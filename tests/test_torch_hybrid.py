"""hymba's hybrid family in the port (``configs/hymba_1_5b.py``, the
ring-buffer ``decode_attention``, the hybrid branches of
``models/blocks.py`` and ``models/lm.py``, the sliding window, the ring
cache in ``ServeEngine``, the trainer and both launchers) against the
JAX reference on the same inputs: the tiny config (window 32), the
reference's random init carried across with ``params_from_reference``,
inputs drawn from fixed numpy seeds.

Tolerances (those of ``tests/test_torch_ssm.py``):
- float32 compute: 1e-5 relative, that is |port - ref| <= 1e-5 ·
  max(1, max|ref|) per tensor (outputs, caches, logits, the loss, every
  gradient leaf); AdamW's moments after one step 1e-4 relative;
- decode attention 2e-5 (two online softmaxes, the bound of
  ``tests/test_torch_serve.py``);
- bf16 compute: 4e-3 · max(1, max|ref|);
- prefill + decode against the teacher-forced forward: atol 2e-4, rtol
  1e-4, the reference's own smoke check;
- ``ServeEngine``: equal tokens and stats (greedy tokens up to the first
  choice whose reference top-2 margin is below 1e-4).
"""

import dataclasses
import functools
import importlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as r_optim
import repro.serve as r_serve
import repro.train as r_train
from repro.configs import get_config as r_get_config
from repro.configs import get_tiny as r_get_tiny
from repro.data import DataConfig as RDataConfig
from repro.models import Model as RModel
from repro.models import blocks as r_blocks
from repro.models import layers as r_layers
from repro.models import lm as r_lm

import repro_torch.optim as t_optim
import repro_torch.train as t_train
from repro_torch.configs import get_config, get_tiny
from repro_torch.convert import (
    cache_from_reference,
    opt_state_from_reference,
    params_from_reference,
)
from repro_torch.data import DataConfig
from repro_torch.models import Model
from repro_torch.models import blocks as t_blocks
from repro_torch.models import layers as t_layers
from repro_torch.models import lm as t_lm
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.tree import leaves, leaves_with_path

t_fa = importlib.import_module("repro_torch.kernels.flash_attention")

ARCH = "hymba_1_5b"
TOL = 1e-5
ATTN_TOL = 2e-5
MOMENT_TOL = 1e-4
BF16_TOL = 4e-3
SMOKE_ATOL, SMOKE_RTOL = 2e-4, 1e-4
TIE = 10 * TOL
FULL_PARAMS = 1_393_625_120
WINDOW = 32                       # the tiny config's sliding window
OCFG = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
DCFG = dict(vocab_size=256, seq_len=48, global_batch=4)


@pytest.fixture(autouse=True)
def _process_state():
    """Run torch on one thread; restore its default dtype and threads."""
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= tol * scale, (err, tol * scale)


def _ref_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def tiny():
    """(reference cfg, port cfg, reference params, their numpy copies),
    float32 compute."""
    r_cfg = r_get_tiny(ARCH).replace(compute_dtype="float32")
    t_cfg = get_tiny(ARCH).replace(compute_dtype="float32")
    r_params = RModel(r_cfg).init_params(jax.random.key(0))
    return r_cfg, t_cfg, r_params, jax.tree.map(np.asarray, r_params)


def _port(tiny):
    return params_from_reference(tiny[3], device="cpu")


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree["layers"])


def _tokens(seed, B, S, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)).astype(
        np.int32)


# ------------------------------------------------------------- the configs
def test_configs_param_count_and_init_match_reference(tiny):
    for t, r in ((get_config(ARCH), r_get_config(ARCH)),
                 (get_tiny(ARCH), r_get_tiny(ARCH))):
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert get_config("hymba-1-5b") == get_config(ARCH)
    assert get_config(ARCH).param_count() == FULL_PARAMS == \
        r_get_config(ARCH).param_count()
    assert get_config(ARCH).active_param_count() == FULL_PARAMS
    assert get_tiny(ARCH).sliding_window == WINDOW
    r_cfg, t_cfg, r_params, _ = tiny
    got = Model(t_cfg).init_params(0, device="cpu")
    flat = {"/".join(p): t for p, t in leaves_with_path(got)}
    want = {"/".join(str(getattr(k, "key", k)) for k in path): a
            for path, a in jax.tree_util.tree_flatten_with_path(r_params)[0]}
    assert sorted(flat) == sorted(want)
    for k, t in flat.items():
        assert tuple(t.shape) == want[k].shape, k
        assert t.dtype == torch.float32
        if k.split("/")[-1] in ("A_log", "dt_bias", "D_skip", "conv_b",
                                "norm_scale", "fuse_attn", "fuse_ssm"):
            _rel_close(t, want[k], 1e-6)                  # fixed, not drawn
    lt = got["layers"]
    assert {"attn", "ssm", "fuse_attn", "fuse_ssm", "mlp"} <= set(lt)


# ------------------------------------------------------- the ring buffer
@pytest.mark.parametrize("cache_len", [5, 31, 32, 33, 50, 200])
def test_ring_decode_attention_matches_reference(cache_len):
    """A ring of S = 32 slots with fewer, as many and more tokens written
    than slots: K7's plain version with valid_len = min(cache_len, S)
    and the port's plain ring branch, against the reference's."""
    S = WINDOW
    rng = np.random.default_rng(cache_len)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, S, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, S, 2, 16)).astype(np.float32)
    want = r_layers._decode_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(cache_len),
        window=WINDOW, ring=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = t_fa.LAUNCHES["flash_attention"]
    got = t_layers.decode_attention(tq, tk, tv, cache_len, window=WINDOW,
                                    ring=True)
    assert t_fa.LAUNCHES["flash_attention"] == before   # plain on the CPU
    _rel_close(got, want, ATTN_TOL)
    assert torch.equal(got, t_fa.flash_attention_plain(
        tq, tk, tv, causal=False, window=0, valid_len=min(cache_len, S)))
    _rel_close(t_layers._decode_attention_impl(tq, tk, tv, cache_len,
                                               window=WINDOW, ring=True),
               want, ATTN_TOL)


@pytest.mark.parametrize("s_cache,pos", [(32, 7), (32, 31), (32, 32),
                                         (32, 45), (32, 70), (48, 20),
                                         (24, 30)])
def test_attention_decode_writes_the_reference_slot(tiny, s_cache, pos):
    """``attention_decode`` on a cache of ``s_cache`` slots at ``pos``: a
    cache no longer than the window is a ring (slot pos % s_cache), a
    longer one linear (slot pos, window mask); the written cache and the
    output equal the reference's."""
    r_cfg, t_cfg, r_params, _ = tiny
    lp = t_lm._layer(_port(tiny)["layers"], 0)["attn"]
    rng = np.random.default_rng(s_cache * 100 + pos)
    x = rng.normal(size=(2, 1, r_cfg.d_model)).astype(np.float32)
    shape = (2, s_cache, r_cfg.n_kv_heads, r_cfg.head_dim_)
    k0 = rng.normal(size=shape).astype(np.float32)
    v0 = rng.normal(size=shape).astype(np.float32)
    r_out, r_cache = r_blocks.attention_decode(
        jnp.asarray(x), _layer0(r_params)["attn"], r_cfg,
        r_blocks.AttnCache(k=jnp.asarray(k0), v=jnp.asarray(v0)),
        jnp.int32(pos), window=WINDOW)
    cache = t_blocks.AttnCache(k=torch.from_numpy(k0.copy()),
                               v=torch.from_numpy(v0.copy()))
    out, new = t_blocks.attention_decode(torch.from_numpy(x), lp, t_cfg,
                                         cache, pos, window=WINDOW)
    assert new is cache                               # written in place
    _rel_close(out, r_out)
    _rel_close(new.k, r_cache.k)
    _rel_close(new.v, r_cache.v)
    slot = pos % s_cache if s_cache <= WINDOW else pos
    changed = np.flatnonzero(np.abs(_np(new.k) - k0).sum(axis=(0, 2, 3)))
    assert changed.tolist() == [slot]


# -------------------------------------------------------------- the block
def test_block_forward_and_decode_match_reference(tiny):
    """The hybrid block (attention and SSD in parallel, each gated, then
    the SwiGLU MLP) over 48 positions with the window of 32, with its
    cache; then one decode step from a ring cache."""
    r_cfg, t_cfg, r_params, _ = tiny
    lp = t_lm._layer(_port(tiny)["layers"], 0)
    x = np.random.default_rng(2).normal(size=(2, 48, r_cfg.d_model)).astype(
        np.float32)
    pos = np.arange(48)
    r_x, r_aux, r_c = jax.jit(
        r_blocks.block_forward, static_argnums=0,
        static_argnames=("window", "build_cache"))(
        r_cfg, _layer0(r_params), jnp.asarray(x), jnp.asarray(pos),
        window=WINDOW, build_cache=True)
    t_x, aux, c = t_blocks.block_forward(t_cfg, lp, torch.from_numpy(x),
                                         torch.from_numpy(pos),
                                         window=WINDOW, build_cache=True)
    assert aux == {} == r_aux
    _rel_close(t_x, r_x)
    for a, b in zip(leaves(c), _ref_leaves(r_c)):
        _rel_close(a, b)
    # a decode step at position 48 on the ring of the last 32 positions
    ring_k = np.roll(_np(c.attn.k)[:, 16:48], 16, axis=1)   # slot p % 32
    ring_v = np.roll(_np(c.attn.v)[:, 16:48], 16, axis=1)
    xd = x[:, :1] * 0.5
    r_lc = r_blocks.LayerCache(
        attn=r_blocks.AttnCache(k=jnp.asarray(ring_k), v=jnp.asarray(ring_v)),
        ssm=r_c.ssm)
    r_out, r_new = jax.jit(r_blocks.block_decode, static_argnums=0,
                           static_argnames="window")(
        r_cfg, _layer0(r_params), jnp.asarray(xd), r_lc, jnp.int32(48),
        window=WINDOW)
    t_lc = t_blocks.LayerCache(
        attn=t_blocks.AttnCache(k=torch.from_numpy(ring_k.copy()),
                                v=torch.from_numpy(ring_v.copy())),
        ssm=c.ssm)
    out, new = t_blocks.block_decode(t_cfg, lp, torch.from_numpy(xd), t_lc,
                                     48, window=WINDOW)
    _rel_close(out, r_out)
    for a, b in zip(leaves(new), _ref_leaves(r_new)):
        _rel_close(a, b)


# ---------------------------------------------------------- the whole model
def test_forward_loss_and_gradients_match_reference(tiny):
    """S = 48 > the window of 32: the window bites in the forward and in
    K7's gradient's recompute."""
    r_cfg, t_cfg, r_params, _ = tiny
    toks = _tokens(4, 2, 48)
    r_logits, _ = RModel(r_cfg).forward(r_params, {"tokens": jnp.asarray(
        toks)})
    t_params = _port(tiny)
    t_logits, aux = Model(t_cfg).forward(t_params, {"tokens": toks},
                                         device="cpu")
    assert aux == {}
    _rel_close(t_logits, r_logits)
    # the window matters: without it the logits move
    full, _ = Model(t_cfg.replace(sliding_window=0)).forward(
        t_params, {"tokens": toks}, device="cpu")
    assert float((full - t_logits).abs().max()) > 100 * TOL
    (r_loss, r_m), r_grads = jax.jit(jax.value_and_grad(
        lambda p: RModel(r_cfg).loss(p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(r_params)
    flat = leaves(t_params, torch.is_tensor)
    for p in flat:
        p.requires_grad_(True)
    t_loss, t_m = Model(t_cfg).loss(t_params, {"tokens": toks}, device="cpu")
    grads = torch.autograd.grad(t_loss, flat)
    assert set(t_m) == set(r_m)
    for k in t_m:
        _rel_close(t_m[k], r_m[k])
    for g, w in zip(grads, _ref_leaves(r_grads)):
        _rel_close(g, w)


def test_bf16_forward_within_tolerance_of_reference():
    r_cfg, t_cfg = r_get_tiny(ARCH), get_tiny(ARCH)
    assert t_cfg.compute_dtype == "bfloat16"
    r_params = RModel(r_cfg).init_params(jax.random.key(5))
    t_params = params_from_reference(jax.tree.map(np.asarray, r_params),
                                     device="cpu")
    toks = _tokens(5, 2, 40)
    r_logits, _ = RModel(r_cfg).forward(r_params, {"tokens": jnp.asarray(
        toks)})
    t_logits, _ = Model(t_cfg).forward(t_params, {"tokens": toks},
                                       device="cpu")
    _rel_close(t_logits, r_logits, BF16_TOL)


def _padded(cache, kv_len):
    """A prefill cache (K/V sized to the prompt) with its K/V zero-padded
    to ``kv_len`` slots, as the engine pastes it."""
    def pad(a):
        return np.pad(a, [(0, 0), (0, 0), (0, kv_len - a.shape[2])]
                      + [(0, 0)] * (a.ndim - 3))
    lc = cache["layers"]
    return {"layers": type(lc)(
        attn=type(lc.attn)(k=pad(np.asarray(lc.attn.k)),
                           v=pad(np.asarray(lc.attn.v))),
        ssm=type(lc.ssm)(*(np.asarray(a) for a in lc.ssm)))}


def test_prefill_and_decode_across_the_wrap_match_reference(tiny):
    """Prefill 24 tokens, pad the cache to the ring of
    min(max_seq 64, window 32) slots, then 24 decode steps (the ring
    wraps at position 32), the reference choosing each next token:
    logits and every cache leaf each step; the reference's cache carried
    across with ``cache_from_reference`` gives the same step."""
    r_cfg, t_cfg, r_params, _ = tiny
    t_params = _port(tiny)
    model = Model(t_cfg)
    kv_len = model.cache_template(2, 64)["layers"].attn.k.shape[2]
    assert kv_len == WINDOW == RModel(r_cfg).cache_template(
        2, 64)["layers"].attn.k.shape[2]
    toks = _tokens(6, 2, 24)
    r_logits, r_cache = r_lm.prefill(r_cfg, r_params,
                                     {"tokens": jnp.asarray(toks)})
    t_logits, t_cache = model.prefill(t_params, {"tokens": toks},
                                      device="cpu")
    _rel_close(t_logits, r_logits)
    for a, b in zip(leaves(t_cache), _ref_leaves(r_cache)):
        _rel_close(a, b)
    r_cache = jax.tree.map(jnp.asarray, _padded(r_cache, kv_len))
    t_cache = cache_from_reference(_padded(jax.tree.map(
        lambda t: t.numpy(), t_cache), kv_len), device="cpu")
    tok = np.asarray(r_logits).argmax(-1)[:, None].astype(np.int32)
    r_decode = jax.jit(functools.partial(r_lm.decode_step, r_cfg))
    for pos in range(24, 48):
        if pos == 40:
            carried = cache_from_reference(jax.tree.map(np.asarray, r_cache),
                                           device="cpu")
        r_logits, r_cache = r_decode(r_params, r_cache, jnp.asarray(tok),
                                     jnp.int32(pos))
        t_logits, out = model.decode_step(t_params, t_cache, tok, pos,
                                          device="cpu")
        assert out is t_cache                        # written in place
        _rel_close(t_logits, r_logits)
        for a, b in zip(leaves(t_cache), _ref_leaves(r_cache)):
            _rel_close(a, b)
        if pos == 40:
            c_logits, _ = model.decode_step(t_params, carried, tok, pos,
                                            device="cpu")
            _rel_close(c_logits, r_logits)
        tok = np.asarray(r_logits).argmax(-1)[:, None].astype(np.int32)


def test_decode_across_the_wrap_matches_the_teacher_forced_forward(tiny):
    """The reference's smoke check on the port, past the ring's length:
    prefill 20 tokens, decode 24 more (the ring of 32 wraps), each step's
    logits equal to the causal windowed forward's at that position."""
    _, t_cfg, _, _ = tiny
    t_params = Model(t_cfg).init_params(1, device="cpu")
    model = Model(t_cfg)
    B, S, n = 2, 20, 24
    toks = _tokens(7, B, S + n)
    full, _ = model.forward(t_params, {"tokens": toks}, device="cpu")
    _, pre = model.prefill(t_params, {"tokens": toks[:, :S]}, device="cpu")
    cache = model.init_cache(B, 64, device="cpu")
    assert cache["layers"].attn.k.shape[2] == WINDOW
    for f, p in zip(leaves(cache), leaves(pre)):
        f[(slice(None),) + tuple(slice(0, m) for m in p.shape[1:])] = p
    for pos in range(S, S + n):
        logits, _ = model.decode_step(t_params, cache, toks[:, pos:pos + 1],
                                      pos, device="cpu")
        np.testing.assert_allclose(_np(logits), _np(full[:, pos]),
                                   atol=SMOKE_ATOL, rtol=SMOKE_RTOL)


def _engines(tiny, prompts, max_new):
    """Both engines over the same prompts (3 requests in 2 slots, max_seq
    64: a ring of 32 slots), greedy; returns ((results, stats, cache) of
    the reference, of the port, the reference's top-2 margins by rid)."""
    r_cfg, t_cfg, r_params, _ = tiny
    t_params = _port(tiny)
    results, margins = [], {}
    for eng_cls, cfg_cls, cfg, p, kw in (
            (r_serve.ServeEngine, r_serve.ServeConfig, r_cfg, r_params, {}),
            (ServeEngine, ServeConfig, t_cfg, t_params, {"device": "cpu"})):
        eng = eng_cls(cfg, p, cfg_cls(max_batch=2, max_seq=64,
                                      max_new_tokens=max_new, **kw))
        if eng_cls is r_serve.ServeEngine:
            choose = eng._select_token

            def recorded(row, slot, eng=eng, choose=choose):
                s = np.sort(np.asarray(row).reshape(-1))
                margins.setdefault(eng.slot_req[slot].rid, []).append(
                    float(s[-1] - s[-2]))
                return choose(row, slot)

            eng._select_token = recorded
        for pr in prompts:
            eng.submit(pr)
        results.append((eng.run_until_drained(), eng.stats, eng.cache))
    return results[0], results[1], margins


def test_serve_engine_decodes_past_the_ring_as_the_reference():
    """Prompts of 20, 28 and 24 tokens and 30 new tokens each: every
    request decodes past position 32, where its ring wraps; the slots
    stand at different positions, so the lagging group's steps restore
    the other row's ring slot ``pos % 32``. Equal stats, equal tokens
    (up to a reference tie), equal final caches."""
    r_cfg = r_get_tiny(ARCH).replace(compute_dtype="float32")
    t_cfg = get_tiny(ARCH).replace(compute_dtype="float32")
    r_params = RModel(r_cfg).init_params(jax.random.key(3))
    tiny = (r_cfg, t_cfg, r_params, jax.tree.map(np.asarray, r_params))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, r_cfg.vocab_size, n) for n in (20, 28, 24)]
    (want, r_stats, r_cache), (got, t_stats, t_cache), margins = _engines(
        tiny, prompts, 30)
    assert t_stats == r_stats
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid, toks_r in want.items():
        assert len(toks_r) == 30 and len(prompts[rid]) + 30 > WINDOW
        tie = next((j for j, m in enumerate(margins[rid]) if m < TIE), None)
        assert got[rid][:tie] == toks_r[:tie], rid
    assert t_cache["layers"].attn.k.shape[2] == WINDOW
    if all(next((m for m in ms if m < TIE), None) is None
           for ms in margins.values()):
        for a, b in zip(leaves(t_cache), _ref_leaves(r_cache)):
            _rel_close(a, b)


def test_engine_refuses_a_prompt_longer_than_the_window(tiny):
    """A prompt past the window needs a chunked prefill: both engines
    refuse it, the port with the reference's message."""
    r_cfg, t_cfg, r_params, _ = tiny
    prompt = np.arange(1, WINDOW + 2)
    eng = ServeEngine(t_cfg, _port(tiny), ServeConfig(
        max_batch=1, max_seq=128, max_new_tokens=4, device="cpu"))
    eng.submit(prompt)
    with pytest.raises(ValueError, match="needs chunked prefill"):
        eng.run_until_drained()
    r_eng = r_serve.ServeEngine(r_cfg, r_params, r_serve.ServeConfig(
        max_batch=1, max_seq=128, max_new_tokens=4))
    r_eng.submit(prompt)
    with pytest.raises(AssertionError, match="needs chunked prefill"):
        r_eng.run_until_drained()
    eng = ServeEngine(t_cfg, _port(tiny), ServeConfig(
        max_batch=1, max_seq=128, max_new_tokens=4, device="cpu"))
    eng.submit(prompt[:WINDOW])                        # at the window: fine
    assert len(eng.run_until_drained()[0]) == 4


# ----------------------------------------------------------------- training
def _trainer(pkg, d, steps):
    mod = r_train if pkg == "ref" else t_train
    ocfg = (r_optim if pkg == "ref" else t_optim).OptimConfig(**OCFG)
    dcfg = (RDataConfig if pkg == "ref" else DataConfig)(**DCFG)
    extra = {} if pkg == "ref" else {"device": "cpu"}
    cfg = (r_get_tiny if pkg == "ref" else get_tiny)(ARCH).replace(
        compute_dtype="float32")
    rc = mod.TrainerConfig(total_steps=steps, checkpoint_every=1,
                           checkpoint_dir=d, async_checkpoint=False)
    return mod.Trainer(cfg=cfg, ocfg=ocfg, tcfg=mod.TrainConfig(), rcfg=rc,
                       data_cfg=dcfg, **extra)


def test_one_trainer_step_matches_reference(tiny):
    """One training step of 4 x 48 tokens (past the window) from the same
    parameters and AdamW state: the port's ``Trainer`` resumes the
    reference's step-1 checkpoint and takes step 2, the reference takes
    it too; loss, every moment and every parameter agree; and
    ``make_train_step``'s metrics and first moments agree from one
    state."""
    from repro.checkpoint import Checkpointer as RCk
    from repro_torch.checkpoint import Checkpointer as TCk

    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as d2:
        _trainer("ref", d, 1).run()
        got = _trainer("port", d, 2).run()
        want = _trainer("ref", d2, 2).run()
        r_tree, _ = RCk(d2).restore(
            {"params": RModel(tiny[0]).param_specs(),
             "opt": r_optim.state_specs(r_optim.OptimConfig(**OCFG),
                                        RModel(tiny[0]).param_specs())})
        t_tree, _ = TCk(d).restore(
            {"params": Model(tiny[1]).param_specs(),
             "opt": t_optim.state_specs(t_optim.OptimConfig(**OCFG),
                                        Model(tiny[1]).param_specs())})
    assert got["final_step"] == want["final_step"] == 2
    _rel_close(np.float32(got["losses"][-1]), np.float32(want["losses"][-1]))
    for a, b in zip(leaves(t_tree["opt"]["moments"], torch.is_tensor),
                    _ref_leaves(r_tree["opt"]["moments"])):
        _rel_close(a, b, MOMENT_TOL)
    for a, b in zip(leaves(t_tree["params"], torch.is_tensor),
                    _ref_leaves(r_tree["params"])):
        _rel_close(a, b, 1e-4)

    r_cfg, t_cfg, r_params, params_np = tiny
    rc, tc = r_optim.OptimConfig(**OCFG), t_optim.OptimConfig(**OCFG)
    state_np = jax.tree.map(np.array, r_optim.init_state(rc, r_params))
    batch = {"tokens": _tokens(9, 4, 48)}
    _, r_s, r_m = r_train.make_train_step(r_cfg, rc)["step"](
        jax.tree.map(jnp.array, params_np), jax.tree.map(jnp.array, state_np),
        {"tokens": jnp.asarray(batch["tokens"])})
    _, t_s, t_m = t_train.make_train_step(t_cfg, tc, device="cpu")["step"](
        params_from_reference(params_np, device="cpu"),
        opt_state_from_reference(jax.tree.map(np.copy, state_np),
                                 device="cpu"), batch)
    assert set(t_m) == set(r_m)
    for k in t_m:
        _rel_close(t_m[k], r_m[k])
    mus_t = [m for path, m in leaves_with_path(t_s["moments"])
             if path[-1] == "mu"]
    mus_r = [m for path, m in leaves_with_path(r_s["moments"])
             if path[-1] == "mu"]
    for a, b in zip(mus_t, _ref_leaves(mus_r)):
        _rel_close(_np(a) / (1 - rc.b1), b / (1 - rc.b1))


# ---------------------------------------------------------------- launchers
def test_launchers_run_hymba(capsys, tmp_path):
    """``--arch hymba_1_5b`` through both launchers, as the reference's
    run it: the engine serves, the trainer trains and prints the
    reference's summary line."""
    from repro_torch.launch import serve as t_serve_cli
    from repro_torch.launch import train as t_train_cli

    t_serve_cli.main(["--arch", ARCH, "--tiny", "--requests", "3",
                      "--max-new-tokens", "4", "--device", "cpu"])
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
    t_train_cli.main(["--arch", ARCH, "--tiny", "--steps", "2",
                      "--seq-len", "48", "--global-batch", "4",
                      "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=hymba-1.5b steps=2 restarts=0 loss " in out
