"""mamba2's SSM family in the port (``configs/mamba2_1_3b.py``,
``models/ssm.py``, the ssm branches of ``models/blocks.py`` and
``models/lm.py``, the SSM state in ``convert``, ``ServeEngine`` and the
trainer) against the JAX reference on the same inputs: the tiny config,
the reference's random init carried across with ``params_from_reference``,
inputs drawn from fixed numpy seeds.

Tolerances:
- float32 compute: 1e-5 relative, that is |port - ref| <= 1e-5 ·
  max(1, max|ref|) per tensor (outputs, states, logits, the loss, every
  gradient leaf; the same operations on the same weights, summed in other
  orders); AdamW's moments after one step 1e-4 relative, as in
  ``tests/test_torch_dense.py``;
- bf16 compute: 4e-3 · max(1, max|ref|) (one bf16 step of the largest
  value, with room for the rounding of the intermediates);
- the reference's ``test_smoke_decode_matches_forward`` check on the
  port: prefill + one decode step equal the teacher-forced forward within
  atol 2e-4, rtol 1e-4, as there;
- ``ServeEngine``: equal tokens and stats (greedy tokens up to the first
  choice whose reference top-2 margin is below 1e-4).
"""

import dataclasses
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
from repro.models import lm as r_lm
from repro.models import ssm as r_ssm

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
from repro_torch.models import lm as t_lm
from repro_torch.models import ssm as t_ssm
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.tree import leaves, leaves_with_path

TOL = 1e-5
MOMENT_TOL = 1e-4
BF16_TOL = 4e-3
SMOKE_ATOL, SMOKE_RTOL = 2e-4, 1e-4
TIE = 10 * TOL
FULL_PARAMS = 1_446_714_368
OCFG = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
DCFG = dict(vocab_size=256, seq_len=32, global_batch=4)


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
    r_cfg = r_get_tiny("mamba2_1_3b").replace(compute_dtype="float32")
    t_cfg = get_tiny("mamba2_1_3b").replace(compute_dtype="float32")
    r_params = RModel(r_cfg).init_params(jax.random.key(0))
    return r_cfg, t_cfg, r_params, jax.tree.map(np.asarray, r_params)


def _port(tiny):
    return params_from_reference(tiny[3], device="cpu")


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree["layers"]["ssm"])


# ------------------------------------------------------------- the configs
def test_configs_param_count_and_init_match_reference(tiny):
    for t, r in ((get_config("mamba2_1_3b"), r_get_config("mamba2_1_3b")),
                 (get_tiny("mamba2_1_3b"), r_get_tiny("mamba2_1_3b"))):
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert get_config("mamba2-1-3b") == get_config("mamba2_1_3b")
    assert get_config("mamba2_1_3b").param_count() == FULL_PARAMS == \
        r_get_config("mamba2_1_3b").param_count()
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
                                "norm_scale"):           # fixed, not drawn
            _rel_close(t, want[k], 1e-6)
    assert "attn" not in got["layers"] and "mlp" not in got["layers"]


# -------------------------------------------------------------- the pieces
def test_segsum_and_causal_conv_match_reference():
    rng = np.random.default_rng(1)
    alpha = -np.abs(rng.normal(size=(2, 3, 17))).astype(np.float32)
    got = _np(t_ssm._segsum(torch.from_numpy(alpha)))
    want = np.asarray(r_ssm._segsum(jnp.asarray(alpha)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[..., 0, 1]).all()          # above the diagonal
    fin = np.isfinite(want)
    _rel_close(got[fin], want[fin])
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    _rel_close(t_ssm._causal_depthwise_conv(*(torch.from_numpy(a)
                                             for a in (x, w, b))),
               r_ssm._causal_depthwise_conv(*(jnp.asarray(a)
                                              for a in (x, w, b))))


@pytest.mark.parametrize("S,chunk", [(128, 128), (123, 128), (1, 128),
                                     (123, 16), (200, 128)])
def test_ssm_forward_with_state_matches_reference(tiny, S, chunk):
    """The chunked SSD and the state after the last real token, at one
    chunk, a ragged single chunk, one token and several chunks with a
    padded last one (the pad decay undone)."""
    r_cfg, t_cfg, r_params, params_np = tiny
    t_params = _port(tiny)
    x = np.random.default_rng(S).normal(size=(2, S, r_cfg.d_model)).astype(
        np.float32)
    r_out, r_st = r_ssm.ssm_forward(jnp.asarray(x), _layer0(r_params), r_cfg,
                                    chunk=chunk, return_state=True)
    lp = t_lm._layer(t_params["layers"], 0)["ssm"]
    t_out, t_st = t_ssm.ssm_forward(torch.from_numpy(x), lp, t_cfg,
                                    chunk=chunk, return_state=True)
    _rel_close(t_out, r_out)
    _rel_close(t_st.conv, r_st.conv)
    _rel_close(t_st.ssm, r_st.ssm)
    assert t_st.ssm.dtype == torch.float32
    plain = t_ssm.ssm_forward(torch.from_numpy(x), lp, t_cfg, chunk=chunk)
    assert torch.equal(plain, t_out)


def test_ssm_decode_step_continues_a_prefill(tiny):
    """The state from ``ssm_forward`` then ``ssm_decode_step`` on the next
    token: the reference's step from the same state, and the forward over
    all the tokens at that position."""
    r_cfg, t_cfg, r_params, _ = tiny
    lp = t_lm._layer(_port(tiny)["layers"], 0)["ssm"]
    x = np.random.default_rng(3).normal(size=(2, 41, r_cfg.d_model)).astype(
        np.float32)
    _, st = t_ssm.ssm_forward(torch.from_numpy(x[:, :40]), lp, t_cfg,
                              chunk=16, return_state=True)
    _, r_st = r_ssm.ssm_forward(jnp.asarray(x[:, :40]), _layer0(r_params),
                                r_cfg, chunk=16, return_state=True)
    out, new = t_ssm.ssm_decode_step(torch.from_numpy(x[:, 40:]), st, lp,
                                     t_cfg)
    r_out, r_new = r_ssm.ssm_decode_step(jnp.asarray(x[:, 40:]), r_st,
                                         _layer0(r_params), r_cfg)
    _rel_close(out, r_out)
    _rel_close(new.conv, r_new.conv)
    _rel_close(new.ssm, r_new.ssm)
    full = t_ssm.ssm_forward(torch.from_numpy(x), lp, t_cfg, chunk=16)
    _rel_close(out[:, 0], full[:, 40], 1e-4)
    zero = t_ssm.ssm_init_state(t_cfg, 3)
    r_zero = r_ssm.ssm_init_state(r_cfg, 3)
    assert [tuple(t.shape) for t in zero] == [a.shape for a in r_zero]
    p = t_ssm.ssm_init_params(t_cfg, torch.Generator().manual_seed(0),
                              torch.float32)
    r_p = r_ssm.ssm_init_params(r_cfg, jax.random.key(0), jnp.float32)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: v.shape for k, v in r_p.items()}
    _rel_close(p["A_log"], r_p["A_log"], 1e-6)
    assert set(t_ssm.ssm_param_shapes(t_cfg)) == set(p)


# ---------------------------------------------------------- the whole model
def _tokens(seed, B, S, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)).astype(
        np.int32)


def test_forward_loss_and_gradients_match_reference(tiny):
    r_cfg, t_cfg, r_params, _ = tiny
    toks = _tokens(4, 2, 37)
    r_logits, _ = RModel(r_cfg).forward(r_params, {"tokens": jnp.asarray(
        toks)})
    t_params = _port(tiny)
    t_logits, _ = Model(t_cfg).forward(t_params, {"tokens": toks},
                                       device="cpu")
    _rel_close(t_logits, r_logits)
    (r_loss, r_m), r_grads = jax.value_and_grad(
        lambda p: RModel(r_cfg).loss(p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(r_params)
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
    r_cfg, t_cfg = r_get_tiny("mamba2_1_3b"), get_tiny("mamba2_1_3b")
    assert t_cfg.compute_dtype == "bfloat16"
    r_params = RModel(r_cfg).init_params(jax.random.key(5))
    t_params = params_from_reference(jax.tree.map(np.asarray, r_params),
                                     device="cpu")
    toks = _tokens(5, 2, 50)
    r_logits, _ = RModel(r_cfg).forward(r_params, {"tokens": jnp.asarray(
        toks)})
    t_logits, _ = Model(t_cfg).forward(t_params, {"tokens": toks},
                                       device="cpu")
    _rel_close(t_logits, r_logits, BF16_TOL)


def test_prefill_and_decode_steps_match_reference(tiny):
    """Prefill (logits and the SSM cache), then 4 decode steps, the
    reference choosing each next token; the reference's cache carried
    across with ``cache_from_reference`` gives the same step."""
    r_cfg, t_cfg, r_params, _ = tiny
    t_params = _port(tiny)
    toks = _tokens(6, 2, 9)
    r_logits, r_cache = r_lm.prefill(r_cfg, r_params,
                                     {"tokens": jnp.asarray(toks)})
    model = Model(t_cfg)
    t_logits, t_cache = model.prefill(t_params, {"tokens": toks},
                                      device="cpu")
    _rel_close(t_logits, r_logits)
    assert t_cache["layers"].attn is None
    for a, b in zip(leaves(t_cache), _ref_leaves(r_cache)):
        _rel_close(a, b)
    tpl = model.cache_template(2, 16)
    assert [tuple(t.shape) for t in leaves(tpl)] == [
        s.shape for s in jax.tree.leaves(RModel(r_cfg).cache_template(2, 16))]
    assert [t.dtype for t in leaves(model.init_cache(2, 16, device="cpu"))] \
        == [torch.float32, torch.float32]
    carried = cache_from_reference(jax.tree.map(np.asarray, r_cache),
                                   device="cpu")
    tok = np.asarray(r_logits).argmax(-1)[:, None].astype(np.int32)
    for pos in range(9, 13):
        r_logits, r_cache = r_lm.decode_step(r_cfg, r_params, r_cache,
                                             jnp.asarray(tok), jnp.int32(pos))
        t_logits, out = model.decode_step(t_params, t_cache, tok, pos,
                                          device="cpu")
        assert out is t_cache                        # written in place
        _rel_close(t_logits, r_logits)
        for a, b in zip(leaves(t_cache), _ref_leaves(r_cache)):
            _rel_close(a, b)
        if pos == 9:
            c_logits, _ = model.decode_step(t_params, carried, tok, pos,
                                            device="cpu")
            _rel_close(c_logits, r_logits)
        tok = np.asarray(r_logits).argmax(-1)[:, None].astype(np.int32)


def test_smoke_decode_matches_forward(tiny):
    """The reference's check on the port: prefill + one decode step equal
    the teacher-forced forward's logits at that position."""
    _, t_cfg, _, _ = tiny
    t_params = Model(t_cfg).init_params(1, device="cpu")
    B, S = 2, 16
    toks = _tokens(7, B, S + 1)
    model = Model(t_cfg)
    full, _ = model.forward(t_params, {"tokens": toks}, device="cpu")
    _, cache = model.prefill(t_params, {"tokens": toks[:, :S]}, device="cpu")
    logits, _ = model.decode_step(t_params, cache, toks[:, S:S + 1], S,
                                  device="cpu")
    np.testing.assert_allclose(_np(logits), _np(full[:, S]), atol=SMOKE_ATOL,
                               rtol=SMOKE_RTOL)


def test_serve_engine_emits_the_reference_tokens(tiny):
    """Both engines on the same prompts and slots (3 requests in 2 slots,
    so a refill and the lagging-group step run): equal stats, and equal
    greedy tokens up to the first reference choice within ``TIE``."""
    r_cfg, t_cfg, r_params, _ = tiny
    t_params = _port(tiny)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, r_cfg.vocab_size, n) for n in (5, 9, 7)]
    results, margins = [], {}
    for eng_cls, cfg_cls, cfg, p, kw in (
            (r_serve.ServeEngine, r_serve.ServeConfig, r_cfg, r_params, {}),
            (ServeEngine, ServeConfig, t_cfg, t_params, {"device": "cpu"})):
        eng = eng_cls(cfg, p, cfg_cls(max_batch=2, max_seq=32,
                                      max_new_tokens=6, **kw))
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
    (want, r_stats, r_cache), (got, t_stats, t_cache) = results
    assert t_stats == r_stats
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid, toks_r in want.items():
        tie = next((j for j, m in enumerate(margins[rid]) if m < TIE), None)
        assert got[rid][:tie] == toks_r[:tie], rid
    if all(next((m for m in ms if m < TIE), None) is None
           for ms in margins.values()):
        for a, b in zip(leaves(t_cache), _ref_leaves(r_cache)):
            _rel_close(a, b)


# ----------------------------------------------------------------- training
def _trainer(pkg, d, steps):
    mod = r_train if pkg == "ref" else t_train
    ocfg = (r_optim if pkg == "ref" else t_optim).OptimConfig(**OCFG)
    dcfg = (RDataConfig if pkg == "ref" else DataConfig)(**DCFG)
    extra = {} if pkg == "ref" else {"device": "cpu"}
    cfg = (r_get_tiny if pkg == "ref" else get_tiny)("mamba2_1_3b").replace(
        compute_dtype="float32")
    rc = mod.TrainerConfig(total_steps=steps, checkpoint_every=1,
                           checkpoint_dir=d, async_checkpoint=False)
    return mod.Trainer(cfg=cfg, ocfg=ocfg, tcfg=mod.TrainConfig(), rcfg=rc,
                       data_cfg=dcfg, **extra)


def test_one_trainer_step_matches_reference(tiny):
    """One training step from the same parameters and AdamW state: the
    port's ``Trainer`` resumes the reference's step-1 checkpoint and takes
    step 2, the reference takes it too; loss, every moment and every
    parameter agree, and the step's gradients (``make_train_step``'s
    first moment after one step is (1 - b1) g) agree leaf by leaf."""
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as d2:
        _trainer("ref", d, 1).run()
        port = _trainer("port", d, 2)
        got = port.run()
        ref = _trainer("ref", d2, 2)
        want = ref.run()
        from repro.checkpoint import Checkpointer as RCk
        from repro_torch.checkpoint import Checkpointer as TCk

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

    # the gradients of one step from the same state
    r_cfg, t_cfg, r_params, params_np = tiny
    rc, tc = r_optim.OptimConfig(**OCFG), t_optim.OptimConfig(**OCFG)
    state_np = jax.tree.map(np.array, r_optim.init_state(rc, r_params))
    batch = {"tokens": _tokens(9, 4, 32)}
    _, r_s, r_m = r_train.make_train_step(r_cfg, rc)["step"](
        jax.tree.map(jnp.array, params_np), jax.tree.map(jnp.array, state_np),
        {"tokens": jnp.asarray(batch["tokens"])})
    _, t_s, t_m = t_train.make_train_step(t_cfg, tc, device="cpu")["step"](
        params_from_reference(params_np, device="cpu"),
        opt_state_from_reference(jax.tree.map(np.copy, state_np),
                                 device="cpu"), batch)
    for k in t_m:
        _rel_close(t_m[k], r_m[k])
    mus_t = [m for path, m in leaves_with_path(t_s["moments"])
             if path[-1] == "mu"]
    mus_r = [m for path, m in leaves_with_path(r_s["moments"])
             if path[-1] == "mu"]
    assert len(mus_t) == len(mus_r) == len(leaves(t_s["moments"])) // 2
    for a, b in zip(mus_t, _ref_leaves(mus_r)):
        _rel_close(_np(a) / (1 - rc.b1), b / (1 - rc.b1))


# ---------------------------------------------------------------- launchers
def test_launchers_run_mamba2(capsys, tmp_path):
    """``--arch mamba2_1_3b`` through both launchers, as the reference's
    run it: the engine serves, the trainer trains and prints the
    reference's summary line."""
    from repro_torch.launch import serve as t_serve_cli
    from repro_torch.launch import train as t_train_cli

    t_serve_cli.main(["--arch", "mamba2_1_3b", "--tiny", "--requests", "3",
                      "--max-new-tokens", "4", "--device", "cpu"])
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
    t_train_cli.main(["--arch", "mamba2_1_3b", "--tiny", "--steps", "2",
                      "--seq-len", "32", "--global-batch", "4",
                      "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=mamba2-1.3b steps=2 restarts=0 loss " in out
