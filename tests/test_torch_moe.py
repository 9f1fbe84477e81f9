"""The MoE family in the port (``models/moe.py``, the MoE branch of
``models/blocks.py``, ``first_k_dense`` as ``front_layers`` and the MoE
loss terms in ``models/lm.py``, ``configs/arctic_480b.py`` and
``configs/kimi_k2_1t_a32b.py``, the engine's restore over every cache
stack, the trainer and both launchers) against the JAX reference on the
same inputs: the tiny configs, the reference's random init carried across
with ``params_from_reference``, inputs drawn from fixed numpy seeds.

Tolerances (those of ``tests/test_torch_ssm.py``):
- float32 compute: 1e-5 relative, that is |port - ref| <= 1e-5 ·
  max(1, max|ref|) per tensor (outputs, aux terms, caches, logits, the
  loss, every gradient leaf); AdamW's moments after one step 1e-4
  relative;
- bf16 compute: 4e-3 · max(1, max|ref|);
- routing by equality: the chosen experts, which assignments are kept;
- ``ServeEngine``: equal tokens and stats (greedy tokens up to the first
  choice whose reference top-2 margin is below 1e-4).

Capacity rounds up to 512 and is capped at the token count, so no tiny
model ever drops a token; ``test_moe_block_with_drops_matches_reference``
routes 2,048 tokens over 4 experts at capacity factor 1.0 with the router
biased to one expert, so that over a quarter of the assignments are
dropped.
"""

import dataclasses
import functools
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
from repro.models import lm as r_lm
from repro.models import moe as r_moe

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
from repro_torch.models import lm as t_lm
from repro_torch.models import moe as t_moe
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.tree import leaves, leaves_with_path

ARCHS = ("arctic_480b", "kimi_k2_1t_a32b")
TOL = 1e-5
MOMENT_TOL = 1e-4
BF16_TOL = 4e-3
TIE = 10 * TOL
FULL = {"arctic_480b": (476_850_275_328, 15_584_314_368),
        "kimi_k2_1t_a32b": (1_026_939_253_760, 33_392_522_240)}
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


@functools.lru_cache(maxsize=None)
def _tiny(arch):
    """(reference cfg, port cfg, reference params, their numpy copies),
    float32 compute."""
    r_cfg = r_get_tiny(arch).replace(compute_dtype="float32")
    t_cfg = get_tiny(arch).replace(compute_dtype="float32")
    r_params = RModel(r_cfg).init_params(jax.random.key(0))
    return r_cfg, t_cfg, r_params, jax.tree.map(np.asarray, r_params)


def _port(tiny):
    return params_from_reference(tiny[3], device="cpu")


def _tokens(seed, B, S, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)).astype(
        np.int32)


def _expert_params(seed, D, E, F):
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(D, E)) * 0.3,
         "w_gate": rng.normal(size=(E, D, F)) * 0.1,
         "w_up": rng.normal(size=(E, D, F)) * 0.1,
         "w_down": rng.normal(size=(E, F, D)) * 0.1}
    return {k: v.astype(np.float32) for k, v in p.items()}


# ------------------------------------------------------------ the MoE block
@pytest.mark.parametrize("T", [1, 7, 64, 511, 513, 2048, 100_000])
@pytest.mark.parametrize("E,k,factor", [(4, 2, 1.0), (8, 2, 1.25),
                                        (128, 2, 1.25), (384, 8, 1.25)])
def test_expert_capacity_matches_reference(T, E, k, factor):
    assert t_moe.expert_capacity(T, E, k, factor) == \
        r_moe.expert_capacity(T, E, k, factor)


def _check_moe_block(x, params, top_k, factor, activation, tol=TOL):
    """The port's ``moe_block`` against the reference's on the same
    inputs: the output and the three aux terms. Returns the port's aux."""
    r_out, r_aux = r_moe.moe_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
        top_k=top_k, capacity_factor=factor, activation=activation)
    out, aux = t_moe.moe_block(
        torch.from_numpy(x), {k: torch.from_numpy(v)
                              for k, v in params.items()},
        top_k=top_k, capacity_factor=factor, activation=activation)
    _rel_close(out, r_out, tol)
    assert set(aux) == set(r_aux)
    for name in aux:
        _rel_close(aux[name], r_aux[name], tol)
    return aux


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_moe_block_without_drops_matches_reference(activation):
    x = np.random.default_rng(1).normal(size=(64, 16)).astype(np.float32)
    params = _expert_params(2, 16, 8, 24)
    if activation == "gelu":
        del params["w_gate"]
    aux = _check_moe_block(x, params, 2, 1.25, activation)
    assert float(aux["dropped_fraction"]) == 0.0


def test_moe_block_with_drops_matches_reference():
    """2,048 tokens, 4 experts, top-2, capacity factor 1.0 (C = 1,024),
    the router biased to expert 0: nearly every token picks it, so more
    than a quarter of all assignments are dropped. The chosen experts
    equal ``jax.lax.top_k``'s; the kept assignments are each expert's
    first C in token order (the stable sort); the output and aux equal the
    reference's."""
    T, D, E, F, k = 2048, 16, 4, 32, 2
    rng = np.random.default_rng(3)
    x = rng.normal(size=(T, D)).astype(np.float32)
    x[:, 0] = 3.0 + 0.1 * x[:, 0]
    params = _expert_params(4, D, E, F)
    params["router"][0, 0] = 2.0
    C = t_moe.expert_capacity(T, E, k, 1.0)
    assert C == 1024
    _, probs, _, idx = t_moe.route(torch.from_numpy(x),
                                   torch.from_numpy(params["router"]), k)
    r_probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(params["router"]),
                             axis=-1)
    _, r_idx = jax.lax.top_k(r_probs, k)
    assert np.array_equal(idx.numpy(), np.asarray(r_idx))
    _rel_close(probs, r_probs)
    dest, keep = t_moe.slots(idx, E, C)
    flat = idx.reshape(-1).numpy()
    rank = np.array([int((flat[:a] == flat[a]).sum())
                     for a in range(flat.size)])
    assert np.array_equal(keep.numpy(), rank < C)
    assert np.array_equal(dest.numpy(), np.where(rank < C, flat * C + rank,
                                                  E * C))
    aux = _check_moe_block(x, params, k, 1.0, "swiglu")
    assert float(aux["dropped_fraction"]) == float((rank >= C).mean()) \
        >= 0.25
    assert np.bincount(flat, minlength=E)[0] > C


def test_moe_block_in_bf16_within_tolerance_of_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(96, 16)).astype(np.float32)
    params = _expert_params(6, 16, 8, 24)
    r_out, _ = r_moe.moe_block(
        jnp.asarray(x, jnp.bfloat16),
        {k: jnp.asarray(v) for k, v in params.items()}, top_k=2,
        capacity_factor=1.25)
    out, _ = t_moe.moe_block(
        torch.from_numpy(x).to(torch.bfloat16),
        {k: torch.from_numpy(v) for k, v in params.items()}, top_k=2,
        capacity_factor=1.25)
    assert out.dtype == torch.bfloat16
    _rel_close(out, np.asarray(r_out, np.float32), BF16_TOL)


# ------------------------------------------------------------- the configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_trees_and_param_counts_match_reference(arch):
    for t, r in ((get_config(arch), r_get_config(arch)),
                 (get_tiny(arch), r_get_tiny(arch))):
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        assert t.param_count() == r.param_count()
        assert t.active_param_count() == r.active_param_count()
    assert (get_config(arch).param_count(),
            get_config(arch).active_param_count()) == FULL[arch]
    assert get_config(arch.replace("_", "-")) == get_config(arch)
    r_cfg, t_cfg, r_params, _ = _tiny(arch)
    got = Model(t_cfg).init_params(0, device="cpu")
    flat = {"/".join(p): t for p, t in leaves_with_path(got)}
    want = {"/".join(str(getattr(kk, "key", kk)) for kk in path): a
            for path, a in jax.tree_util.tree_flatten_with_path(r_params)[0]}
    assert sorted(flat) == sorted(want)
    for name, t in flat.items():
        assert tuple(t.shape) == want[name].shape, name
        assert t.dtype == torch.float32
    assert ("front_layers" in got) == bool(t_cfg.first_k_dense)
    assert {"moe", "moe_dense", "ln2"} <= set(got["layers"])
    # the full configs store bf16 parameters; the router stays float32
    specs = Model(get_config(arch)).param_specs()
    assert specs["layers"]["moe"]["router"].dtype == torch.float32
    assert specs["layers"]["moe"]["w_up"].dtype == torch.bfloat16


def test_large_bf16_leaves_are_drawn_in_slices(monkeypatch):
    """A bf16 leaf above the slice size is drawn slice by slice straight
    into its tensor, with the std of its kind."""
    monkeypatch.setattr(t_lm, "_DRAW_SLICE", 1000)
    cfg = get_tiny("arctic_480b").replace(param_dtype="bfloat16")
    p = Model(cfg).init_params(3, device="cpu")
    w = p["layers"]["moe"]["w_up"]
    assert w.dtype == torch.bfloat16 and w.numel() > 1000
    assert abs(float(w.float().std()) - 0.02) < 1e-3
    out = p["layers"]["moe"]["w_down"].float().std()
    assert abs(float(out) - 0.02 / np.sqrt(2 * cfg.n_layers)) < 1e-3


# -------------------------------------------------------------- the blocks
@pytest.mark.parametrize("arch", ARCHS)
def test_block_forward_and_decode_match_reference(arch):
    """A MoE layer (attention, the MoE block and the dense residual) over
    24 positions with its aux terms and cache, and one decode step."""
    r_cfg, t_cfg, r_params, _ = _tiny(arch)
    lp = t_lm._layer(_port(_tiny(arch))["layers"], 0)
    r_lp = jax.tree.map(lambda a: a[0], r_params["layers"])
    x = np.random.default_rng(2).normal(size=(2, 24, r_cfg.d_model)).astype(
        np.float32)
    pos = np.arange(24)
    r_x, r_aux, r_c = jax.jit(
        r_blocks.block_forward, static_argnums=0,
        static_argnames="build_cache")(
        r_cfg, r_lp, jnp.asarray(x), jnp.asarray(pos), build_cache=True)
    t_x, aux, c = t_blocks.block_forward(t_cfg, lp, torch.from_numpy(x),
                                         torch.from_numpy(pos),
                                         build_cache=True)
    _rel_close(t_x, r_x)
    assert set(aux) == set(r_aux) == {"load_balance_loss", "router_z_loss",
                                      "dropped_fraction"}
    for name in aux:
        _rel_close(aux[name], r_aux[name])
    for a, b in zip(leaves(c), _ref_leaves(r_c)):
        _rel_close(a, b)
    # the dense path of a MoE layer's config (moe_layer=False) has no aux
    front = t_cfg.replace(n_experts=0)
    dense_lp = dict(lp, mlp=lp["moe_dense"])
    _, aux0, _ = t_blocks.block_forward(front, dense_lp, torch.from_numpy(x),
                                        torch.from_numpy(pos),
                                        moe_layer=False)
    assert aux0 == {}
    kv = np.zeros((2, 32, r_cfg.n_kv_heads, r_cfg.head_dim_), np.float32)
    kv[:, :24] = np.asarray(r_c.attn.k)
    vv = np.zeros_like(kv)
    vv[:, :24] = np.asarray(r_c.attn.v)
    xd = x[:, :1] * 0.5
    r_out, r_new = jax.jit(r_blocks.block_decode, static_argnums=0)(
        r_cfg, r_lp, jnp.asarray(xd), r_blocks.LayerCache(
            attn=r_blocks.AttnCache(k=jnp.asarray(kv), v=jnp.asarray(vv)),
            ssm=None), jnp.int32(24))
    out, new = t_blocks.block_decode(
        t_cfg, lp, torch.from_numpy(xd), t_blocks.LayerCache(
            attn=t_blocks.AttnCache(k=torch.from_numpy(kv.copy()),
                                    v=torch.from_numpy(vv.copy())),
            ssm=None), 24)
    _rel_close(out, r_out)
    for a, b in zip(leaves(new), _ref_leaves(r_new)):
        _rel_close(a, b)


# ---------------------------------------------------------- the whole model
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_reference(arch):
    """Logits, the loss with ``moe_lb``, ``moe_rz`` and
    ``dropped_fraction``, and every gradient leaf (the router's through
    the gates and the aux terms, the front layers' for kimi)."""
    r_cfg, t_cfg, r_params, _ = _tiny(arch)
    toks = _tokens(4, 2, 24)
    r_logits, r_aux = RModel(r_cfg).forward(r_params, {"tokens": jnp.asarray(
        toks)})
    t_params = _port(_tiny(arch))
    t_logits, aux = Model(t_cfg).forward(t_params, {"tokens": toks},
                                         device="cpu")
    _rel_close(t_logits, r_logits)
    assert set(aux) == set(r_aux)
    for name in aux:
        _rel_close(aux[name], r_aux[name])
    (r_loss, r_m), r_grads = jax.jit(jax.value_and_grad(
        lambda p: RModel(r_cfg).loss(p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(r_params)
    flat = leaves(t_params, torch.is_tensor)
    for p in flat:
        p.requires_grad_(True)
    t_loss, t_m = Model(t_cfg).loss(t_params, {"tokens": toks}, device="cpu")
    grads = torch.autograd.grad(t_loss, flat)
    assert set(t_m) == set(r_m) == {"ce", "zloss", "moe_lb", "moe_rz",
                                    "dropped_fraction", "loss"}
    for name in t_m:
        _rel_close(t_m[name], r_m[name])
    assert float(t_m["moe_lb"].detach()) > 0
    assert float(t_m["moe_rz"].detach()) > 0
    for g, w in zip(grads, _ref_leaves(r_grads)):
        _rel_close(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_within_tolerance_of_reference(arch):
    r_cfg, t_cfg = r_get_tiny(arch), get_tiny(arch)
    assert t_cfg.compute_dtype == "bfloat16"
    r_params = RModel(r_cfg).init_params(jax.random.key(5))
    t_params = params_from_reference(jax.tree.map(np.asarray, r_params),
                                     device="cpu")
    toks = _tokens(5, 2, 20)
    r_logits, _ = RModel(r_cfg).forward(r_params, {"tokens": jnp.asarray(
        toks)})
    t_logits, _ = Model(t_cfg).forward(t_params, {"tokens": toks},
                                       device="cpu")
    _rel_close(t_logits, r_logits, BF16_TOL)


def _padded(cache, n):
    """A prefill cache with every K/V leaf zero-padded to ``n`` slots."""
    def pad(a):
        a = np.asarray(a)
        return np.pad(a, [(0, 0), (0, 0), (0, n - a.shape[2]), (0, 0),
                          (0, 0)])
    return jax.tree.map(pad, cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch):
    """Prefill (logits and every cache stack, kimi's ``front_layers``
    included), then 4 decode steps, the reference choosing each next
    token; the reference's cache carried across gives the same step."""
    r_cfg, t_cfg, r_params, _ = _tiny(arch)
    t_params = _port(_tiny(arch))
    model = Model(t_cfg)
    toks = _tokens(6, 2, 9)
    r_logits, r_cache = r_lm.prefill(r_cfg, r_params,
                                     {"tokens": jnp.asarray(toks)})
    t_logits, t_cache = model.prefill(t_params, {"tokens": toks},
                                      device="cpu")
    _rel_close(t_logits, r_logits)
    assert sorted(t_cache) == sorted(r_cache)
    assert ("front_layers" in t_cache) == bool(t_cfg.first_k_dense)
    for a, b in zip(leaves(t_cache), _ref_leaves(r_cache)):
        _rel_close(a, b)
    tpl = model.cache_template(2, 16)
    assert [tuple(t.shape) for t in leaves(tpl)] == [
        s.shape for s in jax.tree.leaves(RModel(r_cfg).cache_template(2, 16))]
    r_cache = jax.tree.map(jnp.asarray, _padded(r_cache, 16))
    t_cache = cache_from_reference(_padded(jax.tree.map(
        lambda t: t.numpy(), t_cache), 16), device="cpu")
    carried = cache_from_reference(jax.tree.map(np.asarray, r_cache),
                                   device="cpu")
    tok = np.asarray(r_logits).argmax(-1)[:, None].astype(np.int32)
    r_decode = jax.jit(functools.partial(r_lm.decode_step, r_cfg))
    for pos in range(9, 13):
        r_logits, r_cache = r_decode(r_params, r_cache, jnp.asarray(tok),
                                     jnp.int32(pos))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_emits_the_reference_tokens(arch):
    """Both engines on the same prompts (3 requests in 2 slots, so a
    refill and the lagging-group step run, and the restore walks every
    cache stack): equal stats, equal tokens up to the first reference
    choice within ``TIE``, equal final caches."""
    r_cfg, t_cfg, r_params, _ = _tiny(arch)
    t_params = _port(_tiny(arch))
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
    assert sorted(t_cache) == sorted(r_cache)
    for rid, toks_r in want.items():
        tie = next((j for j, m in enumerate(margins[rid]) if m < TIE), None)
        assert got[rid][:tie] == toks_r[:tie], rid
    if all(next((m for m in ms if m < TIE), None) is None
           for ms in margins.values()):
        for a, b in zip(leaves(t_cache), _ref_leaves(r_cache)):
            _rel_close(a, b)


# ----------------------------------------------------------------- training
def _trainer(pkg, arch, d, steps):
    mod = r_train if pkg == "ref" else t_train
    ocfg = (r_optim if pkg == "ref" else t_optim).OptimConfig(**OCFG)
    dcfg = (RDataConfig if pkg == "ref" else DataConfig)(**DCFG)
    extra = {} if pkg == "ref" else {"device": "cpu"}
    cfg = (r_get_tiny if pkg == "ref" else get_tiny)(arch).replace(
        compute_dtype="float32")
    rc = mod.TrainerConfig(total_steps=steps, checkpoint_every=1,
                           checkpoint_dir=d, async_checkpoint=False)
    return mod.Trainer(cfg=cfg, ocfg=ocfg, tcfg=mod.TrainConfig(), rcfg=rc,
                       data_cfg=dcfg, **extra)


@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b"])
def test_one_trainer_step_matches_reference(arch):
    """One training step of kimi's tiny config (a leading dense layer, MoE
    layers with a shared expert) from the same parameters and AdamW
    state: the
    port's ``Trainer`` resumes the reference's step-1 checkpoint and takes
    step 2, the reference takes it too; loss, every moment and every
    parameter agree; ``make_train_step``'s metrics (the MoE terms among
    them) and first moments agree from one state."""
    from repro.checkpoint import Checkpointer as RCk
    from repro_torch.checkpoint import Checkpointer as TCk

    tiny = _tiny(arch)
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as d2:
        _trainer("ref", arch, d, 1).run()
        got = _trainer("port", arch, d, 2).run()
        want = _trainer("ref", arch, d2, 2).run()
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
    batch = {"tokens": _tokens(9, 4, 32)}
    _, r_s, r_m = r_train.make_train_step(r_cfg, rc)["step"](
        jax.tree.map(jnp.array, params_np), jax.tree.map(jnp.array, state_np),
        {"tokens": jnp.asarray(batch["tokens"])})
    _, t_s, t_m = t_train.make_train_step(t_cfg, tc, device="cpu")["step"](
        params_from_reference(params_np, device="cpu"),
        opt_state_from_reference(jax.tree.map(np.copy, state_np),
                                 device="cpu"), batch)
    assert set(t_m) == set(r_m)
    assert {"moe_lb", "moe_rz", "dropped_fraction"} <= set(t_m)
    for name in t_m:
        _rel_close(t_m[name], r_m[name])
    mus_t = [m for path, m in leaves_with_path(t_s["moments"])
             if path[-1] == "mu"]
    mus_r = [m for path, m in leaves_with_path(r_s["moments"])
             if path[-1] == "mu"]
    for a, b in zip(mus_t, _ref_leaves(mus_r)):
        _rel_close(_np(a) / (1 - rc.b1), b / (1 - rc.b1))


# ---------------------------------------------------------------- launchers
@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_moe(capsys, tmp_path, arch):
    """``--arch`` arctic and kimi through both launchers, as the
    reference's run them: the engine serves, the trainer trains and prints
    the reference's summary line."""
    from repro_torch.launch import serve as t_serve_cli
    from repro_torch.launch import train as t_train_cli

    t_serve_cli.main(["--arch", arch, "--tiny", "--requests", "3",
                      "--max-new-tokens", "4", "--device", "cpu"])
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
    t_train_cli.main(["--arch", arch, "--tiny", "--steps", "2",
                      "--seq-len", "32", "--global-batch", "4",
                      "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={get_tiny(arch).name} steps=2 restarts=0 loss " in out
