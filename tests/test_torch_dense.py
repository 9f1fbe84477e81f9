"""The swiglu dense family in the port (``configs/llama3_8b.py``,
``granite_3_8b.py``, ``granite_34b.py``; the SwiGLU ``mlp`` and its
template; the untied ``unembed``) against the JAX reference on the same
inputs: each tiny config in float32, the reference's random init carried
across with ``params_from_reference``, batches from the ported
``TokenPipeline`` on a fixed seed.

Tolerances (those of ``tests/test_torch_train.py`` and
``tests/test_torch_serve.py`` for the tiny gemma):
- the loss and its metrics: 1e-5 relative;
- logits, the SwiGLU MLP and the decode caches: 1e-5 absolute and
  relative;
- gradients: 1e-4 · max(1, max|ref|) per leaf;
- ``apply_updates`` from the same gradients and state: params, moments,
  lr and grad_norm within 1e-6 · max(1, max|ref|);
- one ``make_train_step`` step: moments within 1e-4 · max(1, max|ref|),
  metrics within 1e-5 relative, params within 1e-5 absolute plus what
  the gradient tolerance allows AdamW's first step (lr · min(2,
  eps · tol / (|g| + eps)^2); nothing but where |g| is within ~1e-6 of
  zero, see the test);
- ``ServeEngine``: equal tokens and stats (greedy tokens up to the first
  choice whose reference top-2 margin is below 1e-4).
"""

import dataclasses

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
from repro.models import Model as RModel
from repro.models import layers as r_layers
from repro.models import lm as r_lm

import repro_torch.optim as t_optim
import repro_torch.train as t_train
from repro_torch.configs import ARCH_IDS, get_config, get_tiny
from repro_torch.convert import opt_state_from_reference, params_from_reference
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import Model
from repro_torch.models import layers as t_layers
from repro_torch.models import lm as t_lm
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.tree import leaves, leaves_with_path

NAMES = ["llama3_8b", "granite_3_8b", "granite_34b"]
FULL_PARAMS = {"llama3_8b": 8_030_261_248, "granite_3_8b": 8_372_187_136,
               "granite_34b": 47_249_922_048}
TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
OPT_TOL = 1e-6
TIE = 10 * TOL
OCFG = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
DCFG = dict(vocab_size=256, seq_len=32, global_batch=8)


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


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _rel_close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= tol * scale, (err, tol * scale)


def _ref_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    """(name, reference cfg, port cfg, reference params, their numpy
    copies, tokens) for one tiny config in float32."""
    name = request.param
    r_cfg = r_get_tiny(name).replace(compute_dtype="float32")
    t_cfg = get_tiny(name).replace(compute_dtype="float32")
    r_params = RModel(r_cfg).init_params(jax.random.key(0))
    tokens = TokenPipeline(DataConfig(**DCFG)).global_batch_at(0)["tokens"]
    return (name, r_cfg, t_cfg, r_params, jax.tree.map(np.asarray, r_params),
            tokens)


def _port_params(case):
    return params_from_reference(case[4], device="cpu")


# ------------------------------------------------------------- the configs
def test_arch_ids_hold_the_dense_family():
    assert sorted(ARCH_IDS) == sorted(NAMES + ["gemma_2b", "whisper_tiny",
                                               "mamba2_1_3b", "hymba_1_5b",
                                               "arctic_480b",
                                               "kimi_k2_1t_a32b",
                                               "llava_next_34b"])
    assert [n for n in ARCH_IDS if get_config(n).family == "dense"] == \
        ["granite_3_8b", "llama3_8b", "granite_34b", "gemma_2b"]
    for name in NAMES:
        assert get_config(name.replace("_", "-")) == get_config(name)


@pytest.mark.parametrize("name", NAMES)
def test_configs_equal_the_reference(name):
    for t, r in ((get_config(name), r_get_config(name)),
                 (get_tiny(name), r_get_tiny(name))):
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        assert t.activation == "swiglu" and not t.tie_embeddings


@pytest.mark.parametrize("name", NAMES)
def test_count_params_at_full_size(name):
    cfg = get_config(name)
    assert t_lm.count_params(cfg) == cfg.param_count() == FULL_PARAMS[name]
    assert FULL_PARAMS[name] == r_get_config(name).param_count()


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()} | {
            "__order__": tuple(tree)}
    return None


def test_template_keys_order_and_shapes_match_reference(case):
    _, r_cfg, t_cfg, _, _, _ = case
    # the templates' keys in the reference's insertion order, wi_gate last
    # (the reference's stacking re-sorts the stacked layer's keys; both
    # packages flatten in sorted order)
    assert _keys(t_lm.layer_template(t_cfg)) == \
        _keys(r_lm.layer_template(r_cfg, moe=True))
    assert tuple(t_lm.model_template(t_cfg)) == \
        tuple(r_lm.model_template(r_cfg)) == \
        ("embed", "final_norm", "unembed", "layers")
    assert tuple(t_lm._mlp_t(t_cfg, 8)) == ("wi", "wo", "wi_gate")
    t_specs = list(leaves_with_path(t_lm.param_specs(t_cfg)))
    r_specs = jax.tree_util.tree_flatten_with_path(
        r_lm.param_specs(r_cfg))[0]
    assert len(t_specs) == len(r_specs) == 12        # unembed included
    for (path, t), (r_path, r) in zip(t_specs, r_specs):
        assert path == tuple(k.key for k in r_path)
        assert t.device.type == "meta"
        assert tuple(t.shape) == r.shape and str(r.dtype) == "float32"
        assert t.dtype == torch.float32
    assert t_lm.param_specs(t_cfg)["unembed"].shape == (64, 256)


# ----------------------------------------------------- the MLP, the forward
def test_swiglu_mlp_matches_reference(case):
    _, r_cfg, _, _, params_np, _ = case
    x = np.random.default_rng(1).normal(size=(2, 24, r_cfg.d_model)) \
        .astype(np.float32)
    r_lp = jax.tree.map(lambda a: a[0], params_np["layers"])
    t_lp = params_from_reference(r_lp, device="cpu")
    _close(t_layers.mlp(torch.from_numpy(x), t_lp["mlp"], "swiglu"),
           r_layers.mlp(jnp.asarray(x), r_lp["mlp"], "swiglu"))


def test_forward_logits_match_reference(case):
    _, r_cfg, t_cfg, r_params, _, tokens = case
    r_logits, _ = jax.jit(lambda p, t: RModel(r_cfg).forward(
        p, {"tokens": t}))(r_params, jnp.asarray(tokens))
    with torch.no_grad():
        t_logits, aux = Model(t_cfg).forward(_port_params(case),
                                             {"tokens": tokens}, device="cpu")
    assert aux == {}
    assert t_logits.shape == (8, 32, 256) and t_logits.dtype == torch.float32
    _close(t_logits, r_logits)
    # the untied head reads unembed: zeroing it zeroes the logits
    params = _port_params(case)
    params["unembed"].zero_()
    with torch.no_grad():
        zero, _ = Model(t_cfg).forward(params, {"tokens": tokens[:1]},
                                       device="cpu")
    assert not bool(zero.any())


# --------------------------------------------------------- loss, gradients
@pytest.mark.parametrize("ce_chunk", [0, 16])
def test_loss_matches_reference(case, ce_chunk):
    _, r_cfg, t_cfg, r_params, _, tokens = case
    rc, tc = r_cfg.replace(ce_chunk=ce_chunk), t_cfg.replace(ce_chunk=ce_chunk)
    _, r_m = jax.jit(lambda p, t: RModel(rc).loss(p, {"tokens": t}))(
        r_params, jnp.asarray(tokens))
    with torch.no_grad():
        _, t_m = Model(tc).loss(_port_params(case), {"tokens": tokens},
                                device="cpu")
    assert set(t_m) == set(r_m) == {"ce", "zloss", "loss"}
    for k in t_m:
        np.testing.assert_allclose(float(t_m[k]), float(r_m[k]),
                                   rtol=LOSS_TOL)


def test_every_gradient_matches_reference(case):
    _, r_cfg, t_cfg, r_params, _, tokens = case
    r_grads = _ref_leaves(jax.jit(jax.grad(
        lambda p, t: RModel(r_cfg).loss(p, {"tokens": t})[0]))(
        r_params, jnp.asarray(tokens)))
    params = _port_params(case)
    flat = leaves(params, torch.is_tensor)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = Model(t_cfg).loss(params, {"tokens": tokens}, device="cpu")
    got = torch.autograd.grad(loss, flat)
    assert len(got) == len(r_grads) == 12
    for g, r in zip(got, r_grads):
        _rel_close(g, r, GRAD_TOL)


def test_adamw_step_matches_reference(case):
    """One AdamW step in both packages: ``apply_updates`` from the same
    gradients and state, then a whole ``make_train_step`` step from the
    same parameters and state."""
    _, r_cfg, t_cfg, r_params, params_np, tokens = case
    rc, tc = r_optim.OptimConfig(**OCFG), t_optim.OptimConfig(**OCFG)
    state_np = jax.tree.map(np.array, r_optim.init_state(rc, r_params))
    grads = jax.jit(jax.grad(
        lambda p, t: RModel(r_cfg).loss(p, {"tokens": t})[0]))(
        r_params, jnp.asarray(tokens))
    r_p, r_s, r_m = jax.jit(r_optim.apply_updates, static_argnums=0)(
        rc, jax.tree.map(jnp.array, params_np), grads,
        jax.tree.map(jnp.array, state_np))
    t_p, t_s, t_m = t_optim.apply_updates(
        tc, params_from_reference(params_np, device="cpu"),
        params_from_reference(jax.tree.map(np.array, grads), device="cpu"),
        opt_state_from_reference(jax.tree.map(np.copy, state_np),
                                 device="cpu"))
    for name in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(t_m[name]), float(r_m[name]),
                                   rtol=OPT_TOL)
    for a, b in zip(leaves(t_p, torch.is_tensor) + leaves(t_s["moments"],
                                                          torch.is_tensor),
                    _ref_leaves(r_p) + _ref_leaves(r_s["moments"])):
        _rel_close(a, b, OPT_TOL)

    r_built = r_train.make_train_step(r_cfg, rc, r_train.TrainConfig())
    r_p, r_s, r_m = r_built["step"](jax.tree.map(jnp.array, params_np),
                                    jax.tree.map(jnp.array, state_np),
                                    {"tokens": jnp.asarray(tokens)})
    t_built = t_train.make_train_step(t_cfg, tc, t_train.TrainConfig(),
                                      device="cpu")
    t_p, t_s, t_m = t_built["step"](
        params_from_reference(params_np, device="cpu"),
        opt_state_from_reference(jax.tree.map(np.copy, state_np),
                                 device="cpu"), {"tokens": tokens})
    assert set(t_m) == set(r_m)
    for k in t_m:
        np.testing.assert_allclose(float(t_m[k]), float(r_m[k]),
                                   rtol=LOSS_TOL)
    for a, b in zip(leaves(t_s["moments"], torch.is_tensor),
                    _ref_leaves(r_s["moments"])):
        _rel_close(a, b, GRAD_TOL)
    assert int(t_s["step"]) == int(r_s["step"]) == 1
    # A first step moves each entry by lr * u(g), u(g) = g / (|g| + eps),
    # |u| <= 1, u'(g) = eps / (|g| + eps)^2. So a gradient within GRAD_TOL
    # moves a param within lr * min(2, eps * tol / (|g| + eps)^2) of the
    # reference's: nothing where |g| >> sqrt(eps * tol), up to 2 lr where
    # |g| is near eps. Params are held to 1e-5 plus that.
    lr = float(r_m["lr"])
    mus = [m for path, m in leaves_with_path(r_s["moments"])
           if path[-1] == "mu"]
    for a, b, mu in zip(leaves(t_p, torch.is_tensor), _ref_leaves(r_p),
                        _ref_leaves(mus)):
        g = np.abs(mu) / (1 - rc.b1)
        tol = GRAD_TOL * max(1.0, float(g.max()))
        bound = LOSS_TOL + lr * np.minimum(2.0, rc.eps * tol
                                           / (g + rc.eps) ** 2)
        assert (np.abs(a.numpy() - b) <= bound).all()


# ------------------------------------------------------------------ decode
def _cache_leaves(cache):
    a = cache["layers"].attn
    return {"k": a.k, "v": a.v}


def test_prefill_and_four_decode_steps_match_reference(case):
    """Prefill then 4 decode steps through the Model API (logits and every
    cache leaf, the reference choosing each next token), then the same
    through ``ServeEngine``: a prefill and 4 decode steps a request."""
    _, r_cfg, t_cfg, r_params, _, _ = case
    params = _port_params(case)
    rng = np.random.default_rng(2)
    toks = rng.integers(1, r_cfg.vocab_size, (2, 9)).astype(np.int32)
    r_logits, pre = r_lm.prefill(r_cfg, r_params, {"tokens": jnp.asarray(toks)})
    model = Model(t_cfg)
    t_logits, t_pre = model.prefill(params, {"tokens": toks}, device="cpu")
    _close(t_logits, r_logits)
    for name, leaf in _cache_leaves(t_pre).items():
        _close(leaf, _cache_leaves(pre)[name])
    r_cache = jax.tree.map(lambda full, part: full.at[:, :, :9].set(part),
                           r_lm.init_cache(r_cfg, 2, 16), pre)
    t_cache = model.init_cache(2, 16, device="cpu")
    for name, leaf in _cache_leaves(t_cache).items():
        leaf[:, :, :9] = _cache_leaves(t_pre)[name]
    tok = np.asarray(r_logits).argmax(-1)[:, None].astype(np.int32)
    for pos in range(9, 13):
        r_logits, r_cache = r_lm.decode_step(r_cfg, r_params, r_cache,
                                             jnp.asarray(tok), jnp.int32(pos))
        t_logits, _ = model.decode_step(params, t_cache, tok, pos,
                                        device="cpu")
        _close(t_logits, r_logits)
        for name, leaf in _cache_leaves(t_cache).items():
            _close(leaf, _cache_leaves(r_cache)[name])
        tok = np.asarray(r_logits).argmax(-1)[:, None].astype(np.int32)

    prompts = [rng.integers(1, r_cfg.vocab_size, n) for n in (5, 9, 7)]
    results, margins = [], {}
    for eng_cls, cfg_cls, cfg, p, kw in (
            (r_serve.ServeEngine, r_serve.ServeConfig, r_cfg, r_params, {}),
            (ServeEngine, ServeConfig, t_cfg, params, {"device": "cpu"})):
        eng = eng_cls(cfg, p, cfg_cls(max_batch=2, max_seq=32,
                                      max_new_tokens=5, **kw))
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
        results.append((eng.run_until_drained(), eng.stats))
    (want, r_stats), (got, t_stats) = results
    assert t_stats == r_stats and t_stats["prefills"] == len(prompts)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid, toks_r in want.items():
        assert len(toks_r) == 5
        tie = next((j for j, m in enumerate(margins[rid]) if m < TIE), None)
        assert got[rid][:tie] == toks_r[:tie], rid
