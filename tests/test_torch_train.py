"""Training in the port (``repro_torch.optim``, ``checkpoint``,
``models.lm.loss_fn``, K7's gradient, ``train`` and ``launch.train``)
against the JAX reference on the same inputs: the tiny gemma in float32,
the reference's random init and optimizer state carried across with
``params_from_reference`` and ``opt_state_from_reference``, batches from
the ported ``TokenPipeline`` on fixed seeds.

Tolerances:
- the loss and its metrics: 1e-5 relative (float32, the same operations,
  sums in other orders);
- gradients: 1e-4 · max(1, max|ref|) per leaf; attention's q, k and v
  gradients: 1e-4 · max(1, max|ref|) (two backward passes of the same
  blocked attention);
- ``lr_at``: 1e-6 relative (float32 cosines of two libraries);
- ``apply_updates`` from the same gradients and state: params, mu, nu,
  lr and grad_norm within 1e-6 · max(1, max|ref|) (float32; the global
  norm sums in the reference's leaf order); int8 moment payloads equal
  but for at most 1 on at most 0.1% of entries (a float32 rounding on
  either side of a .5 boundary), scales within 1e-6 relative;
- the int8 compression functions: equal;
- one ``make_train_step`` step: params within 1e-5 absolute (each moves
  by about lr · sign(g)), moments within 1e-4 · max(1, max|ref|) of the
  reference's, metrics within 1e-5 relative;
- checkpoints across the packages: equal leaves and metadata;
- the trainer resumed from the reference's checkpoint: losses within 1e-4
  of the reference's uninterrupted run; the port's own restart: equal.
"""

import os
import re
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as r_ckpt
import repro.optim as r_optim
import repro.train as r_train
from repro.configs import get_tiny as r_get_tiny
from repro.data import DataConfig as RDataConfig
from repro.models import Model as RModel
from repro.models import layers as r_layers
from repro.optim import adamw as r_adamw
from repro.optim import compression as r_comp

import repro_torch.checkpoint as t_ckpt
import repro_torch.optim as t_optim
import repro_torch.train as t_train
from repro_torch.configs import get_tiny
from repro_torch.convert import opt_state_from_reference, params_from_reference
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import Model
from repro_torch.models import layers as t_layers
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compression as t_comp
from repro_torch.tree import leaves, leaves_with_path, tree_map

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
OPT_TOL = 1e-6
TRAIN_TOL = 1e-4

R_CFG = r_get_tiny("gemma_2b").replace(compute_dtype="float32")
T_CFG = get_tiny("gemma_2b").replace(compute_dtype="float32")
OCFG = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
DCFG = dict(vocab_size=256, seq_len=32, global_batch=8)


@pytest.fixture(autouse=True)
def _process_state():
    """Run torch on one thread; restore what a test may change: torch's
    default dtype and threads, the jax config; no checkpoint thread may
    outlive a test."""
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    x64 = jax.config.jax_enable_x64
    torch.set_num_threads(1)        # tiny ops: one thread beats contention
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", x64)
    assert not [t for t in threading.enumerate() if "(work)" in t.name]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= tol * scale, (err, tol * scale)


def _ref_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def tiny():
    r_params = RModel(R_CFG).init_params(jax.random.key(0))
    tokens = TokenPipeline(DataConfig(**DCFG)).global_batch_at(0)["tokens"]
    return r_params, jax.tree.map(np.asarray, r_params), tokens


def _port_params(tiny):
    return params_from_reference(tiny[1], device="cpu")


# -------------------------------------------------------------- loss, grad
@pytest.mark.parametrize("ce_chunk", [0, 16])
def test_loss_fn_matches_reference(tiny, ce_chunk):
    r_params, _, tokens = tiny
    rc, tc = R_CFG.replace(ce_chunk=ce_chunk), T_CFG.replace(ce_chunk=ce_chunk)
    r_loss, r_m = jax.jit(lambda p, t: RModel(rc).loss(p, {"tokens": t}))(
        r_params, jnp.asarray(tokens))
    with torch.no_grad():
        t_loss, t_m = Model(tc).loss(_port_params(tiny), {"tokens": tokens},
                                     device="cpu")
    assert set(t_m) == set(r_m) == {"ce", "zloss", "loss"}
    for k in t_m:
        assert t_m[k].dtype == torch.float32 and t_m[k].shape == ()
        np.testing.assert_allclose(float(t_m[k]), float(r_m[k]),
                                   rtol=LOSS_TOL)
    assert float(t_loss) == float(t_m["loss"])


def _port_grads(cfg, params, tokens):
    flat = leaves(params, torch.is_tensor)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = Model(cfg).loss(params, {"tokens": tokens}, device="cpu")
    grads = torch.autograd.grad(loss, flat)
    for p in flat:
        p.requires_grad_(False)
    return grads


@pytest.fixture(scope="module")
def port_grads_by_remat(tiny):
    return {remat: _port_grads(T_CFG.replace(remat=remat), _port_params(tiny),
                               tiny[2])
            for remat in ("full", "dots", "none")}


@pytest.fixture(scope="module")
def ref_grads(tiny):
    """The reference's gradients (its default remat, "full"; its remat
    policies change what is saved, not the values)."""
    r_params, _, tokens = tiny
    r_grads = jax.jit(jax.grad(
        lambda p, t: RModel(R_CFG).loss(p, {"tokens": t})[0]))(
        r_params, jnp.asarray(tokens))
    return _ref_leaves(r_grads)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_every_gradient_matches_reference(ref_grads, port_grads_by_remat,
                                          remat):
    got = port_grads_by_remat[remat]
    want = ref_grads
    assert len(got) == len(want) == 11
    for g, r in zip(got, want):
        _rel_close(g, r, GRAD_TOL)
    # the three remat modes give bit-equal gradients in the port
    for g, f in zip(got, port_grads_by_remat["full"]):
        assert torch.equal(g, f)


@pytest.mark.parametrize("remat,per_layer", [("full", 2), ("none", 1)])
def test_remat_full_recomputes_attention_forward(tiny, monkeypatch, remat,
                                                 per_layer):
    """K7 runs once a layer in the forward and, with remat "full", once
    more in the backward's recompute (the chip's 2 x 18 launches a step;
    here its plain version on the CPU)."""
    calls = []
    real = t_layers.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(t_layers, "flash_attention", counted)
    _port_grads(T_CFG.replace(remat=remat), _port_params(tiny), tiny[2])
    assert len(calls) == per_layer * T_CFG.n_layers


@pytest.mark.parametrize("window", [0, 24])
def test_attention_gradient_matches_reference_vjp(window):
    rng = np.random.default_rng(window + 5)
    q = rng.normal(size=(2, 48, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, 48, 1, 32)).astype(np.float32)
    v = rng.normal(size=(2, 48, 1, 32)).astype(np.float32)
    g = rng.normal(size=q.shape).astype(np.float32)
    kw = dict(causal=True, window=window, q_chunk=16, kv_chunk=16)
    r_out, vjp = jax.vjp(
        lambda a, b, c: r_layers.blocked_attention(a, b, c, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    r_dq, r_dk, r_dv = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = t_layers.blocked_attention(tq, tk, tv, **kw)
    _rel_close(out, r_out, 2e-5)
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for got, want in ((dq, r_dq), (dk, r_dk), (dv, r_dv)):
        _rel_close(got, want, GRAD_TOL)


@pytest.mark.parametrize("shape", [(2, 64, 8, 1, 64), (1, 100, 4, 1, 32),
                                   (1, 128, 8, 2, 256)])
def test_attention_gradient_bf16_within_k7_tolerance_of_plain_autograd(
        shape):
    """The CPU rehearsal of the card's check: the Function's bf16 gradients
    (its forward K7's plain version, its backward the blocked recompute)
    against plain autograd through ``flash_attention_plain`` in float32 on
    the same inputs, within K7's 4e-3 · max(1, |plain|)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    B, S, Hq, Hkv, D = shape
    gen = torch.Generator().manual_seed(sum(shape))
    q = torch.randn((B, S, Hq, D), generator=gen).bfloat16()
    k = torch.randn((B, S, Hkv, D), generator=gen).bfloat16()
    v = (torch.rand((B, S, Hkv, D), generator=gen) * 2 - 1).bfloat16()
    g = torch.randn(q.shape, generator=gen).bfloat16()
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    b = [t.float().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(
        t_layers.blocked_attention(*a, causal=True, q_chunk=32, kv_chunk=32),
        a, g)
    want = torch.autograd.grad(flash_attention_plain(*b, causal=True), b,
                               g.float())
    for x, y in zip(got, want):
        assert x.dtype == torch.bfloat16
        d = (x.float() - y).abs()
        assert bool((d <= 4e-3 * torch.clamp(y.abs(), min=1)).all())


# -------------------------------------------------------------- optimizer
def test_lr_at_matches_reference():
    for kw in (OCFG, dict(peak_lr=3e-4, warmup_steps=1, decay_steps=8),
               dict(warmup_steps=0, decay_steps=20, min_lr_ratio=0.0)):
        rc, tc = r_optim.OptimConfig(**kw), t_optim.OptimConfig(**kw)
        for step in range(31):
            got = t_optim.lr_at(tc, torch.tensor(step, dtype=torch.int32))
            want = r_optim.lr_at(rc, jnp.int32(step))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=OPT_TOL)


r_apply = jax.jit(r_optim.apply_updates, static_argnums=0)


def _grad_tree(params_np, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32),
        params_np)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("gscale", [1e-3, 1.0])     # unclipped, clipped
def test_apply_updates_matches_reference(tiny, quantized, gscale):
    """Three steps (from zero moments, then from the reference's), each
    from the same gradients and the same state in both packages."""
    _, params_np, _ = tiny
    kw = dict(OCFG, quantized_moments=quantized, moment_block=64)
    rc, tc = r_optim.OptimConfig(**kw), t_optim.OptimConfig(**kw)
    r_params = jax.tree.map(jnp.array, params_np)
    r_state = r_optim.init_state(rc, r_params)
    for step in range(3):
        g = _grad_tree(params_np, step, gscale)
        t_params = params_from_reference(
            jax.tree.map(np.array, r_params), device="cpu")
        t_state = opt_state_from_reference(
            jax.tree.map(np.array, r_state), device="cpu")
        r_params, r_state, r_m = jax.block_until_ready(r_apply(
            rc, r_params, jax.tree.map(jnp.array, g), r_state))
        # the port consumes its gradients (scratch): a copy of their own
        out = t_optim.apply_updates(
            tc, t_params, params_from_reference(jax.tree.map(np.copy, g),
                                                device="cpu"), t_state)
        assert out[0] is t_params and out[1] is t_state   # in place
        for name in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(out[2][name]),
                                       float(r_m[name]), rtol=OPT_TOL)
        assert int(t_state["step"]) == int(r_state["step"]) == step + 1
        for a, b in zip(leaves(t_params, torch.is_tensor), _ref_leaves(r_params)):
            _rel_close(a, b, OPT_TOL)
        t_mom = list(leaves_with_path(t_state["moments"]))
        r_mom = jax.tree.leaves(r_state["moments"])
        assert len(t_mom) == len(r_mom)
        for (path, a), b in zip(t_mom, r_mom):
            b = np.asarray(b)
            if path[-1] == "q":          # int8 payloads
                d = np.abs(a.numpy().astype(np.int32) - b.astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3, path
            elif path[-1] == "scale":
                np.testing.assert_allclose(a.numpy(), b, rtol=OPT_TOL,
                                           atol=0)
            else:
                _rel_close(a, b, OPT_TOL)


def test_state_specs_and_init_state_match_reference(tiny):
    _, params_np, _ = tiny
    for quantized in (False, True):
        kw = dict(quantized_moments=quantized)
        rc, tc = r_optim.OptimConfig(**kw), t_optim.OptimConfig(**kw)
        r_specs = r_optim.state_specs(rc, RModel(R_CFG).param_specs())
        t_specs = t_optim.state_specs(tc, Model(T_CFG).param_specs())
        t_init = t_optim.init_state(tc, params_from_reference(
            params_np, device="cpu"))
        r_flat = jax.tree.leaves(r_specs)
        for t in (t_specs, t_init):
            flat = leaves(t, torch.is_tensor)
            assert [tuple(x.shape) for x in flat] == [
                tuple(s.shape) for s in r_flat]
            assert [str(x.dtype).split(".")[1] for x in flat] == [
                str(s.dtype) for s in r_flat]
        assert all(x.device.type == "meta" for x in leaves(t_specs,
                                                           torch.is_tensor))
        assert all(not bool(x.any()) for x in leaves(t_init, torch.is_tensor))
    specs = Model(T_CFG).param_specs()
    r_ps = RModel(R_CFG).param_specs()
    assert [tuple(x.shape) for x in leaves(specs, torch.is_tensor)] == [
        tuple(s.shape) for s in jax.tree.leaves(r_ps)]


@pytest.mark.parametrize("seed,shape,block", [
    (0, (300,), 256), (1, (4, 33, 7), 64), (2, (1024,), 256), (3, (5,), 8)])
def test_int8_compression_equals_reference(seed, shape, block):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-3, 3)).astype(
        np.float32)
    res = rng.normal(size=shape).astype(np.float32) * 1e-3
    rq, rs = r_comp.quantize_block_int8(jnp.asarray(x), block)
    tq, ts = t_comp.quantize_block_int8(torch.from_numpy(x), block)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        t_comp.dequantize_block_int8(tq, ts, shape).numpy(),
        np.asarray(r_comp.dequantize_block_int8(rq, rs, shape)))
    got = t_comp.apply_error_feedback(torch.from_numpy(x),
                                      torch.from_numpy(res), block)
    want = r_comp.apply_error_feedback(jnp.asarray(x), jnp.asarray(res),
                                       block)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    z = t_comp.zeros_like_residuals({"a": torch.ones(shape)})
    assert z["a"].dtype == torch.float32 and not bool(z["a"].any())


def test_exports_and_not_ported_labels():
    assert set(t_optim.__all__) == set(r_optim.__all__)
    assert set(t_ckpt.__all__) == set(r_ckpt.__all__)
    assert set(t_train.__all__) == set(r_train.__all__)
    ocfg = t_optim.OptimConfig()
    with pytest.raises(NotImplementedError, match="A11"):
        t_optim.compressed_psum_mean({}, {}, ("data",))
    with pytest.raises(NotImplementedError, match="A11"):
        t_train.make_train_step(T_CFG, ocfg, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        t_train.make_train_step(T_CFG, ocfg, t_train.TrainConfig(
            grad_compression="int8"), device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        t_train.make_serve_step(T_CFG, mesh=object(), device="cpu")
    from repro_torch.train.step import make_dp_compressed_train_step

    with pytest.raises(NotImplementedError, match="A11"):
        make_dp_compressed_train_step(T_CFG, ocfg, object())


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ocfg = t_optim.OptimConfig()
    for fn in (lambda: t_train.make_train_step(T_CFG, ocfg),
               lambda: t_train.make_serve_step(T_CFG),
               lambda: t_train.Trainer(T_CFG, ocfg, t_train.TrainConfig(),
                                       t_train.TrainerConfig(),
                                       DataConfig(**DCFG))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(tiny, microbatches):
    r_params, params_np, tokens = tiny
    rc, tc = r_optim.OptimConfig(**OCFG), t_optim.OptimConfig(**OCFG)
    r_built = r_train.make_train_step(
        R_CFG, rc, r_train.TrainConfig(microbatches=microbatches))
    r_state = r_optim.init_state(rc, r_params)
    t_params = params_from_reference(params_np, device="cpu")
    t_state = opt_state_from_reference(jax.tree.map(np.asarray, r_state),
                                       device="cpu")
    r_p, r_s, r_m = r_built["step"](
        jax.tree.map(jnp.array, r_params), r_state,
        {"tokens": jnp.asarray(tokens)})
    t_built = t_train.make_train_step(
        T_CFG, tc, t_train.TrainConfig(microbatches=microbatches),
        device="cpu")
    t_p, t_s, t_m = t_built["step"](t_params, t_state, {"tokens": tokens})
    assert set(t_m) == set(r_m)
    for k in t_m:
        np.testing.assert_allclose(float(t_m[k]), float(r_m[k]),
                                   rtol=LOSS_TOL)
    for a, b in zip(leaves(t_p, torch.is_tensor), _ref_leaves(r_p)):
        np.testing.assert_allclose(a.numpy(), b, atol=LOSS_TOL, rtol=0)
    for a, b in zip(leaves(t_s["moments"], torch.is_tensor),
                    _ref_leaves(r_s["moments"])):
        _rel_close(a, b, GRAD_TOL)
    assert int(t_s["step"]) == 1
    # the step's specs and init as the reference's
    assert [tuple(x.shape) for x in leaves(t_built["opt_specs"], torch.is_tensor)] \
        == [tuple(s.shape) for s in jax.tree.leaves(r_built["opt_specs"])]
    p1, _ = t_built["init"](3)
    p2, _ = t_built["init"](torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(leaves(p1, torch.is_tensor),
                                                 leaves(p2, torch.is_tensor)))


def test_serve_step_is_the_decode_step(tiny):
    params = _port_params(tiny)
    model = Model(T_CFG)
    step = t_train.make_serve_step(T_CFG, device="cpu")["step"]
    toks = np.array([[3], [7]], np.int32)
    a, _ = step(params, model.init_cache(2, 8, device="cpu"), toks, 0)
    with torch.no_grad():
        b, _ = model.decode_step(params, model.init_cache(2, 8, device="cpu"),
                                 toks, 0, device="cpu")
    assert torch.equal(a, b)


# ------------------------------------------------------------- checkpoint
def _tree_pair():
    """The same tree in both packages: float32, bf16, int32 scalar and int8
    leaves, a QuantMoment."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    b16 = rng.normal(size=(5,)).astype(np.float32)
    q = rng.integers(-127, 128, 64).astype(np.int8)
    s = rng.random(2).astype(np.float32)
    r_tree = {"a": jnp.asarray(a),
              "b": {"c": jnp.asarray(b16).astype(jnp.bfloat16),
                    "step": jnp.int32(7)},
              "m": r_adamw.QuantMoment(q=jnp.asarray(q), scale=jnp.asarray(s))}
    t_tree = {"a": torch.from_numpy(a),
              "b": {"c": torch.from_numpy(b16).bfloat16(),
                    "step": torch.tensor(7, dtype=torch.int32)},
              "m": t_adamw.QuantMoment(q=torch.from_numpy(q),
                                       scale=torch.from_numpy(s))}
    return r_tree, t_tree


def _same(t_tree, r_tree):
    t_flat = list(leaves_with_path(t_tree))
    r_flat = jax.tree.leaves(r_tree)
    assert len(t_flat) == len(r_flat)
    for (_, a), b in zip(t_flat, r_flat):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        b = np.asarray(b)
        assert str(a.dtype).split(".")[1] == str(b.dtype)
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.float().numpy(), b.astype(np.float32))


def test_checkpoints_restore_across_packages():
    r_tree, t_tree = _tree_pair()
    with tempfile.TemporaryDirectory() as d:
        r_ckpt.save(d, 3, r_tree, {"note": "ref", "n": [1, 2]})
        got, meta = t_ckpt.restore(d, t_tree)
        assert meta == {"note": "ref", "n": [1, 2]}
        _same(got, r_tree)
        t_ckpt.save(d, 5, t_tree, {"note": "port"})
        assert r_ckpt.latest_step(d) == t_ckpt.latest_step(d) == 5
        back, meta = r_ckpt.restore(d, r_tree)
        assert meta == {"note": "port"}
        _same(t_tree, back)
        # the same manifest keys, shapes and dtypes as the reference writes
        with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
            r_man = __import__("json").load(f)
        with open(os.path.join(d, "step_00000005", "manifest.json")) as f:
            t_man = __import__("json").load(f)
        assert t_man["leaves"] == r_man["leaves"]
        assert t_man["format"] == r_man["format"] == 1
        # templates may be meta tensors
        meta_tmpl = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                                   device="meta"), t_tree,
                             torch.is_tensor)
        _same(t_ckpt.restore(d, meta_tmpl, step=3)[0], r_tree)


def test_checkpoint_roundtrip_and_atomicity():
    _, t_tree = _tree_pair()
    with tempfile.TemporaryDirectory() as d:
        t_ckpt.save(d, 7, t_tree, {"note": "x"})
        assert t_ckpt.latest_step(d) == 7
        got, meta = t_ckpt.restore(d, t_tree)
        assert meta["note"] == "x"
        assert torch.equal(got["a"], t_tree["a"])
        assert got["b"]["c"].dtype == torch.bfloat16
        assert torch.equal(got["b"]["c"], t_tree["b"]["c"])
        assert got["b"]["step"].shape == ()
        # a stale tmp dir must never be visible as a checkpoint
        os.makedirs(os.path.join(d, "step_00000009.tmp.123"))
        assert t_ckpt.latest_step(d) == 7
        assert t_ckpt.latest_step(os.path.join(d, "none")) is None


def test_checkpointer_async_and_retention():
    with tempfile.TemporaryDirectory() as d:
        ck = t_ckpt.Checkpointer(d, keep=2, async_save=True)
        x = torch.zeros(4)
        for s in (1, 2, 3, 4):
            x.fill_(s)               # in place: the save took a snapshot
            ck.save(s, {"x": x})
        ck.wait()
        steps = sorted(int(n[5:]) for n in os.listdir(d)
                       if n.startswith("step_"))
        assert steps == [3, 4]
        got, _ = ck.restore({"x": torch.zeros(4)})
        assert bool((got["x"] == 4).all())
        # a failed write surfaces on wait()
        bad = t_ckpt.Checkpointer(os.path.join(d, "step_00000004",
                                               "manifest.json"))
        bad.save(1, {"x": x})
        with pytest.raises(OSError):
            bad.wait()


def test_restore_shape_mismatch_raises():
    with tempfile.TemporaryDirectory() as d:
        t_ckpt.save(d, 0, {"x": torch.zeros(4)})
        with pytest.raises(ValueError):
            t_ckpt.restore(d, {"x": torch.zeros(5)})
        with pytest.raises(KeyError):
            t_ckpt.restore(d, {"y": torch.zeros(4)})
        with pytest.raises(FileNotFoundError):
            t_ckpt.restore(os.path.join(d, "empty"), {"x": torch.zeros(4)})


# ---------------------------------------------------------------- trainer
def _trainer(pkg, d, steps, **kw):
    mod = r_train if pkg == "ref" else t_train
    ocfg = (r_optim if pkg == "ref" else t_optim).OptimConfig(**OCFG)
    dcfg = (RDataConfig if pkg == "ref" else DataConfig)(**DCFG)
    extra = {} if pkg == "ref" else {"device": "cpu"}
    rc = mod.TrainerConfig(total_steps=steps, checkpoint_every=4,
                           checkpoint_dir=d, async_checkpoint=False,
                           **kw.pop("rcfg", {}))
    return mod.Trainer(cfg=R_CFG if pkg == "ref" else T_CFG, ocfg=ocfg,
                       tcfg=mod.TrainConfig(**kw.pop("tcfg", {})), rcfg=rc,
                       data_cfg=dcfg, **extra, **kw)


def test_trainer_resumes_from_reference_checkpoint():
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as d2:
        first = _trainer("ref", d, 4).run()
        assert first["final_step"] == 4 and r_ckpt.latest_step(d) == 4
        resumed = _trainer("port", d, 8).run()
        assert resumed["final_step"] == 8 and t_ckpt.latest_step(d) == 8
        whole = _trainer("ref", d2, 8).run()
    assert len(resumed["losses"]) == 4
    np.testing.assert_allclose(resumed["losses"], whole["losses"][4:],
                               atol=TRAIN_TOL, rtol=TRAIN_TOL)


def test_trainer_loss_falls_and_restart_bit_exact():
    with tempfile.TemporaryDirectory() as d:
        out = _trainer("port", d, 4, tcfg={"microbatches": 2}).run()
        out2 = _trainer("port", d, 6, tcfg={"microbatches": 2}).run()
    with tempfile.TemporaryDirectory() as d2:
        ref = _trainer("port", d2, 6, tcfg={"microbatches": 2}).run()
    assert ref["losses"][-1] < ref["losses"][0]
    assert out["losses"] == ref["losses"][:4]
    # the resumed run's tail equals the uninterrupted run's, bit for bit
    assert out2["losses"] == ref["losses"][4:]


def test_trainer_crash_recovery():
    with tempfile.TemporaryDirectory() as d:
        boom = {"armed": True}

        def inject(step):
            if step == 5 and boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("host died")

        tr = _trainer("port", d, 7, failure_injector=inject)
        out = tr.run()
        assert out["final_step"] == 7 and out["restarts"] == 1
        # steps 4 and 5 ran again from the step-4 checkpoint
        assert [h["step"] for h in tr.history] == [0, 1, 2, 3, 4, 4, 5, 6]
        assert tr.history[4]["loss"] == tr.history[5]["loss"]


def test_trainer_gives_up_after_max_restarts():
    with tempfile.TemporaryDirectory() as d:
        def always_fail(step):
            raise RuntimeError("permanently broken")

        tr = _trainer("port", d, 5, rcfg={"max_restarts": 2},
                      failure_injector=always_fail)
        with pytest.raises(RuntimeError):
            tr.run()
        assert tr.restarts == 3


def test_watchdog_flags_the_reference_events():
    rng = np.random.default_rng(0)
    times = np.concatenate([rng.uniform(0.09, 0.11, 30), [0.35, 0.11],
                            [0.5, 0.6, 0.7, 0.3], rng.uniform(0.09, 0.11, 10),
                            [0.25]])
    for kw in (dict(window=20, threshold=2.0, warmup=2),
               dict(window=50, threshold=1.5, warmup=5, escalate_after=2)):
        seen = {"ref": [], "port": []}
        r_wd = r_train.StragglerWatchdog(**kw, on_flag=seen["ref"].append)
        t_wd = t_train.StragglerWatchdog(**kw, on_flag=seen["port"].append)
        for i, dt in enumerate(times):
            assert t_wd.observe(i, float(dt)) == r_wd.observe(i, float(dt))
            assert t_wd.should_escalate == r_wd.should_escalate
        assert [vars(e) for e in seen["port"]] == [
            vars(e) for e in seen["ref"]] and seen["port"]
        assert t_wd.median_s == r_wd.median_s


# -------------------------------------------------------------------- CLI
def test_train_cli_prints_the_reference_summary(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma_2b", "--tiny", "--steps", "4", "--seq-len", "16",
         "--microbatches", "2", "--ckpt-dir", str(tmp_path / "ck"),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    # the reference CLI's line: arch=<name> steps=N restarts=R loss a -> b
    assert re.fullmatch(r"arch=gemma-2b steps=4 restarts=0 "
                        r"loss \d+\.\d{4} -> \d+\.\d{4}",
                        out.stdout.strip()), out.stdout
    assert t_ckpt.latest_step(str(tmp_path / "ck")) == 4
    if not torch.cuda.is_available():
        from repro_torch.launch.train import main

        with pytest.raises(SystemExit, match="no CUDA device"):
            main(["--arch", "gemma_2b", "--tiny", "--steps", "1",
                  "--ckpt-dir", str(tmp_path / "ck2")])
