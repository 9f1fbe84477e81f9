"""The vlm family in the port (``configs/llava_next_34b.py``; the patch
embeddings through ``vision_adapter`` in front of the text in ``lm.py``),
the shape registry (``SHAPES``, ``shape_applicable``, ``input_specs``) and
the optimized profiles (``configs/profiles.py``) against the JAX
reference on the same inputs: the tiny llava (2 layers, d 64, 8 vision
tokens) in float32, the reference's random init carried across with
``params_from_reference``, tokens and patch embeddings drawn with numpy
from fixed seeds.

Tolerances (those of ``tests/test_torch_dense.py``):
- logits, the decode caches: 1e-5 absolute and relative, float32;
- the loss and its metrics: 1e-5 relative;
- gradients, ``vision_adapter``'s included: 1e-4 · max(1, max|ref|) per
  leaf;
- decode logits against the teacher-forced forward: 1e-5;
- bf16 compute: 4e-3 · max(1, |ref|) elementwise, K7's bf16 tolerance;
- one ``make_train_step`` step: metrics 1e-5 relative, moments 1e-4 ·
  max(1, max|ref|), parameters within 1e-5 plus 2 lr (AdamW's first step
  moves a parameter by at most ~lr).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as r_configs
import repro.models as r_models
import repro.optim as r_optim
import repro.serve as r_serve
import repro.train as r_train
from repro.configs.profiles import optimized_opt_rules as r_opt_rules
from repro.configs.profiles import optimized_overrides as r_overrides
from repro.models import Model as RModel
from repro.models import api as r_api
from repro.models import lm as r_lm

import repro_torch.configs as t_configs
import repro_torch.models as t_models
import repro_torch.optim as t_optim
import repro_torch.train as t_train
from repro_torch.configs import get_config, get_tiny
from repro_torch.configs.profiles import optimized_opt_rules
from repro_torch.configs.profiles import optimized_overrides
from repro_torch.convert import opt_state_from_reference, params_from_reference
from repro_torch.models import SHAPES, Model, input_specs, shape_applicable
from repro_torch.models import api as t_api
from repro_torch.models import lm as t_lm
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.tree import leaves, leaves_with_path

ARCH = "llava_next_34b"
FULL_PARAMS = 34_440_297_472
FULL_PARAMS_PROFILE = 35_321_101_312
TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 4e-3
B, T = 2, 12


@pytest.fixture(autouse=True)
def _process_state():
    """Run torch on one thread; restore its thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _rel_close(got, want, tol=LOSS_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _ref_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _batch(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab_size, (b, t)).astype(np.int32),
            "vision_embeds": rng.normal(size=(b, cfg.vision_tokens,
                                              cfg.d_model)).astype(np.float32)}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def tiny():
    """(reference cfg, port cfg, reference params, their numpy copies, a
    batch) for the tiny llava in float32."""
    r_cfg = r_configs.get_tiny(ARCH).replace(compute_dtype="float32")
    t_cfg = get_tiny(ARCH).replace(compute_dtype="float32")
    r_params = RModel(r_cfg).init_params(jax.random.key(0))
    return (r_cfg, t_cfg, r_params, jax.tree.map(np.asarray, r_params),
            _batch(r_cfg, B, T, 1))


def _port(tiny):
    return params_from_reference(tiny[3], device="cpu")


# ------------------------------------------------------------ the registry
def test_configs_and_exports_equal_the_reference():
    assert t_configs.ARCH_IDS == r_configs.ARCH_IDS
    assert t_configs.ALIASES == r_configs.ALIASES
    assert t_models.__all__ == r_models.__all__
    assert {k: dataclasses.asdict(v)
            for k, v in t_configs.all_configs().items()} == {
        k: dataclasses.asdict(v) for k, v in r_configs.all_configs().items()}
    for name in r_configs.ARCH_IDS:
        assert dataclasses.asdict(get_tiny(name)) == dataclasses.asdict(
            r_configs.get_tiny(name))
    cfg = get_config("llava-next-34b")
    assert cfg == get_config(ARCH) and cfg.family == "vlm"
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_, cfg.d_ff, cfg.vocab_size, cfg.vision_tokens) == (
        60, 7168, 56, 8, 128, 20480, 64000, 576)
    with pytest.raises(KeyError, match="unknown architecture"):
        get_tiny("llava_next_35b")


def test_count_params_and_specs_at_full_size():
    cfg = get_config(ARCH)
    prof = cfg.replace(**optimized_overrides(ARCH))
    assert cfg.param_count() == r_configs.get_config(ARCH).param_count() \
        == FULL_PARAMS
    assert prof.n_heads_padded == 64
    assert t_lm.count_params(prof) == FULL_PARAMS_PROFILE == \
        r_configs.get_config(ARCH).replace(
            **r_overrides(ARCH)).param_count()
    for c, rc in ((cfg, r_configs.get_config(ARCH)),
                  (prof, r_configs.get_config(ARCH).replace(
                      **r_overrides(ARCH)))):
        got = list(leaves_with_path(t_lm.param_specs(c)))
        want = jax.tree_util.tree_flatten_with_path(r_lm.param_specs(rc))[0]
        assert len(got) == len(want) == 13
        for (path, t), (r_path, r) in zip(got, want):
            assert path == tuple(k.key for k in r_path)
            assert t.device.type == "meta" and tuple(t.shape) == r.shape
            assert str(t.dtype).split(".")[-1] == str(r.dtype)
    assert tuple(t_lm.param_specs(cfg)["vision_adapter"].shape) == (7168,
                                                                    7168)


def test_shapes_and_input_specs_equal_the_reference():
    assert list(SHAPES) == list(r_models.SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(
            r_models.SHAPES[name])
    for arch in r_configs.ARCH_IDS:
        t_cfg, r_cfg = get_config(arch), r_configs.get_config(arch)
        for name, s in SHAPES.items():
            assert shape_applicable(t_cfg, s) == r_models.shape_applicable(
                r_cfg, r_models.SHAPES[name])
            got = input_specs(t_cfg, s)
            want = r_models.input_specs(r_cfg, r_models.SHAPES[name])
            assert list(got) == list(want), (arch, name)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == want[k].shape, (arch, name, k)
                assert str(t.dtype).split(".")[-1] == str(want[k].dtype)
    assert t_api.INPUT_LOGICAL_AXES == r_api.INPUT_LOGICAL_AXES
    vlm = input_specs(get_config(ARCH), SHAPES["train_4k"])
    assert tuple(vlm["tokens"].shape) == (256, 4096 - 576)


def test_profiles_equal_the_reference():
    for arch in r_configs.ARCH_IDS:
        for name in (arch, arch.replace("_", "-")):
            assert optimized_overrides(name) == r_overrides(name)
        get_config(arch).replace(**optimized_overrides(arch))
    assert optimized_opt_rules() == r_opt_rules()
    assert optimized_opt_rules()["embed"] == ("data",)


# -------------------------------------------------- forward, loss, gradient
def test_forward_logits_match_reference(tiny):
    r_cfg, t_cfg, r_params, _, batch = tiny
    r_logits, _ = jax.jit(lambda p, b: RModel(r_cfg).forward(p, b))(
        r_params, _jbatch(batch))
    with torch.no_grad():
        t_logits, aux = Model(t_cfg).forward(_port(tiny), batch,
                                             device="cpu")
    assert aux == {}
    # text positions only: the vision positions are stripped
    assert t_logits.shape == (B, T, r_cfg.vocab_size)
    _close(t_logits, r_logits)
    # the adapter is read: zeroing it moves the text logits
    params = _port(tiny)
    params["vision_adapter"].zero_()
    with torch.no_grad():
        moved, _ = Model(t_cfg).forward(params, batch, device="cpu")
    assert float((moved - t_logits).abs().max()) > 1e-4


@pytest.mark.parametrize("ce_chunk", [0, 16])
def test_loss_matches_reference(tiny, ce_chunk):
    r_cfg, t_cfg, r_params, _, batch = tiny
    rc, tc = r_cfg.replace(ce_chunk=ce_chunk), t_cfg.replace(ce_chunk=ce_chunk)
    _, r_m = jax.jit(lambda p, b: RModel(rc).loss(p, b))(r_params,
                                                         _jbatch(batch))
    with torch.no_grad():
        _, t_m = Model(tc).loss(_port(tiny), batch, device="cpu")
    assert set(t_m) == set(r_m) == {"ce", "zloss", "loss"}
    for k in t_m:
        np.testing.assert_allclose(float(t_m[k]), float(r_m[k]),
                                   rtol=LOSS_TOL)


def test_every_gradient_matches_reference(tiny):
    r_cfg, t_cfg, r_params, _, batch = tiny
    r_grads = jax.jit(jax.grad(lambda p, b: RModel(r_cfg).loss(p, b)[0]))(
        r_params, _jbatch(batch))
    params = _port(tiny)
    flat = leaves(params, torch.is_tensor)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = Model(t_cfg).loss(params, batch, device="cpu")
    got = torch.autograd.grad(loss, flat)
    want = _ref_leaves(r_grads)
    assert len(got) == len(want) == 13
    for g, r in zip(got, want):
        _rel_close(g, r, GRAD_TOL)
    adapter = [path for path, _ in leaves_with_path(params)].index(
        ("vision_adapter",))
    assert float(got[adapter].abs().max()) > 0


def test_bf16_forward_within_k7_tolerance(tiny):
    """bf16 compute (the config's own) on the same float32 parameters."""
    r_cfg, t_cfg, r_params, _, batch = tiny
    rc = r_cfg.replace(compute_dtype="bfloat16")
    r_logits, _ = jax.jit(lambda p, b: RModel(rc).forward(p, b))(
        r_params, _jbatch(batch))
    with torch.no_grad():
        t_logits, _ = Model(t_cfg.replace(compute_dtype="bfloat16")).forward(
            _port(tiny), batch, device="cpu")
    got, want = _np(t_logits), np.asarray(r_logits, np.float32)
    assert got.shape == want.shape
    assert bool((np.abs(got - want)
                 <= BF16_TOL * np.maximum(1.0, np.abs(want))).all())


def test_padded_heads_forward_and_loss_match_reference():
    """The profile's head padding on the tiny llava (3 q heads over 1 kv
    head padded to 4, as the reference's profile test builds it)."""
    kw = dict(compute_dtype="float32", n_heads=3, n_kv_heads=1,
              pad_heads_to_multiple=4)
    r_cfg = r_configs.get_tiny(ARCH).replace(**kw)
    t_cfg = get_tiny(ARCH).replace(**kw)
    assert t_cfg.n_heads_padded == 4
    r_params = RModel(r_cfg).init_params(jax.random.key(0))
    params = params_from_reference(jax.tree.map(np.asarray, r_params),
                                   device="cpu")
    assert params["layers"]["attn"]["wq"].shape == (2, 64, 4, 16)
    batch = _batch(r_cfg, 2, 16, 4)
    r_logits, _ = RModel(r_cfg).forward(r_params, _jbatch(batch))
    _, r_m = RModel(r_cfg).loss(r_params, _jbatch(batch))
    with torch.no_grad():
        t_logits, _ = Model(t_cfg).forward(params, batch, device="cpu")
        _, t_m = Model(t_cfg).loss(params, batch, device="cpu")
    _close(t_logits, r_logits)
    for k in r_m:
        np.testing.assert_allclose(float(t_m[k]), float(r_m[k]),
                                   rtol=LOSS_TOL)


# ------------------------------------------------------------------ decode
def _kv(cache):
    a = cache["layers"].attn
    return {"k": a.k, "v": a.v}


def test_prefill_and_four_decode_steps_match_reference(tiny):
    """Prefill (logits and cache: vision_tokens + T positions), then 4
    decode steps from the cache padded through ``init_cache``, at pos
    vision_tokens + T + i: logits and cache against the reference's
    ``decode_step``, and logits against the teacher-forced forward."""
    r_cfg, t_cfg, r_params, _, batch = tiny
    params = _port(tiny)
    model = Model(t_cfg)
    n_vis, steps = r_cfg.vision_tokens, 4
    full = np.concatenate([batch["tokens"], np.random.default_rng(5).integers(
        1, r_cfg.vocab_size, (B, steps)).astype(np.int32)], axis=1)
    r_logits, pre = r_lm.prefill(r_cfg, r_params, _jbatch(batch))
    with torch.no_grad():
        t_logits, t_pre = model.prefill(params, batch, device="cpu")
        fwd, _ = model.forward(params, dict(batch, tokens=full),
                               device="cpu")
    _close(t_logits, r_logits)
    _close(t_logits, fwd[:, T - 1])
    for name, leaf in _kv(t_pre).items():
        assert leaf.shape[2] == n_vis + T
        _close(leaf, _kv(pre)[name])
    S = n_vis + T + steps
    r_cache = jax.tree.map(lambda c, part: c.at[:, :, :n_vis + T].set(part),
                           r_lm.init_cache(r_cfg, B, S), pre)
    t_cache = model.init_cache(B, S, device="cpu")
    for name, leaf in _kv(t_cache).items():
        leaf[:, :, :n_vis + T] = _kv(t_pre)[name]
    for i in range(steps):
        tok = full[:, T + i:T + i + 1]
        pos = n_vis + T + i
        r_logits, r_cache = r_lm.decode_step(r_cfg, r_params, r_cache,
                                             jnp.asarray(tok), jnp.int32(pos))
        with torch.no_grad():
            t_logits, _ = model.decode_step(params, t_cache, tok, pos,
                                            device="cpu")
        _close(t_logits, r_logits)
        for name, leaf in _kv(t_cache).items():
            _close(leaf, _kv(r_cache)[name])
        if i + 1 < steps:
            _close(t_logits, fwd[:, T + i])


def test_serve_engine_refuses_a_vlm_as_the_reference_does(tiny):
    """Neither engine carries patch embeddings: each stops on
    ``KeyError: 'vision_embeds'`` at its first prefill."""
    r_cfg, t_cfg, r_params, _, batch = tiny
    for eng in (r_serve.ServeEngine(r_cfg, r_params, r_serve.ServeConfig(
                    max_batch=2, max_seq=32, max_new_tokens=2)),
                ServeEngine(t_cfg, _port(tiny), ServeConfig(
                    max_batch=2, max_seq=32, max_new_tokens=2,
                    device="cpu"))):
        eng.submit(batch["tokens"][0])
        with pytest.raises(KeyError, match="vision_embeds"):
            eng.run_until_drained()


# ---------------------------------------------------------------- training
def test_train_step_with_vision_embeds_matches_reference(tiny):
    """One ``make_train_step`` step on a batch of ``tokens`` and
    ``vision_embeds``, at microbatches 1 and 2 (the embeddings sliced with
    the tokens): metrics, moments and parameters."""
    r_cfg, t_cfg, _, params_np, _ = tiny
    ocfg = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
    rc, tc = r_optim.OptimConfig(**ocfg), t_optim.OptimConfig(**ocfg)
    batch = _batch(r_cfg, 4, 16, 9)
    state_np = jax.tree.map(np.array, r_optim.init_state(
        rc, jax.tree.map(jnp.asarray, params_np)))
    for nm in (1, 2):
        r_built = r_train.make_train_step(r_cfg, rc,
                                          r_train.TrainConfig(microbatches=nm))
        r_p, r_s, r_m = r_built["step"](jax.tree.map(jnp.array, params_np),
                                        jax.tree.map(jnp.array, state_np),
                                        _jbatch(batch))
        t_built = t_train.make_train_step(
            t_cfg, tc, t_train.TrainConfig(microbatches=nm), device="cpu")
        t_p, t_s, t_m = t_built["step"](
            params_from_reference(params_np, device="cpu"),
            opt_state_from_reference(jax.tree.map(np.copy, state_np),
                                     device="cpu"), batch)
        assert set(t_m) == set(r_m)
        for k in t_m:
            _rel_close(t_m[k], r_m[k])
        for a, b in zip(leaves(t_s["moments"], torch.is_tensor),
                        _ref_leaves(r_s["moments"])):
            _rel_close(a, b, GRAD_TOL)
        lr = float(r_m["lr"])
        for a, b in zip(leaves(t_p, torch.is_tensor), _ref_leaves(r_p)):
            assert float(np.abs(_np(a) - b).max()) <= TOL + 2 * lr
