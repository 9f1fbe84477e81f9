"""whisper-tiny's encoder-decoder in the port (``configs/whisper_tiny.py``,
``models/encdec.py``, the layernorm, the ungated gelu MLP, the sinusoidal
positions and ``blocks.cross_attention_decode``) against the JAX
reference on the same inputs: the tiny config, the reference's random
init carried across with ``params_from_reference``, tokens and frames
drawn from fixed numpy seeds. K7 runs as its plain version on the CPU.

Tolerances:
- float32 compute: 1e-5 relative, that is |port - ref| <= 1e-5 ·
  max(1, max|ref|) per tensor (logits, hidden states, caches, the loss,
  every gradient leaf; the same operations on the same weights, summed
  in other orders);
- bf16 compute: 4e-3 · max(1, max|ref|) (one bf16 step of the largest
  value, about 2^-8, with room for the rounding of the intermediates);
- the reference's ``test_smoke_decode_matches_forward`` check on the
  port: prefill + one decode step equal the teacher-forced forward within
  atol 2e-4, rtol 1e-4, as there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as r_optim
import repro.train as r_train
from repro.configs import get_config as r_get_config
from repro.configs import get_tiny as r_get_tiny
from repro.models import Model as RModel
from repro.models import blocks as r_blocks
from repro.models import encdec as r_encdec
from repro.models import layers as r_layers

import repro_torch.optim as t_optim
import repro_torch.train as t_train
from repro_torch.configs import get_config, get_tiny
from repro_torch.convert import (
    cache_from_reference,
    opt_state_from_reference,
    params_from_reference,
)
from repro_torch.models import Model
from repro_torch.models import blocks as t_blocks
from repro_torch.models import encdec as t_encdec
from repro_torch.models import layers as t_layers
from repro_torch.models import lm as t_lm
from repro_torch.tree import leaves, leaves_with_path

TOL = 1e-5
BF16_TOL = 4e-3
SMOKE_ATOL, SMOKE_RTOL = 2e-4, 1e-4
FULL_PARAMS = 56_364_288


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


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32),
        "enc_frames": rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
        .astype(np.float32),
    }


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def tiny():
    """(reference cfg, port cfg, reference params, port params), float32
    compute."""
    r_cfg = r_get_tiny("whisper_tiny").replace(compute_dtype="float32")
    t_cfg = get_tiny("whisper_tiny").replace(compute_dtype="float32")
    r_params = RModel(r_cfg).init_params(jax.random.key(0))
    t_params = params_from_reference(jax.tree.map(np.asarray, r_params),
                                     device="cpu")
    return r_cfg, t_cfg, r_params, t_params


# ------------------------------------------------------------- the configs
def test_configs_and_param_count_equal_the_reference():
    for t, r in ((get_config("whisper_tiny"), r_get_config("whisper_tiny")),
                 (get_tiny("whisper_tiny"), r_get_tiny("whisper_tiny"))):
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert get_config("whisper-tiny") == get_config("whisper_tiny")
    assert get_config("whisper_tiny").param_count() == FULL_PARAMS == \
        r_get_config("whisper_tiny").param_count()
    assert get_tiny("whisper_tiny").param_count() == \
        r_get_tiny("whisper_tiny").param_count()


def test_param_tree_matches_reference(tiny):
    """The port's init has the reference's keys, shapes and dtypes, the
    layernorm biases at 0 and their scales at 1."""
    r_cfg, t_cfg, _, _ = tiny
    want = {"/".join(str(getattr(k, "key", k)) for k in path): s
            for path, s in jax.tree_util.tree_flatten_with_path(
                RModel(r_cfg).param_specs())[0]}
    got = Model(t_cfg).init_params(0, device="cpu")
    flat = {"/".join(p): t for p, t in leaves_with_path(got)}
    assert sorted(flat) == sorted(want)
    for k, t in flat.items():
        assert tuple(t.shape) == want[k].shape, k
        assert t.dtype == torch.float32
    assert not bool(got["enc_layers"]["ln1"]["bias"].any())
    assert bool((got["layers"]["lnx"]["scale"] == 1).all())
    assert set(got["layers"]["mlp"]) == {"wi", "wo"}     # ungated
    assert list(t_lm.model_template(t_cfg)) == list(
        __import__("repro.models.lm", fromlist=["x"]).model_template(r_cfg))


# ------------------------------------------------------------- the layers
def test_layernorm_gelu_mlp_and_sinusoidal_match_reference(tiny):
    r_cfg, _, r_params, t_params = tiny
    rng = np.random.default_rng(1)
    x = (3.0 * rng.normal(size=(2, 24, r_cfg.d_model)) + 0.5).astype(
        np.float32)
    scale = rng.normal(size=(r_cfg.d_model,)).astype(np.float32)
    bias = rng.normal(size=(r_cfg.d_model,)).astype(np.float32)
    _rel_close(t_layers.layernorm(*(torch.from_numpy(a)
                                    for a in (x, scale, bias))),
               r_layers.layernorm(jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias)))
    lp_r = jax.tree.map(lambda a: a[0], r_params["layers"])
    lp_t = t_lm._layer(t_params["layers"], 0)
    _rel_close(t_layers.apply_norm(torch.from_numpy(x), lp_t["lnx"],
                                   "layernorm"),
               r_layers.apply_norm(jnp.asarray(x), lp_r["lnx"], "layernorm"))
    _rel_close(t_layers.mlp(torch.from_numpy(x), lp_t["mlp"], "gelu"),
               r_layers.mlp(jnp.asarray(x), lp_r["mlp"], "gelu"))
    for seq, d in ((24, 64), (7, 10)):
        _rel_close(t_layers.sinusoidal_positions(seq, d),
                   r_layers.sinusoidal_positions(seq, d))
    # at whisper-tiny's 1500 frames the angles reach 1499 rad, whose float32
    # rounding step is 1.2e-4: the two packages' exp round the frequencies
    # apart by an ulp, so the tables agree to 2 steps of the largest angle
    got = _np(t_layers.sinusoidal_positions(1500, 384))
    want = np.asarray(r_layers.sinusoidal_positions(1500, 384))
    assert float(np.abs(got - want).max()) <= 2 * np.spacing(
        np.float32(1499.0))
    _rel_close(got[:100], want[:100])
    # bf16 in, bf16 out, float32 inside
    xb = torch.from_numpy(x).bfloat16()
    got = t_layers.layernorm(xb, torch.from_numpy(scale),
                             torch.from_numpy(bias))
    want = r_layers.layernorm(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(scale), jnp.asarray(bias))
    assert got.dtype == torch.bfloat16
    _rel_close(got, np.asarray(want, np.float32), BF16_TOL)


def test_cross_attention_decode_matches_reference(tiny):
    r_cfg, t_cfg, r_params, t_params = tiny
    rng = np.random.default_rng(2)
    H, D = r_cfg.n_kv_heads, r_cfg.head_dim_
    x = rng.normal(size=(3, 1, r_cfg.d_model)).astype(np.float32)
    k = rng.normal(size=(3, r_cfg.encoder_seq, H, D)).astype(np.float32)
    v = rng.normal(size=(3, r_cfg.encoder_seq, H, D)).astype(np.float32)
    lp_r = jax.tree.map(lambda a: a[1], r_params["layers"])
    lp_t = t_lm._layer(t_params["layers"], 1)
    got = t_blocks.cross_attention_decode(
        torch.from_numpy(x), lp_t["xattn"], t_cfg, torch.from_numpy(k),
        torch.from_numpy(v))
    want = r_blocks.cross_attention_decode(
        jnp.asarray(x), lp_r["xattn"], r_cfg, jnp.asarray(k), jnp.asarray(v))
    _rel_close(got, want)


# ------------------------------------------------------ encoder and forward
def test_encode_matches_reference(tiny):
    r_cfg, t_cfg, r_params, t_params = tiny
    frames = _batch(r_cfg, 2, 8, 3)["enc_frames"]
    _rel_close(t_encdec.encode(t_cfg, t_params, torch.from_numpy(frames)),
               r_encdec.encode(r_cfg, r_params, jnp.asarray(frames)))


def test_forward_and_loss_match_reference(tiny):
    r_cfg, t_cfg, r_params, t_params = tiny
    batch = _batch(r_cfg, 2, 20, 4)
    r_logits, _ = r_encdec.forward(r_cfg, r_params, _jbatch(batch))
    t_logits, aux = Model(t_cfg).forward(t_params, batch, device="cpu")
    assert aux == {} and t_logits.dtype == torch.float32
    _rel_close(t_logits, r_logits)
    r_loss, r_m = RModel(r_cfg).loss(r_params, _jbatch(batch))
    t_loss, t_m = Model(t_cfg).loss(t_params, batch, device="cpu")
    assert set(t_m) == set(r_m) == {"ce", "loss"}
    _rel_close(t_loss, r_loss)
    _rel_close(t_m["ce"], r_m["ce"])


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_gradients_match_reference(tiny, remat):
    """Every leaf's gradient of ``loss_fn`` (the decoder rematerialised or
    not), encoder included."""
    r_cfg, t_cfg, r_params, _ = tiny
    batch = _batch(r_cfg, 2, 16, 5)
    r_grads = jax.grad(lambda p: RModel(r_cfg).loss(p, _jbatch(batch))[0])(
        r_params)
    t_params = params_from_reference(jax.tree.map(np.asarray, r_params),
                                     device="cpu")
    flat = leaves(t_params, torch.is_tensor)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = Model(t_cfg.replace(remat=remat)).loss(t_params, batch,
                                                    device="cpu")
    grads = torch.autograd.grad(loss, flat)
    want = _ref_leaves(r_grads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        _rel_close(g, w)


def test_bf16_forward_within_tolerance_of_reference():
    r_cfg = r_get_tiny("whisper_tiny")
    t_cfg = get_tiny("whisper_tiny")
    assert t_cfg.compute_dtype == "bfloat16"
    r_params = RModel(r_cfg).init_params(jax.random.key(6))
    t_params = params_from_reference(jax.tree.map(np.asarray, r_params),
                                     device="cpu")
    batch = _batch(r_cfg, 2, 12, 6)
    r_logits, _ = r_encdec.forward(r_cfg, r_params, _jbatch(batch))
    t_logits, _ = t_encdec.forward(t_cfg, t_params, batch, device="cpu")
    _rel_close(t_logits, r_logits, BF16_TOL)


# ------------------------------------------------------ prefill and decode
def _pad_cache(cache, max_seq):
    """The prefill cache's self-attention K/V zero-padded to max_seq."""
    def pad(t):
        out = torch.zeros(t.shape[:2] + (max_seq,) + t.shape[3:],
                          dtype=t.dtype)
        out[:, :, :t.shape[2]] = t
        return out

    return t_encdec.EncDecCache(
        self_kv=type(cache.self_kv)(k=pad(cache.self_kv.k),
                                    v=pad(cache.self_kv.v)),
        cross_kv=cache.cross_kv)


def test_prefill_and_decode_steps_match_reference(tiny):
    """Prefill (logits and both cache halves), then 4 decode steps from the
    padded cache, the reference choosing each next token; the reference's
    cache carried across with ``cache_from_reference`` gives the same
    step."""
    r_cfg, t_cfg, r_params, t_params = tiny
    batch = _batch(r_cfg, 2, 9, 7)
    r_logits, r_pre = r_encdec.prefill(r_cfg, r_params, _jbatch(batch))
    model = Model(t_cfg)
    t_logits, t_pre = model.prefill(t_params, batch, device="cpu")
    _rel_close(t_logits, r_logits)
    for a, b in zip(leaves(t_pre), _ref_leaves(r_pre)):
        _rel_close(a, b)
    max_seq = 16
    tpl = model.cache_template(2, max_seq)
    assert [tuple(t.shape) for t in leaves(tpl)] == [
        s.shape for s in jax.tree.leaves(RModel(r_cfg).cache_template(
            2, max_seq))]
    assert all(t.device.type == "meta" for t in leaves(tpl))
    zero = model.init_cache(2, max_seq, device="cpu")
    assert all(not bool(t.any()) for t in leaves(zero))
    r_cache = jax.tree.map(
        lambda c, t: jnp.pad(c, [(0, ts - cs)
                                 for cs, ts in zip(c.shape, t.shape)]),
        r_pre, r_encdec.init_cache(r_cfg, 2, max_seq))
    t_cache = _pad_cache(t_pre, max_seq)
    carried = cache_from_reference(jax.tree.map(np.asarray, r_cache),
                                   device="cpu")
    assert type(carried) is t_encdec.EncDecCache
    tok = np.asarray(r_logits).argmax(-1)[:, None].astype(np.int32)
    for pos in range(9, 13):
        r_logits, r_cache = r_encdec.decode_step(
            r_cfg, r_params, r_cache, jnp.asarray(tok), jnp.int32(pos))
        t_logits, out = model.decode_step(t_params, t_cache, tok, pos,
                                          device="cpu")
        assert out is t_cache                       # written in place
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
    r_cfg, t_cfg, _, t_params = tiny
    B, S = 2, 16
    rng = np.random.default_rng(8)
    toks = rng.integers(1, t_cfg.vocab_size, (B, S + 1)).astype(np.int32)
    frames = 0.01 * np.ones((B, t_cfg.encoder_seq, t_cfg.d_model),
                            np.float32)
    model = Model(t_cfg)
    full, _ = model.forward(t_params, {"tokens": toks, "enc_frames": frames},
                            device="cpu")
    _, cache = model.prefill(t_params, {"tokens": toks[:, :S],
                                        "enc_frames": frames}, device="cpu")
    logits, _ = model.decode_step(t_params, _pad_cache(cache, S + 8),
                                  toks[:, S:S + 1], S, device="cpu")
    np.testing.assert_allclose(_np(logits), _np(full[:, S]), atol=SMOKE_ATOL,
                               rtol=SMOKE_RTOL)


# ----------------------------------------------------------------- training
def test_train_step_with_enc_frames_matches_reference(tiny):
    """One ``make_train_step`` step on a batch of ``tokens`` and
    ``enc_frames`` (as the reference's smoke test builds it): metrics,
    moments and parameters, at microbatches 1 and 2."""
    r_cfg, t_cfg, r_params, _ = tiny
    ocfg = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
    rc, tc = r_optim.OptimConfig(**ocfg), t_optim.OptimConfig(**ocfg)
    batch = _batch(r_cfg, 4, 16, 9)
    params_np = jax.tree.map(np.asarray, r_params)
    state_np = jax.tree.map(np.array, r_optim.init_state(rc, r_params))
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
            _rel_close(a, b, 1e-4)
        # AdamW's first step moves every parameter by at most ~2 lr
        lr = float(r_m["lr"])
        for a, b in zip(leaves(t_p, torch.is_tensor), _ref_leaves(r_p)):
            assert float(np.abs(_np(a) - b).max()) <= TOL + 2 * lr


# ---------------------------------------------------------------- launchers
def test_launchers_do_what_the_reference_does_with_whisper(capsys,
                                                          tmp_path):
    """The reference's token pipeline and serving engine carry no
    ``enc_frames``: its serve (generate) and train launchers stop on
    ``KeyError: 'enc_frames'`` for whisper_tiny, and the port's do the
    same; retrieval mode (the decoder stack as an encoder) serves."""
    from repro_torch.launch import serve as t_serve_cli
    from repro_torch.launch import train as t_train_cli

    with pytest.raises(KeyError, match="enc_frames"):
        t_serve_cli.main(["--arch", "whisper_tiny", "--tiny", "--requests",
                          "1", "--device", "cpu"])
    with pytest.raises(KeyError, match="enc_frames"):
        t_train_cli.main(["--arch", "whisper_tiny", "--tiny", "--steps", "1",
                          "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu"])
    capsys.readouterr()
    t_serve_cli.main(["--arch", "whisper_tiny", "--tiny", "--mode",
                      "retrieval", "--docs", "60", "--queries", "2",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "indexed 60 docs" in out
    assert out.count("(exact vs scan: OK)") == 2
