"""The port's LM encoder (``repro_torch.models``) and K7's plain version
against the JAX reference on the same inputs (numpy seeds, the reference's
random init carried across with ``params_from_reference``).

Tolerances: 2e-5 for attention (float32, the two online softmaxes sum in
different orders: the bound the reference's own kernel test uses), 1e-5
for layers, blocks and the pooled forward in float32 (the same operations
on the same weights; the sums differ in order only).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import get_tiny as r_get_tiny
from repro.kernels.flash_attention import flash_attention as r_flash
from repro.models import Model as RModel
from repro.models import blocks as r_blocks
from repro.models import layers as r_layers
from repro.models import lm as r_lm
from repro.serve.retrieval import RetrievalConfig as RConfig
from repro.serve.retrieval import RetrievalService as RService

from repro_torch.configs import get_config, get_tiny
from repro_torch.convert import params_from_reference
from repro_torch.models import Model
from repro_torch.models import blocks as t_blocks
from repro_torch.models import layers as t_layers
from repro_torch.models import lm as t_lm
from repro_torch.serve import RetrievalConfig, RetrievalService
from repro_torch.tree import leaves

t_fa = importlib.import_module("repro_torch.kernels.flash_attention")

ATTN_TOL = 2e-5
TOL = 1e-5


def _qkv(seed, B, Sq, Sk, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    return q, k, v


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# --------------------------------------------------------------- attention
# the four shapes of tests/test_kernels_attention.py
SHAPES = [
    (1, 128, 128, 4, 4, 32),     # MHA square
    (2, 128, 256, 8, 2, 64),     # GQA, kv longer
    (1, 100, 100, 4, 1, 32),     # MQA, non-multiple seq (padding)
    (2, 64, 192, 6, 3, 16),      # odd head count
]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_k7_matches_pallas_and_blocked_reference(shape, causal):
    q, k, v = _qkv(sum(shape), *shape)
    got = t_fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    pallas = r_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, q_blk=64, kv_blk=64, interpret=True)
    blocked = r_layers._blocked_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_chunk=32, kv_chunk=32)
    _close(got, pallas, ATTN_TOL)
    _close(got, blocked, ATTN_TOL)
    # the port's copy of the blocked path agrees with the reference's too
    t_blocked = t_layers._blocked_attention_impl(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_chunk=32, kv_chunk=32)
    _close(t_blocked, blocked, ATTN_TOL)


@pytest.mark.parametrize("window", [16, 64])
def test_plain_k7_sliding_window_matches_reference(window):
    q, k, v = _qkv(window, 1, 160, 160, 4, 4, 32)
    got = t_fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=True,
                                     window=window)
    pallas = r_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, window=window, q_blk=64, kv_blk=64,
                     interpret=True)
    blocked = r_layers._blocked_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_chunk=32, kv_chunk=32)
    _close(got, pallas, ATTN_TOL)
    _close(got, blocked, ATTN_TOL)


@pytest.mark.parametrize("valid_len", [1, 37, 100, 160])
@pytest.mark.parametrize("window", [0, 24])
def test_plain_k7_valid_len_matches_reference(valid_len, window):
    """Decode over a partly filled cache: the reference kernel with
    ``valid_len`` and its pure decode path."""
    q, k, v = _qkv(valid_len + window, 2, 1, 160, 8, 2, 32)
    got = t_fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=False,
                                     window=window, valid_len=valid_len)
    pallas = r_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=False, window=window,
                     valid_len=jnp.int32(valid_len), interpret=True)
    oracle = r_layers._decode_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(valid_len),
        window=window)
    _close(got, pallas, ATTN_TOL)
    _close(got, oracle, ATTN_TOL)


def test_plain_k7_rows_with_no_key_are_zero():
    q, k, v = _qkv(3, 1, 4, 20, 2, 1, 32)
    got = t_fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=False,
                                     valid_len=0)
    assert torch.equal(got, torch.zeros_like(got))


def test_blocked_attention_runs_k7_and_matches_reference():
    q, k, v = _qkv(5, 2, 40, 40, 4, 1, 32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = t_fa.LAUNCHES["flash_attention"]
    got = t_layers.blocked_attention(tq, tk, tv, causal=True)
    want = r_layers.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True,
                                      q_chunk=16, kv_chunk=16)
    _close(got, want, ATTN_TOL)
    # on a CPU tensor K7's plain version runs: exactly that function,
    # and no launch is counted
    plain = t_fa.flash_attention_plain(tq, tk, tv, causal=True)
    assert torch.equal(got, plain)
    assert t_fa.LAUNCHES["flash_attention"] == before


class _OtherDevice(torch.Tensor):
    """Shape-only tensors on a device with no kernel and no plain version
    (neither CPU nor CUDA nor ``meta``); any op on one fails."""

    @staticmethod
    def __new__(cls, shape):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=torch.float32, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} ran on a device with no kernel")


def test_k7_wrapper_checks_and_refuses_devices_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        t_fa.flash_attention(_OtherDevice((1, 4, 2, 32)),
                             _OtherDevice((1, 4, 1, 32)),
                             _OtherDevice((1, 4, 1, 32)))
    # on ``meta`` (the roofline's counter) nothing runs: an empty output
    x = torch.zeros((1, 4, 2, 32), device="meta")
    before = t_fa.LAUNCHES["flash_attention"]
    out = t_fa.flash_attention(x, x[:, :, :1], x[:, :, :1])
    assert out.device.type == "meta" and out.shape == x.shape
    assert t_fa.LAUNCHES["flash_attention"] == before
    q = torch.zeros((1, 4, 3, 32))
    with pytest.raises(ValueError, match="query heads"):
        t_fa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    before = t_fa.LAUNCHES["flash_attention"]
    t_fa.flash_attention(q, q[:, :, :1], q[:, :, :1])       # plain: no launch
    assert t_fa.LAUNCHES["flash_attention"] == before


# ------------------------------------------------------------ layers/blocks
@pytest.fixture(scope="module")
def tiny():
    """The tiny gemma in float32 with the reference's random init, in both
    packages."""
    r_cfg = r_get_tiny("gemma_2b").replace(compute_dtype="float32")
    t_cfg = get_tiny("gemma_2b").replace(compute_dtype="float32")
    r_params = RModel(r_cfg).init_params(jax.random.key(0))
    t_params = params_from_reference(jax.tree.map(np.asarray, r_params),
                                     device="cpu")
    return r_cfg, t_cfg, r_params, t_params


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["layers"])


def _tree(template):
    """{path: (shape, axes, kind, init)} of either package's parameter
    template (both ``PSpec``s are NamedTuples of those fields)."""
    if isinstance(template, dict):
        return {(k,) + path: spec for k, v in template.items()
                for path, spec in _tree(v).items()}
    return {(): tuple(template)}


def test_config_and_template_match_reference(tiny):
    r_cfg, t_cfg, r_params, t_params = tiny
    assert get_config("gemma_2b").replace(compute_dtype="float32") \
        .__dict__ == r_get_config("gemma_2b").replace(
            compute_dtype="float32").__dict__
    assert t_lm.count_params(get_config("gemma_2b")) == r_lm.count_params(
        r_get_config("gemma_2b")) == 2_506_172_416
    assert t_lm.count_params(t_cfg) == r_lm.count_params(r_cfg)
    flat_r = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
              jax.tree_util.tree_flatten_with_path(r_params)[0]}
    own = t_lm.init_params(t_cfg, torch.Generator().manual_seed(0), "cpu")
    flat_t = {jax.tree_util.keystr(p): a for p, a in
              jax.tree_util.tree_flatten_with_path(own)[0]}
    assert flat_r.keys() == flat_t.keys()
    for key, a in flat_r.items():
        assert tuple(flat_t[key].shape) == a.shape, key
        assert flat_t[key].dtype == torch.float32
    # same std: 0.02, and 0.02 / sqrt(2 L) for the output projections
    wo = flat_t["['layers']['attn']['wo']"]
    assert abs(float(wo.std()) - 0.02 / np.sqrt(4)) < 2e-3
    assert abs(float(flat_t["['embed']"].std()) - 0.02) < 2e-3


def test_norm_rope_and_mlp_match_reference(tiny):
    r_cfg, t_cfg, r_params, t_params = tiny
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 24, r_cfg.d_model)).astype(np.float32)
    r_lp, t_lp = _layer0(r_params), t_lm._layer(t_params["layers"], 0)
    _close(t_layers.apply_norm(torch.from_numpy(x), t_lp["ln1"], "rmsnorm"),
           r_layers.apply_norm(jnp.asarray(x), r_lp["ln1"], "rmsnorm"), TOL)
    pos = np.arange(24)
    cos_r, sin_r = r_layers.rope_angles(jnp.asarray(pos), 32, 10_000.0)
    cos_t, sin_t = t_layers.rope_angles(torch.from_numpy(pos), 32, 10_000.0)
    _close(cos_t, cos_r, TOL)
    _close(sin_t, sin_r, TOL)
    h = rng.normal(size=(2, 24, 4, 32)).astype(np.float32)
    _close(t_layers.apply_rope(torch.from_numpy(h), cos_t, sin_t),
           r_layers.apply_rope(jnp.asarray(h), cos_r, sin_r), TOL)
    for act in ("geglu", "swiglu"):
        _close(t_layers.mlp(torch.from_numpy(x), t_lp["mlp"], act),
               r_layers.mlp(jnp.asarray(x), r_lp["mlp"], act), TOL)
    for act in ("gelu",):              # the ungated MLP (whisper): ported
        _close(t_layers.mlp(torch.from_numpy(x), t_lp["mlp"], act),
               r_layers.mlp(jnp.asarray(x), r_lp["mlp"], act), TOL)
    # the MoE feed-forward is ported (tests/test_torch_moe.py); the vlm's
    # block is the dense block, as the reference's
    t_vlm, _, _ = t_blocks.block_forward(t_cfg.replace(family="vlm"), t_lp,
                                         torch.from_numpy(x),
                                         torch.arange(24))
    r_vlm, _, _ = r_blocks.block_forward(r_cfg.replace(family="vlm"), r_lp,
                                         jnp.asarray(x), jnp.arange(24))
    _close(t_vlm, r_vlm, TOL)
    with pytest.raises(ValueError, match="unknown family"):
        t_blocks.block_forward(t_cfg.replace(family="vision"), t_lp,
                               torch.from_numpy(x), torch.arange(24))


def test_attention_and_block_match_reference(tiny):
    r_cfg, t_cfg, r_params, t_params = tiny
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 24, r_cfg.d_model)).astype(np.float32)
    pos = np.arange(24)
    r_lp = _layer0(r_params)
    t_lp = t_lm._layer(t_params["layers"], 0)
    t_out, _ = t_blocks.attention_full(torch.from_numpy(x), t_lp["attn"],
                                       t_cfg, torch.from_numpy(pos))
    r_out, _ = r_blocks.attention_full(jnp.asarray(x), r_lp["attn"], r_cfg,
                                       jnp.asarray(pos))
    _close(t_out, r_out, TOL)
    t_x, _, _ = t_blocks.block_forward(t_cfg, t_lp, torch.from_numpy(x),
                                       torch.from_numpy(pos))
    r_x, _, _ = r_blocks.block_forward(r_cfg, r_lp, jnp.asarray(x),
                                       jnp.asarray(pos))
    _close(t_x, r_x, TOL)


def test_pooled_forward_matches_reference(tiny):
    """The retrieval encoder end to end (embed, the two layers, the final
    norm, the mean pool), through the two services' ``embed``; 37 rows so
    the last encode batch is padded."""
    r_cfg, t_cfg, r_params, t_params = tiny
    rng = np.random.default_rng(3)
    toks = rng.integers(1, r_cfg.vocab_size, (37, 24)).astype(np.int32)
    r_emb = RService(r_cfg, r_params, RConfig(batch_size=16)).embed(toks)
    t_svc = RetrievalService(t_cfg, t_params,
                             RetrievalConfig(batch_size=16, device="cpu"))
    t_emb = t_svc.embed(toks)
    assert t_emb.shape == r_emb.shape == (37, r_cfg.d_model)
    assert t_emb.dtype == np.float32
    np.testing.assert_allclose(t_emb, r_emb, atol=TOL, rtol=TOL)
    # the embedding scale of tied embeddings, and the stack on its own
    h_t = t_lm.embed_tokens(t_cfg, t_params, torch.from_numpy(toks[:2]).long())
    h_r = r_lm.embed_tokens(r_cfg, r_params, jnp.asarray(toks[:2]))
    _close(h_t, h_r, TOL)


def test_model_init_on_requested_device_and_unported_families_raise(tiny):
    _, t_cfg, _, _ = tiny
    p1 = Model(t_cfg).init_params(7, device="cpu")
    p2 = Model(t_cfg).init_params(torch.Generator().manual_seed(7),
                                  device="cpu")
    assert torch.equal(p1["embed"], p2["embed"])
    assert p1["layers"]["attn"]["wq"].shape == (2, 64, 4, 32)
    # every family is ported: the vlm's template (its vision_adapter),
    # llava-next-34b's config, the ssm, hybrid and MoE families, the
    # layernorm and whisper-tiny match the reference; an unknown name is
    # refused
    assert _tree(t_lm.model_template(t_cfg.replace(family="vlm"))) == _tree(
        r_lm.model_template(r_get_tiny("gemma_2b").replace(family="vlm")))
    assert get_config("llava_next_34b").__dict__ == r_get_config(
        "llava_next_34b").__dict__
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("llava_next_35b")
    for kw in (dict(family="hybrid", ssm_state=8, ssm_heads=4,
                    ssm_head_dim=16, sliding_window=16),
               dict(family="moe", n_experts=4, experts_per_token=2)):
        assert _tree(t_lm.model_template(t_cfg.replace(**kw))) == _tree(
            r_lm.model_template(r_get_tiny("gemma_2b").replace(**kw)))
    ssm = dict(family="ssm", ssm_state=8, ssm_heads=2, ssm_head_dim=8,
               d_ff=0)
    for kw in (ssm, dict(norm="layernorm")):
        got = [tuple(t.shape) for t in leaves(t_lm.param_specs(
            t_cfg.replace(**kw)))]
        want = [s.shape for s in jax.tree.leaves(r_lm.param_specs(
            r_get_tiny("gemma_2b").replace(**kw)))]
        assert got == want
    assert get_config("whisper_tiny").__dict__ == r_get_config(
        "whisper_tiny").__dict__
