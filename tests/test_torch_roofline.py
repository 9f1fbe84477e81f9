"""The port's roofline (``src/repro_torch/roofline/``) against the JAX
reference's (``src/repro/roofline/``), on the CPU, torch on one thread.

- ``model_flops`` and ``flash_io_bytes_per_device`` (at (dp, tp) in
  {(16, 16), (1, 1)}) equal the reference's with ``==`` for every
  architecture at full width, every shape, the published configs and the
  optimized profiles;
- the port's copy of ``parse_hlo_costs`` gives a field-equal ``HloCosts``
  on the text the reference compiles (the three programs of
  ``tests/test_roofline.py`` and a tiny config's train step);
- ``analyze`` gives every field of the reference's report from the same
  costs and ``HW`` at 256 and 512 chips; on one chip the port splits the
  fused attention's traffic 1 x 1 where the reference keeps 16 x 16
  (ROADMAP C-R8), pinned below;
- the step counter (``counter.py``, ``meta`` tensors) counts exact FLOPs
  and bytes on small programs, and K7's work equal to ``chip_smoke.py``'s
  ``flash_count`` (the count behind ``flash_bound_ms``);
- on each architecture's tiny config, the counter's train-step FLOPs
  outside attention are within 2% of the reference's ``parse_hlo_costs``
  on its compiled train step (no mesh). The two differ by design only in
  the SSD's backward, which the test asserts exactly (see
  ``_ssd_backward_dots``). Attention is left out because the two compute
  it differently by design: the reference's CPU path runs the pure
  blocked attention over every (q chunk, kv chunk) pair in the forward,
  remat's recompute and the backward; the port runs K7 (the pairs its
  masks keep) in the forward and the recompute, and the blocked
  attention in float32 in the backward;
- the counter runs every applicable ``SHAPES`` entry for each tiny config
  (``long_500k`` at 8,192 positions).
"""

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as r_configs
import repro.roofline as r_roofline
from repro.configs.profiles import optimized_overrides as r_overrides
from repro.models.api import input_specs as r_input_specs
from repro.models.common import SHAPES as R_SHAPES
from repro.models.common import ShapeConfig as RShapeConfig
from repro.optim import OptimConfig as ROptimConfig
from repro.roofline import analysis as r_analysis
from repro.roofline import hlo_parse as r_hlo
from repro.train.step import make_train_step as r_make_train_step
import repro_torch.configs as t_configs
import repro_torch.roofline as t_roofline
from repro_torch.configs.profiles import optimized_overrides as t_overrides
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import SHAPES, ShapeConfig, shape_applicable
from repro_torch.roofline import analysis as t_analysis
from repro_torch.roofline import hlo_parse as t_hlo
from repro_torch.roofline.counter import count, count_step

# the packages bind ``model_flops`` to the function; the modules by path
r_mf = importlib.import_module("repro.roofline.model_flops")
t_mf = importlib.import_module("repro_torch.roofline.model_flops")

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(t_configs.ARCH_IDS)


@pytest.fixture(autouse=True)
def _process_state():
    """Run torch on one thread; restore its thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ model flops
def test_the_package_exports_the_reference_names():
    assert t_roofline.__all__ == r_roofline.__all__
    for mod, ref in ((t_analysis, r_analysis), (t_hlo, r_hlo),
                     (t_mf, r_mf)):
        assert mod.__all__ == ref.__all__


@pytest.mark.parametrize("profile", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_flash_io_equal_the_reference(arch, profile):
    cfg, rcfg = t_configs.get_config(arch), r_configs.get_config(arch)
    if profile:
        cfg = cfg.replace(**t_overrides(arch))
        rcfg = rcfg.replace(**r_overrides(arch))
    assert SHAPES.keys() == R_SHAPES.keys()
    for name, shape in SHAPES.items():
        rshape = R_SHAPES[name]
        assert t_mf.model_flops(cfg, shape) == r_mf.model_flops(rcfg, rshape)
        assert t_roofline.model_flops(cfg, shape) \
            == r_roofline.model_flops(rcfg, rshape)
        for dp, tp in ((16, 16), (1, 1)):
            assert t_mf.flash_io_bytes_per_device(cfg, shape, dp, tp) \
                == r_mf.flash_io_bytes_per_device(rcfg, rshape, dp, tp)
        assert t_mf.flash_io_bytes_per_device(cfg, shape) \
            == r_mf.flash_io_bytes_per_device(rcfg, rshape)
        for B, S in ((1, 1), (128, 32_768), (1, 524_288)):
            assert t_mf._decode_attn_flops(cfg, B, S) \
                == r_mf._decode_attn_flops(rcfg, B, S)
            assert t_mf._decode_ssm_flops(cfg, B) \
                == r_mf._decode_ssm_flops(rcfg, B)


# ------------------------------------------------------------- the parser
def _scanfree(a, b, c):
    return jnp.tanh(a @ b) @ c


def _scan17(x, w):
    def body(h, _):
        return jnp.tanh(h @ w), None

    return jax.lax.scan(body, x, None, length=17)[0]


def _nested(x, w):
    def inner(h, _):
        return jnp.tanh(h @ w), None

    def outer(h, _):
        return jax.lax.scan(inner, h, None, length=3)[0], None

    return jax.lax.scan(outer, x, None, length=5)[0]


PROGRAMS = {
    "scanfree": (_scanfree, [(128, 256), (256, 512), (512, 64)]),
    "scan17": (_scan17, [(64, 64), (64, 64)]),
    "nested": (_nested, [(32, 32), (32, 32)]),
}


def _same_costs(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total_collective_bytes == want.total_collective_bytes


@pytest.mark.parametrize("prog", sorted(PROGRAMS))
def test_parse_hlo_costs_equals_the_reference(prog):
    fn, shapes = PROGRAMS[prog]
    args = [jnp.zeros(s, jnp.float32) for s in shapes]
    text = jax.jit(fn).lower(*args).compile().as_text()
    _same_costs(t_hlo.parse_hlo_costs(text), r_hlo.parse_hlo_costs(text))
    line = next(x for x in text.splitlines() if " dot(" in x)
    assert dataclasses.asdict(t_hlo._parse_op_line(line)) \
        == dataclasses.asdict(r_hlo._parse_op_line(line))
    assert t_hlo._shape_bytes("bf16", (10, 10)) == r_hlo._shape_bytes(
        "bf16", (10, 10)) == 200


def _reference_train_text(arch, shape):
    """The reference's train step of the tiny ``arch``, compiled with no
    mesh, as HLO text."""
    cfg = r_configs.get_tiny(arch)
    built = r_make_train_step(cfg, ROptimConfig())
    rshape = RShapeConfig(shape.name, shape.seq_len, shape.global_batch,
                          shape.kind)
    return built["step"].lower(built["param_specs"], built["opt_specs"],
                               r_input_specs(cfg, rshape)).compile().as_text()


def test_parse_hlo_costs_equals_the_reference_on_a_train_step():
    text = _reference_train_text("gemma_2b", ShapeConfig("t", 32, 2, "train"))
    got = t_hlo.parse_hlo_costs(text)
    _same_costs(got, r_hlo.parse_hlo_costs(text))
    assert got.n_whiles > 0 and got.flops > 0


# ------------------------------------------------------------ the analysis
COSTS = dict(flops=3.5e15, hbm_bytes=2.25e12,
             collective_bytes={"all-reduce": 4e9, "all-gather": 1.5e9},
             collective_ops={"all-reduce": 7, "all-gather": 3}, n_whiles=2,
             trip_counts=[32, 4],
             hbm_bytes_by_scope={"flash_attn": 4e11, "decode_attn": 1e10,
                                 "mlp": 8e11, "other": 1.04e12})


def _reports(arch, shape_name, chips):
    cfg, rcfg = t_configs.get_config(arch), r_configs.get_config(arch)
    rhw = r_analysis.HW()
    hw = t_analysis.HW(peak_flops=rhw.peak_flops, hbm_bw=rhw.hbm_bw,
                       link_bw=rhw.link_bw)
    args = ("16x16" if chips == 256 else "2x16x16", chips, "", 12e9)
    got = t_roofline.analyze(cfg, SHAPES[shape_name], *args, 16e9, hw,
                             "note", t_hlo.HloCosts(**COSTS))
    want = r_roofline.analyze(rcfg, R_SHAPES[shape_name], *args, 16e9, rhw,
                              "note", r_hlo.HloCosts(**COSTS))
    return got, want


@pytest.mark.parametrize("chips", [256, 512])
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ["llama3_8b", "hymba_1_5b", "mamba2_1_3b",
                                  "kimi_k2_1t_a32b"])
def test_analyze_equals_the_reference(arch, shape_name, chips):
    got, want = _reports(arch, shape_name, chips)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.step_s == want.step_s
    assert got.bound_fraction == want.bound_fraction
    assert json.loads(got.to_json()) == json.loads(want.to_json())


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_analyze_on_one_card_splits_nothing(shape_name):
    """C-R8: the reference computes the fused attention's traffic at
    dp = tp = 16 whatever its ``chips``; on one card the port takes
    dp = tp = 1, so the substituted memory term counts every row and head.
    """
    cfg, rcfg = t_configs.get_config("llama3_8b"), r_configs.get_config(
        "llama3_8b")
    shape, rshape = SHAPES[shape_name], R_SHAPES[shape_name]
    costs = t_hlo.HloCosts(**COSTS)
    got = t_roofline.analyze(cfg, shape, "1", 1, "", 12e9, costs=costs)
    want = r_roofline.analyze(rcfg, rshape, "1", 1, "", 12e9,
                              costs=r_hlo.HloCosts(**COSTS))
    hw = t_analysis.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)
    assert got.compute_s == COSTS["flops"] / 989e12
    assert got.memory_s == COSTS["hbm_bytes"] / 3.35e12
    assert got.fits is (12e9 <= 80e9)
    scope = COSTS["hbm_bytes_by_scope"]
    attn = scope["flash_attn"] + scope["decode_attn"]
    one = t_mf.flash_io_bytes_per_device(cfg, shape, dp=1, tp=1)
    sixteen = r_mf.flash_io_bytes_per_device(rcfg, rshape)
    assert one > sixteen > 0
    assert got.memory_s_fused_attn == (COSTS["hbm_bytes"] - attn + one) \
        / 3.35e12
    rhw = r_analysis.HW()
    assert want.memory_s_fused_attn == (COSTS["hbm_bytes"] - attn
                                        + sixteen) / rhw.hbm_bw
    # the port's arithmetic at the reference's split is the reference's
    assert t_mf.flash_io_bytes_per_device(cfg, shape, dp=16, tp=16) \
        == sixteen


# -------------------------------------------------------------- the counter
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_counter_is_exact_on_a_scan_free_program():
    a, b, c = _meta(128, 256), _meta(256, 512), _meta(512, 64)
    got = count(lambda a, b, c: torch.tanh(a @ b) @ c, a, b, c)
    assert got.costs.flops == 2 * 128 * 256 * 512 + 2 * 128 * 512 * 64
    f = 4
    mm1 = (128 * 256 + 256 * 512 + 128 * 512) * f
    tanh = 2 * 128 * 512 * f
    mm2 = (128 * 512 + 512 * 64 + 128 * 64) * f
    assert got.costs.hbm_bytes == mm1 + tanh + mm2
    assert got.kernels == 3
    assert got.costs.total_collective_bytes == 0
    assert got.arg_bytes == (128 * 256 + 256 * 512 + 512 * 64) * f
    # a @ b and its tanh live at once; then the tanh and the output
    assert got.peak_bytes == 2 * 128 * 512 * f
    assert got.bytes_per_device == got.arg_bytes + got.peak_bytes


def test_counter_counts_every_iteration_of_a_loop():
    def loop(x, w):
        for _ in range(17):
            x = torch.tanh(x @ w)
        return x

    got = count(loop, _meta(64, 64), _meta(64, 64))
    assert got.costs.flops == 17 * 2 * 64 * 64 * 64
    assert got.kernels == 34
    assert got.costs.hbm_bytes == 17 * (3 + 2) * 64 * 64 * 4
    assert got.costs.n_whiles == 0


@pytest.mark.parametrize("scope", [None, "mlp"])
def test_a_backward_op_takes_the_scope_its_node_was_made_in(scope):
    """The mm's node is made outside any range (or in ``mlp``); the next
    op opens ``ce_loss`` with an op that makes no node (an int arange):
    the mm's backward stays in the mm's scope."""
    M, K, N = 16, 32, 8

    def step(x, w):
        if scope is None:
            h = x @ w
        else:
            with torch.profiler.record_function(scope):
                h = x @ w
        with torch.profiler.record_function("ce_loss"):
            torch.arange(4, device="meta")
            y = (h * 2).sum()
        return torch.autograd.grad(y, w)

    got = count(step, _meta(M, K), _meta(K, N).requires_grad_(True))
    key = "mm" if scope is None else f"{scope}/mm"
    assert got.costs.dot_flops_by_meta == {key: 2 * 2.0 * M * K * N}
    assert got.ranges == (1 if scope is None else 2)
    # ce_loss: the arange, h * 2, its sum, and the backward's mul (its
    # stride-0 gradient read once)
    ce = 4 * 8 + 2 * M * N * 4 + (M * N + 1) * 4 + (1 + M * N) * 4
    mm = 2 * (M * K + K * N + M * N) * 4              # forward, backward
    seed = 2 * 4          # autograd's ones_like seed, made in no scope
    want = {"ce_loss": ce, "other": mm + seed} if scope is None else \
        {"ce_loss": ce, scope: mm, "other": seed}
    assert got.costs.hbm_bytes_by_scope == want


FLASH_CALLS = [
    # (B, Sq, Sk, Hq, Hkv, D, dtype, kw)
    (8, 128, 128, 8, 1, 256, torch.bfloat16, {"causal": True}),
    (8, 1, 256, 32, 8, 128, torch.bfloat16,
     {"causal": False, "valid_len": 129}),
    (8, 676, 676, 56, 8, 128, torch.bfloat16, {"causal": True}),
    (8, 1, 708, 56, 8, 128, torch.bfloat16,
     {"causal": False, "valid_len": 708}),
    (2, 4096, 4096, 25, 5, 64, torch.bfloat16,
     {"causal": True, "window": 2048}),
    (8, 16, 1500, 6, 6, 64, torch.float32, {"causal": False}),
    (2, 1, 160, 8, 1, 64, torch.float32,
     {"causal": False, "window": 16, "valid_len": 100}),
    (1, 4, 160, 8, 1, 256, torch.float32, {"causal": False, "valid_len": 0}),
]


@pytest.mark.parametrize("call", FLASH_CALLS, ids=str)
def test_k7_count_equals_chip_smokes_flash_count(call):
    B, Sq, Sk, Hq, Hkv, D, dt, kw = call
    q, k = _meta(B, Sq, Hq, D, dtype=dt), _meta(B, Sk, Hkv, D, dtype=dt)
    got = count(lambda q, k, v: flash_attention(q, k, v, **kw), q, k,
                _meta(B, Sk, Hkv, D, dtype=dt))
    flops, nbytes = _chip_smoke().flash_count(
        torch.empty(q.shape, dtype=dt), torch.empty(k.shape, dtype=dt), kw)
    assert got.costs.flops == flops
    assert got.costs.hbm_bytes == nbytes
    assert got.kernels == 1
    assert got.peak_bytes == q.numel() * q.element_size()   # the output


def test_k7_on_meta_runs_no_plain_version(monkeypatch):
    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on meta")

    monkeypatch.setattr(fa, "flash_attention_plain", refuse)
    before = dict(fa.LAUNCHES)
    q, k = _meta(2, 16, 4, 32), _meta(2, 16, 2, 32)
    out = fa.flash_attention(q, k, k)
    assert out.device.type == "meta" and out.shape == q.shape
    assert fa.LAUNCHES == before                 # nothing was launched


def _attention_flops_outside(counted):
    return counted.costs.flops - sum(
        v for k, v in counted.costs.dot_flops_by_meta.items()
        if "flash_attn" in k)


def _ref_attention_flops(cfg, B, S):
    """The reference's attention FLOPs in its CPU train step: the pure
    blocked attention's two products (QK^T, PV) over every (q chunk, kv
    chunk) pair of the padded lengths, 2 x 2 Sq_p Sk_p Hq D x B each time
    it runs: under remat "full" a layer's attention runs in the forward,
    in the recompute and twice in the backward (4x); whisper's encoder
    layers are not rematerialised (3x)."""
    if not cfg.has_attention:
        return 0.0

    def pad(n, c):
        c = min(c, n)
        return -(-n // c) * c

    def once(sq, sk):
        return 2 * 2.0 * B * pad(sq, cfg.q_chunk) * pad(sk, cfg.kv_chunk) \
            * cfg.n_heads_padded * cfg.head_dim_

    if cfg.family == "encdec":
        enc = cfg.encoder_seq
        return cfg.n_encoder_layers * 3 * once(enc, enc) \
            + cfg.n_layers * 4 * (once(S, S) + once(S, enc))
    return cfg.n_layers * 4 * once(S, S)   # the vlm's S counts its patches


def _ssd_backward_dots(cfg, B, S, chunk=128):
    """FLOPs that the reference's SSD backward runs as dots and the port
    as reductions: the reference writes the decay factors into three-way
    einsums, so their cotangents contract an axis in a dot (the scores'
    over the heads, decay_to_end's and exp(cum)'s over the head dim); the
    port multiplies the decays in elementwise first, and the same sums are
    reductions, which count no matmul FLOPs."""
    if not cfg.has_ssm:
        return 0.0
    Q = min(chunk, S)
    nc = -(-S // Q)
    H, P = cfg.ssm_heads_, cfg.ssm_head_dim
    return cfg.n_layers * (2.0 * B * nc * Q * Q * H + 2 * 2.0 * B * nc * Q
                           * H * P)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_flops_match_the_reference_outside_attention(arch):
    cfg = t_configs.get_tiny(arch)
    shape = ShapeConfig("t", 32, 2, "train")
    ref = r_hlo.parse_hlo_costs(_reference_train_text(arch, shape))
    got = count_step(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    ref_attn = _ref_attention_flops(cfg, B, S)
    tagged = sum(v for k, v in ref.dot_flops_by_meta.items()
                 if "flash_attn" in k)
    # the attention's dots carry the flash_attn scope, or (gemma's MQA,
    # whose head axis of 1 XLA folds away) no op_name at all
    untagged = sum(v for k, v in ref.dot_flops_by_meta.items()
                   if "/" not in k)
    assert tagged == ref_attn or (tagged == 0 and untagged == ref_attn)
    ref_out = ref.flops - ref_attn
    port_out = _attention_flops_outside(got)
    assert port_out == pytest.approx(ref_out, rel=0.02)
    assert ref_out - port_out == _ssd_backward_dots(cfg, B, S)


FAMILY_ARCHS = ["gemma_2b", "llama3_8b", "whisper_tiny", "mamba2_1_3b",
                "hymba_1_5b", "arctic_480b", "kimi_k2_1t_a32b",
                "llava_next_34b"]


def _shape_for_counter(name):
    shape = SHAPES[name]
    if name == "long_500k":
        return ShapeConfig(name, 8_192, shape.global_batch, shape.kind)
    return shape


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_counter_runs_every_applicable_shape(arch):
    """The tiny configs block attention in 16-position chunks for the
    parity tests; at 4,096 positions the backward's blocked recompute
    would loop 65,536 blocks a layer, each a dozen dispatched ops, so the
    shapes run with the published configs' 1,024-position chunks."""
    cfg = t_configs.get_tiny(arch).replace(q_chunk=1024, kv_chunk=1024)
    for name in SHAPES:
        if not shape_applicable(cfg, SHAPES[name])[0]:
            continue
        shape = _shape_for_counter(name)
        got = count_step(cfg, shape)
        c = got.costs
        assert c.flops > 0 and c.hbm_bytes > 0 and got.kernels > 0
        assert c.total_collective_bytes == 0
        assert sum(c.hbm_bytes_by_scope.values()) == pytest.approx(
            c.hbm_bytes, rel=1e-12)
        assert got.bytes_per_device > got.arg_bytes > 0
        scopes = set(c.hbm_bytes_by_scope)
        if shape.kind == "train":
            # the enc-dec loss carries no ce_loss scope in the reference
            assert "adamw" in scopes
            assert ("ce_loss" in scopes) == (cfg.family != "encdec")
        if cfg.has_attention:
            assert ("decode_attn" if shape.kind == "decode"
                    else "flash_attn") in scopes
        if cfg.has_ssm and shape.kind != "decode":
            assert "ssd" in scopes
        if cfg.is_moe:
            assert "moe" in scopes
        rep = t_roofline.analyze(cfg, shape, "1", 1, "",
                                 got.bytes_per_device, costs=c)
        assert rep.compute_s == c.flops / 989e12
        assert rep.collective_s == 0 and rep.useful_ratio > 0


@pytest.mark.parametrize("arch", ["llama3_8b", "hymba_1_5b",
                                  "whisper_tiny"])
def test_decode_counts_k7_over_the_valid_keys(arch):
    """One token against a cache of 256 slots at position 128: each
    attention layer's K7 call keeps 129 keys (the hybrid's ring of 32
    slots keeps 32; whisper's cross-attention keeps every frame)."""
    cfg = t_configs.get_tiny(arch)
    B, S, pos = 4, 256, 128
    got = count_step(cfg, ShapeConfig("d", S, B, "decode"), pos=pos)
    k7 = sum(v for k, v in got.costs.dot_flops_by_meta.items()
             if k.endswith("flash_attention"))
    per_key = 4.0 * cfg.head_dim_ * B * cfg.n_heads_padded
    keys = min(pos + 1, cfg.sliding_window or S) * cfg.n_layers
    if cfg.family == "encdec":
        keys += cfg.encoder_seq * cfg.n_layers
    assert k7 == per_key * keys
    # two ranges a layer: decode_attn and mlp; whisper's decoder scopes
    # its self- and cross-attention and, as the reference, no MLP; the
    # hybrid's SSD runs no chunked scan (no ssd range) in decode
    assert got.ranges == 2 * cfg.n_layers


def test_train_step_arguments_are_counted_once():
    """The arguments' bytes are the parameters, the two float32 moments
    of each, the int32 step and the int32 tokens; AdamW's in-place
    updates allocate nothing more."""
    cfg = t_configs.get_tiny("llama3_8b")
    shape = ShapeConfig("t", 32, 2, "train")
    got = count_step(cfg, shape)
    from repro_torch.models import Model
    from repro_torch.tree import leaves

    specs = leaves(Model(cfg).param_specs(), torch.is_tensor)
    params = sum(t.numel() * t.element_size() for t in specs)
    moments = 2 * sum(t.numel() * 4 for t in specs)
    assert got.arg_bytes == params + moments + 4 + 2 * 32 * 4
    assert got.peak_bytes > 0
