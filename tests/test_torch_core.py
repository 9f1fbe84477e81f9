"""The port's framework-free core against the JAX package's (``repro``):
packing, tuples, probing, enumeration, linear scan, synthetic data, the
device schedules, stacks and CSR, the metrics/trace copies, and the
port's import boundary. Every comparison is equality on the same numpy
inputs."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import enumeration as r_enum
from repro.core import linear_scan as r_ls
from repro.core import packing as r_pack
from repro.core import probe_device as r_pd
from repro.core import probing as r_prob
from repro.core import tuples as r_tup
from repro.core.amih import AMIHIndex as RIndex
from repro.data import synthetic as r_syn
from repro_torch.convert import index_from_reference, index_state
from repro_torch.core import enumeration as t_enum
from repro_torch.core import linear_scan as t_ls
from repro_torch.core import packing as t_pack
from repro_torch.core import probe_device as t_pd
from repro_torch.core import probing as t_prob
from repro_torch.core import tuples as t_tup
from repro_torch.data import synthetic as t_syn
from repro_torch.kernels import ops as t_ops
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import trace as t_trace

ROOT = Path(__file__).resolve().parents[1]


def _codes(n, p, seed):
    rng = np.random.default_rng(seed)
    return r_pack.pack_bits(rng.integers(0, 2, size=(n, p)).astype(np.uint8))


# ------------------------------------------------------------------ packing
@pytest.mark.parametrize("p", [1, 31, 32, 64, 100, 128])
def test_packing_matches_reference(p):
    rng = np.random.default_rng(p)
    bits = rng.integers(0, 2, size=(57, p)).astype(np.uint8)
    words = r_pack.pack_bits(bits)
    assert np.array_equal(t_pack.pack_bits(bits), words)
    assert np.array_equal(t_pack.unpack_bits(words, p), bits)
    assert np.array_equal(t_pack.popcount(words), r_pack.popcount(words))
    r10, r01 = r_pack.hamming_tuples(words[0], words)
    t10, t01 = t_pack.hamming_tuples(words[0], words)
    assert np.array_equal(r10, t10) and np.array_equal(r01, t01)
    for m in sorted({1, max(1, p // 16), max(1, p // 8)}):
        spans = r_pack.substring_spans(p, m)
        assert t_pack.substring_spans(p, m) == spans
        for lo, hi in spans:
            if hi - lo <= 64:
                assert np.array_equal(
                    t_pack.extract_substring(words, lo, hi),
                    r_pack.extract_substring(words, lo, hi),
                )


# -------------------------------------------------------- tuples / probing
@settings(max_examples=25, deadline=None)
@given(p=st.integers(1, 96), data=st.data())
def test_probing_prefix_and_sims_match_reference(p, data):
    z = data.draw(st.integers(0, p))
    L = (z + 1) * (p - z + 1)
    walk = t_prob.probing_prefix(p, z, L)
    assert list(walk) == list(r_prob.probing_prefix(p, z, L))
    for (r1, r2) in walk[:50]:
        assert t_tup.sim_value(p, z, r1, r2) == r_tup.sim_value(p, z, r1, r2)
    for a, b in zip(walk[:40], walk[1:41]):
        assert t_tup.sim_compare(p, z, a, b) == r_tup.sim_compare(p, z, a, b)
    assert t_tup.rhat(z) == r_tup.rhat(z)
    assert t_prob.closed_form_prefix(p, z) == r_prob.closed_form_prefix(p, z)


@pytest.mark.parametrize("n,k", [(0, 0), (5, 0), (5, 2), (12, 3), (16, 4)])
def test_combination_indices_match_reference(n, k):
    assert np.array_equal(
        t_enum.combination_indices(n, k), r_enum.combination_indices(n, k)
    )
    if k <= n and n:
        q = 0b1011_0110_0101 & ((1 << n) - 1)
        z = bin(q).count("1")
        for a in range(min(z, 2) + 1):
            b = min(k, n - z)
            assert np.array_equal(
                t_enum.tuple_bucket_values(q, n, z, a, b),
                r_enum.tuple_bucket_values(q, n, z, a, b),
            )


# -------------------------------------------------------------- linear scan
@pytest.mark.parametrize("p", [32, 64, 128])
def test_linear_scan_matches_reference(p):
    db = _codes(700, p, p)
    q = _codes(6, p, p + 1)
    q[0] = 0
    for i in range(q.shape[0]):
        ri, rs = r_ls.linear_scan_knn(q[i], db, 25)
        ti, ts = t_ls.linear_scan_knn(q[i], db, 25)
        assert np.array_equal(ri, ti) and np.array_equal(rs, ts)
        ids = np.arange(0, 700, 7)
        assert np.array_equal(
            t_ls.sims_for_ids(q[i], db, ids), r_ls.sims_for_ids(q[i], db, ids)
        )
    assert np.array_equal(
        t_ls.sims_batch_against_db(q, db, chunk=128),
        r_ls.sims_batch_against_db(q, db, chunk=128),
    )


# ------------------------------------------------------------ synthetic data
@pytest.mark.parametrize("p,mode", [(64, "clustered"), (128, "clustered"),
                                    (100, "uniform")])
def test_packed_synthetic_equals_reference(p, mode):
    bits = r_syn.synthetic_binary_codes(3000, p, seed=7, mode=mode)
    words = t_syn.synthetic_binary_codes_packed(3000, p, seed=7, mode=mode,
                                                chunk_rows=777)
    assert np.array_equal(words, r_pack.pack_bits(bits))
    assert np.array_equal(
        t_syn.synthetic_binary_codes(300, p, seed=3, mode=mode),
        r_syn.synthetic_binary_codes(300, p, seed=3, mode=mode),
    )
    q = t_syn.synthetic_queries_packed(words, p, 40, seed=9)
    assert np.array_equal(
        q, r_pack.pack_bits(r_syn.synthetic_queries(bits, 40, seed=9))
    )


# ------------------------------------------------------- schedules and CSR
_SCHED_FIELDS = ("r1s", "r2s", "sims64", "cum_maxrad", "inv_pos", "tbl",
                 "step_ext", "idx1", "idx0", "maxi1", "maxi0",
                 "cum_subtuples")


@pytest.mark.parametrize(
    "p,m,z,cap",
    [(32, 2, 0, 1 << 16), (32, 2, 13, 1 << 16), (64, 4, 30, 1 << 16),
     (64, 4, 30, 64), (128, 8, 70, 1 << 12)],
)
def test_schedule_arrays_match_reference(p, m, z, cap):
    widths = tuple(hi - lo for lo, hi in r_pack.substring_spans(p, m))
    rs = r_pd.get_schedule(p, m, widths, z, cap)
    ts = t_pd.get_schedule(p, m, widths, z, cap)
    for name in _SCHED_FIELDS:
        assert np.array_equal(getattr(ts, name), getattr(rs, name)), name
    for name in ("L", "s_len", "built_steps", "complete"):
        assert getattr(ts, name) == getattr(rs, name), name


def test_schedule_stack_matches_reference():
    p, m = 64, 4
    widths = tuple(hi - lo for lo, hi in r_pack.substring_spans(p, m))
    rst = r_pd.ScheduleStack(p, m, widths, 1 << 12)
    tst = t_pd.ScheduleStack(p, m, widths, 1 << 12)
    for z in (31, 0, 40, 31, 17, 64):
        assert tst.row(z) == rst.row(z)
    for name in ("tbl", "step", "idx1", "idx0", "maxi1", "maxi0"):
        assert np.array_equal(getattr(tst, name), getattr(rst, name)), name
    assert tst.g_start == rst.g_start and tst.g_end == rst.g_end
    rb = rst.device_arrays(None)
    tb = tst.device_arrays(torch.device("cpu"))
    for name in ("g_start", "g_end", "tbl", "step", "inv_pos", "widths"):
        assert np.array_equal(tb[name].numpy(), np.asarray(rb[name])), name


@pytest.mark.parametrize("p,m,n", [(32, 2, 300), (64, 4, 500), (128, 8, 257)])
def test_device_csr_and_pow_arrays_match_reference(p, m, n):
    db = _codes(n, p, n)
    ref = RIndex.build(db, p, m=m)
    port = index_from_reference(index_state(ref), probe_backend="device",
                                device="cpu")
    rc, tc = r_pd.build_device_csr(ref), port.device_csr
    for name in ("offsets", "ids"):
        assert np.array_equal(tc[name].numpy(), np.asarray(rc[name])), name
    assert np.array_equal(tc["db_pad"].numpy().view(np.uint32),
                          np.asarray(rc["db_pad"]))
    for name in ("n", "n_pad", "wmax", "widths"):
        assert tc[name] == rc[name], name
    q = _codes(9, p, n + 1)
    q_sub, z_sub = r_pd._query_substrings(ref, q)
    t_sub, t_z = t_pd._query_substrings(port, q)
    assert np.array_equal(q_sub, t_sub) and np.array_equal(z_sub, t_z)
    for rp, tp in zip(r_pd._pow_arrays(q_sub, z_sub, rc["widths"], rc["wmax"]),
                      t_pd._pow_arrays(t_sub, t_z, tc["widths"], tc["wmax"])):
        assert np.array_equal(rp, tp)


def test_pad_bucket_matches_reference():
    from repro.kernels import ops as r_ops

    for size in (0, 1, 2, 3, 7, 8, 9, 1000, 1 << 20, (1 << 20) + 1):
        for minimum in (1, 8, 1024):
            assert t_ops.pad_bucket(size, minimum) == \
                r_ops.pad_bucket(size, minimum)


# -------------------------------------------------------------- obs copies
def test_metrics_and_trace_copies_behave():
    reg = t_metrics.MetricsRegistry()
    reg.counter("launches.x").add(3)
    reg.histogram("lat").record(2.0, count=3)
    assert reg.value("launches.x") == 3 and reg.value("missing") == 0
    assert reg.snapshot()["lat"]["count"] == 3
    reg.reset("launches.")
    assert reg.values("launches.") == {"launches.x": 0}
    tr = t_trace.Tracer(enabled=True)
    with tr.span("outer"):
        with tr.span("inner", cat="kernel", B=4):
            pass
    names = [s["name"] for s in tr.drain()]
    assert names == ["inner", "outer"]
    assert t_trace.Tracer(enabled=False).span("x") is t_trace.NOOP_SPAN


# ---------------------------------------------------------- import boundary
def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    bad = []
    files = _port_files()
    assert len(files) > 10
    # every subpackage is covered, the shard and pipeline layers included
    subpackages = {f.parent.name for f in files}
    assert {"core", "kernels", "shard", "pipeline", "serve"} <= subpackages
    assert ROOT / "src" / "repro_torch" / "shard" / "engines.py" in files
    assert ROOT / "src" / "repro_torch" / "pipeline" / "shardpool.py" in files
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [] if node.level else [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ops.resolve_device(None)
    from repro_torch.core.engine import make_engine

    db = _codes(64, 32, 1)
    # the defaults are the device walk, and the CUDA verify on the host walk
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine("amih", db, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine("amih", db, 32, probe_backend="host")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine("amih", db, 32, probe_backend="device",
                    verify_backend="numpy")
    # the numpy host walk, asked for explicitly, needs no device
    eng = make_engine("amih", db, 32, probe_backend="host",
                      verify_backend="numpy")
    assert eng.index.device is None
    eng.knn_batch(db[:2], 3)


def test_build_dir_in_checkout_or_from_env(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    assert _build.build_dir() == ROOT / "build" / "repro_torch"
    # an installed package has no checkout to build into
    site = tmp_path / "site-packages" / "repro_torch" / "kernels"
    monkeypatch.setattr(_build, "__file__", str(site / "_build.py"))
    with pytest.raises(RuntimeError, match="REPRO_TORCH_BUILD_DIR"):
        _build.build_dir()
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    assert _build.build_dir() == tmp_path / "b"
