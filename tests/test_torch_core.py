"""The port's framework-free core against the JAX package's (``repro``):
packing, tuples, probing, enumeration, linear scan, synthetic data, the
device schedules, stacks and CSR, the metrics/trace copies, and the
port's import boundary. Every comparison is equality on the same numpy
inputs."""

import ast
from dataclasses import fields
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


# ------------------------------------------------ the package surface (C-P2)
@pytest.mark.parametrize("p", [1, 7, 32, 64, 128])
def test_tuple_count_equals_reference(p):
    """Eq. 4 on every tuple of five query weights, out-of-range tuples
    included (they count 0)."""
    for z in sorted({0, 1, p // 3, p // 2, p}):
        for r1 in range(-1, z + 2):
            for r2 in range(-1, p - z + 2):
                assert t_tup.tuple_count(p, z, r1, r2) == \
                    r_tup.tuple_count(p, z, r1, r2)


@pytest.mark.parametrize("p", [1, 31, 32, 33, 64])
def test_ints_to_codes_equals_reference(p):
    rng = np.random.default_rng(p)
    vals = rng.integers(0, 1 << 63, size=40, dtype=np.uint64)
    vals = vals & np.uint64((1 << p) - 1)
    got = t_pack.ints_to_codes(vals, p)
    assert got.dtype == np.uint32
    assert np.array_equal(got, r_pack.ints_to_codes(vals, p))
    assert np.array_equal(t_pack.codes_to_ints(got, p), vals)


def _same(a, b):
    """Deep equality of two results: arrays by value and dtype,
    dataclass instances by their fields."""
    from dataclasses import asdict, is_dataclass

    if is_dataclass(a) and not isinstance(a, type):
        return is_dataclass(b) and asdict(a) == asdict(b)
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _registered(core):
    """The package's backends once every layer has registered its own."""
    import importlib

    root = core.__name__.split(".")[0]
    for sub in ("shard", "cluster"):
        importlib.import_module(f"{root}.{sub}")
    return sorted(core.ENGINES), core.available_backends()


_DB = _codes(300, 64, 3)
_Q = _codes(4, 64, 4)
_DB24 = _codes(300, 24, 5)
_AMIH = dict(m=2, verify_backend="numpy", probe_backend="host")

# each name ``repro.core`` exports -> a call whose result the port's
# counterpart must equal
CORE_CASES = {
    "AMIHIndex": lambda c: c.AMIHIndex.build(_DB, 64, **_AMIH).knn(_Q[0], 7),
    "AMIHStats": lambda c: [f.name for f in fields(c.AMIHStats)],
    "ENGINES": _registered,
    "EngineStats": lambda c: [f.name for f in fields(c.EngineStats)],
    "SearchEngine": lambda c: (
        sorted(c.SearchEngine.__abstractmethods__),
        all(issubclass(e, c.SearchEngine) for e in c.ENGINES.values())),
    "SearchStats": lambda c: [f.name for f in fields(c.SearchStats)],
    "SingleTableIndex": lambda c: c.SingleTableIndex.build(_DB24, 24)
    .knn(_DB24[1], 6),
    "available_backends": lambda c: _registered(c)[1],
    "closed_form_prefix": lambda c: [c.closed_form_prefix(64, z)
                                     for z in (0, 1, 20, 64)],
    "default_num_tables": lambda c: [c.default_num_tables(p, n)
                                     for p in (32, 64, 128, 256)
                                     for n in (10, 10 ** 4, 10 ** 7)],
    "hamming_tuples": lambda c: c.hamming_tuples(_Q[0], _DB),
    "linear_scan_knn": lambda c: c.linear_scan_knn(_Q[2], _DB, 9),
    "make_engine": lambda c: c.make_engine(
        "amih", _DB, 64, **_AMIH).knn_batch(_Q, 5)[:2],
    "n_words": lambda c: [c.n_words(p) for p in (1, 32, 33, 64, 128)],
    "pack_bits": lambda c: c.pack_bits(c.unpack_bits(_DB, 64)),
    "popcount": lambda c: c.popcount(_DB),
    "probing_sequence": lambda c: list(c.probing_sequence(64, 21,
                                                          limit=300)),
    "rhat": lambda c: [c.rhat(z) for z in range(200)],
    "sim_value": lambda c: [c.sim_value(64, 20, r1, r2)
                            for r1 in range(21) for r2 in range(0, 45, 4)],
    "sims_against_db": lambda c: c.sims_against_db(_Q[3], _DB),
    "sims_batch_against_db": lambda c: c.sims_batch_against_db(_Q, _DB,
                                                               chunk=64),
    "substring_spans": lambda c: [c.substring_spans(p, m)
                                  for p in (32, 64, 100, 128)
                                  for m in (1, 2, 3, 8)],
    "topk_from_sims": lambda c: c.topk_from_sims(
        c.sims_against_db(_Q[0], _DB), 11),
    "tuple_count": lambda c: [c.tuple_count(64, 20, r1, r2)
                              for r1 in range(-1, 22) for r2 in range(46)],
    "unpack_bits": lambda c: c.unpack_bits(_DB, 64),
}


def test_core_cases_cover_the_reference_exports():
    import repro.core as r_core

    assert sorted(CORE_CASES) == sorted(r_core.__all__)


@pytest.mark.parametrize("name", sorted(CORE_CASES))
def test_core_export_equals_reference(name):
    """``repro_torch.core`` exports every name ``repro.core`` does, and
    each gives the reference's result (ROADMAP C-P2)."""
    import repro.core as r_core
    import repro_torch.core as t_core

    assert name in t_core.__all__ and hasattr(t_core, name)
    assert _same(CORE_CASES[name](t_core), CORE_CASES[name](r_core))


def test_obs_exports_equal_reference():
    """``repro_torch.obs`` exports what ``repro.obs`` does, ``set_tracer``
    included (ROADMAP C-P2)."""
    import repro.obs as r_obs
    import repro_torch.obs as t_obs

    assert sorted(t_obs.__all__) == sorted(r_obs.__all__)
    prev = t_obs.set_tracer(t_obs.Tracer(enabled=True))
    try:
        assert t_obs.current().enabled
    finally:
        t_obs.set_tracer(prev)
    assert t_obs.current() is prev


# ---------------------------------------------------------- import boundary
def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    bad = []
    files = _port_files()
    assert len(files) > 10
    # every subpackage is covered, the shard, pipeline, cluster and obs
    # layers included
    subpackages = {f.parent.name for f in files}
    assert {"core", "kernels", "shard", "pipeline", "serve", "cluster",
            "obs", "data", "models", "launch", "optim", "checkpoint",
            "train", "configs", "examples"} <= subpackages
    src = ROOT / "src" / "repro_torch"
    for rel in ("shard/engines.py", "pipeline/shardpool.py",
                "cluster/transport.py", "cluster/worker.py",
                "cluster/coordinator.py", "cluster/local.py",
                "cluster/launch.py", "cluster/smoke.py", "obs/export.py",
                "obs/report.py", "obs/smoke.py", "data/pipeline.py",
                "serve/engine.py", "launch/serve.py", "tree.py",
                "optim/adamw.py", "optim/compression.py",
                "checkpoint/checkpointer.py", "train/step.py",
                "train/loop.py", "train/watchdog.py", "launch/train.py",
                "configs/llama3_8b.py", "configs/granite_3_8b.py",
                "configs/granite_34b.py", "examples/quickstart.py",
                "examples/distributed_search.py",
                "examples/retrieval_serving.py",
                "examples/train_embedder.py"):
        assert src / rel in files
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


def test_spawned_port_worker_holds_neither_jax_nor_reference():
    """The modules of a worker process as ``LocalCluster`` spawns it: a
    fresh interpreter from the ``spawn`` context that imports the
    worker's entry module and ``repro_torch.cluster.worker``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    code = ("import sys\n"
            "import repro_torch.cluster.local\n"
            "import repro_torch.cluster.worker\n"
            "conn.send(sorted(sys.modules))\n"
            "conn.close()\n")
    proc = ctx.Process(target=exec, args=(code, {"conn": child}))
    with pytest.MonkeyPatch.context() as env:
        env.setenv("OMP_NUM_THREADS", "1")    # the child inherits it
        proc.start()
    child.close()
    try:
        assert parent.poll(120)
        mods = parent.recv()
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
    assert not proc.is_alive() and proc.exitcode == 0
    assert "repro_torch.cluster.worker" in mods and "torch" in mods
    bad = [m for m in mods
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
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
