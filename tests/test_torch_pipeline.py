"""The port's pipeline layer (``repro_torch.pipeline``: ``VerifyOverlap``,
the shard-probe pool, the smoke canary) against its sequential
counterparts and the JAX package's, on the CPU.

The verify overlap is bit-identical to the sequential host walk — ids,
float64 sims, ``verified`` and the K1 launch counts — and equal to the
reference's overlap, per-query stats included. The shard pool, in thread
and in process mode, returns exactly the sequential chain's (ids, sims),
including on the draw where the reference's pool returns fewer than k
(ROADMAP C-R3: p = 64, B = 64, n = 38, k = 4, seed 0, 4 shards, 4
workers, the stand-down gates at 0), and leaves no child process behind.
Every case is a fixed seed; nothing is drawn at random."""

import multiprocessing
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro.core import make_engine as r_make
from repro.data import synthetic as r_syn
from repro.pipeline import shardpool as r_pool
from repro.pipeline.overlap import VerifyOverlap as RVerifyOverlap
from repro_torch.core import pack_bits
from repro_torch.core.amih import AMIHStats
from repro_torch.core.engine import make_engine as t_make
from repro_torch.core.linear_scan import sims_against_db
from repro_torch.obs import trace as t_trace
from repro_torch.obs.metrics import REGISTRY as T_REG
from repro_torch.pipeline import (
    SharedBound,
    VerifyOverlap,
    prime_ids,
    probe_shards_parallel,
)
from repro_torch.pipeline import shardpool as t_pool


@pytest.fixture(autouse=True)
def _process_state(monkeypatch):
    """Run torch's CPU ops on one thread (the plain versions here are
    small, and the suite runs several workers at once), floor the CPU
    count at 2 so the pool forks workers on any host, and restore the
    process-global state these tests may touch."""
    threads = torch.get_num_threads()
    dtype = torch.get_default_dtype()
    tracer = t_trace.current()
    method = multiprocessing.get_start_method(allow_none=True)
    if multiprocessing.cpu_count() < 2:
        monkeypatch.setattr(multiprocessing, "cpu_count", lambda: 2)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)
    t_trace.set_tracer(tracer)
    if multiprocessing.get_start_method(allow_none=True) != method:
        multiprocessing.set_start_method(method, force=True)


def _data(n, p, B, seed):
    bits = r_syn.synthetic_binary_codes(n, p, seed=seed)
    q = r_syn.synthetic_queries(bits, B, seed=seed + 1)
    return pack_bits(bits), pack_bits(q)


def _force_pool(eng):
    eng.PARALLEL_MIN_SHARD_ROWS = 0
    eng.PARALLEL_MIN_CPUS = 0
    eng.PARALLEL_MIN_BATCH = 0
    return eng


def _no_children(eng):
    """Close the engine; its pool must leave no worker behind."""
    pool = eng._pool
    eng.close()
    assert eng._pool is None
    if pool is not None:
        assert pool.worker_pids() == []
    assert multiprocessing.active_children() == []


# --------------------------------------------------------------- overlap
# (p, n, B, k, verify backend, min_async_candidates): the CUDA verify on a
# CPU device runs its plain version on the worker thread, as the
# reference's does; 0 sends every step through the worker
OVERLAP_CASES = [
    pytest.param((64, 400, 16, 10, "numpy", 2048), id="numpy"),
    pytest.param((64, 400, 16, 10, "numpy", 0), id="numpy-every-step"),
    pytest.param((96, 150, 6, 7, "cuda", 0), id="cuda-cpu-every-step"),
    pytest.param((128, 300, 8, 25, "cuda", 2048), id="cuda-cpu"),
]


@pytest.mark.parametrize("case", OVERLAP_CASES)
def test_overlap_equals_sequential_and_reference(case):
    p, n, B, k, vb, min_async = case
    db, q = _data(n, p, B, seed=p + n)
    q[2] = 0                                   # a zero-norm query
    t_seq = t_make("amih", db, p, probe_backend="host", verify_backend=vb,
                   device="cpu", query_cache_size=0)
    t_ovl = t_make("amih", db, p, probe_backend="host", verify_backend=vb,
                   device="cpu", query_cache_size=0, overlap_verify=True)
    t_ovl._overlap_runner().min_async_candidates = min_async
    r_vb = "pallas" if vb == "cuda" else vb
    r_ovl = r_make("amih", db, p, verify_backend=r_vb, query_cache_size=0,
                   overlap_verify=True)
    r_ovl._overlap = RVerifyOverlap(min_async_candidates=min_async)
    v0 = T_REG.value("launches.verify_grouped")
    si, ss, sst = t_seq.knn_batch(q, k)
    v_seq = T_REG.value("launches.verify_grouped") - v0
    oi, os_, ost = t_ovl.knn_batch(q, k)
    v_ovl = T_REG.value("launches.verify_grouped") - v0 - v_seq
    assert np.array_equal(si, oi) and np.array_equal(ss, os_)
    assert [s.verified for s in sst.per_query] == \
        [s.verified for s in ost.per_query]
    assert t_seq.index.verify_launches == t_ovl.index.verify_launches
    assert v_seq == v_ovl
    assert np.all(os_[2] == 0.0)
    ri, rs, rst = r_ovl.knn_batch(q, k)
    assert np.array_equal(ri, oi) and np.array_equal(rs, os_)
    assert [asdict(s) for s in rst.per_query] == \
        [asdict(s) for s in ost.per_query]
    if min_async == 0:
        assert t_ovl._overlap._pool is not None    # the worker ran
    t_ovl.close()
    assert t_ovl._overlap is None
    t_ovl.close()                                  # idempotent


def test_overlap_on_the_device_walk_is_a_no_op():
    db, q = _data(200, 64, 8, seed=3)
    eng = t_make("amih", db, 64, m=4, device="cpu", query_cache_size=0)
    want = eng.index.knn_batch(q, 5)
    got = eng.index.knn_batch(q, 5, overlap=VerifyOverlap())
    assert np.array_equal(want[0], got[0]) and np.array_equal(want[1],
                                                              got[1])


def test_overlap_with_live_bound_equals_sequential():
    """``knn_batch_bounded`` through the overlap: the bound-stopped
    queries emit exactly what the sequential loop emits."""
    db, q = _data(300, 64, 8, seed=21)
    index = t_make("amih", db, 64, probe_backend="host",
                   verify_backend="numpy").index
    bounds = np.full(8, -np.inf)
    bounds[::3] = 0.85
    seq = index.knn_batch_bounded(q, 6, stop_below=bounds.copy())
    ovl = index.knn_batch_bounded(q, 6, stop_below=bounds.copy(),
                                  overlap=VerifyOverlap(
                                      min_async_candidates=0))
    for (si, ss), (oi, os_) in zip(seq, ovl):
        assert np.array_equal(si, oi) and np.array_equal(ss, os_)


# ------------------------------------------------------------------ pool
POOL_CASES = [
    # C-R3's draw: the reference's pool returns 3 rows for some queries
    pytest.param((64, 38, 64, 4, 4, 0), id="C-R3"),
    # two more draws on which the reference's pool failed alike
    pytest.param((64, 30, 64, 3, 4, 1), id="C-R3-seed-1"),
    pytest.param((64, 233, 8, 5, 4, 0), id="C-R3-B8"),
    pytest.param((64, 997, 16, 10, 8, 7), id="uneven-8-shards"),
    pytest.param((64, 50, 4, 40, 8, 9), id="k-above-shard-rows"),
]


@pytest.mark.parametrize("vb", ["numpy", "cuda"])
@pytest.mark.parametrize("mode", ["process", "thread"])
@pytest.mark.parametrize("case", POOL_CASES)
def test_pool_equals_sequential_chain(case, mode, vb):
    p, n, B, k, S, seed = case
    db, q = _data(n, p, B, seed=seed)
    cfg = dict(num_shards=S, probe_backend="host", verify_backend=vb)
    if vb == "cuda":
        cfg["devices"] = ["cpu"]
    seq = t_make("sharded_amih", db, p, **cfg)
    par = _force_pool(t_make("sharded_amih", db, p, probe_workers=S,
                             probe_mode=mode, **cfg))
    assert par._use_parallel(B)
    si, ss, _ = seq.knn_batch(q, k)
    pi, ps, pst = par.knn_batch(q, k)
    assert pi.shape == (B, min(k, n))
    assert np.array_equal(si, pi) and np.array_equal(ss, ps)
    # the CUDA verify forces thread mode
    assert par._pool.mode == ("thread" if vb == "cuda" else mode)
    if par._pool.mode == "process":
        assert par._pool.forks == len(par._pool.groups) > 1
        assert len(par._pool.worker_pids()) == par._pool.forks
    assert [d["shard"] for d in pst.per_shard] == list(range(S))
    assert sum(d["rows"] for d in pst.per_shard) == n
    for i in range(B):
        assert np.array_equal(sims_against_db(q[i], db)[pi[i]], ps[i])
    _no_children(par)


def test_c_r3_is_the_bound_margin(monkeypatch):
    """The fault the port repairs, pinned on C-R3's draw (thread mode,
    deterministic: the warm-start sample is the whole DB, so every bound
    is the exact k-th at once): the reference's pool comes up short of k,
    and so does the port's with its rounding margin taken away."""
    db, q = _data(38, 64, 64, seed=0)
    eng = _force_pool(r_make("sharded_amih", db, 64, num_shards=4,
                             probe_workers=4, probe_mode="thread"))
    with pytest.raises(ValueError, match="broadcast"):
        eng.knn_batch(q, 4)
    eng.close()
    cfg = dict(num_shards=4, probe_backend="host", verify_backend="numpy")
    si, ss, _ = t_make("sharded_amih", db, 64, **cfg).knn_batch(q, 4)
    monkeypatch.setattr(t_pool, "BOUND_MARGIN", 0.0)
    t_par = _force_pool(t_make("sharded_amih", db, 64, probe_workers=4,
                               probe_mode="thread", **cfg))
    with pytest.raises(ValueError, match="broadcast"):
        t_par.knn_batch(q, 4)
    monkeypatch.undo()
    pi, ps, _ = t_par.knn_batch(q, 4)
    assert np.array_equal(si, pi) and np.array_equal(ss, ps)
    _no_children(t_par)


def test_c_r3_duplicate_row_is_the_bound_margin(monkeypatch):
    """C-R3's second symptom, on a draw of the unseeded reference test
    ``test_pipelined_exact_all_backends`` (thread mode; deterministic):
    the reference's pool returns row 1 twice for query 31, the port's
    returns the float64 scan's sims and equals its sequential chain, and
    with its rounding margin taken away returns the same duplicate."""
    from repro_torch.core.linear_scan import linear_scan_knn

    B, n, k, seed = 64, 30, 2, 16
    bits = r_syn.synthetic_binary_codes(n, 64, seed=seed)
    db = pack_bits(bits)
    q = pack_bits(r_syn.synthetic_queries(bits, B, seed=seed + 1))
    eng = _force_pool(r_make("sharded_amih", db, 64, num_shards=4,
                             probe_workers=4, probe_mode="thread"))
    assert eng.knn_batch(q, k)[0][31].tolist() == [1, 1]
    eng.close()
    cfg = dict(num_shards=4, probe_backend="host", verify_backend="numpy")
    si, ss, _ = t_make("sharded_amih", db, 64, **cfg).knn_batch(q, k)
    t_par = _force_pool(t_make("sharded_amih", db, 64, probe_workers=4,
                               probe_mode="thread", **cfg))
    pi, ps, _ = t_par.knn_batch(q, k)
    assert np.array_equal(si, pi) and np.array_equal(ss, ps)
    for i in range(B):
        assert np.array_equal(ps[i], linear_scan_knn(q[i], db, k)[1])
    monkeypatch.setattr(t_pool, "BOUND_MARGIN", 0.0)
    assert t_par.knn_batch(q, k)[0][31].tolist() == [1, 1]
    _no_children(t_par)


@pytest.mark.parametrize("mode", ["process", "thread"])
def test_persistent_pool_forks_once_and_closes(mode):
    p, n, k, S = 64, 900, 8, 8
    bits = r_syn.synthetic_binary_codes(n, p, seed=40)
    db = pack_bits(bits)
    eng = _force_pool(t_make("sharded_amih", db, p, num_shards=S,
                             probe_workers=S, probe_mode=mode,
                             probe_backend="host", verify_backend="numpy"))
    seq = t_make("sharded_amih", db, p, num_shards=S, probe_backend="host",
                 verify_backend="numpy")
    assert eng._pool is None
    forks = pids = None
    for B, seed in ((12, 41), (1, 42), (32, 43), (12, 41)):
        q = pack_bits(r_syn.synthetic_queries(bits, B, seed=seed))
        ids, sims, _ = eng.knn_batch(q, k)
        want = seq.knn_batch(q, k)
        assert np.array_equal(ids, want[0]) and np.array_equal(sims,
                                                               want[1])
        if forks is None:
            forks, pids = eng._pool.forks, eng._pool.worker_pids()
        assert eng._pool.forks == forks
        assert eng._pool.worker_pids() == pids
    if mode == "process":
        assert forks == len(eng._pool.groups) > 0
    else:
        assert forks == 0 and pids == []
    pool = eng._pool
    _no_children(eng)
    eng.close()                                   # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        pool.probe(q, k, None)
    # a closed engine answers through the sequential chain, forking
    # nothing
    ids, sims, _ = eng.knn_batch(q, k)
    assert np.array_equal(sims, seq.knn_batch(q, k)[1])
    assert eng._pool is None


def test_parallel_gates_and_device_walk_stand_down():
    db, _ = _data(120, 64, 1, seed=11)
    eng = t_make("sharded_amih", db, 64, num_shards=4, probe_workers=4,
                 probe_backend="host", verify_backend="numpy")
    assert not eng._use_parallel(32)          # 30 rows a shard
    _force_pool(eng)
    assert eng._use_parallel(32) and eng._use_parallel(1)
    eng.PARALLEL_MIN_BATCH = 8
    assert not eng._use_parallel(1)
    eng.PARALLEL_MIN_BATCH = 0
    eng.PARALLEL_MIN_CPUS = 10 ** 6
    assert not eng._use_parallel(32)
    dev = _force_pool(t_make("sharded_amih", db, 64, num_shards=4, m=4,
                             probe_workers=4, devices=["cpu"]))
    assert not dev._use_parallel(32)          # the device walk: no pool


def test_one_shot_pool_and_shared_bound():
    db, q = _data(400, 64, 8, seed=17)
    seq = t_make("sharded_amih", db, 64, num_shards=4, probe_backend="host",
                 verify_backend="numpy")
    out = probe_shards_parallel(seq.indexes, q, 6, SharedBound(8, 6),
                                AMIHStats, max_workers=4, mode="thread")
    assert sorted(out) == [s for s, _ in seq.indexes]
    want = seq._probe_sequential(q, 6)

    def merged(shard_out, i):
        gids = np.concatenate([shard_out[s][0][i][0] for s in shard_out])
        sims = np.concatenate([shard_out[s][0][i][1] for s in shard_out])
        order = np.lexsort((gids, -sims))[:6]
        return gids[order], sims[order]

    for i in range(8):
        (gi, gs), (wi, ws) = merged(out, i), merged(want, i)
        assert np.array_equal(gi, wi) and np.array_equal(gs, ws)
    assert multiprocessing.active_children() == []
    # prime_ids equals the reference's
    for n, k in ((10, 3), (1000, 7), (5000, 100)):
        assert np.array_equal(prime_ids(n, k), r_pool.prime_ids(n, k))


def test_shared_bound_margin_monotone_and_dedup():
    sb = SharedBound(2, 3)
    assert np.all(np.isinf(sb.bounds)) and np.all(sb.bounds < 0)
    ids = np.array([5, 9, 11], dtype=np.int64)
    sims = np.array([0.9, 0.8, 0.7])
    sb.offer(0, ids, sims)
    assert sb.bounds[0] == t_pool.safe_bound(0.7) < 0.7
    assert 0.7 - sb.bounds[0] <= 16 * np.finfo(np.float64).eps
    sb.offer(0, ids, sims)                    # re-offers do not inflate
    assert sb.bounds[0] == t_pool.safe_bound(0.7)
    sb.offer(0, np.array([2], dtype=np.int64), np.array([0.95]))
    assert sb.bounds[0] == t_pool.safe_bound(0.8)
    sb.offer(0, np.array([3], dtype=np.int64), np.array([0.1]))
    assert sb.bounds[0] == t_pool.safe_bound(0.8)
    sb.raise_to(1, 0.0)
    assert sb.bounds[1] == 0.0
    # the margin separates two roundings of one exact cosine (C-R1:
    # z = 30, tuples (12, 18) and (15, 10), both 0.3 squared) ...
    from repro_torch.core.tuples import sim_value

    hi, lo = sim_value(64, 30, 12, 18), sim_value(64, 30, 15, 10)
    assert hi > lo and t_pool.safe_bound(hi) <= lo
    # ... and never reaches the next distinct cosine below
    assert t_pool.safe_bound(hi) > sim_value(64, 30, 12, 19)


def test_pipeline_smoke_on_cpu():
    from repro_torch.pipeline import smoke

    assert smoke.main(["--device", "cpu"]) == 0
    assert multiprocessing.active_children() == []
