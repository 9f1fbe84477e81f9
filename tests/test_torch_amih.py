"""The port's AMIH engine against the JAX package's, on the CPU.

``make_engine("amih", ..., device="cpu")`` of the port and the reference's
``make_engine("amih", ...)`` search the same codes; ids, float64 sims,
per-query ``AMIHStats``, ``index.verify_launches`` and the ``launches.*``
counter deltas must be equal — for the device walk (``probe_backend=
"device"``, the kernels' plain versions on the CPU) and the host walk
(``verify_backend="numpy"``, and ``"cuda"`` against the reference's
``"pallas"``)."""

from dataclasses import asdict

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.core import pack_bits
from repro.core.amih import AMIHIndex as RIndex
from repro.core.engine import make_engine as r_make
from repro.obs.metrics import REGISTRY as R_REG
from repro_torch.convert import index_from_reference, index_state
from repro_torch.core.amih import AMIHIndex as TIndex
from repro_torch.core.amih import AMIHStats as TStats
from repro_torch.core.engine import AMIHEngine
from repro_torch.core.engine import make_engine as t_make
from repro_torch.kernels import device_probe as t_kdp
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels.device_probe import POS_INF
from repro_torch.obs.metrics import REGISTRY as T_REG

_COUNTERS = ("launches.device_probe", "launches.device_probe_scan",
             "launches.verify_grouped")


def _data(n, p, B, seed, near=True):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2, size=(n, p)).astype(np.uint8)
    if near:
        q = base[rng.integers(0, n, size=B)].copy()
        for i in range(B):
            q[i, rng.choice(p, size=1 + i % 6, replace=False)] ^= 1
    else:
        q = rng.integers(0, 2, size=(B, p)).astype(np.uint8)
    return pack_bits(base), pack_bits(q)


def _deltas(reg, before):
    return {c: reg.value(c) - before[c] for c in _COUNTERS}


def _run_both(r_eng, t_eng, q, k):
    r0 = {c: R_REG.value(c) for c in _COUNTERS}
    t0 = {c: T_REG.value(c) for c in _COUNTERS}
    ri, rs, rst = r_eng.knn_batch(q, k)
    ti, ts, tst = t_eng.knn_batch(q, k)
    assert np.array_equal(ri, ti)
    assert np.array_equal(rs, ts)
    assert [asdict(s) for s in rst.per_query] == \
        [asdict(s) for s in tst.per_query]
    assert _deltas(R_REG, r0) == _deltas(T_REG, t0)
    assert r_eng.index.verify_launches == t_eng.index.verify_launches
    return ti, ts, tst


@pytest.mark.parametrize(
    "p,B,n,k",
    [(32, 1, 300, 5), (32, 64, 400, 9), (64, 8, 500, 10), (64, 64, 600, 10),
     (128, 8, 300, 7), (128, 1, 300, 40)],
)
def test_device_walk_engine_equals_reference(p, B, n, k):
    db, q = _data(n, p, B, seed=p * 7 + B)
    q[0] = 0                                        # a zero-norm query
    r_eng = r_make("amih", db, p, probe_backend="device", query_cache_size=0)
    t_eng = t_make("amih", db, p, probe_backend="device", query_cache_size=0,
                   device="cpu")
    _run_both(r_eng, t_eng, q, k)


@pytest.mark.parametrize("p,B,n", [(32, 8, 300), (64, 64, 500), (128, 1, 200)])
def test_host_walk_engine_equals_reference(p, B, n):
    db, q = _data(n, p, B, seed=p + B, near=False)
    q[-1] = 0
    r_eng = r_make("amih", db, p, probe_backend="host",
                   verify_backend="numpy")
    t_eng = t_make("amih", db, p, probe_backend="host",
                   verify_backend="numpy")
    _run_both(r_eng, t_eng, q, 6)
    _run_both(r_eng, t_eng, q, 6)                   # hot-query cache hits


def test_host_walk_cuda_verify_equals_pallas():
    p, n, B = 64, 400, 8
    db, q = _data(n, p, B, seed=17)
    r_eng = r_make("amih", db, p, verify_backend="pallas")
    t_eng = t_make("amih", db, p, probe_backend="host", verify_backend="cuda",
                   device="cpu")
    _run_both(r_eng, t_eng, q, 8)


def test_k_larger_than_n_and_truncated_stream():
    p, n = 32, 90
    db, q = _data(n, p, 6, seed=23)
    for cap in (1 << 16, 64):
        r_eng = r_make("amih", db, p, probe_backend="device",
                       probe_stream_cap=cap, query_cache_size=0)
        t_eng = t_make("amih", db, p, probe_backend="device",
                       probe_stream_cap=cap, query_cache_size=0,
                       device="cpu")
        _, _, st = _run_both(r_eng, t_eng, q, n + 50)
    assert any(s.fell_back_to_scan for s in st.per_query)


def test_fused_equals_per_group_launches():
    p, n, B = 64, 800, 24
    db, q = _data(n, p, B, seed=31)
    t_eng = t_make("amih", db, p, probe_backend="device", query_cache_size=0,
                   device="cpu")
    before = T_REG.value("launches.device_probe")
    ids, sims, _ = t_eng.knn_batch(q, 8)
    assert T_REG.value("launches.device_probe") - before == 1
    t_eng.index.probe_fused = False
    ids2, sims2, _ = t_eng.knn_batch(q, 8)
    assert np.array_equal(ids, ids2) and np.array_equal(sims, sims2)


@pytest.mark.parametrize("backend", ["device", "host"])
def test_bounded_search_equals_reference(backend):
    p, n, B, k = 64, 500, 16, 8
    db, q = _data(n, p, B, seed=21, near=False)
    ref = RIndex.build(db, p, probe_backend=backend)
    port = index_from_reference(index_state(ref), probe_backend=backend,
                                verify_backend="numpy", device="cpu")
    for bound in (-np.inf, 0.4, 1.01):
        bounds = np.full(B, bound)
        rs = ref.knn_batch_bounded(q, k, stop_below=bounds)
        got = []
        ts = port.knn_batch_bounded(
            q, k, stop_below=bounds, stats=[TStats() for _ in range(B)],
            on_done=lambda qi, ids, sims: got.append(qi),
        )
        for (ri, rsim), (ti, tsim) in zip(rs, ts):
            assert np.array_equal(ri, ti) and np.array_equal(rsim, tsim)
        assert sorted(got) == sorted(
            i for i, (ti, _) in enumerate(ts) if ti.size >= k)


def test_index_from_reference_round_trip():
    p, n = 128, 300
    db, q = _data(n, p, 5, seed=2)
    ref = RIndex.build(db, p, m=8, id_offset=1000, probe_backend="host",
                       verify_backend="numpy")
    state = index_state(ref)
    port = index_from_reference(state, probe_backend="host",
                                verify_backend="numpy")
    own = TIndex.build(db, p, m=8, id_offset=1000, probe_backend="host",
                       verify_backend="numpy")
    back = index_state(port)
    for st2 in (back, index_state(own)):
        assert {k: st2[k] for k in ("p", "m", "id_offset")} == \
            {k: state[k] for k in ("p", "m", "id_offset")}
        assert np.array_equal(st2["db_words"], state["db_words"])
        for a, b in zip(st2["tables"], state["tables"]):
            assert (a["lo"], a["hi"]) == (b["lo"], b["hi"])
            assert np.array_equal(a["sorted_vals"], b["sorted_vals"])
            assert np.array_equal(a["sorted_ids"], b["sorted_ids"])
    ri, rs = ref.knn_batch(q, 9)
    ti, ts = port.knn_batch(q, 9)
    assert np.array_equal(ri, ti) and np.array_equal(rs, ts)
    bad = dict(state, tables=state["tables"][:-1])
    with pytest.raises(ValueError):
        index_from_reference(bad)


def test_linear_scan_engine_equals_reference():
    db, q = _data(400, 64, 6, seed=4)
    for r_cfg, t_cfg in (({}, {"compute_backend": "numpy"}),
                         ({"compute_backend": "pallas"}, {"device": "cpu"})):
        ri, rs, _ = r_make("linear_scan", db, 64, **r_cfg).knn_batch(q, 12)
        ti, ts, _ = t_make("linear_scan", db, 64, **t_cfg).knn_batch(q, 12)
        assert np.array_equal(ri, ti) and np.array_equal(rs, ts)


def test_layers_not_ported_raise():
    db, _ = _data(64, 32, 1, seed=0)
    for backend, item in (("single_table", "A5"), ("sharded_amih", "A6"),
                          ("sharded_scan", "A6"), ("cluster", "A9")):
        with pytest.raises(NotImplementedError, match=item):
            t_make(backend, db, 32)
    with pytest.raises(NotImplementedError, match="A7"):
        t_make("amih", db, 32, overlap_verify=True)
    with pytest.raises(ValueError, match="pallas"):
        t_make("linear_scan", db, 32, compute_backend="pallas")
    eng = t_make("amih", db, 32, device="cpu")
    assert isinstance(eng, AMIHEngine)
    with pytest.raises(NotImplementedError, match="A7"):
        eng.index.knn_batch(db[:1], 3, overlap=object())


# ------------------------------------------ AMIH extraction (slice 6)
@settings(max_examples=10, deadline=None)
@given(p=st.sampled_from([32, 64, 128]), seed=st.integers(0, 1 << 16),
       k=st.sampled_from([1, 6, 40]), cap=st.sampled_from([1 << 16, 128]),
       B=st.sampled_from([1, 5, 16]))
def test_device_walk_extraction_equals_reference(p, seed, k, cap, B):
    """The whole ``knn_batch`` through the touched-list extraction and the
    fused scan's plain version against the reference: ids, float64 sims,
    every per-query stat and the launch counters, with truncated schedules
    (``probe_stream_cap``) that send queries to the scan."""
    db, q = _data(300, p, B, seed=seed)
    kw = dict(probe_backend="device", query_cache_size=0,
              probe_stream_cap=cap)
    _run_both(r_make("amih", db, p, **kw),
              t_make("amih", db, p, device="cpu", **kw), q, k)


def test_mixed_bails_ties_and_k_above_the_fused_cap():
    """One batch with queries the walk finishes (a cluster of 200 codes one
    bit from theirs, each code twice: ties at the k-th position) and far
    queries it sends to the scan under a truncated schedule, at k = 1, 9
    and above the fused scan's cap (the card's map route), against the
    reference."""
    p, n = 32, 1300
    db, q = _data(n, p, 12, seed=41, near=False)
    rng = np.random.default_rng(3)
    flips = rng.integers(0, p, size=(200, 1)).astype(np.uint32)
    db[:200] = db[0] ^ (np.uint32(1) << flips)
    db[200:400] = db[:200]
    q[:6] = db[0]
    kw = dict(probe_backend="device", query_cache_size=0,
              probe_stream_cap=96)
    r_eng = r_make("amih", db, p, **kw)
    t_eng = t_make("amih", db, p, device="cpu", **kw)
    for k in (1, 9, 1100):
        _, _, st_ = _run_both(r_eng, t_eng, q, k)
        bails = [s.fell_back_to_scan for s in st_.per_query]
        assert bails[6:] == [True] * 6
        assert bails[:6] == [k > 9] * 6


def _pooled_maps():
    return [buf for bufs in t_ops._POSMAP_POOL.values() for buf in bufs]


def test_pooled_maps_hold_pos_inf_after_batches_bails_and_errors(
        monkeypatch):
    """A pooled position map is filled once, when allocated, and holds
    POS_INF everywhere after a batch, after a batch with bails, and after a
    batch that raised (whose map is dropped, not recycled)."""
    p, n = 64, 600
    db, q = _data(n, p, 16, seed=5)
    monkeypatch.setattr(t_ops, "_POSMAP_POOL", {})
    seen = set()
    for cap in (1 << 16, 96):                   # no bails, then bails
        eng = t_make("amih", db, p, device="cpu", query_cache_size=0,
                     probe_stream_cap=cap)
        for _ in range(2):
            _, _, st_ = eng.knn_batch(q, 7)
            bufs = _pooled_maps()
            assert bufs and all(bool((b == POS_INF).all()) for b in bufs)
            seen.update(id(b) for b in bufs)
        if cap == 96:
            assert any(s.fell_back_to_scan for s in st_.per_query)
    assert len(seen) == 1          # one (16, n_pad) map, reused unfilled
    held = _pooled_maps()

    def broken(*a, **kw):
        raise RuntimeError("extraction failed")

    monkeypatch.setattr(t_kdp, "extract_touched", broken)
    with pytest.raises(RuntimeError, match="extraction failed"):
        eng.knn_batch(q, 7)
    bufs = _pooled_maps()
    assert len(bufs) == len(held) - 1           # the batch's map is gone
    assert all(bool((b == POS_INF).all()) for b in bufs)
