"""The port's shard layer (``repro_torch.shard``) against the JAX
package's (``repro.shard``) on the CPU.

``ShardPlan`` equals the reference's plan field by field, through
``summary``/``from_summary`` and ``host_partition``; the mesh helpers read
the port's explicit ``DeviceMesh`` as the reference's read a mesh. Both
sharded engines equal the reference's on host plans — ids, float64 sims,
per-query stats, per-shard dicts (but for the device strings) and the
``launches.*`` counter deltas — at uneven n, k above a shard's rows and
more shards than rows, and equal the port's unsharded engines. Every case
is a fixed seed; nothing is drawn at random."""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro.core import make_engine as r_make
from repro.data import synthetic as r_syn
from repro.obs.metrics import REGISTRY as R_REG
from repro.shard import plan as r_plan
from repro_torch.core import pack_bits
from repro_torch.core.engine import make_engine as t_make
from repro_torch.core.linear_scan import sims_for_ids
from repro_torch.kernels import ops as t_ops
from repro_torch.obs import trace as t_trace
from repro_torch.obs.metrics import REGISTRY as T_REG
from repro_torch.shard import (
    ShardPlan,
    ShardedAMIHEngine,
    ShardedScanEngine,
    devices_from_mesh,
    make_device_mesh,
    make_retrieval_step,
    sharded_scan_candidates,
    sharded_scan_topk,
)
from repro_torch.shard import plan as t_plan
from repro_torch.shard.distributed import place_shards

_COUNTERS = ("launches.device_probe", "launches.device_probe_scan",
             "launches.verify_grouped")


@pytest.fixture(autouse=True)
def _process_state():
    """Run torch's CPU ops on one thread (the plain versions here are
    small, and the suite runs several workers at once), and restore the
    process-global state these tests may touch."""
    threads = torch.get_num_threads()
    dtype = torch.get_default_dtype()
    tracer = t_trace.current()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)
    t_trace.set_tracer(tracer)


def _data(n, p, B, seed):
    bits = r_syn.synthetic_binary_codes(n, p, seed=seed)
    q = r_syn.synthetic_queries(bits, B, seed=seed + 1)
    return pack_bits(bits), pack_bits(q)


# ------------------------------------------------------------------ plan
PLAN_CASES = [(10, 1), (10, 3), (37, 4), (100, 8), (5, 8), (1000, 7)]


@pytest.mark.parametrize("n,S", PLAN_CASES)
def test_plan_equals_reference(n, S):
    r, t = r_plan.ShardPlan.balanced(n, S), ShardPlan.balanced(n, S)
    assert (t.n, t.starts, t.counts, t.rows_padded, t.num_shards) == \
        (r.n, r.starts, r.counts, r.rows_padded, r.num_shards)
    db, _ = _data(n, 64, 1, seed=n)
    assert np.array_equal(t.padded_layout(db), r.padded_layout(db))
    for s in range(S):
        assert t.shard_slice(s) == r.shard_slice(s)
        ids = np.arange(t.counts[s])
        assert np.array_equal(t.global_ids(s, ids), r.global_ids(s, ids))
    assert t.summary() == r.summary()
    assert ShardPlan.from_summary(t.summary()) == t
    for h in range(1, S + 1):
        rp, tp = r.host_partition(h), t.host_partition(h)
        assert [p.summary() for p in tp] == [p.summary() for p in rp]
        for p in tp:
            assert ShardPlan.from_summary(p.summary()) == p
            assert p.shard_slice(0).start == 0
    with pytest.raises(ValueError):
        t.host_partition(S + 1)


def test_plan_placement_and_summary_round_trip():
    plan = ShardPlan.balanced(37, 4)
    placed = plan.place(["cpu", "meta"])
    assert [str(placed.device_for(s)) for s in range(4)] == \
        ["cpu", "meta", "cpu", "meta"]
    assert placed == plan                # placement is not the layout
    assert plan.device_for(0) is None
    assert plan.place(None).devices == ()
    summ = placed.summary()
    assert summ["devices"] == ["cpu", "meta", "cpu", "meta"]
    with pytest.warns(UserWarning, match="drops device placements"):
        back = ShardPlan.from_summary(summ)
    assert back == plan and back.devices == ()
    with pytest.raises(ValueError, match="drops device placements"):
        ShardPlan.from_summary(summ, strict=True)
    with pytest.raises(ValueError, match="devices maps"):
        ShardPlan(n=4, starts=(0, 2), counts=(2, 2), devices=("cpu",))


@pytest.mark.parametrize("shape,names,axes", [
    ((8,), ("data",), None),
    ((2, 4), ("pod", "data"), None),
    ((2, 4), ("pod", "data"), ("data",)),
    ((2, 4), ("pod", "data"), ("pod",)),
])
def test_mesh_helpers_equal_reference(shape, names, axes):
    """The reference's helpers read the port's DeviceMesh as a mesh
    (axis_names, shape, devices): both give the same shard devices."""
    devs = [torch.device("cpu")] * 8
    mesh = make_device_mesh(devs, shape=shape, axis_names=names)
    assert t_plan.resolve_mesh_axes(mesh, axes) == \
        r_plan.resolve_mesh_axes(mesh, axes)
    assert devices_from_mesh(mesh, axes) == \
        tuple(r_plan.devices_from_mesh(mesh, axes))
    plan = ShardPlan.from_mesh(mesh, 50, shard_axes=axes)
    want = r_plan.ShardPlan.balanced(
        50, r_plan.resolve_mesh_axes(mesh, axes)[1])
    assert plan.counts == want.counts
    assert len(plan.devices) == plan.num_shards


# --------------------------------------------------------------- engines
# (n, p, B, k, S, m): uneven n, k above a shard's rows, more shards than
# rows, a single shard
ENGINE_CASES = [
    pytest.param((37, 64, 8, 5, 4, 4), id="uneven"),
    pytest.param((300, 64, 16, 10, 8, 4), id="8-shards"),
    pytest.param((50, 64, 8, 20, 4, 4), id="k-above-shard-rows"),
    pytest.param((6, 32, 4, 3, 9, 2), id="more-shards-than-rows"),
    pytest.param((120, 128, 8, 7, 1, 8), id="one-shard"),
]

# port options -> the reference options they are held against
AMIH_BACKENDS = {
    "host-numpy": (dict(probe_backend="host", verify_backend="numpy"),
                   dict(probe_backend="host", verify_backend="numpy")),
    "host-cuda": (dict(probe_backend="host", verify_backend="cuda",
                       devices=["cpu"]),
                  dict(probe_backend="host", verify_backend="pallas")),
    "device-fused": (dict(probe_backend="device", devices=["cpu"]),
                     dict(probe_backend="device")),
    "device-per-shard": (dict(probe_backend="device", probe_fused=False,
                              devices=["cpu"]),
                         dict(probe_backend="device", probe_fused=False)),
}


def _strip(per_shard):
    """Per-shard dicts without what names a device (jax vs torch)."""
    return [{k: v for k, v in d.items() if k not in ("device", "launch_id")}
            for d in per_shard]


def _run(r_eng, t_eng, q, k):
    r0 = {c: R_REG.value(c) for c in _COUNTERS}
    t0 = {c: T_REG.value(c) for c in _COUNTERS}
    ri, rs, rst = r_eng.knn_batch(q, k)
    ti, ts, tst = t_eng.knn_batch(q, k)
    assert np.array_equal(ri, ti) and np.array_equal(rs, ts)
    assert ti.dtype == np.int64 and ts.dtype == np.float64
    assert [asdict(s) for s in rst.per_query] == \
        [asdict(s) for s in tst.per_query]
    assert _strip(rst.per_shard) == _strip(tst.per_shard)
    assert tst.shards == rst.shards
    assert {c: R_REG.value(c) - r0[c] for c in _COUNTERS} == \
        {c: T_REG.value(c) - t0[c] for c in _COUNTERS}
    return ti, ts, tst


def _check_unsharded(ti, ts, q, db, unsharded):
    """Equal to an unsharded engine of the port: the same sims (sorted:
    AMIH emits equal-cosine tuples in tuple order, ROADMAP C-R1), and
    every id carrying its exact sim."""
    ui, us, _ = unsharded.knn_batch(q, ti.shape[1])
    for i in range(q.shape[0]):
        assert np.array_equal(np.sort(ts[i]), np.sort(us[i]))
        assert np.array_equal(sims_for_ids(q[i], db, ti[i]), ts[i])
        assert len(set(ti[i].tolist())) == ti.shape[1]


@pytest.mark.parametrize("backend", sorted(AMIH_BACKENDS))
@pytest.mark.parametrize("case", ENGINE_CASES)
def test_sharded_amih_equals_reference(case, backend):
    n, p, B, k, S, m = case
    t_cfg, r_cfg = AMIH_BACKENDS[backend]
    db, q = _data(n, p, B, seed=n + p + S)
    q[0] = 0                                       # a zero-norm query
    r_eng = r_make("sharded_amih", db, p, num_shards=S, m=m, **r_cfg)
    t_eng = t_make("sharded_amih", db, p, num_shards=S, m=m, **t_cfg)
    assert isinstance(t_eng, ShardedAMIHEngine)
    ti, ts, tst = _run(r_eng, t_eng, q, k)
    # a second call reuses the per-device super index
    _run(r_eng, t_eng, q, k)
    unsharded = t_make("amih", db, p, m=m, device="cpu",
                       probe_backend="host", verify_backend="numpy")
    _check_unsharded(ti, ts, q, db, unsharded)
    assert sum(d["rows"] for d in tst.per_shard) == n
    t_eng.close()


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_sharded_scan_equals_reference_and_linear_scan(case):
    n, p, B, k, S, _ = case
    db, q = _data(n, p, B, seed=n + 2 * p + S)
    q[0] = 0
    r_eng = r_make("sharded_scan", db, p, num_shards=S)
    t_eng = t_make("sharded_scan", db, p, num_shards=S, devices=["cpu"])
    assert isinstance(t_eng, ShardedScanEngine)
    f0 = T_REG.value("launches.scan_topk")
    ti, ts, tst = _run(r_eng, t_eng, q, k)
    # one fused K4 top-K call per shard and batch
    assert T_REG.value("launches.scan_topk") - f0 == S
    assert [d["launches"] for d in tst.per_shard] == [1] * S
    li, ls, _ = t_make("linear_scan", db, p, device="cpu").knn_batch(q, k)
    assert np.array_equal(ti, li) and np.array_equal(ts, ls)


def test_sharded_amih_per_device_launches_and_placement():
    """Shards placed round-robin over a device list with repeats: one
    fused walk per DEVICE (the lead shard carries the launch, riders 0),
    counted under the device's own ``launches.device.<device>`` key."""
    db, q = _data(200, 64, 8, seed=11)
    eng = t_make("sharded_amih", db, 64, num_shards=6, m=4,
                 devices=["cpu", "cpu"])
    assert [str(d) for d in eng.plan.devices] == ["cpu"] * 6
    c0 = T_REG.value("launches.device.cpu")
    w0 = T_REG.value("launches.device_probe")
    ids, sims, st = eng.knn_batch(q, 10)
    assert T_REG.value("launches.device_probe") - w0 == 1
    assert T_REG.value("launches.device.cpu") > c0
    launches = [d["launches"] for d in st.per_shard]
    assert launches[0] >= 1 and launches[1:] == [0] * 5
    assert {d["launch_id"] for d in st.per_shard} == {"fused:cpu#1"}
    assert all(d["fused_shards"] == 6 for d in st.per_shard)


@pytest.mark.parametrize("n,S", [(5000, 7), (64, 8), (9, 3)])
def test_super_index_equals_a_fresh_build(n, S):
    """The per-device super index, merged from the shards' sorted tables,
    equals ``AMIHIndex.build`` of the concatenated rows table by table
    (ties included: duplicated codes across shards)."""
    from repro_torch.core.amih import AMIHIndex

    db, _ = _data(n, 128, 1, seed=n)
    db[n // 2 : n // 2 + 5] = db[1]
    eng = t_make("sharded_amih", db, 128, m=8, num_shards=S,
                 devices=["cpu"])
    sup = eng._fused_groups()[0]["super"]
    ref = AMIHIndex.build(db, 128, m=8, device="cpu")
    assert np.array_equal(sup.db_words, ref.db_words) and sup.m == ref.m
    for a, b in zip(sup.tables, ref.tables):
        assert (a.lo, a.hi) == (b.lo, b.hi)
        assert np.array_equal(a.sorted_vals, b.sorted_vals)
        assert np.array_equal(a.sorted_ids, b.sorted_ids)


def test_sharded_defaults_are_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    db, q = _data(40, 64, 2, seed=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_make("sharded_scan", db, 64, num_shards=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_make("sharded_amih", db, 64, num_shards=2, m=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_make("sharded_amih", db, 64, num_shards=2,
               probe_backend="host")
    # the host walk with the numpy verify, asked for, needs no device
    eng = t_make("sharded_amih", db, 64, num_shards=2,
                 probe_backend="host", verify_backend="numpy")
    assert eng.plan.devices == ()
    assert eng.knn_batch(q, 3)[0].shape == (2, 3)


def test_sharded_amih_bounded_equals_reference():
    """``knn_batch_bounded`` under an external floor: ragged rows and the
    raised floor equal the reference's."""
    db, q = _data(240, 64, 8, seed=5)
    r_eng = r_make("sharded_amih", db, 64, num_shards=4)
    t_eng = t_make("sharded_amih", db, 64, num_shards=4,
                   probe_backend="host", verify_backend="numpy")
    full, _, _ = t_eng.knn_batch(q, 6)
    floor_r = np.full(8, -np.inf)
    floor_r[::2] = 0.8
    floor_t = floor_r.copy()
    r_res, _ = r_eng.knn_batch_bounded(q, 6, floor_r)
    t_res, _ = t_eng.knn_batch_bounded(q, 6, floor_t)
    assert np.array_equal(floor_r, floor_t)
    for (ri, rs), (ti, ts) in zip(r_res, t_res):
        assert np.array_equal(ri, ti) and np.array_equal(rs, ts)
    with pytest.raises(ValueError, match="float64"):
        t_eng.knn_batch_bounded(q, 6, np.zeros(8, np.float32))


@pytest.mark.parametrize("n,S,hosts", [(997, 3, 2), (90, 4, 2), (64, 8, 3)])
def test_sharded_scan_on_a_host_sub_plan(n, S, hosts):
    """A cluster worker's sharded scan: the engine holds one host's row
    slab under a ``host_partition`` sub-plan (global ids from ``base``).
    The reference re-scores its candidates at their global ids in the
    local slab and raises (ROADMAP C-R7); the port returns the linear
    scan over the slab, ids offset by ``base``."""
    db, q = _data(n, 64, 4, seed=n)
    r_subs = r_plan.ShardPlan.balanced(n, S).host_partition(hosts)
    t_subs = ShardPlan.balanced(n, S).host_partition(hosts)
    for h, (r_sub, t_sub) in enumerate(zip(r_subs, t_subs)):
        slab = db[t_sub.base : t_sub.base + t_sub.n]
        ids, sims, st = t_make("sharded_scan", slab, 64, plan=t_sub,
                               devices=["cpu"]).knn_batch(q, 5)
        for i in range(q.shape[0]):
            w_ids, w_sims = r_make("linear_scan", slab, 64,
                                   compute_backend="pallas").knn_batch(
                                       q[i:i + 1], 5)[:2]
            assert np.array_equal(ids[i], w_ids[0] + t_sub.base)
            assert np.array_equal(sims[i], w_sims[0])
        assert sum(s["candidates"] for s in st.per_shard) > 0
        if h:
            with pytest.raises(IndexError):
                r_make("sharded_scan", slab, 64, plan=r_sub).knn_batch(q, 5)


def test_c_r3_on_the_fused_device_path(monkeypatch):
    """ROADMAP C-P3's draw: the reference's fused device path comes up
    short of k with no pool at all (C-R3), the port's returns the float64
    scan's sims, and the port's too comes up short with its rounding
    margin (``shardpool.BOUND_MARGIN``) taken away."""
    from repro_torch.core.linear_scan import sims_against_db
    from repro_torch.pipeline import shardpool as t_pool

    p, n, B, k, seed = 32, 255, 10, 8, 1023355463
    bits = r_syn.synthetic_binary_codes(n, p, seed=seed, flip_prob=0.05)
    db = pack_bits(bits)
    q = pack_bits(r_syn.synthetic_queries(bits, B, seed=seed + 1))
    cfg = dict(num_shards=3, m=3, probe_backend="device")
    with pytest.raises(ValueError, match="broadcast"):
        r_make("sharded_amih", db, p, **cfg).knn_batch(q, k)
    ids, sims, _ = t_make("sharded_amih", db, p, devices=["cpu"],
                          **cfg).knn_batch(q, k)
    assert ids.shape == sims.shape == (B, k)
    for i in range(B):
        scan = np.sort(sims_against_db(q[i], db))[::-1][:k]
        assert np.array_equal(np.sort(sims[i]), np.sort(scan))
        assert np.array_equal(sims_for_ids(q[i], db, ids[i]), sims[i])
    monkeypatch.setattr(t_pool, "BOUND_MARGIN", 0.0)
    with pytest.raises(ValueError, match="broadcast"):
        t_make("sharded_amih", db, p, devices=["cpu"],
               **cfg).knn_batch(q, k)


# ----------------------------------------------------------- primitives
@pytest.mark.parametrize("n,S,k", [(64, 4, 5), (70, 7, 16), (9, 4, 12)])
def test_sharded_scan_primitives(n, S, k):
    db, q = _data(n, 64, 8, seed=n + S)
    whole_s, whole_i = t_ops.scan_topk(t_ops.to_device(q, "cpu"),
                                       t_ops.to_device(db, "cpu"), k)
    plan = ShardPlan.balanced(n, S).place(["cpu"])
    sims, gids = sharded_scan_candidates(
        plan, q, place_shards(plan, db), min(k, plan.rows_padded))
    assert sims.shape == gids.shape == (8, S * min(k, plan.rows_padded))
    assert np.all((gids >= 0) == (sims > -np.inf))
    for i in range(8):
        got = gids[i][gids[i] >= 0]
        # the pool holds each shard's exact top-k: the global top-k too
        assert set(whole_i[i].numpy().tolist()) <= set(got.tolist())
    if n % S == 0:
        mesh = make_device_mesh(["cpu"] * S)
        ts, ti = sharded_scan_topk(mesh, q, db, k)
        assert torch.equal(ts, whole_s) and torch.equal(ti, whole_i)
        step, devices = make_retrieval_step(mesh, k)
        assert len(devices) == S
        ss, si = step(q, db)
        assert torch.equal(ss, whole_s) and torch.equal(si, whole_i)
    else:
        with pytest.raises(ValueError, match="divide"):
            sharded_scan_topk(make_device_mesh(["cpu"] * S), q, db, k)
