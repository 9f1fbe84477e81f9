"""The port's cluster tier (``repro_torch.cluster``) against the JAX
package's (``repro.cluster``) on the CPU.

Frames written by the port equal the reference's byte for byte, and each
package reads the other's; ragged planes and the stats wire cross between
the packages. The worker's frame loop runs in-process; the coordinator's
failure semantics run against stub workers with the reference tests'
timeouts (request timeout, corrupt result, heartbeat after a slow build,
a SIGKILLed worker). End to end, a module-scoped fleet of two spawned
port workers (3 shards over 2 hosts, uneven) returns ids and float64 sims
bit-identical to the reference's ``cluster`` engine over a reference
fleet and to the port's in-process ``sharded_amih`` over the same plan;
the mixed fleets (a port coordinator with reference workers, and the
reverse) give the same arrays. The port's workers are spawned with
``device="cpu"`` and run the kernels' plain versions; a worker left on
its default device (the card) where there is none fails its build, and
the coordinator raises. Every case is a fixed seed; at most one fleet a
side is module-scoped, every fleet is closed, and no child outlives its
fixture or test.
"""

import contextlib
import json
import multiprocessing
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from repro.cluster import LocalCluster as RFleet
from repro.cluster import transport as r_tp
from repro.cluster import worker as r_worker
from repro.core import AMIHStats as RStats
from repro.core import make_engine as r_make
from repro.core.engine import EngineStats as REngineStats
from repro.core.single_table import SearchStats as RSearchStats
from repro.data import synthetic as r_syn
from repro_torch.cluster import (
    ClusterDegradedError,
    ClusterError,
    FrameError,
    LocalCluster,
    RequestTimeoutError,
    WorkerDiedError,
    WorkerServer,
)
from repro_torch.cluster import launch as t_launch
from repro_torch.cluster import smoke as t_smoke
from repro_torch.cluster import transport as t_tp
from repro_torch.cluster import worker as t_worker
from repro_torch.cluster.coordinator import ClusterCoordinator, _WorkerHandle
from repro_torch.core import AMIHStats, pack_bits
from repro_torch.core.engine import EngineStats
from repro_torch.core.engine import make_engine as t_make
from repro_torch.core.linear_scan import linear_scan_knn, sims_against_db, \
    sims_for_ids
from repro_torch.core.single_table import SearchStats
from repro_torch.obs import trace as t_trace
from repro_torch.shard import ShardPlan

CPU = {"devices": ["cpu"]}
HOST = dict(probe_backend="host", verify_backend="numpy")


@pytest.fixture(autouse=True)
def _process_state():
    """Run torch's CPU ops on one thread, and restore the process-global
    state these tests may touch; check that no environment key, start
    method or default socket timeout changed."""
    threads = torch.get_num_threads()
    dtype = torch.get_default_dtype()
    tracer = t_trace.current()
    env = _env()
    method = _start_method()
    timeout = socket.getdefaulttimeout()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)
    t_trace.set_tracer(tracer)
    assert _env() == env
    assert _start_method() == method
    assert socket.getdefaulttimeout() == timeout


def _start_method():
    """The start method in force. Starting a spawn-context process fixes
    the platform's default in place of None (``multiprocessing.spawn``
    asks for it), which changes no behaviour."""
    method = multiprocessing.get_start_method(allow_none=True)
    return method or multiprocessing.get_all_start_methods()[0]


def _env():
    """The environment but pytest's own note of the running test."""
    return {k: v for k, v in os.environ.items()
            if k != "PYTEST_CURRENT_TEST"}


@contextlib.contextmanager
def _one_thread_children():
    """Spawned workers start with one torch thread: they inherit
    ``OMP_NUM_THREADS=1``, set only while they start."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _fleet(cls, hosts, **kw):
    with _one_thread_children():
        return cls(hosts, **kw)


def _close_fleet(fl):
    fl.close()
    assert not any(p.is_alive() for p in fl.procs)


@pytest.fixture(scope="module")
def fleet():
    """Two spawned port workers for every end-to-end test here (workers
    accept a new coordinator per engine)."""
    fl = _fleet(LocalCluster, 2, device="cpu")
    yield fl
    _close_fleet(fl)


@pytest.fixture(scope="module")
def r_fleet():
    """Two spawned reference workers, for the reference's engine and the
    mixed fleets."""
    fl = _fleet(RFleet, 2)
    yield fl
    _close_fleet(fl)


def _data(n, p, B, seed):
    bits = r_syn.synthetic_binary_codes(n, p, seed=seed)
    return pack_bits(bits), pack_bits(r_syn.synthetic_queries(bits, B,
                                                             seed=seed + 1))


def _run(make, db, p, qs, k, **cfg):
    eng = make("cluster", db, p, **cfg)
    try:
        return eng.knn_batch(qs, k)
    finally:
        eng.close()


def _check_exact(ids, sims, qs, db, k):
    """Sims bit-identical to the scan; ids distinct and carrying them."""
    assert ids.shape == sims.shape == (qs.shape[0], k)
    for i in range(qs.shape[0]):
        assert np.array_equal(sims[i], linear_scan_knn(qs[i], db, k)[1])
        assert np.array_equal(sims_for_ids(qs[i], db, ids[i]), sims[i])
        assert len(set(ids[i].tolist())) == k


def _eq(a, b):
    assert a.dtype == b.dtype and np.array_equal(a, b)


# ============================================================= transport
def _wire(send, kind, meta=None, arrays=None):
    """The bytes ``send`` puts on a socketpair for one frame."""
    a, b = socket.socketpair()
    try:
        send(a, kind, meta, arrays)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)
    finally:
        a.close()
        b.close()


FRAMES = {
    "search": ("search", {"req": 7, "k": 10, "trace": {"id": "ab12",
                                                        "host": "host1"}},
               {"q": np.arange(12, dtype=np.uint32).reshape(3, 4),
                "floor": np.array([-np.inf, 0.25, 1 / 3])}),
    "bare": ("ping", None, None),
    "pong": ("pong", {"seq": 3, "ts": 123456.789012}, None),
    "bound": ("bound", {"req": 2},
              {"qi": np.array([0, 5], np.int64),
               "val": np.array([0.7071067811865476, 0.1])}),
    "build": ("build", {"host": 1, "p": 64, "backend": "sharded_amih",
                        "plan": ShardPlan.balanced(997, 5)
                        .host_partition(2)[1].summary(),
                        "cfg": {"m": 4, "devices": ["cuda:0"],
                                "enumeration_cap": None}},
              {"db": np.arange(40, dtype=np.uint32).reshape(20, 2)}),
    "result": ("result", {"req": 9, "message": "é ünïcode",
                          "stats": {"per_query": [{"_kind": "AMIHStats",
                                                   "probes": 3}]},
                          "spans": [{"name": "amih.probe", "ts": 1.5,
                                     "dur": 2.25, "host": "host0"}]},
               {"ids": np.array([3, 1, 4], np.int64),
                "sims": np.array([0.9, 0.5, 0.25]),
                "lens": np.array([2, 0, 1], np.int64),
                "empty": np.empty((0, 3), np.float32),
                "u8": np.arange(5, dtype=np.uint8),
                "u64": np.array([1 << 63], np.uint64),
                "i32": np.array([-1], np.int32)}),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_equal_reference_byte_for_byte(name):
    """The same frame written by both packages is the same bytes, and each
    package reads the other's frame back to the same kind, meta and
    arrays (over a socketpair)."""
    kind, meta, arrays = FRAMES[name]
    frame = _wire(t_tp.send_frame, kind, meta, arrays)
    assert frame[:4] == b"AMRP"
    assert frame == _wire(r_tp.send_frame, kind, meta, arrays)
    for send, recv in ((t_tp.send_frame, r_tp.recv_frame),
                       (r_tp.send_frame, t_tp.recv_frame)):
        a, b = socket.socketpair()
        try:
            send(a, kind, meta, arrays)
            got_kind, got_meta, got = recv(b, timeout=10)
        finally:
            a.close()
            b.close()
        assert got_kind == kind and got_meta == (meta or {})
        assert set(got) == set(arrays or {})
        for key, arr in (arrays or {}).items():
            _eq(got[key], arr)


@pytest.mark.parametrize("send,recv", [
    (t_tp.send_frame, r_tp.recv_frame), (r_tp.send_frame, t_tp.recv_frame),
    (t_tp.send_frame, t_tp.recv_frame)], ids=["port-ref", "ref-port",
                                              "port-port"])
def test_frame_partial_reads(send, recv):
    """A frame that arrives one byte at a time is read whole, by either
    package from either package's writer."""
    arrays = {"ids": np.arange(1000, dtype=np.int64),
              "sims": np.linspace(0, 1, 7)}
    frame = _wire(send, "result", {"req": 1}, arrays)
    a, b = socket.socketpair()

    def trickle():
        for i in range(len(frame)):
            a.sendall(frame[i : i + 1])

    t = threading.Thread(target=trickle, daemon=True)
    t.start()
    try:
        kind, meta, got = recv(b, timeout=30)
    finally:
        t.join(timeout=30)
        a.close()
        b.close()
    assert kind == "result" and meta == {"req": 1}
    for key, arr in arrays.items():
        _eq(got[key], arr)


def _bad_frames():
    frame = _wire(r_tp.send_frame, "result", {"req": 1},
                  {"ids": np.arange(64, dtype=np.int64)})
    neg = json.dumps({"kind": "result", "arrays": [
        {"name": "z", "dtype": "int64", "shape": [-1, 1 << 40]}]}).encode()
    f16 = json.dumps({"kind": "x", "arrays": [
        {"name": "h", "dtype": "float16", "shape": [2]}]}).encode()
    return {
        "truncated": (frame[: len(frame) // 2], "mid-frame"),
        "bad_magic": (b"NOPE" + frame[4:], "magic"),
        "negative_shape": (b"AMRP" + struct.pack(">I", len(neg)) + neg,
                           "negative dimension"),
        "non_wire_dtype": (b"AMRP" + struct.pack(">I", len(f16)) + f16,
                           "non-wire dtype"),
        "huge_header": (b"AMRP" + struct.pack(">I", 1 << 30), "header"),
        "bad_json": (b"AMRP" + struct.pack(">I", 3) + b"{x}",
                     "undecodable"),
    }


@pytest.mark.parametrize("name", sorted(_bad_frames()))
def test_bad_frames_raise_as_in_the_reference(name):
    """Both packages refuse the same malformed bytes with a FrameError of
    the same message."""
    data, match = _bad_frames()[name]
    messages = []
    for recv, err in ((t_tp.recv_frame, t_tp.FrameError),
                      (r_tp.recv_frame, r_tp.FrameError)):
        a, b = socket.socketpair()
        try:
            a.sendall(data)
            a.close()          # EOF after the bytes
            with pytest.raises(err, match=match) as info:
                recv(b, timeout=10)
            messages.append(str(info.value))
        finally:
            b.close()
    assert messages[0] == messages[1]


def test_send_refuses_non_wire_dtype_and_timeout_bounds_wait():
    a, b = socket.socketpair()
    try:
        with pytest.raises(ValueError, match="non-wire dtype"):
            t_tp.send_frame(a, "x", arrays={"h": np.zeros(2, np.float16)})
        t0 = time.perf_counter()
        with pytest.raises((socket.timeout, TimeoutError)):
            t_tp.recv_frame(b, timeout=0.2)
        assert time.perf_counter() - t0 < 5.0
        # nothing was sent, and the socket is reusable after the timeout
        t_tp.send_frame(a, "pong", {"seq": 3})
        kind, meta, _ = t_tp.recv_frame(b, timeout=5.0)
        assert kind == "pong" and meta == {"seq": 3}
    finally:
        a.close()
        b.close()


RAGGED = {
    "mixed": [np.array([3, 1, 4], np.int64), np.empty(0, np.int64),
              np.array([1, 5], np.int64)],
    "sims": [np.array([0.5, 0.25]), np.array([0.125])],
    "empty": [],
    "all_empty": [np.empty(0, np.int64)] * 3,
}


@pytest.mark.parametrize("name", sorted(RAGGED))
def test_ragged_packing_equals_reference(name):
    planes = RAGGED[name]
    dtype = np.float64 if name == "sims" else np.int64
    t_flat, t_lens = t_tp.pack_ragged(planes, dtype=dtype)
    r_flat, r_lens = r_tp.pack_ragged(planes, dtype=dtype)
    _eq(t_flat, r_flat)
    _eq(t_lens, r_lens)
    for unpack in (t_tp.unpack_ragged, r_tp.unpack_ragged):
        back = unpack(t_flat, t_lens)
        assert [p.tolist() for p in back] == [p.tolist() for p in planes]
    if t_lens.size:
        with pytest.raises(FrameError, match="lengths sum"):
            t_tp.unpack_ragged(t_flat, t_lens + 1)


def _stats(stats_cls, engine_cls, search_cls):
    return engine_cls(
        backend="sharded_amih", queries=3,
        per_query=[stats_cls(probes=3, tuples_processed=7, max_radius=2,
                             exceeded_rhat=True), search_cls(retrieved=4),
                   None],
        shards=2, per_shard=[{"shard": 0, "rows": 5, "device": "cpu"}],
        cache_info={"hits": 1},
    )


def test_stats_wire_crosses_the_packages():
    """The port's wire dict equals the reference's, and each package
    decodes the other's into its own AMIHStats/SearchStats."""
    t_wire = t_worker.stats_to_wire(_stats(AMIHStats, EngineStats,
                                           SearchStats))
    r_wire = r_worker.stats_to_wire(_stats(RStats, REngineStats,
                                           RSearchStats))
    assert json.dumps(t_wire) == json.dumps(r_wire)
    t_back = t_worker.stats_from_wire(r_wire)
    r_back = r_worker.stats_from_wire(t_wire)
    assert isinstance(t_back.per_query[0], AMIHStats)
    assert isinstance(t_back.per_query[1], SearchStats)
    assert isinstance(r_back.per_query[0], RStats)
    assert t_back.per_query[2] is None and r_back.per_query[2] is None
    assert t_back.per_query[0].tuples_processed == 7
    assert t_back.per_shard == r_back.per_shard == r_wire["per_shard"]
    assert t_back.cache_info == r_back.cache_info == {"hits": 1}
    assert (t_back.backend, t_back.queries, t_back.shards) == \
        (r_back.backend, r_back.queries, r_back.shards)
    # a real engine's stats are JSON as they stand
    db, qs = _data(200, 64, 3, seed=30)
    eng = t_make("sharded_amih", db, 64, num_shards=2, **CPU)
    _, st = eng.knn_batch_bounded(qs, 4, np.full(3, -np.inf))
    wire = json.loads(json.dumps(t_worker.stats_to_wire(st)))
    assert r_worker.stats_from_wire(wire).aggregate() == st.aggregate()


# ====================================================== worker, in-process
def _serve(device="cpu"):
    srv = WorkerServer("127.0.0.1", 0, device=device)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t


def _stop(srv, t):
    srv.close()
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(probe_backend="host", verify_backend="numpy"),
    dict(CPU, probe_backend="host", verify_backend="cuda"),
], ids=["device-walk", "host-numpy", "host-cuda"])
def test_worker_frame_loop_in_process(cfg):
    """One port WorkerServer (``device="cpu"``) driven over raw frames by
    the reference's transport: build -> ready, a bounded search returning
    exact global-id planes, bound frames published when queries fill k
    (the exact local k-th, rising), and a live remote bound absorbed.
    The shards lie on the worker's device, or on the frame's
    ``devices``."""
    p, n, B, k = 64, 600, 4, 5
    db, qs = _data(n, p, B, seed=20)
    sub = ShardPlan.balanced(n, 4).host_partition(2)[1]
    srv, t = _serve()
    sock = socket.create_connection(srv.addr, timeout=30)
    try:
        r_tp.send_frame(sock, "build", {
            "host": 1, "p": p, "backend": "sharded_amih",
            "plan": sub.summary(), "cfg": cfg,
        }, {"db": db[sub.base : sub.base + sub.n]})
        kind, meta, _ = r_tp.recv_frame(sock, timeout=60)
        assert kind == "ready" and meta == {"host": 1, "n": sub.n,
                                            "shards": 2}
        r_tp.send_frame(sock, "search", {"req": 0, "k": k}, {
            "q": qs, "floor": np.full(B, -np.inf),
        })
        bounds, result = [], None
        while result is None:
            kind, meta, arrays = r_tp.recv_frame(sock, timeout=60)
            if kind == "bound":
                assert meta["req"] == 0
                bounds.append((int(arrays["qi"][0]),
                               float(arrays["val"][0])))
                r_tp.send_frame(sock, "bound", {"req": 0}, {
                    "qi": arrays["qi"].copy(), "val": arrays["val"].copy(),
                })
            else:
                assert kind == "result"
                result = (meta, arrays)
        meta, arrays = result
        ids = r_tp.unpack_ragged(arrays["ids"], arrays["lens"])
        sims = r_tp.unpack_ragged(arrays["sims"], arrays["lens"])
        slab = db[sub.base : sub.base + sub.n]
        for i in range(B):
            assert sims[i].shape[0] >= k
            assert np.array_equal(sims[i][:k],
                                  linear_scan_knn(qs[i], slab, k)[1])
            assert (ids[i] >= sub.base).all()
            assert np.array_equal(sims_for_ids(qs[i], db, ids[i]), sims[i])
        assert {qi for qi, _ in bounds} == set(range(B))
        last = {}
        for qi, val in bounds:
            assert val > last.get(qi, -np.inf)
            last[qi] = val
        for i in range(B):
            assert last[i] == sims[i][k - 1]
        st = r_worker.stats_from_wire(meta["stats"])
        assert st.queries == B and st.shards == sub.num_shards
        assert {s["device"] for s in st.per_shard} == {"cpu"}
    finally:
        sock.close()
        _stop(srv, t)


@pytest.mark.parametrize("meta,named", [
    ({"backend": "sharded_amih",
      "cfg": dict(CPU, probe_backend="host", verify_backend="pallas")},
     "'pallas'"),
    ({"backend": "sharded_amih", "cfg": dict(CPU, probe_backend="tpu")},
     "'tpu'"),
    ({"backend": "amih", "cfg": {}}, "'amih'"),
    ({"backend": "sharded_scan", "cfg": dict(CPU, mesh_axes=1)},
     "mesh_axes"),
    ({}, "'backend'"),
], ids=["pallas", "probe-tpu", "unsharded", "unknown-knob", "no-backend"])
def test_worker_refuses_what_it_cannot_build(meta, named):
    """A build the port cannot serve comes back as an error frame naming
    the value (never mapped to something else); that connection closes
    and the server goes on serving."""
    n, p = 40, 32
    db, _ = _data(n, p, 1, seed=31)
    plan = ShardPlan.balanced(n, 2)
    srv, t = _serve()
    try:
        with socket.create_connection(srv.addr, timeout=10) as sock:
            t_tp.send_frame(sock, "build", {
                "host": 0, "p": p, "plan": plan.summary(), **meta,
            }, {"db": db})
            kind, got, _ = t_tp.recv_frame(sock, timeout=30)
            assert kind == "error" and named in got["message"]
            with pytest.raises(FrameError):          # then torn down
                t_tp.recv_frame(sock, timeout=10)
        with socket.create_connection(srv.addr, timeout=10) as sock:
            t_tp.send_frame(sock, "ping", {"seq": 9})
            kind, got, _ = t_tp.recv_frame(sock, timeout=10)
            assert kind == "pong" and got["seq"] == 9
    finally:
        _stop(srv, t)


def test_worker_lowers_received_floors_by_the_margin():
    """The floors a port worker prunes against are the received ones
    lowered by ``shardpool.safe_bound`` (ROADMAP C-R3); infinities
    stay."""
    from repro_torch.pipeline.shardpool import safe_bound

    for v in (0.75, 0.1, 1 / 3, 0.0):
        assert t_worker._lowered(v) == safe_bound(v) <= v
    assert t_worker._lowered(0.5) < 0.5
    assert t_worker._lowered(-np.inf) == -np.inf
    assert t_worker._lowered(np.inf) == np.inf


@pytest.mark.parametrize("cfg", [dict(), HOST], ids=["default", "host-numpy"])
def test_worker_on_the_card_without_one_fails_its_build(monkeypatch, cfg):
    """No fallback: a worker left on its default device (the card) where
    torch sees no CUDA device answers a build frame that names no
    ``devices`` with an error frame, and the port's coordinator raises a
    ClusterError naming the cause. Nothing is built on the CPU instead,
    not even for the host walk with the numpy verify."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db, _ = _data(200, 64, 1, seed=32)
    srv, t = _serve(device=None)
    try:
        with pytest.raises(ClusterError, match="no CUDA device"):
            t_make("cluster", db, 64, workers=[srv.addr], num_shards=2,
                   **cfg)
    finally:
        _stop(srv, t)


# ============================================= coordinator failure semantics
class _StubWorker:
    """Protocol-correct worker that answers the build and pings, then
    either swallows every search (``garbage=False``: the request-timeout
    case) or answers it with a well-framed result whose stats do not
    decode (``garbage=True``)."""

    def __init__(self, garbage=False):
        self._srv = socket.create_server(("127.0.0.1", 0))
        self.addr = self._srv.getsockname()[:2]
        self.garbage = garbage
        self.searches = 0
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        try:
            conn, _ = self._srv.accept()
        except OSError:
            return
        try:
            while True:
                kind, meta, arrays = t_tp.recv_frame(conn)
                if kind == "build":
                    t_tp.send_frame(conn, "ready", {
                        "host": meta.get("host", 0),
                        "n": meta["plan"]["n"],
                        "shards": meta["plan"]["num_shards"],
                    })
                elif kind == "ping":
                    t_tp.send_frame(conn, "pong", {"seq": meta.get("seq")})
                elif kind == "search":
                    self.searches += 1
                    if self.garbage:
                        t_tp.send_frame(conn, "result", {
                            "req": meta["req"],
                            "stats": {"per_query": [
                                {"_kind": "AMIHStats", "no_such_counter": 1}
                            ]},
                        }, {
                            "ids": np.zeros(0, np.int64),
                            "sims": np.zeros(0),
                            "lens": np.zeros(arrays["q"].shape[0],
                                             np.int64),
                        })
                elif kind == "close":
                    return
        except (FrameError, OSError):
            pass
        finally:
            conn.close()

    def close(self):
        self._srv.close()
        self._t.join(timeout=5)


def test_heartbeat_clock_restarts_after_slow_build():
    """A build can take minutes: the coordinator restarts each worker's
    staleness clock at init, or the first heartbeat check would mark
    every worker dead before a ping went out."""
    a, b = socket.socketpair()
    stop = threading.Event()

    def ponger():
        try:
            while not stop.is_set():
                kind, meta, _ = t_tp.recv_frame(b)
                if kind == "ping":
                    t_tp.send_frame(b, "pong", {"seq": meta.get("seq", 0)})
        except (FrameError, OSError):
            pass

    t = threading.Thread(target=ponger, daemon=True)
    t.start()
    h = _WorkerHandle(0, ("127.0.0.1", 0), a)
    h.last_seen -= 60.0                # as if the build took a minute
    coord = ClusterCoordinator([h], ShardPlan.balanced(10, 1),
                               heartbeat=0.1)
    try:
        time.sleep(1.0)                # ~10 beats
        assert h.alive
    finally:
        stop.set()
        coord.close()
        b.close()
        t.join(timeout=5)
    assert not t.is_alive()


def test_corrupt_result_fails_request_fast_not_timeout():
    db, qs = _data(200, 64, 2, seed=24)
    stub = _StubWorker(garbage=True)
    try:
        eng = t_make("cluster", db, 64, workers=[stub.addr],
                     request_timeout=60.0, heartbeat=0.4)
        try:
            t0 = time.perf_counter()
            with pytest.raises(WorkerDiedError):
                eng.knn_batch(qs, 3)
            assert time.perf_counter() - t0 < 20.0
        finally:
            eng.close()
    finally:
        stub.close()


def test_request_timeout_degrades_silent_worker():
    db, qs = _data(200, 64, 2, seed=22)
    stub = _StubWorker()
    try:
        eng = t_make("cluster", db, 64, workers=[stub.addr],
                     request_timeout=1.5, heartbeat=0.4)
        try:
            t0 = time.perf_counter()
            with pytest.raises(RequestTimeoutError, match="timed out"):
                eng.knn_batch(qs, 3)
            assert time.perf_counter() - t0 < 30.0
            assert stub.searches == 1
            # the timed-out handle's socket is closed: the stub sees EOF
            stub._t.join(timeout=10.0)
            assert not stub._t.is_alive()
            with pytest.raises(ClusterDegradedError):
                eng.knn_batch(qs, 3)
        finally:
            eng.close()
    finally:
        stub.close()


def test_killed_worker_fails_tickets_and_degrades_cluster():
    """A port worker SIGKILLed mid-stream under the port's retrieval
    service: the in-flight step's tickets fail with a ClusterError
    promptly, unanswered queries are re-queued, and the degraded cluster
    fails fast afterwards."""
    from repro_torch.serve.retrieval import RetrievalConfig, RetrievalService

    p, n, B, k = 64, 1200, 12, 5
    db, qs = _data(n, p, B, seed=50)
    fl = _fleet(LocalCluster, 2, device="cpu")
    eng = None
    try:
        eng = t_make("cluster", db, p, workers=fl.addresses, num_shards=2,
                     request_timeout=60.0)
        svc = RetrievalService(cfg=None, params=None,
                               rcfg=RetrievalConfig(search_batch_size=4,
                                                    device="cpu"))
        svc.engine = eng
        gate = threading.Event()
        calls = [0]

        def encode(toks):
            if calls[0] > 0:
                assert gate.wait(timeout=30.0)
            calls[0] += 1
            return np.asarray(toks)

        svc.encode_query = encode
        tickets = [svc.submit(qs[i]) for i in range(B)]
        futures = [t.future for t in tickets]
        stream = svc.run_queued(k, stream=True)
        first = next(stream)
        assert len(first.results) == 4
        fl.kill_worker(1)
        gate.set()
        t0 = time.perf_counter()
        with pytest.raises(ClusterError):
            for _ in stream:
                pass
        assert time.perf_counter() - t0 < 30.0
        for f in futures[:4]:
            ids, _ = f.result(timeout=1)
            assert ids.shape == (k,)
        failed = [f for f in futures[4:]
                  if isinstance(f.exception(timeout=10), ClusterError)]
        assert len(failed) == B - 4
        assert svc.queue_depth() == B - 4
        with pytest.raises(ClusterDegradedError):
            eng.knn_batch(qs[:2], k)
    finally:
        if eng is not None:
            eng.close()
        _close_fleet(fl)


# ===================================================== end to end: fleets
N, P, S = 997, 64, 5   # the reference tests' corpus: prime n, 5 shards


@pytest.fixture(scope="module")
def corpus():
    return _data(N, P, 64, seed=0)[0]


def _queries(B, seed):
    bits = r_syn.synthetic_binary_codes(N, P, seed=0)
    return pack_bits(r_syn.synthetic_queries(bits, B, seed=seed))


@pytest.mark.parametrize("B", [1, 8])
def test_four_clusters_bit_identical(fleet, r_fleet, corpus, B):
    """A port or reference coordinator over port or reference workers (5
    shards over 2 hosts, the host walk with the numpy verify): all four
    return the same ids and float64 sims, and the sims are the float64
    scan's bit for bit."""
    qs = _queries(B, seed=B)
    got = {}
    for coord, make in (("port", t_make), ("reference", r_make)):
        for side, fl in (("port", fleet), ("reference", r_fleet)):
            got[coord, side] = _run(make, corpus, P, qs, 10,
                                    workers=fl.addresses, num_shards=S,
                                    **HOST)
    ids, sims, st = got["port", "port"]
    for g_ids, g_sims, g_st in got.values():
        _eq(g_ids, ids)
        _eq(g_sims, sims)
        assert [h["rows"] for h in g_st.per_host] == \
            [h["rows"] for h in st.per_host]
    _check_exact(ids, sims, qs, corpus, 10)


@pytest.mark.parametrize("B", [1, 8, 64])
def test_port_cluster_equals_port_sharded_amih(fleet, corpus, B):
    """The port's cluster on its default path (the device walk, run on the
    workers' CPU) against the port's in-process sharded_amih over the
    same plan: the same ids and sims, and per-host stats that sum to the
    rows and the shards."""
    qs = _queries(B, seed=200 + B)
    ids, sims, st = _run(t_make, corpus, P, qs, 10,
                         workers=fleet.addresses, num_shards=S)
    s_ids, s_sims, s_st = t_make("sharded_amih", corpus, P, num_shards=S,
                                 **CPU).knn_batch(qs, 10)
    _eq(ids, s_ids)
    _eq(sims, s_sims)
    _check_exact(ids, sims, qs, corpus, 10)
    assert len(st.per_host) == 2
    assert sum(h["rows"] for h in st.per_host) == N
    assert sum(h["shards"] for h in st.per_host) == S
    assert sorted(r["rows"] for r in st.per_shard) == \
        sorted(r["rows"] for r in s_st.per_shard)
    assert {r["cluster_host"] for r in st.per_shard} == {0, 1}
    assert {r["device"] for r in st.per_shard} == {"cpu"}
    assert all(h["rpc_ms"] >= 0 for h in st.per_host)
    assert st.queries == B and len(st.per_query) == B


def test_traced_cluster_ingests_worker_spans_by_host(fleet, corpus):
    """A traced batch: the coordinator records its rpc, search and merge
    spans and ingests each worker's spans under the worker's host tag,
    one K2 launch span per worker lane on the workers' device; tracing
    changes no result."""
    qs = _queries(8, seed=300)
    want = _run(t_make, corpus, P, qs, 10, workers=fleet.addresses,
                num_shards=S)
    tracer = t_trace.Tracer(enabled=True, host="coordinator")
    got = _run(t_make, corpus, P, qs, 10, workers=fleet.addresses,
               num_shards=S, tracer=tracer)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    spans = tracer.snapshot()
    by_host = {}
    for sp in spans:
        by_host.setdefault(sp["host"], set()).add(sp["name"])
    assert set(by_host) == {"coordinator", "host0", "host1"}
    assert {"cluster.rpc", "cluster.search", "cluster.merge"} <= \
        by_host["coordinator"]
    k2 = [sp["host"] for sp in spans
          if sp["name"] == "launch.device_probe.dispatch"]
    assert sorted(k2) == ["host0", "host1"]
    assert all((sp.get("args") or {}).get("device") == "cpu"
               for sp in spans if sp["name"].startswith("launch."))
    assert len({sp.get("trace") for sp in spans}) == 1


def test_cluster_k_exceeds_per_host_rows(fleet):
    """K above any host's slice: hosts return short planes (and publish
    no bound), the union still covers k; k > n clamps to n."""
    db, qs = _data(50, 64, 4, seed=2)
    eng = t_make("cluster", db, 64, workers=fleet.addresses, num_shards=2)
    try:
        ids, sims, _ = eng.knn_batch(qs, 40)
        _check_exact(ids, sims, qs, db, 40)
        ids, sims, _ = eng.knn_batch(qs, 99)
        _check_exact(ids, sims, qs, db, 50)
    finally:
        eng.close()


def test_cluster_bound_broadcast_reaches_other_hosts(fleet, corpus):
    """Raised bounds travel (bound_frames move) on the host walk, and
    priming never changes a result (prime_bound on and off agree)."""
    bits = r_syn.synthetic_binary_codes(N, P, seed=0)
    qs = pack_bits(r_syn.synthetic_queries(bits, 8, seed=40))
    cfg = dict(HOST, workers=fleet.addresses, num_shards=4)
    ids, sims, st = _run(t_make, corpus, P, qs, 10, **cfg)
    assert sum(h["bound_frames"] for h in st.per_host) > 0
    ids_b, sims_b, _ = _run(t_make, corpus, P, qs, 10, prime_bound=False,
                            **cfg)
    _eq(ids, ids_b)
    _eq(sims, sims_b)


@pytest.mark.parametrize("probe", ["device", "host"])
def test_cluster_exact_when_floor_equals_kth_with_tie_group(fleet, probe):
    """The reference's tie-group draw (tests/test_cluster.py): the primed
    floor equals the true k-th and two rows sit exactly at it. The port's
    workers prune against that floor lowered by ``safe_bound``, and the
    merge keeps the sample rows: the scan's sims, the in-process engine's
    ids."""
    p, n, k, seed = 128, 186, 6, 1994142471
    bits = r_syn.synthetic_binary_codes(n, p, seed=seed)
    db = pack_bits(bits)
    qs = pack_bits(r_syn.synthetic_queries(bits, 8, seed=seed + 1))
    ids, sims, _ = _run(t_make, db, p, qs, k, workers=fleet.addresses,
                        num_shards=3, probe_backend=probe)
    _check_exact(ids, sims, qs, db, k)
    s_ids, s_sims, _ = t_make("sharded_amih", db, p, num_shards=3,
                              probe_backend=probe, **CPU).knn_batch(qs, k)
    _eq(ids, s_ids)
    _eq(sims, s_sims)
    scan = np.sort(sims_against_db(qs[6], db))[::-1]
    assert (scan == scan[k - 1]).sum() > 1        # query 6: the witness


def test_cluster_refuses_pallas_and_the_fleet_serves_on(fleet, corpus):
    """``verify_backend="pallas"`` names a backend the port does not have:
    the build fails with a ClusterError naming it, and the same workers
    then build and serve a valid engine."""
    with pytest.raises(ClusterError, match="pallas"):
        t_make("cluster", corpus, P, workers=fleet.addresses, num_shards=S,
               probe_backend="host", verify_backend="pallas")
    qs = corpus[:3]
    ids, sims, _ = _run(t_make, corpus, P, qs, 4, workers=fleet.addresses,
                        num_shards=S)
    _check_exact(ids, sims, qs, corpus, 4)


def test_cluster_sharded_scan_workers_equal_the_sharded_scan(fleet, corpus):
    qs = corpus[5:13]
    ids, sims, st = _run(t_make, corpus, P, qs, 7, workers=fleet.addresses,
                         num_shards=S, inner_backend="sharded_scan")
    want = t_make("sharded_scan", corpus, P, num_shards=S,
                  **CPU).knn_batch(qs, 7)
    _eq(ids, want[0])
    _eq(sims, want[1])
    assert st.per_host[0]["per_shard"][0]["device"] == "cpu"


def test_launcher_checks_against_the_scan(fleet, capsys):
    """``python -m repro_torch.cluster.launch --role coordinator`` over
    the running fleet (workers on the CPU), its answers checked against
    the linear scan."""
    addrs = ",".join(f"{h}:{p}" for h, p in fleet.addresses)
    rc = t_launch.main(["--role", "coordinator", "--workers", addrs,
                        "--synthetic", "600", "--p", "64", "--queries",
                        "4", "--k", "5", "--num-shards", "3", "--check"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "exact vs linear_scan_knn" in out and "answered 4 queries" in out
    with pytest.raises(SystemExit):
        t_launch._parse_workers("nohost")


def test_cluster_engine_spawns_and_owns_local_fleet():
    """The no-workers path: build spawns its own fleet and close tears it
    down; a build the workers refuse leaves no child behind either."""
    db, qs = _data(300, 64, 2, seed=60)
    before = set(multiprocessing.active_children())
    with _one_thread_children():
        with pytest.raises(ClusterError, match="pallas"):
            t_make("cluster", db, 64, hosts=2, num_shards=2,
                   probe_backend="host", verify_backend="pallas",
                   device="cpu")
        assert set(multiprocessing.active_children()) <= before
        eng = t_make("cluster", db, 64, hosts=2, num_shards=2,
                     device="cpu")
    procs = list(eng._fleet.procs)
    assert eng._fleet.procs and all(pr.is_alive() for pr in procs)
    try:
        ids, sims, _ = eng.knn_batch(qs, 3)
        _check_exact(ids, sims, qs, db, 3)
        assert all(pr.is_alive() for pr in procs)
    finally:
        eng.close()
    assert not any(pr.is_alive() for pr in procs)


def test_cluster_smoke_runs(capsys):
    before = set(multiprocessing.active_children())
    with _one_thread_children():
        assert t_smoke.run(n=600, B=4, device="cpu") == 0
    assert "PASS" in capsys.readouterr().out
    assert set(multiprocessing.active_children()) <= before
