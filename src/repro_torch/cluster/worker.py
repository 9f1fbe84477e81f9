"""Cluster worker: one host's slice of the DB behind a TCP frame loop (a
port of the reference's ``cluster/worker.py`` that runs the port's
engines).

A worker is a small server around the port's sharded engines: it accepts
one coordinator connection, receives a ``build`` frame (its
host-partitioned ``ShardPlan`` sub-plan summary + its local row slab),
constructs a ``sharded_amih``/``sharded_scan`` engine over the slab via
the port's ``make_engine`` — sub-plan ``starts`` are global ids, so every
result the engine emits is already DB-wide — and then answers ``search``
frames until the connection drops. The frame's ``cfg`` is forwarded
verbatim. Device placement does not cross the wire: the worker takes its
device when it starts (``serve(device=None)`` is the CUDA device,
``device="cpu"`` the plain versions) and gives ``devices=[device]`` to
an engine whose ``cfg`` names none. A build that fails — a ``cfg`` the
port cannot build (say the reference's ``verify_backend="pallas"``), no
CUDA device, a kernel that does not build or launch — comes back as an
``error`` frame naming the cause, and the connection closes; nothing is
retried on the CPU or mapped to something else.

Concurrency model (two threads per connection while a search runs):

  - the READER loop keeps consuming frames during a search: ``ping``
    gets an immediate ``pong`` (liveness is never blocked behind
    probing), and ``bound`` frames — the cluster-wide k-th-cosine floor
    raised by OTHER hosts — are written monotonically into the live
    ``stop_below`` array the running search re-reads per tuple step, so
    a remote raise prunes local probing mid-flight.
  - the SEARCH thread runs ``engine.knn_batch_bounded`` and publishes
    bounds back out through its ``on_done`` hook: the moment a query
    fills k results locally, its local k-th (the k-th best exact sim of
    k real rows — a valid global lower bound) goes to the coordinator
    as a ``bound`` frame. Publishing is gated on the REQUESTED k, not
    the local ``min(k, n_local)``: a host holding fewer than k rows has
    no valid global k-th to offer and stays silent.

Every floor this worker prunes against — the request's primed floor and
each received bound — is first lowered by ``shardpool.safe_bound``
(ROADMAP C-R3): a walk stops at the first tuple whose float64 sim is
below its bound, and a tuple of equal exact cosine may round one ulp
below the value that set the bound. That costs probing, never a
different result. The bounds it publishes are the exact local k-th.

Failure semantics: a coordinator disconnect (EOF, reset, bad frame)
raises the active search's floor to +inf — probing collapses within a
few tuple steps and the result is discarded — then the worker loops
back to ``accept`` for the next coordinator. A search that raises
ships an ``error`` frame instead of a result, so the coordinator fails
that request's tickets instead of timing out.
"""

from __future__ import annotations

import socket
import threading
from dataclasses import asdict
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.amih import AMIHStats
from ..core.engine import EngineStats, make_engine
from ..core.single_table import SearchStats
from ..kernels.ops import resolve_device
from ..obs import trace as _obs
from ..pipeline.shardpool import safe_bound
from ..shard.plan import ShardPlan
from .transport import FrameError, pack_ragged, recv_frame, send_frame

__all__ = ["WorkerServer", "serve", "stats_to_wire", "stats_from_wire"]

#: engines a worker will build; anything else in a ``build`` frame is
#: refused (the cluster tier serves row-sharded backends only).
WORKER_BACKENDS = ("sharded_amih", "sharded_scan")


# ------------------------------------------------------- stats over JSON
def stats_to_wire(st: EngineStats) -> Dict[str, Any]:
    """EngineStats -> JSON-serializable dict. Per-query counter objects
    travel as plain dicts tagged with their dataclass; ``per_shard`` and
    ``cache_info`` are JSON already."""
    return {
        "backend": st.backend,
        "queries": st.queries,
        "shards": st.shards,
        "per_shard": st.per_shard,
        "cache_info": st.cache_info,
        "per_query": [
            None if s is None else {
                "_kind": type(s).__name__, **asdict(s)
            }
            for s in st.per_query
        ],
    }


def stats_from_wire(d: Dict[str, Any]) -> EngineStats:
    """Inverse of ``stats_to_wire`` (per-query rows come back as real
    AMIHStats/SearchStats objects, so ``aggregate()`` works on the
    coordinator exactly as it does host-side)."""
    per_query: List[Optional[object]] = []
    for row in d.get("per_query", []):
        if row is None:
            per_query.append(None)
            continue
        row = dict(row)
        kind = row.pop("_kind", "AMIHStats")
        cls = AMIHStats if kind == "AMIHStats" else SearchStats
        per_query.append(cls(**row))
    return EngineStats(
        backend=d.get("backend", ""),
        queries=int(d.get("queries", 0)),
        per_query=per_query,
        shards=int(d.get("shards", 0)),
        per_shard=list(d.get("per_shard", [])),
        cache_info=dict(d.get("cache_info", {})),
    )


def _lowered(v: float) -> float:
    """A received bound lowered by ``safe_bound`` (infinities kept)."""
    v = float(v)
    return safe_bound(v) if np.isfinite(v) else v


class WorkerServer:
    """One worker host's frame loop; ``serve_forever`` blocks."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 device=None):
        self._srv = socket.create_server((host, port))
        self.addr = self._srv.getsockname()[:2]
        self.device = device
        self._shutdown = False

    def close(self) -> None:
        self._shutdown = True
        try:
            # shutdown wakes an accept() blocked in another thread, which
            # close() alone does not
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass

    def serve_forever(self) -> None:
        """Accept coordinators one at a time until ``close`` (a worker
        serves exactly one coordinator; a replacement coordinator simply
        reconnects after the old one drops)."""
        while not self._shutdown:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                break   # listener closed
            try:
                self._serve_conn(conn)
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def _build(self, meta, arrays):
        """The engine a ``build`` frame asks for (raises on a frame the
        port cannot serve). Placement is the worker's own: a ``cfg``
        without ``devices`` gets ``[self.device]``, resolved here, so a
        worker that should run on the card and finds none raises "no
        CUDA device" instead of building on the CPU."""
        backend = meta["backend"]
        if backend not in WORKER_BACKENDS:
            raise ValueError(f"worker refuses backend {backend!r}")
        plan = ShardPlan.from_summary(meta["plan"])
        cfg = dict(meta.get("cfg", {}))
        if cfg.get("devices") is None:
            cfg["devices"] = [str(resolve_device(self.device))]
        # detach the slab from the frame buffer before the engine keeps
        # a reference to it
        db = np.array(arrays["db"], copy=True)
        return make_engine(backend, db, int(meta["p"]), plan=plan, **cfg)

    # ------------------------------------------------------- one session
    def _serve_conn(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_lock = threading.Lock()
        dead = threading.Event()
        engine = None
        host_id = -1
        k_req = 0
        active: Dict[int, np.ndarray] = {}   # req id -> live floor array
        searcher: Optional[threading.Thread] = None
        try:
            while not self._shutdown:
                kind, meta, arrays = recv_frame(conn)
                if kind == "build":
                    try:
                        engine = self._build(meta, arrays)
                    except Exception as e:   # noqa: BLE001
                        # the coordinator reads this instead of "ready"
                        # and fails the build with the message; then this
                        # connection, the failure unit, closes
                        send_frame(conn, "error", {
                            "host": meta.get("host", -1),
                            "message": f"{type(e).__name__}: {e}",
                        }, lock=send_lock)
                        break
                    host_id = int(meta.get("host", -1))
                    send_frame(conn, "ready", {
                        "host": host_id, "n": engine.n,
                        "shards": engine.plan.num_shards,
                    }, lock=send_lock)
                elif kind == "search":
                    if engine is None:
                        raise FrameError("search before build")
                    if searcher is not None and searcher.is_alive():
                        # the previous search's result frame lands a hair
                        # before its thread exits, and a serialized
                        # coordinator may fire the next request inside
                        # that window — give the thread a beat to finish
                        # before calling the protocol broken
                        searcher.join(timeout=2.0)
                    if searcher is not None and searcher.is_alive():
                        send_frame(conn, "error", {
                            "req": meta["req"],
                            "message": "worker busy: search in flight",
                        }, lock=send_lock)
                        continue
                    req = int(meta["req"])
                    k_req = int(meta["k"])
                    floor = np.array(
                        [_lowered(v) for v in arrays["floor"].tolist()],
                        dtype=np.float64,
                    )
                    active.clear()
                    active[req] = floor
                    q = np.array(arrays["q"], copy=True)
                    searcher = threading.Thread(
                        target=self._run_search,
                        args=(conn, send_lock, engine, req, q, k_req,
                              floor, dead, meta.get("trace")),
                        daemon=True,
                    )
                    searcher.start()
                elif kind == "bound":
                    floor = active.get(int(meta.get("req", -1)))
                    if floor is None:
                        continue   # stale: a late bound only costs time
                    qi, val = arrays["qi"], arrays["val"]
                    for j in range(qi.shape[0]):
                        i, v = int(qi[j]), _lowered(val[j])
                        if 0 <= i < floor.shape[0] and v > floor[i]:
                            floor[i] = v
                elif kind == "ping":
                    # ts is this worker's perf_counter in microseconds —
                    # the coordinator pairs it with the ping's send/recv
                    # times to estimate the cross-host clock offset
                    send_frame(conn, "pong", {
                        "seq": meta.get("seq", 0), "ts": _obs.now_us(),
                    }, lock=send_lock)
                elif kind == "close":
                    break
                else:
                    raise FrameError(f"unknown frame kind {kind!r}")
        except (FrameError, OSError):
            pass   # coordinator gone: fall through to cleanup
        except Exception:   # noqa: BLE001
            # well-framed but malformed content (a missing meta key, …)
            # tears down THIS connection — the documented failure unit —
            # and the server re-accepts; it must never kill the worker
            pass
        finally:
            dead.set()
            # collapse any in-flight search: +inf floor prunes every
            # remaining tuple step, so the thread exits promptly
            for floor in active.values():
                floor[:] = np.inf
            if searcher is not None:
                searcher.join(timeout=30.0)
            close = getattr(engine, "close", None)
            if callable(close):
                close()

    @staticmethod
    def _run_search(conn, send_lock, engine, req, q, k_req, floor, dead,
                    trace_meta=None):
        B = q.shape[0]
        sent = np.full(B, -np.inf)
        # the coordinator's trace id rides the search frame's optional
        # "trace" meta; install a per-request tracer process-wide so the
        # engine, probe and kernel span sites below this thread all
        # record into it (one search runs at a time per worker), then
        # ship the spans back inside the result frame
        tracer = prev_tracer = None
        if trace_meta:
            tracer = _obs.Tracer(
                enabled=True,
                host=str(trace_meta.get("host", "worker")),
                trace_id=trace_meta.get("id"),
            )
            prev_tracer = _obs.set_tracer(tracer)

        def publish(qi: int, _ids, sims) -> None:
            # only a k-th best of >= k_req REAL rows is a valid global
            # lower bound; a short local fill stays private
            if dead.is_set() or sims.size < k_req:
                return
            kth = float(sims[-1])
            if kth > sent[qi]:
                sent[qi] = kth
                try:
                    send_frame(conn, "bound", {"req": req}, {
                        "qi": np.array([qi], dtype=np.int64),
                        "val": np.array([kth], dtype=np.float64),
                    }, lock=send_lock)
                except OSError:
                    dead.set()

        try:
            if hasattr(engine, "knn_batch_bounded"):
                results, st = engine.knn_batch_bounded(
                    q, k_req, floor, on_done=publish
                )
            else:   # exhaustive backends have no bounded path: full k
                ids, sims, st = engine.knn_batch(q, k_req)
                results = [(ids[i], sims[i]) for i in range(B)]
            ids_flat, lens = pack_ragged(
                [r[0] for r in results], dtype=np.int64
            )
            sims_flat, _ = pack_ragged(
                [r[1] for r in results], dtype=np.float64
            )
            meta_out = {"req": req, "stats": stats_to_wire(st)}
            if tracer is not None:
                meta_out["spans"] = tracer.drain()
            if not dead.is_set():
                send_frame(conn, "result", meta_out,
                           {"ids": ids_flat, "sims": sims_flat,
                            "lens": lens},
                           lock=send_lock)
        except Exception as e:                # noqa: BLE001
            if not dead.is_set():
                try:
                    send_frame(conn, "error", {
                        "req": req,
                        "message": f"{type(e).__name__}: {e}",
                    }, lock=send_lock)
                except OSError:
                    pass
        finally:
            if tracer is not None:
                _obs.set_tracer(prev_tracer)


def serve(host: str = "127.0.0.1", port: int = 0, announce=None,
          device=None) -> None:
    """Entry point for worker processes: bind (port 0 = ephemeral),
    report the bound ``(host, port)`` through ``announce`` (a
    multiprocessing pipe end) when given — the localhost fleet reads
    it — and serve until killed. ``device`` places every engine whose
    build frame names no ``devices`` (None: the CUDA device)."""
    srv = WorkerServer(host, port, device=device)
    if announce is not None:
        announce.send(srv.addr)
        announce.close()
    srv.serve_forever()
