"""Cluster coordinator: fan out, bound broadcast, exact O(K) merge (a
port of the reference's ``cluster/coordinator.py``).

The coordinator owns one TCP connection per worker host. A ``knn_batch``
call becomes one ``search`` frame to every live worker (packed queries +
the primed per-query floor); while workers probe, their ``bound`` frames
— each a query's local k-th cosine, a valid lower bound on the global
k-th — fold monotonically into the request's global floor and are
REBROADCAST to the other workers, which apply them to the live
``stop_below`` array mid-probe. This is ``SharedBound`` generalized from
one process's shared memory to sockets: bounds only ever rise, so a
late, lost, or reordered update yields a weaker-but-valid bound — it
costs probing time, never correctness (docs/cluster.md spells out the
argument).

Each worker returns its host-local exact top-<=k as O(K) ragged planes;
the union across hosts always contains every row of the true global
top-K (a host only withholds rows strictly below a valid global bound),
so the same lexsort used inside the single-host engines —
``np.lexsort((gids, -sims))[:k]`` — produces results bit-identical to
single-host ``sharded_amih`` and to per-query ``linear_scan_knn``.

Failure semantics: heartbeats and per-request timeouts wrap every wait.
A worker that dies mid-request (EOF, reset, stale heartbeat, timeout)
fails THAT request with ``WorkerDiedError`` — its rows are gone, so
pretending with a partial merge would break exactness — and permanently
degrades the cluster: later calls fail fast with
``ClusterDegradedError`` instead of hanging a serving drain (the
streaming tier surfaces both through its ticket futures).

``ClusterEngine`` (backend name ``"cluster"``) wraps all of it behind
the standard ``SearchEngine`` API: ``build`` host-partitions one
``ShardPlan``, ships each worker its row slab + sub-plan summary, and
— when no worker addresses are given — spawns a localhost worker fleet
(repro_torch.cluster.local) so the full wire protocol runs on one
machine.
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import fields as dc_fields
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.amih import AMIHStats
from ..core.engine import EngineStats, SearchEngine, register_engine
from ..core.linear_scan import sims_for_ids
from ..core.packing import WORD_DTYPE
from ..core.single_table import SearchStats
from ..obs import trace as _obs
from ..pipeline.shardpool import prime_ids
from ..shard.plan import ShardPlan
from .transport import FrameError, recv_frame, send_frame, unpack_ragged
from .worker import WORKER_BACKENDS, stats_from_wire

__all__ = [
    "ClusterCoordinator",
    "ClusterDegradedError",
    "ClusterEngine",
    "ClusterError",
    "RemoteSearchError",
    "RequestTimeoutError",
    "WorkerDiedError",
]


class ClusterError(RuntimeError):
    """Base for every cluster-tier failure."""


class WorkerDiedError(ClusterError):
    """A worker connection dropped (or went silent) mid-request."""


class ClusterDegradedError(ClusterError):
    """The cluster has lost a worker's rows: exact answers are
    impossible, so every call fails fast until rebuilt."""


class RequestTimeoutError(ClusterError):
    """A request exceeded its per-request deadline."""


class RemoteSearchError(ClusterError):
    """A worker's search raised; its message travelled back."""


class _WorkerHandle:
    """Coordinator-side state for one worker connection."""

    def __init__(self, host: int, addr: Tuple[str, int],
                 sock: socket.socket):
        self.host = host
        self.addr = addr
        self.sock = sock
        self.send_lock = threading.Lock()
        self.alive = True
        self.info: Dict[str, Any] = {}
        self.last_seen = time.monotonic()
        self.bound_frames = 0        # bound updates received from it
        self.reader: Optional[threading.Thread] = None
        # cross-host clock calibration: the last ping's (seq, send-time
        # in perf_counter us) and the offset estimated from its pong —
        # worker_perf_counter_us - coordinator_perf_counter_us, so
        # shifting worker span timestamps by -offset lands them on the
        # coordinator timeline (~0 for localhost fleets: one kernel
        # clock)
        self.ping_sent: Optional[Tuple[int, float]] = None
        self.clock_offset_us = 0.0

    def send(self, kind, meta=None, arrays=None) -> None:
        send_frame(self.sock, kind, meta, arrays, lock=self.send_lock)


class _Request:
    """One in-flight fan-out: per-host result slots + the live floor."""

    def __init__(self, req: int, B: int, hosts: Sequence[int],
                 floor: np.ndarray):
        self.req = req
        self.B = B
        self.expected = set(hosts)
        self.floor = floor
        self.t0 = time.monotonic()
        self.t0_us = _obs.now_us()   # same instant on the span clock
        # host -> (ids planes, sims planes, EngineStats, rpc seconds)
        self.results: Dict[int, Tuple[list, list, EngineStats, float]] = {}
        self.error: Optional[ClusterError] = None

    def settled(self) -> bool:
        return self.error is not None or \
            self.expected <= set(self.results)


class ClusterCoordinator:
    """Request fan-out/merge over a fixed set of worker handles."""

    def __init__(
        self,
        handles: List[_WorkerHandle],
        plan: ShardPlan,
        request_timeout: float = 120.0,
        heartbeat: float = 2.0,
    ):
        self.handles = handles
        self.plan = plan
        self.request_timeout = request_timeout
        self.heartbeat = heartbeat
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._current: Optional[_Request] = None
        self._seq = 0
        self._ping_seq = 0
        self._closed = False
        for h in self.handles:
            # the handle's last_seen was stamped at socket-connect time,
            # and build (slab transfer + engine construction) can take
            # minutes — restart the staleness clock NOW, or the first
            # heartbeat check would mark every worker dead before a
            # single ping went out
            h.last_seen = time.monotonic()
            h.reader = threading.Thread(
                target=self._reader, args=(h,), daemon=True
            )
            h.reader.start()
        self._beater = threading.Thread(
            target=self._heartbeat_loop, daemon=True
        )
        self._beater.start()

    # ---------------------------------------------------------- liveness
    def _mark_dead(self, h: _WorkerHandle) -> None:
        with self._cond:
            if not h.alive:
                return
            h.alive = False
            cur = self._current
            if cur is not None and h.host in cur.expected \
                    and cur.error is None:
                cur.error = WorkerDiedError(
                    f"worker {h.host} at {h.addr[0]}:{h.addr[1]} died "
                    f"mid-request {cur.req}"
                )
            self._cond.notify_all()
        # shutdown BEFORE close: close() alone neither sends FIN nor
        # unblocks a reader parked in recv on this socket (the in-flight
        # syscall pins the kernel socket), so the worker would never see
        # EOF and our reader thread would never exit
        try:
            h.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            h.sock.close()
        except OSError:
            pass

    def _heartbeat_loop(self) -> None:
        while not self._closed:
            time.sleep(self.heartbeat)
            if self._closed:
                return
            self._ping_seq += 1
            now = time.monotonic()
            for h in self.handles:
                if not h.alive:
                    continue
                # the worker's reader answers pings even while a search
                # runs, so silence across several beats means it's gone
                if now - h.last_seen > 4 * self.heartbeat:
                    self._mark_dead(h)
                    continue
                try:
                    h.ping_sent = (self._ping_seq, _obs.now_us())
                    h.send("ping", {"seq": self._ping_seq})
                except OSError:
                    self._mark_dead(h)

    # ------------------------------------------------------ reader thread
    def _reader(self, h: _WorkerHandle) -> None:
        try:
            while True:
                kind, meta, arrays = recv_frame(h.sock)
                h.last_seen = time.monotonic()
                if kind == "result":
                    self._on_result(h, meta, arrays)
                elif kind == "bound":
                    self._on_bound(h, meta, arrays)
                elif kind == "pong":
                    # midpoint clock-offset estimate: the worker stamped
                    # its perf_counter into the pong, and (send + recv)/2
                    # approximates the coordinator time of that stamp
                    # (symmetric-RTT assumption; error is bounded by
                    # RTT/2, far below the millisecond spans we draw)
                    ts = meta.get("ts")
                    if ts is not None and h.ping_sent is not None and \
                            int(meta.get("seq", -1)) == h.ping_sent[0]:
                        t_recv = _obs.now_us()
                        h.clock_offset_us = \
                            float(ts) - (h.ping_sent[1] + t_recv) / 2.0
                elif kind == "error":
                    with self._cond:
                        cur = self._current
                        if cur is not None and \
                                int(meta.get("req", -1)) == cur.req and \
                                cur.error is None:
                            cur.error = RemoteSearchError(
                                f"worker {h.host}: "
                                f"{meta.get('message', 'unknown')}"
                            )
                            self._cond.notify_all()
                else:
                    raise FrameError(f"unexpected frame {kind!r}")
        except Exception:   # noqa: BLE001
            # not just FrameError/OSError: a well-framed but corrupt
            # payload (bad ragged lengths, unexpected stats fields, …)
            # must also kill the handle IMMEDIATELY — otherwise the
            # in-flight request would sit out the full request_timeout
            # with a reader that is already gone
            pass
        finally:
            self._mark_dead(h)

    def _on_result(self, h, meta, arrays) -> None:
        elapsed = None
        with self._cond:
            cur = self._current
            if cur is None or int(meta["req"]) != cur.req:
                return   # stale result from an abandoned request
            elapsed = time.monotonic() - cur.t0
            ids = unpack_ragged(
                np.array(arrays["ids"], copy=True), arrays["lens"]
            )
            sims = unpack_ragged(
                np.array(arrays["sims"], copy=True), arrays["lens"]
            )
            cur.results[h.host] = (
                ids, sims, stats_from_wire(meta.get("stats", {})), elapsed
            )
            tr = _obs.current()
            if tr.enabled:
                # one rpc span per host (send -> result landed), plus the
                # worker's own spans shifted onto the coordinator clock
                tr.record("cluster.rpc", cur.t0_us,
                          cur.t0_us + elapsed * 1e6, cat="cluster",
                          host=h.host, req=cur.req)
                spans = meta.get("spans")
                if spans:
                    tr.ingest(spans, shift_us=h.clock_offset_us)
            self._cond.notify_all()

    def _on_bound(self, h, meta, arrays) -> None:
        """Fold a worker's bound rows into the request floor; rebroadcast
        entries that actually raised it to every OTHER live worker."""
        h.bound_frames += 1
        qi = np.asarray(arrays["qi"], dtype=np.int64)
        val = np.asarray(arrays["val"], dtype=np.float64)
        raised_qi: List[int] = []
        raised_val: List[float] = []
        with self._lock:
            cur = self._current
            if cur is None or int(meta.get("req", -1)) != cur.req:
                return   # late bound: only ever a lost optimization
            for j in range(qi.shape[0]):
                i, v = int(qi[j]), float(val[j])
                if 0 <= i < cur.B and v > cur.floor[i]:
                    cur.floor[i] = v
                    raised_qi.append(i)
                    raised_val.append(v)
            req = cur.req
        if not raised_qi:
            return
        payload = {
            "qi": np.asarray(raised_qi, dtype=np.int64),
            "val": np.asarray(raised_val, dtype=np.float64),
        }
        for peer in self.handles:
            if peer is h or not peer.alive:
                continue
            try:
                peer.send("bound", {"req": req}, payload)
            except OSError:
                self._mark_dead(peer)

    # ------------------------------------------------------------ request
    def alive_hosts(self) -> List[int]:
        return [h.host for h in self.handles if h.alive]

    def search(
        self, q: np.ndarray, k: int, floor: np.ndarray
    ) -> Tuple[Dict[int, Tuple[list, list, EngineStats, float]],
               np.ndarray]:
        """Fan one batch out to every worker and collect all per-host
        planes (raises on death/timeout/remote error — never a partial
        merge). Returns ({host: (ids, sims, stats, rpc_s)}, floor)."""
        B = q.shape[0]
        with self._cond:
            if self._closed:
                raise ClusterError("coordinator is closed")
            dead = [h for h in self.handles if not h.alive]
            if dead:
                raise ClusterDegradedError(
                    f"cluster degraded: worker(s) "
                    f"{[h.host for h in dead]} are gone; exact answers "
                    f"need every host's rows"
                )
            self._seq += 1
            cur = _Request(self._seq, B, [h.host for h in self.handles],
                           floor)
            self._current = cur
        tr = _obs.current()
        try:
            for h in self.handles:
                try:
                    smeta = {"req": cur.req, "k": k}
                    if tr.enabled:
                        # propagate the trace id so worker spans come
                        # back under the same distributed trace; the
                        # host tag keeps per-worker timelines apart
                        smeta["trace"] = {
                            "id": tr.trace_id, "host": f"host{h.host}",
                        }
                    h.send("search", smeta, {"q": q, "floor": floor})
                except OSError:
                    self._mark_dead(h)
            deadline = cur.t0 + self.request_timeout
            timed_out: List[_WorkerHandle] = []
            with self._cond:
                while not cur.settled():
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        missing = sorted(cur.expected - set(cur.results))
                        cur.error = RequestTimeoutError(
                            f"request {cur.req} timed out after "
                            f"{self.request_timeout:.0f}s waiting on "
                            f"worker(s) {missing}"
                        )
                        break
                    self._cond.wait(remaining)
                if isinstance(cur.error, RequestTimeoutError):
                    # a silent worker is an unusable worker: degrade
                    # rather than racing its late result next call
                    timed_out = [h for h in self.handles
                                 if h.alive and h.host not in cur.results]
            # _mark_dead takes the condition lock itself (and closing the
            # socket unblocks the reader thread), so it runs outside —
            # flipping alive in place would leave the reader parked in
            # recv_frame and the connection lingering until close()
            for h in timed_out:
                self._mark_dead(h)
            with self._cond:
                if cur.error is not None:
                    raise cur.error
                if tr.enabled:
                    tr.record("cluster.search", cur.t0_us, _obs.now_us(),
                              cat="cluster", req=cur.req, B=B, k=k,
                              hosts=len(cur.expected))
                return cur.results, cur.floor
        finally:
            with self._cond:
                self._current = None

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        for h in self.handles:
            if h.alive:
                try:
                    h.send("close")
                except OSError:
                    pass
            try:
                h.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                h.sock.close()
            except OSError:
                pass
            h.alive = False
        for h in self.handles:
            if h.reader is not None:
                h.reader.join(timeout=5.0)


# --------------------------------------------------------------- engine
def _fold_counters(dst, src) -> None:
    """Sum/max/or ``src``'s counters into ``dst`` across the fields they
    share (AMIHStats is a superset of SearchStats)."""
    for f in dc_fields(dst):
        if not hasattr(src, f.name):
            continue
        v = getattr(src, f.name)
        if isinstance(v, (bool, np.bool_)):
            setattr(dst, f.name, bool(getattr(dst, f.name)) | bool(v))
        elif f.name == "max_radius":
            setattr(dst, f.name, max(getattr(dst, f.name), int(v)))
        elif isinstance(v, (int, np.integer)):
            setattr(dst, f.name, getattr(dst, f.name) + int(v))


@register_engine
class ClusterEngine(SearchEngine):
    """Cross-host serving tier behind the standard engine API.

    ``build`` balances one ``ShardPlan`` over the DB, splits it with
    ``host_partition(hosts)``, and gives every worker its row slab plus
    its sub-plan ``summary()`` — the whole layout contract crosses the
    wire as one JSON dict. Workers run the existing ``inner_backend``
    engine (``sharded_amih`` by default; ``sharded_scan`` for the
    exhaustive tier) with ``inner_cfg`` forwarded verbatim, so every
    single-host knob (``m``, ``probe_backend``, ``verify_backend``, …)
    applies per host unchanged.

    With no ``workers`` address list, a localhost fleet is spawned
    (repro_torch.cluster.local) on ``device`` (None: the CUDA device) and
    torn down by ``close()`` — the same wire protocol, one machine. ``prime_bound`` warm-starts every request's
    floor with the exact k-th sim of a deterministic row sample before
    any worker probes (the cross-host analog of the shard pool's
    priming), and the sampled rows themselves stay in the merge pool —
    every floor a worker prunes against is justified by >= k rows that
    are present at the merge, exactly like the shard pool keeps its
    bound-generating rows. That invariant is what makes the tier immune
    to the float64 tie-group edge: exactly-tied probing tuples can
    round 1 ulp apart, so a worker's strictly-below stop may fire
    mid-tie-group and drop rows AT the floor — harmless, because the
    justifying rows supply any ties the top-k needs.
    """

    name = "cluster"

    def __init__(self, db_words, p, plan, coordinator, local_fleet,
                 prime_bound: bool):
        self.db_words = np.ascontiguousarray(db_words, dtype=WORD_DTYPE)
        self.p = p
        self.plan = plan
        self.coordinator = coordinator
        self._fleet = local_fleet
        self.prime_bound = prime_bound
        # the wire protocol carries one search per worker at a time, so
        # concurrent knn_batch callers (e.g. the streaming loop's
        # pipelined search stage) queue here instead of erroring with
        # "worker busy"
        self._serial = threading.Lock()

    @classmethod
    def build(
        cls,
        db_words: np.ndarray,
        p: int,
        hosts: int = 2,
        workers: Optional[Sequence[Tuple[str, int]]] = None,
        inner_backend: str = "sharded_amih",
        num_shards: Optional[int] = None,
        plan: Optional[ShardPlan] = None,
        prime_bound: bool = True,
        request_timeout: float = 120.0,
        heartbeat: float = 2.0,
        build_timeout: float = 300.0,
        device=None,
        **inner_cfg: Any,
    ) -> "ClusterEngine":
        if inner_backend not in WORKER_BACKENDS:
            raise ValueError(
                f"inner_backend must be one of {WORKER_BACKENDS}, "
                f"got {inner_backend!r}"
            )
        db = np.ascontiguousarray(db_words, dtype=WORD_DTYPE)
        n = db.shape[0]
        if workers is not None:
            hosts = len(workers)
        if plan is None:
            plan = ShardPlan.balanced(n, num_shards or hosts)
        elif plan.n != n:
            raise ValueError(f"plan covers n={plan.n}, DB has n={n}")
        sub_plans = plan.host_partition(hosts)
        fleet = None
        if workers is None:
            from .local import LocalCluster

            fleet = LocalCluster(hosts, device=device)
            workers = fleet.addresses
        handles: List[_WorkerHandle] = []
        try:
            for h, (addr, sub) in enumerate(zip(workers, sub_plans)):
                addr = (str(addr[0]), int(addr[1]))
                sock = socket.create_connection(addr, timeout=build_timeout)
                sock.settimeout(None)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                hd = _WorkerHandle(h, addr, sock)
                handles.append(hd)
                slab = db[sub.base : sub.base + sub.n]
                hd.send("build", {
                    "host": h, "p": p, "backend": inner_backend,
                    "plan": sub.summary(), "cfg": dict(inner_cfg),
                }, {"db": slab})
            for hd in handles:
                kind, meta, _ = recv_frame(hd.sock, timeout=build_timeout)
                if kind != "ready":
                    raise ClusterError(
                        f"worker {hd.host} sent {kind!r} instead of "
                        f"ready: {meta.get('message', '')}"
                    )
                hd.info = meta
        except (OSError, FrameError, ClusterError) as e:
            # a worker that refused its build frame closes like one that
            # vanished: no socket or spawned worker outlives the error
            for hd in handles:
                try:
                    hd.sock.close()
                except OSError:
                    pass
            if fleet is not None:
                fleet.close()
            if isinstance(e, ClusterError):
                raise
            raise ClusterError(f"cluster build failed: {e}") from e
        coord = ClusterCoordinator(
            handles, plan, request_timeout=request_timeout,
            heartbeat=heartbeat,
        )
        return cls(db, p, plan, coord, fleet, prime_bound)

    @property
    def n(self) -> int:
        return self.db_words.shape[0]

    @property
    def hosts(self) -> int:
        return len(self.coordinator.handles)

    def knn_batch(self, q_words, k):
        q = self._check_queries(q_words, self.p)
        B = q.shape[0]
        k_eff = min(k, self.n)
        if k_eff == 0:
            return (
                np.empty((B, 0), np.int64), np.empty((B, 0), np.float64),
                EngineStats(backend=self.name, queries=B,
                            per_query=[SearchStats() for _ in range(B)],
                            shards=self.plan.num_shards),
            )
        with _obs.current().span("engine.knn_batch", cat="engine",
                                 backend=self.name, B=B, k=k_eff):
            return self._knn_batch_traced(q, B, k_eff)

    def _knn_batch_traced(self, q, B, k_eff):
        floor = np.full(B, -np.inf)
        primed: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None
        if self.prime_bound:
            sample = prime_ids(self.n, k_eff)
            if sample.size >= k_eff:
                # keep the per-query top-k of the sample: workers prune
                # strictly below the floor, but exactly-tied probing
                # tuples can round 1 ulp apart, so a worker may still
                # drop rows AT the floor — the rows that justify the
                # floor must therefore sit in the merge pool themselves
                # (same invariant as the shard pool's candidate pool)
                cut = sample.size - k_eff
                primed = []
                for i in range(B):
                    sims_i = sims_for_ids(q[i], self.db_words, sample)
                    top = np.argpartition(sims_i, cut)[cut:]
                    floor[i] = sims_i[top].min()
                    primed.append((
                        sample[top].astype(np.int64, copy=False),
                        sims_i[top],
                    ))
        with self._serial:
            by_host, _ = self.coordinator.search(q, k_eff, floor)

        tr = _obs.current()
        t_merge = _obs.now_us() if tr.enabled else 0.0
        ids_out = np.empty((B, k_eff), dtype=np.int64)
        sims_out = np.empty((B, k_eff), dtype=np.float64)
        order_hosts = sorted(by_host)
        for i in range(B):
            planes = [by_host[h][0][i] for h in order_hosts]
            splanes = [by_host[h][1][i] for h in order_hosts]
            if primed is not None:
                planes.append(primed[i][0])
                splanes.append(primed[i][1])
            gids = np.concatenate(planes).astype(np.int64, copy=False)
            sims = np.concatenate(splanes)
            if primed is not None:
                # primed rows overlap host-returned rows; one id's sim
                # is bitwise-equal on every path, so keep first
                gids, first = np.unique(gids, return_index=True)
                sims = sims[first]
            if gids.size < k_eff:
                raise ClusterError(
                    f"query {i}: union of host planes holds "
                    f"{gids.size} < k={k_eff} rows — a worker violated "
                    f"the bound contract"
                )
            order = np.lexsort((gids, -sims))[:k_eff]
            ids_out[i] = gids[order]
            sims_out[i] = sims[order]
        if tr.enabled:
            tr.record("cluster.merge", t_merge, _obs.now_us(),
                      cat="cluster", B=B, hosts=len(order_hosts))

        per_query: List[object] = []
        host_rows = [by_host[h][2].per_query for h in order_hosts]
        for i in range(B):
            rows = [pq[i] for pq in host_rows if i < len(pq)
                    and pq[i] is not None]
            kind = AMIHStats if any(
                isinstance(r, AMIHStats) for r in rows
            ) else SearchStats
            agg = kind()
            for r in rows:
                _fold_counters(agg, r)
            per_query.append(agg)

        per_shard: List[Dict[str, Any]] = []
        per_host: List[Dict[str, Any]] = []
        for h in order_hosts:
            _ids, _sims, st, rpc_s = by_host[h]
            hd = self.coordinator.handles[h]
            for row in st.per_shard:
                per_shard.append({**row, "cluster_host": h})
            entry: Dict[str, Any] = {
                "host": h,
                "addr": f"{hd.addr[0]}:{hd.addr[1]}",
                "rows": int(hd.info.get("n", 0)),
                "shards": st.shards,
                "rpc_ms": round(rpc_s * 1e3, 3),
                "bound_frames": hd.bound_frames,
                "per_shard": st.per_shard,
                "cache_info": st.cache_info,
            }
            for counter in ("launches", "probes", "retrieved", "verified",
                            "tuples_processed", "early_stopped",
                            "fell_back_to_scan"):
                entry[counter] = sum(
                    int(row.get(counter, 0)) for row in st.per_shard
                )
            per_host.append(entry)
        per_shard.sort(key=lambda r: r.get("shard", 0))

        stats = EngineStats(
            backend=self.name, queries=B, per_query=per_query,
            shards=self.plan.num_shards, per_shard=per_shard,
            per_host=per_host,
        )
        return ids_out, sims_out, stats

    def close(self) -> None:
        """Tear the cluster down: close every worker connection, then
        (for a spawned localhost fleet) terminate the worker processes.
        Idempotent; GC-safe."""
        self.coordinator.close()
        if self._fleet is not None:
            self._fleet.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass   # interpreter shutdown
