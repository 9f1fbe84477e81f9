"""Shard-parallel AMIH probing with a shared monotone k-th-cosine bound
(a port of the reference's ``pipeline/shardpool.py``).

The sequential ``sharded_amih`` engine probes its shards one after
another, chaining each shard's pooled k-th cosine into the next shard's
``stop_below`` bound. That serializes the embarrassingly parallel part of
multi-index hashing — every shard owns a disjoint, read-only table set —
and gives shard 0 no bound at all.

This module replaces the chain with a shared per-query bound probed by
all shards CONCURRENTLY:

  - ``SharedBound`` owns a live float64 ``bounds`` array handed directly
    to every shard's ``AMIHIndex.knn_batch_bounded`` (which re-reads it
    at every tuple step, no copy). Entries only ever increase, and every
    value written is the k-th best exact sim of SOME subset of real DB
    rows, lowered by a float64 rounding margin (``safe_bound``) — hence
    always a valid lower bound on the global k-th, which is all exactness
    needs (see the engine docstring). Monotonicity is also what makes
    lock-free reads safe: a stale read is merely a weaker, still-correct
    bound.

  - The margin repairs ROADMAP C-R3. A shard's walk visits tuples in
    exact-rational order and stops a query at the first tuple whose
    float64 sim is below its bound; two tuples of EQUAL exact cosine can
    round a few ulps apart (C-R1: p = 64, z = 30, (12, 18) and (15, 10)
    give 0.5477225575051662 and ...661). A bound equal to the larger
    rounding stopped a shard at the smaller one before it reached the
    other, dropping rows the bound itself was taken from — the
    warm-start sample's rows are not in the result pool, so the merge
    came up short of k. Lowered by the margin, a bound stops a walk only
    at a tuple of strictly smaller exact cosine, and those differ by far
    more than the margin.

  - Bounds rise *while shards probe*: the ``on_done`` hook fires inside
    the bounded search the moment a query fills its local K, publishing
    that shard's local k-th immediately — peers prune mid-flight instead
    of waiting for whole-shard completion the way the sequential chain
    waits for whole-shard results.

  - ``prime()``-style warm starting: the exact sims of a small
    deterministic row sample (``prime_ids``) are offered before any
    probing, so even the first-finishing shard — which the sequential
    chain probes with no bound at all — starts pruned.

Worker modes (``mode=``):

  - "process" (default where ``fork`` exists): one forked worker per
    shard group, the per-call bounds array in a named
    ``multiprocessing.shared_memory`` segment every worker attaches to.
    Probing is a Python loop over many small NumPy calls — too GIL-bound
    for threads to help on CPython — so real CPU parallelism needs
    processes. Fork is cheap here: the child inherits the built shard
    indexes copy-on-write and ships back only (B, k) results. Children
    run numpy only, never a torch op: forking after torch's intra-op
    thread pool has started can deadlock a child that uses it, and a
    child forked after CUDA is initialised cannot use CUDA. Racy ``max``
    writes to the shared array can lose an update, leaving a smaller —
    still valid — bound; exactness is unaffected.
  - "thread": the right choice on free-threaded (nogil) interpreters and
    where probing cost is dominated by device calls that release the GIL
    (the CUDA verify forces this mode).
  - "auto": "process" when the platform has ``fork``, else "thread".

``PersistentShardPool`` is the serving-host form: workers fork ONCE per
engine lifetime (``ShardedAMIHEngine`` owns one, released by
``engine.close()``) and every ``probe()`` call ships its task over the
worker's task pipe instead of re-forking — the per-call fork cost that
erased the pool's wins on serving hosts is paid once at warm-up. The
one-shot ``probe_shards_parallel`` is a build-probe-close wrapper over
it, kept for callers without an engine lifetime to amortize over.
"""

from __future__ import annotations

import multiprocessing
import sys
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs import trace as _obs

__all__ = [
    "BOUND_MARGIN",
    "PersistentShardPool",
    "SharedBound",
    "prime_ids",
    "probe_shards_parallel",
    "resolve_probe_mode",
    "safe_bound",
]

_EMPTY64 = np.empty(0, dtype=np.int64)

# Relative float64 margin by which every bound the pool (and the sharded
# engine's warm start) writes is lowered; see the module docstring (C-R3).
# Two roundings of one exact cosine differ by a few ulps; two distinct
# exact cosines of codes with p bits differ by at least ~1/p^3 relative.
BOUND_MARGIN = 16 * float(np.finfo(np.float64).eps)


def safe_bound(kth: float) -> float:
    """``kth`` lowered by ``BOUND_MARGIN`` (relative): the bound a walk
    may stop below without losing a tuple of equal exact cosine."""
    kth = float(kth)
    return kth - BOUND_MARGIN * abs(kth)


def resolve_probe_mode(mode: str = "auto") -> str:
    if mode not in ("auto", "process", "thread"):
        raise ValueError(f"unknown probe mode {mode!r}")
    if mode != "auto":
        return mode
    can_fork = (
        sys.platform != "win32"
        and "fork" in multiprocessing.get_all_start_methods()
    )
    return "process" if can_fork else "thread"


class SharedBound:
    """Per-query monotone lower bounds on the global k-th cosine.

    ``bounds`` is a live float64 (B,) array: consumers hand it directly
    to ``AMIHIndex.knn_batch_bounded`` while producers raise it through
    ``offer`` (pooled candidates, deduplicated by global id — the same
    code offered twice must not fake a tighter k-th than the DB
    supports) or ``raise_to`` (a known-valid k-th, e.g. a shard's local
    k-th). ``bounds=<array>`` aliases an existing live array instead of
    allocating one; cross-process sharing is the pool's job —
    ``PersistentShardPool._probe_procs`` re-points ``bounds`` at a
    per-call shared-memory segment for the duration of a call.
    """

    def __init__(self, B: int, k: int,
                 bounds: Optional[np.ndarray] = None):
        self.k = k
        if bounds is not None:
            self.bounds = bounds
        else:
            self.bounds = np.full(B, -np.inf, dtype=np.float64)
        # per query: pooled (ids, sims) of the current top-<=k candidates
        self._ids: List[np.ndarray] = [_EMPTY64 for _ in range(B)]
        self._sims: List[np.ndarray] = [
            np.empty(0, dtype=np.float64) for _ in range(B)
        ]
        self._lock = threading.Lock()

    def raise_to(self, qi: int, kth: float) -> None:
        """Monotone write of a known-valid k-th sim, lowered by the
        rounding margin (lock-free)."""
        kth = safe_bound(kth)
        if kth > self.bounds[qi]:
            self.bounds[qi] = kth

    def offer(self, qi: int, ids: np.ndarray, sims: np.ndarray) -> None:
        """Fold candidate (global id, exact sim) pairs into query ``qi``'s
        pool and raise its bound to the pooled k-th best (once the pool
        holds k distinct ids)."""
        if ids.size == 0:
            return
        with self._lock:
            all_ids = np.concatenate([self._ids[qi], ids])
            all_sims = np.concatenate([self._sims[qi], sims])
            uniq, first = np.unique(all_ids, return_index=True)
            usims = all_sims[first]
            if uniq.size > self.k:
                keep = np.argpartition(usims, uniq.size - self.k)[
                    uniq.size - self.k:
                ]
                uniq, usims = uniq[keep], usims[keep]
            self._ids[qi], self._sims[qi] = uniq, usims
            if uniq.size >= self.k:
                self.raise_to(qi, float(usims.min()))


def prime_ids(n: int, k: int, sample: Optional[int] = None) -> np.ndarray:
    """Deterministic row sample for bound warm-starting: ``sample`` ids
    spread evenly across [0, n) (default ``min(n, max(4k, 256))``)."""
    if sample is None:
        sample = min(n, max(4 * k, 256))
    sample = max(1, min(n, sample))
    return np.unique(
        np.linspace(0, n - 1, num=sample, dtype=np.int64)
    )


def _local_kth_publisher(bounds: np.ndarray, k: int):
    """on_done hook: the moment a query fills its local K inside a
    shard's bounded search, its local k-th (emission order is
    non-increasing, so the last sim) becomes a live bound for peers."""

    def on_done(qi: int, ids: np.ndarray, sims: np.ndarray) -> None:
        if sims.size >= k:
            kth = safe_bound(sims[-1])
            if kth > bounds[qi]:
                bounds[qi] = kth

    return on_done


def _probe_group(group, q_words, k, pool: SharedBound, stats_factory,
                 enumeration_cap,
                 on_first_shard=None) -> Dict[int, Tuple[list, list, int]]:
    """One worker's shard group, probed sequentially under the live
    shared bound. Within the group the bound chains exactly like the
    sequential engine (each finished shard's results are pooled and
    offered before the next shard starts); across groups the bound
    flows through the shared array — per query, the moment it fills its
    local K (``on_done``). ``on_first_shard`` fires once the group's
    first (cold) shard completes — the staggered-start gate."""
    B = q_words.shape[0]
    on_done = _local_kth_publisher(pool.bounds, k)
    out: Dict[int, Tuple[list, list, int]] = {}
    for s, index in group:
        st = [stats_factory() for _ in range(B)]
        launches0 = index.verify_launches
        results = index.knn_batch_bounded(
            q_words, k, stop_below=pool.bounds, stats=st,
            enumeration_cap=enumeration_cap, on_done=on_done,
        )
        for qi, (r_ids, r_sims) in enumerate(results):
            pool.offer(qi, r_ids, r_sims)
        # launch delta measured where the verifies RAN: a forked worker's
        # index counters never reach the parent's index objects
        out[s] = (results, st, index.verify_launches - launches0)
        if on_first_shard is not None:
            on_first_shard()
            on_first_shard = None
    return out


def _await_warm_start(bounds: np.ndarray, floor: np.ndarray, gate,
                      fraction: float = 0.9,
                      timeout_s: float = 60.0) -> None:
    """Bound-aware staggered start: block until ``fraction`` of the
    queries have had their shared bound raised ABOVE ``floor`` (the
    pre-probe snapshot — priming counts for nothing here; only a peer's
    probing publishes tighter values), or the lead worker's cold shard
    has completed (``gate``), whichever is first. A worker that starts
    cold probes its first shard unbounded — the expensive regime the
    sequential chain pays exactly once, for shard 0; the stagger keeps
    it paid roughly once across the whole pool while everything after
    still overlaps."""
    import time as _time

    deadline = _time.perf_counter() + timeout_s
    while ((bounds > floor).mean() < fraction
           and not gate()
           and _time.perf_counter() < deadline):
        _time.sleep(0.002)


def _attach_shm(name: str):
    """Attach a named shared-memory segment without taking ownership: the
    parent owns the segment's lifetime (it unlinks after the call).
    ``track=False`` (3.13+) skips tracker registration outright; on older
    Pythons the attach re-registers the name with the resource tracker —
    harmless here because the pool forks its workers only after
    ``ensure_running`` (see ``_ensure_procs``), so parent and children
    share ONE tracker whose per-name set the re-register is a no-op on
    and the parent's unlink balances (a child-side unregister would
    instead strip the parent's registration, CPython gh-82300)."""
    from multiprocessing import shared_memory

    try:
        return shared_memory.SharedMemory(name=name, track=False)  # 3.13+
    except TypeError:
        return shared_memory.SharedMemory(name=name)


def _run_pool_task(group, lead, stats_factory, result_conn, shm,
                   task) -> None:
    """One probe task inside a persistent worker: alias the call's shared
    bounds segment and probe the group, STREAMING each finished shard's
    results back immediately — the parent folds them into the one global
    candidate pool and is the single writer of the pooled k-th bounds
    (per-worker pools would compose only through a max of partial k-ths,
    a strictly weaker bound). Touches only NumPy and the pipes — never a
    torch op — so running in a fork-child of a torch process is safe. A
    separate function so every view of ``shm.buf`` (including
    the ones captured by the gate/on_done closures) is dead before the
    caller closes the segment.

    ``trace_meta`` (the task's optional 6th element) carries the
    parent's trace id when tracing is on: the child installs a matching
    tracer and ships each shard's spans back on the SAME result pipe,
    tagged with its pid (stamped at record time) and shard id — fork
    children share the parent's CLOCK_MONOTONIC base, so the spans land
    on the parent timeline without adjustment."""
    B, q_words, k, enumeration_cap, floor, trace_meta = task
    tracer = _obs.Tracer(enabled=False)
    if trace_meta:
        tracer = _obs.Tracer(
            enabled=True, host=trace_meta.get("host", "local"),
            trace_id=trace_meta.get("id"),
        )
    _obs.set_tracer(tracer)
    bounds = np.frombuffer(shm.buf, dtype=np.float64, count=B)
    gate = np.frombuffer(shm.buf, dtype=np.uint8, count=1, offset=8 * B)
    try:
        if not lead:                     # staggered worker: warm start
            _await_warm_start(bounds, floor, lambda: gate[0] != 0)
            on_first = None
        else:                            # lead worker: opens the gate
            def on_first():
                gate[0] = 1

        on_done = _local_kth_publisher(bounds, k)
        for s, index in group:
            st = [stats_factory() for _ in range(B)]
            launches0 = index.verify_launches
            results = index.knn_batch_bounded(
                q_words, k, stop_below=bounds, stats=st,
                enumeration_cap=enumeration_cap, on_done=on_done,
            )
            spans = None
            if trace_meta:
                spans = tracer.drain()
                for sp in spans:
                    sp.setdefault("args", {})["shard"] = s
            result_conn.send(("shard", s, results, st,
                              index.verify_launches - launches0, spans))
            if on_first is not None:
                on_first()
                on_first = None
        result_conn.send(("done",))
    except BaseException as e:          # surface the failure to the parent
        result_conn.send(("error", e))
    finally:
        # even on failure: staggered peers must not sit out the full
        # warm-start timeout waiting on a gate that will never open
        if lead:
            gate[0] = 1


def _pool_worker(group, lead, stats_factory, task_conn, result_conn):
    """Persistent forked-worker loop: block on the task pipe, run each
    probe task against the inherited (copy-on-write) shard indexes, exit
    on ("stop",) or when the parent's end of the pipe closes."""
    try:
        while True:
            try:
                msg = task_conn.recv()
            except EOFError:            # parent died / closed the pipe
                break
            if msg[0] == "stop":
                break
            try:
                shm = _attach_shm(msg[1])
            except (FileNotFoundError, OSError) as e:
                # the parent abandoned this call (a peer's pipe broke
                # mid-dispatch) and already unlinked its segment: report
                # and stay alive rather than dying on a stale task
                result_conn.send(("error", e))
                continue
            try:
                _run_pool_task(group, lead, stats_factory, result_conn,
                               shm, msg[2:])
            finally:
                shm.close()
    finally:
        result_conn.close()
        task_conn.close()


def _partition(entries, workers: int):
    """Round-robin shard groups of near-equal row totals (shards are
    already balanced, so round-robin by position is enough)."""
    groups = [entries[w::workers] for w in range(workers)]
    return [g for g in groups if g]


class PersistentShardPool:
    """Fork-once shard-probe worker pool: the amortized form of
    ``probe_shards_parallel`` for engines that answer many calls.

    Construction only partitions the shards; the workers (one per shard
    group, at most ``min(max_workers, len(shards), cpu_count)``) fork
    lazily on the FIRST ``probe()`` and then persist — every later call
    reuses them, shipping its task over each worker's task pipe and a
    fresh named shared-memory bounds segment (created per call, sized to
    the call's batch, unlinked after). ``forks`` counts worker processes
    ever started; for a healthy pool it never exceeds the group count,
    which is what "fork at most once per engine lifetime" means
    operationally.

    More workers than cores cannot probe faster but DOES weaken the
    bound (a shard only sees peers' bounds once their queries complete,
    so oversubscription just multiplies un-pruned starts). Within a
    group the bound chains sequentially, exactly like the sequential
    engine; across groups it flows live through the shared segment.
    Thread mode keeps one persistent ``ThreadPoolExecutor`` instead of
    processes — the right shape when probing cost is dominated by
    GIL-releasing device calls (the CUDA verify).

    ``close()`` (idempotent, also run on GC) sends every worker a stop
    message and joins it; ``ShardedAMIHEngine.close()`` forwards here so
    serving hosts can release the pool deterministically.
    """

    def __init__(self, indexes, stats_factory,
                 max_workers: Optional[int] = None, mode: str = "auto"):
        self.mode = resolve_probe_mode(mode)
        self.entries = list(indexes)
        self.stats_factory = stats_factory
        # stand-down gate: a device-probing shard answers in one fused
        # walk launch per z-group — there is no host loop to overlap, a
        # child forked after CUDA is initialised cannot use CUDA, and a
        # single device serializes the launches anyway. Any
        # device-backed shard collapses the pool to the inline path.
        if any(
            getattr(ix, "probe_backend", "host") == "device"
            for _, ix in self.entries
        ):
            workers = 1
        else:
            workers = max(1, min(
                max_workers or len(self.entries),
                len(self.entries),
                multiprocessing.cpu_count(),
            ))
        self.groups = _partition(self.entries, workers)
        self.forks = 0                   # worker processes ever started
        self._procs: List[tuple] = []    # [(proc, task_conn, result_conn)]
        self._executor: Optional[ThreadPoolExecutor] = None
        self._closed = False
        self._broken = False
        # serializes probe(): the standing task/result pipes carry one
        # call at a time (the per-call-fork predecessor was isolated per
        # call; a second concurrent call here would steal the first's
        # result messages). Serving already serializes knn_batch per
        # engine — this guards direct multi-threaded engine use.
        self._probe_lock = threading.Lock()

    def worker_pids(self) -> List[int]:
        """PIDs of the live forked workers (empty in thread/inline mode)."""
        return [proc.pid for proc, _, _ in self._procs]

    # ------------------------------------------------------------ lifecycle
    def _ensure_procs(self) -> None:
        """Fork the workers, once. Children inherit the built shard
        indexes copy-on-write (fork start method: args are never
        pickled) and block on their task pipes between calls."""
        if self._procs:
            return
        try:
            # start the resource tracker BEFORE forking so parent and
            # workers share one tracker process: per-call segment
            # registrations then balance against the parent's unlink
            # (see _attach_shm)
            from multiprocessing import resource_tracker

            resource_tracker.ensure_running()
        except Exception:
            pass
        ctx = multiprocessing.get_context("fork")
        for w, group in enumerate(self.groups):
            task_parent, task_child = ctx.Pipe(duplex=False)
            res_parent, res_child = ctx.Pipe(duplex=False)
            proc = ctx.Process(
                target=_pool_worker,
                args=(group, w == 0, self.stats_factory,
                      task_parent, res_child),
                daemon=True,
            )
            with warnings.catch_warnings():
                # Python (and libraries that run threads) warn that a fork
                # of a multi-threaded process may deadlock a child that
                # takes a lock another thread held; these children are
                # numpy-only by construction (_run_pool_task)
                for cat in (DeprecationWarning, RuntimeWarning):
                    warnings.filterwarnings(
                        "ignore", message=".*fork.*", category=cat
                    )
                proc.start()
            self.forks += 1
            task_parent.close()
            res_child.close()
            self._procs.append((proc, task_child, res_parent))

    def close(self) -> None:
        """Stop and join every worker (idempotent). Takes the probe lock,
        so a close racing an in-flight ``probe()`` drains that call first
        instead of closing the pipes out from under its collector."""
        with self._probe_lock:
            if self._closed:
                return
            self._closed = True
            for _, task_conn, _ in self._procs:
                try:
                    task_conn.send(("stop",))
                except (OSError, ValueError):
                    pass
                task_conn.close()
            for proc, _, res_conn in self._procs:
                proc.join(timeout=10)
                if proc.is_alive():
                    proc.terminate()
                res_conn.close()
            self._procs = []
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass   # interpreter shutdown: pipes may already be gone

    # -------------------------------------------------------------- probing
    def probe(
        self,
        q_words: np.ndarray,
        k: int,
        shared: SharedBound,
        enumeration_cap: Optional[int] = None,
    ) -> Dict[int, Tuple[list, list, int]]:
        """Probe every shard concurrently under ``shared``'s live bound.
        Returns shard_id -> (per-query results, per-query stats,
        verify-launch delta); callers fold in shard-id order so merged
        stats stay deterministic. ``shared`` may be a plain-array
        SharedBound — process mode re-points ``shared.bounds`` at the
        call's shared segment for the duration of the call (and back to
        a plain copy after), so the parent's ``offer`` writes are the
        single pooled-bound source every worker reads."""
        with self._probe_lock:
            if self._closed:
                raise RuntimeError("probe pool is closed")
            if self._broken:
                raise RuntimeError(
                    "probe pool lost a worker; build a fresh engine/pool"
                )
            if len(self.groups) == 1:
                return _probe_group(
                    self.entries, q_words, k, shared, self.stats_factory,
                    enumeration_cap,
                )
            if self.mode == "thread":
                return self._probe_threads(
                    q_words, k, shared, enumeration_cap
                )
            return self._probe_procs(q_words, k, shared, enumeration_cap)

    def _probe_threads(self, q_words, k, shared, enumeration_cap):
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=len(self.groups),
                thread_name_prefix="shard-probe",
            )
        # pre-probe bound snapshot: later workers stagger on bounds
        # raised ABOVE this floor by the lead worker's first shard
        # (priming does not count), lead cold-shard completion fallback
        floor = shared.bounds.copy()
        gate = threading.Event()

        def probe_entry(item):
            w, group = item
            if w > 0:
                _await_warm_start(shared.bounds, floor, gate.is_set)
                return _probe_group(
                    group, q_words, k, shared, self.stats_factory,
                    enumeration_cap,
                )
            try:
                return _probe_group(
                    group, q_words, k, shared, self.stats_factory,
                    enumeration_cap, on_first_shard=gate.set,
                )
            finally:
                gate.set()   # even on failure: unblock staggered peers

        out: Dict[int, Tuple[list, list, int]] = {}
        for part in self._executor.map(probe_entry, enumerate(self.groups)):
            out.update(part)
        return out

    def _probe_procs(self, q_words, k, shared, enumeration_cap):
        from multiprocessing import shared_memory

        self._ensure_procs()
        B = q_words.shape[0]
        # per-call bounds segment: B float64 bounds + 1 gate byte (the
        # lead worker's cold-shard flag), zero-initialized by create
        shm = shared_memory.SharedMemory(create=True, size=8 * B + 1)
        seg = np.frombuffer(shm.buf, dtype=np.float64, count=B)

        def open_gate():
            # on-demand view, dropped before returning: a persistent
            # gate array handed into _collect would be pinned by an
            # error path's traceback frame and block shm.close()
            g = np.frombuffer(shm.buf, dtype=np.uint8, count=1,
                              offset=8 * B)
            g[0] = 1

        try:
            seg[:] = shared.bounds
            shared.bounds = seg          # live view for parent offers
            floor = seg.copy()
            tr = _obs.current()
            trace_meta = (
                {"id": tr.trace_id, "host": tr.host} if tr.enabled
                else None
            )
            for w, (_, task_conn, _) in enumerate(self._procs):
                try:
                    task_conn.send((
                        "probe", shm.name, B, q_words, k, enumeration_cap,
                        None if w == 0 else floor, trace_meta,
                    ))
                except OSError as e:
                    # a worker died between calls: its task pipe is
                    # broken. The pool cannot serve half-dispatched
                    # calls — mark it dead so later probes fail fast
                    # instead of stranding stale tasks.
                    self._broken = True
                    raise RuntimeError(
                        "probe pool lost a worker; build a fresh "
                        "engine/pool"
                    ) from e
            return self._collect(shared, open_gate)
        finally:
            # detach the live bound from the segment (keep final values)
            # and drop every view before closing the mapping
            shared.bounds = np.array(shared.bounds, dtype=np.float64)
            del seg
            try:
                shm.close()
            except BufferError:
                # an in-flight exception's traceback can still pin a
                # view; never let that mask the real error — the name
                # is unlinked below regardless and the mapping dies
                # with the last reference
                pass
            shm.unlink()

    def _collect(self, shared, open_gate):
        """Drain result pipes for one call. The parent is the pooling
        thread: it folds streamed per-shard results into THE global
        candidate pool and is the single writer of the pooled per-query
        k-th bounds (children still publish their local k-ths via
        on_done — aligned 8-byte stores, monotone, safe)."""
        from multiprocessing.connection import wait as mp_wait

        out: Dict[int, Tuple[list, list, int]] = {}
        failure: Optional[BaseException] = None
        live = {conn: proc for proc, _, conn in self._procs}
        while live:
            for conn in mp_wait(list(live)):
                try:
                    msg = conn.recv()
                except EOFError:        # worker died mid-call
                    open_gate()         # (hard kill skips its finally)
                    self._broken = True
                    del live[conn]
                    continue
                if msg[0] == "shard":
                    _, s, results, st, launches, spans = msg
                    if spans:
                        # same machine, shared monotonic clock: no shift
                        _obs.current().ingest(spans)
                    out[s] = (results, st, launches)
                    for qi, (r_ids, r_sims) in enumerate(results):
                        shared.offer(qi, r_ids, r_sims)
                elif msg[0] == "error":
                    failure = failure or msg[1]
                    open_gate()         # never strand staggered peers
                    del live[conn]
                else:                   # "done": task finished
                    del live[conn]
        if failure is not None:
            raise failure
        if len(out) != len(self.entries):
            missing = sorted(set(s for s, _ in self.entries) - set(out))
            self._broken = True
            raise RuntimeError(
                f"shard probe worker died without reporting shards "
                f"{missing}"
            )
        return out


def probe_shards_parallel(
    indexes,
    q_words: np.ndarray,
    k: int,
    shared: SharedBound,
    stats_factory,
    enumeration_cap: Optional[int] = None,
    max_workers: Optional[int] = None,
    mode: str = "auto",
) -> Dict[int, Tuple[list, list]]:
    """One-shot form of ``PersistentShardPool``: build the pool, probe
    once, tear the workers down. Same result contract as ``probe()``;
    use the persistent pool (as ``ShardedAMIHEngine`` does) when there
    is an engine lifetime to amortize the forks over."""
    pool = PersistentShardPool(
        indexes, stats_factory, max_workers=max_workers, mode=mode
    )
    try:
        return pool.probe(
            q_words, k, shared, enumeration_cap=enumeration_cap
        )
    finally:
        pool.close()
