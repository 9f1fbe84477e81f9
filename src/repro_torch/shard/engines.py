"""Sharded SearchEngine backends: row-sharded DBs behind the same
knn_batch (a port of the reference's ``shard/engines.py``).

Both backends consume a ``ShardPlan`` (row partition with per-shard
global-id offsets and a ``torch.device`` per shard) and register in the
core engine registry, so

    make_engine("sharded_scan", db, p, num_shards=8)
    make_engine("sharded_amih", db, p, num_shards=8)

work unchanged for every caller of the unified API. Both are EXACT: sims
returned are bit-identical to per-query ``linear_scan_knn`` (up to ties
inside one Hamming tuple), including N not divisible by the shard count
and K larger than a shard's row count.

  - "sharded_scan": every shard runs the fused K4 top-K
    (``kernels/ops.scan_topk``) over its padded row slice on its own
    device, with ``n_valid`` masking the pad rows, and contributes its
    local top-``k_fetch`` to a candidate pool (``sharded_scan_candidates``:
    every call queued before any is read). The pooled candidates are
    re-scored on host in exact float64 (``sims_for_ids``) and re-ranked,
    the same preselect-then-rerank contract as LinearScanEngine's CUDA
    path.

  - "sharded_amih": each shard owns an ``AMIHIndex`` over its row slice
    (built with ``id_offset`` so emitted ids are global). Shards are
    probed in sequence; after each, the pooled k-th best cosine becomes
    the next shard's ``stop_below`` bound — a shard stops probing the
    moment its tuple sequence's sim drops below the global k-th
    (``AMIHIndex.knn_batch_bounded``), the cross-shard form of the
    paper's early-termination rule. Per-shard exact top-K lists merge by
    one lexsort into the global top-K.

``EngineStats`` gains the shard view: ``stats.shards`` and one
``stats.per_shard`` dict per shard (rows held, candidates/verifications
contributed, device launches, early stops).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.amih import AMIHIndex, AMIHStats, _SubTable
from ..core.engine import (
    EngineStats,
    SearchEngine,
    probe_cache_snapshot,
    register_engine,
)
from ..core.linear_scan import sims_for_ids
from ..core.packing import WORD_DTYPE
from ..core.single_table import SearchStats
from ..kernels import ops
from ..obs import trace as _obs
from .plan import ShardPlan

__all__ = ["ShardedAMIHEngine", "ShardedScanEngine"]


def _resolve_plan(
    db_words: np.ndarray,
    mesh,
    num_shards: Optional[int],
    shard_axes,
    plan: Optional[ShardPlan],
    devices=None,
) -> ShardPlan:
    """One plan from whichever knob the caller provided (plan > mesh (a
    ``DeviceMesh``) > num_shards > one shard per CUDA device). Placement:
    an explicit ``devices`` list wins (strings or ``torch.device``s); a
    mesh-derived plan is already placed on its mesh devices; any
    still-unplaced plan — including ``ShardPlan.from_summary`` restores,
    which are always unplaced — round-robins the CUDA devices (one card
    holds every shard). Without a CUDA device an unplaced plan stays
    unplaced: the host walk with ``verify_backend="numpy"`` needs no
    device, and every backend that does resolves ``None`` to the card and
    raises. A caller plan that already carries devices is trusted
    as-is."""
    import torch

    n = np.asarray(db_words).shape[0]
    if plan is not None:
        if plan.n != n:
            raise ValueError(f"plan covers n={plan.n}, DB has n={n}")
    elif mesh is not None:
        plan = ShardPlan.from_mesh(mesh, n, shard_axes=shard_axes)
    else:
        if num_shards is None:
            num_shards = max(1, torch.cuda.device_count())
        plan = ShardPlan.balanced(n, num_shards)
    if devices is not None:
        return plan.place([torch.device(d) for d in devices])
    if not plan.devices and torch.cuda.is_available():
        plan = plan.place([torch.device("cuda", i)
                           for i in range(torch.cuda.device_count())])
    return plan


def _super_index(shards, p: int, device) -> AMIHIndex:
    """One device's *super index* over its shards' concatenated rows
    (local ids, ``id_offset=0``): what ``AMIHIndex.build`` of the
    concatenation returns, without sorting it again. Each substring
    table's values are the shards' already-sorted runs, merged by one
    stable argsort (a run-merging sort: ~10x faster than sorting afresh);
    equal values keep shard order and, within a shard, id order — the
    ascending row order a fresh build gives them."""
    first = shards[0][1]
    db = np.concatenate([ix.db_words for _, ix in shards])
    offsets = np.cumsum([0] + [ix.n for _, ix in shards[:-1]])
    tables = []
    for t, tab in enumerate(first.tables):
        vals = np.concatenate([ix.tables[t].sorted_vals for _, ix in shards])
        ids = np.concatenate([ix.tables[t].sorted_ids + off
                              for (_, ix), off in zip(shards, offsets)])
        order = np.argsort(vals, kind="stable")
        tables.append(_SubTable(lo=tab.lo, hi=tab.hi,
                                sorted_vals=vals[order],
                                sorted_ids=ids[order]))
    return AMIHIndex.from_tables(
        db, p, first.m, tables, device=device, probe_backend="device",
        probe_stream_cap=first.probe_stream_cap,
    )


def _preselect_slack(p: int) -> int:
    # Same float32 selection-boundary slack as LinearScanEngine._topk_slack:
    # distinct Eq. 3 sims stay resolvable in float32 up to p ~ 192; beyond,
    # the slack grows so a collapsed boundary population still fits.
    return 16 + max(0, p - 128) // 4


def _count_per_shard(plan: ShardPlan, gids: np.ndarray) -> List[int]:
    """How many candidate ids fall in each shard's global-id range."""
    edges = np.asarray(plan.starts[1:], dtype=np.int64)
    owner = np.searchsorted(edges, gids, side="right")
    return np.bincount(owner, minlength=plan.num_shards).tolist()


@register_engine
class ShardedScanEngine(SearchEngine):
    """Exhaustive scan over a row-sharded DB: one fused K4 top-K call per
    shard on the shard's device, O(K)-per-shard gather, exact float64
    host rerank. A shard without a plan device runs on the CUDA device
    (and raises without one); pass ``devices=["cpu"]`` for the plain
    version on the CPU."""

    name = "sharded_scan"

    def __init__(self, db_words, p, plan, chunk):
        self.db_words = np.ascontiguousarray(db_words, dtype=WORD_DTYPE)
        self.p = p
        self.plan = plan
        self.chunk = chunk
        self.shard_launches = 0
        self._shard_dev: List[Any] = []   # per-shard padded slices

    @classmethod
    def build(
        cls,
        db_words: np.ndarray,
        p: int,
        mesh=None,
        num_shards: Optional[int] = None,
        shard_axes: Optional[Tuple[str, ...]] = None,
        plan: Optional[ShardPlan] = None,
        chunk: int = 1 << 16,
        devices=None,
        **cfg: Any,
    ) -> "ShardedScanEngine":
        if cfg:
            raise TypeError(f"unknown sharded_scan options: {sorted(cfg)}")
        plan = _resolve_plan(db_words, mesh, num_shards, shard_axes, plan,
                             devices)
        for s in range(plan.num_shards):
            ops.resolve_device(plan.device_for(s))   # the card, or raise
        return cls(db_words, p, plan, chunk)

    @property
    def n(self) -> int:
        return self.db_words.shape[0]

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
        k_fetch = min(
            self.plan.rows_padded,
            ops.pad_bucket(k_eff + _preselect_slack(self.p), minimum=8),
        )
        with _obs.current().span("engine.knn_batch", cat="engine",
                                 backend=self.name, B=B, k=k_eff):
            return self._knn_batch_traced(q, B, k_eff, k_fetch)

    def _knn_batch_traced(self, q, B, k_eff, k_fetch):
        pool_sims, pool_gids = self._candidates(q, k_fetch)

        ids_out = np.empty((B, k_eff), dtype=np.int64)
        sims_out = np.empty((B, k_eff), dtype=np.float64)
        shard_counts = np.zeros(self.plan.num_shards, dtype=np.int64)
        for i in range(B):
            cand = pool_gids[i][pool_gids[i] >= 0].astype(np.int64)
            shard_counts += np.asarray(_count_per_shard(self.plan, cand))
            # exact float64; ids are global, the rows this host's own
            # (a host sub-plan's local row 0 is global id ``base``)
            sub = sims_for_ids(q[i], self.db_words, cand - self.plan.base)
            order = np.lexsort((cand, -sub))[:k_eff]
            ids_out[i] = cand[order]
            sims_out[i] = sub[order]
        self.shard_launches += self.plan.num_shards
        per_shard = [
            {
                "shard": s,
                "rows": self.plan.counts[s],
                "candidates": int(shard_counts[s]),
                "launches": 1,
                "device": str(self.plan.device_for(s)),
            }
            for s in range(self.plan.num_shards)
        ]
        stats = EngineStats(
            backend=self.name, queries=B,
            per_query=[SearchStats(retrieved=self.n) for _ in range(B)],
            shards=self.plan.num_shards, per_shard=per_shard,
        )
        return ids_out, sims_out, stats

    def _candidates(self, q, k_fetch):
        """Each shard's fused K4 top-K on its own device (the padded
        layout, pads masked by ``n_valid``), every call queued before any
        result is read; the gathered pool as host arrays."""
        from .distributed import place_shards, sharded_scan_candidates

        if not self._shard_dev:
            self._shard_dev = place_shards(self.plan, self.db_words)
        return sharded_scan_candidates(
            self.plan, q, self._shard_dev, k_fetch, chunk=self.chunk,
        )


@register_engine
class ShardedAMIHEngine(SearchEngine):
    """AMIH over a row-sharded DB: one shard-local index per slice,
    sequential probing with the pooled k-th cosine as each next shard's
    early-termination bound, exact lexsort merge.

    Each shard's index is DEVICE-PLACED from the plan's assignment map
    (an explicit ``devices`` list, a ``DeviceMesh``, or the CUDA devices
    round-robin): its codes upload to — and its launches run on — the
    shard's own device. Only the O(K) per-shard result lists ever cross
    back to the host merge. ``stats.per_shard[s]["device"]`` records
    where each shard's work landed (the ``launches.device.<device>``
    counters of ``repro_torch.obs.metrics.REGISTRY`` count the launches
    per device). The defaults follow the port's AMIH engine: the device
    walk, and the CUDA grouped verify (K1) on the host walk.

    ``probe_workers`` switches the host walk's shard probing from the
    sequential chain to the pipelined shard pool
    (repro_torch.pipeline.shardpool): every shard
    probes concurrently — forked worker processes by default (the
    probing loop is too GIL-bound for threads on CPython;
    ``probe_mode="thread"`` selects the pool for free-threaded runtimes)
    — all reading ONE shared monotone per-query bound that every query
    raises the moment it fills its local K, and that ``prime_bound``
    warm-starts with the exact sims of a small deterministic row sample
    before any probing begins (the sequential chain gives shard 0 no
    bound at all). Still exact: the shared bound is always the k-th best
    sim of some subset of real rows, lowered by a float64 rounding margin
    (``shardpool.safe_bound``, ROADMAP C-R3), hence a valid lower bound
    on the global k-th (see shardpool.py). The CUDA verify forces thread
    mode: a child forked after CUDA is initialised cannot use CUDA. The
    pool is PERSISTENT: workers fork
    once, on the engine's first parallel call, and each later call ships
    its task over the standing worker pipes (``engine.close()`` releases
    them; GC does too).

    ``probe_backend="device"`` builds every shard index with the fused
    device probing walk (see core.probe_device), so the host probe pool
    stands down entirely — no workers ever fork. With ``probe_fused``
    (the default) the engine goes further and collapses the launch count
    to O(devices): the shards resident on each device are stacked into
    one per-device *super index* (concatenated rows + rebuilt CSR, local
    rows mapped back to global ids at extraction), every device's fused
    batch walk (one K2 launch per device) is dispatched WITHOUT blocking,
    and the host only syncs at each device's extraction — device-parallel
    probing. Since the
    walk is shared, ``stats.per_shard[s]`` records the shared
    ``launch_id`` it participated in, the per-device launch count on the
    device group's LEAD shard, and 0 on the riders — summing
    ``launches`` over shards equals real dispatches, so serving
    dashboards don't over-count.
    """

    name = "sharded_amih"

    # Adaptive stand-down gates: the parallel pool only engages when the
    # host and the call can actually pay for it; everything else runs
    # the sequential chain (identical results — the pool is a schedule,
    # not an algorithm). Instance attributes, so tests/benches force the
    # pool on small fixtures by zeroing them.
    #   MIN_SHARD_ROWS — tiny shards are pure Python overhead (small
    #     buckets, no GIL-releasing bulk NumPy); worker startup plus the
    #     pool's weaker early bounds cost more than concurrency returns.
    #   MIN_CPUS — measured on a 2-HT-sibling host: the probing mix gets
    #     ~1.0x from a second hardware thread while fork/IPC and the
    #     pool's extra unbounded starts are pure cost, so below a real
    #     multicore the pool cannot win.
    #   MIN_BATCH — per-call worker startup (forks in process mode)
    #     amortizes over the batch; a 1-query call pays it all alone.
    PARALLEL_MIN_SHARD_ROWS = 4096
    PARALLEL_MIN_CPUS = 4
    PARALLEL_MIN_BATCH = 8

    def __init__(self, db_words, p, plan, indexes, enumeration_cap,
                 probe_workers: Optional[int] = None,
                 prime_bound: bool = True,
                 probe_mode: str = "auto",
                 probe_backend: str = "device",
                 probe_fused: bool = True):
        self.db_words = np.ascontiguousarray(db_words, dtype=WORD_DTYPE)
        self.p = p
        self.plan = plan
        self.indexes = indexes      # [(shard_id, AMIHIndex)] non-empty shards
        self.enumeration_cap = enumeration_cap
        self.probe_workers = probe_workers
        self.prime_bound = prime_bound
        self.probe_mode = probe_mode
        self.probe_backend = probe_backend
        self.probe_fused = probe_fused
        self._fused = None          # per-device super-index groups, lazy
        self._fused_seq = 0         # shared launch-id counter (S6)
        self._pool = None           # PersistentShardPool, forked on first use
        self._closed = False
        # guards _pool/_closed: a knn_batch racing close() must not
        # rebuild (and leak) a fresh worker pool on a closed engine
        self._pool_lock = threading.Lock()

    @classmethod
    def build(
        cls,
        db_words: np.ndarray,
        p: int,
        mesh=None,
        num_shards: Optional[int] = None,
        shard_axes: Optional[Tuple[str, ...]] = None,
        plan: Optional[ShardPlan] = None,
        m: Optional[int] = None,
        verify_backend: str = "cuda",
        enumeration_cap: Optional[int] = None,
        probe_workers: Optional[int] = None,
        prime_bound: bool = True,
        probe_mode: str = "auto",
        probe_backend: str = "device",
        probe_stream_cap: int = 1 << 16,
        probe_fused: bool = True,
        devices=None,
        **cfg: Any,
    ) -> "ShardedAMIHEngine":
        if cfg:
            raise TypeError(f"unknown sharded_amih options: {sorted(cfg)}")
        db = np.ascontiguousarray(db_words, dtype=WORD_DTYPE)
        plan = _resolve_plan(db, mesh, num_shards, shard_axes, plan,
                             devices)
        indexes = []
        for s in range(plan.num_shards):
            if plan.counts[s] == 0:
                continue
            # each shard's index is PLACED: its db_dev upload and its
            # launches target the shard's own device
            indexes.append((s, AMIHIndex.build(
                db[plan.shard_slice(s)], p, m=m,
                verify_backend=verify_backend, id_offset=plan.starts[s],
                device=plan.device_for(s),
                probe_backend=probe_backend,
                probe_stream_cap=probe_stream_cap,
                probe_fused=probe_fused,
            )))
        return cls(db, p, plan, indexes, enumeration_cap,
                   probe_workers, prime_bound, probe_mode, probe_backend,
                   probe_fused)

    @property
    def n(self) -> int:
        return self.db_words.shape[0]

    def close(self) -> None:
        """Release the persistent probe-worker pool (idempotent; also run
        on GC, so engine churn never leaks forked workers). A closed
        engine still answers ``knn_batch`` — parallel calls fall back to
        the sequential chain instead of re-forking workers."""
        with self._pool_lock:
            self._closed = True
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass   # interpreter shutdown: pipes may already be gone

    def _use_parallel(self, B: int) -> bool:
        import multiprocessing

        # the device probe path runs each shard as one fused launch per
        # z-group — there is no host probing loop left to parallelize,
        # so the worker pool never forks for it
        if self.probe_backend == "device":
            return False
        # mean rows per non-empty shard: robust to one straggler shard
        # in an otherwise-large custom plan (min would stand the pool
        # down) without letting one big shard drag seven tiny ones into
        # worker startup they can't amortize (max would engage it)
        mean_rows = self.n / max(1, len(self.indexes))
        return bool(
            self.probe_workers and self.probe_workers > 1
            and len(self.indexes) > 1
            and B >= self.PARALLEL_MIN_BATCH
            and multiprocessing.cpu_count() >= self.PARALLEL_MIN_CPUS
            and mean_rows >= self.PARALLEL_MIN_SHARD_ROWS
        )

    def knn_batch(self, q_words, k):
        q = self._check_queries(q_words, self.p)
        B = q.shape[0]
        k_eff = min(k, self.n)
        per_query = [AMIHStats() for _ in range(B)]
        if k_eff == 0:
            return (
                np.empty((B, 0), np.int64), np.empty((B, 0), np.float64),
                EngineStats(backend=self.name, queries=B,
                            per_query=per_query,
                            shards=self.plan.num_shards),
            )
        with _obs.current().span("engine.knn_batch", cat="engine",
                                 backend=self.name, B=B, k=k_eff):
            return self._knn_batch_traced(q, B, k_eff, per_query)

    def _knn_batch_traced(self, q, B, k_eff, per_query):
        fuse_meta: Optional[Dict[int, Dict[str, Any]]] = None
        groups = self._fused_groups()
        if groups is not None:
            shard_out, fuse_meta = self._probe_device_fused(q, k_eff, groups)
        elif self._use_parallel(B):
            shard_out = self._probe_parallel(q, k_eff)
        else:
            shard_out = self._probe_sequential(q, k_eff)

        per_shard, gid_parts, sim_parts = self._fold_shard_out(
            shard_out, fuse_meta, per_query, B, k_eff
        )
        ids_out = np.empty((B, k_eff), dtype=np.int64)
        sims_out = np.empty((B, k_eff), dtype=np.float64)
        for i in range(B):
            gids = np.concatenate(gid_parts[i]) if gid_parts[i] \
                else np.empty(0, dtype=np.int64)
            sims = np.concatenate(sim_parts[i]) if sim_parts[i] \
                else np.empty(0, dtype=np.float64)
            order = np.lexsort((gids, -sims))[:k_eff]
            ids_out[i] = gids[order]
            sims_out[i] = sims[order]
        stats = EngineStats(
            backend=self.name, queries=B, per_query=per_query,
            shards=self.plan.num_shards, per_shard=per_shard,
            cache_info=probe_cache_snapshot(),
        )
        return ids_out, sims_out, stats

    def knn_batch_bounded(self, q_words, k, stop_below, on_done=None):
        """``knn_batch`` pruned by an external LIVE per-query floor — the
        engine-level form of ``AMIHIndex.knn_batch_bounded``, built for
        the cross-host tier (ROADMAP A9): each worker host runs its slice
        under the cluster-wide k-th-cosine floor, so a query whose
        global top-K already lives on other hosts stops probing here
        early. Results are RAGGED — a per-query ``(ids, sims)`` list
        holding this host's rows with sim >= the floor, possibly fewer
        than k when the floor pruned locally — plus the same
        ``EngineStats`` as ``knn_batch``.

        ``stop_below`` must be a float64 (B,) array; its entries may
        only ever RISE and must stay valid lower bounds on each query's
        global k-th cosine. The sequential chain re-reads it live (a
        remote raise prunes mid-shard) and raises it monotonically with
        the local pooled k-th; the fused-device and parallel-pool paths
        snapshot it at dispatch (a raise landing mid-flight costs time,
        never correctness) and raise it at the merge. ``on_done(qi, ids,
        sims)`` fires whenever query ``qi`` fills a local K (mid-probe
        on the sequential chain, at the merge everywhere) — the cluster
        worker publishes its local k-th through it."""
        q = self._check_queries(q_words, self.p)
        B = q.shape[0]
        k_eff = min(k, self.n)
        per_query = [AMIHStats() for _ in range(B)]
        if k_eff == 0:
            empty = (np.empty(0, np.int64), np.empty(0, np.float64))
            return [empty for _ in range(B)], EngineStats(
                backend=self.name, queries=B, per_query=per_query,
                shards=self.plan.num_shards,
            )
        floor = np.asarray(stop_below)
        if floor.dtype != np.float64 or floor.shape != (B,):
            raise ValueError(
                f"stop_below must be float64 of shape ({B},), got "
                f"{floor.dtype} {floor.shape} — the live no-copy "
                f"contract (see AMIHIndex.knn_batch_bounded)"
            )
        fuse_meta: Optional[Dict[int, Dict[str, Any]]] = None
        groups = self._fused_groups()
        if groups is not None:
            shard_out, fuse_meta = self._probe_device_fused(
                q, k_eff, groups, floor=floor
            )
        elif self._use_parallel(B):
            shard_out = self._probe_parallel(q, k_eff, floor=floor)
        else:
            shard_out = self._probe_sequential(
                q, k_eff, bounds=floor, on_done=on_done
            )
        per_shard, gid_parts, sim_parts = self._fold_shard_out(
            shard_out, fuse_meta, per_query, B, k_eff
        )
        results: List[Tuple[np.ndarray, np.ndarray]] = []
        for i in range(B):
            gids = np.concatenate(gid_parts[i]) if gid_parts[i] \
                else np.empty(0, dtype=np.int64)
            sims = np.concatenate(sim_parts[i]) if sim_parts[i] \
                else np.empty(0, dtype=np.float64)
            order = np.lexsort((gids, -sims))[:k_eff]
            ids_i, sims_i = gids[order], sims[order]
            results.append((ids_i, sims_i))
            if sims_i.size >= k_eff:
                kth = float(sims_i[-1])
                if kth > floor[i]:
                    floor[i] = kth
                if on_done is not None:
                    on_done(i, ids_i, sims_i)
        stats = EngineStats(
            backend=self.name, queries=B, per_query=per_query,
            shards=self.plan.num_shards, per_shard=per_shard,
            cache_info=probe_cache_snapshot(),
        )
        return results, stats

    def _fold_shard_out(self, shard_out, fuse_meta, per_query, B, k_eff):
        """Fold per-shard probe output in shard-id order regardless of
        probing order, so merged stats and results are deterministic
        either way. Returns (per_shard aggregates, per-query gid parts,
        per-query sim parts)."""
        per_shard: List[Dict[str, int]] = []
        gid_parts: List[List[np.ndarray]] = [[] for _ in range(B)]
        sim_parts: List[List[np.ndarray]] = [[] for _ in range(B)]
        for s, index in self.indexes:
            results, shard_stats, launches = shard_out[s]
            local_k = min(k_eff, index.n)
            early_stopped = 0
            for i, (r_ids, r_sims) in enumerate(results):
                if r_ids.size < local_k:
                    early_stopped += 1
                if r_ids.size:
                    gid_parts[i].append(r_ids)
                    sim_parts[i].append(r_sims)
                self._fold_stats(per_query[i], shard_stats[i])
            agg: Dict[str, int] = {
                "shard": s,
                "rows": index.n,
                # measured where the verifies ran (forked workers'
                # index counters never reach the parent's objects)
                "launches": launches,
                "early_stopped": early_stopped,
                "device": str(index.device),
                "probe_backend": index.probe_backend,
            }
            for counter in ("probes", "retrieved", "verified",
                            "tuples_processed", "fell_back_to_scan"):
                agg[counter] = sum(
                    int(getattr(st, counter)) for st in shard_stats
                )
            if fuse_meta is not None:
                # fused device path: every shard of a device group shares
                # one launch id; only the group's lead shard carries the
                # launch count and device-level counters, so summing
                # ``launches`` across shards equals real dispatches
                agg.update(fuse_meta.get(s, {}))
            per_shard.append(agg)
        return per_shard, gid_parts, sim_parts

    def _fused_groups(self):
        """Per-device super-index groups for the fused device path,
        built lazily on first use and cached for the engine lifetime.

        Returns None — and the caller falls back to the sequential
        chain — unless every shard index runs ``probe_backend="device"``
        with ``probe_fused`` and all shards agree on (m, stream cap), so
        a mixed or per-shard-tuned layout never silently changes shape.

        Each group stacks the shards resident on ONE device: a
        single-shard group reuses that shard's index outright; a
        multi-shard group builds a hidden *super index* over the
        concatenated row slices (local ids, ``id_offset=0``) with a
        ``row_to_gid`` map and shard ``edges`` for attribution. Because
        the plan hands out contiguous ascending row ranges in shard
        order, concat-row order equals global-id order within the
        device, so extraction order — hence the final lexsort merge —
        is bit-identical to the sequential per-shard path."""
        if (
            self.probe_backend != "device"
            or not self.probe_fused
            or not self.indexes
        ):
            return None
        if self._fused is not None:
            return self._fused
        if (
            len({ix.m for _, ix in self.indexes}) > 1
            or len({ix.probe_stream_cap for _, ix in self.indexes}) > 1
            or not all(ix.probe_fused for _, ix in self.indexes)
            or not all(
                ix.probe_backend == "device" for _, ix in self.indexes
            )
        ):
            return None
        by_dev: Dict[str, Dict[str, Any]] = {}
        order: List[Dict[str, Any]] = []
        for s, ix in self.indexes:
            dkey = ops.device_key(ix.device)
            g = by_dev.get(dkey)
            if g is None:
                g = {"dkey": dkey, "device": ix.device, "shards": []}
                by_dev[dkey] = g
                order.append(g)
            g["shards"].append((s, ix))
        for g in order:
            shards = g["shards"]
            if len(shards) == 1:
                g["super"] = shards[0][1]
                g["row_to_gid"] = None
            else:
                g["super"] = _super_index(shards, self.p, g["device"])
                g["row_to_gid"] = np.concatenate([
                    np.arange(ix.n, dtype=np.int64) + ix.id_offset
                    for _, ix in shards
                ])
            g["edges"] = np.cumsum(
                [ix.n for _, ix in shards]
            ).astype(np.int64)
        self._fused = order
        return order

    def _probe_device_fused(self, q, k_eff, groups, floor=None):
        """One fused walk launch per DEVICE: dispatch every device group
        back-to-back without blocking, then resolve them in turn — the
        host only syncs per device at extraction time, so all devices
        probe concurrently. ``prime_bound`` warm-starts every group with
        the exact k-th sim of a deterministic row sample (each group is
        probed independently, so no cross-shard bound chaining exists to
        lean on); an external ``floor`` (the cluster-wide bound) is
        SNAPSHOTTED at dispatch and max-folded in. Returns (shard_out,
        fuse_meta): per-shard result lists split out of each device's
        super index, stats and launch counts attributed to the group's
        lead shard (S6)."""
        from ..core import probe_device
        from ..pipeline.shardpool import prime_ids, safe_bound

        B = q.shape[0]
        bounds = None
        if self.prime_bound:
            sample = prime_ids(self.n, k_eff)
            if sample.size >= k_eff:
                cut = sample.size - k_eff
                bounds = np.empty(B, dtype=np.float64)
                for i in range(B):
                    sims_i = sims_for_ids(q[i], self.db_words, sample)
                    # lowered by the rounding margin: the walk stops at
                    # the first position whose float64 sim is below the
                    # bound, and an equal-cosine tuple may round lower
                    # than the sample's (ROADMAP C-R3)
                    bounds[i] = safe_bound(np.partition(sims_i, cut)[cut])
        if floor is not None:
            snap = np.array(floor, dtype=np.float64, copy=True)
            bounds = snap if bounds is None else np.maximum(bounds, snap)
        pend = []
        for g in groups:
            sup = g["super"]
            pend.append((
                sup.verify_launches,
                probe_device.dispatch_groups_device(
                    sup, q, min(k_eff, sup.n), stop_below=bounds
                ),
            ))
        shard_out: Dict[int, Tuple[list, list, int]] = {}
        fuse_meta: Dict[int, Dict[str, Any]] = {}
        for g, (l0, pending) in zip(groups, pend):
            sup = g["super"]
            dstats = [AMIHStats() for _ in range(B)]
            states = probe_device.resolve_groups_device(
                sup, pending, dstats
            )
            launches = sup.verify_launches - l0
            shards = g["shards"]
            lead_ix = shards[0][1]
            if len(shards) > 1:
                # the hidden super index did the probing; surface its
                # launches on the lead shard's index so process-wide
                # counters that sum engine.indexes stay truthful
                lead_ix.verify_launches += launches
            self._fused_seq += 1
            lid = f"fused:{g['dkey']}#{self._fused_seq}"
            res_by: List[List[Any]] = [[None] * B for _ in shards]
            for st in states:           # states arrive qi-ordered
                rows = st.out_ids
                sims = np.asarray(st.out_sims, dtype=np.float64)
                if g["row_to_gid"] is None:
                    owner = np.zeros(rows.size, dtype=np.int64)
                    gids = rows + lead_ix.id_offset
                else:
                    owner = np.searchsorted(g["edges"], rows, side="right")
                    gids = g["row_to_gid"][rows]
                for j in range(len(shards)):
                    sel = owner == j
                    res_by[j][st.qi] = (gids[sel], sims[sel])
            for j, (s, _ix) in enumerate(shards):
                stats_j = dstats if j == 0 else [
                    AMIHStats() for _ in range(B)
                ]
                shard_out[s] = (res_by[j], stats_j,
                                launches if j == 0 else 0)
                fuse_meta[s] = {
                    "launch_id": lid,
                    "fused_shards": len(shards),
                }
        return shard_out, fuse_meta

    def _probe_sequential(self, q, k_eff, bounds=None, on_done=None):
        """The sequential chain: shards probed one after another, each
        next shard bounded by the pooled k-th cosine of everything seen
        so far.
        ``bounds`` may be a caller-owned LIVE float64 (B,) array (the
        cluster-wide floor): each shard's bounded search re-reads it per
        tuple step, and the chain's pooled-k-th writes are MONOTONE
        raises — a concurrently-raised remote value is never lowered."""
        B = q.shape[0]
        shard_out: Dict[int, Tuple[list, list, int]] = {}
        sim_parts: List[List[np.ndarray]] = [[] for _ in range(B)]
        if bounds is None:
            bounds = np.full(B, -np.inf)
        for s, index in self.indexes:
            shard_stats = [AMIHStats() for _ in range(B)]
            launches0 = index.verify_launches
            results = index.knn_batch_bounded(
                q, k_eff, stop_below=bounds, stats=shard_stats,
                enumeration_cap=self.enumeration_cap, on_done=on_done,
            )
            for i, (r_ids, r_sims) in enumerate(results):
                if r_ids.size:
                    sim_parts[i].append(r_sims)
                total = sum(a.size for a in sim_parts[i])
                if total >= k_eff:
                    pool = np.concatenate(sim_parts[i]) if \
                        len(sim_parts[i]) > 1 else sim_parts[i][0]
                    # pooled k-th best cosine: sims strictly below it can
                    # never enter the global top-K of query i
                    b = np.partition(pool, total - k_eff)[total - k_eff]
                    if b > bounds[i]:
                        bounds[i] = b
            shard_out[s] = (results, shard_stats,
                            index.verify_launches - launches0)
        return shard_out

    def _probe_pool(self):
        """The engine's PersistentShardPool, built once: workers fork on
        the first parallel call and persist for the engine lifetime
        (``close()`` releases them). Returns None on a closed engine —
        the caller falls back to the sequential chain rather than
        re-forking workers nothing will ever release."""
        with self._pool_lock:
            if self._closed:
                return None
            if self._pool is None:
                from ..pipeline.shardpool import (
                    PersistentShardPool,
                    resolve_probe_mode,
                )

                mode = resolve_probe_mode(self.probe_mode)
                if mode == "process" and any(
                    ix.verify_backend == "cuda" for _, ix in self.indexes
                ):
                    # a child forked after CUDA is initialised cannot use
                    # CUDA, and one that runs torch ops after the parent
                    # started the intra-op thread pool may deadlock (the
                    # plain version on a CPU device); the verify also
                    # releases the GIL, so threads are the right pool
                    mode = "thread"
                self._pool = PersistentShardPool(
                    self.indexes, AMIHStats,
                    max_workers=self.probe_workers, mode=mode,
                )
            return self._pool

    def _probe_parallel(self, q, k_eff, floor=None):
        """Pipelined shard pool: all shards probe concurrently under one
        shared monotone bound, warm-started from a row sample (and from
        a SNAPSHOT of the external cluster ``floor``, when given). The
        pool is persistent — forked once per engine lifetime, each call
        ships its task over the standing worker pipes."""
        from ..pipeline.shardpool import SharedBound, prime_ids

        pool = self._probe_pool()
        if pool is None:               # engine closed: no new workers
            return self._probe_sequential(q, k_eff, bounds=floor)
        B = q.shape[0]
        shared = SharedBound(B, k_eff)
        if self.prime_bound:
            sample = prime_ids(self.n, k_eff)
            for i in range(B):
                shared.offer(i, sample, sims_for_ids(
                    q[i], self.db_words, sample
                ))
        if floor is not None:
            for i in range(B):
                f = float(floor[i])
                if f > -np.inf:
                    shared.raise_to(i, f)
        try:
            return pool.probe(
                q, k_eff, shared, enumeration_cap=self.enumeration_cap
            )
        except RuntimeError:
            if pool._closed:           # close() won the race mid-call:
                return self._probe_sequential(q, k_eff)
            raise                      # a genuinely broken pool

    @staticmethod
    def _fold_stats(into: AMIHStats, src: AMIHStats) -> None:
        into.probes += src.probes
        into.retrieved += src.retrieved
        into.verified += src.verified
        into.tuples_processed += src.tuples_processed
        into.substring_tuples_probed += src.substring_tuples_probed
        into.max_radius = max(into.max_radius, src.max_radius)
        into.exceeded_rhat |= src.exceeded_rhat
        into.fell_back_to_scan |= src.fell_back_to_scan
