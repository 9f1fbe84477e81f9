"""Unified batched SearchEngine: one query API over the port's exact-KNN
backends (a port of the reference's ``core/engine.py``).

    engine = make_engine("amih", db_words, p)          # on the CUDA device
    ids, sims, stats = engine.knn_batch(q_words, k)   # q_words: (B, W)

Backends ported so far:

  - "linear_scan" — exhaustive Eq. 3 scan: on the CUDA device
                    (``compute_backend="cuda"``, the default: the K4 scoring
                    kernel streamed through a running top-K, then an exact
                    float64 host rerank), or chunked host popcounts
                    (``compute_backend="numpy"``, the float64 oracle).
  - "amih"        — angular multi-index hashing (§5): the device walk
                    (``probe_backend="device"``, the default: ONE kernel
                    launch per batch plus at most one scan launch), or the
                    host walk (``probe_backend="host"``) with
                    ``verify_backend="cuda"`` (the default) or ``"numpy"``.

Backends and options of layers not ported yet raise
``NotImplementedError`` naming their ROADMAP item: ``single_table`` (A5),
``sharded_scan``/``sharded_amih`` (A6), ``cluster`` (A9) and
``overlap_verify=True`` (A7).

Both backends are EXACT and return, for every row, the reference's ids and
float64 sims. Entry points that need a device take ``device=``: ``None``
means the CUDA device (and raises where there is none); ``"cpu"`` runs the
kernels' plain PyTorch versions. Only the numpy scan and the host walk
with ``verify_backend="numpy"``, asked for explicitly, need no device.
"""

from __future__ import annotations

import abc
import sys
from collections import OrderedDict
from dataclasses import dataclass, field, fields as dc_fields, replace
from typing import Any, ClassVar, Dict, List, Optional, Tuple

import numpy as np

from ..kernels import ops
from ..obs import trace as _obs
from .amih import AMIHIndex, AMIHStats
from .linear_scan import sims_batch_against_db, sims_for_ids, topk_from_sims
from .packing import WORD_DTYPE, n_words

__all__ = [
    "ENGINES",
    "EngineStats",
    "SearchEngine",
    "SearchStats",
    "available_backends",
    "make_engine",
    "probe_cache_snapshot",
    "register_engine",
]

# backends of layers the port does not have yet -> their ROADMAP item
_NOT_PORTED = {
    "single_table": "A5",
    "sharded_scan": "A6",
    "sharded_amih": "A6",
    "cluster": "A9",
}


@dataclass
class SearchStats:
    """Per-query counters of the exhaustive scan (the reference's
    single-table ``SearchStats``; the scan fills ``retrieved``)."""

    probes: int = 0
    retrieved: int = 0
    tuples_processed: int = 0
    max_radius: int = 0
    exceeded_rhat: bool = False
    fell_back_to_scan: bool = False


@dataclass
class EngineStats:
    """Batched-search accounting: one stats object per query row plus
    lazily-aggregated totals (``aggregate`` sums every numeric counter;
    bools count occurrences; ``max_radius`` aggregates with max).
    ``cache_hits`` counts rows answered from the engine's hot-query cache;
    ``cache_info`` snapshots the process-wide probing caches. Streaming
    serving (``pipeline.stream``) fills ``queue_depth`` (queries still
    waiting behind the step) and ``latency_ms`` (rolling answered-query
    latency percentiles); both keep their defaults for direct
    ``knn_batch`` calls."""

    backend: str
    queries: int = 0
    per_query: List[Optional[object]] = field(default_factory=list)
    cache_hits: int = 0
    cache_info: Dict[str, int] = field(default_factory=dict)
    queue_depth: int = 0
    latency_ms: Dict[str, float] = field(default_factory=dict)

    _MAX_COUNTERS = frozenset({"max_radius"})

    def aggregate(self) -> Dict[str, int]:
        totals: Dict[str, int] = {}
        for s in self.per_query:
            if s is None:
                continue
            for f in dc_fields(s):
                v = getattr(s, f.name)
                if not isinstance(v, (bool, int, np.bool_, np.integer)):
                    continue
                if f.name in self._MAX_COUNTERS:
                    totals[f.name] = max(totals.get(f.name, 0), int(v))
                else:
                    totals[f.name] = totals.get(f.name, 0) + int(v)
        return totals

    def total(self, counter: str) -> int:
        return self.aggregate().get(counter, 0)


class SearchEngine(abc.ABC):
    """Exact batched angular-KNN engine over packed binary codes."""

    name: ClassVar[str]

    #: the Tracer handed to ``make_engine(..., tracer=...)``, if any
    tracer = None

    @classmethod
    @abc.abstractmethod
    def build(
        cls, db_words: np.ndarray, p: int, **cfg: Any
    ) -> "SearchEngine":
        ...

    @abc.abstractmethod
    def knn_batch(
        self, q_words: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray, EngineStats]:
        """Exact batched angular KNN: (B, W) packed queries ->
        (ids (B, k'), sims (B, k'), stats) with k' = min(k, n); ids are
        int64 row indices sorted by descending float64 sim."""
        ...

    @property
    @abc.abstractmethod
    def n(self) -> int:
        ...

    def _check_queries(self, q_words: np.ndarray, p: int) -> np.ndarray:
        q = np.atleast_2d(np.asarray(q_words, dtype=WORD_DTYPE))
        if q.ndim != 2 or q.shape[1] != n_words(p):
            raise ValueError(
                f"queries must be (B, {n_words(p)}) packed words for "
                f"p={p}; got shape {np.asarray(q_words).shape}"
            )
        return np.ascontiguousarray(q)


def probe_cache_snapshot() -> Dict[str, int]:
    """Occupancy + lifetime hit/miss counters of the process-wide probing
    caches: the (p, z) sequence cache, plus the device schedule cache once
    the device path has been imported."""
    from .probing import _cache_stats

    out: Dict[str, int] = dict(_cache_stats())
    mod = sys.modules.get(__package__ + ".probe_device")
    if mod is not None:
        out.update(mod.schedule_cache_stats())
    return out


ENGINES: Dict[str, type] = {}


def register_engine(cls: type) -> type:
    ENGINES[cls.name] = cls
    return cls


def available_backends() -> List[str]:
    return sorted(ENGINES)


def make_engine(
    backend: str, db_words: np.ndarray, p: int, **cfg: Any
) -> SearchEngine:
    """Build a search engine by backend name.

    ``db_words`` is the packed (n, W) uint32 code array, ``p`` the code
    length in bits; ``cfg`` goes to the backend's ``build`` (unknown keys
    raise ``TypeError``):

      - "linear_scan" — ``compute_backend`` ("cuda" | "numpy"),
                        ``device``, ``chunk`` (rows per host chunk of
                        the numpy scan).
      - "amih"        — ``m``, ``verify_backend`` ("cuda" | "numpy"),
                        ``probe_backend`` ("device" | "host"),
                        ``probe_fused``, ``probe_stream_cap``,
                        ``enumeration_cap``, ``query_cache_size``,
                        ``device``.

    ``tracer=`` (a ``repro_torch.obs.trace.Tracer``) is installed as the
    process tracer and attached to the engine as ``engine.tracer``.
    """
    tracer = cfg.pop("tracer", None)
    if tracer is not None:
        _obs.set_tracer(tracer)
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet: "
            f"ROADMAP {_NOT_PORTED[backend]}"
        )
    cls = ENGINES.get(backend)
    if cls is None:
        raise ValueError(
            f"unknown search backend {backend!r}; "
            f"available: {available_backends()}"
        )
    eng = cls.build(db_words, p, **cfg)
    eng.tracer = tracer
    return eng


@register_engine
class LinearScanEngine(SearchEngine):
    """Exhaustive baseline: batched Eq. 3 sims + per-row deterministic
    top-k (the selection code of ``linear_scan_knn``).

    ``compute_backend`` selects the scoring path:

      - "cuda"  — the device top-K ``kernels.ops.scan_topk`` (the fused
        K4 top-k kernel, or its plain version on ``device="cpu"``) over a
        copy of the codes on ``device``, uploaded once. The device preselects
        ``k + slack`` candidates in float32; their sims are recomputed on
        the host in float64 (``sims_for_ids``) and re-ranked, so the
        returned (ids, sims) equal ``linear_scan_knn``'s bit for bit. The
        reference calls this backend "pallas".
      - "numpy" — chunked host popcounts in float64 (no device).
    """

    name = "linear_scan"

    # Cap on live sims-matrix elements of the numpy scan: query rows are
    # processed in groups of max(1, _SIMS_BUDGET // n) so peak scratch
    # stays ~64 MB.
    _SIMS_BUDGET = 1 << 23

    # Device preselect slack: candidates fetched beyond k so float32
    # rounding at the selection boundary cannot evict a true top-k item
    # (distinct Eq. 3 sims differ by more than float32 resolution for
    # p <= ~192; beyond that the slack grows with p). The reference's rule.
    @property
    def _topk_slack(self) -> int:
        return 16 + max(0, self.p - 128) // 4

    def __init__(self, db_words: np.ndarray, p: int, chunk: int,
                 compute_backend: str = "cuda", device=None):
        self.db_words = np.ascontiguousarray(db_words, dtype=WORD_DTYPE)
        self.p = p
        self.chunk = chunk
        self.compute_backend = compute_backend
        self.device = device
        self._db_dev = None   # codes on the device, uploaded on first use

    @classmethod
    def build(
        cls,
        db_words: np.ndarray,
        p: int,
        chunk: int = 1 << 15,
        compute_backend: str = "cuda",
        device=None,
        **cfg: Any,
    ) -> "LinearScanEngine":
        if cfg:
            raise TypeError(f"unknown linear_scan options: {sorted(cfg)}")
        if compute_backend not in ("cuda", "numpy"):
            raise ValueError(
                f"unknown compute_backend {compute_backend!r}: the port's "
                f"are 'cuda' (the reference's 'pallas') and 'numpy'"
            )
        if compute_backend == "cuda":
            device = ops.resolve_device(device)
        return cls(db_words, p, chunk, compute_backend, device)

    @property
    def n(self) -> int:
        return self.db_words.shape[0]

    def knn_batch(self, q_words, k):
        q = self._check_queries(q_words, self.p)
        B = q.shape[0]
        k_eff = min(k, self.n)
        with _obs.current().span("engine.knn_batch", cat="engine",
                                 backend=self.name, B=B, k=k_eff):
            if self.compute_backend == "cuda" and k_eff > 0:
                ids_out, sims_out = self._knn_batch_device(q, k_eff)
            else:
                ids_out, sims_out = self._knn_batch_host(q, k_eff)
            stats = EngineStats(
                backend=self.name, queries=B,
                per_query=[SearchStats(retrieved=self.n) for _ in range(B)],
            )
            return ids_out, sims_out, stats

    def _knn_batch_host(self, q, k_eff):
        B = q.shape[0]
        ids_out = np.empty((B, k_eff), dtype=np.int64)
        sims_out = np.empty((B, k_eff), dtype=np.float64)
        group = max(1, self._SIMS_BUDGET // max(self.n, 1))
        for lo in range(0, B, group):
            sims = sims_batch_against_db(
                q[lo : lo + group], self.db_words, chunk=self.chunk
            )
            for i in range(sims.shape[0]):
                ids_out[lo + i], sims_out[lo + i] = topk_from_sims(
                    sims[i], k_eff
                )
        return ids_out, sims_out

    def _knn_batch_device(self, q, k_eff):
        """Device top-K preselect (one fused K4 call) + exact float64 host
        rerank. The fetch size is padded to a power-of-two bucket as in the
        reference; the batch is not (the reference pads it with zero rows
        for its trace cache, and no row's result depends on another's)."""
        if self._db_dev is None:
            self._db_dev = ops.to_device(self.db_words, self.device)
        B = q.shape[0]
        k_fetch = min(
            self.n, ops.pad_bucket(k_eff + self._topk_slack, minimum=8)
        )
        _, ids32 = ops.scan_topk(ops.to_device(q, self.device),
                                 self._db_dev, k_fetch)
        fetched = ids32.cpu().numpy().astype(np.int64)       # (B, k_fetch)
        ids_out = np.empty((B, k_eff), dtype=np.int64)
        sims_out = np.empty((B, k_eff), dtype=np.float64)
        for i in range(B):
            cand = fetched[i]
            sub = sims_for_ids(q[i], self.db_words, cand)    # exact float64
            order = np.lexsort((cand, -sub))[:k_eff]
            ids_out[i] = cand[order]
            sims_out[i] = sub[order]
        return ids_out, sims_out


@register_engine
class AMIHEngine(SearchEngine):
    """Angular multi-index hashing (paper §5): batch-aware probing with
    per-(p, z) probing-sequence sharing, on the host walk or the device
    walk.

    ``enumeration_cap`` bounds a single substring-tuple's bucket
    enumeration on the host walk before the query degrades to an exact
    full scan (default ``max(8n, 16384)``).

    Hot-query cache: ``knn_batch`` memoizes per (code bytes, k) in a
    bounded LRU (``query_cache_size`` entries, 0 disables). Hits skip
    probing entirely and are counted in ``EngineStats.cache_hits``; the
    cached counters are replayed (copied) so per-query accounting stays
    identical to an uncached run. Duplicate rows inside one batch are
    computed once.
    """

    name = "amih"

    def __init__(self, index: AMIHIndex, enumeration_cap,
                 query_cache_size: int = 256):
        self.index = index
        self.p = index.p
        self.enumeration_cap = enumeration_cap
        self.query_cache_size = query_cache_size
        # (q_words bytes, k) -> (ids row, sims row, AMIHStats); ordered
        # oldest-first so popitem(last=False) evicts the LRU entry.
        self._query_cache: "OrderedDict[Tuple[bytes, int], tuple]" = (
            OrderedDict()
        )
        self.cache_hits = 0

    @classmethod
    def build(
        cls,
        db_words: np.ndarray,
        p: int,
        m: Optional[int] = None,
        verify_backend: str = "cuda",
        enumeration_cap: Optional[int] = None,
        query_cache_size: int = 256,
        overlap_verify: bool = False,
        probe_backend: str = "device",
        probe_stream_cap: int = 1 << 16,
        probe_fused: bool = True,
        device=None,
        **cfg: Any,
    ) -> "AMIHEngine":
        if cfg:
            raise TypeError(f"unknown amih options: {sorted(cfg)}")
        if overlap_verify:
            raise NotImplementedError(
                "overlap_verify=True (the pipelined verify) is not ported "
                "yet: ROADMAP A7"
            )
        n = np.asarray(db_words).shape[0]
        if enumeration_cap is None:
            enumeration_cap = max(8 * n, 1 << 14)
        index = AMIHIndex.build(
            db_words, p, m=m, verify_backend=verify_backend,
            probe_backend=probe_backend, probe_stream_cap=probe_stream_cap,
            probe_fused=probe_fused, device=device,
        )
        return cls(index, enumeration_cap, query_cache_size)

    @property
    def n(self) -> int:
        return self.index.n

    def knn_batch(self, q_words, k):
        q = self._check_queries(q_words, self.p)
        B = q.shape[0]
        k_eff = min(k, self.n)
        with _obs.current().span("engine.knn_batch", cat="engine",
                                 backend=self.name, B=B, k=k_eff):
            return self._knn_batch_traced(q, B, k_eff)

    def _knn_batch_traced(self, q, B, k_eff):
        cache = self._query_cache if self.query_cache_size > 0 else None
        per_query: List[Optional[AMIHStats]] = [None] * B
        ids_out = np.empty((B, k_eff), dtype=np.int64)
        sims_out = np.empty((B, k_eff), dtype=np.float64)
        hits = 0
        miss_keys: Dict[bytes, List[int]] = {}
        for i in range(B):
            key = q[i].tobytes()
            cached = cache.get((key, k_eff)) if cache is not None else None
            if cached is not None:
                cache.move_to_end((key, k_eff))
                c_ids, c_sims, c_stats = cached
                ids_out[i], sims_out[i] = c_ids, c_sims
                per_query[i] = replace(c_stats)
                hits += 1
            else:
                miss_keys.setdefault(key, []).append(i)

        if miss_keys:
            rows = [idxs[0] for idxs in miss_keys.values()]
            miss_stats = [AMIHStats() for _ in rows]
            m_ids, m_sims = self.index.knn_batch(
                q[rows], k_eff, stats=miss_stats,
                enumeration_cap=self.enumeration_cap,
            )
            for j, (key, idxs) in enumerate(miss_keys.items()):
                for i in idxs:
                    ids_out[i], sims_out[i] = m_ids[j], m_sims[j]
                    per_query[i] = replace(miss_stats[j])
                if cache is not None:
                    cache[(key, k_eff)] = (
                        m_ids[j].copy(), m_sims[j].copy(), miss_stats[j]
                    )
                    while len(cache) > self.query_cache_size:
                        cache.popitem(last=False)

        self.cache_hits += hits
        return ids_out, sims_out, EngineStats(
            backend=self.name, queries=B, per_query=per_query,
            cache_hits=hits, cache_info=probe_cache_snapshot(),
        )
