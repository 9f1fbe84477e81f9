"""Probing-sequence generation (paper §4, RQ1, Props 1–3).

Produces Hamming-distance tuples in monotonically non-increasing order of
cosine similarity, using the paper's priority-queue + two-anchor algorithm:

- popping tuple R = (x, y) pushes
  * the **first anchor**: the max-sim tuple at distance x+y+1, i.e.
    ``(c, x+y+1-c)`` with ``c = max(0, x+y+1-(p-z))`` (Prop. 1), and
  * the **second anchor**: ``(x+1, y-1)`` — the next tuple at the same
    distance in decreasing-sim direction (Prop. 1),
  each pushed iff valid and not yet traversed.

We initialize the queue with (0, 0) (the query's own bucket): the paper's
closed-form phase for r <= rhat (Prop. 2) is an optimization of the same
order, which we also implement (``closed_form_prefix``) and property-test
for agreement. Priorities are exact rationals (sim^2 as Fraction) so tuple
ordering is never corrupted by floating point; ties are broken by
(ascending Hamming distance, ascending r1) for determinism.

Degenerate queries: z == 0 makes cosine undefined for every code; we fall
back to Hamming ordering (tuples are (0, r2), emitted by ascending r2), the
natural limit. Codes that are themselves the zero vector sort last.
"""

from __future__ import annotations

import heapq
import threading
from collections import OrderedDict
from fractions import Fraction
from typing import Iterator, List, Optional, Tuple

from ..obs.metrics import REGISTRY as _REG
from .tuples import is_valid_tuple, rhat, sim_squared_fraction

__all__ = [
    "probing_sequence",
    "closed_form_prefix",
    "first_anchor",
    "second_anchor",
    "probing_prefix",
    "shared_probing_iter",
]


def first_anchor(p: int, z: int, x: int, y: int) -> Optional[Tuple[int, int]]:
    """Max-sim tuple at Hamming distance x+y+1 (paper Def. 5a)."""
    d = x + y + 1
    c = max(0, d - (p - z))
    t = (c, d - c)
    return t if is_valid_tuple(p, z, *t) else None


def second_anchor(p: int, z: int, x: int, y: int) -> Optional[Tuple[int, int]]:
    """Next-smaller-sim tuple at the same Hamming distance (paper Def. 5b)."""
    t = (x + 1, y - 1)
    return t if is_valid_tuple(p, z, *t) else None


def _priority(p: int, z: int, t: Tuple[int, int]):
    """Heap key: max-sim first; exact; deterministic tie-break."""
    r1, r2 = t
    if z == 0:
        # Hamming order on the zero query: only (0, r2) tuples are valid.
        return (Fraction(r2), 0, 0)
    return (-sim_squared_fraction(p, z, r1, r2), r1 + r2, r1)


def probing_sequence(
    p: int, z: int, limit: Optional[int] = None
) -> Iterator[Tuple[int, int]]:
    """Yield all valid tuples for (p, z) in non-increasing sim order.

    ``limit`` caps the number of tuples yielded (None = all
    (z+1)*(p-z+1) of them).
    """
    if not 0 <= z <= p:
        raise ValueError(f"need 0 <= z <= p, got z={z}, p={p}")
    start = (0, 0)
    heap = [(_priority(p, z, start), start)]
    traversed = {start}
    emitted = 0
    while heap:
        _, (x, y) = heapq.heappop(heap)
        yield (x, y)
        emitted += 1
        if limit is not None and emitted >= limit:
            return
        for anchor in (first_anchor(p, z, x, y), second_anchor(p, z, x, y)):
            if anchor is not None and anchor not in traversed:
                traversed.add(anchor)
                heapq.heappush(heap, (_priority(p, z, anchor), anchor))


def closed_form_prefix(p: int, z: int):
    """The provably-sorted prefix for r <= rhat (Props. 1–2, t=1).

    Within the Hamming ball C(q, rhat), sim strictly decreases with the
    Hamming distance, and within one distance r the order is
    (0, r), (1, r-1), ..., (r, 0). Returns the list of valid tuples in
    that closed-form order.
    """
    out = []
    for r in range(rhat(z) + 1):
        for r1 in range(r + 1):
            t = (r1, r - r1)
            if is_valid_tuple(p, z, *t):
                out.append(t)
    return out


# --------------------------------------------------------------- shared cache
# The sequence depends only on (p, z) — not on the query, the index, or the
# shard — so materialized prefixes are cached at MODULE level and shared by
# every AMIHIndex in the process: a sharded engine with S shards enumerates
# each (p, z) once instead of S times, and the device probe path reads its
# walk arrays straight out of the same entries. The cache is a bounded LRU
# (whole (p, z) entries are evicted, never truncated) and is thread-safe:
# thread-mode shard probing extends entries concurrently.

class _SeqEntry:
    """One (p, z) entry: the materialized prefix plus the live generator
    that extends it. ``prefix`` is append-only — index-based readers can
    scan it without the lock; only extension takes ``_SEQ_LOCK``."""

    __slots__ = ("prefix", "gen", "exhausted")

    def __init__(self, p: int, z: int):
        self.prefix: List[Tuple[int, int]] = []
        self.gen = probing_sequence(p, z)
        self.exhausted = False

    def extend_to(self, count: int) -> None:
        """Materialize at least ``count`` tuples (or until exhaustion).
        Caller must hold ``_SEQ_LOCK``."""
        while len(self.prefix) < count and not self.exhausted:
            try:
                self.prefix.append(next(self.gen))
            except StopIteration:
                self.exhausted = True


_SEQ_CACHE: "OrderedDict[Tuple[int, int], _SeqEntry]" = OrderedDict()
_SEQ_CACHE_MAX = 64
_SEQ_LOCK = threading.RLock()
# process-lifetime hit/miss counters (see _cache_stats): a miss is
# one (p, z) enumeration from scratch, so hits/(hits+misses) is the share
# of probing-sequence work the cache absorbed
_SEQ_HITS = 0
_SEQ_MISSES = 0


def _seq_entry(p: int, z: int) -> _SeqEntry:
    """The shared cache entry for (p, z) (LRU-touched; caller need not hold
    the lock — entry internals are guarded separately)."""
    global _SEQ_HITS, _SEQ_MISSES
    with _SEQ_LOCK:
        entry = _SEQ_CACHE.get((p, z))
        if entry is None:
            _SEQ_MISSES += 1
            _REG.counter("cache.probing.misses").add(1)
            entry = _SeqEntry(p, z)
            _SEQ_CACHE[(p, z)] = entry
        else:
            _SEQ_HITS += 1
            _REG.counter("cache.probing.hits").add(1)
            _SEQ_CACHE.move_to_end((p, z))
        while len(_SEQ_CACHE) > _SEQ_CACHE_MAX:
            _SEQ_CACHE.popitem(last=False)
        return entry


def probing_prefix(p: int, z: int, count: int) -> List[Tuple[int, int]]:
    """The first ``count`` tuples of the (p, z) probing sequence (fewer if
    the walk is shorter), materialized once process-wide. The returned
    list is the live cache prefix — callers must treat it as read-only."""
    entry = _seq_entry(p, z)
    if len(entry.prefix) < count and not entry.exhausted:
        with _SEQ_LOCK:
            entry.extend_to(count)
    return entry.prefix


def shared_probing_iter(p: int, z: int) -> Iterator[Tuple[int, int]]:
    """Iterator over the (p, z) sequence backed by the shared cache:
    already-materialized tuples replay from the prefix list; going deeper
    extends it (under the lock) for every future consumer."""
    entry = _seq_entry(p, z)
    prefix = entry.prefix
    i = 0
    while True:
        if i >= len(prefix):
            with _SEQ_LOCK:
                entry.extend_to(i + 1)
            if i >= len(prefix):
                return
        yield prefix[i]
        i += 1


def _cache_stats() -> dict:
    """Occupancy plus process-lifetime hit/miss counters of the shared
    (p, z) sequence cache — surfaced through ``EngineStats.cache_info``
    and the benchmark rows so cache effectiveness is visible per cell.
    Hit/miss counters are mirrored into the metrics registry as
    ``cache.probing.hits`` / ``cache.probing.misses``."""
    with _SEQ_LOCK:
        return {
            "probing_entries": len(_SEQ_CACHE),
            "probing_tuples": sum(
                len(e.prefix) for e in _SEQ_CACHE.values()
            ),
            "probing_hits": _SEQ_HITS,
            "probing_misses": _SEQ_MISSES,
        }
