"""Streaming search serving: tickets, per-step results, latency counters
(a copy of the reference's ``pipeline/stream.py`` on the port's ``obs``).

``stream_search`` drives a ``SearchEngine`` over a sequence of query
batches through a two-stage pipeline (encode -> search) and yields a
``StepResult`` per batch step AS IT COMPLETES: batch ``i+1`` encodes on
the device while batch ``i`` searches, and callers consume results while
later steps are still in flight. This is the serving loop of
``RetrievalService.run_queued(stream=True)``.

``Ticket`` is the handle ``RetrievalService.submit`` returns: an
int-compatible query id carrying a ``concurrent.futures.Future`` that
resolves to ``(ids, sims)`` when the query's batch step completes, plus
its submission timestamp for queueing-latency accounting.

Each yielded step's ``EngineStats`` carries ``queue_depth`` (queries
still waiting behind this step); the retrieval service stamps
``latency_ms`` (rolling p50/p99 over answered queries) on it.
"""

from __future__ import annotations

import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from ..obs import trace as _obs
from ..obs.metrics import REGISTRY as _REG, Histogram
from .stages import Stage, StagedExecutor

__all__ = ["LatencyTracker", "StepResult", "Ticket", "stream_search"]


class Ticket:
    """Handle for one submitted query: an int-compatible qid plus a
    future resolving to ``(ids, sims)``. Hashes and compares equal to its
    qid, so dicts keyed by the old integer qids accept tickets and vice
    versa."""

    __slots__ = ("qid", "future", "submitted_at")

    def __init__(self, qid: int):
        self.qid = qid
        self.future: Future = Future()
        self.submitted_at = time.perf_counter()

    def result(self, timeout: Optional[float] = None):
        """Block until the query's batch step completes; returns
        (ids, sims)."""
        return self.future.result(timeout)

    def __int__(self) -> int:
        return self.qid

    __index__ = __int__

    def __hash__(self) -> int:
        return hash(self.qid)

    def __eq__(self, other) -> bool:
        if isinstance(other, Ticket):
            return self.qid == other.qid
        if isinstance(other, int):
            return self.qid == other
        return NotImplemented

    def __repr__(self) -> str:
        state = "done" if self.future.done() else "pending"
        return f"Ticket(qid={self.qid}, {state})"


class LatencyTracker(Histogram):
    """Rolling latency percentiles over answered queries (thread-safe).

    A ``repro.obs.metrics.Histogram`` (same bounded window, same locks)
    keeping its historical snapshot shape: interpolated np.percentile
    values rounded to 4 places with a float ``count`` — the dict that
    lands on ``EngineStats.latency_ms``. Dashboards want recent p50/p99,
    not all-time, so only the last ``window`` samples score.
    """

    def __init__(self, window: int = 4096):
        super().__init__(window)

    def record(self, ms: float, count: int = 1) -> None:
        super().record(float(ms), count)

    def snapshot(self) -> Dict[str, float]:
        """{"p50": ..., "p99": ..., "mean": ..., "count": ...} in ms over
        the current window; empty dict before the first sample."""
        with self._lock:
            if not self._samples:
                return {}
            arr = np.asarray(self._samples, dtype=np.float64)
            return {
                "p50": round(float(np.percentile(arr, 50)), 4),
                "p99": round(float(np.percentile(arr, 99)), 4),
                "mean": round(float(arr.mean()), 4),
                "count": float(self._count),
            }


@dataclass
class StepResult:
    """One completed batch step of a streaming search."""

    step: int                     # step index in submission order
    ids: np.ndarray               # (B_step, k')
    sims: np.ndarray              # (B_step, k')
    stats: Any                    # EngineStats with serving counters set
    latency_ms: float             # enqueue -> completion for this step
    # service-level view (filled by RetrievalService): qid -> (ids, sims)
    results: Dict[int, Tuple[np.ndarray, np.ndarray]] = field(
        default_factory=dict
    )


def stream_search(
    engine,
    batches: Sequence,
    k: int,
    encode: Callable[[Any], np.ndarray],
) -> Iterator[StepResult]:
    """Pipeline ``batches`` through encode -> ``engine.knn_batch`` and
    yield a ``StepResult`` per batch, in order, as each completes.

    ``batches`` is a sequence of per-step payloads; ``encode`` maps a
    payload to packed (B, W) query words. Encoding of step ``i+1``
    overlaps the search of step ``i`` (one worker thread each, see
    stages.StagedExecutor). Per-step latency is measured from pipeline
    enqueue to step completion; ``stats.latency_ms`` is left to the
    caller, which stamps its own definition (the retrieval service uses
    true submit -> resolve latency).
    """
    batches = list(batches)
    # queries waiting strictly behind step i (queue depth when i answers)
    sizes = [len(b) for b in batches]
    behind = np.concatenate([np.cumsum(sizes[::-1])[::-1][1:], [0]]) \
        if sizes else np.zeros(0)
    enqueue_t: Dict[int, float] = {}

    def _enc(item):
        i, payload = item
        return i, encode(payload)

    def _search(item):
        i, q = item
        ids, sims, stats = engine.knn_batch(q, k)
        return i, ids, sims, stats

    def _feed():
        for i, payload in enumerate(batches):
            enqueue_t[i] = time.perf_counter()
            yield (i, payload)

    with StagedExecutor(
        [Stage("encode", _enc), Stage("search", _search)],
        name="serve",
    ) as ex:
        tr = _obs.current()
        for i, ids, sims, stats in ex.map(_feed()):
            done_t = time.perf_counter()
            lat_ms = 1e3 * (done_t - enqueue_t[i])
            if tr.enabled:
                # enqueue_t and now_us share the perf_counter clock
                tr.record("serve.step", enqueue_t[i] * 1e6, done_t * 1e6,
                          cat="serve", step=i, B=int(ids.shape[0]))
            _REG.histogram("serve.latency_ms").record(
                lat_ms, count=max(1, ids.shape[0])
            )
            stats.queue_depth = int(behind[i])
            yield StepResult(
                step=i, ids=ids, sims=sims, stats=stats,
                latency_ms=lat_ms,
            )
