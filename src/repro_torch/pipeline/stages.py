"""StagedExecutor: a small software pipeline over thread pools (a copy of
the reference's ``pipeline/stages.py`` on the port's ``obs``).

Serving a search query is a chain of stages that alternate between the
device and the host — encode (device) -> probe (host) -> verify (device)
-> merge/emit (host). Run sequentially, each resource idles while the
other works; run as a pipeline, stage ``s`` of item ``i`` overlaps stage
``s+1`` of item ``i-1``. Threads are the right vehicle here because every
stage either releases the GIL (NumPy popcounts, torch dispatch/transfer) or
is a device call, and all shared structures (tables, packed DBs) are
read-only.

Each stage owns ONE worker thread, so a stage processes items strictly in
submission order (per-stage FIFO — results come back in order, no
reordering logic needed) while different stages run different items
concurrently, as in double buffering. An item's
stage-``s`` task blocks on its stage-``s-1`` future; since the worker
could not run anything else anyway (FIFO), that wait costs nothing.

``map`` keeps at most ``2 * n_stages`` items in flight: the producer is throttled by yielding finished items,
so an unbounded input stream never piles up unbounded intermediate
buffers. A stage exception propagates to the consumer at the failed
item's position in the output order; later items may still run their
early stages (their results are discarded by the raised iteration).
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence

from ..obs import trace as _obs

__all__ = ["Stage", "StagedExecutor"]


@dataclass(frozen=True)
class Stage:
    """One pipeline stage: a name (thread/debug label) and a callable
    ``fn(x) -> y`` mapping the previous stage's output to this one's."""

    name: str
    fn: Callable[[Any], Any]


class StagedExecutor:
    """Run items through a chain of stages with cross-stage overlap.

    >>> ex = StagedExecutor([Stage("enc", enc), Stage("search", knn)])
    >>> for out in ex.map(batches):
    ...     consume(out)          # in submission order
    >>> ex.close()

    Also usable as a context manager. ``submit`` returns the final-stage
    future for callers that want to drive completion themselves.
    """

    def __init__(
        self,
        stages: Sequence[Stage],
        name: str = "pipeline",
    ):
        if not stages:
            raise ValueError("StagedExecutor needs at least one stage")
        self.stages: List[Stage] = list(stages)
        self.window = 2 * len(self.stages)
        self._pools = [
            ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"{name}-{s.name}"
            )
            for s in self.stages
        ]
        self._closed = False

    # ------------------------------------------------------------ plumbing
    @staticmethod
    def _run_stage(name, fn, prev: Optional[Future], item):
        """Stage body: wait for the upstream result (FIFO worker — nothing
        else could run meanwhile), then apply this stage. The span covers
        only this stage's own work, not the upstream wait — queueing time
        would otherwise inflate every downstream stage's cost."""
        x = item if prev is None else prev.result()
        with _obs.current().span(f"stage.{name}", cat="pipeline"):
            return fn(x)

    def submit(self, item) -> Future:
        """Push one item through every stage; returns the LAST stage's
        future (exceptions from any stage surface on it)."""
        if self._closed:
            raise RuntimeError("StagedExecutor is closed")
        fut: Optional[Future] = None
        for stage, pool in zip(self.stages, self._pools):
            fut = pool.submit(self._run_stage, stage.name, stage.fn, fut,
                              item)
            item = None   # only the first stage sees the raw item
        assert fut is not None
        return fut

    def map(self, items: Iterable) -> Iterator:
        """Pipeline ``items`` through the stages, yielding final-stage
        results in submission order, at most ``self.window`` items in
        flight."""
        inflight: deque = deque()
        for item in items:
            inflight.append(self.submit(item))
            while len(inflight) >= self.window:
                yield inflight.popleft().result()
        while inflight:
            yield inflight.popleft().result()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            for pool in self._pools:
                pool.shutdown(wait=True)

    def __enter__(self) -> "StagedExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
