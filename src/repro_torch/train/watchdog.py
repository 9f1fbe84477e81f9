"""Straggler detection: trailing-median step-time watchdog (a copy of the
reference's ``train/watchdog.py``, which is plain Python).

At 1000+ nodes, slow hosts (thermal throttling, failing HBM, noisy
neighbors) stretch every synchronous step. The watchdog tracks a trailing
median of per-step wall times and flags any observation exceeding
``threshold x median``. In a multi-host deployment the flag handler
re-assigns the slow host's data shard and schedules the host for drain;
here the handler is a callback so tests/simulations can observe decisions.

Also used to drive *proactive checkpointing*: repeated flags raise
``should_checkpoint`` so work is persisted before a likely failure.
"""

from __future__ import annotations

import statistics
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional

__all__ = ["StragglerWatchdog", "StragglerEvent"]


@dataclass
class StragglerEvent:
    step: int
    host: int
    duration_s: float
    median_s: float
    ratio: float


@dataclass
class StragglerWatchdog:
    window: int = 50              # trailing window of step times
    threshold: float = 2.0        # flag if step > threshold * median
    warmup: int = 5               # ignore the first few (compile) steps
    escalate_after: int = 3       # consecutive flags -> escalate
    on_flag: Optional[Callable[[StragglerEvent], None]] = None

    _times: Deque[float] = field(default_factory=deque, repr=False)
    _seen: int = 0
    _consecutive: int = 0
    events: List[StragglerEvent] = field(default_factory=list)

    def observe(self, step: int, duration_s: float, host: int = 0) -> bool:
        """Record one step time. Returns True if flagged as straggler."""
        self._seen += 1
        if self._seen <= self.warmup:
            return False
        flagged = False
        if len(self._times) >= max(3, self.window // 10):
            med = statistics.median(self._times)
            if med > 0 and duration_s > self.threshold * med:
                ev = StragglerEvent(
                    step=step,
                    host=host,
                    duration_s=duration_s,
                    median_s=med,
                    ratio=duration_s / med,
                )
                self.events.append(ev)
                if self.on_flag is not None:
                    self.on_flag(ev)
                self._consecutive += 1
                flagged = True
        if not flagged:
            self._consecutive = 0
            # only healthy samples update the baseline, so a degrading host
            # cannot drag the median up and mask itself
            self._times.append(duration_s)
            while len(self._times) > self.window:
                self._times.popleft()
        return flagged

    @property
    def should_escalate(self) -> bool:
        return self._consecutive >= self.escalate_after

    @property
    def median_s(self) -> float:
        return statistics.median(self._times) if self._times else 0.0
