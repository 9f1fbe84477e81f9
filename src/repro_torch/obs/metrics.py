"""Process-wide metrics registry: counters + bounded histograms.

One named surface for the port's counters: every kernel launch bumps
``launches.<op>`` here (kernels/ops.py) and the probing-sequence cache
counts its hits and misses under ``cache.*``. Pure stdlib — percentiles
are nearest-rank over a bounded sample window, no numpy. The port keeps
its own registry: its counters never mix with the reference package's.

Thread safety: every mutation takes the instrument's own lock; the
registry lock only guards name → instrument creation, so two threads
bumping different counters never contend.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional

__all__ = ["Counter", "Histogram", "MetricsRegistry", "REGISTRY"]


class Counter:
    """Monotonic (well, add-anything) integer counter."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def set(self, n: int) -> None:
        with self._lock:
            self._value = int(n)

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


def _percentile(sorted_samples: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list (q in [0,1])."""
    n = len(sorted_samples)
    idx = min(n - 1, max(0, int(round(q * (n - 1)))))
    return sorted_samples[idx]


class Histogram:
    """Bounded rolling window of samples with percentile snapshots.

    Keeps the most recent ``window`` samples (older ones age out, so a
    long-running server reports RECENT latency, not lifetime latency)
    plus lifetime count/sum so totals survive the trim.
    """

    __slots__ = ("window", "_samples", "_count", "_sum", "_max", "_lock")

    def __init__(self, window: int = 4096) -> None:
        self.window = int(window)
        self._samples: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._max = float("-inf")
        self._lock = threading.Lock()

    def record(self, value: float, count: int = 1) -> None:
        """Add ``value`` (``count`` duplicate samples at once mirrors
        LatencyTracker's batch-amortized recording)."""
        v = float(value)
        with self._lock:
            self._samples.extend([v] * count)
            extra = len(self._samples) - self.window
            if extra > 0:
                del self._samples[:extra]
            self._count += count
            self._sum += v * count
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def snapshot(self) -> Dict[str, float]:
        """{} when no samples yet; else nearest-rank p50/p99 over the
        window plus window mean, lifetime count, and lifetime max."""
        with self._lock:
            if not self._samples:
                return {}
            srt = sorted(self._samples)
            return {
                "p50": round(_percentile(srt, 0.50), 3),
                "p99": round(_percentile(srt, 0.99), 3),
                "mean": round(sum(srt) / len(srt), 3),
                "max": round(self._max, 3),
                "count": self._count,
            }


class MetricsRegistry:
    """Name → Counter/Histogram, created on first touch."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------- instruments
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(window))
        return h

    # ------------------------------------------------------------ reads
    def value(self, name: str) -> int:
        """Counter value; 0 for a counter that was never bumped."""
        c = self._counters.get(name)
        return 0 if c is None else c.value

    def values(self, prefix: str = "") -> Dict[str, int]:
        """All counter values whose name starts with ``prefix``."""
        with self._lock:
            names = [n for n in self._counters if n.startswith(prefix)]
        return {n: self._counters[n].value for n in names}

    def snapshot(self) -> Dict[str, Any]:
        """Flat dict of every counter value and histogram snapshot."""
        out: Dict[str, Any] = {}
        with self._lock:
            counters = list(self._counters.items())
            histograms = list(self._histograms.items())
        for name, c in counters:
            out[name] = c.value
        for name, h in histograms:
            snap = h.snapshot()
            if snap:
                out[name] = snap
        return out

    def dump_jsonl(self, path: str) -> None:
        """One JSON line per metric — greppable, appendable."""
        snap = self.snapshot()
        with open(path, "w") as f:
            for name in sorted(snap):
                f.write(json.dumps({"metric": name, "value": snap[name]})
                        + "\n")

    def reset(self, prefix: Optional[str] = None) -> None:
        """Zero counters and drop histograms (tests; ``prefix`` scopes
        the reset)."""
        with self._lock:
            for name, c in self._counters.items():
                if prefix is None or name.startswith(prefix):
                    c.set(0)
            if prefix is None:
                self._histograms.clear()
            else:
                for name in [n for n in self._histograms
                             if n.startswith(prefix)]:
                    del self._histograms[name]


#: The process-wide registry every instrumented layer writes to.
REGISTRY = MetricsRegistry()
