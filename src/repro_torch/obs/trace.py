"""Monotonic-clock spans with thread-local nesting and a no-op fast path.

The port's own tracer (stdlib only), a copy of the reference's, so the
port's ``launch.*`` spans land in a tracer that imports nothing else.

A span is a plain dict — ``{"name", "cat", "ts", "dur", "pid", "tid",
"host", "trace", "args"}`` with ``ts``/``dur`` in microseconds on the
``time.perf_counter`` clock — so spans cross fork pipes and the AMRP
wire as JSON without a serialization layer. On Linux ``perf_counter``
is CLOCK_MONOTONIC, which is system-wide: spans recorded in fork
children and spawned localhost workers land on the same timeline as
the parent without adjustment. Cross-host spans are shifted by the
coordinator's ping/pong clock-offset estimate at merge time
(``Tracer.ingest``).

Instrumentation contract: every hot-path site fetches the process
tracer once (``current()``) and checks ``.enabled`` — a single
attribute read — before touching the clock. The inner AMIH loop uses
explicit ``if tr.enabled:`` guards around ``now_us()``/``record()``;
colder sites use the ``span()`` context manager, which returns a
shared no-op object when tracing is off.

Sampling: ``sample`` is a probability applied when a TOP-LEVEL span
opens on a thread; the decision is inherited by every nested span, so
a sampled-out subtree vanishes whole and nesting invariants survive.
``record()`` (used for dispatch→resolve pairs whose endpoints live in
different call sites) bypasses the stack and is kept whenever tracing
is enabled.
"""

from __future__ import annotations

import os
import random
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

__all__ = [
    "NOOP_SPAN",
    "Tracer",
    "current",
    "disable",
    "enable",
    "new_trace_id",
    "now_us",
    "set_tracer",
]


def now_us() -> float:
    """Microseconds on the monotonic perf_counter clock."""
    return time.perf_counter() * 1e6


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


class _NoopSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _SpanCtx:
    """One live span; append-on-exit so children land before parents
    only by end time (Perfetto nests by interval containment)."""

    __slots__ = ("_tr", "name", "cat", "args", "_t0", "_keep", "_depth")

    def __init__(self, tr: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]], keep: bool, depth: int):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.args = args
        self._keep = keep
        self._depth = depth
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = now_us()
        return self

    def __exit__(self, *exc):
        t1 = now_us()
        tls = self._tr._tls
        tls.stack.pop()
        if self._keep:
            self._tr.record(self.name, self._t0, t1, cat=self.cat,
                            depth=self._depth, **(self.args or {}))
        return False


class Tracer:
    """Bounded process-wide span sink.

    ``enabled`` is the only attribute the hot path reads when tracing
    is off. ``max_spans`` bounds memory (and the size of span payloads
    shipped over pipes and result frames); overflow increments
    ``dropped`` instead of growing the buffer.
    """

    def __init__(self, enabled: bool = False, sample: float = 1.0,
                 host: str = "local", trace_id: Optional[str] = None,
                 max_spans: int = 262144):
        self.enabled = bool(enabled)
        self.sample = float(sample)
        self.host = str(host)
        self.trace_id = trace_id or new_trace_id()
        self.max_spans = int(max_spans)
        self.dropped = 0
        self._spans: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._rng = random.Random()

    # ------------------------------------------------------------ spans
    def span(self, name: str, cat: str = "span",
             **args: Any):
        """Context manager for a nested span. No-op when disabled or
        when the enclosing top-level span was sampled out."""
        if not self.enabled:
            return NOOP_SPAN
        tls = self._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        if stack:
            keep = stack[-1]
        elif self.sample >= 1.0:
            keep = True
        else:
            keep = self._rng.random() < self.sample
        stack.append(keep)
        return _SpanCtx(self, name, cat, args or None, keep,
                        len(stack) - 1)

    def record(self, name: str, t0_us: float, t1_us: float,
               cat: str = "span", **args: Any) -> None:
        """Append a completed span from explicit timestamps (dispatch →
        resolve pairs measure their endpoints manually)."""
        if not self.enabled:
            return
        span = {
            "name": name,
            "cat": cat,
            "ts": float(t0_us),
            "dur": max(0.0, float(t1_us) - float(t0_us)),
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "host": self.host,
            "trace": self.trace_id,
        }
        if args:
            span["args"] = args
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
            else:
                self._spans.append(span)

    # --------------------------------------------------------- plumbing
    def ingest(self, spans, shift_us: float = 0.0,
               host: Optional[str] = None) -> None:
        """Fold spans recorded elsewhere (fork child, remote worker)
        into this tracer's buffer, shifting their clock by ``shift_us``
        (the coordinator's offset estimate; 0 for same-machine spans)."""
        if not spans:
            return
        with self._lock:
            for s in spans:
                if len(self._spans) >= self.max_spans:
                    self.dropped += len(spans)
                    break
                s = dict(s)
                if shift_us:
                    s["ts"] = float(s.get("ts", 0.0)) - float(shift_us)
                if host is not None:
                    s.setdefault("host", host)
                s["trace"] = self.trace_id
                self._spans.append(s)

    def snapshot(self) -> List[Dict[str, Any]]:
        """Copy of the span buffer (non-destructive)."""
        with self._lock:
            return [dict(s) for s in self._spans]

    def drain(self) -> List[Dict[str, Any]]:
        """Return and clear the span buffer."""
        with self._lock:
            out, self._spans = self._spans, []
            return out

    def clear(self) -> None:
        with self._lock:
            self._spans = []
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


# A permanently-disabled tracer is the default: instrumentation sites
# pay one attribute read per call until someone installs a live one.
_ACTIVE = Tracer(enabled=False)
_ACTIVE_LOCK = threading.Lock()


def current() -> Tracer:
    """The process-wide active tracer (disabled unless installed)."""
    return _ACTIVE


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process tracer; returns the previous
    one so callers can restore it."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, tracer
    return prev


def enable(sample: float = 1.0, host: str = "local",
           trace_id: Optional[str] = None, max_spans: int = 262144) -> Tracer:
    """Install and return a fresh enabled tracer."""
    tr = Tracer(enabled=True, sample=sample, host=host,
                trace_id=trace_id, max_spans=max_spans)
    set_tracer(tr)
    return tr


def disable() -> Tracer:
    """Install a disabled tracer; returns the previous (possibly live)
    tracer so its spans can still be exported."""
    return set_tracer(Tracer(enabled=False))
