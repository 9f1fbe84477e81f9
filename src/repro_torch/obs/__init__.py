"""The port's stdlib-only tracing and metrics (copies of the reference's
``obs.trace`` and ``obs.metrics``): ``launches.*`` counters and
``launch.*`` spans of the kernel launch layer land here."""

from .metrics import Counter, Histogram, MetricsRegistry, REGISTRY
from .trace import NOOP_SPAN, Tracer, current, disable, enable, now_us

__all__ = [
    "Counter",
    "Histogram",
    "MetricsRegistry",
    "NOOP_SPAN",
    "REGISTRY",
    "Tracer",
    "current",
    "disable",
    "enable",
    "now_us",
]
