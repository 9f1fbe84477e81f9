"""The port's stdlib-only tracing and metrics (copies of the reference's
``obs`` package): ``launches.*`` counters and ``launch.*`` spans of the
kernel launch layer land here; ``export`` writes a Chrome trace-event
JSON (one process lane per ``host`` tag) and a JSONL metrics dump, and
``python -m repro_torch.obs.report`` summarizes a trace by stage."""

from .metrics import Counter, Histogram, MetricsRegistry, REGISTRY
from .trace import (
    NOOP_SPAN,
    Tracer,
    current,
    disable,
    enable,
    now_us,
    set_tracer,
)

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
    "set_tracer",
]
