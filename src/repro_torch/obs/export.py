"""Chrome trace-event JSON export and JSONL metrics dump (a copy of the
reference's ``obs/export.py`` over the port's tracer and registry).

``write_chrome_trace`` turns a span list (or a live Tracer) into the
Chrome trace-event format Perfetto and chrome://tracing load directly:
one complete ("ph": "X") event per span with µs timestamps, processes
keyed by span ``host`` tag (so a merged cross-host trace renders as
one process lane per host), and ``process_name`` metadata events
labelling each lane. ``load_chrome_trace`` is the validating loader
the report CLI uses — it raises ``ValueError`` on anything Perfetto
would reject.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Union

from .metrics import REGISTRY, MetricsRegistry
from .trace import Tracer

__all__ = [
    "chrome_trace_doc",
    "load_chrome_trace",
    "write_chrome_trace",
    "write_metrics_jsonl",
]


def chrome_trace_doc(
    spans: Sequence[Dict[str, Any]],
    trace_id: Optional[str] = None,
) -> Dict[str, Any]:
    """Span dicts -> Chrome trace-event document (a plain dict)."""
    # One synthetic pid per host tag: Perfetto renders each as its own
    # process track (a coordinator lane plus one lane per worker host).
    hosts: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    for s in spans:
        host = str(s.get("host", "local"))
        pid = hosts.get(host)
        if pid is None:
            pid = hosts[host] = len(hosts) + 1
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": host},
            })
        ev: Dict[str, Any] = {
            "name": str(s.get("name", "?")),
            "cat": str(s.get("cat", "span")),
            "ph": "X",
            "ts": float(s.get("ts", 0.0)),
            "dur": float(s.get("dur", 0.0)),
            "pid": pid,
            "tid": int(s.get("tid", 0)),
        }
        args = dict(s.get("args") or {})
        if s.get("trace"):
            args["trace"] = s["trace"]
        if args:
            ev["args"] = args
        events.append(ev)
    doc: Dict[str, Any] = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
    }
    if trace_id:
        doc["metadata"] = {"trace_id": trace_id}
    return doc


def write_chrome_trace(
    spans_or_tracer: Union[Tracer, Sequence[Dict[str, Any]]],
    path: str,
) -> int:
    """Write a Perfetto-loadable trace file; returns the span count."""
    if isinstance(spans_or_tracer, Tracer):
        spans = spans_or_tracer.snapshot()
        trace_id = spans_or_tracer.trace_id
    else:
        spans = list(spans_or_tracer)
        trace_id = next(
            (s.get("trace") for s in spans if s.get("trace")), None
        )
    doc = chrome_trace_doc(spans, trace_id=trace_id)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(spans)


def load_chrome_trace(path: str) -> Dict[str, Any]:
    """Load and validate a trace file. Raises ValueError on anything that
    is not a well-formed Chrome trace-event document."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(
        doc.get("traceEvents"), list
    ):
        raise ValueError(f"{path}: not a Chrome trace-event document")
    for ev in doc["traceEvents"]:
        if not isinstance(ev, dict) or "ph" not in ev or "name" not in ev:
            raise ValueError(f"{path}: malformed trace event {ev!r}")
        if ev["ph"] == "X" and ("ts" not in ev or "dur" not in ev):
            raise ValueError(
                f"{path}: complete event without ts/dur: {ev!r}"
            )
    return doc


def write_metrics_jsonl(
    path: str, registry: MetricsRegistry = REGISTRY
) -> None:
    """Dump the registry snapshot as one JSON object per line."""
    registry.dump_jsonl(path)
