"""Per-stage breakdown of a Chrome trace file (a copy of the reference's
``obs/report.py``).

    python -m repro_torch.obs.report trace.json [--min-hosts N] [--min-stages N]

Groups complete events by span name, prints count / total / mean /
share-of-wall per stage plus the host lanes found, and exits nonzero
if the file is not a valid trace (2) or the ``--min-*`` floors are
unmet (1).
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List

from .export import load_chrome_trace

__all__ = ["main", "summarize"]


def summarize(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Trace document -> {wall_ms, hosts, stages: {name: {...}}}."""
    pid_host: Dict[int, str] = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_host[int(ev.get("pid", 0))] = str(
                (ev.get("args") or {}).get("name", ev.get("pid"))
            )
    stages: Dict[str, Dict[str, Any]] = {}
    hosts = set()
    t_min, t_max = float("inf"), float("-inf")
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        ts, dur = float(ev["ts"]), float(ev["dur"])
        t_min = min(t_min, ts)
        t_max = max(t_max, ts + dur)
        host = pid_host.get(int(ev.get("pid", 0)), str(ev.get("pid", "?")))
        hosts.add(host)
        st = stages.setdefault(ev["name"], {
            "count": 0, "total_ms": 0.0, "hosts": set(),
        })
        st["count"] += 1
        st["total_ms"] += dur / 1000.0
        st["hosts"].add(host)
    wall_ms = 0.0 if t_max < t_min else (t_max - t_min) / 1000.0
    for st in stages.values():
        st["mean_ms"] = st["total_ms"] / max(1, st["count"])
        st["hosts"] = sorted(st["hosts"])
    return {"wall_ms": wall_ms, "hosts": sorted(hosts), "stages": stages}


def _print_summary(summary: Dict[str, Any]) -> None:
    wall = summary["wall_ms"]
    hosts: List[str] = summary["hosts"]
    stages = summary["stages"]
    print(f"trace wall time: {wall:.3f} ms across "
          f"{len(hosts)} host(s): {', '.join(hosts)}")
    if not stages:
        print("no spans.")
        return
    name_w = max(len(n) for n in stages)
    hdr = (f"{'stage':<{name_w}}  {'count':>7}  {'total ms':>10}  "
           f"{'mean ms':>9}  {'% wall':>7}  hosts")
    print(hdr)
    print("-" * len(hdr))
    for name in sorted(stages, key=lambda n: -stages[n]["total_ms"]):
        st = stages[name]
        share = 100.0 * st["total_ms"] / wall if wall > 0 else 0.0
        print(f"{name:<{name_w}}  {st['count']:>7}  "
              f"{st['total_ms']:>10.3f}  {st['mean_ms']:>9.3f}  "
              f"{share:>6.1f}%  {len(st['hosts'])}")
    total = sum(st["total_ms"] for st in stages.values())
    print(f"summed stage time: {total:.3f} ms "
          f"(> wall is normal: spans nest and hosts overlap)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Per-stage time breakdown of a Chrome trace file.",
    )
    ap.add_argument("trace", help="Chrome trace-event JSON file")
    ap.add_argument("--min-hosts", type=int, default=0,
                    help="fail unless spans from at least N hosts")
    ap.add_argument("--min-stages", type=int, default=0,
                    help="fail unless at least N distinct span names")
    args = ap.parse_args(argv)
    try:
        doc = load_chrome_trace(args.trace)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    summary = summarize(doc)
    _print_summary(summary)
    if len(summary["hosts"]) < args.min_hosts:
        print(f"error: spans from {len(summary['hosts'])} host(s), "
              f"need >= {args.min_hosts}", file=sys.stderr)
        return 1
    if len(summary["stages"]) < args.min_stages:
        print(f"error: {len(summary['stages'])} distinct stage(s), "
              f"need >= {args.min_stages}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
