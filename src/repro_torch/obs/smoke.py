"""Traced end-to-end cluster smoke: ``python -m repro_torch.obs.smoke``
(a port of the reference's ``obs/smoke.py``).

Builds a 2-localhost-worker cluster engine over a small random DB with
tracing enabled, runs one ``knn_batch``, asserts the results are
bit-identical in sims to ``linear_scan_knn`` (tracing observes, never
reorders), and writes one Chrome-trace JSON containing coordinator RPC
spans and per-worker engine, probe, verify and kernel-launch spans under
a single trace id. ``python -m repro_torch.obs.report`` over the output
with host and stage floors is the cheapest proof that the distributed
trace plumbing (AMRP ``trace`` meta out, ``spans`` meta back,
clock-offset ingest) works.

The workers run on the CUDA device unless ``--device cpu`` is given;
there is no silent CPU path. Needs a real spawned-process fleet, so it
runs as a module.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from . import trace as _obs
from .export import load_chrome_trace, write_chrome_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.smoke",
        description="traced 2-worker cluster search smoke",
    )
    ap.add_argument("--out", default=None,
                    help="Chrome trace output path (default: a new "
                         "temporary directory, never the working one)")
    ap.add_argument("--n", type=int, default=2000, help="DB rows")
    ap.add_argument("--p", type=int, default=64, help="code bits")
    ap.add_argument("--batch", type=int, default=8, help="queries")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--probe-backend", default="host",
                    choices=("host", "device"),
                    help="worker probe backend (host with the CUDA verify "
                         "covers the amih.* AND launch.* span families; "
                         "device trades the amih.probe spans for the "
                         "walk's launch spans)")
    ap.add_argument("--verify-backend", default="cuda",
                    choices=("numpy", "cuda"),
                    help="worker verify backend (cuda: the grouped "
                         "verify's launches appear in the trace)")
    ap.add_argument("--device", default=None,
                    help="the workers' device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ..core.engine import make_engine
    from ..core.linear_scan import linear_scan_knn, sims_for_ids
    from ..core.packing import pack_bits

    rng = np.random.default_rng(0)
    db = pack_bits(rng.integers(0, 2, (args.n, args.p), dtype=np.uint8))
    q = pack_bits(
        rng.integers(0, 2, (args.batch, args.p), dtype=np.uint8)
    )

    if args.out is None:
        args.out = os.path.join(tempfile.mkdtemp(prefix="obs_smoke_"),
                                "obs_smoke_trace.json")
    tracer = _obs.Tracer(enabled=True, host="coordinator")
    eng = make_engine(
        "cluster", db, args.p, hosts=2, num_shards=2,
        probe_backend=args.probe_backend,
        verify_backend=args.verify_backend, tracer=tracer,
        device=args.device,
    )
    try:
        ids, sims, _ = eng.knn_batch(q, args.k)
    finally:
        eng.close()

    # the exactness contract of repro_torch.cluster.smoke: sims
    # bit-identical to the scan, ids distinct and really carrying those
    # sims (id order inside one exact-sim tie may differ)
    for i in range(args.batch):
        _ref_ids, ref_sims = linear_scan_knn(q[i], db, args.k)
        ok = (
            np.array_equal(sims[i], ref_sims)
            and np.unique(ids[i]).size == ids[i].size
            and np.array_equal(sims_for_ids(q[i], db, ids[i]), sims[i])
        )
        if not ok:
            print(f"FAIL: traced cluster query {i} differs from "
                  f"linear scan", file=sys.stderr)
            return 1

    n_spans = write_chrome_trace(tracer, args.out)
    load_chrome_trace(args.out)   # must be Perfetto-loadable JSON
    spans = tracer.snapshot()
    hosts = sorted({s["host"] for s in spans})
    stages = sorted({s["name"] for s in spans})
    devices = sorted({str((s.get("args") or {}).get("device"))
                      for s in spans if s["name"].startswith("launch.")})
    print(f"wrote {args.out}: {n_spans} spans, "
          f"{len(hosts)} hosts {hosts}, {len(stages)} stages, "
          f"launch devices {devices}")
    if len(hosts) < 3:   # coordinator + 2 workers
        print(f"FAIL: expected spans from coordinator + 2 workers, "
              f"got hosts {hosts}", file=sys.stderr)
        return 1
    if not any(s["name"].startswith("launch.") for s in spans):
        print("FAIL: no device-launch span in trace", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
