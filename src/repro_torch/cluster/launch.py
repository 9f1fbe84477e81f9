"""One-command cluster launcher (a port of the reference's
``cluster/launch.py``).

Worker hosts run:

    python -m repro_torch.cluster.launch --role worker --port 9377

which binds the frame loop and waits; all layout flows from the
coordinator's ``build`` frame (each worker's host-partitioned
``ShardPlan.summary()`` plus its row slab), so worker invocations are
identical on every host: one config, N hosts, one command per host.
Placement does not cross the wire: a worker runs on the CUDA device, or
on the CPU with ``--device cpu`` (a coordinator's ``--device`` goes to
the workers it spawns).

The coordinator host runs:

    python -m repro_torch.cluster.launch --role coordinator \\
        --workers hostA:9377,hostB:9377 --data codes.npy --p 256 \\
        --queries 64 --k 10

which loads (or synthesizes) the packed code DB, balances a plan over
``--num-shards``, ships every worker its slice, answers ``--queries``
random queries through the cluster, and prints per-host attribution.
With ``--hosts N`` and no ``--workers``, a localhost fleet is spawned
instead — the quickest way to see the whole tier run on one machine.
``--check`` verifies every answer against ``linear_scan_knn`` exactly.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Tuple


def _parse_workers(spec: str) -> List[Tuple[str, int]]:
    out = []
    for part in spec.split(","):
        host, _, port = part.strip().rpartition(":")
        if not host or not port.isdigit():
            raise SystemExit(f"bad worker address {part!r} (want host:port)")
        out.append((host, int(port)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cluster.launch",
        description="Run one role of the cross-host serving tier.",
    )
    ap.add_argument("--role", required=True,
                    choices=("coordinator", "worker"))
    # worker flags
    ap.add_argument("--bind", default="0.0.0.0",
                    help="worker: interface to listen on")
    ap.add_argument("--port", type=int, default=9377,
                    help="worker: listening port (0 = ephemeral)")
    ap.add_argument("--device", default=None,
                    help="the workers' device (default: the CUDA device; "
                         "'cpu' runs the kernels' plain versions)")
    # coordinator flags
    ap.add_argument("--workers", default=None,
                    help="coordinator: comma-separated host:port list")
    ap.add_argument("--hosts", type=int, default=2,
                    help="coordinator: spawn N localhost workers when "
                         "no --workers list is given")
    ap.add_argument("--data", default=None,
                    help="coordinator: .npy of packed (n, W) uint32 codes")
    ap.add_argument("--p", type=int, default=64,
                    help="coordinator: code length in bits")
    ap.add_argument("--synthetic", type=int, default=20000,
                    help="coordinator: synthetic DB rows when no --data")
    ap.add_argument("--num-shards", type=int, default=None,
                    help="coordinator: total shards (default: one/host)")
    ap.add_argument("--backend", default="sharded_amih",
                    choices=("sharded_amih", "sharded_scan"),
                    help="coordinator: per-worker engine")
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="coordinator: verify vs linear_scan_knn")
    args = ap.parse_args(argv)

    if args.role == "worker":
        from .worker import WorkerServer

        srv = WorkerServer(args.bind, args.port, device=args.device)
        print(f"worker listening on {srv.addr[0]}:{srv.addr[1]}",
              flush=True)
        srv.serve_forever()
        return 0

    import numpy as np

    from ..core.engine import make_engine
    from ..core.linear_scan import linear_scan_knn
    from ..core.packing import pack_bits

    rng = np.random.default_rng(args.seed)
    if args.data:
        db_words = np.load(args.data)
        if db_words.ndim != 2:
            raise SystemExit(f"--data must be a packed (n, W) array, "
                             f"got shape {db_words.shape}")
    else:
        db_words = pack_bits(rng.integers(
            0, 2, size=(args.synthetic, args.p), dtype=np.uint8
        ))
    q_words = pack_bits(rng.integers(
        0, 2, size=(args.queries, args.p), dtype=np.uint8
    ))
    workers = _parse_workers(args.workers) if args.workers else None
    engine = make_engine(
        "cluster", db_words, args.p,
        hosts=args.hosts, workers=workers,
        inner_backend=args.backend, num_shards=args.num_shards,
        device=args.device,
    )
    try:
        t0 = time.perf_counter()
        ids, sims, stats = engine.knn_batch(q_words, args.k)
        dt = time.perf_counter() - t0
        print(f"answered {args.queries} queries (k={args.k}) over "
              f"{engine.n} rows x {engine.hosts} hosts in "
              f"{dt * 1e3:.1f}ms")
        print(json.dumps(stats.per_host, indent=2, default=str))
        if args.check:
            from ..core.linear_scan import sims_for_ids

            for i in range(args.queries):
                _ref_ids, ref_sims = linear_scan_knn(
                    q_words[i], db_words, args.k
                )
                # sims bit-identical; ids distinct and carrying those
                # sims (tie order inside a Hamming tuple may differ)
                if not (np.array_equal(sims[i], ref_sims)
                        and np.unique(ids[i]).size == sims[i].size
                        and np.array_equal(
                            sims_for_ids(q_words[i], db_words, ids[i]),
                            sims[i])):
                    print(f"MISMATCH on query {i}", file=sys.stderr)
                    return 1
            print("check: all queries exact vs linear_scan_knn")
        return 0
    finally:
        engine.close()


if __name__ == "__main__":
    sys.exit(main())
