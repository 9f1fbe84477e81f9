"""Row-sharded retrieval: the DB split over a ShardPlan of 8 shards on the
device(s) given, queries broadcast, one fused K4 top-K per shard, the
(B, k) partials gathered and merged.

This is the >HBM-capacity regime of the paper's SIFT-1B experiment, the
layer AMIH hands off to when one index cannot hold the corpus. With one
card every shard lives on it; with several the shards round-robin them.

Run:  python -m repro_torch.examples.distributed_search [--device cpu]
(REPRO_EXAMPLE_N overrides the DB size; it must divide into 8 shards)
"""

from __future__ import annotations

import os
import time

import numpy as np

from . import _common

SHARDS = 8


def main(argv=None):
    args = _common.parser(__doc__).parse_args(argv)
    dev = _common.device("distributed_search", args.device)

    import torch

    from repro_torch.core import linear_scan_knn, pack_bits
    from repro_torch.data import synthetic_binary_codes, synthetic_queries
    from repro_torch.shard import ShardPlan, make_device_mesh, \
        sharded_scan_topk

    devices = [dev]
    if args.device is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    print(f"shards: {SHARDS} on {len(devices)} device(s) "
          f"({', '.join(str(d) for d in devices)})")
    p, n, B, k = 128, int(os.environ.get("REPRO_EXAMPLE_N", 1 << 18)), 8, 10
    db_bits = synthetic_binary_codes(n, p, seed=0)
    q_bits = synthetic_queries(db_bits, B, seed=1)
    db = pack_bits(db_bits)
    qs = pack_bits(q_bits)

    mesh = make_device_mesh([devices[s % len(devices)]
                             for s in range(SHARDS)], axis_names=("data",))
    plan = ShardPlan.from_mesh(mesh, n)
    print(f"mesh: {mesh.shape} — DB rows sharded over 'data' "
          f"({plan.num_shards} shards x {n // SHARDS:,} codes)")

    def wait():                  # so that the host clock covers the card
        if devices[0].type == "cuda":
            torch.cuda.synchronize(devices[0])

    t0 = time.perf_counter()
    sims, ids = sharded_scan_topk(mesh, qs, db, k, chunk=1 << 14)
    wait()
    print(f"first query batch (incl. kernel build): "
          f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    sims, ids = sharded_scan_topk(mesh, qs, db, k, chunk=1 << 14)
    wait()
    dt = time.perf_counter() - t0
    print(f"steady-state: {1e3 * dt:.1f}ms for {B} queries x {n:,} codes "
          f"({B * n / dt / 1e9:.2f} Gcomparisons/s)")

    # exactness: the sharded merge equals the single-host linear scan
    sims_h = sims.cpu().numpy()
    for b in range(B):
        _, sims_l = linear_scan_knn(qs[b], db, k)
        np.testing.assert_allclose(np.sort(sims_h[b])[::-1], sims_l,
                                   atol=1e-6)
    print("sharded top-K == single-host linear scan for every query (exact)")


if __name__ == "__main__":
    main()
