"""Quickstart: the paper's algorithm end to end on the port.

1. build a synthetic binary dataset (AQBC-like clustered codes),
2. build a search engine by backend name (the unified SearchEngine API),
3. run exact angular KNN as ONE batched query call and verify against the
   float64 linear scan,
4. print the paper-style cost accounting (probes / verifications / walk
   launches).

AMIH runs its device path (K2's probing walk, one launch a batch, and K3
for queries that bail); the kernel-backed exhaustive baseline runs K4's
fused score-and-top-K and re-ranks on the host in float64; sharded AMIH
runs over a ShardPlan of 8 shards. All three must return the scan's sims
bit for bit.

Run:  python -m repro_torch.examples.quickstart [--device cpu]
(REPRO_EXAMPLE_N overrides the DB size)
"""

from __future__ import annotations

import os
import time

import numpy as np

from . import _common


def main(argv=None):
    args = _common.parser(__doc__).parse_args(argv)
    dev = _common.device("quickstart", args.device)

    from repro_torch.core import make_engine, pack_bits
    from repro_torch.data import synthetic_binary_codes, synthetic_queries
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.shard import ShardPlan

    p, n, k, B = 64, int(os.environ.get("REPRO_EXAMPLE_N", 200_000)), 10, 5
    print(f"dataset: n={n:,} codes x {p} bits, {B} queries in one batch "
          f"on {dev}")
    db_bits = synthetic_binary_codes(n, p, seed=0)
    db = pack_bits(db_bits)
    qs = pack_bits(synthetic_queries(db_bits, B, seed=1))

    t0 = time.perf_counter()
    amih = make_engine("amih", db, p, device=dev)
    print(f"indexed in {time.perf_counter() - t0:.2f}s "
          f"(m={amih.index.m} tables, paper's m = p/log2 n; "
          f"enumeration_cap={amih.enumeration_cap:,} = max(8n, 16384))")
    scan = make_engine("linear_scan", db, p, compute_backend="numpy")

    amih.knn_batch(qs[:1], k)       # warm: schedules, kernel build
    walks0 = REGISTRY.value("launches.device_probe")
    t0 = time.perf_counter()
    ids, sims, stats = amih.knn_batch(qs, k)
    t_amih = time.perf_counter() - t0
    walks = REGISTRY.value("launches.device_probe") - walks0

    t0 = time.perf_counter()
    ids_l, sims_l, _ = scan.knn_batch(qs, k)
    t_scan = time.perf_counter() - t0

    assert np.array_equal(sims, sims_l), "exactness violated!"
    agg = stats.aggregate()
    for i, s in enumerate(stats.per_query):
        print(f"q{i}: top-{k} sims {np.round(sims[i, :3], 4)}..., "
              f"probes={s.probes} verified={s.verified} "
              f"({s.verified / n:.2%} of db)")
    print(f"batch of {B}: AMIH {1e3 * t_amih:6.2f}ms vs scan "
          f"{1e3 * t_scan:7.2f}ms ({t_scan / max(t_amih, 1e-9):6.1f}x) | "
          f"total probes={agg['probes']} verified={agg['verified']} in "
          f"{walks} walk launch(es)")

    # the kernel-backed exhaustive baseline: K4's fused top-K preselect
    # (DB uploaded once, resident thereafter) + exact float64 host rerank
    scan_dev = make_engine("linear_scan", db, p, compute_backend="cuda",
                           device=dev)
    scan_dev.knn_batch(qs[:1], k)   # warm: kernel build + DB upload
    t0 = time.perf_counter()
    _, sims_d, _ = scan_dev.knn_batch(qs, k)
    t_dev = time.perf_counter() - t0
    assert np.array_equal(sims_d, sims_l), "device path exactness violated!"
    print(f"kernel-backed scan (compute_backend='cuda'): "
          f"{1e3 * t_dev:7.2f}ms, sims bit-identical")

    # the sharded backend: the DB row-partitioned by a ShardPlan (per-shard
    # global-id offsets, balanced remainder), every shard on ``dev``,
    # served through the SAME knn_batch API
    plan = ShardPlan.balanced(n, 8)
    print(f"shard plan: {plan.summary()}")
    sharded = make_engine("sharded_amih", db, p, plan=plan, devices=[dev])
    t0 = time.perf_counter()
    _, sims_s, st_s = sharded.knn_batch(qs, k)
    t_sh = time.perf_counter() - t0
    assert np.array_equal(sims_s, sims_l), "sharded exactness violated!"
    early = sum(d["early_stopped"] for d in st_s.per_shard)
    print(f"sharded_amih over {st_s.shards} shards: {1e3 * t_sh:6.2f}ms, "
          f"sims bit-identical; {early} per-shard searches stopped early "
          f"(global k-th cosine bound)")
    print("all queries exact — engine('amih') == engine('linear_scan') == "
          "engine('sharded_amih'), orders faster.")


if __name__ == "__main__":
    main()
