"""Cluster smoke canary: coordinator + 2 localhost workers, exact vs scan
(a port of the reference's ``cluster/smoke.py``).

``python -m repro_torch.cluster.smoke`` spawns a 2-worker loopback fleet
over a small synthetic DB, runs one mixed batch through the full wire
protocol (build frames, fan-out, bound broadcast, merge), and asserts
the merged results are exactly ``linear_scan_knn``'s — sims bit for bit,
ids distinct and carrying those sims. Exits non-zero on any mismatch.
The workers run the port's engines on the CUDA device, or with
``--device cpu`` their kernels' plain versions on the CPU.

Small on purpose: the DB is a few thousand rows, so the whole canary —
including two spawned interpreters importing torch — stays in tens of
seconds.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np


def run(n: int = 4096, p: int = 64, B: int = 8, k: int = 10,
        hosts: int = 2, num_shards: int = 4, seed: int = 0,
        device: Optional[str] = None) -> int:
    from repro_torch.core.engine import make_engine
    from repro_torch.core.linear_scan import linear_scan_knn, sims_for_ids
    from repro_torch.core.packing import pack_bits

    rng = np.random.default_rng(seed)
    db_words = pack_bits(rng.integers(0, 2, size=(n, p), dtype=np.uint8))
    q_words = pack_bits(rng.integers(0, 2, size=(B, p), dtype=np.uint8))

    t0 = time.perf_counter()
    engine = make_engine("cluster", db_words, p, hosts=hosts,
                         num_shards=num_shards, device=device)
    t_build = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        ids, sims, stats = engine.knn_batch(q_words, k)
        t_search = time.perf_counter() - t0
        bad = 0
        for i in range(B):
            # the repo-wide exactness convention: sims bit-identical to
            # the scan; emitted ids distinct and really carrying those
            # sims (tie order inside one Hamming tuple is the only
            # permitted difference)
            _ref_ids, ref_sims = linear_scan_knn(q_words[i], db_words, k)
            ok = (
                np.array_equal(sims[i], ref_sims)
                and np.unique(ids[i]).size == k
                and np.array_equal(
                    sims_for_ids(q_words[i], db_words, ids[i]), sims[i]
                )
            )
            if not ok:
                bad += 1
                print(f"MISMATCH query {i}:\n  got  {sims[i]}\n"
                      f"  want {ref_sims}", file=sys.stderr)
        hosts_seen = [h["host"] for h in stats.per_host]
        rpc = [h["rpc_ms"] for h in stats.per_host]
        devs = sorted({str(s.get("device")) for s in stats.per_shard})
        print(
            f"cluster smoke: n={n} p={p} B={B} k={k} hosts={hosts} "
            f"shards={num_shards} devices={devs} build={t_build:.1f}s "
            f"search={t_search * 1e3:.0f}ms per_host={hosts_seen} "
            f"rpc_ms={rpc}"
        )
        if bad:
            print(f"FAIL: {bad}/{B} queries mismatched", file=sys.stderr)
            return 1
        if len(stats.per_host) != hosts:
            print(f"FAIL: expected {hosts} per_host entries, got "
                  f"{len(stats.per_host)}", file=sys.stderr)
            return 1
        print("PASS: cluster merge bit-identical to linear_scan_knn")
        return 0
    finally:
        engine.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cluster.smoke",
        description="2-worker cluster search, exact against the scan",
    )
    ap.add_argument("--device", default=None,
                    help="the workers' device (default: the CUDA device)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    sys.exit(main())
