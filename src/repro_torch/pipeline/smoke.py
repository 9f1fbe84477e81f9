"""Fast pipelined-vs-sequential smoke check of the port's pipeline and
shard layers (a port of the reference's ``pipeline/smoke.py``).

    PYTHONPATH=src python -m repro_torch.pipeline.smoke               # card
    PYTHONPATH=src python -m repro_torch.pipeline.smoke --device cpu

Runs in seconds: a small clustered workload is answered by the pipelined
paths (the AMIH verify overlap, shard-parallel probing under the shared
warm-started bound in thread and process mode, the sharded AMIH device
walk, the sharded scan, the single table, the streaming loop) and every
result is asserted bit-identical to its sequential counterpart and to the
exact linear scan. The default device is the card (it raises without
one); ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _force_pool(eng):
    """Zero the adaptive stand-down gates so the tiny smoke DB exercises
    the pool on any host."""
    eng.PARALLEL_MIN_SHARD_ROWS = 0
    eng.PARALLEL_MIN_CPUS = 0
    eng.PARALLEL_MIN_BATCH = 0
    assert eng._use_parallel(16)
    return eng


def main(argv=None) -> int:
    from ..core import linear_scan_knn, make_engine, pack_bits
    from ..data import synthetic_binary_codes, synthetic_queries
    from ..kernels.ops import resolve_device
    from .stream import stream_search

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    dev = resolve_device(ap.parse_args(argv).device)

    t0 = time.perf_counter()
    p, n, B, k, S = 64, 1200, 16, 10, 8
    db_bits = synthetic_binary_codes(n, p, seed=0)
    db = pack_bits(db_bits)
    qs = pack_bits(synthetic_queries(db_bits, B, seed=1))
    qs[1] = 0  # zero-norm query rides along
    ref = [linear_scan_knn(qs[i], db, k)[1] for i in range(B)]
    host = dict(probe_backend="host", verify_backend="cuda")

    def check(tag, engine, want=None):
        ids, sims, _ = engine.knn_batch(qs, k)
        for i in range(B):
            np.testing.assert_array_equal(np.sort(sims[i])[::-1], ref[i])
        if want is not None:
            np.testing.assert_array_equal(ids, want[0])
            np.testing.assert_array_equal(sims, want[1])
        print(f"  {tag}: exact")
        return ids, sims

    # ids are held where the two paths break ties alike: the overlap
    # against the sequential walk, the pool against the sequential chain
    seq = make_engine("amih", db, p, device=dev, **host)
    want = check("amih sequential     ", seq)
    ovl = make_engine("amih", db, p, overlap_verify=True, device=dev, **host)
    check("amih overlap        ", ovl, want)
    chain = make_engine("sharded_amih", db, p, num_shards=S,
                        devices=[dev], **host)
    want_sh = check("sharded sequential  ", chain)
    par = _force_pool(make_engine("sharded_amih", db, p, num_shards=S,
                                  devices=[dev], probe_workers=S, **host))
    check("sharded pool, thread", par, want_sh)
    proc = _force_pool(make_engine(
        "sharded_amih", db, p, num_shards=S, probe_workers=S,
        probe_backend="host", verify_backend="numpy", probe_mode="process"))
    check("sharded pool, proc  ", proc, want_sh)
    fused = make_engine("sharded_amih", db, p, num_shards=S, devices=[dev])
    check("sharded device walk ", fused)
    check("sharded scan        ",
          make_engine("sharded_scan", db, p, num_shards=S, devices=[dev]))
    check("single table        ", make_engine("single_table", db, p))
    for eng in (ovl, par, proc):
        eng.close()
    assert not par._pool and not proc._pool

    # streaming loop over the sequential engine: per-step results in
    # order, queue depth counted, same sims
    steps = list(stream_search(seq, [qs[:8], qs[8:]], k,
                               encode=lambda q: q))
    got = np.concatenate([sr.sims for sr in steps])
    np.testing.assert_array_equal(got, want[1])
    assert steps[0].stats.queue_depth == 8
    print("  stream_search       : exact, queue depth counted")
    print(f"pipeline smoke OK on {dev} in {time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
