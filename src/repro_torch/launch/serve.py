"""Serving entry point: the generation engine and the AMIH retrieval service
(a port of the reference's ``launch/serve.py``, with the same flags and
printed lines).

    python -m repro_torch.launch.serve --arch gemma_2b --tiny --requests 8
    python -m repro_torch.launch.serve --arch gemma_2b --tiny \\
        --mode retrieval --docs 300 --queries 5

It runs on the CUDA device; ``--device cpu`` runs every kernel's plain
version on the CPU. ``--tiny`` computes in float32, as the reference
does. The random weights come from ``--seed`` through the port's own
generator, so they are not the reference's.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--mode", default="generate",
                    choices=["generate", "retrieval"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--docs", type=int, default=300)
    ap.add_argument("--queries", type=int, default=5)
    ap.add_argument("--code-bits", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA device)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_tiny
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models import Model

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"repro_torch.launch.serve: {e}")
    cfg = get_tiny(args.arch) if args.tiny else get_config(args.arch)
    cfg = cfg.replace(compute_dtype="float32") if args.tiny else cfg
    model = Model(cfg)
    params = model.init_params(args.seed, device=dev)
    rng = np.random.default_rng(args.seed)

    if args.mode == "generate":
        from repro_torch.serve import ServeConfig, ServeEngine

        eng = ServeEngine(
            cfg, params,
            ServeConfig(
                max_batch=args.max_batch, max_seq=args.max_seq,
                max_new_tokens=args.max_new_tokens, device=dev,
            ),
        )
        for _ in range(args.requests):
            plen = int(rng.integers(4, args.max_seq // 4))
            eng.submit(rng.integers(1, cfg.vocab_size, plen))
        t0 = time.perf_counter()
        results = eng.run_until_drained()
        dt = time.perf_counter() - t0
        toks = sum(len(v) for v in results.values())
        print(f"served {len(results)} requests / {toks} tokens in {dt:.2f}s "
              f"({eng.stats['decode_steps']} batched decode steps)")
        return

    from repro_torch.serve import RetrievalConfig, RetrievalService

    svc = RetrievalService(
        cfg, params,
        RetrievalConfig(code_bits=args.code_bits, aqbc_iters=8, device=dev),
    )
    docs = rng.integers(1, cfg.vocab_size, (args.docs, 24)).astype(np.int32)
    info = svc.build_index(docs)
    print(f"indexed {args.docs} docs "
          f"(m={int(info['m_tables'])} tables, "
          f"AQBC objective {info['aqbc_objective']:.3f})")
    try:
        for qi in rng.integers(0, args.docs, args.queries):
            ids, sims, stats = svc.search(docs[int(qi)], k=5)
            ids_l, sims_l = svc.search_linear(docs[int(qi)], k=5)
            if not np.allclose(sims, sims_l, atol=1e-9):
                raise AssertionError("exactness violated")
            print(f"  q=doc[{qi}]: hits {ids[:3].tolist()} "
                  f"sims {np.round(sims[:3], 3).tolist()} "
                  f"probes={stats.probes} (exact vs scan: OK)")
    finally:
        svc.close()


if __name__ == "__main__":
    main()
