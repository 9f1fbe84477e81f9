"""Retrieval serving (the paper as a production feature): an LM encodes
documents (K7 in every layer), AQBC binarizes the embeddings, AMIH serves
exact angular KNN through the STREAMING serving loop: submit returns a
ticket whose future resolves per batch step, run_queued(stream=True)
yields results as each step completes while the next batch encodes, and
every step carries queue-depth and p50/p99 latency counters; then the
token-serving engine answers generation requests on the same weights,
encoder and generator sharing them as a deployment would.

Run:  python -m repro_torch.examples.retrieval_serving [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from . import _common


def main(argv=None):
    args = _common.parser(__doc__).parse_args(argv)
    dev = _common.device("retrieval_serving", args.device)

    from repro_torch.configs import get_tiny
    from repro_torch.models import Model
    from repro_torch.serve import (
        RetrievalConfig,
        RetrievalService,
        ServeConfig,
        ServeEngine,
    )

    cfg = get_tiny("gemma_2b").replace(compute_dtype="float32")
    params = Model(cfg).init_params(0, device=dev)
    rng = np.random.default_rng(0)

    # ---- corpus: token "documents" (deterministic synthetic) ----
    n_docs, doc_len = 400, 24
    docs = rng.integers(1, cfg.vocab_size, (n_docs, doc_len)).astype(np.int32)

    # ---- index: encode -> AQBC(64 bits) -> AMIH (pipelined serving) ----
    svc = RetrievalService(
        cfg, params,
        RetrievalConfig(code_bits=64, aqbc_iters=8, search_batch_size=2,
                        pipelined=True, device=dev),
    )
    t0 = time.perf_counter()
    info = svc.build_index(docs)
    print(f"indexed {n_docs} docs in {time.perf_counter() - t0:.2f}s "
          f"(AQBC objective {info['aqbc_objective']:.3f}, "
          f"m={int(info['m_tables'])} tables)")

    # ---- exact angular search, STREAMED: submit -> tickets; results
    # ---- arrive per batch step while the next batch is still encoding
    queries = (11, 222, 7, 333)
    tickets = {qi: svc.submit(docs[qi]) for qi in queries}
    for step in svc.run_queued(k=5, stream=True):
        lat = step.stats.latency_ms
        print(f"step {step.step}: {len(step.results)} queries answered "
              f"in {step.latency_ms:.0f} ms (queue depth "
              f"{step.stats.queue_depth}, p50 {lat['p50']:.0f} ms, "
              f"p99 {lat['p99']:.0f} ms)")
    for qi, ticket in tickets.items():
        ids, sims = ticket.result()          # already resolved
        ids_l, sims_l = svc.search_linear(docs[qi], k=5)
        assert np.allclose(sims, sims_l, atol=1e-9)
        print(f"query=doc[{qi}]: hits {ids[:5].tolist()} "
              f"sims {np.round(sims[:5], 3).tolist()} (exact, streamed)")

    # single-query convenience path still returns per-query counters
    ids, sims, stats = svc.search(docs[11], k=5)
    print(f"doc[11] solo: probes={stats.probes} verified={stats.verified}")
    svc.close()

    # ---- generation on the same weights: batched serving engine ----
    eng = ServeEngine(cfg, params, ServeConfig(max_batch=4, max_seq=64,
                                               max_new_tokens=8, device=dev))
    rids = [
        eng.submit(rng.integers(1, cfg.vocab_size, int(rng.integers(5, 15))))
        for _ in range(6)
    ]
    t0 = time.perf_counter()
    results = eng.run_until_drained()
    dt = time.perf_counter() - t0
    print(f"generated {sum(len(v) for v in results.values())} tokens for "
          f"{len(results)} requests in {dt:.2f}s "
          f"({eng.stats['decode_steps']} batched decode steps)")
    for rid in rids[:3]:
        print(f"  request {rid}: {results[rid]}")


if __name__ == "__main__":
    main()
