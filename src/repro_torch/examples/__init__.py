"""The reference's four examples (``examples/*.py``) on the port's API, each
runnable as ``python -m repro_torch.examples.<name>``:

- quickstart: AMIH, the linear scan and sharded AMIH, exact against each
  other, with the paper's cost counters;
- distributed_search: the linear scan with the DB row-sharded over a
  ShardPlan of 8 shards on the device(s) given, merged and held against
  the single-host scan;
- retrieval_serving: an LM encoder, AQBC and AMIH behind the streamed
  serving queue, then the token-serving engine on the same weights;
- train_embedder: a ~100M llama-family LM (``--tiny``: the tiny llama3-8b)
  trained with the production stack, checkpoints and restarts included.

Each takes the reference's ``REPRO_EXAMPLE_N`` and flags plus ``--device``
(default: the CUDA device; without one it exits naming "no CUDA device"),
and prints the reference example's success lines.
"""
