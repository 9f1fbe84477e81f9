"""The port's serving pipeline (a port of the reference's
``pipeline/``): every pipelined path returns bit-identical (ids, sims) to
its sequential counterpart.

Modules:
  - stages.py    — StagedExecutor: per-stage single-worker thread pools,
                   bounded in-flight window, in-order results.
  - overlap.py   — VerifyOverlap: AMIH tuple-step verify/probe overlap
                   (the host walk's K1 launches on a side CUDA stream;
                   ``make_engine("amih", ..., overlap_verify=True)``).
  - shardpool.py — SharedBound + PersistentShardPool: shard-parallel
                   probing for "sharded_amih" under a shared, monotone,
                   warm-startable k-th-cosine bound (``probe_workers``).
  - stream.py    — Ticket / stream_search / LatencyTracker, which
                   ``RetrievalService.run_queued(stream=True)`` runs on.
  - smoke.py     — fast pipelined == sequential check
                   (``python -m repro_torch.pipeline.smoke``).
"""

from .overlap import VerifyOverlap
from .shardpool import (
    PersistentShardPool,
    SharedBound,
    prime_ids,
    probe_shards_parallel,
)
from .stages import Stage, StagedExecutor
from .stream import LatencyTracker, StepResult, Ticket, stream_search

__all__ = [
    "LatencyTracker",
    "PersistentShardPool",
    "SharedBound",
    "Stage",
    "StagedExecutor",
    "StepResult",
    "Ticket",
    "VerifyOverlap",
    "prime_ids",
    "probe_shards_parallel",
    "stream_search",
]
