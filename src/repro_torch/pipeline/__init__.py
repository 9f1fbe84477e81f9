"""The port's serving pipeline: ``StagedExecutor`` (per-stage worker
threads, in-order results) and ``stream_search`` with its ``Ticket``,
``StepResult`` and ``LatencyTracker``, which
``RetrievalService.run_queued(stream=True)`` runs on. The AMIH verify
overlap and the shard-probe pool are ROADMAP A7."""

from .stages import Stage, StagedExecutor
from .stream import LatencyTracker, StepResult, Ticket, stream_search

__all__ = ["LatencyTracker", "Stage", "StagedExecutor", "StepResult",
           "Ticket", "stream_search"]
