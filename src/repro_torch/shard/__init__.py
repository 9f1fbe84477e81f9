"""Sharded search (a port of the reference's ``shard/``): row-sharded
DBs behind the unified engine API.

Layout:
  - plan.py        — ShardPlan: balanced row partition + global-id offsets
                     + a ``torch.device`` per shard + serializable summary
                     (the layout contract); ``DeviceMesh`` for the mesh
                     helpers (torch has no mesh of its own).
  - distributed.py — row-sharded scan primitives: one fused K4 top-K per
                     shard on its own device, O(K) gather, merge.
  - engines.py     — "sharded_scan" / "sharded_amih" SearchEngine
                     backends, registered on import.

``make_engine("sharded_scan" | "sharded_amih", ...)`` imports this
package on demand (see core.engine.make_engine).
"""

from .distributed import (
    make_retrieval_step,
    sharded_scan_candidates,
    sharded_scan_topk,
)
from .engines import ShardedAMIHEngine, ShardedScanEngine
from .plan import DeviceMesh, ShardPlan, devices_from_mesh, make_device_mesh

__all__ = [
    "DeviceMesh",
    "ShardPlan",
    "ShardedAMIHEngine",
    "ShardedScanEngine",
    "devices_from_mesh",
    "make_device_mesh",
    "make_retrieval_step",
    "sharded_scan_candidates",
    "sharded_scan_topk",
]
