"""Cross-host serving tier: coordinator/worker cluster over TCP frames (a
port of the reference's ``repro.cluster`` whose workers run the port's
engines).

One coordinator fans query batches out to per-host workers — each
running the port's ``sharded_amih``/``sharded_scan`` engines over its
slice of a host-partitioned ``ShardPlan``, on the device the worker
was started on (the card unless it was given ``device="cpu"``) — over a length-prefixed TCP transport (framed
numpy + JSON headers, stdlib only, byte for byte the reference's frames),
merges the O(K) per-host exact result planes with the same lexsort the
single-host engines use, and broadcasts the monotone per-query
k-th-cosine floor between hosts so each host's probing stops early
against results found anywhere in the cluster. Results are bit-identical
to single-host ``sharded_amih`` and to per-query ``linear_scan_knn``.

Modules:

  - ``transport``   — framing: MAGIC + uint32 + JSON header + raw numpy
  - ``worker``      — one host's engine behind a frame loop
  - ``coordinator`` — fan-out, bound rebroadcast, merge; ClusterEngine
                      (registered as backend ``"cluster"``)
  - ``local``       — spawn-based localhost fleet (tests, smokes)
  - ``launch``      — ``python -m repro_torch.cluster.launch`` CLI
  - ``smoke``       — ``python -m repro_torch.cluster.smoke`` canary

Entry points: ``make_engine("cluster", db_words, p, hosts=2, ...)``, or
``RetrievalConfig(cluster=True, hosts=N)`` one level up (serving), or
the launcher for a real multi-host deployment. See docs/cluster.md for
the wire protocol and the bound-broadcast exactness argument.
"""

from .coordinator import (
    ClusterCoordinator,
    ClusterDegradedError,
    ClusterEngine,
    ClusterError,
    RemoteSearchError,
    RequestTimeoutError,
    WorkerDiedError,
)
from .local import LocalCluster
from .transport import FrameError, pack_ragged, recv_frame, send_frame, \
    unpack_ragged
from .worker import WorkerServer, serve

__all__ = [
    "ClusterCoordinator",
    "ClusterDegradedError",
    "ClusterEngine",
    "ClusterError",
    "FrameError",
    "LocalCluster",
    "RemoteSearchError",
    "RequestTimeoutError",
    "WorkerDiedError",
    "WorkerServer",
    "pack_ragged",
    "recv_frame",
    "send_frame",
    "serve",
    "unpack_ragged",
]
