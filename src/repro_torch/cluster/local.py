"""Localhost worker fleet: the real wire protocol on one machine (a port
of the reference's ``cluster/local.py``).

``LocalCluster(hosts)`` spawns one worker PROCESS per host on loopback
ephemeral ports and reports their addresses, so tests, the smoke canaries
and ``chip_smoke.py`` exercise the exact coordinator/worker protocol —
framing, bound broadcast, heartbeats, death handling — with no second
machine.

The ``spawn`` start method (``multiprocessing.get_context``, never the
process-wide ``set_start_method``) is deliberate: each worker is a FRESH
interpreter, because a child forked from a process that has initialised
CUDA cannot use CUDA, and because a real deployment's workers are
independent processes too. A worker imports only
``repro_torch.cluster.worker`` and, unless the fleet was given
``device="cpu"``, opens its own CUDA context at its first build. Workers announce their bound
``(host, port)`` back over a pipe before serving.

``kill_worker(i)`` SIGKILLs one worker — the failure-injection hook the
killed-worker tests use; ``close()`` terminates the fleet, killing any
worker that does not exit, and joins every one (idempotent).
"""

from __future__ import annotations

import multiprocessing as mp
from typing import List, Tuple

__all__ = ["LocalCluster"]


def _worker_main(announce, device) -> None:
    # runs in the spawned interpreter; imports resolve there
    from repro_torch.cluster.worker import serve

    serve(host="127.0.0.1", port=0, announce=announce, device=device)


class LocalCluster:
    """``hosts`` spawned loopback workers; ``addresses[i]`` is worker
    ``i``'s ``(host, port)``. ``device`` is every worker's device (None:
    the CUDA device; ``"cpu"`` runs the plain versions)."""

    def __init__(self, hosts: int, start_timeout: float = 120.0,
                 device=None):
        if hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {hosts}")
        ctx = mp.get_context("spawn")
        self.procs: List[mp.Process] = []
        self.addresses: List[Tuple[str, int]] = []
        pipes = []
        try:
            for _ in range(hosts):
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_worker_main,
                    args=(child, None if device is None else str(device)),
                    daemon=True,
                )
                proc.start()
                child.close()
                self.procs.append(proc)
                pipes.append(parent)
            for i, parent in enumerate(pipes):
                if not parent.poll(start_timeout):
                    raise RuntimeError(
                        f"worker {i} did not announce its address "
                        f"within {start_timeout:.0f}s"
                    )
                self.addresses.append(tuple(parent.recv()))
                parent.close()
        except BaseException:
            self.close()
            raise

    def kill_worker(self, i: int) -> None:
        """SIGKILL worker ``i`` — no shutdown handshake, the coordinator
        sees a raw connection drop. Failure-injection hook for tests."""
        self.procs[i].kill()
        self.procs[i].join(timeout=10.0)

    def close(self) -> None:
        for proc in self.procs:
            if proc.is_alive():
                proc.terminate()
        for proc in self.procs:
            proc.join(timeout=10.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass   # interpreter shutdown
