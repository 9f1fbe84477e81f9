"""AMIH tuple-step overlap: verify step *t* while probing step *t+1* (a
port of the reference's ``pipeline/overlap.py``).

The sequential ``AMIHIndex`` group loop alternates strictly:

    probe(t)  ->  verify(t)  ->  bucket(t)  ->  emit(t)  ->  probe(t+1) ...

``verify`` is a kernel launch (K1, the grouped verify) or one vectorized
host popcount, and ``probe`` is host-side table walking — each leaves the
other resource idle. ``VerifyOverlap`` software-pipelines the loop one
step deep:

    probe(t)          | verify(t-1)  [side CUDA stream / worker thread]
    bucket+emit(t-1)  |
    submit verify(t)  |
    probe(t+1)        | verify(t)    ...

On a CUDA device, step t's K1 launches and the copies of their keys to
pinned host memory are queued on a side stream of the index's device, and
the host waits on a CUDA event recorded after them — never on the whole
device — when it flushes step t. Elsewhere (the CUDA verify's plain
version on a CPU device, or ``verify_backend="numpy"``) a worker thread
runs the verify, as the reference's does; steps below
``min_async_candidates`` candidates verify inline there.

Exactness is preserved because bucketing is order-independent *within* a
step: the candidates a tuple emits depend only on the probes performed up
to that tuple and on their exact verified tuples, never on when the
verification physically ran. Emission for step ``t`` happens only after
step ``t``'s verification has been joined and bucketed, so results (ids,
sims) are bit-identical to the sequential loop, and so are ``verified``
and the verify launch counts.

One visible difference is bounded over-probing: the pipelined loop probes
step ``t+1`` *before* it learns (at step ``t``'s emit) that a query just
filled its K results, so a finishing query may execute one extra probing
step. Its fresh candidates are dropped before verification, but the
probe-side counters (``probes`` / ``tuples_processed`` / ``max_radius``)
may run one step past the sequential ones.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

from ..core.tuples import rhat, sim_value
from ..obs import trace as _obs

__all__ = ["VerifyOverlap"]


class _Deferred:
    """Future-like wrapper of a deferred device verify: ``result()`` waits
    on the launches' CUDA events and returns the per-query keys."""

    __slots__ = ("_finish",)

    def __init__(self, finish):
        self._finish = finish

    def result(self):
        return self._finish()


class _PendingStep:
    """Verification in flight (or already resolved) for one tuple step."""

    __slots__ = ("r1", "r2", "s_val", "states", "blocks", "future", "keys")

    def __init__(self, r1, r2, s_val, states, blocks, future, keys=None):
        self.r1 = r1
        self.r2 = r2
        self.s_val = s_val
        self.states = states
        self.blocks = blocks
        self.future = future
        self.keys = keys               # inline-verified small steps


class VerifyOverlap:
    """Pipelined runner for ``AMIHIndex``'s per-z-group tuple loop.

    Holds one side CUDA stream per device it has verified on, and one
    background worker thread for the host verifies (created on first
    use). The worker only reads the index and the DB and writes nothing
    but its returned key arrays, so a plain thread is safe. One instance
    serves one engine; calls are not re-entrant (the engine layer
    serializes ``knn_batch`` calls per engine object).
    """

    def __init__(self, name: str = "amih-verify",
                 min_async_candidates: int = 2048):
        self._name = name
        self.min_async_candidates = min_async_candidates
        self._pool: Optional[ThreadPoolExecutor] = None
        self._streams: Dict[str, object] = {}
        self.device_steps = 0          # steps verified on a side stream

    def _submit(self, fn, *args) -> Future:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=self._name
            )
        return self._pool.submit(fn, *args)

    def _submit_device(self, index, states, blocks) -> _Deferred:
        """Queue the step's K1 launches on the device's side stream."""
        import torch

        dev = index.device
        key = str(dev)
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.Stream(device=dev)
        # the resident codes were placed on the default stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            finish = index._verify_group_cuda(states, blocks, deferred=True)
        self.device_steps += 1
        return _Deferred(finish)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._streams.clear()

    # ------------------------------------------------------- the loop
    def run_group(
        self,
        index,
        z: int,
        states: List,
        k: int,
        enumeration_cap: Optional[int],
        stop_below=None,
        on_done=None,
    ) -> None:
        """Pipelined replacement for ``AMIHIndex._run_group_sequential``:
        same states in, same out_ids/out_sims per state out (see the
        module docstring for the counter caveat)."""
        on_card = (index.verify_backend == "cuda"
                   and getattr(index.device, "type", None) == "cuda")
        r_hat = rhat(z)
        prev: Optional[_PendingStep] = None
        for (r1, r2) in index._probing_iter(z):
            alive = [s for s in states if not s.done]
            if not alive and prev is None:
                break
            s_val = sim_value(index.p, z, r1, r2)
            # Bound-stopped queries skip this step's probing, but their
            # `done` flag is only set AFTER the previous step's emission
            # below — the sequential loop emits step t-1 before it checks
            # the bound at step t, and so must we.
            bound_stopped, probing = [], alive
            if stop_below is not None:
                # one bound read per state: shared bounds may move between
                # reads (they only ever increase), and a state must land in
                # exactly one of the two lists.
                bound_stopped, probing = [], []
                for s in alive:
                    (bound_stopped if s_val < stop_below[s.qi]
                     else probing).append(s)
            # 1. probe step t on the host while step t-1 verifies.
            tr = _obs.current()
            t0 = _obs.now_us() if tr.enabled else 0.0
            fresh_states, fresh_blocks = [], []
            for s in probing:
                fresh = index._probe_step(s, r1, r2, r_hat, enumeration_cap)
                if fresh.size:
                    fresh_states.append(s)
                    fresh_blocks.append(fresh)
            if tr.enabled:
                tr.record("amih.probe", t0, _obs.now_us(), cat="amih",
                          z=z, r1=r1, r2=r2, queries=len(probing),
                          overlapped=True)
            # 2. flush step t-1: join its verification, bucket, emit.
            if prev is not None:
                self._flush(index, states, k, prev, on_done)
            for s in bound_stopped:
                s.done = True
            # 3. drop blocks of queries that just finished, then start
            #    step t's verification asynchronously.
            keep = [
                (s, b)
                for s, b in zip(fresh_states, fresh_blocks)
                if not s.done
            ]
            v_states = [s for s, _ in keep]
            v_blocks = [b for _, b in keep]
            for s, b in keep:
                if s.stats is not None:
                    s.stats.verified += b.size
            future = keys = None
            if v_blocks:
                if on_card:
                    future = self._submit_device(index, v_states, v_blocks)
                elif (sum(b.size for b in v_blocks)
                        >= self.min_async_candidates):
                    future = self._submit(
                        index._verify_keys, v_states, v_blocks
                    )
                else:   # tiny step: the thread hop costs more than it hides
                    keys = index._verify_keys(v_states, v_blocks)
            prev = _PendingStep(
                r1, r2, s_val, v_states, v_blocks, future, keys
            )
            if all(s.done for s in states):
                break
        if prev is not None:
            self._flush(index, states, k, prev, on_done)

    @staticmethod
    def _flush(index, states, k, step: _PendingStep, on_done=None) -> None:
        """Join the step's verification, bucket its keys, emit its tuple."""
        keys = (
            step.future.result() if step.future is not None else step.keys
        )
        if keys is not None:
            index._bucket_keys(step.states, step.blocks, keys)
        emitted = [s for s in states if not s.done]
        tr = _obs.current()
        t0 = _obs.now_us() if tr.enabled else 0.0
        index._emit_tuple(emitted, step.r1, step.r2, step.s_val, k)
        if tr.enabled:
            tr.record("amih.emit", t0, _obs.now_us(), cat="amih",
                      overlapped=True)
        if on_done is not None:
            index._notify_done(emitted, on_done)
