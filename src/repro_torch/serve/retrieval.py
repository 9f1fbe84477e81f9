"""Retrieval service: encoder LM -> mean-pooled hidden state -> AQBC
binarization -> exact angular KNN through the port's ``SearchEngine``
(a port of the reference's ``serve/retrieval.py``).

``RetrievalService.build_index`` encodes the documents (the encoder's
attention runs K7), learns AQBC on the pooled states, packs the codes and
builds the engine; ``search_batch`` answers a batch of queries through
one ``knn_batch`` call, ``search`` is the B = 1 convenience, and
``submit``/``run_queued`` are the queued serving loop, streamed
(``stream=True``: one ``StepResult`` per batch step as it completes, the
next batch encoding while this one searches) or drained at once.

Backends: ``"amih"`` (the device walk by default; the host walk with
``probe_backend="host"`` and ``verify_backend="cuda"`` or ``"numpy"``)
and ``"linear_scan"`` (``compute_backend="cuda"`` or ``"numpy"``). The
encoder, AQBC and the engine run on ``RetrievalConfig.device``: None is
the CUDA device (it raises without one), ``"cpu"`` runs every kernel's
plain version. The encoder's parameters must lie on that device.
``single_table`` (ROADMAP A5), the sharded backends (A6), ``pipelined``
(A7) and ``cluster`` (A9) are not ported and raise
``NotImplementedError``.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import aqbc
from ..core.engine import EngineStats, SearchEngine, make_engine
from ..core.linear_scan import linear_scan_knn
from ..core.packing import pack_bits
from ..kernels.ops import resolve_device
from ..models import lm as lm_lib
from ..models.common import ArchConfig
from ..models.layers import apply_norm
from ..obs import trace as _obs_trace
from ..pipeline.stream import LatencyTracker, StepResult, Ticket, stream_search

__all__ = ["RetrievalConfig", "RetrievalService"]


@dataclass(frozen=True)
class RetrievalConfig:
    code_bits: int = 64
    aqbc_iters: int = 15
    m_tables: Optional[int] = None    # None -> paper's p/log2(n)
    batch_size: int = 32              # encode batch (padded to it)
    # engine backend: "amih" or "linear_scan"
    backend: str = "amih"
    # AMIH: the device walk ("device", one walk launch per batch) or the
    # host walk ("host") with the grouped verify on the card ("cuda", the
    # reference's "pallas") or on the host ("numpy")
    verify_backend: str = "cuda"
    probe_backend: str = "device"
    probe_stream_cap: int = 1 << 16
    probe_fused: bool = True
    # linear_scan: "cuda" (K4 streamed through a device top-K, float64
    # host rerank) or "numpy" (host popcounts)
    compute_backend: str = "cuda"
    enumeration_cap: Optional[int] = None
    search_batch_size: int = 32       # queued queries per knn_batch step
    pipelined: bool = False           # not ported: ROADMAP A7
    cluster: bool = False             # not ported: ROADMAP A9
    # True installs an enabled port Tracer at build_index (a float in
    # (0, 1] samples top-level spans at that probability); spans land on
    # ``service.engine.tracer``
    trace: object = False
    # where the encoder, AQBC and the engine run: None = the CUDA device
    device: Optional[object] = None


@dataclass
class RetrievalService:
    """End-to-end retrieval serving over one encoder LM and one engine.

    Construct with an encoder config and its parameters (on
    ``rcfg.device``) and a ``RetrievalConfig``; ``build_index(doc_tokens)``
    builds the engine; then ``search_batch``/``search``, or ``submit`` and
    ``run_queued``. ``close()`` releases what the engine holds.
    """

    cfg: ArchConfig
    params: object
    rcfg: RetrievalConfig = field(default_factory=RetrievalConfig)

    engine: Optional[SearchEngine] = None
    rotation: Optional[torch.Tensor] = None
    db_words: Optional[np.ndarray] = None
    shift: Optional[np.ndarray] = None   # non-negativity shift, fit at build
    _queue: List[Tuple[Ticket, np.ndarray]] = field(default_factory=list)
    _next_qid: int = 0
    # guards _queue/_next_qid: submit may be called from many request
    # threads while run_queued drains
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)
    # rolling submit->resolve latency over answered queries (ms)
    _latency: LatencyTracker = field(default_factory=LatencyTracker,
                                     repr=False)

    @property
    def device(self) -> torch.device:
        return resolve_device(self.rcfg.device)

    # ------------------------------------------------------------ encoding
    def _pooled(self, tokens: torch.Tensor) -> torch.Tensor:
        """Mean-pooled final-norm hidden states (not logits), float32."""
        cfg = self.cfg
        h = lm_lib.embed_tokens(cfg, self.params, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        h = lm_lib._apply_stack(cfg, self.params["layers"], h, positions)
        h = apply_norm(h, self.params["final_norm"], cfg.norm)
        return h.mean(dim=1).float()

    def embed(self, token_batches: np.ndarray) -> np.ndarray:
        """(N, S) int32 tokens -> (N, d_model) float32 mean-pooled states,
        ``batch_size`` rows per forward (the last batch zero-padded)."""
        dev = self.device
        B = self.rcfg.batch_size
        toks = np.asarray(token_batches, np.int32)
        out = []
        with torch.no_grad():
            for i in range(0, len(toks), B):
                chunk = toks[i : i + B]
                rows = len(chunk)
                if rows < B:
                    chunk = np.pad(chunk, ((0, B - rows), (0, 0)))
                t = torch.from_numpy(chunk.astype(np.int64)).to(dev)
                out.append(self._pooled(t).cpu().numpy()[:rows])
        return np.concatenate(out, axis=0)

    def _shifted(self, x: np.ndarray, fit: bool) -> np.ndarray:
        """AQBC assumes non-negative data: shift into the positive orthant
        per dimension. The shift is fit on the corpus and reused for
        queries."""
        if fit:
            self.shift = x.min(axis=0, keepdims=True)
        return np.maximum(x - self.shift, 0.0)

    def _codes(self, x: np.ndarray) -> np.ndarray:
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return pack_bits(aqbc.encode(xt, self.rotation).cpu().numpy())

    # ------------------------------------------------------------ indexing
    def build_index(self, doc_tokens: np.ndarray,
                    aqbc_init=None) -> Dict[str, float]:
        """Encode the corpus, learn AQBC (from ``aqbc_init``, a (d, c)
        rotation, where given), pack the codes and build the engine. With
        tracing on, the three steps record ``retrieval.encode``,
        ``retrieval.aqbc`` and ``retrieval.index`` spans."""
        rc = self.rcfg
        if rc.pipelined:
            raise NotImplementedError(
                "RetrievalConfig(pipelined=True) is not ported yet: "
                "ROADMAP A7")
        if rc.cluster:
            raise NotImplementedError(
                "RetrievalConfig(cluster=True) is not ported yet: "
                "ROADMAP A9")
        tr = _obs_trace.current()
        with tr.span("retrieval.encode", cat="serve", n=len(doc_tokens)):
            x = self._shifted(self.embed(doc_tokens), fit=True)
        with tr.span("retrieval.aqbc", cat="serve"):
            model = aqbc.learn(torch.from_numpy(x).to(self.device),
                               rc.code_bits, iters=rc.aqbc_iters,
                               init_rotation=aqbc_init)
            self.rotation = model.rotation
            self.db_words = self._codes(x)       # ends in a host copy
        cfg: Dict[str, object] = {}
        if rc.backend == "amih":
            cfg = {
                "m": rc.m_tables,
                "verify_backend": rc.verify_backend,
                "enumeration_cap": rc.enumeration_cap,
                "probe_backend": rc.probe_backend,
                "probe_stream_cap": rc.probe_stream_cap,
                "probe_fused": rc.probe_fused,
                "device": rc.device,
            }
        elif rc.backend == "linear_scan":
            cfg = {"compute_backend": rc.compute_backend,
                   "device": rc.device}
        if rc.trace:
            sample = (float(rc.trace) if isinstance(rc.trace, float)
                      else 1.0)
            cfg["tracer"] = _obs_trace.Tracer(enabled=True, sample=sample,
                                              host="coordinator")
        with tr.span("retrieval.index", cat="serve"):
            self.engine = make_engine(rc.backend, self.db_words,
                                      rc.code_bits, **cfg)
        index = getattr(self.engine, "index", None)
        trace = model.objective_trace
        return {
            "n_docs": float(len(doc_tokens)),
            "aqbc_objective": float(trace[-1]) if len(trace) else 0.0,
            "m_tables": float(getattr(index, "m", 0)),
        }

    # -------------------------------------------------------------- search
    def encode_query(self, query_tokens: np.ndarray) -> np.ndarray:
        q = np.asarray(query_tokens)
        x = self._shifted(self.embed(q[None, :] if q.ndim == 1 else q),
                          fit=False)
        return self._codes(x)

    def search_batch(
        self, query_tokens: np.ndarray, k: int = 10
    ) -> Tuple[np.ndarray, np.ndarray, EngineStats]:
        """Exact angular KNN for a batch of queries through one
        ``knn_batch`` call. Returns (ids (B, k'), sims (B, k'), stats)."""
        assert self.engine is not None, "call build_index first"
        return self.engine.knn_batch(self.encode_query(query_tokens), k)

    def search(self, query_tokens: np.ndarray, k: int = 10):
        """Single-query convenience over ``search_batch``: (ids, sims,
        the query's own stats object)."""
        q = np.asarray(query_tokens)
        ids, sims, stats = self.search_batch(q[None, :] if q.ndim == 1
                                             else q, k)
        return ids[0], sims[0], stats.per_query[0]

    # ------------------------------------------------------ queued serving
    def submit(self, query_tokens: np.ndarray) -> Ticket:
        """Enqueue a query for the next batched search step (thread-safe);
        the ``Ticket``'s future resolves to its (ids, sims)."""
        toks = np.asarray(query_tokens)
        with self._lock:
            ticket = Ticket(self._next_qid)
            self._next_qid += 1
            self._queue.append((ticket, toks))
        return ticket

    def queue_depth(self) -> int:
        """Queries currently waiting for a ``run_queued`` drain."""
        with self._lock:
            return len(self._queue)

    def run_queued(self, k: int = 10, stream: bool = False):
        """Drain the queue, ``search_batch_size`` queries per knn_batch
        step.

        ``stream=False``: block until the drain completes and return
        qid -> (ids, sims). ``stream=True``: an iterator of
        ``StepResult``s, one per step as it completes, each step's stats
        carrying ``queue_depth`` and rolling p50/p99 ``latency_ms``.

        Queries submitted after the drain snapshot wait for the next
        drain. If a step raises, the unanswered queries go back to the
        queue's front; their current futures fail with the step's
        exception and are replaced with fresh ones for the retry. A
        consumer that abandons the stream re-queues the unanswered
        queries with their futures left pending.
        """
        if stream:
            return self._run_queued_stream(k)
        out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for step in self._run_queued_stream(k):
            out.update(step.results)
        return out

    def _run_queued_stream(self, k: int) -> Iterator[StepResult]:
        assert self.engine is not None, "call build_index first"
        step_size = max(1, self.rcfg.search_batch_size)
        with self._lock:
            pending = self._queue
            self._queue = []
        steps = [pending[lo : lo + step_size]
                 for lo in range(0, len(pending), step_size)]
        done_steps = 0
        try:
            results = stream_search(
                self.engine,
                [np.stack([t for _, t in batch]) for batch in steps],
                k,
                encode=self.encode_query,   # latency stamped below
            )
            for sr in results:
                now = time.perf_counter()
                for row, (ticket, _) in enumerate(steps[sr.step]):
                    pair = (sr.ids[row], sr.sims[row])
                    sr.results[ticket.qid] = pair
                    self._latency.record(1e3 * (now - ticket.submitted_at))
                    ticket.future.set_result(pair)
                sr.stats.latency_ms = self._latency.snapshot()
                sr.stats.queue_depth += self.queue_depth()
                done_steps += 1
                yield sr
        except GeneratorExit:
            self._requeue(steps[done_steps:])
            raise
        except BaseException as exc:
            for ticket, _ in self._requeue(steps[done_steps:]):
                failed, ticket.future = ticket.future, Future()
                failed.set_exception(exc)
            raise

    def _requeue(self, unanswered_steps):
        """Push un-drained batches back onto the queue's front."""
        requeued = [item for batch in unanswered_steps for item in batch]
        with self._lock:
            self._queue[:0] = requeued
        return requeued

    def search_linear(self, query_tokens: np.ndarray, k: int = 10):
        """Exhaustive host scan over the same codes (a cross-check)."""
        return linear_scan_knn(self.encode_query(query_tokens)[0],
                               self.db_words, k)

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Release what the engine holds. Idempotent; safe before
        build_index."""
        close = getattr(self.engine, "close", None)
        if callable(close):
            close()
