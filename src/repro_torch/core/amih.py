"""Angular Multi-Index Hashing — the paper's primary contribution (§5, RQ2).

Long p-bit codes are split into ``m`` disjoint substrings; each substring is
indexed in its own table (CSR-sorted, see single_table.py). An exact angular
KNN query walks the full-code tuple sequence (probing.py) in decreasing-sim
order; before emitting the codes at full tuple ``(r1, r2)`` it performs the
substring probes required by Proposition 4:

    T_{r1,r2,m} = { (a, b) : a + b <= floor((r1+r2)/m), a <= r1, b <= r2 }

probed in *every* table. Any code with Hamming tuple <= (r1, r2) — in
particular, exactly (r1, r2) — is guaranteed (pigeonhole) to fall in one of
those buckets, so emission order is exact. Retrieved candidates are verified
once (dedup bitmap) by computing their exact full-code tuple with popcounts.

Counters mirror the paper's cost model (Eq. 13): probes (bucket lookups) and
candidate verifications are the two cost terms.

Batched queries (``knn_batch``) follow the multi-index-hashing serving
shape: queries with identical ``(p, z)`` share one probing-sequence
enumeration (the heap + exact-rational ordering is per-*group*, not
per-query) and advance in lockstep over full-code tuples. Each tuple step
is a probe -> verify -> bucket -> emit pipeline:

  1. probe: every active query runs its outstanding substring-tuple
     probes (host, per-query — the tables are host CSR structures) and
     collects its *fresh* candidate ids;
  2. verify: the whole z-group is verified in ONE call. With
     ``verify_backend="numpy"`` that is a single vectorized popcount over
     the concatenated blocks; with ``verify_backend="cuda"`` (the
     reference's ``"pallas"``) the blocks become a padded ``(B_g, C_max)``
     index matrix (power-of-two padding buckets) and one grouped-verify
     kernel launch per (z-group, tuple-step) returns packed bucket keys
     ``r10 * (p + 1) + r01`` — candidate rows are gathered inside the
     kernel from the copy of ``db_words`` placed on the device once at
     build, so only the index and key matrices cross to and from the card
     (see kernels/ops.verify_tuples_grouped_launch);
  3. bucket: keys are grouped by one stable argsort per query (no
     ``np.unique(axis=0)`` on the hot path) into the pending dict;
  4. emit: codes whose bucket equals the current tuple are appended in
     ascending-id order at the host float64 ``sim_value`` — emission sims
     never round-trip through float32, keeping results bit-identical to
     ``linear_scan_knn``.

``verify_launches`` on the index counts grouped verification dispatches
(one per (z-group, tuple-step) unless a block exceeds the element budget).

A port of the reference's ``core/amih.py``: the same index, the same walk,
the same statistics. ``knn_batch(..., overlap=VerifyOverlap())``
(``repro_torch.pipeline.overlap``) pipelines each z-group's host walk one
tuple step deep: step t's grouped verify runs while the host probes step
t + 1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..obs import trace as _obs
from .enumeration import tuple_bucket_values
from .packing import (
    WORD_DTYPE,
    extract_substring,
    hamming_tuples,
    popcount,
    substring_spans,
)
from .probing import shared_probing_iter
from .tuples import rhat, sim_value

__all__ = ["AMIHIndex", "AMIHStats", "default_num_tables"]

_EMPTY_IDS = np.empty(0, dtype=np.int64)


def default_num_tables(p: int, n: int) -> int:
    """Paper §5.2 / §6.2: m ≈ p / log2(n), clamped to [ceil(p/64), p].

    The lower clamp keeps every substring <= 64 bits so bucket indices fit
    an integer word (the paper's tables are likewise word-indexed).
    """
    m_min = (p + 63) // 64
    if n < 2:
        return m_min
    m = int(round(p / max(1.0, math.log2(n))))
    return max(m_min, min(p, m))


@dataclass
class AMIHStats:
    probes: int = 0              # bucket lookups across all tables
    retrieved: int = 0           # ids pulled from buckets (incl. cross-table dups)
    verified: int = 0            # unique candidates tuple-verified
    tuples_processed: int = 0    # full-code tuples traversed
    substring_tuples_probed: int = 0
    max_radius: int = 0
    exceeded_rhat: bool = False
    # The paper (§5) observes that when required probes exceed the dataset
    # size, linear scan is the faster alternative. We make that a guard:
    # once a single substring-tuple's bucket enumeration would cost more
    # than verifying every stored code, the query degrades gracefully to a
    # full verification pass (still exact).
    fell_back_to_scan: bool = False


@dataclass
class _SubTable:
    lo: int
    hi: int
    sorted_vals: np.ndarray = field(repr=False)
    sorted_ids: np.ndarray = field(repr=False)

    @property
    def width(self) -> int:
        return self.hi - self.lo

    def probe(self, bucket_vals: np.ndarray) -> np.ndarray:
        if bucket_vals.size == 0:
            return np.empty(0, dtype=np.int64)
        lo = np.searchsorted(self.sorted_vals, bucket_vals, side="left")
        hi = np.searchsorted(self.sorted_vals, bucket_vals, side="right")
        nz = hi > lo
        if not nz.any():
            return np.empty(0, dtype=np.int64)
        parts = [self.sorted_ids[l:h] for l, h in zip(lo[nz], hi[nz])]
        return np.concatenate(parts)


@dataclass
class _QueryState:
    """Per-query probing state inside a batched search.

    ``cover[s]`` maps substring-tuple weight ``a`` to the largest ``b``
    already probed in table ``s``. Probes for one (s, a) always extend a
    contiguous prefix b = 0..bmax, so the max-b staircase is a lossless
    (and O(1)-membership) replacement for the old probed-(s, a, b) set.
    ``scanned`` marks a query degraded to full verification (every id
    seen) — no more probing needed.
    """

    qi: int                       # row in the query batch
    q_words: np.ndarray
    q_subs: List[int]
    z_subs: List[int]
    seen: np.ndarray
    cover: List[Dict[int, int]]
    pending: Dict[Tuple[int, int], List[np.ndarray]]
    out_ids: List[int]
    out_sims: List[float]
    stats: Optional[AMIHStats]
    scanned: bool = False
    done: bool = False


@dataclass
class AMIHIndex:
    """Exact angular-KNN index over n packed p-bit codes.

    ``id_offset`` supports shard-local builds: an index over rows
    [offset, offset + n) of a larger sharded DB emits *global* ids
    (local row + offset) from every public search method, so per-shard
    result lists merge without any caller-side remapping. Internal state
    (tables, dedup bitmaps, device gathers) stays local-row-indexed.

    ``device`` places the index's device state (``db_dev``, the device
    CSR) and runs every kernel launch there. ``build`` resolves it for the
    backends that need a device: ``None`` means the CUDA device, and
    raises where there is none; ``"cpu"`` runs the kernels' plain PyTorch
    versions. The defaults are the device walk (``probe_backend="device"``)
    and, for the host walk, the CUDA grouped verify
    (``verify_backend="cuda"``); only the host walk with
    ``verify_backend="numpy"``, asked for explicitly, needs no device.
    """

    p: int
    m: int
    db_words: np.ndarray = field(repr=False)   # (n, W) uint32 — for verification
    tables: List[_SubTable] = field(repr=False, default_factory=list)
    id_offset: int = 0
    # Placement device (a torch.device) of db_dev, the CSR and the launches.
    device: Optional[object] = field(default=None, compare=False)
    # Candidate-verification backend: "numpy" (one vectorized host popcount
    # per z-group and tuple step) or "cuda" (one grouped-verify kernel
    # launch per z-group and tuple step; its plain PyTorch version on a
    # CPU device). Both are exact.
    verify_backend: str = "cuda"
    # Probing backend: "host" walks the tuple sequence in the Python
    # group loop below; "device" runs the whole walk — probe-step
    # enumeration, CSR bucket lookup, candidate dedup, verification, and
    # Prop. 2 early termination — in ONE kernel launch per batch, every
    # z-group fused (see core/probe_device.py and
    # kernels/device_probe.py). Both are exact and bit-identical.
    probe_backend: str = "device"
    # Device-path schedule bound: max precomputed probe-stream entries
    # per (p, z). Walks that would exceed it are truncated and finish
    # through the fused scan fallback (the device analogue of the host
    # enumeration-cap guard).
    probe_stream_cap: int = 1 << 16
    # Device-path launch shape: True (default) fuses every z-group of a
    # batch into ONE walk launch via the schedule stack; False keeps the
    # one-launch-per-z-group shape (the fused path's parity oracle).
    probe_fused: bool = True
    # Grouped verification dispatches so far (one per (z-group, tuple-step)
    # with fresh candidates, unless a step exceeds verify_elem_budget and
    # is chunked). Benchmarks/tests assert launch economy through this.
    verify_launches: int = 0
    # Cap on padded gather elements (B_g_pad * C_max_pad * W words) per
    # device launch; oversized steps (e.g. a fell-back-to-scan query whose
    # block is the whole DB) are split across launches instead of
    # materializing an unbounded (B_g, C_max, W) buffer.
    verify_elem_budget: int = 1 << 24
    # Device-resident copy of db_words: placed once (eagerly at build for
    # the host walk with verify_backend="cuda", lazily otherwise) so grouped verification
    # gathers candidate rows on device instead of re-shipping them per call.
    _db_dev: Optional[object] = field(
        default=None, repr=False, compare=False
    )
    # Device-resident CSR bucket layout (offsets + sorted ids + padded
    # codes), built next to db_dev for probe_backend="device".
    _device_csr: Optional[dict] = field(
        default=None, repr=False, compare=False
    )

    # ------------------------------------------------------------- build
    @classmethod
    def build(
        cls,
        db_words: np.ndarray,
        p: int,
        m: Optional[int] = None,
        verify_backend: str = "cuda",
        id_offset: int = 0,
        device: Optional[object] = None,
        probe_backend: str = "device",
        probe_stream_cap: int = 1 << 16,
        probe_fused: bool = True,
    ) -> "AMIHIndex":
        db_words = np.ascontiguousarray(db_words, dtype=WORD_DTYPE)
        n = db_words.shape[0]
        if m is None:
            m = default_num_tables(p, n)
        if p / m > 64:
            raise ValueError(
                f"m={m} gives substrings wider than 64 bits for p={p}; "
                f"need m >= {(p + 63) // 64}"
            )
        tables = []
        for (lo, hi) in substring_spans(p, m):
            vals = extract_substring(db_words, lo, hi)
            order = np.argsort(vals, kind="stable")
            tables.append(
                _SubTable(
                    lo=lo,
                    hi=hi,
                    sorted_vals=vals[order],
                    sorted_ids=np.arange(n, dtype=np.int64)[order],
                )
            )
        return cls.from_tables(
            db_words, p, m, tables, verify_backend=verify_backend,
            id_offset=id_offset, device=device, probe_backend=probe_backend,
            probe_stream_cap=probe_stream_cap, probe_fused=probe_fused,
        )

    @classmethod
    def from_tables(
        cls,
        db_words: np.ndarray,
        p: int,
        m: int,
        tables: List[_SubTable],
        verify_backend: str = "cuda",
        id_offset: int = 0,
        device: Optional[object] = None,
        probe_backend: str = "device",
        probe_stream_cap: int = 1 << 16,
        probe_fused: bool = True,
    ) -> "AMIHIndex":
        """The index over already-sorted substring ``tables`` (``build``'s
        second half; ``repro_torch.convert`` enters here)."""
        if verify_backend not in ("numpy", "cuda"):
            raise ValueError(f"unknown verify_backend {verify_backend!r}")
        if probe_backend not in ("host", "device"):
            raise ValueError(f"unknown probe_backend {probe_backend!r}")
        if verify_backend == "cuda" or probe_backend == "device":
            from ..kernels.ops import resolve_device

            device = resolve_device(device)
        index = cls(
            p=p, m=m, db_words=db_words, tables=tables,
            verify_backend=verify_backend, id_offset=id_offset,
            device=device, probe_backend=probe_backend,
            probe_stream_cap=probe_stream_cap, probe_fused=probe_fused,
        )
        if verify_backend == "cuda" and probe_backend == "host":
            index.db_dev  # place once, at build time
        if probe_backend == "device":
            index.device_csr  # validate widths + place once, at build
        return index

    @property
    def n(self) -> int:
        return self.db_words.shape[0]

    @property
    def db_dev(self):
        """The (n, W) codes as an int32 tensor on ``device`` (placed on
        first access)."""
        if self._db_dev is None:
            from ..kernels.ops import to_device

            self._db_dev = to_device(self.db_words, self.device)
        return self._db_dev

    @property
    def device_csr(self) -> dict:
        """Device-resident CSR bucket layout for the fused probing walk
        (built and placed on ``device`` on first access; eagerly at build
        for ``probe_backend="device"``)."""
        if self._device_csr is None:
            from .probe_device import build_device_csr

            self._device_csr = build_device_csr(self)
        return self._device_csr

    # ------------------------------------------------------------- search
    def knn(
        self,
        q_words: np.ndarray,
        k: int,
        stats: Optional[AMIHStats] = None,
        enumeration_cap: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact angular K nearest neighbors of a packed query.

        Returns (ids, sims); deterministic up to ties inside the final
        tuple (all codes of one tuple are exactly equidistant in angle).
        """
        q_words = np.asarray(q_words, dtype=WORD_DTYPE)
        ids, sims = self.knn_batch(
            q_words[None, :], k,
            stats=None if stats is None else [stats],
            enumeration_cap=enumeration_cap,
        )
        return ids[0], sims[0]

    def knn_batch(
        self,
        q_words: np.ndarray,
        k: int,
        stats: Optional[List[AMIHStats]] = None,
        enumeration_cap: Optional[int] = None,
        overlap=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact angular KNN for a batch of packed queries: (B, W) -> ids,
        sims each (B, min(k, n)).

        Queries with equal popcount z share one probing-sequence
        enumeration and advance in lockstep through the probe ->
        grouped-verify -> bucket -> emit pipeline (one verification call
        per z-group and tuple step, see module docstring); each query
        keeps its own dedup bitmap / probe-cover staircase / pending
        buckets, so per-query results and counters are identical to
        ``knn`` run query-by-query.

        ``overlap`` (a ``repro_torch.pipeline.VerifyOverlap``) pipelines
        each group's host walk one tuple step deep (see
        pipeline/overlap.py); the device walk has no host loop to overlap
        and ignores it.
        """
        q_words = np.ascontiguousarray(
            np.atleast_2d(np.asarray(q_words, dtype=WORD_DTYPE))
        )
        B = q_words.shape[0]
        if stats is not None and len(stats) != B:
            raise ValueError(f"stats list has {len(stats)} entries for B={B}")
        k = min(k, self.n)
        out_ids = np.empty((B, k), dtype=np.int64)
        out_sims = np.empty((B, k), dtype=np.float64)
        if k == 0:
            return out_ids, out_sims
        for s in self._run_groups(
            q_words, k, stats, enumeration_cap, overlap=overlap
        ):
            out_ids[s.qi] = s.out_ids
            out_sims[s.qi] = s.out_sims
        if self.id_offset:
            out_ids += self.id_offset
        return out_ids, out_sims

    def knn_batch_bounded(
        self,
        q_words: np.ndarray,
        k: int,
        stop_below: np.ndarray,
        stats: Optional[List[AMIHStats]] = None,
        enumeration_cap: Optional[int] = None,
        overlap=None,
        on_done=None,
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """``knn_batch`` with a per-query early-termination bound: query
        ``qi`` stops as soon as the next probing tuple's sim drops
        *strictly below* ``stop_below[qi]``, so its result list may hold
        fewer than k entries (ragged -> returned as a per-query list).

        This is the cross-shard termination rule of the sharded AMIH
        engine: once the global top-K heap (merged from other shards)
        holds K results with k-th cosine >= bound, a shard may stop —
        every un-emitted local code has sim <= the current tuple's
        sim < bound and cannot enter the global top-K. Ties at exactly
        the bound are still collected, so the merged sims stay
        bit-identical to an unsharded search. Emitted ids carry
        ``id_offset`` like every public method.

        ``stop_below`` is re-read at EVERY tuple step through a no-copy
        view, so callers may hand in a live array whose entries are
        raised concurrently (a shard-parallel shared bound): as long as
        each entry only ever
        increases and stays a valid lower bound on the query's global
        k-th cosine, results remain exact. The live contract requires a
        float64 array of shape (B,) — any other dtype or shape is
        SNAPSHOTTED by the entry conversion (results stay exact, but
        concurrent raises are never observed).

        ``on_done(qi, ids, sims)`` fires the moment query ``qi`` fills
        its K results (its final, already-offset id/sim arrays), while
        this search may still be probing other queries.
        """
        q_words = np.ascontiguousarray(
            np.atleast_2d(np.asarray(q_words, dtype=WORD_DTYPE))
        )
        B = q_words.shape[0]
        bounds_in = np.asarray(stop_below, dtype=np.float64)
        bounds = (
            bounds_in if bounds_in.shape == (B,)
            else np.broadcast_to(bounds_in, (B,))
        )
        if stats is not None and len(stats) != B:
            raise ValueError(f"stats list has {len(stats)} entries for B={B}")
        k = min(k, self.n)
        empty = (_EMPTY_IDS, np.empty(0, dtype=np.float64))
        out: List[Tuple[np.ndarray, np.ndarray]] = [empty] * B
        if k == 0:
            return out
        for s in self._run_groups(
            q_words, k, stats, enumeration_cap, stop_below=bounds,
            overlap=overlap, on_done=on_done,
        ):
            ids = np.asarray(s.out_ids, dtype=np.int64) + self.id_offset
            out[s.qi] = (ids, np.asarray(s.out_sims, dtype=np.float64))
        return out

    def _run_groups(
        self,
        q_words: np.ndarray,
        k: int,
        stats: Optional[List[AMIHStats]],
        enumeration_cap: Optional[int],
        stop_below: Optional[np.ndarray] = None,
        overlap=None,
        on_done=None,
    ) -> List[_QueryState]:
        """Shared group loop of ``knn_batch`` / ``knn_batch_bounded``:
        same-z queries advance in lockstep through the probe ->
        grouped-verify -> bucket -> emit pipeline. Returns every query's
        final state (out_ids/out_sims hold LOCAL row ids).

        With ``probe_backend="device"`` the whole group loop is replaced
        by the fused device walk (ONE launch for the whole batch — every
        z-group shares it via the schedule stack — plus at most one
        scan-fallback launch; ``probe_fused=False`` restores the
        one-launch-per-z-group shape): results and the early-termination
        contract are identical, but ``enumeration_cap`` is a no-op there —
        the device path bounds work through ``probe_stream_cap`` and the
        fused scan, and ``overlap`` is ignored (no host loop to overlap).
        With ``overlap`` each group's host loop is software-pipelined one
        tuple step deep instead (pipeline/overlap.py)."""
        if self.probe_backend == "device":
            from .probe_device import run_groups_device

            return run_groups_device(
                self, q_words, k, stats,
                stop_below=stop_below, on_done=on_done,
            )
        B = q_words.shape[0]
        zs = popcount(q_words)
        groups: Dict[int, List[int]] = {}
        for qi in range(B):
            groups.setdefault(int(zs[qi]), []).append(qi)

        done_states: List[_QueryState] = []
        for z, qis in groups.items():
            states = [self._make_state(q_words[qi], qi, stats) for qi in qis]
            if overlap is not None:
                overlap.run_group(
                    self, z, states, k, enumeration_cap, stop_below,
                    on_done=on_done,
                )
            else:
                self._run_group_sequential(
                    z, states, k, enumeration_cap, stop_below, on_done
                )
            done_states.extend(states)
        return done_states

    def _notify_done(self, states, on_done) -> None:
        """Fire ``on_done`` for states that just filled their K (their
        result lists are final from this point on)."""
        for s in states:
            if s.done:
                on_done(
                    s.qi,
                    np.asarray(s.out_ids, dtype=np.int64) + self.id_offset,
                    np.asarray(s.out_sims, dtype=np.float64),
                )

    def _run_group_sequential(
        self,
        z: int,
        states: List[_QueryState],
        k: int,
        enumeration_cap: Optional[int],
        stop_below: Optional[np.ndarray],
        on_done=None,
    ) -> None:
        """One z-group's strict probe -> verify -> bucket -> emit loop."""
        r_hat = rhat(z)
        # spans observe the loop, never reorder it: the traced path runs
        # the identical statements, it only reads the clock around them
        tr = _obs.current()
        traced = tr.enabled
        for (r1, r2) in self._probing_iter(z):
            active = [s for s in states if not s.done]
            if not active:
                break
            s_val = sim_value(self.p, z, r1, r2)
            if stop_below is not None:
                # every later tuple has sim <= s_val: below the bound
                # nothing more from this query can reach the global
                # top-K (ties at the bound keep probing).
                for s in active:
                    if s_val < stop_below[s.qi]:
                        s.done = True
                active = [s for s in active if not s.done]
                if not active:
                    break
            # 1. probe: per-query table lookups -> fresh candidate ids
            t0 = _obs.now_us() if traced else 0.0
            fresh_states: List[_QueryState] = []
            fresh_blocks: List[np.ndarray] = []
            for s in active:
                fresh = self._probe_step(s, r1, r2, r_hat, enumeration_cap)
                if fresh.size:
                    if s.stats is not None:
                        s.stats.verified += fresh.size
                    fresh_states.append(s)
                    fresh_blocks.append(fresh)
            if traced:
                tr.record("amih.probe", t0, _obs.now_us(), cat="amih",
                          z=z, r1=r1, r2=r2, queries=len(active))
            # 2+3. verify the whole z-group in one call and bucket
            if fresh_blocks:
                self._verify_and_bucket(fresh_states, fresh_blocks)
            # 4. emit this tuple's bucket per query
            t0 = _obs.now_us() if traced else 0.0
            self._emit_tuple(active, r1, r2, s_val, k)
            if traced:
                tr.record("amih.emit", t0, _obs.now_us(), cat="amih", z=z)
            if on_done is not None:
                self._notify_done(active, on_done)

    def _probe_step(
        self,
        s: _QueryState,
        r1: int,
        r2: int,
        r_hat: int,
        enumeration_cap: Optional[int],
    ) -> np.ndarray:
        """Per-query probing for one tuple step, with its stats updates
        (shared by the sequential and the pipelined group loop)."""
        if s.stats is not None:
            s.stats.tuples_processed += 1
            s.stats.max_radius = max(s.stats.max_radius, r1 + r2)
            if r1 + r2 > r_hat:
                s.stats.exceeded_rhat = True
        return self._probe_tables_for_tuple(s, r1, r2, enumeration_cap)

    def _emit_tuple(self, states, r1: int, r2: int, s_val: float, k: int):
        """Step 4: emit tuple (r1, r2)'s bucket for each given state, in
        ascending-id order at the host float64 sim, capping at k."""
        for s in states:
            hits = s.pending.pop((r1, r2), None)
            if hits:
                ids = np.sort(np.concatenate(hits))
                take = min(ids.size, k - len(s.out_ids))
                s.out_ids.extend(ids[:take].tolist())
                s.out_sims.extend([s_val] * take)
                if len(s.out_ids) >= k:
                    s.done = True

    def _probing_iter(self, z: int) -> Iterator[Tuple[int, int]]:
        """Probing sequence for popcount z, served from the MODULE-level
        shared cache (core/probing.py): the heap + exact-rational tuple
        ordering depends only on (p, z), so one materialized prefix serves
        every index, shard, and batch in the process."""
        return shared_probing_iter(self.p, z)

    def _make_state(
        self,
        q_words: np.ndarray,
        qi: int,
        stats: Optional[List[AMIHStats]],
    ) -> _QueryState:
        q_subs = [
            int(extract_substring(q_words[None, :], t.lo, t.hi)[0])
            for t in self.tables
        ]
        return _QueryState(
            qi=qi,
            q_words=q_words,
            q_subs=q_subs,
            z_subs=[int(v).bit_count() for v in q_subs],
            seen=np.zeros(self.n, dtype=bool),
            cover=[{} for _ in self.tables],
            pending={},
            out_ids=[],
            out_sims=[],
            stats=None if stats is None else stats[qi],
        )

    def search_radius(
        self,
        q_words: np.ndarray,
        r1: int,
        r2: int,
        stats: Optional[AMIHStats] = None,
        enumeration_cap: Optional[int] = None,
    ) -> np.ndarray:
        """The (r1, r2)-near neighbor problem (Def. 4): all codes with
        Hamming tuple <= (r1, r2) componentwise. Returns sorted ids."""
        q_words = np.asarray(q_words, dtype=WORD_DTYPE)
        state = self._make_state(q_words, 0, None)
        state.stats = stats
        fresh = self._probe_tables_for_tuple(state, r1, r2, enumeration_cap)
        if fresh.size:
            if stats is not None:
                stats.verified += fresh.size
            self._verify_and_bucket([state], [fresh])
        matches = [
            np.concatenate(v)
            for (e1, e2), v in state.pending.items()
            if e1 <= r1 and e2 <= r2
        ]
        if not matches:
            return np.empty(0, dtype=np.int64)
        return np.sort(np.concatenate(matches)) + self.id_offset

    # ------------------------------------------------------------ private
    def _probe_tables_for_tuple(
        self,
        state: _QueryState,
        r1: int,
        r2: int,
        enumeration_cap: Optional[int],
    ) -> np.ndarray:
        """Run all not-yet-done probes required by T_{r1,r2,m} (Prop. 4)
        for one query; return its fresh (never-seen) candidate ids.

        Probing only — verification happens once per z-group in
        ``_verify_and_bucket``. The per-table ``cover`` staircase (max b
        probed per a) makes the already-probed check O(tables * rsub)
        instead of re-enumerating and set-filtering every (s, a, b) combo
        per tuple step.

        Cost guard: if a single substring-tuple enumeration would probe
        more buckets than there are stored codes (or than
        ``enumeration_cap``), bucket probing has lost to exhaustive
        verification — every not-yet-seen code becomes a candidate instead
        (exact; the paper's §5 observation that "linear scan is a faster
        alternative" past that point) and ``state.scanned``
        short-circuits later tuples.
        """
        if state.scanned:
            return _EMPTY_IDS
        rsub = (r1 + r2) // self.m
        if enumeration_cap is None:
            # same n-scaled default as the engine layer: max(8n, 16384)
            enumeration_cap = max(8 * self.n, 1 << 14)
        cap = min(enumeration_cap, max(self.n, 1))
        stats = state.stats
        z_subs = state.z_subs
        new_ids: List[np.ndarray] = []
        for s, table in enumerate(self.tables):
            w_s, z_s = table.width, z_subs[s]
            amax = min(r1, z_s, rsub)
            cov = state.cover[s]
            for a in range(amax + 1):
                bmax = min(r2, w_s - z_s, rsub - a)
                b0 = cov.get(a, -1) + 1
                if b0 > bmax:
                    continue
                cov[a] = bmax
                for b in range(b0, bmax + 1):
                    n_buckets = math.comb(z_s, a) * math.comb(w_s - z_s, b)
                    if n_buckets > cap:
                        state.scanned = True
                        fresh = np.flatnonzero(~state.seen)
                        state.seen[:] = True
                        if fresh.size:
                            new_ids.append(fresh)
                        if stats is not None:
                            stats.fell_back_to_scan = True
                            stats.retrieved += fresh.size
                        return (
                            np.concatenate(new_ids) if len(new_ids) > 1
                            else new_ids[0] if new_ids else _EMPTY_IDS
                        )
                    buckets = tuple_bucket_values(
                        state.q_subs[s], w_s, z_s, a, b, cap=None
                    )
                    if stats is not None:
                        stats.substring_tuples_probed += 1
                        stats.probes += len(buckets)
                    ids = table.probe(buckets)
                    if stats is not None:
                        stats.retrieved += len(ids)
                    if ids.size:
                        fresh = ids[~state.seen[ids]]
                        if fresh.size:
                            state.seen[fresh] = True
                            new_ids.append(fresh)
        if not new_ids:
            return _EMPTY_IDS
        return np.concatenate(new_ids) if len(new_ids) > 1 else new_ids[0]

    def _verify_and_bucket(
        self,
        states: List[_QueryState],
        blocks: List[np.ndarray],
    ) -> None:
        """Verify every query's fresh candidate block in ONE backend call
        and bucket the candidates by their exact full-code tuple.

        Tuples are handled as packed keys ``r10 * (p + 1) + r01``
        throughout; bucketing is one stable argsort + boundary scan per
        query (the old np.unique(axis=0) row-sort was the dominant fixed
        cost of small verification batches).
        """
        self._bucket_keys(states, blocks, self._verify_keys(states, blocks))

    def _verify_keys(
        self, states: List[_QueryState], blocks: List[np.ndarray]
    ) -> List[np.ndarray]:
        """Backend half of ``_verify_and_bucket``: the grouped tuple
        verification alone, returning per-query packed-key arrays. Reads
        only the index and the DB — safe to run on a worker thread while
        the main thread probes the next tuple step (pipeline/overlap.py);
        the mutable bucketing stays on the caller's thread."""
        tr = _obs.current()
        if not tr.enabled:
            if self.verify_backend == "cuda":
                return self._verify_group_cuda(states, blocks)
            return self._verify_group_numpy(states, blocks)
        t0 = _obs.now_us()
        if self.verify_backend == "cuda":
            out = self._verify_group_cuda(states, blocks)
        else:
            out = self._verify_group_numpy(states, blocks)
        tr.record("amih.verify", t0, _obs.now_us(), cat="amih",
                  backend=self.verify_backend, queries=len(states),
                  candidates=int(sum(b.size for b in blocks)))
        return out

    def _bucket_keys(
        self,
        states: List[_QueryState],
        blocks: List[np.ndarray],
        keys_list: List[np.ndarray],
    ) -> None:
        """Bucketing half of ``_verify_and_bucket``: group each query's
        candidates by packed key into its pending dict."""
        tr = _obs.current()
        t0 = _obs.now_us() if tr.enabled else 0.0
        pp = self.p + 1
        for state, cand, keys in zip(states, blocks, keys_list):
            order = np.argsort(keys, kind="stable")
            ks = keys[order]
            cuts = np.flatnonzero(ks[1:] != ks[:-1]) + 1
            bounds = np.concatenate(([0], cuts, [ks.size]))
            pending = state.pending
            for i in range(bounds.size - 1):
                lo, hi = bounds[i], bounds[i + 1]
                kk = int(ks[lo])
                pending.setdefault((kk // pp, kk % pp), []).append(
                    cand[order[lo:hi]]
                )
        if tr.enabled:
            tr.record("amih.bucket", t0, _obs.now_us(), cat="amih",
                      queries=len(states))

    def _verify_group_numpy(
        self, states: List[_QueryState], blocks: List[np.ndarray]
    ) -> List[np.ndarray]:
        """One vectorized host popcount over the whole z-group: blocks are
        concatenated (ragged — no padding needed on host) with queries
        repeated per-candidate, then split back per query."""
        self.verify_launches += 1
        if len(blocks) == 1:
            r10, r01 = hamming_tuples(
                states[0].q_words, self.db_words[blocks[0]]
            )
            return [r10 * (self.p + 1) + r01]
        lengths = [b.size for b in blocks]
        cand = np.concatenate(blocks)
        q_rep = np.repeat(
            np.stack([s.q_words for s in states]), lengths, axis=0
        )
        r10, r01 = hamming_tuples(q_rep, self.db_words[cand])
        keys = r10 * (self.p + 1) + r01
        out, off = [], 0
        for length in lengths:
            out.append(keys[off : off + length])
            off += length
        return out

    def _verify_group_cuda(
        self, states: List[_QueryState], blocks: List[np.ndarray],
        deferred: bool = False,
    ):
        """Grouped-verify kernel launches for the z-group: candidate rows
        are gathered inside the kernel from the resident DB through a
        padded (B_g, C_max) index matrix and come back as packed bucket
        keys.

        Steps whose padded gather would exceed ``verify_elem_budget``
        words are split across several launches — greedily over query
        rows, and along the candidate axis when even a single block is
        oversized (a fell-back-to-scan query's block is the whole DB) —
        bounded device memory beats launch economy there. Regular
        sub-batches are double-buffered: the next launch is DISPATCHED
        (``ops.verify_tuples_grouped_launch`` is non-blocking) before
        the previous one is resolved, overlapping device work and
        transfers — but at most two launches are ever in flight, and the
        column chunks of an oversized block resolve eagerly, because
        each in-flight launch holds its padded buffers live and an
        unbounded queue would rebuild exactly the footprint the budget
        exists to prevent. ``deferred=True`` (pipeline/overlap.py) starts
        each launch's copy to pinned host memory at once, behind a CUDA
        event, and returns a callable that waits on those events and
        returns the keys.
        """
        from ..kernels import ops

        W = self.db_words.shape[1]
        budget = max(self.verify_elem_budget, 8 * W)
        # largest power of two <= budget // W: keeps segments aligned with
        # the op's pad_bucket so padding never blows past the budget
        col_step = max(8, 1 << (max(budget // W, 1).bit_length() - 1))
        # deferred materializers, double-buffered: at most 2 in flight
        pending: List[object] = []
        out: List[Optional[np.ndarray]] = [None] * len(blocks)
        i = 0
        while i < len(blocks):
            if ops.pad_bucket(blocks[i].size, minimum=8) * W > budget:
                # oversized single block: chunk along the candidate axis
                # and resolve each segment eagerly (keeping them all in
                # flight would hold ~N/col_step padded buffers live)
                block = blocks[i]
                q_row = states[i].q_words[None, :]
                parts: List[np.ndarray] = []
                for lo in range(0, block.size, col_step):
                    seg = block[lo : lo + col_step]
                    self.verify_launches += 1
                    parts.append(ops.verify_tuples_grouped_launch(
                        q_row,
                        self.db_dev,
                        np.ascontiguousarray(seg[None, :]),
                        np.array([seg.size], dtype=np.int32),
                        p=self.p,
                        device=self.device,
                    ).get()[0].astype(np.int64))
                out[i] = np.concatenate(parts)
                i += 1
                continue
            # greedy row sub-batch whose shared padded width fits budget
            j, c_pad = i, 0
            while j < len(blocks):
                c_j = ops.pad_bucket(blocks[j].size, minimum=8)
                if c_j * W > budget:
                    break  # oversized block: column-chunked next round
                c_new = max(c_pad, c_j)
                rows_pad = ops.pad_bucket(j - i + 1, minimum=1)
                if j > i and rows_pad * c_new * W > budget:
                    break
                c_pad = c_new
                j += 1
            sub_states, sub_blocks = states[i:j], blocks[i:j]
            c_max = max(b.size for b in sub_blocks)
            idx = np.zeros((len(sub_blocks), c_max), dtype=np.int32)
            lengths = np.empty(len(sub_blocks), dtype=np.int32)
            for t, b in enumerate(sub_blocks):
                idx[t, : b.size] = b
                lengths[t] = b.size
            self.verify_launches += 1
            handle = ops.verify_tuples_grouped_launch(
                np.stack([s.q_words for s in sub_states]),
                self.db_dev,
                idx,
                lengths,
                p=self.p,
                device=self.device,
            )
            if deferred:
                handle.copy_async()

            def resolve_grouped(row=i, handle=handle, sizes=[b.size for b in sub_blocks]):
                keys = handle.get()
                for t, size in enumerate(sizes):
                    out[row + t] = keys[t, :size].astype(np.int64)

            pending.append(resolve_grouped)
            if len(pending) >= 2:
                pending.pop(0)()
            i = j

        def finish():
            for resolve in pending:
                resolve()
            return out

        return finish if deferred else finish()
