"""Device-resident AMIH probing (the ``probe_backend="device"`` path).

The host probing loop in ``amih.py`` walks the (p, z) tuple sequence one
step at a time. This module runs the whole walk in ONE kernel launch per
batch (``kernels/device_probe.py``, ``csrc/probe_walk.cu``):

1.  **Schedule** (``DeviceSchedule``): the probing sequence depends only
    on (p, z), so the whole walk is precomputed as flat arrays. Each
    *stream entry* is one bucket probe: a table id, the walk step it
    belongs to, and the index combination that flips ``a`` one-bits and
    ``b`` zero-bits of the query substring (Prop. 4's T_{r1,r2,m} cover,
    deduplicated across steps by the staircase the host path uses). The
    combination names canonical indices into the query's *sorted* bit
    positions, so one schedule serves every query.

2.  **CSR** (``build_device_csr``): each ``_SubTable``'s buckets become a
    dense offsets table plus one shared sorted-ids matrix, placed on the
    index's device next to the zero-padded codes.

3.  **Walk** (kernel K2): consumes the stream in tiles, expands bucket
    ranges into at most ``cap`` candidate slots per query per iteration,
    verifies them and scatter-mins each candidate's exact walk position
    into a per-query position map (a pooled buffer that holds POS_INF
    between batches), listing each id it lowers. A query is done when at
    least k codes have position <= the last *completed* step (Prop. 2 in
    walk-position space) or the walk has passed its ``stop_below``
    position. Queries the walk leaves undone finish through ONE exhaustive
    scan fused with their selection (kernel K3).

4.  **Extraction** (``_resolve_walk``, on the device): the final top-K of
    a query is its k smallest (position, id) pairs, read from the walk's
    touched lists and histograms (``extract_touched``, which also resets
    the map) or from the fused scan; only those pairs cross to the host,
    where sims are read from the float64 ``sims64`` table, so results are
    bit-identical to the host path. No step reads the whole map.

A port of the reference's ``core/probe_device.py``: schedules, stack, CSR
and statistics are the same arrays and the same numbers.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import device_probe as kdp
from ..kernels import ops
from ..obs import trace as _obs
from .enumeration import combination_indices
from .packing import extract_substring, popcount
from .probing import probing_prefix
from .tuples import rhat, sim_value

__all__ = [
    "DEFAULT_PROBE_CAP",
    "DEFAULT_STREAM_CAP",
    "DeviceSchedule",
    "KMAX",
    "MAX_OFFSET_WIDTH",
    "POS_INF",
    "ScheduleStack",
    "build_device_csr",
    "dispatch_groups_device",
    "get_schedule",
    "get_schedule_stack",
    "resolve_groups_device",
    "run_groups_device",
    "schedule_cache_clear",
    "schedule_cache_info",
    "schedule_cache_stats",
]

# Max flips per substring probe the schedule encodes (index columns per
# side). Probes needing more truncate the schedule -> scan fallback.
KMAX = 8

# "Never probed" sentinel in the per-query position map (int32 max).
POS_INF = np.int32(0x7FFFFFFF)

# Dense CSR offsets spend 4 * (2^w + 1) bytes per table; w <= 20 caps
# that at ~4 MiB/table. Wider substrings should raise m instead.
MAX_OFFSET_WIDTH = 20

# Stream entries consumed per walk iteration (also the schedule's pad
# margin, so a tile never reads past its segment).
DEFAULT_TILE = 1024

# Candidate slots expanded per query per iteration.
DEFAULT_PROBE_CAP = 2048

# Default bound on schedule stream entries per (p, z); the `AMIHIndex`
# field ``probe_stream_cap`` overrides it per index.
DEFAULT_STREAM_CAP = 1 << 16

# Done-check cadence of the walk (every iteration: most walks finish
# within their first tiles).
DEFAULT_CHECK_EVERY = 1

_EMPTY_I64 = np.empty(0, dtype=np.int64)


@dataclass
class DeviceSchedule:
    """Precomputed device walk for one (p, m, widths, z, stream_cap).

    Host-side metadata (numpy) plus per-device tensor bundles
    (``device_arrays``). Instances are shared process-wide through
    ``get_schedule`` — treat every array as read-only.
    """

    p: int
    m: int
    widths: Tuple[int, ...]
    z: int
    stream_cap: int
    # ---- full walk metadata (all L valid tuples, in walk order)
    L: int = 0
    r1s: np.ndarray = field(default=None, repr=False)      # (L,) int32
    r2s: np.ndarray = field(default=None, repr=False)      # (L,) int32
    sims64: np.ndarray = field(default=None, repr=False)   # (L,) float64
    cum_maxrad: np.ndarray = field(default=None, repr=False)  # (L,) int32
    inv_pos: np.ndarray = field(default=None, repr=False)  # ((p+1)^2,) int32
    # ---- probe stream (built_steps walk steps flattened; padded to P)
    s_len: int = 0          # real stream entries
    built_steps: int = 0    # walk steps fully encoded in the stream
    complete: bool = False  # built_steps == L
    tbl: np.ndarray = field(default=None, repr=False)      # (P,) int32
    step_ext: np.ndarray = field(default=None, repr=False)  # (P+1,) int32
    idx1: np.ndarray = field(default=None, repr=False)     # (P, KMAX) int32
    idx0: np.ndarray = field(default=None, repr=False)     # (P, KMAX) int32
    maxi1: np.ndarray = field(default=None, repr=False)    # (P,) int32
    maxi0: np.ndarray = field(default=None, repr=False)    # (P,) int32
    cum_subtuples: np.ndarray = field(default=None, repr=False)
    _dev: Dict[str, dict] = field(default_factory=dict, repr=False)

    def device_arrays(self, device) -> dict:
        """The walk arrays as int32 tensors on ``device`` (placed on first
        use per device, cached on the schedule)."""
        key = ops.device_key(device)
        bundle = self._dev.get(key)
        if bundle is None:
            bundle = {
                name: ops.to_device(getattr(self, name), device)
                for name in ("tbl", "step_ext", "idx1", "idx0", "maxi1",
                             "maxi0", "inv_pos")
            }
            bundle["widths"] = ops.to_device(
                np.asarray(self.widths, dtype=np.int32), device
            )
            self._dev[key] = bundle
        return bundle


def _build_schedule(
    p: int, m: int, widths: Tuple[int, ...], z: int, stream_cap: int
) -> DeviceSchedule:
    sched = DeviceSchedule(p=p, m=m, widths=widths, z=z,
                           stream_cap=stream_cap)
    L = (z + 1) * (p - z + 1)
    walk = probing_prefix(p, z, L)
    assert len(walk) == L, "probing sequence shorter than tuple count"
    r1s = np.fromiter((t[0] for t in walk), dtype=np.int32, count=L)
    r2s = np.fromiter((t[1] for t in walk), dtype=np.int32, count=L)
    sched.L = L
    sched.r1s, sched.r2s = r1s, r2s
    sched.sims64 = np.fromiter(
        (sim_value(p, z, r1, r2) for (r1, r2) in walk),
        dtype=np.float64, count=L,
    )
    sched.cum_maxrad = np.maximum.accumulate(r1s + r2s).astype(np.int32)
    inv_pos = np.full((p + 1) * (p + 1), POS_INF, dtype=np.int32)
    inv_pos[r1s.astype(np.int64) * (p + 1) + r2s] = np.arange(
        L, dtype=np.int32
    )
    sched.inv_pos = inv_pos

    wmax = max(widths)
    cover: List[Dict[int, int]] = [{} for _ in range(m)]
    tbl_l: List[np.ndarray] = []
    step_l: List[np.ndarray] = []
    idx1_l: List[np.ndarray] = []
    idx0_l: List[np.ndarray] = []
    maxi1_l: List[np.ndarray] = []
    maxi0_l: List[np.ndarray] = []
    probe_counts: List[int] = []
    total = 0
    built = 0
    complete = False
    for t, (r1, r2) in enumerate(walk):
        rsub = (r1 + r2) // m
        # collect this step's new probes WITHOUT committing the cover:
        # a step is all-or-nothing, so an abort leaves the stream ending
        # exactly at a completed step boundary
        new_probes: List[Tuple[int, int, int]] = []
        cnt = 0
        abort = False
        for s in range(m):
            w = widths[s]
            cov = cover[s]
            for a in range(min(r1, w, rsub) + 1):
                bmax = min(r2, w, rsub - a)
                for b in range(cov.get(a, -1) + 1, bmax + 1):
                    if a > KMAX or b > KMAX:
                        abort = True
                        break
                    cnt += math.comb(w, a) * math.comb(w, b)
                    new_probes.append((s, a, b))
                if abort:
                    break
            if abort:
                break
        if abort or total + cnt > stream_cap:
            break
        for (s, a, b) in new_probes:
            cov = cover[s]
            cov[a] = max(cov.get(a, -1), b)
            w = widths[s]
            c1 = combination_indices(w, a)
            c0 = combination_indices(w, b)
            C1, C0 = len(c1), len(c0)
            i1 = np.full((C1, KMAX), wmax, dtype=np.int32)
            if a:
                i1[:, :a] = c1
            i0 = np.full((C0, KMAX), wmax, dtype=np.int32)
            if b:
                i0[:, :b] = c0
            m1 = (
                c1[:, -1].astype(np.int32)
                if a else np.full(C1, -1, dtype=np.int32)
            )
            m0 = (
                c0[:, -1].astype(np.int32)
                if b else np.full(C0, -1, dtype=np.int32)
            )
            e = C1 * C0
            tbl_l.append(np.full(e, s, dtype=np.int32))
            step_l.append(np.full(e, t, dtype=np.int32))
            idx1_l.append(np.repeat(i1, C0, axis=0))
            idx0_l.append(np.tile(i0, (C1, 1)))
            maxi1_l.append(np.repeat(m1, C0))
            maxi0_l.append(np.tile(m0, C1))
        total += cnt
        probe_counts.append(len(new_probes))
        built = t + 1
    else:
        complete = True

    s_len = total
    P = ops.pad_bucket(s_len + DEFAULT_TILE, minimum=DEFAULT_TILE)

    def cat(parts, pad_shape, pad_val):
        out = np.full(pad_shape, pad_val, dtype=np.int32)
        if parts:
            body = np.concatenate(parts, axis=0)
            out[: len(body)] = body
        return out

    sched.s_len = s_len
    sched.built_steps = built
    sched.complete = complete
    sched.tbl = cat(tbl_l, (P,), 0)
    steps = cat(step_l, (P + 1,), built)
    sched.step_ext = steps
    sched.idx1 = cat(idx1_l, (P, KMAX), wmax)
    sched.idx0 = cat(idx0_l, (P, KMAX), wmax)
    # padded entries carry an impossible max index so they can never be
    # valid for any query (belt and braces next to the in-stream mask)
    sched.maxi1 = cat(maxi1_l, (P,), 1 << 30)
    sched.maxi0 = cat(maxi0_l, (P,), 1 << 30)
    sched.cum_subtuples = np.concatenate(
        ([0], np.cumsum(probe_counts, dtype=np.int64))
    )
    return sched


_SCHED_CACHE: "OrderedDict[tuple, DeviceSchedule]" = OrderedDict()
_SCHED_CACHE_MAX = 32
_SCHED_LOCK = threading.RLock()
_SCHED_HITS = 0
_SCHED_MISSES = 0


def get_schedule(
    p: int, m: int, widths: Tuple[int, ...], z: int, stream_cap: int
) -> DeviceSchedule:
    """Process-wide LRU of device walk schedules — like the probing-prefix
    cache, one (p, m, widths, z) schedule serves every index and shard."""
    global _SCHED_HITS, _SCHED_MISSES
    key = (p, m, tuple(widths), z, stream_cap)
    with _SCHED_LOCK:
        sched = _SCHED_CACHE.get(key)
        if sched is not None:
            _SCHED_CACHE.move_to_end(key)
            _SCHED_HITS += 1
            return sched
        _SCHED_MISSES += 1
    built = _build_schedule(p, m, tuple(widths), z, stream_cap)
    with _SCHED_LOCK:
        sched = _SCHED_CACHE.setdefault(key, built)
        _SCHED_CACHE.move_to_end(key)
        while len(_SCHED_CACHE) > _SCHED_CACHE_MAX:
            _SCHED_CACHE.popitem(last=False)
        return sched


def schedule_cache_clear() -> None:
    """Empty the process-wide schedule cache and schedule-stack cache."""
    with _SCHED_LOCK:
        _SCHED_CACHE.clear()
    with _STACK_LOCK:
        _STACK_CACHE.clear()


def schedule_cache_info() -> Tuple[int, int]:
    """(entries, total stream entries) of the schedule cache."""
    with _SCHED_LOCK:
        return (
            len(_SCHED_CACHE),
            sum(s.s_len for s in _SCHED_CACHE.values()),
        )


def schedule_cache_stats() -> Dict[str, int]:
    """Process-wide schedule-cache health: entries/stream size plus the
    cumulative ``get_schedule`` hit/miss counts (threaded into
    ``EngineStats.cache_info`` and recorded in bench rows, so a cache
    regression shows up as a miss-rate jump instead of a latency mystery)."""
    with _SCHED_LOCK:
        entries, stream = (
            len(_SCHED_CACHE),
            sum(s.s_len for s in _SCHED_CACHE.values()),
        )
        hits, misses = _SCHED_HITS, _SCHED_MISSES
    return {
        "schedule_entries": entries,
        "schedule_stream": stream,
        "schedule_hits": hits,
        "schedule_misses": misses,
    }
# ----------------------------------------------------------------- stack
class ScheduleStack:
    """Grow-only concatenation of every z-schedule of one
    (p, m, widths, stream_cap) config — the batched form of
    ``DeviceSchedule`` the fused cross-z-group walk indexes by row.

    Each new z appends one *segment* of ``s_len + DEFAULT_TILE`` entries
    to the flat stream arrays (the stream itself plus a tile of inert
    pad entries, so a frozen group's cursor can over-advance by one tile
    without reading a neighbor's stream); per-row ``g_start``/``g_end``
    bound the real entries and the inverse-position tables stack one row
    per z. Host capacity grows by power-of-two buckets and the per-device
    bundle is placed again only when the version changes, so steady-state
    serving copies nothing to the card.
    """

    def __init__(self, p: int, m: int, widths: Tuple[int, ...],
                 stream_cap: int):
        self.p = p
        self.m = m
        self.widths = tuple(widths)
        self.stream_cap = stream_cap
        self.wmax = max(widths)
        self.rows: Dict[int, int] = {}          # z -> row index
        self.scheds: List[DeviceSchedule] = []  # one per row
        self.g_start: List[int] = []
        self.g_end: List[int] = []
        self.version = 0
        self._used = 0
        self._cap = 0
        self.tbl = np.zeros(0, dtype=np.int32)
        self.step = np.zeros(0, dtype=np.int32)
        self.idx1 = np.zeros((0, KMAX), dtype=np.int32)
        self.idx0 = np.zeros((0, KMAX), dtype=np.int32)
        self.maxi1 = np.zeros(0, dtype=np.int32)
        self.maxi0 = np.zeros(0, dtype=np.int32)
        self._dev: Dict[str, tuple] = {}        # dkey -> (version, bundle)
        self._lock = threading.RLock()

    def _grow(self, need: int) -> None:
        cap = ops.pad_bucket(need, minimum=4 * DEFAULT_TILE)
        for name in ("tbl", "step", "idx1", "idx0", "maxi1", "maxi0"):
            old = getattr(self, name)
            shape = (cap,) + old.shape[1:]
            new = np.zeros(shape, dtype=np.int32)
            new[: len(old)] = old
            setattr(self, name, new)
        self._cap = cap

    def row(self, z: int) -> int:
        """The stack row for popcount ``z``, appending (and versioning)
        on first sight. Thread-safe; rows never move once assigned."""
        with self._lock:
            r = self.rows.get(z)
            if r is not None:
                return r
        sched = get_schedule(self.p, self.m, self.widths, z,
                             self.stream_cap)
        with self._lock:
            r = self.rows.get(z)
            if r is not None:
                return r
            seg = sched.s_len + DEFAULT_TILE
            start = self._used
            if start + seg > self._cap:
                self._grow(start + seg)
            # the schedule's own pad entries (step=built, maxi=1<<30)
            # fill the segment margin, so a cursor parked past g_end
            # still reads its group's completed-step count
            self.tbl[start : start + seg] = sched.tbl[:seg]
            self.step[start : start + seg] = sched.step_ext[:seg]
            self.idx1[start : start + seg] = sched.idx1[:seg]
            self.idx0[start : start + seg] = sched.idx0[:seg]
            self.maxi1[start : start + seg] = sched.maxi1[:seg]
            self.maxi0[start : start + seg] = sched.maxi0[:seg]
            self._used = start + seg
            self.scheds.append(sched)
            self.g_start.append(start)
            self.g_end.append(start + sched.s_len)
            r = len(self.scheds) - 1
            self.rows[z] = r
            self.version += 1
            return r

    def device_arrays(self, device) -> dict:
        """The stack as int32 tensors on ``device`` at the current version
        (row count and capacity padded to power-of-two buckets; placed
        again only after a new z grew the stack)."""
        key = ops.device_key(device)
        with self._lock:
            cur = self._dev.get(key)
            if cur is not None and cur[0] == self.version:
                return cur[1]
            G = len(self.scheds)
            G_pad = ops.pad_bucket(G, minimum=1)
            g_start = np.zeros(G_pad, dtype=np.int32)
            g_start[:G] = self.g_start
            g_end = np.zeros(G_pad, dtype=np.int32)
            g_end[:G] = self.g_end
            pp2 = (self.p + 1) * (self.p + 1)
            inv = np.full((G_pad, pp2), POS_INF, dtype=np.int32)
            for i, s in enumerate(self.scheds):
                inv[i] = s.inv_pos

            bundle = {
                name: ops.to_device(a, device)
                for name, a in (
                    ("g_start", g_start), ("g_end", g_end),
                    ("tbl", self.tbl), ("step", self.step),
                    ("idx1", self.idx1), ("idx0", self.idx0),
                    ("maxi1", self.maxi1), ("maxi0", self.maxi0),
                    ("inv_pos", inv),
                    ("widths", np.asarray(self.widths, dtype=np.int32)),
                )
            }
            self._dev[key] = (self.version, bundle)
            return bundle


_STACK_CACHE: "OrderedDict[tuple, ScheduleStack]" = OrderedDict()
_STACK_CACHE_MAX = 8
_STACK_LOCK = threading.RLock()


def get_schedule_stack(
    p: int, m: int, widths: Tuple[int, ...], stream_cap: int
) -> ScheduleStack:
    """Process-wide LRU of schedule stacks: one grow-only stack per
    (p, m, widths, stream_cap) config serves every index and shard,
    exactly like ``get_schedule`` one level down."""
    key = (p, m, tuple(widths), stream_cap)
    with _STACK_LOCK:
        stack = _STACK_CACHE.get(key)
        if stack is None:
            stack = ScheduleStack(p, m, tuple(widths), stream_cap)
            _STACK_CACHE[key] = stack
        _STACK_CACHE.move_to_end(key)
        while len(_STACK_CACHE) > _STACK_CACHE_MAX:
            _STACK_CACHE.popitem(last=False)
        return stack

# ------------------------------------------------------------------- CSR
def build_device_csr(index) -> dict:
    """The CSR of every ``_SubTable`` as int32 tensors on ``index.device``.

    ``offsets`` is dense over bucket values — (m, 2^wmax + 1) — so a
    bucket lookup is two reads; ``ids`` is the per-table sorted id rows
    padded to ``n_pad`` with the out-of-bounds marker ``n_pad`` (dropped by
    the position scatter); ``db_pad`` zero-pads the packed codes to
    ``n_pad`` rows.
    """
    widths = [t.width for t in index.tables]
    wmax = max(widths)
    if wmax > MAX_OFFSET_WIDTH:
        raise ValueError(
            f"probe_backend='device' needs substring width <= "
            f"{MAX_OFFSET_WIDTH} bits for the dense CSR offsets "
            f"(got {wmax}); build with larger m (>= "
            f"{-(-index.p // MAX_OFFSET_WIDTH)} for p={index.p})"
        )
    n = index.n
    n_pad = ops.pad_bucket(n, minimum=8)
    m = index.m
    offsets = np.full((m, (1 << wmax) + 1), n, dtype=np.int32)
    ids = np.full((m, n_pad), n_pad, dtype=np.int32)
    for s, table in enumerate(index.tables):
        w = table.width
        offsets[s, : (1 << w) + 1] = np.searchsorted(
            table.sorted_vals, np.arange((1 << w) + 1), side="left"
        ).astype(np.int32)
        ids[s, :n] = table.sorted_ids
    db_pad = np.zeros((n_pad, index.db_words.shape[1]), dtype=np.uint32)
    db_pad[:n] = index.db_words
    dev = index.device
    return {
        "offsets": ops.to_device(offsets, dev),
        "ids": ops.to_device(ids, dev),
        "db_pad": ops.to_device(db_pad, dev),
        "n": n,
        "n_pad": n_pad,
        "wmax": wmax,
        "widths": tuple(widths),
    }


def _pow_arrays(
    q_sub: np.ndarray, z_sub: np.ndarray, widths: Tuple[int, ...], wmax: int
):
    """Per-query flip values for the canonical index combinations.

    ``pow1[b, s, i]`` is the bit value of the i-th one-position of query
    b's substring s (ascending position; 0 for i >= z_s and for the KMAX
    padding column i == wmax); ``pow0`` likewise over zero-positions. The
    schedule's index combinations OR these into the XOR mask, so each
    valid stream entry reproduces exactly one host bucket value.
    """
    Bg, m = q_sub.shape
    pow1 = np.zeros((Bg, m, wmax + 1), dtype=np.int32)
    pow0 = np.zeros((Bg, m, wmax + 1), dtype=np.int32)
    for s in range(m):
        w = widths[s]
        bits = (q_sub[:, s, None] >> np.arange(w, dtype=np.uint32)) & 1
        order1 = np.argsort(1 - bits, axis=1, kind="stable")
        order0 = np.argsort(bits, axis=1, kind="stable")
        col = np.arange(w)
        z_s = z_sub[:, s : s + 1].astype(np.int64)
        pow1[:, s, :w] = np.where(col < z_s, 1 << order1, 0)
        pow0[:, s, :w] = np.where(col < (w - z_s), 1 << order0, 0)
    return pow1, pow0


# ---------------------------------------------------------------- driver
def _resolve_walk(index, handle, q_words, gid, t_stop, k, inv_pos):
    """Wait for a walk, finish its bailed queries with ONE fused scan
    launch, and extract every query's k smallest (position, id) pairs —
    from the touched lists for the walk's done queries, from the scan for
    the others — resetting the walk's map. Returns (found: per-query (ids
    int64, pos int64), verified (B,) int64, scanned (B,) bool, the walk's
    result dict). ``gid`` picks each query's ``inv_pos`` row."""
    res = handle.get()
    dev = index.device
    B = q_words.shape[0]
    done_rows = np.flatnonzero(res["done"])
    undone = np.flatnonzero(~res["done"])
    with _obs.current().span("probe.extract", cat="probe", B=B):
        ts = ops.to_device(np.asarray(t_stop, dtype=np.int32), dev)
        ids_w, pos_w = kdp.extract_touched(
            res["posmap"], res["touched"], res["hist"], ts, k, done_rows,
            res["width"])
        handle.mark_clean()
        parts = [ids_w, pos_w]
        if undone.size:
            # truncated schedules / budget bails: one exhaustive launch
            # finishes every straggler; positions are exact, so results
            # are unchanged
            ids_s, pos_s, ver_s = ops.device_probe_scan_topk_launch(
                np.ascontiguousarray(q_words[undone]), gid[undone],
                t_stop[undone], k, inv_pos=inv_pos, csr=index.device_csr,
                p=index.p, device=dev)
            index.verify_launches += 1
            parts += [ids_s, pos_s, ver_s[:, None]]
        host = torch.cat([x.reshape(-1) for x in parts]).cpu().numpy()
    nd, nu = done_rows.size * k, undone.size * k
    ids = np.empty((B, k), dtype=np.int64)
    pos = np.empty((B, k), dtype=np.int64)
    ids[done_rows] = host[:nd].reshape(-1, k)
    pos[done_rows] = host[nd:2 * nd].reshape(-1, k)
    verified = res["n_touched"].astype(np.int64)
    if undone.size:
        ids[undone] = host[2 * nd:2 * nd + nu].reshape(-1, k)
        pos[undone] = host[2 * nd + nu:2 * nd + 2 * nu].reshape(-1, k)
        verified[undone] = host[2 * nd + 2 * nu:]
    found = []
    for b in range(B):
        take = int((ids[b] >= 0).sum())
        found.append((ids[b, :take], pos[b, :take]) if take
                     else (_EMPTY_I64, _EMPTY_I64))
    scanned = np.zeros(B, dtype=bool)
    scanned[undone] = True
    return found, verified, scanned, res


def _record_stats(st, sched, verified, out_pos, take, probes, retrieved,
                  scanned, r_hat):
    st.probes += int(probes)
    st.retrieved += int(retrieved)
    st.verified += int(verified)
    t_last = int(out_pos[-1]) if take else -1
    st.tuples_processed += t_last + 1
    if t_last >= 0:
        st.max_radius = max(st.max_radius, int(sched.cum_maxrad[t_last]))
        if st.max_radius > r_hat:
            st.exceeded_rhat = True
        st.substring_tuples_probed += int(
            sched.cum_subtuples[min(t_last + 1, sched.built_steps)]
        )
    if scanned:
        st.fell_back_to_scan = True


def _query_substrings(index, q_words):
    """(q_sub uint32, z_sub int32) substring values/popcounts for a
    whole (possibly mixed-z) query batch."""
    q_sub = np.stack(
        [
            np.asarray(extract_substring(q_words, t.lo, t.hi))
            for t in index.tables
        ],
        axis=1,
    ).astype(np.uint32)
    z_sub = np.bitwise_count(q_sub).astype(np.int32)
    return q_sub, z_sub


def _t_stop(sched, stop_below, sel, count):
    """Last walk position each query considers: the whole walk, or the
    last position whose sim is >= the query's live bound (a snapshot:
    bounds only ever rise, so a stale one is still a valid lower bound)."""
    if stop_below is None:
        return np.full(count, sched.L - 1, dtype=np.int32)
    return (
        np.searchsorted(-sched.sims64, -stop_below[sel], side="right") - 1
    ).astype(np.int32)


def _finish(index, q_words, k, qis, scheds, zs, found, verified, probes,
            retrieved, scanned, stats, on_done, states):
    """Record each query's results (``found``: its (ids, positions)) and
    statistics: the host loop's result contract (LOCAL ids, float64
    sims)."""
    from .amih import _QueryState

    for j, qi in enumerate(qis):
        sched = scheds[j]
        out_ids, out_pos = found[j]
        out_sims = sched.sims64[out_pos]
        take = out_ids.size
        st = None if stats is None else stats[qi]
        if st is not None:
            _record_stats(
                st, sched, verified[j], out_pos, take, probes[j],
                retrieved[j], bool(scanned[j]), rhat(int(zs[j])),
            )
        state = _QueryState(
            qi=qi,
            q_words=q_words[qi],
            q_subs=[],
            z_subs=[],
            seen=np.empty(0, dtype=bool),
            cover=[],
            pending={},
            out_ids=out_ids,
            out_sims=out_sims,
            stats=st,
            scanned=bool(scanned[j]),
            done=take >= k,
        )
        states.append(state)
        if on_done is not None and state.done:
            on_done(qi, out_ids + index.id_offset,
                    np.asarray(out_sims, dtype=np.float64))


class _PendingGroups:
    """In-flight fused batch probe: the non-blocking half of
    ``run_groups_device``. Holds the launch handle plus the host-side
    context ``resolve_groups_device`` needs for extraction."""

    __slots__ = ("q_words", "k", "zs", "gid", "t_stop", "stack", "handle")

    def __init__(self, q_words, k, zs, gid, t_stop, stack, handle):
        self.q_words = q_words
        self.k = k
        self.zs = zs
        self.gid = gid
        self.t_stop = t_stop
        self.stack = stack
        self.handle = handle


def dispatch_groups_device(
    index,
    q_words: np.ndarray,
    k: int,
    stop_below: Optional[np.ndarray] = None,
) -> _PendingGroups:
    """Dispatch ONE fused walk launch for the whole batch — every z-group
    rides the same launch via its schedule-stack row — and return without
    waiting for it."""
    B = q_words.shape[0]
    csr = index.device_csr
    widths = csr["widths"]
    with _obs.current().span("probe.prep", cat="probe", B=B):
        stack = get_schedule_stack(
            index.p, index.m, widths, index.probe_stream_cap
        )
        zs = popcount(q_words)
        gid = np.empty(B, dtype=np.int32)
        t_stop = np.empty(B, dtype=np.int32)
        for z in np.unique(zs):
            r = stack.row(int(z))
            sel = zs == z
            gid[sel] = r
            t_stop[sel] = _t_stop(stack.scheds[r], stop_below, sel,
                                  int(sel.sum()))
        q_sub, z_sub = _query_substrings(index, q_words)
        pow1, pow0 = _pow_arrays(q_sub, z_sub, widths, csr["wmax"])
    handle = ops.device_probe_walk_batched_launch(
        q_words, q_sub.astype(np.int32), z_sub, pow1, pow0, gid, t_stop, k,
        stack=stack, csr=csr, p=index.p, device=index.device,
    )
    index.verify_launches += 1
    return _PendingGroups(q_words, k, zs, gid, t_stop, stack, handle)


def resolve_groups_device(index, pending: _PendingGroups, stats,
                          on_done=None):
    """Wait for a dispatched fused walk, finish any bailed queries with
    ONE cross-group scan launch, and extract results — two launches at
    most for the whole batch. Returns finished ``_QueryState``s (LOCAL
    ids; float64 sims)."""
    q_words = pending.q_words
    B = q_words.shape[0]
    try:
        found, verified, scanned, res = _resolve_walk(
            index, pending.handle, q_words, pending.gid, pending.t_stop,
            pending.k, pending.stack.device_arrays(index.device)["inv_pos"])
        states: List = []
        _finish(
            index, q_words, pending.k, list(range(B)),
            [pending.stack.scheds[g] for g in pending.gid], pending.zs,
            found, verified, res["probes"], res["retrieved"], scanned, stats,
            on_done, states,
        )
        return states
    finally:
        pending.handle.release()


def run_groups_device(
    index,
    q_words: np.ndarray,
    k: int,
    stats,
    stop_below: Optional[np.ndarray] = None,
    on_done=None,
):
    """Device-path replacement for ``AMIHIndex._run_groups``: ONE fused
    walk launch (plus at most one scan launch) for the whole batch, then
    extraction. ``index.probe_fused=False`` runs one walk launch per
    z-group instead, the fused path's parity oracle; results are
    bit-identical."""
    if not getattr(index, "probe_fused", True):
        return _run_groups_device_grouped(
            index, q_words, k, stats, stop_below, on_done
        )
    if q_words.shape[0] == 0:
        return []
    if np.unique(popcount(q_words)).size == 1:
        # single z-group (every B=1 call lands here): the per-group launch
        # is the same ONE walk launch with smaller operands, and its
        # per-group budget is the reference's — results identical
        return _run_groups_device_grouped(
            index, q_words, k, stats, stop_below, on_done
        )
    pending = dispatch_groups_device(index, q_words, k, stop_below)
    return resolve_groups_device(index, pending, stats, on_done=on_done)


def _run_groups_device_grouped(
    index,
    q_words: np.ndarray,
    k: int,
    stats,
    stop_below: Optional[np.ndarray] = None,
    on_done=None,
):
    """One walk launch per z-group (plus one scan launch per group with
    stragglers): the fused path's parity oracle and the single-z path."""
    B = q_words.shape[0]
    zs = popcount(q_words)
    groups: Dict[int, List[int]] = {}
    for qi in range(B):
        groups.setdefault(int(zs[qi]), []).append(qi)

    csr = index.device_csr
    widths = csr["widths"]
    states: List = []
    for z, qis in groups.items():
        Bg = len(qis)
        with _obs.current().span("probe.prep", cat="probe", B=Bg):
            sched = get_schedule(
                index.p, index.m, widths, z, index.probe_stream_cap
            )
            q_grp = np.ascontiguousarray(q_words[qis])
            q_sub, z_sub = _query_substrings(index, q_grp)
            pow1, pow0 = _pow_arrays(q_sub, z_sub, widths, csr["wmax"])
            t_stop = _t_stop(sched, stop_below, qis, Bg)
        handle = ops.device_probe_walk_launch(
            q_grp, q_sub.astype(np.int32), z_sub, pow1, pow0, t_stop, k,
            sched=sched, csr=csr, p=index.p, device=index.device,
        )
        index.verify_launches += 1
        try:
            # truncated schedule or budget bail: one exhaustive launch
            # finishes the group's stragglers
            found, verified, scanned, res = _resolve_walk(
                index, handle, q_grp, np.zeros(Bg, dtype=np.int32), t_stop,
                k, sched.device_arrays(index.device)["inv_pos"][None, :])
        finally:
            handle.release()
        _finish(
            index, q_words, k, qis, [sched] * Bg, zs[qis], found, verified,
            res["probes"], res["retrieved"], scanned, stats, on_done, states,
        )
    return states
