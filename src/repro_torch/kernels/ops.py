"""The launch layer: padding, placement and launch accounting around the
port's kernels (the counterpart of the reference's ``kernels/ops.py``).

Every launch bumps ``launches.<op>`` in the port's metrics registry at the
same site as the reference: ``verify_grouped`` (the host walk's grouped
verify), ``device_probe`` (one probing walk), ``device_probe_scan`` (one
exhaustive fallback scan) and ``verify`` (``verify_tuples_op``), plus
``launches.device.<device>``; the linear scan's kernels, which the
reference does not count, bump ``scan_topk`` (one fused K4 top-k call),
``scan_scores`` (one K4 score launch: ``scan_scores``, or one chunk of a
top-k above the fused kernel's k) and ``blockmax`` (one K5 launch).
Launch sites record ``launch.*`` spans when tracing is on.
``LAUNCH_COUNTS`` is the reference's deprecated read-only view of the
first four counters, ``LAUNCH_COUNTS_BY_DEVICE`` its per-device dict (every
counted launch, keyed by ``device_key``).

The linear scan (``scan_scores``, ``scan_topk``, ``merge_topk``,
``scan_topk_pruned``) takes int32 code tensors and runs where they lie:
the kernels on a CUDA tensor, their plain versions on a CPU tensor. Its
top-K is ordered as ``jax.lax.top_k`` orders the reference's chunk loop:
score descending, ties to the lowest id.

Shapes keep the reference's power-of-two padding (``pad_bucket``) even
though eager PyTorch has no trace cache to bound: the walk's iteration
budget depends on the padded batch, the budget decides which queries bail
to the scan, and that decides ``probes``, ``retrieved`` and
``fell_back_to_scan``. Padded query rows start with ``t_stop = -1`` and
gid 0 (born done), exactly as in the reference.
"""

from __future__ import annotations

import threading
import warnings
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from ..obs import trace as _obs
from ..obs.metrics import REGISTRY as _REG
from . import device_probe
from .blockmax_scan import DEFAULT_BLK_N as BLOCKMAX_BLK_N
from .blockmax_scan import blockmax_scores
from .hamming_scan import (
    KCAP_MAX,
    chunked_topk,
    hamming_scan_scores,
    hamming_scan_topk,
    topk_first,
)
from .ref import popcount32
from .verify_tuples import gather_verify_grouped, verify_tuples

__all__ = [
    "LAUNCH_COUNTS",
    "LAUNCH_COUNTS_BY_DEVICE",
    "PendingKeys",
    "PendingWalk",
    "device_key",
    "device_probe_scan_launch",
    "device_probe_scan_multi_launch",
    "device_probe_scan_topk_launch",
    "device_probe_walk_batched_launch",
    "device_probe_walk_launch",
    "merge_topk",
    "pad_bucket",
    "resolve_device",
    "scan_scores",
    "scan_topk",
    "scan_topk_pruned",
    "to_device",
    "verify_tuples_grouped_launch",
    "verify_tuples_grouped_op",
    "verify_tuples_op",
]

_LOCK = threading.Lock()

_LAUNCH_KEYS = ("verify_grouped", "verify", "device_probe",
                "device_probe_scan")


class _DeprecatedLaunchCounts(Mapping):
    """The reference's ``ops.LAUNCH_COUNTS``: a read-only view of the
    ``launches.*`` registry counters of the reference's four ops. Direct
    reads warn; new code reads ``REGISTRY.value("launches.<op>")``."""

    def __getitem__(self, key: str) -> int:
        warnings.warn(
            "ops.LAUNCH_COUNTS is deprecated; read "
            "repro_torch.obs.metrics.REGISTRY.value('launches.<op>') "
            "instead", DeprecationWarning, stacklevel=2,
        )
        if key not in _LAUNCH_KEYS:
            raise KeyError(key)
        return _REG.value("launches." + key)

    def __iter__(self):
        return iter(_LAUNCH_KEYS)

    def __len__(self) -> int:
        return len(_LAUNCH_KEYS)


LAUNCH_COUNTS = _DeprecatedLaunchCounts()

# device key -> launches counted there (mirrors launches.device.<dkey>)
LAUNCH_COUNTS_BY_DEVICE: dict = {}


def _bump_launch(op: str, dkey: str) -> None:
    """One device dispatch of ``op``: bump ``launches.<op>`` and the
    per-device split ``launches.device.<dkey>``."""
    _REG.counter("launches." + op).add(1)
    _REG.counter("launches.device." + dkey).add(1)
    with _LOCK:
        LAUNCH_COUNTS_BY_DEVICE[dkey] = LAUNCH_COUNTS_BY_DEVICE.get(dkey, 0) + 1


def device_key(device) -> str:
    """Stable string key of a placement device."""
    return str(torch.device(device))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. ``None`` means ``cuda``, and raises ``RuntimeError``
    where no CUDA device is available (it never falls back to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array as an int32 tensor on ``device`` (uint32 words are
    viewed as int32 over the same bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int32:
        a = a.astype(np.int32)
    return torch.from_numpy(a).to(device)


def pad_bucket(size: int, minimum: int = 8) -> int:
    """Next power of two >= max(size, minimum)."""
    target = max(int(size), minimum, 1)
    return 1 << (target - 1).bit_length()


def _pad_rows(a, Bp: int, fill=0) -> np.ndarray:
    a = np.asarray(a)
    out = np.full((Bp,) + a.shape[1:], fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


# ------------------------------------------------------------ grouped verify
class PendingKeys:
    """Handle for an in-flight grouped-verify launch: ``get()`` copies the
    unpadded (B, C) keys to the host (waiting for the kernel).
    ``copy_async()`` starts that copy on the current stream instead, into
    pinned memory, and records a CUDA event after it; ``get()`` then waits
    on that event alone, never on the whole device."""

    __slots__ = ("_keys", "_B", "_C", "_dkey", "_host", "_event")

    def __init__(self, keys, B: int, C: int, dkey: str = "cpu"):
        self._keys = keys
        self._B = B
        self._C = C
        self._dkey = dkey
        self._host = None
        self._event = None

    def copy_async(self) -> "PendingKeys":
        keys = self._keys
        if isinstance(keys, np.ndarray) or keys.device.type != "cuda":
            return self
        self._host = keys[: self._B, : self._C].to("cpu", non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()
        return self

    def get(self) -> np.ndarray:
        keys = self._keys
        if isinstance(keys, np.ndarray):
            return keys
        tr = _obs.current()
        t0 = _obs.now_us() if tr.enabled else 0.0
        if self._event is not None:
            self._event.synchronize()
            out = self._host.numpy()
        else:
            out = keys[: self._B, : self._C].cpu().numpy()
        if tr.enabled:
            tr.record("launch.verify_grouped.resolve", t0, _obs.now_us(),
                      cat="kernel", device=self._dkey)
        return out


def verify_tuples_grouped_launch(
    q_words, db_dev, cand_idx, lengths, *, p: int, device,
) -> PendingKeys:
    """Pad to power-of-two (B, C) buckets, place on ``device`` and launch
    the grouped verify against the resident codes ``db_dev``, without
    waiting for it. Returns a ``PendingKeys`` handle."""
    idx = np.ascontiguousarray(np.asarray(cand_idx, dtype=np.int32))
    lens = np.asarray(lengths, dtype=np.int32)
    B, C = idx.shape
    if C == 0 or B == 0:
        return PendingKeys(np.full((B, C), -1, dtype=np.int32), B, C)
    Bp = pad_bucket(B, minimum=1)
    Cp = pad_bucket(C, minimum=8)
    idxp = np.zeros((Bp, Cp), dtype=np.int32)
    idxp[:B, :C] = idx
    lensp = np.zeros(Bp, dtype=np.int32)
    lensp[:B] = lens
    qp = _pad_rows(np.asarray(q_words, dtype=np.uint32), Bp)
    dkey = device_key(device)
    _bump_launch("verify_grouped", dkey)
    with _obs.current().span("launch.verify_grouped.dispatch",
                             cat="kernel", device=dkey, B=B, C=C):
        keys = gather_verify_grouped(
            to_device(qp, device), db_dev, to_device(idxp, device),
            to_device(lensp, device), p=p,
        )
    return PendingKeys(keys, B, C, dkey)


def verify_tuples_grouped_op(q_words, db_words, cand_idx, lengths, *, p: int,
                             device=None) -> np.ndarray:
    """The blocking grouped verify: a host (B, C) int32 array of packed
    bucket keys ``r10 * (p + 1) + r01``, -1 in every padded slot
    (``verify_tuples_grouped_launch(...).get()``). ``device`` defaults to
    where the resident codes ``db_words`` lie."""
    device = db_words.device if device is None else device
    return verify_tuples_grouped_launch(
        q_words, db_words, cand_idx, lengths, p=p, device=device,
    ).get()


# ----------------------------------------------------------- probing walks
def _walk_shape(tile, cap, check_every):
    from ..core.probe_device import (
        DEFAULT_CHECK_EVERY,
        DEFAULT_PROBE_CAP,
        DEFAULT_TILE,
    )

    tile = DEFAULT_TILE if tile is None else tile
    if tile > DEFAULT_TILE:
        raise ValueError(
            f"tile={tile} exceeds the schedule pad margin {DEFAULT_TILE}"
        )
    cap = pad_bucket(DEFAULT_PROBE_CAP if cap is None else cap, minimum=8)
    check_every = (
        DEFAULT_CHECK_EVERY if check_every is None else max(1, check_every)
    )
    return tile, cap, check_every


# Recycled (B_pad, n_pad) position-map buffers per (device, batch bucket,
# index size): sustained serving reuses one buffer instead of allocating
# 4 * B_pad * n_pad bytes per batch. A buffer holds POS_INF everywhere
# between batches: it is filled once, when allocated, and each batch's
# extraction resets the entries its walk lowered (``PendingWalk.mark_clean``).
# A buffer whose batch failed before that is dropped, never recycled. Small
# cap so odd one-off batch shapes don't pin device memory.
_POSMAP_POOL: dict = {}
_POSMAP_POOL_MAX = 2


def _take_posmap(device, Bp: int, n_pad: int):
    key = (device_key(device), Bp, n_pad)
    with _LOCK:
        pool = _POSMAP_POOL.get(key)
        if pool:
            return key, pool.pop()
    return key, torch.full((Bp, n_pad), device_probe.POS_INF,
                           dtype=torch.int32, device=device)


def _recycle_posmap(key, buf) -> None:
    with _LOCK:
        pool = _POSMAP_POOL.setdefault(key, [])
        if len(pool) < _POSMAP_POOL_MAX:
            pool.append(buf)


class PendingWalk:
    """Handle for an in-flight walk launch on a pooled position map.
    ``get()`` waits for the kernel and returns the result dict: device
    tensors ``posmap`` (B, n_pad), ``touched`` (B, lt) and ``hist``
    (B, H), host arrays ``probes``, ``retrieved``, ``done``, ``n_touched``
    (the verified codes) and ``cursor``, ``iters``, and ``width`` (the
    entries of the lists the walk wrote: iters x cap). ``release()`` hands the
    buffer back to the pool if ``mark_clean()`` said the batch reset every
    entry it lowered, and drops it otherwise."""

    __slots__ = ("_out", "_B", "_cap", "_pool_key", "_buf", "_res", "_clean")

    def __init__(self, out, B: int, cap: int, pool_key, buf):
        self._out = out
        self._B = B
        self._cap = cap
        self._pool_key = pool_key
        self._buf = buf
        self._res = None
        self._clean = False

    def get(self) -> dict:
        if self._res is None:
            tr = _obs.current()
            t0 = _obs.now_us() if tr.enabled else 0.0
            (posmap, probes, retrieved, done, cursor, iters, touched,
             n_touched, hist) = self._out
            B = self._B
            small = [probes[:B], retrieved[:B], done[:B].to(torch.int32),
                     n_touched[:B], torch.as_tensor(cursor).reshape(-1)
                     .to(probes.device, torch.int32),
                     torch.as_tensor(iters).reshape(-1)
                     .to(probes.device, torch.int32)]
            host = torch.cat(small).cpu().numpy()    # one copy, one wait
            pr, rt, dn, nt, rest = np.split(host, [B, 2 * B, 3 * B, 4 * B])
            self._res = {
                "posmap": posmap[:B],
                "touched": touched[:B],
                "hist": hist[:B],
                "probes": pr,
                "retrieved": rt,
                "done": dn.astype(bool),
                "n_touched": nt,
                "cursor": rest[:-1],
                "iters": int(rest[-1]),
                "width": int(rest[-1]) * self._cap,
            }
            self._out = None
            if tr.enabled:
                tr.record("launch.device_probe.resolve", t0, _obs.now_us(),
                          cat="kernel", device=self._pool_key[0])
        return self._res

    def mark_clean(self) -> None:
        """The batch's extraction reset every entry the walk lowered."""
        self._clean = True

    def release(self) -> None:
        """Return the position-map buffer to the pool if it is clean, else
        drop it (idempotent)."""
        buf, self._buf = self._buf, None
        self._res = None
        if buf is not None and self._clean:
            _recycle_posmap(self._pool_key, buf)


def device_probe_walk_launch(
    q_words, q_sub, z_sub, pow1, pow0, t_stop, k: int, *, sched, csr, p: int,
    device, tile: Optional[int] = None, cap: Optional[int] = None,
    check_every: Optional[int] = None, walk_budget: Optional[int] = None,
) -> PendingWalk:
    """One z-group's fused walk launch on a pooled position map. Per-call
    arrays are padded to a power-of-two batch and placed on ``device``.
    ``walk_budget`` defaults to ``max(4, n_pad // (4 * cap))``: past that
    many iterations the walk has spent a quarter of an exhaustive scan.
    Returns a ``PendingWalk``."""
    from ..core.probe_device import KMAX

    tile, cap, check_every = _walk_shape(tile, cap, check_every)
    if walk_budget is None:
        walk_budget = max(4, int(csr["n_pad"]) // (4 * cap))
    qh = np.ascontiguousarray(np.asarray(q_words))
    B = qh.shape[0]
    Bp = pad_bucket(B, minimum=1)
    per_call = [
        to_device(_pad_rows(a, Bp, fill), device)
        for a, fill in (
            (qh, 0), (q_sub, 0), (z_sub, 0), (pow1, 0), (pow0, 0),
            (np.asarray(t_stop, dtype=np.int32), -1),
        )
    ]
    bundle = sched.device_arrays(device)
    pool_key, buf = _take_posmap(device, Bp, int(csr["n_pad"]))
    dkey = device_key(device)
    _bump_launch("device_probe", dkey)
    with _obs.current().span("launch.device_probe", cat="kernel",
                             device=dkey, B=B):
        out = device_probe.device_probe_walk(
            *per_call, k, sched.s_len, walk_budget,
            bundle["tbl"], bundle["step_ext"], bundle["idx1"],
            bundle["idx0"], bundle["maxi1"], bundle["maxi0"],
            bundle["widths"], csr["offsets"], csr["ids"], csr["db_pad"],
            bundle["inv_pos"], p=p, tile=tile, cap=cap, kmax=KMAX,
            check_every=check_every, posmap_in=buf,
        )
    return PendingWalk(out, B, cap, pool_key, buf)


def device_probe_walk_batched_launch(
    q_words, q_sub, z_sub, pow1, pow0, gid, t_stop, k: int, *, stack, csr,
    p: int, device, tile: Optional[int] = None, cap: Optional[int] = None,
    check_every: Optional[int] = None, walk_budget: Optional[int] = None,
) -> PendingWalk:
    """The fused cross-z-group walk: ONE launch for the whole batch, every
    z-group included, on a pooled position map, dispatched without
    waiting.

    ``walk_budget`` defaults to ``max(4, n_pad // (4 * cap * B_pad))``: an
    iteration probes a tile for every query, so it costs about B_pad times
    a per-group iteration while the bail scan covers only the stragglers.
    """
    from ..core.probe_device import KMAX

    tile, cap, check_every = _walk_shape(tile, cap, check_every)
    qh = np.ascontiguousarray(np.asarray(q_words))
    B = qh.shape[0]
    Bp = pad_bucket(B, minimum=1)
    if walk_budget is None:
        walk_budget = max(4, int(csr["n_pad"]) // (4 * cap * Bp))
    per_call = [
        to_device(_pad_rows(a, Bp, fill), device)
        for a, fill in (
            (qh, 0), (q_sub, 0), (z_sub, 0), (pow1, 0), (pow0, 0),
            (np.asarray(gid, dtype=np.int32), 0),
            (np.asarray(t_stop, dtype=np.int32), -1),
        )
    ]
    bundle = stack.device_arrays(device)
    pool_key, buf = _take_posmap(device, Bp, int(csr["n_pad"]))
    dkey = device_key(device)
    _bump_launch("device_probe", dkey)
    tr = _obs.current()
    t0 = _obs.now_us() if tr.enabled else 0.0
    out = device_probe.device_probe_walk_batched(
        buf, *per_call, k, walk_budget,
        bundle["g_start"], bundle["g_end"], bundle["tbl"], bundle["step"],
        bundle["idx1"], bundle["idx0"], bundle["maxi1"], bundle["maxi0"],
        bundle["widths"], csr["offsets"], csr["ids"], csr["db_pad"],
        bundle["inv_pos"], p=p, tile=tile, cap=cap, kmax=KMAX,
        check_every=check_every,
    )
    if tr.enabled:
        tr.record("launch.device_probe.dispatch", t0, _obs.now_us(),
                  cat="kernel", device=dkey, B=B)
    return PendingWalk(out, B, cap, pool_key, buf)


def _scan_map_launch(q_words, gid, inv_pos, *, csr, p: int, chunk: int,
                     device):
    """One exhaustive map launch (K3's map kernel): a host (B, n_pad)
    int32 position map."""
    qh = np.ascontiguousarray(np.asarray(q_words))
    B = qh.shape[0]
    Bp = pad_bucket(B, minimum=1)
    n_pad = csr["n_pad"]
    chunk = min(pad_bucket(chunk, minimum=8), n_pad)
    q_t = to_device(_pad_rows(qh, Bp), device)
    g_t = to_device(_pad_rows(np.asarray(gid, dtype=np.int32), Bp), device)
    dkey = device_key(device)
    _bump_launch("device_probe_scan", dkey)
    with _obs.current().span("launch.device_probe_scan", cat="kernel",
                             device=dkey, B=B):
        pm = device_probe.device_probe_scan_multi(
            q_t, g_t, csr["db_pad"], inv_pos, csr["n"], p=p, chunk=chunk)
        return pm[:B].cpu().numpy()


def device_probe_scan_launch(q_words, *, sched, csr, p: int, device=None,
                             chunk: int = 2048):
    """The exhaustive fallback for one z-group: the exact walk position
    of every stored code for each query, a host (B, n_pad) int32 map
    (POS_INF where a code has none). ``device`` defaults to where the
    index's codes lie."""
    device = csr["db_pad"].device if device is None else device
    inv = sched.device_arrays(device)["inv_pos"]
    gid = np.zeros(np.asarray(q_words).shape[0], dtype=np.int32)
    return _scan_map_launch(q_words, gid, inv[None, :], csr=csr, p=p,
                            chunk=chunk, device=device)


def device_probe_scan_multi_launch(q_words, gid, *, stack, csr, p: int,
                                   device=None, chunk: int = 2048):
    """``device_probe_scan_launch`` across every z-group of a batch, with a
    per-query ``gid`` row into the stack's inverse-position tables."""
    device = csr["db_pad"].device if device is None else device
    inv = stack.device_arrays(device)["inv_pos"]
    return _scan_map_launch(q_words, gid, inv, csr=csr, p=p, chunk=chunk,
                            device=device)


def device_probe_scan_topk_launch(q_words, gid, t_stop, k: int, *, inv_pos,
                                  csr, p: int, device, chunk: int = 2048):
    """One exhaustive scan launch for the bailed queries of a batch, with a
    per-query ``gid`` row into ``inv_pos`` (G, pp2): each query's k
    smallest (position, id) pairs within its ``t_stop`` and its verified
    count, (ids, pos) int32 (B, k) and verified (B,) int32 device tensors
    (``device_probe.device_probe_scan_topk``). On the card a k above the
    fused kernel's ``KCAP_MAX`` takes the map route instead, chosen by
    shape: the map-writing scan kernel, then ``extract_map``'s torch
    ops."""
    qh = np.ascontiguousarray(np.asarray(q_words))
    B = qh.shape[0]
    Bp = pad_bucket(B, minimum=1)
    n_pad = csr["n_pad"]
    chunk = min(pad_bucket(chunk, minimum=8), n_pad)
    q_t = to_device(_pad_rows(qh, Bp), device)
    g_t = to_device(_pad_rows(np.asarray(gid, dtype=np.int32), Bp), device)
    ts_t = to_device(_pad_rows(np.asarray(t_stop, dtype=np.int32), Bp, -1),
                     device)
    dkey = device_key(device)
    _bump_launch("device_probe_scan", dkey)
    with _obs.current().span("launch.device_probe_scan", cat="kernel",
                             device=dkey, B=B, k=k):
        if q_t.device.type != "cuda":
            ids, pos, ver = device_probe.device_probe_scan_topk(
                q_t, g_t, ts_t, csr["db_pad"], inv_pos, csr["n"], k, p=p,
                chunk=chunk)
        elif k > device_probe.KCAP_MAX:
            pm = device_probe.device_probe_scan_multi(
                q_t, g_t, csr["db_pad"], inv_pos, csr["n"], p=p, chunk=chunk)
            ids, pos, ver = device_probe.extract_map(pm, ts_t, k)
        else:
            # the kernel's plan from the host's copies (no wait for the card)
            z = _pad_rows(np.bitwise_count(qh.view(np.uint32)).sum(axis=1),
                          Bp)
            n_sm = torch.cuda.get_device_properties(
                q_t.device).multi_processor_count
            plan = device_probe.scan_topk_plan(
                _pad_rows(np.asarray(gid, dtype=np.int32), Bp), z, k,
                int(csr["n"]), n_sm, qh.shape[1], p)
            ids, pos, ver = device_probe.device_probe_scan_topk(
                q_t, g_t, ts_t, csr["db_pad"], inv_pos, csr["n"], k, p=p,
                chunk=chunk, plan=plan)
        return ids[:B], pos[:B], ver[:B]


# ------------------------------------------------------------ linear scan
def query_popcounts(q_words: torch.Tensor) -> torch.Tensor:
    """(B, W) int32 packed queries -> (B,) int32 set bits (z)."""
    return popcount32(q_words).sum(dim=-1, dtype=torch.int32)


def _scores(q_words, z_q, db_words) -> torch.Tensor:
    """One K4 launch (its plain version on the CPU), counted."""
    dkey = device_key(q_words.device)
    _bump_launch("scan_scores", dkey)
    with _obs.current().span("launch.scan_scores", cat="kernel",
                             device=dkey, B=q_words.shape[0],
                             n=db_words.shape[0]):
        return hamming_scan_scores(q_words, z_q, db_words)


def scan_scores(q_words: torch.Tensor, db_words: torch.Tensor):
    """(B, W), (N, W) int32 -> (B, N) float32 Eq. 3 cosine scores."""
    return _scores(q_words, query_popcounts(q_words), db_words)


def _stream_topk(q_words, z_q, db_words, k: int, chunk: int, n_valid=None,
                 row_ids=None):
    """The exact top-k of the scan (``hamming_scan_topk``'s contract): one
    fused K4 launch, counted under ``scan_topk`` (its plain version on the
    CPU). On the card a k above the fused kernel's ``KCAP_MAX`` takes the
    chunked route instead, chosen by shape: one K4 score launch per
    ``chunk`` rows (each counted under ``scan_scores``) and the running
    top-K in torch ops."""
    dev = q_words.device
    if dev.type == "cuda" and k > KCAP_MAX:
        return chunked_topk(_scores, q_words, z_q, db_words, k, chunk,
                            n_valid, row_ids)
    dkey = device_key(dev)
    _bump_launch("scan_topk", dkey)
    with _obs.current().span("launch.scan_topk", cat="kernel", device=dkey,
                             B=q_words.shape[0], n=db_words.shape[0], k=k):
        return hamming_scan_topk(q_words, z_q, db_words, k, n_valid,
                                 row_ids, chunk=chunk)


def scan_topk(q_words: torch.Tensor, db_words: torch.Tensor, k: int, *,
              chunk: int = 1 << 16, n_valid=None):
    """Streaming exact angular top-K: (B, W) x (N, W) int32 -> sims
    (B, k') float32 and ids (B, k') int32, k' = min(k, N), by descending
    score, ties to the lowest id. On the card one fused K4 call scores
    every code and keeps the top-K on chip, so the (B, N) scores never
    exist; the plain version on the CPU, and a k above ``KCAP_MAX`` on the
    card, score ``chunk`` rows at a time with a running top-K merge.
    ``n_valid`` (an int or a 0-d tensor, read on the device) masks rows
    ``>= n_valid`` to -inf: their slots keep id -1."""
    N = db_words.shape[0]
    k = min(k, N)
    chunk = max(1, min(chunk, N))
    return _stream_topk(q_words, query_popcounts(q_words), db_words, k,
                        chunk, n_valid)


def merge_topk(sims: torch.Tensor, ids: torch.Tensor, k: int):
    """Merge candidate pools: (B, C) sims and ids -> the top k (B, k) by
    score, ties to the lowest column (as ``jax.lax.top_k``)."""
    k = min(k, sims.shape[1])
    best, pos = topk_first(sims, k)
    return best, torch.gather(ids, 1, pos)


def scan_topk_pruned(q_words: torch.Tensor, db_words: torch.Tensor, k: int,
                     *, blk: int = BLOCKMAX_BLK_N):
    """Block-max pruned EXACT angular top-K: (sims, ids, scanned_fraction).

    Phase 1: the per-block score maxima (one K5 launch). Phase 2: mu_k,
    the k-th largest block maximum of each query; a block whose maximum is
    below mu_k for every query holds no top-K item (k items in other
    blocks score >= mu_k), so only the others are rescored, gathered in
    id order and ranked by the fused K4 top-k with their ids.
    ``scanned_fraction`` is the float32 share of blocks rescored (a 0-d
    tensor; 1.0 is no pruning)."""
    B = q_words.shape[0]
    N = db_words.shape[0]
    dev = q_words.device
    k = min(k, N)
    blk = max(1, min(blk, N))
    n_blocks = -(-N // blk)
    z_q = query_popcounts(q_words)
    dkey = device_key(dev)
    _bump_launch("blockmax", dkey)
    with _obs.current().span("launch.blockmax", cat="kernel", device=dkey,
                             B=B, n=N):
        maxima = blockmax_scores(q_words, z_q, db_words, blk_n=blk)
    kk = min(k, n_blocks)
    mu_k = torch.topk(maxima, kk, dim=1).values[:, -1]
    needed = (maxima >= mu_k[:, None]).any(dim=0)           # (n_blocks,)
    frac = needed.to(torch.float32).mean()
    blocks = needed.nonzero().flatten()
    rows = (blocks[:, None] * blk
            + torch.arange(blk, device=dev)[None, :]).flatten()
    rows = rows[rows < N]
    sims, ids = _stream_topk(q_words, z_q, db_words.index_select(0, rows),
                             k, max(1, min(1 << 16, rows.numel())),
                             row_ids=rows.to(torch.int32))
    return sims, ids, frac


def verify_tuples_op(q_words: torch.Tensor, cand_words: torch.Tensor):
    """(W,), (N, W) int32 -> exact (r10, r01) int32 tuples of every
    candidate (one K6 launch)."""
    dkey = device_key(q_words.device)
    _bump_launch("verify", dkey)
    with _obs.current().span("launch.verify", cat="kernel", device=dkey,
                             n=cand_words.shape[0]):
        return verify_tuples(q_words, cand_words)
