"""K4: the linear scan's kernels (``csrc/hamming_scan.cu``).

``hamming_scan_scores`` is the port of the reference's Pallas kernel of
the same name (``_scores_kernel``): (B, W) queries with their popcounts
(B,) against (N, W) codes -> (B, N) float32 cosine scores. Both it and
its plain version compute ``num * (1 / sqrt(den_sq))`` with correctly
rounded float32 steps, so kernel and plain version agree bit for bit.

``hamming_scan_topk`` is the scan's exact top-k fused into the scoring
pass (the reference's chunk loop of ``scan_topk`` around that kernel):
(B, k) float32 sims and int32 ids by descending score, ties to the lowest
id, without ever writing the (B, N) scores. Its plain version,
``hamming_scan_topk_plain``, is the reference's chunk loop in torch ops;
the two agree bit for bit, sims and ids.

Each entry point launches its CUDA kernel on a CUDA tensor and runs its
plain version on a CPU tensor.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import scores_ref

__all__ = ["KCAP_MAX", "LAUNCHES", "chunked_topk", "hamming_scan_scores",
           "hamming_scan_scores_plain", "hamming_scan_topk",
           "hamming_scan_topk_plain", "topk_first", "topk_plan"]

# kernel launches so far (bumped where the kernel is launched, nowhere else)
LAUNCHES = {"hamming_scan": 0, "hamming_scan_topk": 0}

# the largest k the fused kernel takes (its keys per query: a power of two)
KCAP_MAX = 1024
# threads of a fused block, and rows one step of it scores (csrc: TOPK_THREADS)
TOPK_THREADS = 256
# bytes of shared memory a pass-1 block spends on its queries' keys
_KEY_BYTES = 64 * 1024
# queries a pass-1 block takes at most (csrc: TOPK_QMAX)
_QMAX = 16


def hamming_scan_scores_plain(q_words, z_q, db_words):
    """(B, W), (B,), (N, W) int32 -> (B, N) float32 Eq. 3 scores."""
    return scores_ref(q_words, db_words, z_q)


def _launch(lib, q_words, z_q, db_words, out, stream: int) -> None:
    B, W = q_words.shape
    N = db_words.shape[0]
    dev = q_words.device
    if W > 8:
        raise ValueError(f"W={W} words exceeds the kernel's 8 (p <= 256)")
    ptrs = [
        _build.require(q_words, "q_words", (B, W), dev),
        _build.require(z_q, "z_q", (B,), dev),
        _build.require(db_words, "db_words", (N, W), dev),
        _build.require(out, "out", (B, N), dev, torch.float32),
    ]
    _build.call(lib, "hamming_scan", ptrs, [B, W, N], stream)


def hamming_scan_scores(q_words, z_q, db_words):
    """(B, W), (B,), (N, W) int32 -> (B, N) float32 Eq. 3 scores, 0.0
    where the query or the code has no set bit."""
    if q_words.device.type == "cpu":
        return hamming_scan_scores_plain(q_words, z_q, db_words)
    if q_words.device.type != "cuda":
        raise ValueError(f"no kernel for device {q_words.device}")
    out = torch.empty((q_words.shape[0], db_words.shape[0]),
                      dtype=torch.float32, device=q_words.device)
    if out.numel():
        _launch(_build.load("hamming_scan"), q_words, z_q, db_words, out,
                _build.stream_of(q_words.device))
        LAUNCHES["hamming_scan"] += 1
    return out


# ------------------------------------------------------------ fused top-k
def topk_first(vals: torch.Tensor, k: int):
    """``jax.lax.top_k`` of float32 rows: the k largest values, ties to
    the lowest position. ``torch.topk`` promises no order among ties, so
    it ranks an int64 key: the value's order-preserving int32 image in the
    high half, the complemented position in the low half. Returns
    (values, positions)."""
    bits = vals.contiguous().view(torch.int32)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    pos = torch.arange(vals.shape[1], dtype=torch.int64, device=vals.device)
    key = order * (1 << 32) + ((1 << 32) - 1 - pos)
    sel = torch.topk(key, k, dim=1).indices
    return torch.gather(vals, 1, sel), sel


def chunked_topk(score_fn, q_words, z_q, db_words, k: int, chunk: int,
                 n_valid=None, row_ids=None):
    """Running top-k over ``db_words`` in chunks of ``chunk`` rows, each
    scored by ``score_fn(q_words, z_q, rows)``: (B, k) float32 sims and
    int32 ids, -inf and -1 in slots no valid row fills. A row's id is its
    index, or ``row_ids[index]`` where given (ascending); rows whose id is
    ``>= n_valid`` score -inf. Each step ranks [best so far, chunk] and
    every id in the chunk exceeds every id kept, so ties go to the lowest
    id, as in the reference."""
    B = q_words.shape[0]
    N = db_words.shape[0]
    dev = q_words.device
    chunk = max(1, chunk)
    best_sims = torch.full((B, k), float("-inf"), dtype=torch.float32,
                           device=dev)
    best_ids = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        sims = score_fn(q_words, z_q, db_words[lo:hi])
        if row_ids is None:
            ids = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        else:
            ids = row_ids[lo:hi]
        if n_valid is not None:
            sims = torch.where(ids[None, :] < n_valid, sims, float("-inf"))
        all_sims = torch.cat([best_sims, sims], dim=1)
        all_ids = torch.cat([best_ids, ids[None, :].expand(B, -1)], dim=1)
        best_sims, pos = topk_first(all_sims, k)
        best_ids = torch.gather(all_ids, 1, pos)
    return best_sims, best_ids


def hamming_scan_topk_plain(q_words, z_q, db_words, k: int, n_valid=None,
                            row_ids=None, *, chunk: int = 1 << 16):
    """The plain version of ``hamming_scan_topk``: the chunk loop over the
    plain scores (``chunked_topk``)."""
    return chunked_topk(hamming_scan_scores_plain, q_words, z_q, db_words, k,
                        chunk, n_valid, row_ids)


def _up16(x: int) -> int:
    return -(-x // 16) * 16


def _tiles_smem(QT: int, L: int, W: int) -> int:
    """Pass 1's dynamic shared memory (csrc: ``topk_smem``)."""
    QR = 1 if QT == 1 else _QMAX
    return (_up16(_up16(QT * L * 8 + QR * W * 4) + QT * 12)
            + QR * (32 * W + 1) * 4)


def topk_plan(B: int, N: int, k: int, n_sm: int, W: int = 4,
              tile_rows=None) -> dict:
    """The fused kernel's shape for (B, N, k) and codes of W words on a
    card of ``n_sm`` SMs: ``L`` keys per query in shared memory (the best
    k plus at least one step of staging, a power of two), ``QT`` queries
    per pass-1 block, and the row tile. Without ``tile_rows`` the tiles
    fill one wave of the blocks that fit on the SMs at once (two an SM for
    one query), but stay few enough that the (B, tiles, k) keys of pass 1
    keep within 1% of the (B, N) float32 scores (``tiles <= N / (200 k)``),
    and at least one step long."""
    kcap = 1 << max(0, k - 1).bit_length()
    L = 2 * max(kcap, TOPK_THREADS)
    QT = max(1, min(_KEY_BYTES // (8 * L), B))
    n_qtiles = -(-B // QT)
    if tile_rows is None:
        if QT == 1:
            # two blocks an SM (each thread loads 4 rows a step) read the
            # codes near the memory rate, and pass 2's one block a query
            # reads tiles x k keys: fewer tiles keep it short
            per_sm = 2
        else:
            # as many as fit at once: 3 by the kernel's launch bounds, and
            # by the 227 KiB of shared memory an SM has (1 KiB a block kept)
            per_sm = min(3, 232448 // (_tiles_smem(QT, L, W) + 1024))
        tiles = -(-max(1, per_sm) * n_sm // n_qtiles)
        tiles = max(1, min(tiles, N // (200 * max(k, 1)),
                           -(-N // TOPK_THREADS)))
        tile_rows = -(-N // tiles)
        tile_rows = -(-tile_rows // TOPK_THREADS) * TOPK_THREADS
    tile_rows = max(1, int(tile_rows))
    return {"L": L, "QT": QT, "n_qtiles": n_qtiles, "tile_rows": tile_rows,
            "n_tiles": max(1, -(-N // tile_rows))}


def _launch_topk(lib, q_words, z_q, db_words, k: int, n_valid, row_ids,
                 sims, ids, part, plan: dict, stream: int) -> None:
    B, W = q_words.shape
    N = db_words.shape[0]
    dev = q_words.device
    if W > 8:
        raise ValueError(f"W={W} words exceeds the kernel's 8 (p <= 256)")
    if not 0 < k <= KCAP_MAX:
        raise ValueError(f"k={k}: the fused top-k takes 1 <= k <= "
                         f"{KCAP_MAX}")
    if W % 4 == 0 and (q_words.data_ptr() % 16 or db_words.data_ptr() % 16):
        raise ValueError("q_words, db_words: codes of 4 or 8 words must "
                         "start on a 16-byte boundary (the kernel's vector "
                         "loads)")
    nv_ptr, nv = 0, 0x7FFFFFFF
    if isinstance(n_valid, torch.Tensor):
        nv_ptr = _build.require(n_valid, "n_valid", (), dev)
    elif n_valid is not None:
        nv = max(-1, min(int(n_valid), 0x7FFFFFFF))
    ptrs = [
        _build.require(q_words, "q_words", (B, W), dev),
        _build.require(z_q, "z_q", (B,), dev),
        _build.require(db_words, "db_words", (N, W), dev),
        0 if row_ids is None else _build.require(row_ids, "row_ids", (N,),
                                                 dev),
        nv_ptr,
        _build.require(part, "part", (B, plan["n_tiles"], k), dev,
                       torch.int64),
        _build.require(sims, "sims", (B, k), dev, torch.float32),
        _build.require(ids, "ids", (B, k), dev),
    ]
    _build.call(lib, "hamming_scan_topk", ptrs,
                [B, W, N, k, plan["L"], plan["QT"], plan["tile_rows"],
                 plan["n_tiles"], plan["n_qtiles"], nv], stream)


def _device_n_valid(n_valid, dev):
    """A 0-d tensor ``n_valid`` as int32 on ``dev``, without a host sync."""
    if not isinstance(n_valid, torch.Tensor):
        return n_valid
    nv = n_valid.reshape(()).to(dev)
    return nv.clamp(-1, 0x7FFFFFFF).to(torch.int32).contiguous()


def hamming_scan_topk(q_words, z_q, db_words, k: int, n_valid=None,
                      row_ids=None, *, chunk: int = 1 << 16):
    """(B, W), (B,), (N, W) int32 -> the top k (B, k) float32 sims and
    int32 ids by descending Eq. 3 score, ties to the lowest id; a row's id
    is its index or ``row_ids[index]`` (ascending int32), rows whose id is
    ``>= n_valid`` (an int or a 0-d tensor) take no part, and slots no row
    fills hold -inf and -1. ``chunk`` is the plain version's chunk; the
    kernel takes 1 <= k <= ``KCAP_MAX`` and raises above it."""
    if q_words.device.type == "cpu":
        return hamming_scan_topk_plain(q_words, z_q, db_words, k, n_valid,
                                       row_ids, chunk=chunk)
    dev = q_words.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    B, N = q_words.shape[0], db_words.shape[0]
    sims = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0 or k == 0:
        return sims, ids
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = topk_plan(B, N, k, n_sm, W=q_words.shape[1])
    part = torch.empty((B, plan["n_tiles"], k), dtype=torch.int64,
                       device=dev)
    _launch_topk(_build.load("hamming_scan"), q_words, z_q, db_words, k,
                 _device_n_valid(n_valid, dev), row_ids, sims, ids, part,
                 plan, _build.stream_of(dev))
    LAUNCHES["hamming_scan_topk"] += 1
    return sims, ids
