"""K5: per-block maxima of the Eq. 3 scores (phase 1 of the pruned scan).

``blockmax_scores`` is the port of the reference's Pallas kernel of the
same name (``_blockmax_kernel``): (B, W) queries with their popcounts
(B,) against (N, W) codes -> (B, ceil(N / blk_n)) float32, the largest
score of each block of ``blk_n`` rows. The reference pads N to a multiple
of ``blk_n`` with zero codes, which score 0.0; here the last block is
ragged and its missing rows count as such zero codes, which changes no
maximum (every score is >= 0) and copies no padded array. On a CUDA
tensor it launches the CUDA kernel (``csrc/blockmax_scan.cu``, one wave
of blocks that each walk whole blocks of rows, planned by
``blockmax_plan``); on a CPU tensor it runs ``blockmax_scores_plain``.
Both take the maximum of the same float32 scores as ``hamming_scan``, so
they agree bit for bit.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import scores_ref

__all__ = ["DEFAULT_BLK_N", "LAUNCHES", "blockmax_plan", "blockmax_scores",
           "blockmax_scores_plain"]

DEFAULT_BLK_N = 2048
_QMAX = 16   # queries a kernel block takes (csrc: BM_QMAX), one if B = 1

# kernel launches so far (bumped where the kernel is launched, nowhere else)
LAUNCHES = {"blockmax_scan": 0}


def blockmax_scores_plain(q_words, z_q, db_words, blk_n: int = DEFAULT_BLK_N):
    """(B, W), (B,), (N, W) int32 -> (B, ceil(N / blk_n)) float32, scored
    a few blocks at a time so the (B, rows) scores stay small."""
    B = q_words.shape[0]
    N = db_words.shape[0]
    step = blk_n * max(1, (1 << 16) // blk_n)
    out = []
    for lo in range(0, N, step):
        sims = scores_ref(q_words, db_words[lo : lo + step], z_q)
        n_blocks = -(-sims.shape[1] // blk_n)
        pad = n_blocks * blk_n - sims.shape[1]   # zero codes score 0.0
        sims = torch.nn.functional.pad(sims, (0, pad), value=0.0)
        out.append(sims.reshape(B, n_blocks, blk_n).amax(dim=-1))
    if not out:
        return torch.empty((B, 0), dtype=torch.float32,
                           device=q_words.device)
    return torch.cat(out, dim=1)


def blockmax_plan(B: int, N: int, blk_n: int, n_sm: int, W: int) -> dict:
    """The kernel's grid for B queries over N codes of W words in blocks
    of ``blk_n`` rows on a card of ``n_sm`` SMs: ``n_qtiles`` tiles of 16
    queries (one tile of one query if B = 1), and the row blocks
    ("groups") a kernel block walks, so that the kernel blocks fill one
    wave of those that fit at once (csrc: ``BM_BLOCKS_PER_SM``, the
    launch bounds: 4 an SM up to 2 words, 3 up to 4 words, 2 above them
    or for one query above 2 words)."""
    n_qtiles = -(-B // (1 if B == 1 else _QMAX))
    n_groups = -(-N // blk_n)
    per_sm = 4 if W <= 2 else 3 if W <= 4 and B > 1 else 2
    chunks = max(1, per_sm * n_sm // n_qtiles)
    gpb = -(-n_groups // chunks)
    return {"n_qtiles": n_qtiles, "n_groups": n_groups,
            "groups_per_block": gpb, "n_chunks": -(-n_groups // gpb)}


def _launch(lib, q_words, z_q, db_words, out, blk_n: int, plan: dict,
            stream: int) -> None:
    B, W = q_words.shape
    N = db_words.shape[0]
    dev = q_words.device
    if W > 8:
        raise ValueError(f"W={W} words exceeds the kernel's 8 (p <= 256)")
    ptrs = [
        _build.require(q_words, "q_words", (B, W), dev),
        _build.require(z_q, "z_q", (B,), dev),
        _build.require(db_words, "db_words", (N, W), dev),
        _build.require(out, "out", (B, -(-N // blk_n)), dev, torch.float32),
    ]
    # 16-byte code loads where every row starts on a 16-byte boundary;
    # other codes take the scalar-load instantiation
    vec = W % 4 == 0 and db_words.data_ptr() % 16 == 0
    _build.call(lib, "blockmax_scan", ptrs,
                [B, W, N, blk_n, plan["groups_per_block"], vec], stream)


def blockmax_scores(q_words, z_q, db_words, *, blk_n: int = DEFAULT_BLK_N):
    """(B, W), (B,), (N, W) int32 -> (B, ceil(N / blk_n)) float32 maxima
    of the Eq. 3 scores per block of ``blk_n`` code rows."""
    if blk_n <= 0:
        raise ValueError(f"blk_n={blk_n} must be positive")
    if q_words.device.type == "cpu":
        return blockmax_scores_plain(q_words, z_q, db_words, blk_n)
    if q_words.device.type != "cuda":
        raise ValueError(f"no kernel for device {q_words.device}")
    N = db_words.shape[0]
    out = torch.empty((q_words.shape[0], -(-N // blk_n)),
                      dtype=torch.float32, device=q_words.device)
    if out.numel():
        n_sm = torch.cuda.get_device_properties(
            q_words.device).multi_processor_count
        plan = blockmax_plan(q_words.shape[0], N, blk_n, n_sm,
                             W=q_words.shape[1])
        _launch(_build.load("blockmax_scan"), q_words, z_q, db_words, out,
                blk_n, plan, _build.stream_of(q_words.device))
        LAUNCHES["blockmax_scan"] += 1
    return out
