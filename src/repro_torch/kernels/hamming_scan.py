"""K4: Eq. 3 scores of every (query, code) pair, the linear scan's body.

``hamming_scan_scores`` is the port of the reference's Pallas kernel of
the same name (``_scores_kernel``): (B, W) queries with their popcounts
(B,) against (N, W) codes -> (B, N) float32 cosine scores. On a CUDA
tensor it launches the CUDA kernel (``csrc/hamming_scan.cu``); on a CPU
tensor it runs ``hamming_scan_scores_plain``, the same function in plain
PyTorch. Both compute ``num * (1 / sqrt(den_sq))`` with correctly rounded
float32 steps, so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import scores_ref

__all__ = ["LAUNCHES", "hamming_scan_scores", "hamming_scan_scores_plain"]

# kernel launches so far (bumped where the kernel is launched, nowhere else)
LAUNCHES = {"hamming_scan": 0}


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
