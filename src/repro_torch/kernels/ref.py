"""Plain PyTorch versions of the kernels' arithmetic (the CPU path and the
on-card oracle of the CUDA kernels).

Packed codes are ``int32`` tensors over the same bits as the host's
``uint32`` words: torch has no ``~``/``>>`` for ``uint32`` on the CPU and no
``bitwise_count``. The SWAR popcount below masks after every right shift,
so the arithmetic shift of a negative ``int32`` gives the same counts as a
logical shift of the ``uint32`` it stands for.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "popcount32",
    "scores_from_tuples",
    "scores_ref",
    "tuples_ref",
    "verify_tuples_grouped_ref",
    "verify_tuples_ref",
]


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int32 lanes (read as uint32 bits) -> int32 counts.

    Each right shift is followed by a mask that clears every bit the sign
    extension could have set, and the products wrap modulo 2^32 exactly as
    in uint32, so the count is the uint32 popcount."""
    v = v.to(torch.int32)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    # the byte sums are <= 32, so bit 31 of the product is clear and the
    # arithmetic shift below is a logical one
    return (v * 0x01010101) >> 24


def tuples_ref(q_words: torch.Tensor, db_words: torch.Tensor):
    """Hamming tuples of every (query, code) pair.

    q_words: (B, W) int32; db_words: (N, W) int32 -> r10, r01: (B, N) int32.
    """
    q = q_words[:, None, :]
    b = db_words[None, :, :]
    r10 = popcount32(q & ~b).sum(dim=-1, dtype=torch.int32)
    r01 = popcount32(~q & b).sum(dim=-1, dtype=torch.int32)
    return r10, r01


# den_sq = z * |code| <= 256 * 256 for the codes the kernels take (p <= 256)
_DEN_MAX = 256 * 256


@functools.lru_cache(maxsize=None)
def _inv_sqrt_table(device: str) -> torch.Tensor:
    """rn(1 / rn(sqrt(d))) in float32 for every integer d in [0, 65536]
    (entry 0 unused), by numpy's IEEE float32 square root and division.
    torch's CPU float32 ``sqrt`` is not correctly rounded on every build
    (a vectorised approximation), so the plain version reads the table."""
    d = np.arange(_DEN_MAX + 1, dtype=np.float32)
    d[0] = 1.0
    inv = np.float32(1.0) / np.sqrt(d)
    return torch.from_numpy(inv).to(device)


def scores_from_tuples(z_q: torch.Tensor, r10: torch.Tensor,
                       r01: torch.Tensor) -> torch.Tensor:
    """Eq. 3 cosine sims from tuples in float32, 0.0 where the
    denominator is not positive (a zero-norm query or code).

    z_q: (B,) int32 query popcounts; r10, r01: (B, N) int32 -> (B, N)
    float32 ``num * (1 / sqrt(den_sq))`` with ``num = z - r10`` and
    ``den_sq = z * (z - r10 + r01)``, exact integers, and the square root,
    the reciprocal and the product each correctly rounded, as the CUDA
    kernels compute them (``__fsqrt_rn``, ``__frcp_rn``): the two agree bit
    for bit. Codes of at most 256 bits (``den_sq <= 65536``)."""
    z = z_q.to(torch.float32)[:, None]
    r10f = r10.to(torch.float32)
    num = z - r10f
    den_sq = z * (z - r10f + r01.to(torch.float32))
    pos = den_sq > 0
    idx = torch.where(pos, den_sq, 0.0).to(torch.int64)
    inv = _inv_sqrt_table(str(den_sq.device))[idx]
    return torch.where(pos, num * inv, 0.0)


def scores_ref(q_words: torch.Tensor, db_words: torch.Tensor,
               z_q: torch.Tensor) -> torch.Tensor:
    """(B, W), (N, W), (B,) -> (B, N) float32 Eq. 3 scores (W <= 8)."""
    if q_words.shape[-1] > 8:
        raise ValueError(f"W={q_words.shape[-1]} words: p <= 256 only")
    r10, r01 = tuples_ref(q_words, db_words)
    return scores_from_tuples(z_q, r10, r01)


def verify_tuples_ref(q_words: torch.Tensor, cand_words: torch.Tensor):
    """One query against a block: (W,), (N, W) -> (r10, r01), (N,) int32."""
    r10, r01 = tuples_ref(q_words[None, :], cand_words)
    return r10[0], r01[0]


def verify_tuples_grouped_ref(
    q_words: torch.Tensor,
    cand_words: torch.Tensor,
    lengths: torch.Tensor,
    p: int,
) -> torch.Tensor:
    """(B, W), (B, C, W), (B,) -> (B, C) int32 packed bucket keys
    ``r10 * (p + 1) + r01``, -1 where ``c >= lengths[b]`` (padding)."""
    q = q_words[:, None, :]
    c = cand_words
    r10 = popcount32(q & ~c).sum(dim=-1, dtype=torch.int32)
    r01 = popcount32(~q & c).sum(dim=-1, dtype=torch.int32)
    key = r10 * (p + 1) + r01
    col = torch.arange(c.shape[1], dtype=torch.int32, device=c.device)
    valid = col[None, :] < lengths.to(torch.int32)[:, None]
    return torch.where(valid, key, torch.full_like(key, -1))
