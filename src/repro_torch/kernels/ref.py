"""Plain PyTorch versions of the kernels' arithmetic (the CPU path and the
on-card oracle of the CUDA kernels).

Packed codes are ``int32`` tensors over the same bits as the host's
``uint32`` words: torch has no ``~``/``>>`` for ``uint32`` on the CPU and no
``bitwise_count``. The SWAR popcount below masks after every right shift,
so the arithmetic shift of a negative ``int32`` gives the same counts as a
logical shift of the ``uint32`` it stands for.
"""

from __future__ import annotations

import torch

__all__ = [
    "popcount32",
    "tuples_ref",
    "verify_tuples_grouped_ref",
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
