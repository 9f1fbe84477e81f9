"""Gradient compression for the data-parallel all-reduce (a port of the
reference's ``optim/compression.py``): int8 block quantization with error
feedback (EF-SGD style). Each step the local gradient plus the carried
quantization residual is block-quantized to int8 and the quantization
error is carried to the next step, which keeps the accumulated bias
bounded.

The quantization functions are ported. ``compressed_psum_mean``, the
mean over the data-parallel group of several cards, needs a process group
and is not ported (ROADMAP A11).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..models.common import not_ported
from ..tree import tree_map

__all__ = [
    "apply_error_feedback",
    "compressed_psum_mean",
    "dequantize_block_int8",
    "quantize_block_int8",
    "zeros_like_residuals",
]


def quantize_block_int8(x: torch.Tensor, block: int = 256):
    """float32 tensor -> (int8 payload (padded,), float32 per-block scales)."""
    flat = x.reshape(-1).float()
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-30)[:, None])
    return q.to(torch.int8), scale


def dequantize_block_int8(q: torch.Tensor, scale: torch.Tensor, shape
                          ) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[:math.prod(shape)].reshape(tuple(shape))


def apply_error_feedback(grad: torch.Tensor, residual: torch.Tensor,
                         block: int = 256
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize (grad + residual); return (q, scale, new_residual)."""
    target = grad.float() + residual
    q, scale = quantize_block_int8(target, block)
    recon = dequantize_block_int8(q, scale, target.shape)
    return q, scale, target - recon


def compressed_psum_mean(grads, residuals, axis_names, block: int = 256):
    """The int8-compressed mean over the data-parallel cards: not ported."""
    raise not_ported("the compressed data-parallel mean over several cards")


def zeros_like_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device),
                    params, lambda x: isinstance(x, torch.Tensor))
