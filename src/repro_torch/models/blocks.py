"""Transformer block of the port's LM encoder (the dense branch of the
reference's ``models/blocks.py``):

  dense   x += attn(norm(x));  x += mlp(norm(x))

The other families (MoE, SSM, hybrid, enc-dec), the decode path and its
caches are ROADMAP A11 and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from .common import not_ported
from .layers import apply_norm, apply_rope, blocked_attention, mlp, rope_angles

__all__ = ["attention_full", "block_forward"]


def _attn_proj(x, p):
    cdt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cdt))
    return q, k, v


def attention_full(x, p, cfg, positions, *, causal: bool = True,
                   window: int = 0):
    """Full-sequence self-attention; ``p`` is the attention subdict
    {wq, wk, wv, wo}."""
    q, k, v = _attn_proj(x, p)
    if cfg.rope_theta > 0:
        cos, sin = rope_angles(positions, cfg.head_dim_, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = blocked_attention(q, k, v, causal=causal, window=window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def block_forward(cfg, p, x, positions, *, window: int = 0,
                  causal: bool = True):
    """One dense layer, full sequence."""
    if cfg.family != "dense" or cfg.is_moe:
        raise not_ported(f"the {cfg.family!r} block")
    h = apply_norm(x, p["ln1"], cfg.norm)
    x = x + attention_full(h, p["attn"], cfg, positions, causal=causal,
                           window=window)
    if cfg.d_ff > 0:
        h2 = apply_norm(x, p["ln2"], cfg.norm)
        x = x + mlp(h2, p["mlp"], cfg.activation)
    return x
