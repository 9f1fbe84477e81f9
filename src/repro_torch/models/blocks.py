"""Transformer block of the port's LM (the dense, encoder-decoder and SSM
branches of the reference's ``models/blocks.py``):

  dense   x += attn(norm(x));  x += mlp(norm(x))
  ssm     x += ssd(norm(x))                         (no MLP when d_ff == 0)

``block_forward`` is the full-sequence path (the encoder, prefill, the
scoring forward), ``block_decode`` the single-token path against a KV
cache or an SSM state. The enc-dec family's layers run the dense branch
here (the reference's ``block_forward`` does the same; its decoder with
cross-attention lives in ``encdec.py``). Caches are NamedTuples laid out
as the reference lays them. MoE and hybrid are ROADMAP A11 and raise
``NotImplementedError``, and so does the vlm family.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import ssm as ssm_lib
from .common import not_ported
from .layers import (
    apply_norm,
    apply_rope,
    blocked_attention,
    decode_attention,
    mlp,
    rope_angles,
)

__all__ = [
    "AttnCache",
    "LayerCache",
    "attention_decode",
    "attention_full",
    "block_decode",
    "block_forward",
    "cross_attention_decode",
]


class AttnCache(NamedTuple):
    k: torch.Tensor    # (B, S_max, Hkv, Dh); stacked: (L, B, S_max, Hkv, Dh)
    v: torch.Tensor


class LayerCache(NamedTuple):
    attn: Optional[AttnCache]
    ssm: Optional[ssm_lib.SSMState]


def _ported(cfg):
    if cfg.family not in ("dense", "encdec", "ssm") or cfg.is_moe:
        raise not_ported(f"the {cfg.family!r} block")


def _attn_proj(x, p):
    cdt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cdt))
    return q, k, v


def attention_full(x, p, cfg, positions, *, causal: bool = True,
                   window: int = 0):
    """Full-sequence self-attention; ``p`` is the attention subdict
    {wq, wk, wv, wo}. Returns (out, (k, v)), k after RoPE, for the
    cache."""
    q, k, v = _attn_proj(x, p)
    if cfg.rope_theta > 0:
        cos, sin = rope_angles(positions, cfg.head_dim_, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = blocked_attention(q, k, v, causal=causal, window=window,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, (k, v)


def attention_decode(x, p, cfg, cache: AttnCache, pos: int, *,
                     window: int = 0):
    """Single-token attention at position ``pos`` (a Python int): writes
    this token's k and v into slot ``pos`` of ``cache`` in place (the
    reference's engine donates its cache) and attends over slots
    [0, pos]. Returns (out, cache)."""
    q, k, v = _attn_proj(x, p)          # (B, 1, H, Dh)
    if cfg.rope_theta > 0:
        posv = torch.full((1,), pos, device=x.device)
        cos, sin = rope_angles(posv, cfg.head_dim_, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    cache.k[:, pos] = k[:, 0].to(cache.k.dtype)
    cache.v[:, pos] = v[:, 0].to(cache.v.dtype)
    out = decode_attention(q, cache.k, cache.v, pos + 1, window=window)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, cache


def cross_attention_decode(x, p, cfg, cross_k, cross_v):
    """Decoder-side cross-attention of (B, 1, d) against the encoder's
    precomputed (B, S_enc, Hkv, Dh) k and v: K7 with ``valid_len`` =
    S_enc."""
    cdt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cdt))
    out = decode_attention(q, cross_k, cross_v, cross_k.shape[1])
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cdt))


def block_forward(cfg, p, x, positions, *, window: int = 0,
                  build_cache: bool = False, causal: bool = True):
    """One layer, full sequence. Returns (x, aux, cache or None)."""
    _ported(cfg)
    h = apply_norm(x, p["ln1"], cfg.norm)
    if cfg.family == "ssm":
        cache = None
        if build_cache:
            out, state = ssm_lib.ssm_forward(h, p["ssm"], cfg,
                                             return_state=True)
            cache = LayerCache(attn=None, ssm=state)
        else:
            out = ssm_lib.ssm_forward(h, p["ssm"], cfg)
        return x + out, {}, cache
    attn_out, (k, v) = attention_full(h, p["attn"], cfg, positions,
                                      causal=causal, window=window)
    x = x + attn_out
    cache = (LayerCache(attn=AttnCache(k=k, v=v), ssm=None)
             if build_cache else None)
    if cfg.d_ff > 0:
        h2 = apply_norm(x, p["ln2"], cfg.norm)
        x = x + mlp(h2, p["mlp"], cfg.activation)
    return x, {}, cache


def block_decode(cfg, p, x, cache: LayerCache, pos: int, *,
                 window: int = 0):
    """One layer, one token. Returns (x, cache): a KV cache is written in
    place; an SSM layer returns its new state (the caller stores it)."""
    _ported(cfg)
    h = apply_norm(x, p["ln1"], cfg.norm)
    if cfg.family == "ssm":
        out, new_ssm = ssm_lib.ssm_decode_step(h, cache.ssm, p["ssm"], cfg)
        return x + out, LayerCache(attn=None, ssm=new_ssm)
    attn_out, new_attn = attention_decode(h, p["attn"], cfg, cache.attn, pos,
                                          window=window)
    x = x + attn_out
    if cfg.d_ff > 0:
        h2 = apply_norm(x, p["ln2"], cfg.norm)
        x = x + mlp(h2, p["mlp"], cfg.activation)
    return x, LayerCache(attn=new_attn, ssm=None)
