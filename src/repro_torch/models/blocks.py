"""Transformer block of the port's LM (the reference's ``models/blocks.py``):

  dense   x += attn(norm(x));  x += mlp(norm(x))
  moe     x += attn(norm(x));  x += moe(norm(x)) [+ dense-residual mlp]
  ssm     x += ssd(norm(x))                         (no MLP when d_ff == 0)
  hybrid  x += g_a*attn(norm(x)) + g_m*ssd(norm(x)); x += mlp(norm(x))

``block_forward`` is the full-sequence path (the encoder, prefill, the
scoring forward), ``block_decode`` the single-token path against a KV
cache (linear, or a ring buffer of the sliding window) and an SSM state.
The enc-dec family's layers run the dense branch here (the reference's
``block_forward`` does the same; its decoder with cross-attention lives
in ``encdec.py``), and so do the vlm's (its patch embeddings enter in
``lm.py``). Caches are NamedTuples laid out as the reference lays them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import moe as moe_lib
from . import ssm as ssm_lib
from .common import check_family
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
    "cache_slot",
    "ring_buffer",
    "block_forward",
    "cross_attention_decode",
]


class AttnCache(NamedTuple):
    k: torch.Tensor    # (B, S_max, Hkv, Dh); stacked: (L, B, S_max, Hkv, Dh)
    v: torch.Tensor


class LayerCache(NamedTuple):
    attn: Optional[AttnCache]
    ssm: Optional[ssm_lib.SSMState]


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


def ring_buffer(s_cache: int, window: int) -> bool:
    """Whether a K/V cache of ``s_cache`` slots is a ring buffer: it is no
    longer than a sliding ``window``."""
    return bool(window) and s_cache <= window


def cache_slot(pos: int, s_cache: int, window: int) -> int:
    """The K/V slot the token at ``pos`` goes to in a cache of
    ``s_cache`` slots: pos % s_cache on a ring buffer, else pos."""
    return pos % s_cache if ring_buffer(s_cache, window) else pos


def attention_decode(x, p, cfg, cache: AttnCache, pos: int, *,
                     window: int = 0):
    """Single-token attention at position ``pos`` (a Python int): writes
    this token's k and v into ``cache`` in place (the reference's engine
    donates its cache) and attends over what the cache holds. Returns
    (out, cache).

    The slot is ``cache_slot``'s: on a ring buffer the key carries RoPE at
    its absolute position, so relative phases stay exact."""
    q, k, v = _attn_proj(x, p)          # (B, 1, H, Dh)
    if cfg.rope_theta > 0:
        posv = torch.full((1,), pos, device=x.device)
        cos, sin = rope_angles(posv, cfg.head_dim_, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    s_cache = cache.k.shape[1]
    slot = cache_slot(pos, s_cache, window)
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    out = decode_attention(q, cache.k, cache.v, pos + 1, window=window,
                           ring=ring_buffer(s_cache, window))
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


def _ffn(x, p, cfg):
    """The dense MLP, or the MoE block plus the dense-residual MLP, on
    (B, S, D). Returns (out, aux)."""
    if not cfg.is_moe:
        with torch.profiler.record_function("mlp"):
            return mlp(x, p["mlp"], cfg.activation), {}
    B, S, D = x.shape
    with torch.profiler.record_function("moe"):
        out, aux = moe_lib.moe_block(
            x.reshape(B * S, D), p["moe"], top_k=cfg.experts_per_token,
            capacity_factor=cfg.capacity_factor, activation=cfg.activation)
    out = out.reshape(B, S, D)
    if cfg.moe_dense_residual_ff:
        out = out + mlp(x, p["moe_dense"], cfg.activation)
    return out, aux


def _fuse(p, x, attn_out, ssm_out):
    """The hybrid's two branches, each scaled by its learned per-channel
    gate."""
    return x + p["fuse_attn"].to(x.dtype) * attn_out \
        + p["fuse_ssm"].to(x.dtype) * ssm_out


def block_forward(cfg, p, x, positions, *, window: int = 0,
                  build_cache: bool = False, moe_layer: bool = True,
                  causal: bool = True):
    """One layer, full sequence. Returns (x, aux, cache or None); ``aux``
    holds the MoE block's terms (empty elsewhere)."""
    check_family(cfg)
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
    state = None
    if cfg.family == "hybrid":
        if build_cache:
            ssm_out, state = ssm_lib.ssm_forward(h, p["ssm"], cfg,
                                                 return_state=True)
        else:
            ssm_out = ssm_lib.ssm_forward(h, p["ssm"], cfg)
        x = _fuse(p, x, attn_out, ssm_out)
    else:
        x = x + attn_out
    cache = (LayerCache(attn=AttnCache(k=k, v=v), ssm=state)
             if build_cache else None)
    aux = {}
    if cfg.d_ff > 0 or cfg.is_moe:
        h2 = apply_norm(x, p["ln2"], cfg.norm)
        if moe_layer:
            out, aux = _ffn(h2, p, cfg)
        else:
            out = mlp(h2, p["mlp"], cfg.activation)
        x = x + out
    return x, aux, cache


def block_decode(cfg, p, x, cache: LayerCache, pos: int, *,
                 window: int = 0):
    """One layer, one token. Returns (x, cache): a KV cache is written in
    place; an SSM layer returns its new state (the caller stores it)."""
    check_family(cfg)
    h = apply_norm(x, p["ln1"], cfg.norm)
    if cfg.family == "ssm":
        out, new_ssm = ssm_lib.ssm_decode_step(h, cache.ssm, p["ssm"], cfg)
        return x + out, LayerCache(attn=None, ssm=new_ssm)
    attn_out, new_attn = attention_decode(h, p["attn"], cfg, cache.attn, pos,
                                          window=window)
    new_ssm = None
    if cfg.family == "hybrid":
        ssm_out, new_ssm = ssm_lib.ssm_decode_step(h, cache.ssm, p["ssm"],
                                                   cfg)
        x = _fuse(p, x, attn_out, ssm_out)
    else:
        x = x + attn_out
    if cfg.d_ff > 0 or cfg.is_moe:
        h2 = apply_norm(x, p["ln2"], cfg.norm)
        x = x + _ffn(h2, p, cfg)[0]
    return x, LayerCache(attn=new_attn, ssm=new_ssm)
