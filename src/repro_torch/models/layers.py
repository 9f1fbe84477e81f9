"""Core layers of the port's LM: norms (RMSNorm, LayerNorm), RoPE,
sinusoidal positions, MLPs and attention (a port of the reference's
``models/layers.py``).

``blocked_attention`` (training, prefill, the encoder) and
``decode_attention`` (one query row against a linear or ring-buffer KV
cache, with ``valid_len``) run K7 (``kernels.flash_attention``): the
kernel on a CUDA tensor, its plain version on a CPU tensor, as the
reference runs its Pallas kernel on the TPU. ``_blocked_attention_impl`` and
``_decode_attention_impl`` are the reference's pure paths, which the
reference runs off the TPU; the port keeps them as second plain versions
that the tests hold against the reference, and ``blocked_attention``'s
gradient recomputes through ``_blocked_attention_impl``, as the
reference's does. No caller of the port shifts the query block (the reference's
``q_offset``), so neither blocked function takes one.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import NEG_INF, flash_attention

__all__ = [
    "apply_norm",
    "apply_rope",
    "blocked_attention",
    "decode_attention",
    "layernorm",
    "mlp",
    "rmsnorm",
    "rope_angles",
    "sinusoidal_positions",
]


# ------------------------------------------------------------------ norms
def rmsnorm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dt)


def layernorm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


def apply_norm(x, params, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])


# ------------------------------------------------------------------- RoPE
def rope_angles(positions, head_dim: int, theta: float):
    """positions (...,) -> cos/sin (..., head_dim/2), float32."""
    half = head_dim // 2
    freqs = 1.0 / (
        theta ** (torch.arange(0, half, dtype=torch.float32,
                               device=positions.device) / half)
    )
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, D); cos/sin: (..., S, D/2) broadcast over heads."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dt)


# ------------------------------------------------ sinusoidal (whisper enc)
def sinusoidal_positions(seq: int, d_model: int, device=None):
    """(seq, d_model) float32: sin then cos of each position times
    10000^(-i / half)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / half)
    ang = pos * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ------------------------------------------------------------------- MLPs
def mlp(x, params, activation: str):
    """Gated (SwiGLU, GeGLU; weights wi, wi_gate, wo) or ungated
    (``"gelu"``, whisper; weights wi, wo) feed-forward, gelu in its tanh
    form."""
    cdt = x.dtype
    if activation in ("swiglu", "geglu"):
        act = F.silu if activation == "swiglu" else functools.partial(
            F.gelu, approximate="tanh")
        h = act(x @ params["wi_gate"].to(cdt)) * (x @ params["wi"].to(cdt))
    else:  # gelu
        h = F.gelu(x @ params["wi"].to(cdt), approximate="tanh")
    return h @ params["wo"].to(cdt)


# ------------------------------------------------------------- attention
def blocked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_chunk: int = 1024, kv_chunk: int = 1024):
    """Online-softmax attention: (B, Sq, Hq, D) queries against
    (B, Sk, Hkv, D) keys and values -> (B, Sq, Hq, D), through K7 (the
    kernel on a CUDA tensor, its plain version on a CPU tensor). Its
    gradient recomputes through ``_blocked_attention_impl`` in
    ``q_chunk`` x ``kv_chunk`` blocks (``_FlashFwdOracleBwd``). It runs in
    the ``flash_attn`` range, the reference's named scope."""
    with torch.profiler.record_function("flash_attn"):
        return _FlashFwdOracleBwd.apply(q, k, v, causal, window, q_chunk,
                                        kv_chunk)


class _FlashFwdOracleBwd(torch.autograd.Function):
    """K7's forward with the reference's pure blocked attention as its
    gradient (the reference's ``_flash_fwd_oracle_bwd`` custom vjp): the
    backward recomputes the attention through ``_blocked_attention_impl``
    with autograd and returns its vjp. The reference has no backward
    kernel, so the backward is torch ops.

    The recompute runs on float32 copies of q, k and v, and the gradients
    are rounded to their inputs' dtype once, at the end. (The blocked
    attention computes in float32 anyway; on bf16 inputs it would also
    round P, and so P's cotangent, to bf16, which puts the gradients up
    to several bf16 steps off the float32 gradient.) In float32 the two
    are the same computation."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, q_chunk, kv_chunk)
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        causal, window, q_chunk, kv_chunk = ctx.opts
        with torch.profiler.record_function("flash_attn_bwd"), \
                torch.enable_grad():
            saved = ctx.saved_tensors
            q, k, v = (t.detach().float().requires_grad_(True)
                       for t in saved)
            out = _blocked_attention_impl(q, k, v, causal=causal,
                                          window=window, q_chunk=q_chunk,
                                          kv_chunk=kv_chunk)
            grads = torch.autograd.grad(out, (q, k, v), g.float())
        return (*(d.to(t.dtype) for d, t in zip(grads, saved)), None, None,
                None, None)


def _chunk_mask(q_pos, k_pos, causal: bool, window: int):
    """(Sq, Sk) additive mask in float32."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    return torch.where(ok, 0.0, NEG_INF)


def _blocked_attention_impl(q, k, v, *, causal: bool, window: int = 0,
                            q_chunk: int = 1024,
                            kv_chunk: int = 1024):
    """The reference's pure blocked attention: q and kv chunks, an
    additive mask, p cast to v's dtype before the PV product."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = D ** -0.5
    dev = q.device
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq = -(-Sq // q_chunk)
    nk = -(-Sk // kv_chunk)
    Sq_p, Sk_p = nq * q_chunk, nk * kv_chunk

    qf = F.pad(q, (0, 0, 0, 0, 0, Sq_p - Sq))
    kf = F.pad(k, (0, 0, 0, 0, 0, Sk_p - Sk))
    vf = F.pad(v, (0, 0, 0, 0, 0, Sk_p - Sk))
    qf = qf.reshape(B, nq, q_chunk, Hkv, G, D)
    kf = kf.reshape(B, nk, kv_chunk, Hkv, D)
    vf = vf.reshape(B, nk, kv_chunk, Hkv, D)

    q_pos_all = torch.arange(Sq_p, device=dev)
    k_pos_all = torch.arange(Sk_p, device=dev)
    k_valid_all = k_pos_all < Sk

    outs = []
    for qi in range(nq):
        q_blk = qf[:, qi].float()
        q_pos = q_pos_all[qi * q_chunk:(qi + 1) * q_chunk]
        m = torch.full((B, q_chunk, Hkv, G), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, q_chunk, Hkv, G), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((B, q_chunk, Hkv, G, D), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            k_blk = kf[:, ki]
            v_blk = vf[:, ki]
            k_pos = k_pos_all[ki * kv_chunk:(ki + 1) * kv_chunk]
            k_val = k_valid_all[ki * kv_chunk:(ki + 1) * kv_chunk]
            s = torch.einsum("bqhgd,bkhd->bqhgk", q_blk, k_blk.float()) \
                * scale
            mask = _chunk_mask(q_pos, k_pos, causal, window)
            mask = torch.where(k_val[None, :], mask, NEG_INF)
            s = s + mask[None, :, None, None, :]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bqhgk,bkhd->bqhgd",
                              p.to(v_blk.dtype).float(), v_blk.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, dim=1).reshape(B, Sq_p, Hq, D)[:, :Sq]
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     ring: bool = False):
    """One query row (B, 1, Hq, D) against a KV cache (B, S, Hkv, D),
    through K7 with ``valid_len``. ``cache_len`` is the number of tokens
    written so far, a Python int, so nothing waits for the card.

    A linear cache's valid slots are [0, cache_len), with ``window`` only
    the last ``window`` of them. A ring buffer (``ring=True``, slot =
    position % S, the hybrid family's sliding window) holds by
    construction exactly the last min(cache_len, S) positions in slots
    [0, min(cache_len, S)), so it runs with that ``valid_len`` and no
    window: a softmax over a set of slots does not depend on their order.
    (The reference's ring branch bypasses its kernel; its plain path is
    ``_decode_attention_impl`` with ``ring=True``.) It runs in the
    ``decode_attn`` range, the reference's named scope."""
    if ring:
        cache_len, window = min(int(cache_len), k_cache.shape[1]), 0
    with torch.profiler.record_function("decode_attn"):
        return flash_attention(q.contiguous(), k_cache.contiguous(),
                               v_cache.contiguous(), causal=False,
                               window=window, valid_len=int(cache_len))


def _decode_attention_impl(q, k_cache, v_cache, cache_len, *,
                           window: int = 0, ring: bool = False):
    """The reference's pure decode attention: scores in float32, a masked
    softmax, p cast to v's dtype before the PV product; on a ring buffer
    the slots below ``cache_len`` and no window mask."""
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    qh = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qh, k_cache.float()) * D ** -0.5
    k_pos = torch.arange(S, device=q.device)
    ok = k_pos < cache_len
    if window > 0 and not ring:
        ok &= k_pos >= cache_len - window
    s = torch.where(ok[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)
