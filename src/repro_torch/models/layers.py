"""Core layers of the port's LM encoder: norms, RoPE, MLPs and attention
(a port of the reference's ``models/layers.py``).

``blocked_attention`` runs K7 (``kernels.flash_attention``): the kernel on
a CUDA tensor, its plain version on a CPU tensor, as the reference runs
its Pallas kernel on the TPU. ``_blocked_attention_impl`` is the
reference's pure blocked online-softmax path, which the reference runs
off the TPU; the port keeps it as a second plain version that the tests
hold against the reference. No caller of the port shifts the query block
(the reference's ``q_offset``), so neither function takes one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import NEG_INF, flash_attention
from .common import not_ported

__all__ = [
    "apply_norm",
    "apply_rope",
    "blocked_attention",
    "mlp",
    "rmsnorm",
    "rope_angles",
]


# ------------------------------------------------------------------ norms
def rmsnorm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dt)


def apply_norm(x, params, kind: str):
    if kind != "rmsnorm":
        raise not_ported(f"the {kind!r} norm")
    return rmsnorm(x, params["scale"])


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


# ------------------------------------------------------------------- MLPs
def mlp(x, params, activation: str):
    """GeGLU feed-forward. Weights: wi, wi_gate, wo."""
    if activation != "geglu":
        raise not_ported(f"the {activation!r} MLP")
    cdt = x.dtype
    h = F.gelu(x @ params["wi_gate"].to(cdt), approximate="tanh") \
        * (x @ params["wi"].to(cdt))
    return h @ params["wo"].to(cdt)


# ------------------------------------------------------------- attention
def blocked_attention(q, k, v, *, causal: bool, window: int = 0):
    """Online-softmax attention: (B, Sq, Hq, D) queries against
    (B, Sk, Hkv, D) keys and values -> (B, Sq, Hq, D), through K7 (the
    kernel on a CUDA tensor, its plain version on a CPU tensor)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window)


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

