"""Mamba2 / SSD (state-space duality) block of the port (the reference's
``models/ssm.py``), arXiv:2405.21060.

Training and prefill: chunked SSD. Within a chunk the recurrence is a
decay-masked quadratic form (matmuls); across chunks a short loop over
the chunks carries the float32 (H, P, N) state. Every einsum of the SSD
runs on float32 operands, as the reference's do (``preferred_element_type``
float32 on float32 inputs); the projections, the depthwise conv and the
gated norm run in the compute dtype.

Decode: one recurrent update a token, from ``SSMState`` (the last
``conv_width - 1`` pre-activation conv inputs and the float32 state).

Group count G = 1 (B and C shared across heads), as mamba2-1.3b has it.
The SSD is torch ops: the reference has no Pallas kernel for it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .layers import rmsnorm

__all__ = [
    "SSMState",
    "ssm_decode_step",
    "ssm_dims",
    "ssm_forward",
    "ssm_init_params",
    "ssm_init_state",
    "ssm_param_shapes",
]


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, conv_width-1, conv_dim)
    ssm: torch.Tensor    # (B, H, P, N) float32


def ssm_dims(cfg):
    H = cfg.ssm_heads_
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    d_inner = H * P
    conv_dim = d_inner + 2 * N            # x, B, C are convolved
    d_in_proj = 2 * d_inner + 2 * N + H   # z, xBC, dt
    return H, P, N, d_inner, conv_dim, d_in_proj


def _causal_depthwise_conv(x, w, b):
    """x (B, S, C), w (K, C), b (C,): causal depthwise conv along S."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + S, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _segsum(alpha):
    """alpha (..., Q) -> (..., Q, Q) with out[i, j] = sum_{j<t<=i} alpha_t,
    -inf above the diagonal."""
    Q = alpha.shape[-1]
    cs = torch.cumsum(alpha, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(Q, device=alpha.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, -math.inf)


def _split_proj(proj, d_inner, conv_dim):
    return (proj[..., :d_inner], proj[..., d_inner:d_inner + conv_dim],
            proj[..., d_inner + conv_dim:])


def ssm_forward(x, params, cfg, chunk: int = 128,
                return_state: bool = False):
    """Full-sequence SSD: (B, S, D) -> (B, S, D) [, final SSMState].

    ``return_state`` also returns the recurrent state after the last real
    token, so decode continues exactly where prefill stopped."""
    with torch.profiler.record_function("ssd"):
        return _ssm_forward_impl(x, params, cfg, chunk, return_state)


def _ssm_forward_impl(x, params, cfg, chunk=128, return_state=False):
    H, P, N, d_inner, conv_dim, _ = ssm_dims(cfg)
    B, S, D = x.shape
    cdt = x.dtype
    f32 = torch.float32

    proj = x @ params["in_proj"].to(cdt)
    z, xBC, dt_raw = _split_proj(proj, d_inner, conv_dim)

    xBC = F.silu(_causal_depthwise_conv(xBC, params["conv_w"].to(cdt),
                                        params["conv_b"].to(cdt)))
    xs = xBC[..., :d_inner]
    B_ = xBC[..., d_inner:d_inner + N].float()
    C_ = xBC[..., d_inner + N:].float()

    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())   # (B,S,H)
    A = -torch.exp(params["A_log"].float())                       # (H,)
    alpha = dt * A[None, None, :]                                 # (B,S,H)

    # ---- chunking ----
    Q = min(chunk, S)
    nc = -(-S // Q)
    Sp = nc * Q
    pad = (0, 0, 0, Sp - S)
    xs_c = F.pad(xs, pad).reshape(B, nc, Q, H, P)
    B_c = F.pad(B_, pad).reshape(B, nc, Q, N)
    C_c = F.pad(C_, pad).reshape(B, nc, Q, N)
    dt_c = F.pad(dt, pad).reshape(B, nc, Q, H)
    al_c = F.pad(alpha, pad).reshape(B, nc, Q, H)

    xdt = xs_c.float() * dt_c[..., None]        # dt-discretized input

    # intra-chunk (quadratic, decay-masked)
    L = torch.exp(_segsum(al_c.movedim(-1, 2)))                # (B,nc,H,Q,Q)
    scores = torch.einsum("bcin,bcjn->bcij", C_c, B_c)         # (B,nc,Q,Q)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores[:, :, None] * L,
                          xdt)

    # chunk states: decay from step j to the end of the chunk
    cum = torch.cumsum(al_c, dim=2)                            # (B,nc,Q,H)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # (B,nc,Q,H)
    states = torch.einsum("bcjn,bcjhp->bchpn", B_c,
                          decay_to_end[..., None] * xdt)       # (B,nc,H,P,N)

    # inter-chunk recurrence (sequential over nc); each chunk reads the
    # state before it
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (B,nc,H)
    h = torch.zeros((B, H, P, N), dtype=f32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_last = h
    h_prev = torch.stack(h_prev, dim=1)                        # (B,nc,H,P,N)

    y_off = torch.einsum("bcin,bchpn->bcihp", C_c, h_prev) \
        * torch.exp(cum)[..., None]

    y = (y_diag + y_off).reshape(B, Sp, H, P)[:, :S]
    y = y + xs.reshape(B, S, H, P).float() * params["D_skip"].float()[
        None, None, :, None]
    y = y.reshape(B, S, d_inner)

    # gated RMSNorm + out projection (mamba2's NormGated)
    y = y.to(cdt) * F.silu(z)
    y = rmsnorm(y, params["norm_scale"])
    out = y @ params["out_proj"].to(cdt)
    if not return_state:
        return out
    # conv tail: the last K-1 pre-activation conv inputs, zero-padded on
    # the left for sequences shorter than the window
    K = cfg.conv_width
    pre_conv = proj[..., d_inner:d_inner + conv_dim]
    tail = F.pad(pre_conv, (0, 0, K - 1, 0))[:, S:S + K - 1, :]
    # the pad steps carry xs = 0 but alpha < 0, so h_last is the state at
    # the last real token scaled by the pad's decay: undo it, as the
    # reference does
    if Sp - S:
        pad_alpha = al_c.reshape(B, Sp, H)[:, S:, :].sum(dim=1)  # (B,H)
        h_last = h_last / torch.exp(pad_alpha)[:, :, None, None]
    return out, SSMState(conv=tail.to(cdt), ssm=h_last)


def ssm_init_state(cfg, batch: int, dtype=torch.float32,
                   device=None) -> SSMState:
    H, P, N, d_inner, conv_dim, _ = ssm_dims(cfg)
    return SSMState(
        conv=torch.zeros((batch, cfg.conv_width - 1, conv_dim), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, H, P, N), dtype=torch.float32,
                        device=device),
    )


def ssm_decode_step(x, state: SSMState, params,
                    cfg) -> Tuple[torch.Tensor, SSMState]:
    """One-token recurrent update: x (B, 1, D) -> (B, 1, D) and the new
    state (new tensors; ``state`` is not written)."""
    H, P, N, d_inner, conv_dim, _ = ssm_dims(cfg)
    B = x.shape[0]
    cdt = x.dtype
    xt = x[:, 0, :]

    proj = xt @ params["in_proj"].to(cdt)
    z, xBC, dt_raw = _split_proj(proj, d_inner, conv_dim)

    window = torch.cat([state.conv.to(cdt), xBC[:, None, :]], dim=1)
    conv_out = (torch.einsum("bkc,kc->bc", window, params["conv_w"].to(cdt))
                + params["conv_b"].to(cdt)[None, :])
    new_conv = window[:, 1:, :]
    xBC = F.silu(conv_out)
    xs = xBC[..., :d_inner].reshape(B, H, P).float()
    B_ = xBC[..., d_inner:d_inner + N].float()
    C_ = xBC[..., d_inner + N:].float()

    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())   # (B,H)
    A = -torch.exp(params["A_log"].float())
    a = torch.exp(dt * A[None, :])                                # (B,H)

    xdt = xs * dt[..., None]                                      # (B,H,P)
    h = state.ssm * a[:, :, None, None] + xdt[..., None] * B_[:, None,
                                                              None, :]
    y = torch.einsum("bhpn,bn->bhp", h, C_)
    y = y + xs * params["D_skip"].float()[None, :, None]
    y = y.reshape(B, d_inner).to(cdt) * F.silu(z)
    y = rmsnorm(y, params["norm_scale"])
    out = (y @ params["out_proj"].to(cdt))[:, None, :]
    return out, SSMState(conv=new_conv.to(state.conv.dtype), ssm=h)


def ssm_init_params(cfg, generator: torch.Generator, dtype, device=None):
    """One SSM layer's parameters (the reference's ``ssm_init_params``),
    drawn from ``generator`` (which must live on ``device``)."""
    H, P, N, d_inner, conv_dim, d_in_proj = ssm_dims(cfg)
    D = cfg.d_model
    kw = dict(generator=generator, dtype=torch.float32, device=device)
    std = D ** -0.5
    dt_min, dt_max = 1e-3, 1e-1
    u = torch.rand((H,), **kw) * (math.log(dt_max) - math.log(dt_min)) \
        + math.log(dt_min)
    dt_init = torch.exp(u)
    # inverse softplus so softplus(dt_bias) ~= dt_init
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    conv_w = torch.randn((cfg.conv_width, conv_dim), **kw)
    return {
        "in_proj": (torch.randn((D, d_in_proj), **kw) * std).to(dtype),
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "dt_bias": dt_bias,
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)),
        "D_skip": torch.ones((H,), dtype=torch.float32, device=device),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": (torch.randn((d_inner, D), **kw)
                     * d_inner ** -0.5).to(dtype),
    }


def ssm_param_shapes(cfg):
    """(shape, logical_axes, dtype_kind) per parameter; dtype_kind 'p' =
    the param dtype, 'f' = float32 (small numerically sensitive vectors)."""
    H, P, N, d_inner, conv_dim, d_in_proj = ssm_dims(cfg)
    D = cfg.d_model
    return {
        "in_proj": ((D, d_in_proj), ("embed", "ssm_inner"), "p"),
        "conv_w": ((cfg.conv_width, conv_dim), ("conv_width", "ssm_inner"),
                   "p"),
        "conv_b": ((conv_dim,), ("ssm_inner",), "p"),
        "dt_bias": ((H,), ("ssm_heads",), "f"),
        "A_log": ((H,), ("ssm_heads",), "f"),
        "D_skip": ((H,), ("ssm_heads",), "f"),
        "norm_scale": ((d_inner,), ("ssm_inner",), "p"),
        "out_proj": ((d_inner, D), ("ssm_inner", "embed"), "p"),
    }
