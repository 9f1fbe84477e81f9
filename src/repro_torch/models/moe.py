"""Mixture-of-Experts block of the port (the reference's ``models/moe.py``):
top-k routing with sort-based static-capacity dispatch.

Routing runs in float32: softmax over the experts, the top ``top_k``
gates renormalised to sum to 1. The (token, expert) assignments are
sorted by expert with a stable sort, so within an expert they keep token
order; an assignment's rank within its expert decides whether it fits the
expert's capacity C, and those past it are dropped (the sentinel row
E * C). The kept assignments are gathered into an (E, C, D) buffer, the
experts run as batched products over their stacked weights, and each
token sums its ``top_k`` gated expert rows.

The reference combines with a scatter-add of the buffer rows into the
tokens. The port gathers each token's ``top_k`` rows instead and adds
them in order, in the compute dtype: every token has exactly ``top_k``
assignments (a dropped one counts with a zero gate), so this is the same
sum, and it is the same on every run, where a scatter-add on the
card adds in the order its atomics land.

The aux terms follow Switch-Transformer: the load-balance loss
E · Σ_e f_e · P_e, the router z-loss mean(logsumexp(logits)²), and the
fraction of assignments dropped. The reference computes all of this in
XLA, outside any Pallas kernel; so does the port, in torch ops.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

__all__ = ["expert_capacity", "moe_block", "route", "slots"]


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    factor: float, multiple: int = 512) -> int:
    """Static per-expert capacity, rounded up to ``multiple`` and capped at
    ``n_tokens`` (an expert can never receive more than every token)."""
    c = max(1, math.ceil(n_tokens * top_k * factor / n_experts))
    c = ((c + multiple - 1) // multiple) * multiple
    return min(c, n_tokens)


def _act(activation: str):
    if activation == "swiglu":
        return F.silu
    return lambda v: F.gelu(v, approximate="tanh")


def route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """Float32 routing of (T, D) tokens: (logits (T, E), probs (T, E),
    gate (T, k) renormalised to sum to 1, expert_idx (T, k))."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = torch.topk(probs, top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    return logits, probs, gate, expert_idx


def slots(expert_idx: torch.Tensor, n_experts: int, capacity: int):
    """Each (token, choice) assignment's row of the (E * C) buffer, in
    token-major order, and whether it fits: assignments sorted by expert
    with a stable sort (token order within an expert), ranked within
    their expert, those ranked C or later dropped to the sentinel E * C.
    Returns (dest (T * k,) int64, keep (T * k,) bool)."""
    E, C = n_experts, capacity
    flat_expert = expert_idx.reshape(-1)
    order = torch.sort(flat_expert, stable=True).indices
    sorted_expert = flat_expert[order]
    seg_start = torch.searchsorted(sorted_expert, sorted_expert)
    within = torch.arange(flat_expert.numel(),
                          device=flat_expert.device) - seg_start
    dest_sorted = torch.where(within < C, sorted_expert * C + within, E * C)
    dest = torch.empty_like(dest_sorted).scatter_(0, order, dest_sorted)
    return dest, dest < E * C


def moe_block(x: torch.Tensor, params, *, top_k: int,
              capacity_factor: float, activation: str = "swiglu"
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (T, D) tokens in the compute dtype; ``params``: ``router`` (D, E)
    float32, ``w_up`` (and ``w_gate`` for the gated activations) (E, D, F),
    ``w_down`` (E, F, D). Returns (out (T, D), aux)."""
    T, D = x.shape
    E = params["router"].shape[1]
    C = expert_capacity(T, E, top_k, capacity_factor)
    dev, cdt = x.device, x.dtype
    logits, probs, gate, expert_idx = route(x, params["router"], top_k)
    dest, keep = slots(expert_idx, E, C)

    # dispatch: the buffer row -> token map, then one gather
    row_token = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    row_token[dest] = torch.arange(T, device=dev).repeat_interleave(top_k)
    row_token = row_token[:E * C]
    row_valid = (row_token < T)[:, None].to(cdt)
    buf = (x[torch.clamp(row_token, max=T - 1)] * row_valid).reshape(E, C, D)

    # the experts, batched over E
    if activation in ("swiglu", "geglu"):
        h = _act(activation)(torch.bmm(buf, params["w_gate"].to(cdt))) \
            * torch.bmm(buf, params["w_up"].to(cdt))
    else:
        h = F.gelu(torch.bmm(buf, params["w_up"].to(cdt)),
                   approximate="tanh")
    out_buf = torch.bmm(h, params["w_down"].to(cdt)).reshape(E * C, D)

    # combine: each token's top_k rows (a dropped one with a zero gate)
    w = (gate.reshape(-1) * keep).to(cdt)                         # (T*k,)
    rows = out_buf[torch.clamp(dest, max=E * C - 1)] * w[:, None]
    rows = rows.reshape(T, top_k, D)
    out = rows[:, 0]
    for j in range(1, top_k):
        out = out + rows[:, j]

    # each expert's assignment count (bincount's, as a scatter-add of
    # int64 ones, which also runs on the meta device)
    flat_idx = expert_idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_idx, torch.ones_like(flat_idx))
    frac_tokens = counts.float() / (T * top_k)
    aux = {
        "load_balance_loss": E * torch.sum(frac_tokens * probs.mean(dim=0)),
        "router_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "dropped_fraction": 1.0 - keep.float().mean(),
    }
    return out, aux
