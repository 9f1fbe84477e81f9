"""Angular Quantization-based Binary Codes (Gong et al., NIPS 2012), in
torch (a port of the reference's ``core/aqbc.py``).

Learn an orthogonal projection ``R`` (d x c, RᵀR = I) so that the binary
vertex ``b(x) = argmax_b <b, Rᵀx> / ||b||₂`` preserves angles. Inputs are
assumed non-negative and are L2-normalized internally.

Encoding is exact: for v = Rᵀx, sort v descending (stable, so equal
values keep their index order) and pick the prefix length t maximizing
``prefix_sum(t) / sqrt(t)`` (the first best); the code has ones at the
top-t coordinates. Learning alternates a B-step (encode with the current
R) and an R-step (orthogonal Procrustes, R = U Vᵀ from
svd(X̂ᵀ B̃) with B̃ the unit-normalized codes). The SVD is
``torch.linalg.svd``. Everything runs on the tensors' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["AQBCModel", "encode", "encode_projected", "learn"]


class AQBCModel(NamedTuple):
    rotation: torch.Tensor         # (d, c) with orthonormal columns
    objective_trace: torch.Tensor  # (iters,) objective per iteration


def _normalize_rows(x, eps: float = 1e-12):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=eps)


def encode_projected(v):
    """Exact argmax_b <b,v>/||b|| for each row of v: (n, c) -> (n, c)
    uint8."""
    c = v.shape[-1]
    order = torch.argsort(-v, dim=-1, stable=True)        # descending
    v_sorted = torch.gather(v, -1, order)
    prefix = torch.cumsum(v_sorted, dim=-1)
    scores = prefix / torch.sqrt(
        torch.arange(1, c + 1, dtype=v.dtype, device=v.device))
    t_star = torch.argmax(scores, dim=-1)                 # first best
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(c, device=v.device)
                   .expand_as(order).contiguous())
    return (ranks <= t_star[:, None]).to(torch.uint8)


def encode(x, rotation):
    """Binarize raw vectors: (n, d) x (d, c) -> (n, c) uint8 codes."""
    v = _normalize_rows(x.float()) @ rotation
    return encode_projected(v)


def _objective(x_hat, rotation, bits):
    b_tilde = _normalize_rows(bits.float())
    return torch.mean(torch.sum((x_hat @ rotation) * b_tilde, dim=-1))


def learn(x, code_bits: int, iters: int = 25, *,
          init_rotation=None) -> AQBCModel:
    """Learn the AQBC rotation on a (n, d) training set; c = code_bits <= d.

    ``x`` is a tensor, used on its own device. The initial rotation is
    ``init_rotation`` (a (d, c) tensor) where given, else the Q factor of
    a (d, c) standard normal drawn from a ``torch.Generator`` seeded
    with 0."""
    x = x.float()
    n, d = x.shape
    c = code_bits
    if c > d:
        raise ValueError(f"code_bits={c} must be <= data dim {d}")
    x_hat = _normalize_rows(x)
    if init_rotation is None:
        gen = torch.Generator(device=x.device).manual_seed(0)
        g = torch.randn((d, c), generator=gen, dtype=torch.float32,
                        device=x.device)
        rotation, _ = torch.linalg.qr(g)
    else:
        rotation = init_rotation.float().to(x.device)
    trace = []
    for _ in range(iters):
        bits = encode_projected(x_hat @ rotation)
        b_tilde = _normalize_rows(bits.float())
        u, _, vt = torch.linalg.svd(x_hat.T @ b_tilde, full_matrices=False)
        rotation = u @ vt
        trace.append(_objective(x_hat, rotation,
                                encode_projected(x_hat @ rotation)))
    objective = (torch.stack(trace) if trace
                 else torch.zeros(0, device=x.device))
    return AQBCModel(rotation=rotation, objective_trace=objective)
