"""AdamW with a cosine schedule, global-norm clipping and optional
block-quantized (int8) moments (a port of the reference's
``optim/adamw.py``).

The update is the reference's, not ``torch.optim.AdamW``'s (whose decay
and eps differ): clip the gradients by their global norm, bias-correct
both moments, ``upd = mu_hat / (sqrt(nu_hat) + eps) + wd * p`` and
``p - lr * upd``. States mirror the parameter tree leaf by leaf:
``{"step": int32 scalar, "moments": {<param path>: {"mu", "nu"}}}``, each
moment a float32 tensor of the parameter's shape or a ``QuantMoment``.

``apply_updates`` writes the parameters and the moments **in place**
under ``torch.no_grad()`` (the reference's train step donates both), so a
step holds one copy of each. The step count, the learning rate and the
global norm stay on the parameters' device: a step never waits for it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..tree import leaves, tree_map

__all__ = ["OptimConfig", "QuantMoment", "apply_updates", "global_norm",
           "init_state", "lr_at", "state_specs"]


@dataclass(frozen=True)
class OptimConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 200
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantized_moments: bool = False   # int8 moments (block=moment_block)
    moment_block: int = 128


class QuantMoment(NamedTuple):
    """int8 payload + per-block float32 scales (flat layout + pad)."""

    q: torch.Tensor       # (padded_size,) int8
    scale: torch.Tensor   # (padded_size / block,) float32


def lr_at(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32, on its device:
    linear warmup, then a cosine from ``peak_lr`` to
    ``min_lr_ratio * peak_lr`` at ``decay_steps``."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * torch.clamp(
        (step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


# ---------------------------------------------------------- quantization
def _quant(x: torch.Tensor, block: int) -> QuantMoment:
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)[:, None])
    return QuantMoment(q=q.to(torch.int8).reshape(-1), scale=scale)


def _dequant(qm: QuantMoment, shape, block: int) -> torch.Tensor:
    blocks = qm.q.reshape(-1, block).float()
    flat = (blocks * qm.scale[:, None]).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape)


# The second moment is non-negative with a huge dynamic range; quantizing
# sqrt(nu) (8-bit-Adam style) halves the log-range, so the int8 grid error
# lands on the Adam denominator roughly linearly instead of quadratically.
def _quant_nu(x: torch.Tensor, block: int) -> QuantMoment:
    return _quant(torch.sqrt(torch.clamp(x, min=0.0)), block)


def _dequant_nu(qm: QuantMoment, shape, block: int) -> torch.Tensor:
    r = _dequant(qm, shape, block)
    return r * r


# ------------------------------------------------------------- optimizer
def init_state(cfg: OptimConfig, params):
    """Zero moments on each parameter's device and a step count of 0."""

    def leaf(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.quantized_moments:
            return {"mu": _quant(z, cfg.moment_block),
                    "nu": _quant(z, cfg.moment_block)}
        return {"mu": z, "nu": torch.zeros_like(z)}

    dev = leaves(params, torch.is_tensor)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "moments": tree_map(leaf, params, torch.is_tensor)}


def state_specs(cfg: OptimConfig, param_specs_tree):
    """The optimizer state's shapes and dtypes, allocated nowhere (tensors
    on the ``meta`` device; the reference returns ShapeDtypeStructs)."""

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def leaf(p):
        if cfg.quantized_moments:
            size = math.prod(p.shape)
            padded = size + ((-size) % cfg.moment_block)
            qm = QuantMoment(q=meta((padded,), torch.int8),
                             scale=meta((padded // cfg.moment_block,),
                                        torch.float32))
            return {"mu": qm, "nu": qm}
        f = meta(tuple(p.shape), torch.float32)
        return {"mu": f, "nu": f}

    return {"step": meta((), torch.int32),
            "moments": tree_map(leaf, param_specs_tree, torch.is_tensor)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in the tree's order) of each leaf's
    sum of squares, in float32."""
    total = None
    for g in leaves(grads, torch.is_tensor):
        # the norm's own reduction, squared: no leaf-sized temporary
        s = torch.linalg.vector_norm(g, dtype=torch.float32).square()
        total = s if total is None else total + s
    return torch.sqrt(total)


def apply_updates(cfg: OptimConfig, params, grads, state):
    """One AdamW step, in place. ``grads`` mirrors ``params`` (float32
    gradients, consumed: they are scaled and reused as scratch). Returns
    (params, state, metrics) with the same tensors as were passed and
    metrics ``{"lr", "grad_norm"}`` as 0-d tensors."""
    with torch.profiler.record_function("adamw"), torch.no_grad():
        return _apply_updates_impl(cfg, params, grads, state)


def _apply_updates_impl(cfg: OptimConfig, params, grads, state):
    step = state["step"]
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = (step + 1).float()
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)
    blk = cfg.moment_block

    flat_p = leaves(params, torch.is_tensor)
    flat_g = leaves(grads, torch.is_tensor)
    flat_m = leaves(state["moments"], lambda x: isinstance(x, dict)
                    and set(x) == {"mu", "nu"})
    if not len(flat_p) == len(flat_g) == len(flat_m):
        raise ValueError(f"{len(flat_p)} parameters, {len(flat_g)} "
                         f"gradients, {len(flat_m)} moments")
    for p, g, m in zip(flat_p, flat_g, flat_m):
        if g.dtype != torch.float32:
            g = g.float()
        g.mul_(scale)
        if cfg.quantized_moments:
            mu = _dequant(m["mu"], p.shape, blk).mul_(b1).add_(g,
                                                                alpha=1 - b1)
            nu = _dequant_nu(m["nu"], p.shape, blk).mul_(b2).addcmul_(
                g, g, value=1 - b2)
            for name, new in (("mu", _quant(mu, blk)),
                              ("nu", _quant_nu(nu, blk))):
                m[name].q.copy_(new.q)
                m[name].scale.copy_(new.scale)
        else:
            mu = m["mu"].mul_(b1).add_(g, alpha=1 - b1)
            nu = m["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = torch.div(nu, bc2, out=g).sqrt_().add_(cfg.eps)
        upd = torch.div(mu, bc1).div_(denom)
        upd.add_(p.float(), alpha=cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(upd.mul_(lr))
        else:
            p.copy_(p.float().sub_(upd.mul_(lr)))
        del upd, denom, mu, nu
    step.add_(1)
    return params, state, {"lr": lr, "grad_norm": gnorm}
