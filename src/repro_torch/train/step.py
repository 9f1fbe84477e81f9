"""Train and serve step construction of the port (the reference's
``train/step.py`` for one device, ``mesh=None``).

``make_train_step``: the family's loss (``Model.loss``; a batch carries
``tokens`` and, for the enc-dec family, ``enc_frames``, for the vlm
``vision_embeds``, which the loss places on the step's device) ->
gradients (``torch.autograd.grad`` over the parameter leaves; with ``microbatches > 1`` the microbatch gradients are
summed in order and scaled by 1/nm, as the reference's ``lax.scan`` does)
-> AdamW. The step updates the parameters and the optimizer state in
place (the reference donates both) and returns them with its metrics as
0-d tensors on the device, so it never waits for the card.

``make_serve_step``: one decode token against a KV cache, over the
port's ``decode_step``.

A mesh, the int8-compressed data-parallel step and the dry-run lowering
need several cards or XLA and are not ported (ROADMAP A11).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.ops import resolve_device
from ..models import Model
from ..models.common import ArchConfig, not_ported
from ..optim import OptimConfig, apply_updates, init_state, state_specs
from ..tree import leaves, unflatten

__all__ = ["TrainConfig", "make_dp_compressed_train_step", "make_serve_step",
           "make_train_step"]


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1            # gradient-accumulation steps
    grad_compression: str = "none"   # none | int8 (error-feedback DP mean)
    compression_block: int = 256


def _grads(model: Model, params, batch, dev):
    """(gradients mirroring ``params``, metrics) of one batch. The
    parameter leaves require grad only while the loss is taken."""
    flat = leaves(params, torch.is_tensor)
    for p in flat:
        p.requires_grad_(True)
    try:
        loss, metrics = model.loss(params, batch, device=dev)
        grads = torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return unflatten(params, list(grads), torch.is_tensor), metrics


def make_train_step(cfg: ArchConfig, ocfg: OptimConfig,
                    tcfg: TrainConfig = TrainConfig(), mesh=None, *,
                    device=None):
    """Build the train step for one architecture on ``device`` (None: the
    CUDA device, which raises without one).

    Returns a dict with:
      step:         (params, opt_state, batch) -> (params, opt_state,
                    metrics), in place
      param_specs:  the parameters' shapes and dtypes (meta tensors)
      opt_specs:    the optimizer state's (meta tensors)
      init:         (seed or torch.Generator) -> (params, opt_state)
    """
    if mesh is not None:
        raise not_ported("the train step over a mesh")
    if tcfg.grad_compression != "none":
        raise not_ported(f"grad_compression={tcfg.grad_compression!r} (the "
                         "compressed data-parallel mean over several cards)")
    dev = resolve_device(device)
    model = Model(cfg)

    def compute_grads(params, batch):
        nm = tcfg.microbatches
        if nm <= 1:
            return _grads(model, params, batch, dev)
        b = len(batch["tokens"])
        if b % nm:
            raise ValueError(f"batch of {b} rows in {nm} microbatches")
        acc, metrics = None, None
        for i in range(nm):
            mb = {k: v[i * (b // nm):(i + 1) * (b // nm)]
                  for k, v in batch.items()}
            grads, metrics = _grads(model, params, mb, dev)
            g = leaves(grads, torch.is_tensor)
            if acc is None:
                acc = [x.float() for x in g]
            else:
                torch._foreach_add_(acc, g)
            del grads, g
        torch._foreach_mul_(acc, 1.0 / nm)
        return unflatten(params, acc, torch.is_tensor), metrics

    def train_step(params, opt_state, batch):
        grads, metrics = compute_grads(params, batch)
        params, opt_state, om = apply_updates(ocfg, params, grads, opt_state)
        metrics = dict(metrics)
        metrics.update(om)
        return params, opt_state, metrics

    def init(seed):
        params = model.init_params(seed, device=dev)
        return params, init_state(ocfg, params)

    return {
        "step": train_step,
        "param_specs": model.param_specs(),
        "opt_specs": state_specs(ocfg, model.param_specs()),
        "init": init,
    }


def make_serve_step(cfg: ArchConfig, mesh=None, *, device=None):
    """The single-token decode step on ``device`` (None: the CUDA device).

    Returns a dict with:
      step:         (params, cache, tokens, pos) -> (logits, cache), the
                    cache written in place
      param_specs:  the parameters' shapes and dtypes (meta tensors)
    """
    if mesh is not None:
        raise not_ported("the serve step over a mesh")
    dev = resolve_device(device)
    model = Model(cfg)

    def serve_step(params, cache, tokens, pos):
        with torch.no_grad():
            return model.decode_step(params, cache, tokens, pos, device=dev)

    return {"step": serve_step, "param_specs": model.param_specs()}


def make_dp_compressed_train_step(cfg: ArchConfig, ocfg: OptimConfig, mesh,
                                  block: int = 256):
    """The data-parallel step with the int8 error-feedback all-reduce over
    several cards: not ported."""
    raise not_ported("the compressed data-parallel train step")
