"""The port's decoder LM: parameter templates, random init, embedding and
the layer stack (the dense part of the reference's ``models/lm.py``).

Parameters are a plain dict of tensors with the reference's tree: per
layer tensors stacked on a leading "layers" axis under ``"layers"``, the
embedding, the final norm, and ``"unembed"`` where embeddings are untied.
``init_params`` draws them as the reference does (normal, std 0.02 and
0.02 / sqrt(2 L) for output projections, norms at 1; ``param_dtype``),
from a ``torch.Generator`` on the target device. The forward loops over
the stacked layers; rematerialisation is a training concern and is not
ported, nor are MoE, SSM, hybrid, enc-dec, the LM head, the loss, prefill
or decode (ROADMAP A11).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .blocks import block_forward
from .common import ArchConfig, not_ported

__all__ = [
    "PSpec",
    "count_params",
    "embed_tokens",
    "init_params",
    "layer_template",
    "model_template",
]


class PSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    kind: str = "p"        # p = param dtype, f = float32
    init: str = "normal"   # normal | out | zeros | ones


# ------------------------------------------------------------- templates
def _norm_t(cfg) -> Dict[str, PSpec]:
    if cfg.norm != "rmsnorm":
        raise not_ported(f"the {cfg.norm!r} norm")
    return {"scale": PSpec((cfg.d_model,), ("embed",), "p", "ones")}


def _attn_t(cfg) -> Dict[str, PSpec]:
    d, hq, hkv, dh = (cfg.d_model, cfg.n_heads_padded, cfg.n_kv_heads,
                      cfg.head_dim_)
    return {
        "wq": PSpec((d, hq, dh), ("embed", "q_heads", "head_dim")),
        "wk": PSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": PSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": PSpec((hq, dh, d), ("q_heads", "head_dim", "embed"), "p",
                    "out"),
    }


def _mlp_t(cfg, d_ff: int) -> Dict[str, PSpec]:
    if cfg.activation != "geglu":
        raise not_ported(f"the {cfg.activation!r} MLP")
    d = cfg.d_model
    return {
        "wi": PSpec((d, d_ff), ("embed", "mlp")),
        "wo": PSpec((d_ff, d), ("mlp", "embed"), "p", "out"),
        "wi_gate": PSpec((d, d_ff), ("embed", "mlp")),
    }


def layer_template(cfg: ArchConfig):
    """Template for one dense layer (unstacked)."""
    if cfg.family != "dense" or cfg.is_moe:
        raise not_ported(f"the {cfg.family!r} layer")
    t: Dict[str, Any] = {"ln1": _norm_t(cfg), "attn": _attn_t(cfg)}
    if cfg.d_ff > 0:
        t["ln2"] = _norm_t(cfg)
        t["mlp"] = _mlp_t(cfg, cfg.d_ff)
    return t


def _stack(template, n: int):
    if isinstance(template, PSpec):
        return PSpec((n,) + template.shape, ("layers",) + template.axes,
                     template.kind, template.init)
    return {k: _stack(v, n) for k, v in template.items()}


def model_template(cfg: ArchConfig):
    if cfg.first_k_dense:
        raise not_ported("leading dense layers of a MoE model")
    d, v = cfg.d_model, cfg.vocab_size
    t: Dict[str, Any] = {
        "embed": PSpec((v, d), ("vocab", "embed")),
        "final_norm": _norm_t(cfg),
    }
    if not cfg.tie_embeddings:
        t["unembed"] = PSpec((d, v), ("embed", "vocab"), "p", "out")
    t["layers"] = _stack(layer_template(cfg), cfg.n_layers)
    return t


def _leaves(tree, path=()):
    """(path, leaf) pairs in sorted key order, as jax flattens dicts."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def count_params(cfg: ArchConfig) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(model_template(cfg)))


def init_params(cfg: ArchConfig, generator: torch.Generator, device=None):
    """Random parameters with the reference's shapes, dtypes and std,
    drawn from ``generator`` (which must live on ``device``)."""
    pdt = cfg.pdtype()
    out: Dict[str, Any] = {}
    for path, spec in _leaves(model_template(cfg)):
        dt = torch.float32 if spec.kind == "f" else pdt
        if spec.init == "zeros":
            t = torch.zeros(spec.shape, dtype=dt, device=device)
        elif spec.init == "ones":
            t = torch.ones(spec.shape, dtype=dt, device=device)
        else:
            std = 0.02
            if spec.init == "out":
                std = 0.02 / math.sqrt(2 * cfg.n_layers)
            t = torch.randn(spec.shape, generator=generator,
                            dtype=torch.float32, device=device)
            t = t.mul_(std).to(dt)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


# ----------------------------------------------------------------- embed
def embed_tokens(cfg, params, tokens):
    h = params["embed"][tokens].to(cfg.cdtype())
    if cfg.tie_embeddings:  # gemma-style scaled embedding
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                             device=h.device)
    return h


# -------------------------------------------------------------- the stack
def _layer(stack_params, i: int):
    if isinstance(stack_params, dict):
        return {k: _layer(v, i) for k, v in stack_params.items()}
    return stack_params[i]


def _apply_stack(cfg, stack_params, h, positions, *, window: int = 0):
    """The stacked layers in order."""
    for i in range(stack_params["ln1"]["scale"].shape[0]):
        h = block_forward(cfg, _layer(stack_params, i), h, positions,
                          window=window)
    return h
