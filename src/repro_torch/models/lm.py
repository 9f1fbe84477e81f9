"""The port's decoder LM, the dense, MoE, SSM, hybrid and vlm families (the
reference's ``models/lm.py``): parameter templates (the enc-dec family's
too, whose forward lives in ``encdec.py``), random init, embedding, the
layer stack, the LM head, the scoring forward, the loss, the decode
cache, prefill and the decode step.

Parameters are a plain dict of tensors with the reference's tree: per
layer tensors stacked on a leading "layers" axis under ``"layers"`` (and
a MoE model's ``first_k_dense`` leading dense layers under
``"front_layers"``), the embedding, the final norm, ``"unembed"`` where
embeddings are untied, and the vlm's (d, d) ``"vision_adapter"``.
``init_params`` draws them as the reference does (normal, std 0.02 and
0.02 / sqrt(2 L) for output projections, norms at 1, biases at 0, the
SSM's ``A_log``, ``dt_bias`` and ``D_skip`` fixed; ``param_dtype``),
from a ``torch.Generator`` on the target device (a leaf stored in
another dtype than float32 is drawn in float32 slices of at most
``_DRAW_SLICE`` elements, straight into its tensor, so arctic's 8.9 G
element expert stack needs no float32 copy); ``param_specs`` gives their
shapes and dtypes on the ``meta`` device.

The stack splits each stacked leaf once a forward (``unbind``), so under
autograd each leaf's gradient comes back as one stack, not as a full-size
zero gradient per layer. Under autograd each layer is rematerialised as
``cfg.remat`` says (the reference's ``_remat_policy``, with
``torch.utils.checkpoint``): ``"full"`` recomputes the whole layer in the
backward, K7 included, ``"dots"`` keeps the matmul outputs, ``"none"``
keeps everything. ``loss_fn`` is next-token cross-entropy plus a 1e-4
z-loss, over the full float32 logits or, with ``cfg.ce_chunk``, over
checkpointed chunks of ``ce_chunk`` tokens, plus for MoE the layers' mean
load-balance loss (x 0.01) and router z-loss (x 1e-3); as in the
reference, the leading dense layers add no aux terms. The hybrid family's
attention runs with ``cfg.sliding_window``.

The vlm family is the dense decoder behind stubbed patch embeddings: a
batch carries ``"vision_embeds"`` (B, vision_tokens, d) beside its
tokens; ``forward_hidden`` and ``prefill`` cast them to the compute
dtype, multiply them by ``vision_adapter`` and put them in front of the
embedded text. ``forward_hidden`` strips those positions after the final
norm, so the logits and the loss cover text positions only; prefill's
cache holds vision_tokens + T positions, and decoding goes on at pos =
vision_tokens + T.

The decode cache is ``{"layers": LayerCache(attn=AttnCache(k, v),
ssm=None)}`` with k and v laid out (layers, batch, kv_len, kv_heads,
head_dim) in the compute dtype, as the reference's; the SSM family's is
``LayerCache(attn=None, ssm=SSMState(conv, ssm))``, conv (layers, batch,
conv_width - 1, conv_dim) in the compute dtype and ssm (layers, batch, H,
P, N) in float32; the hybrid's has both halves, its k and v a ring
buffer of kv_len = min(max_seq, sliding_window) slots; a MoE model with
leading dense layers has a second ``"front_layers"`` KV cache.
``decode_step`` writes its token's k and v, or each layer's new SSM
state, into that cache in place (the reference's serving engine donates
it) and returns it. ``prefill``, ``forward``, ``loss_fn``,
``init_cache`` and ``decode_step`` run on ``device`` (None: the CUDA
device; it raises without one) and refuse parameters that lie elsewhere.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ..kernels.ops import resolve_device
from ..tree import leaves_with_path, tree_map, unflatten
from . import ssm as ssm_lib
from .blocks import AttnCache, LayerCache, block_decode, block_forward
from .common import ArchConfig, check_family
from .layers import apply_norm

__all__ = [
    "PSpec",
    "attention_window",
    "cache_template",
    "count_params",
    "decode_step",
    "embed_tokens",
    "forward",
    "forward_hidden",
    "init_cache",
    "init_params",
    "layer_template",
    "lm_head",
    "loss_fn",
    "model_template",
    "param_specs",
    "prefill",
]


class PSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    kind: str = "p"        # p = param dtype, f = float32
    init: str = "normal"   # normal | out | zeros | ones | ssm_special


# a leaf stored in another dtype than float32 is drawn in float32 slices
# of at most this many elements (1 GiB)
_DRAW_SLICE = 1 << 28


# ------------------------------------------------------------- templates
def _norm_t(cfg) -> Dict[str, PSpec]:
    d = cfg.d_model
    t = {"scale": PSpec((d,), ("embed",), "p", "ones")}
    if cfg.norm == "layernorm":
        t["bias"] = PSpec((d,), ("embed",), "p", "zeros")
    return t


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
    d = cfg.d_model
    t = {
        "wi": PSpec((d, d_ff), ("embed", "mlp")),
        "wo": PSpec((d_ff, d), ("mlp", "embed"), "p", "out"),
    }
    if cfg.activation in ("swiglu", "geglu"):
        t["wi_gate"] = PSpec((d, d_ff), ("embed", "mlp"))
    return t


def _moe_t(cfg) -> Dict[str, PSpec]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    t = {
        "router": PSpec((d, e), ("embed", "experts"), "f"),
        "w_up": PSpec((e, d, f), ("experts", "embed", "mlp")),
        "w_down": PSpec((e, f, d), ("experts", "mlp", "embed"), "p", "out"),
    }
    if cfg.activation in ("swiglu", "geglu"):
        t["w_gate"] = PSpec((e, d, f), ("experts", "embed", "mlp"))
    return t


def _ssm_t(cfg) -> Dict[str, PSpec]:
    out = {}
    for name, (shape, axes, kind) in ssm_lib.ssm_param_shapes(cfg).items():
        init = "ssm_special" if name in ("A_log", "dt_bias", "D_skip") else (
            "out" if name == "out_proj" else
            "ones" if name == "norm_scale" else
            "zeros" if name == "conv_b" else "normal"
        )
        out[name] = PSpec(shape, axes, kind, init)
    return out


def layer_template(cfg: ArchConfig, moe: bool = True,
                   cross_attn: bool = False):
    """Template for one layer (unstacked). A MoE config's layer carries
    the MoE block where ``moe`` (else the dense MLP); ``cross_attn`` adds
    the decoder's cross-attention (``lnx``, ``xattn``) of the enc-dec
    family."""
    check_family(cfg)
    t: Dict[str, Any] = {"ln1": _norm_t(cfg)}
    if cfg.has_attention:
        t["attn"] = _attn_t(cfg)
    if cfg.has_ssm:
        t["ssm"] = _ssm_t(cfg)
    if cfg.family == "hybrid":
        d = cfg.d_model
        t["fuse_attn"] = PSpec((d,), ("embed",), "p", "ones")
        t["fuse_ssm"] = PSpec((d,), ("embed",), "p", "ones")
    if cross_attn:
        t["lnx"] = _norm_t(cfg)
        t["xattn"] = _attn_t(cfg)
    if moe and cfg.is_moe:
        t["ln2"] = _norm_t(cfg)
        t["moe"] = _moe_t(cfg)
        if cfg.moe_dense_residual_ff:
            t["moe_dense"] = _mlp_t(cfg, cfg.moe_dense_residual_ff)
    elif cfg.d_ff > 0:
        t["ln2"] = _norm_t(cfg)
        t["mlp"] = _mlp_t(cfg, cfg.d_ff)
    return t


def _stack(template, n: int):
    if isinstance(template, PSpec):
        return PSpec((n,) + template.shape, ("layers",) + template.axes,
                     template.kind, template.init)
    return {k: _stack(v, n) for k, v in template.items()}


def _dense(cfg: ArchConfig) -> ArchConfig:
    """The config of a MoE model's leading dense layers."""
    return cfg.replace(n_experts=0)


def model_template(cfg: ArchConfig):
    d, v = cfg.d_model, cfg.vocab_size
    t: Dict[str, Any] = {
        "embed": PSpec((v, d), ("vocab", "embed")),
        "final_norm": _norm_t(cfg),
    }
    if not cfg.tie_embeddings:
        t["unembed"] = PSpec((d, v), ("embed", "vocab"), "p", "out")
    if cfg.family == "encdec":
        # the decoder's layers carry cross-attention; the encoder's do not
        t["layers"] = _stack(layer_template(cfg, cross_attn=True),
                             cfg.n_layers)
        t["enc_layers"] = _stack(layer_template(cfg, moe=False),
                                 cfg.n_encoder_layers)
        t["enc_norm"] = _norm_t(cfg)
        return t
    if cfg.first_k_dense:
        t["front_layers"] = _stack(layer_template(_dense(cfg), moe=False),
                                   cfg.first_k_dense)
    t["layers"] = _stack(layer_template(cfg),
                         cfg.n_layers - cfg.first_k_dense)
    if cfg.family == "vlm":
        t["vision_adapter"] = PSpec((d, d), ("embed", None))
    return t


def _is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """All parameters, or (``active_only``) those one token runs through:
    of a MoE model's routed experts only ``experts_per_token`` of
    ``n_experts``."""
    total = 0
    for path, spec in leaves_with_path(model_template(cfg), _is_pspec):
        n = math.prod(spec.shape)
        if active_only and cfg.is_moe and path[-1] in ("w_up", "w_down",
                                                       "w_gate"):
            n = n * cfg.experts_per_token // cfg.n_experts
        total += n
    return total


def param_specs(cfg: ArchConfig):
    """The parameters' shapes and dtypes, allocated nowhere (tensors on
    the ``meta`` device; the reference returns ShapeDtypeStructs)."""
    pdt = cfg.pdtype()
    return tree_map(
        lambda s: torch.empty(s.shape, device="meta",
                              dtype=torch.float32 if s.kind == "f" else pdt),
        model_template(cfg), _is_pspec)


def init_params(cfg: ArchConfig, generator: torch.Generator, device=None):
    """Random parameters with the reference's shapes, dtypes and std,
    drawn from ``generator`` (which must live on ``device``)."""
    pdt = cfg.pdtype()
    out: Dict[str, Any] = {}
    for path, spec in leaves_with_path(model_template(cfg), _is_pspec):
        dt = torch.float32 if spec.kind == "f" else pdt
        if spec.init == "zeros":
            t = torch.zeros(spec.shape, dtype=dt, device=device)
        elif spec.init == "ones":
            t = torch.ones(spec.shape, dtype=dt, device=device)
        elif spec.init == "ssm_special":
            t = _ssm_special(path[-1], spec.shape, dt, device)
        else:
            std = 0.02
            if spec.init == "out":
                std = 0.02 / math.sqrt(2 * cfg.n_layers)
            t = _normal(spec.shape, std, dt, generator, device)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def _normal(shape, std: float, dt, generator, device):
    """Normal(0, std) draws in float32, stored as ``dt``: one draw for a
    float32 leaf or a small one, else slices of ``_DRAW_SLICE`` elements
    drawn one after another into the ``dt`` tensor."""
    n = math.prod(shape)
    if dt == torch.float32 or n <= _DRAW_SLICE:
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return t.mul_(std).to(dt)
    t = torch.empty(shape, dtype=dt, device=device)
    flat = t.view(-1)
    for lo in range(0, n, _DRAW_SLICE):
        hi = min(n, lo + _DRAW_SLICE)
        flat[lo:hi].copy_(torch.randn(hi - lo, generator=generator,
                                      dtype=torch.float32,
                                      device=device).mul_(std))
    return t


def _ssm_special(name: str, shape, dt, device):
    """The SSM's fixed per-head vectors, broadcast over the layers:
    A_log = log(linspace(1, 16, H)), dt_bias = the inverse softplus of
    dt0 = exp(linspace(log 1e-3, log 1e-1, H)), D_skip = 1."""
    h = shape[-1]
    if name == "A_log":
        base = torch.log(torch.linspace(1.0, 16.0, h, device=device))
    elif name == "dt_bias":
        dt0 = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), h,
                                       device=device))
        base = dt0 + torch.log(-torch.expm1(-dt0))
    else:  # D_skip
        base = torch.ones(h, device=device)
    return base.expand(shape).to(dt).contiguous()


# ----------------------------------------------------------------- embed
def embed_tokens(cfg, params, tokens):
    h = params["embed"][tokens].to(cfg.cdtype())
    if cfg.tie_embeddings:  # gemma-style scaled embedding
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                             device=h.device)
    return h


def lm_head(cfg, params, h):
    """(B, S, d) hidden states -> (B, S, V) float32 logits. The weights are
    cast to the compute dtype on every call, as the reference does."""
    if cfg.tie_embeddings:
        w = params["embed"].to(cfg.cdtype()).T
    else:
        w = params["unembed"].to(cfg.cdtype())
    return (h @ w).float()


# -------------------------------------------------------------- the stack
def _layer(stack_params, i: int):
    if isinstance(stack_params, dict):
        return {k: _layer(v, i) for k, v in stack_params.items()}
    return stack_params[i]


def _n_layers(stack_params) -> int:
    return stack_params["ln1"]["scale"].shape[0]


def _split_layers(stack_params):
    """Per-layer dicts of views into the stacked leaves, each leaf split
    once (``unbind``, whose backward is one stack). Indexing each leaf per
    layer instead would give every layer's backward a full-size zero
    gradient of the stacked leaf to fill and add."""
    stacked = [leaf.unbind(0) for _, leaf in leaves_with_path(stack_params)]
    return [unflatten(stack_params, [col[i] for col in stacked])
            for i in range(_n_layers(stack_params))]


# the matmul outputs that remat "dots" keeps (the reference's
# dots_with_no_batch_dims_saveable, as torch's einsum and matmul lower)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(cfg):
    """The ``context_fn`` of the per-layer checkpoint for ``cfg.remat``, or
    None where nothing is rematerialised (the reference's
    ``_remat_policy``)."""
    if cfg.remat == "none":
        return None
    if cfg.remat == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
    if cfg.remat == "full":
        return noop_context_fn
    raise ValueError(f"unknown remat {cfg.remat!r}")


def _layer_out(cfg, lp, h, positions, window, moe):
    return block_forward(cfg, lp, h, positions, window=window,
                         moe_layer=moe)[:2]


def _apply_stack(cfg, stack_params, h, positions, *, window: int = 0,
                 moe: bool = True):
    """The stacked layers in order; where autograd records them, each is
    rematerialised as ``cfg.remat`` says. Returns (h, aux summed over the
    layers)."""
    recorded = torch.is_grad_enabled() and (h.requires_grad or any(
        t.requires_grad for _, t in leaves_with_path(stack_params)))
    context_fn = _remat_context(cfg) if recorded else None
    aux = {}
    for lp in _split_layers(stack_params):
        if context_fn is None:
            h, a = _layer_out(cfg, lp, h, positions, window, moe)
        else:
            h, a = checkpoint(_layer_out, cfg, lp, h, positions, window, moe,
                              use_reentrant=False, context_fn=context_fn,
                              preserve_rng_state=False)
        aux = {k: aux[k] + v if k in aux else v for k, v in a.items()}
    return h, aux


def attention_window(cfg) -> int:
    """The sliding window of the family's attention (the hybrid's), else
    0."""
    return cfg.sliding_window if cfg.family == "hybrid" else 0


def _placed(params, tokens, device):
    """The run's device and the tokens on it as int64 (the embedding's
    index type); parameters on another device are refused, not moved."""
    dev = resolve_device(device)
    if params["embed"].device != dev:
        raise ValueError(f"parameters lie on {params['embed'].device}, the "
                         f"run on {dev}: place them there first")
    if isinstance(tokens, torch.Tensor):
        return dev, tokens.to(dev, torch.int64)
    return dev, torch.from_numpy(np.asarray(tokens, np.int64)).to(dev)


def _placed_input(batch, name: str, dev):
    """The batch's float input ``name`` (the vlm's ``vision_embeds``, the
    enc-dec family's ``enc_frames``) as a tensor on ``dev``."""
    x = batch[name]
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(np.asarray(x, np.float32)).to(dev)


def _embed_inputs(cfg, params, batch, tokens, dev):
    """The embedded tokens; for the vlm, behind the patch embeddings
    through ``vision_adapter`` (a product in the compute dtype). Returns
    (h (B, S, d), the number of vision positions in front)."""
    h = embed_tokens(cfg, params, tokens)
    if cfg.family != "vlm":
        return h, 0
    vis = _placed_input(batch, "vision_embeds", dev).to(h.dtype) \
        @ params["vision_adapter"].to(h.dtype)
    return torch.cat([vis, h], dim=1), vis.shape[1]


def forward_hidden(cfg: ArchConfig, params, batch, *, device=None):
    """Forward up to and including the final norm: (h (B, S, d), aux);
    the vlm's vision positions are stripped, so S counts text only."""
    dev, tokens = _placed(params, batch["tokens"], device)
    h, n_vis = _embed_inputs(cfg, params, batch, tokens, dev)
    positions = torch.arange(h.shape[1], device=dev)
    window = attention_window(cfg)
    if cfg.first_k_dense:
        # the reference drops the leading dense layers' aux (there is none)
        h, _ = _apply_stack(_dense(cfg), params["front_layers"], h,
                            positions, window=window, moe=False)
    h, aux = _apply_stack(cfg, params["layers"], h, positions, window=window)
    h = apply_norm(h, params["final_norm"], cfg.norm)
    return h[:, n_vis:], aux


def forward(cfg: ArchConfig, params, batch, *, device=None):
    """Scoring forward (causal, K7): (logits (B, S, V) float32, aux)."""
    h, aux = forward_hidden(cfg, params, batch, device=device)
    return lm_head(cfg, params, h), aux


# ------------------------------------------------------------------ loss
def _unembed_weights(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"].to(cfg.cdtype()).T
    return params["unembed"].to(cfg.cdtype())


def _ce_chunk(h_i, y_i, w):
    lg = (h_i @ w).float()                   # (Tc, V): the only copy
    lz = torch.logsumexp(lg, dim=-1)
    ll = lg.gather(-1, torch.clamp(y_i, min=0)[:, None])[:, 0]
    m = (y_i >= 0).float()
    return ((lz - ll) * m).sum(), ((lz ** 2) * m).sum(), m.sum()


def _chunked_ce(cfg, params, h, targets):
    """Blocked cross-entropy (+z-loss): the (tokens, vocab) logits exist
    only at (ce_chunk, vocab), and under autograd each chunk is
    recomputed in the backward. Returns (ce_sum, z_sum, count)."""
    B, S, d = h.shape
    w = _unembed_weights(cfg, params)
    T = B * S
    hc = h.reshape(T, d)
    yc = targets.reshape(T)
    Tc = min(cfg.ce_chunk, T)
    n = -(-T // Tc)
    pad = n * Tc - T
    if pad:
        hc = F.pad(hc, (0, 0, 0, pad))
        yc = F.pad(yc, (0, pad), value=-1)
    hc = hc.reshape(n, Tc, d)
    yc = yc.reshape(n, Tc)
    remat = torch.is_grad_enabled() and (h.requires_grad or w.requires_grad)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    ce_sum, z_sum, cnt = zero, zero, zero
    for i in range(n):
        if remat:
            c, z, m = checkpoint(_ce_chunk, hc[i], yc[i], w,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            c, z, m = _ce_chunk(hc[i], yc[i], w)
        ce_sum, z_sum, cnt = ce_sum + c, z_sum + z, cnt + m
    return ce_sum, z_sum, cnt


def loss_fn(cfg: ArchConfig, params, batch, *, device=None):
    """Next-token cross-entropy plus a 1e-4 z-loss, and for MoE the
    layers' load-balance and router z-losses. Returns (loss, metrics
    ``{"ce", "zloss", "loss"}``, for MoE also ``"moe_lb"``, ``"moe_rz"``
    and ``"dropped_fraction"``), 0-d float32 tensors on the run's device.
    ``ce_chunk > 0`` takes the blocked path (the same math, the logits
    held a chunk at a time); 0 takes the full logits."""
    with torch.profiler.record_function("ce_loss"):
        dev, tokens = _placed(params, batch["tokens"], device)
        targets = tokens[:, 1:]
        if cfg.ce_chunk:
            h, aux = forward_hidden(cfg, params, dict(batch, tokens=tokens),
                                    device=dev)
            ce_sum, z_sum, cnt = _chunked_ce(cfg, params, h[:, :-1],
                                             targets)
            denom = torch.clamp(cnt, min=1.0)
            ce = ce_sum / denom
            zloss = 1e-4 * z_sum / denom
        else:
            logits, aux = forward(cfg, params, dict(batch, tokens=tokens),
                                  device=dev)
            lg = logits[:, :-1]
            logz = torch.logsumexp(lg, dim=-1)
            ll = lg.gather(-1, targets[..., None])[..., 0]
            mask = (targets >= 0).float()
            denom = torch.clamp(mask.sum(), min=1.0)
            ce = ((logz - ll) * mask).sum() / denom
            zloss = 1e-4 * ((logz ** 2) * mask).sum() / denom
    total = ce + zloss
    metrics = {"ce": ce, "zloss": zloss}
    if "load_balance_loss" in aux:
        lb = 0.01 * aux["load_balance_loss"] / cfg.n_layers
        rz = 1e-3 * aux["router_z_loss"] / cfg.n_layers
        total = total + lb + rz
        metrics.update(
            moe_lb=lb, moe_rz=rz,
            dropped_fraction=aux["dropped_fraction"] / cfg.n_layers)
    metrics["loss"] = total
    return total, metrics


# ------------------------------------------------------------------ cache
def cache_template(cfg: ArchConfig, batch: int, max_seq: int):
    """The decode cache's shapes and dtypes, allocated nowhere (tensors on
    the ``meta`` device; the reference returns ShapeDtypeStructs). The
    hybrid's sliding-window attention gets a ring buffer of
    min(max_seq, sliding_window) slots."""
    check_family(cfg)
    cdt = cfg.cdtype()
    window = attention_window(cfg)
    kv_len = min(max_seq, window) if window else max_seq

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    def attn_cache(n):
        shape = (n, batch, kv_len, cfg.n_kv_heads, cfg.head_dim_)
        return AttnCache(k=meta(shape, cdt), v=meta(shape, cdt))

    def ssm_cache(n):
        H, P, N, _, conv_dim, _ = ssm_lib.ssm_dims(cfg)
        return ssm_lib.SSMState(
            conv=meta((n, batch, cfg.conv_width - 1, conv_dim), cdt),
            ssm=meta((n, batch, H, P, N), torch.float32))

    n_main = cfg.n_layers - cfg.first_k_dense
    cache = {"layers": LayerCache(
        attn=attn_cache(n_main) if cfg.has_attention else None,
        ssm=ssm_cache(n_main) if cfg.has_ssm else None)}
    if cfg.first_k_dense:
        cache["front_layers"] = LayerCache(attn=attn_cache(cfg.first_k_dense),
                                           ssm=None)
    return cache


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None):
    """A zero decode cache on ``device`` (None: the CUDA device)."""
    dev = resolve_device(device)
    return tree_map(lambda t: torch.zeros_like(t, device=dev),
                    cache_template(cfg, batch, max_seq))


# ---------------------------------------------------------------- decode
def _decode_stack(cfg, stack_params, stack_cache, h, pos, window):
    kv, st = stack_cache.attn, stack_cache.ssm
    for i in range(_n_layers(stack_params)):
        lc = LayerCache(
            attn=None if kv is None else AttnCache(k=kv.k[i], v=kv.v[i]),
            ssm=None if st is None else ssm_lib.SSMState(conv=st.conv[i],
                                                         ssm=st.ssm[i]))
        h, new = block_decode(cfg, _layer(stack_params, i), h, lc, pos,
                              window=window)
        if st is not None:
            st.conv[i].copy_(new.ssm.conv)
            st.ssm[i].copy_(new.ssm.ssm)
    return h


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int, *,
                device=None):
    """One decode step: tokens (B, 1) at position ``pos`` (a Python int).
    Returns (logits (B, V) float32, cache), the cache written in place."""
    _, tokens = _placed(params, tokens, device)
    pos = int(pos)
    window = attention_window(cfg)
    h = embed_tokens(cfg, params, tokens)
    if cfg.first_k_dense:
        h = _decode_stack(_dense(cfg), params["front_layers"],
                          cache["front_layers"], h, pos, window)
    h = _decode_stack(cfg, params["layers"], cache["layers"], h, pos, window)
    h = apply_norm(h, params["final_norm"], cfg.norm)
    return lm_head(cfg, params, h)[:, 0], cache


# --------------------------------------------------------------- prefill
def _prefill_stack(cfg, stack_params, h, positions, window, moe):
    caches = []
    for i in range(_n_layers(stack_params)):
        h, _, lc = block_forward(cfg, _layer(stack_params, i), h, positions,
                                 window=window, build_cache=True,
                                 moe_layer=moe)
        caches.append(lc)
    return h, _stack_caches(caches)


def prefill(cfg: ArchConfig, params, batch, max_seq: Optional[int] = None,
            *, device=None):
    """Full-prompt pass that also builds the decode cache. Returns (logits
    at the last position (B, V) float32, cache sized to the prompt; the
    serving engine pads it to its ``max_seq``, and ``max_seq`` here is
    unused, as in the reference). The vlm's cache holds its vision
    positions in front of the prompt's."""
    dev, tokens = _placed(params, batch["tokens"], device)
    h, _ = _embed_inputs(cfg, params, batch, tokens, dev)
    positions = torch.arange(h.shape[1], device=dev)
    window = attention_window(cfg)
    cache = {}
    if cfg.first_k_dense:
        h, cache["front_layers"] = _prefill_stack(
            _dense(cfg), params["front_layers"], h, positions, window, False)
    h, cache["layers"] = _prefill_stack(cfg, params["layers"], h, positions,
                                        window, True)
    h = apply_norm(h, params["final_norm"], cfg.norm)
    logits = lm_head(cfg, params, h[:, -1:, :])[:, 0]
    return logits, cache


def _stack_caches(caches):
    """Per-layer caches -> one cache whose leaves are stacked on a leading
    layers axis."""
    first = caches[0]
    cols = list(zip(*(leaves_with_path(c) for c in caches)))
    return unflatten(first, [torch.stack([leaf for _, leaf in col])
                             for col in cols])
