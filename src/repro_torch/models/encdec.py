"""Whisper-style encoder-decoder of the port (the reference's
``models/encdec.py``; the audio family, its conv frontend stubbed).

The caller passes precomputed mel-frame embeddings as ``enc_frames``
(B, encoder_seq, d_model). Positions are sinusoidal on both sides (the
decoder's sin/cos from ``pos0 + arange(S)``). Decoder layers are causal
self-attention, then cross-attention over the encoder's output, then the
MLP, all pre-norm. Every attention runs through K7: the encoder's
non-causal self-attention, the decoder's causal self-attention and its
non-causal cross-attention (Sq != Sk) through ``blocked_attention``, the
decode step's self- and cross-attention through ``decode_attention``
with ``valid_len``.

Decode caches: per layer a self-attention KV buffer of ``max_seq`` slots
(written in place by ``decode_step``) and the cross-attention KV, built
once at prefill from the encoder's output. ``forward`` rematerialises the
decoder layers as ``cfg.remat`` says; ``loss_fn`` is next-token
cross-entropy over the full float32 logits (no z-loss, no chunking), as
the reference's. Each entry point runs on ``device`` (None: the CUDA
device; it raises without one) and refuses parameters that lie
elsewhere.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import resolve_device
from ..tree import leaves, tree_map
from .blocks import AttnCache, attention_decode, attention_full
from .blocks import cross_attention_decode
from .layers import apply_norm, blocked_attention, mlp, sinusoidal_positions
from .lm import _placed, _placed_input, _remat_context, _split_layers

__all__ = [
    "EncDecCache",
    "cache_template",
    "decode_step",
    "encode",
    "forward",
    "init_cache",
    "loss_fn",
    "prefill",
]


class EncDecCache(NamedTuple):
    self_kv: AttnCache     # (L, B, S_max, Hkv, Dh)
    cross_kv: AttnCache    # (L, B, S_enc, Hkv, Dh)


# ------------------------------------------------------------- encoder
def encode(cfg, params, enc_frames):
    """(B, S_enc, D) stub frames -> encoder hidden states (the compute
    dtype), on the frames' device."""
    cdt = cfg.cdtype()
    h = enc_frames.to(cdt)
    h = h + sinusoidal_positions(h.shape[1], cfg.d_model,
                                 device=h.device).to(cdt)[None]
    positions = torch.arange(h.shape[1], device=h.device)
    for lp in _split_layers(params["enc_layers"]):
        hh = apply_norm(h, lp["ln1"], cfg.norm)
        attn_out, _ = attention_full(hh, lp["attn"], cfg, positions,
                                     causal=False)
        h = h + attn_out
        h2 = apply_norm(h, lp["ln2"], cfg.norm)
        h = h + mlp(h2, lp["mlp"], cfg.activation)
    return apply_norm(h, params["enc_norm"], cfg.norm)


# ------------------------------------------------- decoder (full sequence)
def _cross_attention_full(x, xp, cfg, enc_h):
    cdt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, xp["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", enc_h, xp["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", enc_h, xp["wv"].to(cdt))
    out = blocked_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk)
    return torch.einsum("bshk,hkd->bsd", out, xp["wo"].to(cdt)), (k, v)


def _decoder_layer_full(cfg, lp, x, positions, enc_h, build_cache):
    h = apply_norm(x, lp["ln1"], cfg.norm)
    attn_out, kv = attention_full(h, lp["attn"], cfg, positions, causal=True)
    x = x + attn_out
    hx = apply_norm(x, lp["lnx"], cfg.norm)
    cross_out, cross_kv = _cross_attention_full(hx, lp["xattn"], cfg, enc_h)
    x = x + cross_out
    h2 = apply_norm(x, lp["ln2"], cfg.norm)
    x = x + mlp(h2, lp["mlp"], cfg.activation)
    cache = None
    if build_cache:
        cache = EncDecCache(self_kv=AttnCache(k=kv[0], v=kv[1]),
                            cross_kv=AttnCache(k=cross_kv[0], v=cross_kv[1]))
    return x, cache


def _decoder_layer_out(cfg, lp, x, positions, enc_h):
    return _decoder_layer_full(cfg, lp, x, positions, enc_h, False)[0]


def _decode_tokens_embed(cfg, params, tokens, pos0: int):
    """Token embeddings plus the sinusoidal positions pos0 .. pos0 + S - 1
    (the same float32 angles as the reference's ``pos0 + arange(S)``)."""
    cdt = cfg.cdtype()
    h = params["embed"][tokens].to(cdt)
    pe = sinusoidal_positions(pos0 + tokens.shape[1], cfg.d_model,
                              device=tokens.device)[pos0:]
    return h + pe.to(cdt)[None]


def forward(cfg, params, batch, *, device=None):
    """Training forward: (decoder logits (B, S, V) float32, aux {})."""
    dev, tokens = _placed(params, batch["tokens"], device)
    enc_h = encode(cfg, params, _placed_input(batch, "enc_frames", dev))
    h = _decode_tokens_embed(cfg, params, tokens, 0)
    positions = torch.arange(tokens.shape[1], device=dev)
    recorded = torch.is_grad_enabled() and (enc_h.requires_grad or any(
        t.requires_grad for t in leaves(params["layers"])))
    context_fn = _remat_context(cfg) if recorded else None
    for lp in _split_layers(params["layers"]):
        if context_fn is None:
            h = _decoder_layer_out(cfg, lp, h, positions, enc_h)
        else:
            h = checkpoint(_decoder_layer_out, cfg, lp, h, positions, enc_h,
                           use_reentrant=False, context_fn=context_fn,
                           preserve_rng_state=False)
    h = apply_norm(h, params["final_norm"], cfg.norm)
    logits = (h @ params["unembed"].to(h.dtype)).float()
    return logits, {}


def loss_fn(cfg, params, batch, *, device=None):
    """Next-token cross-entropy over the full float32 logits. Returns
    (loss, metrics ``{"ce", "loss"}``)."""
    logits, _ = forward(cfg, params, batch, device=device)
    _, tokens = _placed(params, batch["tokens"], device)
    targets = tokens[:, 1:]
    lg = logits[:, :-1]
    logz = torch.logsumexp(lg, dim=-1)
    ll = lg.gather(-1, torch.clamp(targets, min=0)[..., None])[..., 0]
    mask = (targets >= 0).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = ((logz - ll) * mask).sum() / denom
    return ce, {"ce": ce, "loss": ce}


# ----------------------------------------------------------------- decode
def cache_template(cfg, batch: int, max_seq: int):
    """The decode cache's shapes and dtypes, allocated nowhere (tensors on
    the ``meta`` device)."""
    hkv, dh, L, cdt = cfg.n_kv_heads, cfg.head_dim_, cfg.n_layers, \
        cfg.cdtype()

    def meta(s):
        return torch.empty((L, batch, s, hkv, dh), dtype=cdt, device="meta")

    return EncDecCache(
        self_kv=AttnCache(k=meta(max_seq), v=meta(max_seq)),
        cross_kv=AttnCache(k=meta(cfg.encoder_seq), v=meta(cfg.encoder_seq)),
    )


def init_cache(cfg, batch: int, max_seq: int, device=None):
    """A zero decode cache on ``device`` (None: the CUDA device)."""
    dev = resolve_device(device)
    return tree_map(lambda t: torch.zeros_like(t, device=dev),
                    cache_template(cfg, batch, max_seq))


def decode_step(cfg, params, cache: EncDecCache, tokens, pos: int, *,
                device=None):
    """One decoder token: tokens (B, 1) at position ``pos`` (a Python
    int). Returns (logits (B, V) float32, cache), the self-attention
    cache written in place."""
    _, tokens = _placed(params, tokens, device)
    pos = int(pos)
    h = _decode_tokens_embed(cfg, params, tokens, pos)
    sk, xk = cache.self_kv, cache.cross_kv
    for i, lp in enumerate(_split_layers(params["layers"])):
        hh = apply_norm(h, lp["ln1"], cfg.norm)
        attn_out, _ = attention_decode(hh, lp["attn"], cfg,
                                       AttnCache(k=sk.k[i], v=sk.v[i]), pos)
        h = h + attn_out
        hx = apply_norm(h, lp["lnx"], cfg.norm)
        h = h + cross_attention_decode(hx, lp["xattn"], cfg, xk.k[i],
                                       xk.v[i])
        h2 = apply_norm(h, lp["ln2"], cfg.norm)
        h = h + mlp(h2, lp["mlp"], cfg.activation)
    h = apply_norm(h, params["final_norm"], cfg.norm)
    logits = (h @ params["unembed"].to(h.dtype))[:, 0].float()
    return logits, cache


def prefill(cfg, params, batch, *, device=None) -> Tuple[torch.Tensor,
                                                         EncDecCache]:
    """The encoder pass and the decoder's prompt pass; builds both cache
    halves (self-attention sized to the prompt). Returns (logits at the
    last position (B, V) float32, cache)."""
    dev, tokens = _placed(params, batch["tokens"], device)
    enc_h = encode(cfg, params, _placed_input(batch, "enc_frames", dev))
    h = _decode_tokens_embed(cfg, params, tokens, 0)
    positions = torch.arange(tokens.shape[1], device=dev)
    caches = []
    for lp in _split_layers(params["layers"]):
        h, c = _decoder_layer_full(cfg, lp, h, positions, enc_h, True)
        caches.append(c)
    h = apply_norm(h, params["final_norm"], cfg.norm)
    logits = (h[:, -1] @ params["unembed"].to(h.dtype)).float()

    def stack(get):
        return torch.stack([get(c) for c in caches])

    return logits, EncDecCache(
        self_kv=AttnCache(k=stack(lambda c: c.self_kv.k),
                          v=stack(lambda c: c.self_kv.v)),
        cross_kv=AttnCache(k=stack(lambda c: c.cross_kv.k),
                           v=stack(lambda c: c.cross_kv.v)))
