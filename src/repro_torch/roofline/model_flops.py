"""Analytic MODEL_FLOPS per (architecture, shape) — the 'useful compute'
yardstick the roofline report compares against a step's counted FLOPs (a
copy of the reference's ``roofline/model_flops.py``, over the port's
``ArchConfig`` and ``ShapeConfig``; the arithmetic is the reference's,
value for value).

Conventions (assignment-mandated):
  train:    6 * N * D      (N = params; MoE: active params per token)
  prefill:  2 * N * D
  decode:   2 * N * B per emitted token, plus the KV-cache attention term
            4 * B * S_ctx * Hq * Dh per attention layer (score + value),
            or the O(1) SSD state term for ssm/hybrid.
D = global_batch * seq_len tokens.
"""

from __future__ import annotations

from ..models.common import ArchConfig, ShapeConfig

__all__ = ["model_flops"]


def _decode_attn_flops(cfg: ArchConfig, B: int, S: int) -> float:
    """Per-token attention-over-cache FLOPs across layers."""
    if not cfg.has_attention:
        return 0.0
    ctx = S
    if cfg.family == "hybrid" and cfg.sliding_window:
        ctx = min(S, cfg.sliding_window)
    per_layer = 4.0 * B * ctx * cfg.n_heads * cfg.head_dim_
    return per_layer * cfg.n_layers


def _decode_ssm_flops(cfg: ArchConfig, B: int) -> float:
    if not cfg.has_ssm:
        return 0.0
    H, P, N = cfg.ssm_heads_, cfg.ssm_head_dim, cfg.ssm_state
    # state update + output contraction per token per layer
    per_layer = B * (2.0 * H * P * N + 2.0 * H * P * N)
    return per_layer * cfg.n_layers


def flash_io_bytes_per_device(
    cfg: ArchConfig,
    shape: ShapeConfig,
    dp: int = 16,
    tp: int = 16,
    q_blk: int = 512,
) -> float:
    """Per-device HBM bytes of the fused flash-attention kernel
    (K7, ``kernels/flash_attention.py``) for one step — the L2
    substitution the roofline applies to the counted ``flash_attn`` scope.
    ``dp`` and ``tp`` are the data- and tensor-parallel degrees that
    divide the batch and the heads (the reference's default of 16 x 16;
    one card is ``dp = tp = 1``), ``q_blk`` the query block whose row of
    the grid streams k and v once.

    Traffic model (flash-v2): q and o move once; k/v stream once per
    q-block row of the grid; causal masking halves the live kv tiles.

    Covered kinds:
      prefill — flash forward kernel (q+o once, k/v per q-row, causal half)
      decode  — flash-DECODE kernel (``valid_len``): ONE pass over the
                valid KV cache per layer + tiny q/o
    Train returns 0 (not substituted): the kernel is forward-only; its
    backward recomputes through the plain blocked attention in torch ops,
    re-materializing scores, so substituting fused traffic into train
    cells would lie.
    """
    if not cfg.has_attention or shape.kind == "train":
        return 0.0
    B, S = shape.global_batch, shape.seq_len
    b_loc = B // dp if B % dp == 0 else B
    hq_all = cfg.n_heads_padded
    hq = hq_all // tp if hq_all % tp == 0 else hq_all
    hkv = cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0 else cfg.n_kv_heads
    d = cfg.head_dim_
    bpe = 2  # bf16: the port computes attention in bf16 on the card
    if shape.kind == "decode":
        ctx = S
        if cfg.family == "hybrid" and cfg.sliding_window:
            ctx = min(S, cfg.sliding_window)  # ring buffer cache
        kv = 2 * b_loc * ctx * hkv * d * bpe       # one fused cache pass
        qo = 2 * b_loc * 1 * hq * d * bpe
        return (kv + qo) * cfg.n_layers
    nq = -(-S // q_blk)
    causal_frac = 0.5
    qo = 2 * b_loc * S * hq * d * bpe
    kv = 2 * b_loc * S * hkv * d * bpe * nq * causal_frac
    return (qo + kv) * cfg.n_layers


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    B, S = shape.global_batch, shape.seq_len
    N = cfg.active_param_count() if cfg.is_moe else cfg.param_count()
    if shape.kind == "train":
        return 6.0 * N * B * S
    if shape.kind == "prefill":
        return 2.0 * N * B * S
    # decode: one token against an S-token cache
    return (
        2.0 * N * B
        + _decode_attn_flops(cfg, B, S)
        + _decode_ssm_flops(cfg, B)
    )
