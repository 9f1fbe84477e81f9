"""Architecture config of the port's LM and the shape registry (copies
of the reference's ``models/common.py`` ``ArchConfig``, with torch dtypes,
and ``ShapeConfig``, ``SHAPES``, ``shape_applicable``).

Every parameter shape derives from one frozen ``ArchConfig``. The port
runs every family of the reference: the dense family (the retrieval
encoder, serving, training), the encoder-decoder (whisper), the SSM
(mamba2), the hybrid (hymba), MoE (arctic, kimi-k2) and the vlm (llava:
the dense decoder behind stubbed patch embeddings). ``SHAPES`` names the
reference's four workload shapes (train 4k, prefill 32k, decode 32k, a
500k-token decode that only the sub-quadratic families take).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

__all__ = ["ArchConfig", "FAMILIES", "LONG_CONTEXT_FAMILIES", "SHAPES",
           "ShapeConfig", "check_family", "not_ported", "shape_applicable"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def _dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    activation: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    rope_theta: float = 500_000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_dense_residual_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # --- enc-dec (whisper) ---
    n_encoder_layers: int = 0
    encoder_seq: int = 0
    # --- vlm (llava) ---
    vision_tokens: int = 0
    # --- attention windowing (hybrid long-context) ---
    sliding_window: int = 0
    # --- numerics / execution ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: str = "full"
    q_chunk: int = 1024
    kv_chunk: int = 1024
    ce_chunk: int = 0
    pad_heads_to_multiple: int = 0

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_heads_padded(self) -> int:
        """Attention-projection head count after tensor-parallel padding."""
        m = self.pad_heads_to_multiple
        if not m:
            return self.n_heads
        h = ((self.n_heads + m - 1) // m) * m
        while h % self.n_kv_heads:
            h += 1
        return h

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        if self.ssm_heads:
            return self.ssm_heads * self.ssm_head_dim
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads_(self) -> int:
        return self.ssm_heads or self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    def pdtype(self) -> torch.dtype:
        return _dtype(self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return _dtype(self.compute_dtype)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Total parameters (embedding included)."""
        from . import lm

        return lm.count_params(self)

    def active_param_count(self) -> int:
        """Parameters a token runs through (MoE: only its routed experts
        count)."""
        from . import lm

        return lm.count_params(self, active_only=True)


def check_family(cfg: ArchConfig) -> None:
    """Raise on a family the zoo does not have."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; known: {FAMILIES}")


# ------------------------------------------------------------- the shapes
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: only SSM/hybrid run it
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(whether ``cfg`` runs ``shape``, the reason where it does not)."""
    if shape.name == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (skip recorded in DESIGN.md)"
        )
    return True, ""


def not_ported(what: str) -> NotImplementedError:
    """The error a caller gets for a part of the LM zoo not ported yet."""
    return NotImplementedError(f"{what} is not ported yet: ROADMAP A11")
