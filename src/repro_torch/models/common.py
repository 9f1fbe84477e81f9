"""Architecture config of the port's LM encoder (a copy of the reference's
``models/common.py`` ``ArchConfig``, with torch dtypes).

Every parameter shape derives from one frozen ``ArchConfig``. The port
runs only the dense-family forward that retrieval serving's encoder uses;
the fields of the other families are kept so that a reference config
copies over unchanged, and the code that would read them raises
``NotImplementedError`` (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

__all__ = ["ArchConfig", "not_ported"]

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
    def is_moe(self) -> bool:
        return self.n_experts > 0

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


def not_ported(what: str) -> NotImplementedError:
    """The error a caller gets for a part of the LM zoo not ported yet."""
    return NotImplementedError(f"{what} is not ported yet: ROADMAP A11")
