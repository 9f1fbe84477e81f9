"""Optimizer substrate of the port: AdamW (+ int8 moments), schedules,
compression (the reference's ``repro.optim``)."""

from .adamw import OptimConfig, apply_updates, init_state, lr_at, state_specs
from .compression import (
    apply_error_feedback,
    compressed_psum_mean,
    dequantize_block_int8,
    quantize_block_int8,
    zeros_like_residuals,
)

__all__ = [
    "OptimConfig",
    "apply_error_feedback",
    "apply_updates",
    "compressed_psum_mean",
    "dequantize_block_int8",
    "init_state",
    "lr_at",
    "quantize_block_int8",
    "state_specs",
    "zeros_like_residuals",
]
