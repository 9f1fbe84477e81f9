"""llava-next-34b [vlm]: Yi-34B-class backbone + anyres vision frontend (stub).

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000, head_dim=128.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] — backbone only; the
anyres tiling and the CLIP tower are stubbed: ``input_specs()`` provides
precomputed patch embeddings (``vision_tokens`` per sequence) fused before
the text tokens.
The numbers are those of the reference's ``configs/llava_next_34b.py``.
"""

from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=5_000_000.0,
    vision_tokens=576,          # one base-resolution tile (stub for anyres)
    param_dtype="bfloat16",
)


def tiny() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, vision_tokens=8,
        param_dtype="float32", q_chunk=16, kv_chunk=16,
    )
