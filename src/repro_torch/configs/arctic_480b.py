"""arctic-480b [moe]: dense-MoE hybrid, 128 experts top-2 + dense residual.

35L d_model=7168 56H (GQA kv=8) d_ff=4864, MoE 128e top-2, vocab=32000,
head_dim=128. [hf:Snowflake/snowflake-arctic-base; hf]
The numbers are those of the reference's ``configs/arctic_480b.py``.
"""

from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    n_experts=128,
    experts_per_token=2,
    moe_dense_residual_ff=4864,   # arctic's parallel dense FFN
    capacity_factor=1.25,
    param_dtype="bfloat16",
)


def tiny() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=256, n_experts=8, experts_per_token=2,
        moe_dense_residual_ff=96, param_dtype="float32",
        q_chunk=16, kv_chunk=16,
    )
