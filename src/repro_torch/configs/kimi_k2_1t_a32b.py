"""kimi-k2-1t-a32b [moe]: trillion-param MoE (paper-table config).

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048, MoE 384 experts top-8,
vocab=163840, 1 leading dense layer + 1 shared expert (modeled as the
dense-residual FFN), head_dim=112. [arXiv:2501.kimi2; unverified]
bf16 params: 1T params do not fit 512 x 16 GB in f32. The numbers are
those of the reference's ``configs/kimi_k2_1t_a32b.py``.
"""

from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163840,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=50_000.0,
    n_experts=384,
    experts_per_token=8,
    first_k_dense=1,
    moe_dense_residual_ff=2048,   # shared expert
    capacity_factor=1.25,
    param_dtype="bfloat16",
)


def tiny() -> ArchConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=256, n_experts=8, experts_per_token=2,
        first_k_dense=1, moe_dense_residual_ff=64,
        param_dtype="float32", q_chunk=16, kv_chunk=16,
    )
