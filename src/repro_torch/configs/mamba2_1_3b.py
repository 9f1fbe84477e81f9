"""mamba2-1.3b [ssm]: attention-free SSD (state-space duality).

48L d_model=2048, d_inner=4096 (expand 2), 64 SSM heads x 64, ssm_state=128,
no MLP (d_ff=0), vocab=50280. [arXiv:2405.21060] The numbers are those of
the reference's ``configs/mamba2_1_3b.py``.
"""

from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=0.0,
    ssm_state=128,
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_expand=2,
)


def tiny() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, vocab_size=256,
        ssm_state=16, ssm_heads=4, ssm_head_dim=16,
    )
