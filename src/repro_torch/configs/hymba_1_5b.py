"""hymba-1.5b [hybrid]: parallel attention + Mamba heads per layer.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16,
head_dim=64; SSM branch: 25 heads x 64 = 1600 inner width. Sliding-window
attention (2048) in the attention branch enables long_500k decode with a
ring-buffer KV cache. [arXiv:2411.13676; hf] Meta-tokens and the paper's
per-head fusion are simplified to learned per-channel branch gates, as
in the reference. The numbers are those of the reference's
``configs/hymba_1_5b.py``.
"""

from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    ssm_state=16,
    ssm_heads=25,
    ssm_head_dim=64,
    sliding_window=2048,
)


def tiny() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, ssm_state=8, ssm_heads=4, ssm_head_dim=16,
        sliding_window=32, q_chunk=16, kv_chunk=16,
    )
