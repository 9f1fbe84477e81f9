"""llama3-8b [dense]: GQA + 128k vocab (embedding-sharding stress).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, head_dim=128.
[arXiv:2407.21783; unverified]
The numbers are those of the reference's ``configs/llama3_8b.py``.
"""

from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=500_000.0,
)


def tiny() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, q_chunk=16, kv_chunk=16,
    )
