"""granite-3-8b [dense]: GQA decoder.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155, head_dim=128.
[hf:ibm-granite/granite-3.0-2b-base; hf]
The numbers are those of the reference's ``configs/granite_3_8b.py``.
"""

from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
)


def tiny() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, q_chunk=16, kv_chunk=16,
    )
