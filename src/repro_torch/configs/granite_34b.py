"""granite-34b [dense]: deep MQA code model (llama-arch).

88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152, head_dim=128.
[arXiv:2405.04324; hf]
The numbers are those of the reference's ``configs/granite_34b.py``.
"""

from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
)


def tiny() -> ArchConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, q_chunk=16, kv_chunk=16,
    )
