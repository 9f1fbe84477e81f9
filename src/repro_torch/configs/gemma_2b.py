"""gemma-2b [dense]: GeGLU, head_dim=256 (> d_model/heads), MQA, tied embeds.

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000, head_dim=256.
[arXiv:2403.08295; hf] The numbers are those of the reference's
``configs/gemma_2b.py``.
"""

from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
)


def tiny() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=128, vocab_size=256, q_chunk=16, kv_chunk=16,
    )
