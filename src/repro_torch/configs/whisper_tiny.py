"""whisper-tiny [audio]: encoder-decoder, conv frontend stubbed.

4L (enc) + 4L (dec), d_model=384, 6H (MHA kv=6), d_ff=1536, vocab=51865,
encoder_seq=1500 (30 s of mel frames after the conv stem, which is
stubbed: the caller passes frame embeddings as ``enc_frames``).
[arXiv:2212.04356] The numbers are those of the reference's
``configs/whisper_tiny.py``.
"""

from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    rope_theta=0.0,            # sinusoidal positions
    encoder_seq=1500,
)


def tiny() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256, encoder_seq=24,
        q_chunk=16, kv_chunk=16,
    )
