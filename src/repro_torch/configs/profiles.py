"""Optimized execution profiles (the reference's ``configs/profiles.py``).

``optimized_overrides(arch)`` returns the ``ArchConfig`` overrides of each
architecture's optimized profile; ``optimized_opt_rules()`` the
optimizer-state sharding rules (ZeRO-2: the moments' embed dim also over
the data axes). The published config and the default rules stay the
default everywhere; a profile is opt-in:

    cfg = get_config("llava_next_34b").replace(
        **optimized_overrides("llava_next_34b"))

The knobs: ``ce_chunk`` (blocked cross-entropy) for vocabularies of 100k
and more; ``q_chunk``/``kv_chunk`` (attention blocking); and
``pad_heads_to_multiple=16`` (tensor-parallel head padding: llava's and
arctic's 56 q heads become 64, G = 8 over their 8 kv heads).
"""

from __future__ import annotations

from typing import Dict

from ..models.sharding import DEFAULT_RULES

__all__ = ["optimized_opt_rules", "optimized_overrides"]

_BIG_VOCAB = 100_000

_PER_ARCH: Dict[str, Dict] = {
    "llava_next_34b": {"pad_heads_to_multiple": 16, "q_chunk": 4096,
                       "kv_chunk": 8192},
    "arctic_480b": {"pad_heads_to_multiple": 16, "q_chunk": 4096,
                    "kv_chunk": 8192},
    "kimi_k2_1t_a32b": {"q_chunk": 4096, "kv_chunk": 8192},
    "granite_3_8b": {"q_chunk": 4096, "kv_chunk": 8192},
    "granite_34b": {"q_chunk": 4096, "kv_chunk": 8192},
    "llama3_8b": {"q_chunk": 4096, "kv_chunk": 8192},
    "gemma_2b": {"q_chunk": 4096, "kv_chunk": 8192},
    # 25 heads over 5 kv heads: head padding would need lcm(16, 5) = 80
    # heads, more than 3x; the chunks alone
    "hymba_1_5b": {"q_chunk": 4096, "kv_chunk": 4096},
    "mamba2_1_3b": {},    # attention-free
    "whisper_tiny": {},   # 6-head MHA on a 384-wide model: left exact
}


def optimized_overrides(arch: str) -> Dict:
    from . import ALIASES, get_config

    arch = ALIASES.get(arch, arch)
    over = dict(_PER_ARCH.get(arch, {}))
    if get_config(arch).vocab_size >= _BIG_VOCAB:
        over.setdefault("ce_chunk", 8192)
    return over


def optimized_opt_rules() -> Dict:
    """ZeRO-2: the optimizer moments also sharded over the data axes on
    their embed dim."""
    rules = dict(DEFAULT_RULES)
    rules["embed"] = ("data",)
    return rules
