"""The architectures of the reference's zoo, every one ported: the dense
family, gemma-2b (GeGLU, the retrieval encoder) and llama3-8b,
granite-3-8b and granite-34b (SwiGLU); whisper-tiny (encoder-decoder),
mamba2-1.3b (SSM), hymba-1.5b (hybrid), arctic-480b and kimi-k2-1t-a32b
(MoE) and llava-next-34b (vlm: the SwiGLU decoder behind stubbed patch
embeddings).

``get_config(name)`` returns the published configuration, ``get_tiny(name)``
the reduced same-family configuration the CPU tests use, ``all_configs()``
every published one, as the reference's ``configs`` do; names take
dashes or underscores (``ALIASES``). ``profiles`` holds the optimized
overrides.
"""

from __future__ import annotations

import importlib
from typing import List

from ..models.common import ArchConfig

__all__ = ["ALIASES", "ARCH_IDS", "all_configs", "get_config", "get_tiny"]

ARCH_IDS: List[str] = ["llava_next_34b", "kimi_k2_1t_a32b", "arctic_480b",
                       "whisper_tiny", "granite_3_8b", "llama3_8b",
                       "granite_34b", "gemma_2b", "hymba_1_5b",
                       "mamba2_1_3b"]
# dashed ids -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(
            f"unknown architecture {name!r}; available: {sorted(ALIASES)}"
        )
    return importlib.import_module(f".{name}", __name__)


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_tiny(name: str) -> ArchConfig:
    return _module(name).tiny()


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
