"""Architectures the port runs: the dense family, gemma-2b (GeGLU, the
retrieval encoder) and llama3-8b, granite-3-8b and granite-34b (SwiGLU);
whisper-tiny (encoder-decoder), mamba2-1.3b (SSM), hymba-1.5b (hybrid) and
arctic-480b and kimi-k2-1t-a32b (MoE).

``get_config(name)`` returns the published configuration, ``get_tiny(name)``
the reduced same-family configuration the CPU tests use (as in the
reference's ``configs``). The rest of the reference's zoo (llava-next-34b,
the vlm family) is ROADMAP A11.
"""

from __future__ import annotations

import importlib
from typing import List

from ..models.common import ArchConfig

__all__ = ["ARCH_IDS", "get_config", "get_tiny"]

ARCH_IDS: List[str] = ["kimi_k2_1t_a32b", "arctic_480b", "whisper_tiny",
                       "granite_3_8b", "llama3_8b", "granite_34b", "gemma_2b",
                       "hymba_1_5b", "mamba2_1_3b"]
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(
            f"architecture {name!r} is not ported (ROADMAP A11); "
            f"available: {sorted(ALIASES)}"
        )
    return importlib.import_module(f".{name}", __name__)


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_tiny(name: str) -> ArchConfig:
    return _module(name).tiny()
