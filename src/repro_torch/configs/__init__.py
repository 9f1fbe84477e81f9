"""Architectures the port runs: gemma-2b, the retrieval encoder.

``get_config(name)`` returns the published configuration, ``get_tiny(name)``
the reduced same-family configuration the CPU tests use (as in the
reference's ``configs``). The rest of the reference's zoo is ROADMAP A11.
"""

from __future__ import annotations

import importlib
from typing import List

from ..models.common import ArchConfig

__all__ = ["ARCH_IDS", "get_config", "get_tiny"]

ARCH_IDS: List[str] = ["gemma_2b"]
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
