"""The port's LM encoder: the dense-family forward that retrieval serving
runs (``common``, ``layers``, ``blocks``, ``lm``, ``api``), with attention
through K7."""

from .api import Model
from .common import ArchConfig

__all__ = ["ArchConfig", "Model"]
