"""The port's dense-family LM (``common``, ``layers``, ``blocks``, ``lm``,
``api``): the retrieval encoder's forward, the scoring forward, the loss
and its gradient, prefill and the KV-cache decode step, with attention
through K7."""

from .api import Model
from .common import ArchConfig

__all__ = ["ArchConfig", "Model"]
