"""Model API of the port (the reference's ``models/api.py`` ``Model``, with
only parameter initialisation: the forward that the port runs is the
retrieval encoder's, ``serve.retrieval.RetrievalService.embed``; training,
prefill and decode are ROADMAP A11)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.ops import resolve_device
from . import lm
from .common import ArchConfig

__all__ = ["Model"]


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def init_params(self, seed=0, device=None):
        """Random parameters on ``device`` (None: the CUDA device), drawn
        from ``seed`` (an int, or a ``torch.Generator`` on that device)."""
        dev = resolve_device(device)
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        return lm.init_params(self.cfg, gen, device=dev)
