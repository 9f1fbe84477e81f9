"""Model API of the port (the reference's ``models/api.py`` ``Model``):
parameter initialisation and specs, the loss, the scoring forward,
prefill, the decode step and the decode cache, dispatching on the family
(``"encdec"`` to ``encdec.py``, the rest to ``lm.py``) as the reference
does. Each call runs on ``device`` (None: the CUDA device, which raises
without one)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.ops import resolve_device
from . import encdec, lm
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

    def param_specs(self):
        return lm.param_specs(self.cfg)

    @property
    def _impl(self):
        return encdec if self.cfg.family == "encdec" else lm

    def loss(self, params, batch, device=None):
        return self._impl.loss_fn(self.cfg, params, batch, device=device)

    def forward(self, params, batch, device=None):
        return self._impl.forward(self.cfg, params, batch, device=device)

    def prefill(self, params, batch, device=None):
        return self._impl.prefill(self.cfg, params, batch, device=device)

    def decode_step(self, params, cache, tokens, pos, device=None):
        return self._impl.decode_step(self.cfg, params, cache, tokens, pos,
                                      device=device)

    def cache_template(self, batch: int, max_seq: int):
        return self._impl.cache_template(self.cfg, batch, max_seq)

    def init_cache(self, batch: int, max_seq: int, device=None):
        return self._impl.init_cache(self.cfg, batch, max_seq, device=device)
