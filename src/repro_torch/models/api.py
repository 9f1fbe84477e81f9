"""Model API of the port (the reference's ``models/api.py`` ``Model``):
parameter initialisation and specs, the loss, the scoring forward,
prefill, the decode step and the decode cache, dispatching on the family
(``"encdec"`` to ``encdec.py``, the rest to ``lm.py``) as the reference
does. Each call runs on ``device`` (None: the CUDA device, which raises
without one).

``input_specs(cfg, shape)`` gives the inputs of one (architecture x
shape) cell, allocated nowhere (tensors on the ``meta`` device; the
reference returns ShapeDtypeStructs), the stubbed frontends included
(the vlm's patch embeddings, whisper's frames)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from ..kernels.ops import resolve_device
from . import encdec, lm
from .common import ArchConfig, ShapeConfig

__all__ = ["INPUT_LOGICAL_AXES", "Model", "input_specs"]


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


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The inputs of one cell as ``meta`` tensors (no allocation).

    train:   the full-sequence batch of the train step
    prefill: the full-sequence batch of prefill
    decode:  one token a row (the cache is ``Model.cache_template`` at
             ``seq_len``)

    The vlm's text is ``seq_len - vision_tokens`` long behind its
    ``vision_embeds``; tokens are int32, embeddings and frames in the
    compute dtype."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            n_vis = cfg.vision_tokens
            return {
                "tokens": meta((B, S - n_vis), i32),
                "vision_embeds": meta((B, n_vis, cfg.d_model), cfg.cdtype()),
            }
        if cfg.family == "encdec":
            return {
                "tokens": meta((B, S), i32),
                "enc_frames": meta((B, cfg.encoder_seq, cfg.d_model),
                                   cfg.cdtype()),
            }
        return {"tokens": meta((B, S), i32)}
    # decode: one new token against a seq_len-sized cache
    return {"tokens": meta((B, 1), i32)}


INPUT_LOGICAL_AXES = {
    "tokens": ("batch", "seq"),
    "vision_embeds": ("batch", "vision_seq", "embed"),
    "enc_frames": ("batch", "enc_seq", "embed"),
}
