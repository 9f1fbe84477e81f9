"""Batched prefill/decode serving engine (a port of the reference's
``serve/engine.py``).

Slot-based continuous batching: a fixed device batch of ``max_batch``
slots; requests occupy slots, and finished slots are refilled from the
queue. The KV cache is allocated once at ``max_seq`` and written in
place. Slots decode at a shared position, so each step advances the
lagging position group; the other rows keep their cache, as the
reference's masked merge of every cache leaf keeps them: the decode
writes one slot of every row's K/V in every cache stack (``pos``, or
``pos % kv_len`` on the hybrid's ring buffer), and the rows outside the
group get their saved column back; an SSM decode rewrites every row's
whole conv and SSM state, and the rows outside the group get theirs back
whole. A prompt longer than the hybrid's attention window is refused, as
the reference refuses it (that needs a chunked prefill).

Token choice happens on the host, on the logits copied out as float32:
``np.argmax``, or a draw from ``np.random.default_rng(seed + 7919 *
decode_steps + slot)``, as the reference chooses. The engine runs on
``ServeConfig.device`` (None: the CUDA device, which raises without one);
parameters that lie elsewhere are refused, not moved.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..kernels.ops import resolve_device
from ..models import Model
from ..models.blocks import cache_slot
from ..models.common import ArchConfig
from ..models.lm import attention_window
from ..tree import leaves, leaves_with_path

__all__ = ["ServeConfig", "ServeEngine", "Request"]


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 256
    max_new_tokens: int = 32
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0
    # where the model and its cache run: None = the CUDA device
    device: Optional[object] = None


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                      # (S,) int32
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Single-device engine over one model's parameters."""

    def __init__(self, cfg: ArchConfig, params,
                 scfg: ServeConfig = ServeConfig()):
        self.cfg = cfg
        self.scfg = scfg
        self.model = Model(cfg)
        self.device = resolve_device(scfg.device)
        for path, leaf in leaves_with_path(params):
            if leaf.device != self.device:
                raise ValueError(
                    f"parameter {'/'.join(path)} lies on {leaf.device}, the "
                    f"engine on {self.device}: place it there first")
        self.params = params
        B, S = scfg.max_batch, scfg.max_seq
        self.cache = self.model.init_cache(B, S, device=self.device)
        # slot table
        self.slot_req: List[Optional[Request]] = [None] * B
        self.slot_pos = np.zeros(B, dtype=np.int32)   # next position to write
        self.queue: List[Request] = []
        self._next_rid = 0
        self._stats = {"prefills": 0, "decode_steps": 0, "tokens_out": 0}

    # --------------------------------------------------------------- API
    def submit(self, prompt: np.ndarray,
               max_new_tokens: Optional[int] = None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(
            Request(
                rid=rid,
                prompt=np.asarray(prompt, np.int32),
                max_new_tokens=max_new_tokens or self.scfg.max_new_tokens,
            )
        )
        return rid

    def run_until_drained(self) -> Dict[int, List[int]]:
        """Process the whole queue; returns {rid: generated tokens}."""
        results: Dict[int, List[int]] = {}
        with torch.no_grad():
            while self.queue or any(r is not None for r in self.slot_req):
                self._fill_slots()
                self._step()
                for i, req in enumerate(self.slot_req):
                    if req is not None and req.done:
                        results[req.rid] = req.generated
                        self.slot_req[i] = None
        return results

    @property
    def stats(self):
        return dict(self._stats)

    # ------------------------------------------------------------ internal
    def _fill_slots(self):
        for i in range(self.scfg.max_batch):
            if self.slot_req[i] is None and self.queue:
                req = self.queue.pop(0)
                self._prefill_into_slot(i, req)

    def _prefill_into_slot(self, slot: int, req: Request):
        """Prefill one request (B = 1) and paste every leaf of its cache
        (K/V sized to the prompt, the SSM state) into the slot's row, zero
        past the prompt, as the reference pastes its zero-padded cache."""
        S = len(req.prompt)
        if S + req.max_new_tokens > self.scfg.max_seq:
            raise ValueError(f"prompt too long: {S} tokens + "
                             f"{req.max_new_tokens} new > max_seq "
                             f"{self.scfg.max_seq}")
        window = attention_window(self.cfg)
        if window and S > window:
            # ring-buffer KV: slot = pos % ring is the identity only while
            # the prompt fits the ring
            raise ValueError("prompt longer than the attention window "
                             "needs chunked prefill (not implemented in "
                             "this engine)")
        logits, cache1 = self.model.prefill(
            self.params, {"tokens": req.prompt[None, :]}, device=self.device)
        self._stats["prefills"] += 1
        for f, p in zip(leaves(self.cache), leaves(cache1)):
            row = f[:, slot]
            row.zero_()
            row[(slice(None),) + tuple(slice(0, n) for n in p.shape[2:])] \
                = p[:, 0].to(f.dtype)
        self.slot_req[slot] = req
        self.slot_pos[slot] = S
        tok = self._select_token(logits.float().cpu().numpy(), slot)
        req.generated.append(int(tok))
        self._stats["tokens_out"] += 1

    def _select_token(self, logits_row: np.ndarray, slot: int) -> int:
        if logits_row.ndim == 2:
            logits_row = logits_row[0]
        if self.scfg.greedy:
            return int(np.argmax(logits_row))
        rng = np.random.default_rng(
            self.scfg.seed + 7919 * self._stats["decode_steps"] + slot
        )
        p = np.exp(
            (logits_row - logits_row.max()) / max(self.scfg.temperature, 1e-6)
        )
        p /= p.sum()
        return int(rng.choice(len(p), p=p))

    def _decode(self, tokens: np.ndarray, pos: int, mask: np.ndarray):
        """The decode step at ``pos`` for every slot; the cache rows outside
        ``mask`` get back what the step rewrote in each cache stack: K/V
        slot ``pos`` (``pos % kv_len`` on a ring buffer, which is no longer
        than the window), the SSM state whole."""
        kv, st = [], []
        for lc in self.cache.values():
            if lc.attn is not None:
                kv += [lc.attn.k, lc.attn.v]
            if lc.ssm is not None:
                st += [lc.ssm.conv, lc.ssm.ssm]
        rest = np.flatnonzero(~mask)
        if rest.size:
            rows = torch.from_numpy(rest).to(self.device)
            window = attention_window(self.cfg)
            slot = [cache_slot(pos, t.shape[2], window) for t in kv]
            saved_kv = [t[:, rows, j] for t, j in zip(kv, slot)]
            saved_st = [t[:, rows] for t in st]
        logits, _ = self.model.decode_step(self.params, self.cache, tokens,
                                           pos, device=self.device)
        if rest.size:
            for t, j, old in zip(kv, slot, saved_kv):
                t[:, rows, j] = old
            for t, old in zip(st, saved_st):
                t[:, rows] = old
        return logits

    def _step(self):
        active = [i for i, r in enumerate(self.slot_req)
                  if r is not None and not r.done]
        if not active:
            return
        # slots decode at a shared position; advance the lagging group
        pos_vals = {int(self.slot_pos[i]) for i in active}
        pos = min(pos_vals)
        group = [i for i in active if int(self.slot_pos[i]) == pos]
        tokens = np.zeros((self.scfg.max_batch, 1), np.int32)
        mask = np.zeros((self.scfg.max_batch,), bool)
        for i in group:
            tokens[i, 0] = self.slot_req[i].generated[-1]
            mask[i] = True
        logits = self._decode(tokens, pos, mask)
        self._stats["decode_steps"] += 1
        logits = logits.float().cpu().numpy()
        for i in group:
            req = self.slot_req[i]
            tok = self._select_token(logits[i], i)
            req.generated.append(int(tok))
            self._stats["tokens_out"] += 1
            self.slot_pos[i] = pos + 1
            if (
                len(req.generated) >= req.max_new_tokens
                or int(self.slot_pos[i]) + 1 >= self.scfg.max_seq
            ):
                req.done = True
