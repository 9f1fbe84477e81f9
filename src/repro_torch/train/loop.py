"""Fault-tolerant training loop of the port (the reference's
``train/loop.py`` on one device).

A single-controller trainer that composes:

  - the deterministic checkpointable data pipeline (``repro_torch.data``)
  - the in-place train step (``train.step``)
  - atomic/async checkpointing with retention (``repro_torch.checkpoint``)
  - the straggler watchdog driving proactive checkpoints
    (``train.watchdog``)
  - crash recovery: a failed step restores the last checkpoint and
    replays; because the pipeline is a pure function of the step counter
    and the step is deterministic, recovery is bit-exact.

Checkpoints hold ``{"params", "opt"}`` with the pipeline's state and the
step in the metadata, in the reference's layout: a checkpoint of either
package's trainer resumes in the other's. The trainer runs on ``device``
(None: the CUDA device, which raises without one).
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..data import DataConfig, TokenPipeline
from ..kernels.ops import resolve_device
from ..models.common import ArchConfig, not_ported
from ..optim import OptimConfig
from ..tree import tree_map
from .step import TrainConfig, make_train_step
from .watchdog import StragglerWatchdog

__all__ = ["Trainer", "TrainerConfig"]


def _default_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclass(frozen=True)
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = field(default_factory=_default_dir)
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    max_restarts: int = 3
    log_every: int = 10
    seed: int = 0


@dataclass
class Trainer:
    cfg: ArchConfig
    ocfg: OptimConfig
    tcfg: TrainConfig
    rcfg: TrainerConfig
    data_cfg: DataConfig
    mesh: Optional[Any] = None
    # test hook: fn(step) raising to simulate a mid-run failure
    failure_injector: Optional[Callable[[int], None]] = None
    device: Any = None

    history: List[Dict[str, float]] = field(default_factory=list)
    restarts: int = 0

    def __post_init__(self):
        if self.mesh is not None:
            raise not_ported("training over a mesh")
        self.device = resolve_device(self.device)
        self._built = make_train_step(self.cfg, self.ocfg, self.tcfg,
                                      device=self.device)
        self._ckpt = Checkpointer(
            self.rcfg.checkpoint_dir,
            keep=self.rcfg.keep_checkpoints,
            async_save=self.rcfg.async_checkpoint,
        )
        self._watchdog = StragglerWatchdog()
        self.pipeline = TokenPipeline(self.data_cfg)

    # ---------------------------------------------------------- state mgmt
    def _fresh_state(self):
        return self._built["init"](self.rcfg.seed)

    def _save(self, step: int, params, opt):
        tree = {"params": params, "opt": opt}
        meta = {"data": self.pipeline.state_dict(), "step": step}
        self._ckpt.save(step, tree, meta)

    def _restore(self):
        tmpl = {
            "params": self._built["param_specs"],
            "opt": self._built["opt_specs"],
        }
        tree, meta = self._ckpt.restore(tmpl)
        self.pipeline.load_state_dict(meta["data"])
        tree = tree_map(lambda t: t.to(self.device), tree,
                        lambda x: isinstance(x, torch.Tensor))
        return int(meta["step"]), tree["params"], tree["opt"]

    # ------------------------------------------------------------- running
    def run(self) -> Dict[str, Any]:
        """Train to total_steps with crash recovery. Returns a summary."""
        if self._ckpt.latest_step() is not None:
            step, params, opt = self._restore()
        else:
            step = 0
            params, opt = self._fresh_state()

        step_fn = self._built["step"]
        while step < self.rcfg.total_steps:
            try:
                t0 = time.perf_counter()
                if self.failure_injector is not None:
                    self.failure_injector(step)
                batch = self.pipeline.global_batch_at(step)
                params, opt, metrics = step_fn(params, opt, batch)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
                dt = time.perf_counter() - t0
                self._watchdog.observe(step, dt)
                self.history.append(
                    {"step": step, "loss": loss, "time_s": dt}
                )
                step += 1
                self.pipeline.step = step
                if (
                    step % self.rcfg.checkpoint_every == 0
                    or step == self.rcfg.total_steps
                    or self._watchdog.should_escalate
                ):
                    self._save(step, params, opt)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:
                self.restarts += 1
                if self.restarts > self.rcfg.max_restarts:
                    raise
                if self._ckpt.latest_step() is not None:
                    step, params, opt = self._restore()
                else:
                    step = 0
                    params, opt = self._fresh_state()
                    self.pipeline.step = 0
        self._ckpt.wait()
        return {
            "final_step": step,
            "restarts": self.restarts,
            "losses": [h["loss"] for h in self.history],
            "straggler_events": len(self._watchdog.events),
        }
