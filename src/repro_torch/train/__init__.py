"""Training runtime of the port: step construction, the fault-tolerant
loop, the straggler watchdog (the reference's ``repro.train``)."""

from .step import TrainConfig, make_serve_step, make_train_step
from .loop import Trainer, TrainerConfig
from .watchdog import StragglerWatchdog

__all__ = [
    "StragglerWatchdog",
    "TrainConfig",
    "Trainer",
    "TrainerConfig",
    "make_serve_step",
    "make_train_step",
]
