"""The port's LM zoo (``common``, ``layers``, ``blocks``, ``lm``,
``encdec``, ``ssm``, ``moe``, ``api``): every family of the reference,
the retrieval encoder's forward, the scoring forward, the loss and its
gradient, prefill and the decode step, with attention through K7; and
the shape registry (``SHAPES``, ``shape_applicable``, ``input_specs``)."""

from .api import Model, input_specs
from .common import SHAPES, ArchConfig, ShapeConfig, shape_applicable

__all__ = [
    "ArchConfig",
    "Model",
    "SHAPES",
    "ShapeConfig",
    "input_specs",
    "shape_applicable",
]
