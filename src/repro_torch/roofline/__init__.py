"""Roofline analysis of the port's steps on one card (the reference's
``roofline`` package; no hardware needed to count).

``hlo_parse``   the reference's structural parser of optimized HLO text
                (a copy), and ``HloCosts``, the per-device cost record.
``counter``     the port's counterpart of compiling a step and parsing
                it: one train, prefill or decode step run on ``meta``
                tensors under a dispatch mode that counts FLOPs, HBM
                bytes by scope and the peak of live storages.
``analysis``    the three roofline terms + dominant-bottleneck report,
                at the NVIDIA H100's data-sheet rates.
``model_flops`` analytic MODEL_FLOPS (6ND / 2ND / decode) per architecture.
"""

from .analysis import HW, RooflineReport, analyze
from .hlo_parse import HloCosts, parse_hlo_costs
from .model_flops import model_flops

__all__ = [
    "HW",
    "HloCosts",
    "RooflineReport",
    "analyze",
    "model_flops",
    "parse_hlo_costs",
]
