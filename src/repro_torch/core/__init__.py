"""Exact angular KNN over binary codes: the port's core.

Numpy modules copied from the reference (packing, tuples, enumeration,
probing, linear_scan) plus the AMIH index, the device probing path and
the engine registry.
"""

from .amih import AMIHIndex, AMIHStats, default_num_tables
from .engine import (
    ENGINES,
    EngineStats,
    SearchEngine,
    available_backends,
    make_engine,
)
from .linear_scan import linear_scan_knn, sims_for_ids
from .packing import n_words, pack_bits, popcount, unpack_bits

__all__ = [
    "AMIHIndex",
    "AMIHStats",
    "ENGINES",
    "EngineStats",
    "SearchEngine",
    "available_backends",
    "default_num_tables",
    "linear_scan_knn",
    "make_engine",
    "n_words",
    "pack_bits",
    "popcount",
    "sims_for_ids",
    "unpack_bits",
]
