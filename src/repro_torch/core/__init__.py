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
from .linear_scan import (
    linear_scan_knn,
    sims_against_db,
    sims_batch_against_db,
    sims_for_ids,
    topk_from_sims,
)
from .packing import (
    hamming_tuples,
    n_words,
    pack_bits,
    popcount,
    substring_spans,
    unpack_bits,
)
from .probing import closed_form_prefix, probing_sequence
from .single_table import SearchStats, SingleTableIndex
from .tuples import rhat, sim_value, tuple_count

__all__ = [
    "AMIHIndex",
    "AMIHStats",
    "ENGINES",
    "EngineStats",
    "SearchEngine",
    "SearchStats",
    "SingleTableIndex",
    "available_backends",
    "closed_form_prefix",
    "default_num_tables",
    "hamming_tuples",
    "linear_scan_knn",
    "make_engine",
    "n_words",
    "pack_bits",
    "popcount",
    "probing_sequence",
    "rhat",
    "sim_value",
    "sims_against_db",
    "sims_batch_against_db",
    "sims_for_ids",
    "substring_spans",
    "topk_from_sims",
    "tuple_count",
    "unpack_bits",
]
