"""Data substrate of the port (numpy copies of the reference's
``repro.data``): the deterministic, shard-aware, checkpointable token
pipeline, and seeded synthetic features, binary codes and queries (with
chunked ``_packed`` generators for codes at n = 10^7)."""

from .pipeline import DataConfig, TokenPipeline
from .synthetic import (
    clustered_features,
    synthetic_binary_codes,
    synthetic_binary_codes_packed,
    synthetic_queries,
    synthetic_queries_packed,
)

__all__ = [
    "DataConfig",
    "TokenPipeline",
    "clustered_features",
    "synthetic_binary_codes",
    "synthetic_binary_codes_packed",
    "synthetic_queries",
    "synthetic_queries_packed",
]
