"""Seeded synthetic binary codes and queries (numpy)."""

from .synthetic import (
    synthetic_binary_codes,
    synthetic_binary_codes_packed,
    synthetic_queries,
    synthetic_queries_packed,
)

__all__ = [
    "synthetic_binary_codes",
    "synthetic_binary_codes_packed",
    "synthetic_queries",
    "synthetic_queries_packed",
]
