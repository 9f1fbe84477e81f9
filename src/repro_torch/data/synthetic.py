"""Synthetic datasets for the retrieval experiments (paper §6).

The paper evaluates on SIFT (10^6–10^9 128-D descriptors) and TRC2
(word-count vectors). Neither raw dataset ships with the repo, so the
benchmarks use deterministic synthetic stand-ins with matched statistics:

- ``clustered_features``: non-negative, heavy-tailed, cluster-structured
  vectors (SIFT-like: gradients histograms are non-negative and clumpy;
  TRC2-like: word counts are non-negative and sparse). Cluster structure is
  what gives hashing/LSH methods non-trivial recall curves — i.i.d. data
  would make every method look artificially bad.
- ``synthetic_binary_codes``: codes drawn either uniformly or by planting
  near-duplicate clusters, for exercising AMIH directly in binary space.

All generation is seeded and reproducible.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "clustered_features",
    "synthetic_binary_codes",
    "synthetic_binary_codes_packed",
    "synthetic_queries",
    "synthetic_queries_packed",
]


def clustered_features(
    n: int,
    dim: int = 128,
    n_clusters: int = 64,
    seed: int = 0,
    noise: float = 0.25,
) -> np.ndarray:
    """Non-negative cluster-structured feature vectors, (n, dim) float32."""
    rng = np.random.default_rng(seed)
    centers = rng.gamma(shape=2.0, scale=1.0, size=(n_clusters, dim))
    assign = rng.integers(0, n_clusters, n)
    x = centers[assign] + noise * rng.gamma(2.0, 1.0, size=(n, dim))
    return np.maximum(x, 0.0).astype(np.float32)


def synthetic_binary_codes(
    n: int,
    p: int,
    seed: int = 0,
    mode: str = "clustered",
    n_clusters: int = 256,
    flip_prob: float = 0.08,
) -> np.ndarray:
    """(n, p) uint8 binary dataset.

    mode='uniform':   i.i.d. Bernoulli(1/2) bits (worst case for hashing).
    mode='clustered': cluster centers with per-bit flip noise — matches the
                      hashed-descriptor regime the paper targets (AQBC codes
                      of natural data are highly clustered).
    """
    rng = np.random.default_rng(seed)
    if mode == "uniform":
        return (rng.random((n, p)) < 0.5).astype(np.uint8)
    centers = (rng.random((n_clusters, p)) < 0.5).astype(np.uint8)
    assign = rng.integers(0, n_clusters, n)
    flips = (rng.random((n, p)) < flip_prob).astype(np.uint8)
    return centers[assign] ^ flips


def synthetic_queries(
    db_bits: np.ndarray,
    n_queries: int,
    seed: int = 1,
    flip_prob: float = 0.05,
) -> np.ndarray:
    """Queries near dataset items (realistic ANN workload): perturb random
    db rows by i.i.d. bit flips."""
    rng = np.random.default_rng(seed)
    n, p = db_bits.shape
    rows = rng.integers(0, n, n_queries)
    flips = (rng.random((n_queries, p)) < flip_prob).astype(np.uint8)
    return db_bits[rows] ^ flips


# ------------------------------------------------------------ packed, chunked
# At n = 10^7 and p = 128 the (n, p) float64 draw of ``synthetic_binary_codes``
# is 10 GB. The packed generators below draw the SAME random stream in row
# chunks (numpy's Generator fills ``random((c, p))`` in C order, so chunked
# draws concatenate to the one-shot draw) and pack each chunk at once: the
# result equals ``pack_bits(synthetic_binary_codes(...))`` bit for bit while
# peak scratch stays O(chunk_rows * p).

def _pack_rows(bits: np.ndarray) -> np.ndarray:
    """(c, p) {0,1} -> (c, ceil(p/32)) uint32 words, LSB-first (as
    ``core.packing.pack_bits``)."""
    c, p = bits.shape
    W = (p + 31) // 32
    by = np.packbits(bits.astype(np.uint8, copy=False), axis=1,
                     bitorder="little")
    if by.shape[1] != 4 * W:
        by = np.concatenate(
            [by, np.zeros((c, 4 * W - by.shape[1]), dtype=np.uint8)], axis=1
        )
    return np.ascontiguousarray(by).view("<u4").astype(np.uint32, copy=False)


def synthetic_binary_codes_packed(
    n: int,
    p: int,
    seed: int = 0,
    mode: str = "clustered",
    n_clusters: int = 256,
    flip_prob: float = 0.08,
    chunk_rows: int = 1 << 20,
) -> np.ndarray:
    """``pack_bits(synthetic_binary_codes(n, p, ...))`` as (n, W) uint32,
    generated chunk by chunk."""
    rng = np.random.default_rng(seed)
    W = (p + 31) // 32
    out = np.empty((n, W), dtype=np.uint32)
    if mode == "uniform":
        for lo in range(0, n, chunk_rows):
            c = min(chunk_rows, n - lo)
            out[lo : lo + c] = _pack_rows(rng.random((c, p)) < 0.5)
        return out
    centers = _pack_rows(rng.random((n_clusters, p)) < 0.5)
    assign = rng.integers(0, n_clusters, n)
    for lo in range(0, n, chunk_rows):
        c = min(chunk_rows, n - lo)
        flips = _pack_rows(rng.random((c, p)) < flip_prob)
        out[lo : lo + c] = centers[assign[lo : lo + c]] ^ flips
    return out


def synthetic_queries_packed(
    db_words: np.ndarray,
    p: int,
    n_queries: int,
    seed: int = 1,
    flip_prob: float = 0.05,
) -> np.ndarray:
    """``pack_bits(synthetic_queries(db_bits, ...))`` straight from the
    packed database: the same rows and flips, never unpacking the DB."""
    rng = np.random.default_rng(seed)
    n = db_words.shape[0]
    rows = rng.integers(0, n, n_queries)
    flips = _pack_rows(rng.random((n_queries, p)) < flip_prob)
    return np.asarray(db_words, dtype=np.uint32)[rows] ^ flips
