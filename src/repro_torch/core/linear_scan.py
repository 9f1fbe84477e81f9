"""Exhaustive angular KNN baseline (the paper's comparator, §6.2).

Like the paper's optimized linear scan: sims are computed from the Hamming
tuple (Eq. 3) via XOR/ANDN + popcount, norm terms come from a lookup table
over the p+1 possible code norms, and sqrt(z) of the query is dropped from
comparisons (it is query-constant).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .packing import WORD_DTYPE, hamming_tuples, popcount

__all__ = [
    "linear_scan_knn",
    "sims_against_db",
    "sims_batch_against_db",
    "sims_for_ids",
    "topk_from_sims",
]


def sims_against_db(q_words: np.ndarray, db_words: np.ndarray) -> np.ndarray:
    """Cosine sims of every db code vs one query, via Eq. 3 (float64).

    Zero-norm codes (or a zero query) get sim = 0.0 (see tuples.sim_value).
    """
    q_words = np.asarray(q_words, dtype=WORD_DTYPE)
    z = int(popcount(q_words[None, :])[0])
    r10, r01 = hamming_tuples(q_words, db_words)
    if z == 0:
        return np.zeros(r10.shape[0], dtype=np.float64)
    norm_b_sq = (z - r10 + r01).astype(np.float64)
    num = (z - r10).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        sims = num / (np.sqrt(float(z)) * np.sqrt(norm_b_sq))
    sims = np.where(norm_b_sq == 0, 0.0, sims)
    return sims


def sims_batch_against_db(
    q_words: np.ndarray, db_words: np.ndarray, chunk: int = 1 << 15
) -> np.ndarray:
    """(B, W) x (N, W) -> (B, N) float64 Eq. 3 sims, chunked over the DB
    so peak scratch stays O(B * chunk * W) regardless of N.

    Row i is elementwise-identical to ``sims_against_db(q_words[i], db)``
    (same broadcasted float ops), which is what lets batched callers reuse
    the per-query top-K selection bit-for-bit.
    """
    q = np.atleast_2d(np.asarray(q_words, dtype=WORD_DTYPE))
    db = np.asarray(db_words, dtype=WORD_DTYPE)
    B, N = q.shape[0], db.shape[0]
    z = popcount(q).astype(np.float64)                  # (B,)
    out = np.empty((B, N), dtype=np.float64)
    for lo in range(0, max(N, 1), chunk):
        blk = db[lo : lo + chunk]                       # (C, W)
        r10 = np.bitwise_count(q[:, None, :] & ~blk[None, :, :]).sum(-1)
        r01 = np.bitwise_count(~q[:, None, :] & blk[None, :, :]).sum(-1)
        norm_b_sq = (z[:, None] - r10 + r01).astype(np.float64)
        num = (z[:, None] - r10).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            sims = num / (np.sqrt(z)[:, None] * np.sqrt(norm_b_sq))
        sims = np.where(norm_b_sq == 0, 0.0, sims)
        out[:, lo : lo + chunk] = np.where(z[:, None] == 0, 0.0, sims)
    return out


def sims_for_ids(
    q_words: np.ndarray, db_words: np.ndarray, ids: np.ndarray
) -> np.ndarray:
    """Eq. 3 sims of a *subset* of db rows vs one query (float64).

    Elementwise-identical to ``sims_against_db(q, db)[ids]`` (the math is
    per-row, so gathering first changes nothing) — this is the host-side
    exact rescorer of the device top-K path: the kernel preselects
    candidate ids in float32, this recomputes their sims in float64 so the
    final output is bit-identical to ``linear_scan_knn``.
    """
    return sims_against_db(
        q_words, np.asarray(db_words, dtype=WORD_DTYPE)[ids]
    )


def topk_from_sims(sims: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic top-k of one query's sim row: sorted by (-sim, id)."""
    n = sims.shape[0]
    k = min(k, n)
    if k == n:
        idx = np.arange(n)
    else:
        idx = np.argpartition(-sims, k - 1)[:k]
    order = np.lexsort((idx, -sims[idx]))
    ids = idx[order]
    return ids, sims[ids]


def linear_scan_knn(
    q_words: np.ndarray, db_words: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact angular KNN by exhaustive scan.

    Returns (ids, sims), sorted by (-sim, id) for determinism. ``k`` is
    clamped to the dataset size.
    """
    sims = sims_against_db(q_words, db_words)
    return topk_from_sims(sims, k)
