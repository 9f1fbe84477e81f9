"""Bucket-index enumeration for a tuple (Eq. 4 support).

Given a query substring value ``q`` (as a python int over ``w`` bits with
``z`` ones), the codes at exactly tuple ``(a, b)`` are obtained by flipping
``a`` of the one-bits and ``b`` of the zero-bits:

    { q ^ (m1 | m0) : m1 in C(ones(q), a), m0 in C(zeros(q), b) }

There are C(z, a) * C(w - z, b) of them (Eq. 4). Enumeration cost is linear
in the output size; AMIH keeps a, b small so this never explodes, but a
safety ``cap`` is enforced and surfaced to the caller.
"""

from __future__ import annotations

import math
import threading
from itertools import combinations
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "EnumerationCapExceeded",
    "bit_positions",
    "combination_indices",
    "combination_masks",
    "tuple_bucket_values",
]


class EnumerationCapExceeded(ValueError):
    """A tuple's bucket enumeration would exceed the caller's cap.

    Subclasses ValueError for backward compatibility; callers that fall
    back to scanning catch THIS type so unrelated ValueErrors surface."""


def bit_positions(value: int, width: int) -> List[int]:
    """Positions (LSB-first) of set bits of ``value`` within ``width`` bits."""
    return [j for j in range(width) if (value >> j) & 1]


# Canonical k-out-of-n index combinations, cached process-wide: both the
# host bucket enumeration and the device probe schedule expand the same
# C(n, k) tables (in itertools.combinations order), so they are built once
# and shared. Entries are tiny (C(16, 4) = 1820 rows of k int8s) and the
# (n, k) key space is small; no eviction needed.
_COMBO_CACHE: Dict[Tuple[int, int], np.ndarray] = {}
_COMBO_LOCK = threading.Lock()


def combination_indices(n: int, k: int) -> np.ndarray:
    """All C(n, k) combinations of k indices out of range(n), as a
    (C(n, k), max(k, 1)) int8 array in ``itertools.combinations`` order
    (k == 0 yields one all-padding row). Cached; treat as read-only."""
    with _COMBO_LOCK:
        out = _COMBO_CACHE.get((n, k))
        if out is None:
            cnt = math.comb(n, k)
            out = np.fromiter(
                (j for combo in combinations(range(n), k) for j in combo),
                dtype=np.int8,
                count=cnt * k,
            ).reshape(cnt, k) if k else np.zeros((1, 1), dtype=np.int8)
            out.setflags(write=False)
            _COMBO_CACHE[(n, k)] = out
    return out


def combination_masks(positions: List[int], k: int) -> np.ndarray:
    """All C(len(positions), k) OR-masks of k distinct positions, uint64.

    Vectorized through the shared ``combination_indices`` table: the
    canonical index rows gather per-position bit values and OR-reduce,
    replacing the old per-combination Python loop on the probe hot path."""
    n = len(positions)
    if k == 0:
        return np.zeros(1, dtype=np.uint64)
    if k > n:
        return np.empty(0, dtype=np.uint64)
    pos_bits = np.array(
        [1 << int(pos) for pos in positions], dtype=np.uint64
    )
    idx = combination_indices(n, k)
    return np.bitwise_or.reduce(pos_bits[idx.astype(np.intp)], axis=1)


def tuple_bucket_values(
    q_value: int,
    width: int,
    z: int,
    a: int,
    b: int,
    cap: Optional[int] = None,
) -> np.ndarray:
    """All bucket indices at exactly tuple (a, b) from the query substring.

    Returns a uint64 array of length C(z, a) * C(width - z, b).
    Raises ValueError if the count exceeds ``cap`` (guard against probing
    blowup; AMIH's tuple schedule keeps a+b <= floor(r/m) so this is small).
    """
    if not (0 <= a <= z and 0 <= b <= width - z):
        return np.empty(0, dtype=np.uint64)
    count = math.comb(z, a) * math.comb(width - z, b)
    if cap is not None and count > cap:
        raise EnumerationCapExceeded(
            f"bucket enumeration for tuple ({a},{b}) on width={width}, z={z} "
            f"would produce {count} > cap={cap} buckets"
        )
    ones = bit_positions(q_value, width)
    zeros = [j for j in range(width) if not (q_value >> j) & 1]
    m1 = combination_masks(ones, a)          # flip 1 -> 0
    m0 = combination_masks(zeros, b)         # flip 0 -> 1
    masks = (m1[:, None] | m0[None, :]).reshape(-1)
    return np.uint64(q_value) ^ masks
