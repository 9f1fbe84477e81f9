"""Hamming-distance-tuple arithmetic (paper §3–§4, Eq. 3, Props 1–2).

A tuple ``(r1, r2)`` relative to a query with ``z = ||q||_1`` ones out of
``p`` bits describes every code with exactly ``r1`` bits flipped 1->0 and
``r2`` bits flipped 0->1. All such codes share one cosine similarity
(Eq. 3):

    sim = (z - r1) / (sqrt(z) * sqrt(z - r1 + r2))

Ordering tuples by sim is the paper's core primitive. Floating point is
avoided for *comparisons*: since sim >= 0 on the valid domain, ordering by
sim equals ordering by

    sim^2 = (z - r1)^2 / (z * (z - r1 + r2))

which is an exact rational in small integers -> exact cross-multiplication.
"""

from __future__ import annotations

import math
from fractions import Fraction

__all__ = [
    "sim_value",
    "sim_squared_fraction",
    "sim_compare",
    "is_valid_tuple",
    "rhat",
    "tuple_count",
    "all_valid_tuples",
]


def is_valid_tuple(p: int, z: int, r1: int, r2: int) -> bool:
    """A tuple is valid iff 0 <= r1 <= z and 0 <= r2 <= p - z."""
    return 0 <= r1 <= z and 0 <= r2 <= p - z


def sim_value(p: int, z: int, r1: int, r2: int) -> float:
    """Cosine similarity for a tuple (Eq. 3). Degenerate cases -> 0.0.

    Degenerate: z == 0 (query is the zero vector) or z - r1 + r2 == 0
    (the *code* is the zero vector). Cosine is undefined there; we define
    it as 0.0 so such codes sort last, matching the convention that the
    zero vector is maximally dissimilar.
    """
    if z == 0:
        return 0.0
    norm_b_sq = z - r1 + r2
    if norm_b_sq == 0:
        return 0.0
    return (z - r1) / (math.sqrt(z) * math.sqrt(norm_b_sq))


def sim_squared_fraction(p: int, z: int, r1: int, r2: int) -> Fraction:
    """Exact sim^2 as a Fraction (valid since sim >= 0 on the domain)."""
    if z == 0:
        return Fraction(0)
    norm_b_sq = z - r1 + r2
    if norm_b_sq == 0:
        return Fraction(0)
    num = (z - r1) * (z - r1)
    den = z * norm_b_sq
    return Fraction(num, den)


def sim_compare(p: int, z: int, a: tuple, b: tuple) -> int:
    """Exact integer comparison: -1 if sim(a) < sim(b), 0 if ==, +1 if >."""
    (a1, a2), (b1, b2) = a, b
    if z == 0:
        return 0
    na, da = (z - a1) ** 2, z * (z - a1 + a2)
    nb, db = (z - b1) ** 2, z * (z - b1 + b2)
    # handle zero-vector codes (den == 0 -> sim defined as 0)
    sa_zero = da == 0
    sb_zero = db == 0
    if sa_zero and sb_zero:
        return 0
    if sa_zero:
        return -1 if nb > 0 else 0
    if sb_zero:
        return 1 if na > 0 else 0
    lhs = na * db
    rhs = nb * da
    return (lhs > rhs) - (lhs < rhs)


def tuple_count(p: int, z: int, r1: int, r2: int) -> int:
    """Number of codes at exactly tuple (r1, r2) from the query (Eq. 4)."""
    if not is_valid_tuple(p, z, r1, r2):
        return 0
    return math.comb(z, r1) * math.comb(p - z, r2)


def rhat(z: int) -> int:
    """Integer part of the positive root of r^2 + r - z (Prop. 2, t=1).

    For all radii r < rhat (strictly: while z > r(r+1)), every code inside
    the Hamming ball C(q, r) has larger sim than every code outside.
    """
    if z <= 0:
        return 0
    return (math.isqrt(4 * z + 1) - 1) // 2


def all_valid_tuples(p: int, z: int):
    """All valid tuples for (p, z) — O((z+1)(p-z+1)) of them."""
    return [(r1, r2) for r1 in range(z + 1) for r2 in range(p - z + 1)]
