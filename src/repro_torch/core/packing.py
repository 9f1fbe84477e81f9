"""Bit-packing and popcount utilities for binary codes.

Conventions
-----------
- A *code* is a p-bit binary vector. Bit ``j`` of code ``i`` lives in word
  ``j // word_bits`` at bit position ``j % word_bits`` (LSB-first).
- Host-side packed arrays use ``uint32`` words. The device side views the
  same bytes as ``int32`` tensors (torch has no full ``uint32`` arithmetic),
  so a buffer crosses to the card without conversion.
- ``W = ceil(p / 32)`` words per code. Trailing bits of the last word are 0.
"""

from __future__ import annotations

import numpy as np

WORD_BITS = 32
WORD_DTYPE = np.uint32


def n_words(p: int) -> int:
    return (p + WORD_BITS - 1) // WORD_BITS


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack a (n, p) {0,1} array into (n, W) uint32 words (LSB-first)."""
    bits = np.asarray(bits)
    if bits.ndim == 1:
        return pack_bits(bits[None, :])[0]
    n, p = bits.shape
    W = n_words(p)
    padded = np.zeros((n, W * WORD_BITS), dtype=np.uint8)
    padded[:, :p] = bits.astype(np.uint8) & 1
    # (n, W, 32) -> weight by bit position -> sum
    grouped = padded.reshape(n, W, WORD_BITS).astype(np.uint64)
    weights = (np.uint64(1) << np.arange(WORD_BITS, dtype=np.uint64))
    words = (grouped * weights).sum(axis=2)
    return words.astype(WORD_DTYPE)


def unpack_bits(words: np.ndarray, p: int) -> np.ndarray:
    """Unpack (n, W) uint32 words into (n, p) uint8 bits."""
    words = np.asarray(words, dtype=WORD_DTYPE)
    if words.ndim == 1:
        return unpack_bits(words[None, :], p)[0]
    n, W = words.shape
    shifts = np.arange(WORD_BITS, dtype=WORD_DTYPE)
    bits = (words[:, :, None] >> shifts[None, None, :]) & WORD_DTYPE(1)
    return bits.reshape(n, W * WORD_BITS)[:, :p].astype(np.uint8)


def popcount(words: np.ndarray) -> np.ndarray:
    """Per-row popcount of packed codes: (n, W) -> (n,) int64."""
    return np.bitwise_count(np.asarray(words)).sum(axis=-1).astype(np.int64)


def hamming_tuples(q_words: np.ndarray, db_words: np.ndarray):
    """Exact Hamming-distance tuples (Definition 1) of every db code vs q.

    Returns (r_1to0, r_0to1) as int64 arrays of shape (n,):
      r_1to0 = #bits 1 in q and 0 in b  = popcount(q & ~b)
      r_0to1 = #bits 0 in q and 1 in b  = popcount(~q & b)

    Trailing pad bits are zero in both q and b, so ``~q & b`` is unaffected
    and ``q & ~b`` is unaffected (q pad bits are 0).
    """
    q = np.asarray(q_words, dtype=WORD_DTYPE)
    b = np.asarray(db_words, dtype=WORD_DTYPE)
    r10 = np.bitwise_count(q & ~b).sum(axis=-1).astype(np.int64)
    r01 = np.bitwise_count(~q & b).sum(axis=-1).astype(np.int64)
    return r10, r01


def codes_to_ints(words: np.ndarray, p: int) -> np.ndarray:
    """Packed (n, W) codes -> python-int-exact uint64 values. Requires p <= 64."""
    if p > 64:
        raise ValueError(f"codes_to_ints requires p <= 64, got {p}")
    words = np.asarray(words, dtype=np.uint64)
    if words.ndim == 1:
        words = words[None, :]
    vals = words[:, 0].copy()
    if words.shape[1] > 1:
        vals |= words[:, 1] << np.uint64(32)
    return vals


def ints_to_codes(vals: np.ndarray, p: int) -> np.ndarray:
    """Inverse of codes_to_ints: uint64 values -> (n, W) uint32 words."""
    vals = np.asarray(vals, dtype=np.uint64)
    W = n_words(p)
    out = np.zeros((vals.shape[0], W), dtype=WORD_DTYPE)
    out[:, 0] = (vals & np.uint64(0xFFFFFFFF)).astype(WORD_DTYPE)
    if W > 1:
        out[:, 1] = (vals >> np.uint64(32)).astype(WORD_DTYPE)
    return out


def extract_substring(words: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Extract bit range [lo, hi) of each packed code as uint64 values.

    Requires hi - lo <= 64. Vectorized over rows.
    """
    w = hi - lo
    if w > 64:
        raise ValueError("substring wider than 64 bits")
    words = np.asarray(words, dtype=WORD_DTYPE)
    if words.ndim == 1:
        words = words[None, :]
    n, W = words.shape
    # Place each overlapping word directly at its offset in the RESULT
    # (offset = 32k - shift). Building a pre-shift window would need up to
    # 65 bits when shift > 0 and w == 64 — a uint64 shift by >= 64 is UB.
    first = lo // WORD_BITS
    shift = lo - first * WORD_BITS
    vals = np.zeros(n, dtype=np.uint64)
    nw = (w + shift + WORD_BITS - 1) // WORD_BITS
    for k in range(nw):
        idx = first + k
        if idx >= W:
            break
        w64 = words[:, idx].astype(np.uint64)
        off = 32 * k - shift
        if off >= 64:
            break
        if off >= 0:
            vals |= w64 << np.uint64(off)
        else:
            vals |= w64 >> np.uint64(-off)
    if w < 64:
        vals &= (np.uint64(1) << np.uint64(w)) - np.uint64(1)
    return vals


def substring_spans(p: int, m: int):
    """Split p bits into m near-equal contiguous spans [(lo, hi), ...].

    The first ``p % m`` spans get one extra bit, mirroring the MIH convention.
    """
    if not 1 <= m <= p:
        raise ValueError(f"need 1 <= m <= p, got m={m}, p={p}")
    base = p // m
    extra = p % m
    spans = []
    lo = 0
    for s in range(m):
        w = base + (1 if s < extra else 0)
        spans.append((lo, lo + w))
        lo += w
    assert lo == p
    return spans
