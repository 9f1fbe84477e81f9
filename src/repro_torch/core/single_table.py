"""Single-hash-table exact angular KNN (paper §4, RQ1).

The hash "table" is stored cache-friendly as a CSR-style sorted array:
codes sorted by integer value with their ids. Probing a bucket is a binary
search returning a contiguous id range — batched over all bucket indices of
one tuple with ``np.searchsorted``. The probing *order* is exactly the
paper's.

Practical only for short codes (p <= ~32, the paper's own observation);
AMIH (amih.py) is the long-code solution. Host code, a copy of the
reference's ``core/single_table.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from .enumeration import tuple_bucket_values
from .packing import WORD_DTYPE, codes_to_ints, popcount
from .probing import probing_sequence
from .tuples import sim_value

__all__ = ["SingleTableIndex", "SearchStats"]


@dataclass
class SearchStats:
    """Counters mirroring the paper's cost accounting."""

    probes: int = 0            # bucket lookups performed
    retrieved: int = 0         # ids pulled out of buckets (incl. duplicates)
    tuples_processed: int = 0  # Hamming-distance tuples traversed
    max_radius: int = 0        # largest Hamming distance reached
    exceeded_rhat: bool = False
    # Set by SingleTableEngine when a tuple's bucket enumeration exceeded
    # the cap and the query degraded to an exact linear scan (the paper's
    # §5 observation, applied to the single table).
    fell_back_to_scan: bool = False


@dataclass
class SingleTableIndex:
    """Exact angular KNN over one table of p-bit codes (p <= 64)."""

    p: int
    sorted_vals: np.ndarray = field(repr=False)   # (n,) uint64, ascending
    sorted_ids: np.ndarray = field(repr=False)    # (n,) int64

    @classmethod
    def build(cls, db_words: np.ndarray, p: int) -> "SingleTableIndex":
        if p > 64:
            raise ValueError("SingleTableIndex supports p <= 64; use AMIH")
        vals = codes_to_ints(db_words, p)
        order = np.argsort(vals, kind="stable")
        return cls(p=p, sorted_vals=vals[order], sorted_ids=np.arange(len(vals))[order])

    @property
    def n(self) -> int:
        return self.sorted_vals.shape[0]

    def probe_buckets(self, bucket_vals: np.ndarray) -> np.ndarray:
        """ids stored in any of the given buckets (batched binary search)."""
        if bucket_vals.size == 0:
            return np.empty(0, dtype=np.int64)
        lo = np.searchsorted(self.sorted_vals, bucket_vals, side="left")
        hi = np.searchsorted(self.sorted_vals, bucket_vals, side="right")
        counts = hi - lo
        nz = counts > 0
        if not nz.any():
            return np.empty(0, dtype=np.int64)
        parts = [self.sorted_ids[l:h] for l, h in zip(lo[nz], hi[nz])]
        return np.concatenate(parts)

    def knn(
        self,
        q_words: np.ndarray,
        k: int,
        stats: Optional[SearchStats] = None,
        enumeration_cap: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact angular KNN: probe buckets tuple-by-tuple in sim order.

        Returns (ids, sims) with len == min(k, n); deterministic up to ties
        within the final tuple (codes in one tuple are exactly equidistant).
        """
        from .tuples import rhat  # local import to keep module deps acyclic

        q_words = np.asarray(q_words, dtype=WORD_DTYPE)
        q_val = int(codes_to_ints(q_words[None, :], self.p)[0])
        z = int(popcount(q_words[None, :])[0])
        k = min(k, self.n)
        out_ids: list = []
        out_sims: list = []
        r_hat = rhat(z)
        for (r1, r2) in probing_sequence(self.p, z):
            if stats is not None:
                stats.tuples_processed += 1
                stats.max_radius = max(stats.max_radius, r1 + r2)
                if r1 + r2 > r_hat:
                    stats.exceeded_rhat = True
            buckets = tuple_bucket_values(
                q_val, self.p, z, r1, r2, cap=enumeration_cap
            )
            if stats is not None:
                stats.probes += len(buckets)
            ids = self.probe_buckets(buckets)
            if stats is not None:
                stats.retrieved += len(ids)
            if ids.size:
                s = sim_value(self.p, z, r1, r2)
                take = min(ids.size, k - len(out_ids))
                ids_sorted = np.sort(ids)  # deterministic tie order
                out_ids.extend(ids_sorted[:take].tolist())
                out_sims.extend([s] * take)
            if len(out_ids) >= k:
                break
        return np.asarray(out_ids, dtype=np.int64), np.asarray(out_sims)
