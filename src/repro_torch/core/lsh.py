"""Cross-polytope LSH baselines (paper §6.3: SP-CP and MP-CP).

Approximate angular NN comparators used by the paper's Fig. 8/9 — the
FALCONN-style cross-polytope family (Andoni et al., NeurIPS 2015):

  h(x) = argmax_i [ (Gx)_1, ..., (Gx)_{d'}, -(Gx)_1, ..., -(Gx)_{d'} ]

with a fresh pseudo-random Gaussian G per hash function; ``k`` functions are
concatenated per table; ``l`` independent tables. Single-probe (SP) checks
only the query's own bucket per table; multiprobe (MP) additionally probes
buckets obtained by switching the least-confident hash coordinates to their
runner-up value, ranked by the score gap (the standard multiprobe ordering).

numpy implementation — these are baselines for benchmark comparisons, not a
production path (a copy of the reference's ``core/lsh.py``).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["CrossPolytopeLSH"]


def _hash_indices(v: np.ndarray) -> np.ndarray:
    """Cross-polytope bucket index per row: argmax over (v, -v)."""
    ext = np.concatenate([v, -v], axis=-1)
    return np.argmax(ext, axis=-1)


@dataclass
class CrossPolytopeLSH:
    l: int                         # tables
    k: int                         # concatenated hashes per table
    gs: np.ndarray = field(repr=False)       # (l, k, d, proj_dim)
    tables: List[Dict[Tuple[int, ...], np.ndarray]] = field(repr=False)
    data: np.ndarray = field(repr=False)     # normalized dataset

    @classmethod
    def build(
        cls,
        x: np.ndarray,
        l: int = 10,
        k: int = 2,
        proj_dim: int = 32,
        seed: int = 0,
    ) -> "CrossPolytopeLSH":
        rng = np.random.default_rng(seed)
        x = np.asarray(x, dtype=np.float32)
        xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        d = x.shape[1]
        gs = rng.standard_normal((l, k, d, proj_dim)).astype(np.float32)
        gs /= np.sqrt(proj_dim)
        tables: List[Dict[Tuple[int, ...], np.ndarray]] = []
        for t in range(l):
            keys = np.stack(
                [_hash_indices(xn @ gs[t, j]) for j in range(k)], axis=1
            )  # (n, k)
            table: Dict[Tuple[int, ...], List[int]] = {}
            for i, row in enumerate(map(tuple, keys)):
                table.setdefault(row, []).append(i)
            tables.append({kk: np.asarray(v) for kk, v in table.items()})
        return cls(l=l, k=k, gs=gs, tables=tables, data=xn)

    def _probe_keys(self, q: np.ndarray, t: int, n_probes: int):
        """Multiprobe key sequence for table t, best-first by score gap."""
        per_hash = []
        for j in range(self.k):
            v = q @ self.gs[t, j]
            ext = np.concatenate([v, -v])
            order = np.argsort(-ext)
            # (gap_to_best, candidate_index) for top few alternates
            gaps = ext[order[0]] - ext[order]
            per_hash.append((order, gaps))
        base = tuple(int(per_hash[j][0][0]) for j in range(self.k))
        # best-first search over per-hash alternate choices
        heap = [(0.0, tuple([0] * self.k))]
        seen = {tuple([0] * self.k)}
        out = []
        while heap and len(out) < n_probes:
            cost, alt = heapq.heappop(heap)
            key = tuple(
                int(per_hash[j][0][alt[j]]) for j in range(self.k)
            )
            out.append(key)
            for j in range(self.k):
                nxt = list(alt)
                if nxt[j] + 1 < len(per_hash[j][1]):
                    nxt[j] += 1
                    tup = tuple(nxt)
                    if tup not in seen:
                        seen.add(tup)
                        delta = (
                            per_hash[j][1][nxt[j]]
                            - per_hash[j][1][nxt[j] - 1]
                        )
                        heapq.heappush(heap, (cost + float(delta), tup))
        return out

    def query(
        self, q: np.ndarray, k_neighbors: int = 1, probes_per_table: int = 1
    ) -> np.ndarray:
        """Approximate angular KNN: candidate union -> exact rerank.

        probes_per_table = 1 is SP-CP; > 1 is MP-CP.
        """
        q = np.asarray(q, dtype=np.float32)
        qn = q / max(float(np.linalg.norm(q)), 1e-12)
        cands: List[np.ndarray] = []
        for t in range(self.l):
            for key in self._probe_keys(qn, t, probes_per_table):
                hit = self.tables[t].get(key)
                if hit is not None:
                    cands.append(hit)
        if not cands:
            return np.empty(0, dtype=np.int64)
        ids = np.unique(np.concatenate(cands))
        sims = self.data[ids] @ qn
        order = np.argsort(-sims, kind="stable")[:k_neighbors]
        return ids[order]
