"""Deterministic, shard-aware, checkpointable token pipeline (a numpy
copy of the reference's ``data/pipeline.py``).

Production posture: each host process reads only the examples assigned to
its data shard (``shard_id`` of ``num_shards``); the stream is a pure
function of (seed, step) via counter-based hashing, so

  - restarts are bit-exact: restoring ``state_dict()`` resumes mid-epoch
    without replay,
  - elastic re-sharding is exact: a host joining with a different
    (shard_id, num_shards) still sees a disjoint, complete partition,
  - no host ever materializes the global batch.

The "dataset" is a deterministic synthetic LM corpus: a fixed mixture of
Zipfian unigram draws and repeated-motif spans (so models have learnable
structure and losses visibly fall — used by the train examples/tests).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "TokenPipeline"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # unigram skew
    motif_len: int = 16          # repeated-span length (learnable structure)
    motif_prob: float = 0.5      # fraction of rows carrying a motif


def _philox(counters: np.ndarray, seed: int) -> np.ndarray:
    """Counter-based pseudo-random uint64 stream (stateless, vectorized).

    splitmix64 over (counter ^ seed) — deterministic across hosts and
    restores without carrying RNG state.
    """
    x = (counters.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)) ^ np.uint64(seed)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class TokenPipeline:
    """Iterator of per-shard batches: dict(tokens=(B_local, S) int32).

    B_local = global_batch // num_shards. The stream position is one
    integer (``step``); ``state_dict``/``load_state_dict`` checkpoint it.
    """

    def __init__(
        self,
        cfg: DataConfig,
        shard_id: int = 0,
        num_shards: int = 1,
        start_step: int = 0,
    ):
        if cfg.global_batch % num_shards:
            raise ValueError(
                f"global_batch={cfg.global_batch} not divisible by "
                f"num_shards={num_shards}"
            )
        self.cfg = cfg
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.step = start_step
        self._local_batch = cfg.global_batch // num_shards
        # Zipfian unigram table (shared, deterministic)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._cdf = np.cumsum(probs / probs.sum())

    # ------------------------------------------------------------- state
    def state_dict(self) -> Dict[str, int]:
        return {
            "step": self.step,
            "seed": self.cfg.seed,
            "shard_id": self.shard_id,
            "num_shards": self.num_shards,
        }

    def load_state_dict(self, state: Dict[str, int]) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError("checkpoint seed mismatch")
        # shard geometry may legally change on elastic resize; only the
        # global step must carry over.
        self.step = int(state["step"])

    # ------------------------------------------------------------ batches
    def _row_tokens(self, row_counters: np.ndarray) -> np.ndarray:
        """(R,) uint64 row ids -> (R, S) int32 tokens, fully vectorized."""
        cfg = self.cfg
        R, S = row_counters.shape[0], cfg.seq_len
        # one u64 per (row, position)
        pos = np.arange(S, dtype=np.uint64)[None, :]
        ctr = row_counters[:, None] * np.uint64(1_000_003) + pos
        u = _philox(ctr, cfg.seed)
        uni = (u >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        tokens = np.searchsorted(self._cdf, uni).astype(np.int32)
        tokens = np.clip(tokens, 0, cfg.vocab_size - 1)
        # motif rows: overwrite a span with a periodic repetition
        hrow = _philox(row_counters, cfg.seed ^ 0xABCDEF)
        has_motif = (hrow % np.uint64(1000)) < np.uint64(
            int(cfg.motif_prob * 1000)
        )
        if cfg.motif_len > 0 and S >= 2 * cfg.motif_len:
            start = (hrow % np.uint64(max(1, S - 2 * cfg.motif_len))).astype(
                np.int64
            )
            motif_tok = (hrow % np.uint64(cfg.vocab_size)).astype(np.int32)
            for r in np.flatnonzero(has_motif):
                s0 = int(start[r])
                motif = (
                    motif_tok[r]
                    + np.arange(cfg.motif_len, dtype=np.int32)
                ) % cfg.vocab_size
                tokens[r, s0 : s0 + 2 * cfg.motif_len] = np.concatenate(
                    [motif, motif]
                )
        return tokens

    def next_batch(self) -> Dict[str, np.ndarray]:
        """The shard's slice of global batch ``self.step`` (advances step)."""
        cfg = self.cfg
        base = np.uint64(self.step) * np.uint64(cfg.global_batch)
        rows = base + np.uint64(self.shard_id * self._local_batch) + np.arange(
            self._local_batch, dtype=np.uint64
        )
        tokens = self._row_tokens(rows)
        self.step += 1
        return {"tokens": tokens}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    # -------------------------------------------------- global batch view
    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The FULL batch of one step (tests / single-host training)."""
        cfg = self.cfg
        base = np.uint64(step) * np.uint64(cfg.global_batch)
        rows = base + np.arange(cfg.global_batch, dtype=np.uint64)
        return {"tokens": self._row_tokens(rows)}
