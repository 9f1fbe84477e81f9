"""Row-sharded angular search: the DB's rows split over devices (a port of
the reference's ``shard/distributed.py``).

A query batch broadcast to every shard runs the fused K4 top-K
(``ops.scan_topk``) over that shard's rows on the shard's own device, and
only the O(B * k) partials cross back — no code ever moves. Where the
reference runs one ``shard_map`` launch and all-gathers the partials over
the mesh, the port loops over the plan's devices: each shard's call is
queued on its device's current stream without waiting, and the partials
are gathered afterwards.

Two merge shapes:

  - ``sharded_scan_topk``: gather + re-select the global top-K (float32
    scores, ties to the lowest id) on the first shard's device — the
    retrieval-step path (``make_retrieval_step``).
  - ``sharded_scan_candidates``: gather WITHOUT the final re-selection,
    returning every shard's top-``k_fetch`` (global ids, -1 in invalid
    slots) as host arrays. The sharded scan engine reranks this pool in
    exact float64 in the reference's lexsort order, so its results stay
    bit-identical to ``linear_scan_knn``; pad rows of a ShardPlan layout
    are masked on the device (``scan_topk``'s ``n_valid``), so uneven N
    never leaks zero-code pads into the pool.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from .plan import ShardPlan, devices_from_mesh, resolve_mesh_axes

__all__ = [
    "make_retrieval_step",
    "place_shards",
    "sharded_scan_candidates",
    "sharded_scan_topk",
]


def place_shards(plan: ShardPlan, db_words: np.ndarray) -> List[torch.Tensor]:
    """Each shard's rows as an int32 tensor on its plan device, padded to
    ``rows_padded`` with zero-code rows (the layout
    ``sharded_scan_candidates`` masks with ``n_valid``)."""
    out = []
    R = plan.rows_padded
    for s in range(plan.num_shards):
        rows = np.asarray(db_words)[plan.shard_slice(s)]
        if rows.shape[0] < R:
            pad = np.zeros((R,) + rows.shape[1:], dtype=rows.dtype)
            pad[: rows.shape[0]] = rows
            rows = pad
        out.append(ops.to_device(rows, ops.resolve_device(
            plan.device_for(s))))
    return out


def _queries_on(q_words, devices) -> dict:
    """The query batch once per distinct device."""
    out = {}
    for dev in devices:
        key = ops.device_key(dev)
        if key not in out:
            out[key] = (q_words.to(dev) if isinstance(q_words, torch.Tensor)
                        else ops.to_device(q_words, dev))
    return out


def sharded_scan_candidates(
    plan: ShardPlan,
    q_words,
    shard_words: Sequence[torch.Tensor],
    k_fetch: int,
    *,
    chunk: int = 1 << 16,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-shard top-``k_fetch`` pools, gathered but NOT re-selected.

    ``shard_words[s]`` is shard ``s``'s padded (rows_padded, W) int32
    codes on its plan device (``place_shards``); each shard's fused K4
    call masks its pad rows via the plan's ``counts`` (``n_valid``) and
    maps local rows to global ids via ``starts``. Every call is queued
    before any result is read. Returns host arrays (sims (B, S * k_fetch)
    float32, gids (B, S * k_fetch) int64) with sim = -inf / gid = -1 in
    invalid slots — the host-rerank candidate pool of the sharded_scan
    engine."""
    if len(shard_words) != plan.num_shards:
        raise ValueError(f"{len(shard_words)} shard arrays for a plan of "
                         f"{plan.num_shards} shards")
    qs = _queries_on(q_words, [t.device for t in shard_words])
    parts = []
    for s, words in enumerate(shard_words):
        sims, ids = ops.scan_topk(
            qs[ops.device_key(words.device)], words,
            min(k_fetch, words.shape[0]), chunk=chunk,
            n_valid=plan.counts[s],
        )
        parts.append((sims, ids))
    sims_parts, gid_parts = [], []
    for s, (sims, ids) in enumerate(parts):
        sims = sims.cpu().numpy()
        gids = ids.cpu().numpy().astype(np.int64)
        sims_parts.append(sims)
        gid_parts.append(np.where(sims > -np.inf, gids + plan.starts[s], -1))
    return np.concatenate(sims_parts, axis=1), np.concatenate(gid_parts,
                                                              axis=1)


def sharded_scan_topk(
    mesh,
    q_words,
    db_words,
    k: int,
    *,
    chunk: int = 1 << 16,
    shard_axes: Optional[Tuple[str, ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact global angular top-K with the DB row-sharded over a
    ``DeviceMesh`` (``plan.make_device_mesh``).

    q_words: (B, W) packed queries; db_words: (N, W) packed codes (host
    array or tensor) with N divisible by the number of shards (pad the DB
    with zero codes otherwise). Each shard's fused K4 top-K runs on its
    mesh device; the (B, k) partials are gathered on the first shard's
    device and re-selected there. Returns (sims (B, k) float32, ids (B, k)
    int32), ties to the lowest id.

    ``shard_axes`` defaults to every mesh axis (the scan is row-parallel,
    so no axis needs to sit idle)."""
    axes, n_shards = resolve_mesh_axes(mesh, shard_axes)
    devices = devices_from_mesh(mesh, axes)
    db = db_words.cpu().numpy() if isinstance(db_words, torch.Tensor) \
        else np.asarray(db_words)
    N = db.shape[0]
    if N % n_shards:
        raise ValueError(f"N={N} rows do not divide into {n_shards} shards")
    rows = N // n_shards
    qs = _queries_on(q_words, devices)
    parts = []
    for s, dev in enumerate(devices):
        shard = ops.to_device(db[s * rows : (s + 1) * rows], dev)
        sims, ids = ops.scan_topk(qs[ops.device_key(dev)], shard,
                                  min(k, rows), chunk=chunk)
        parts.append((sims, ids + s * rows))
    home = devices[0]
    all_sims = torch.cat([p[0].to(home) for p in parts], dim=1)
    all_ids = torch.cat([p[1].to(home) for p in parts], dim=1)
    return ops.merge_topk(all_sims, all_ids, k)


def make_retrieval_step(
    mesh,
    k: int,
    chunk: int = 1 << 16,
    shard_axes: Optional[Tuple[str, ...]] = None,
):
    """The retrieval step for serving: ``(retrieval_step, devices)``,
    where ``retrieval_step(q_words, db_words)`` is ``sharded_scan_topk``
    over ``mesh`` and ``devices`` lists the shard devices the DB rows are
    split over, in shard order (the placement the reference expresses as
    input shardings)."""
    if shard_axes is None:
        shard_axes = tuple(mesh.axis_names)

    def retrieval_step(q_words, db_words):
        return sharded_scan_topk(
            mesh, q_words, db_words, k, chunk=chunk, shard_axes=shard_axes
        )

    return retrieval_step, devices_from_mesh(mesh, shard_axes)
