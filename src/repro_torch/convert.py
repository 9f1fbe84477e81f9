"""Carry the reference's state across to the port: an AMIH index, and
the LM encoder's parameters.

The reference's ``AMIHIndex`` exports as plain numpy (``index_state`` of
either package gives the same dict): ``p``, ``m``, ``id_offset``,
``db_words`` (n, W) uint32, and per substring table its bit span
``lo``/``hi`` with ``sorted_vals`` (the substring values in table order)
and ``sorted_ids`` (the row ids in that order). ``index_from_reference``
builds the port's ``AMIHIndex`` from that state as it is — no re-sorting —
so both packages search the very same tables.

``params_from_reference`` takes the reference's parameter tree with its
leaves as numpy arrays (the caller does the ``np.asarray``) and returns
the port's dict of tensors with the same keys, shapes and dtypes.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.amih import AMIHIndex, _SubTable
from .core.packing import WORD_DTYPE, n_words, substring_spans
from .kernels.ops import resolve_device

__all__ = ["index_from_reference", "index_state", "params_from_reference"]


def index_state(index) -> Dict[str, Any]:
    """The numpy state of an ``AMIHIndex`` (of either package)."""
    return {
        "p": int(index.p),
        "m": int(index.m),
        "id_offset": int(index.id_offset),
        "db_words": np.asarray(index.db_words),
        "tables": [
            {
                "lo": int(t.lo),
                "hi": int(t.hi),
                "sorted_vals": np.asarray(t.sorted_vals),
                "sorted_ids": np.asarray(t.sorted_ids),
            }
            for t in index.tables
        ],
    }


def index_from_reference(state: Dict[str, Any], **options) -> AMIHIndex:
    """The port's ``AMIHIndex`` over a reference index's exported state.

    ``options`` are the port's index options (``verify_backend``,
    ``probe_backend``, ``probe_stream_cap``, ``probe_fused``, ``device``).
    The state is checked for shape and consistency; its tables are used
    as given."""
    p, m = int(state["p"]), int(state["m"])
    db = np.ascontiguousarray(state["db_words"], dtype=WORD_DTYPE)
    if db.ndim != 2 or db.shape[1] != n_words(p):
        raise ValueError(f"db_words must be (n, {n_words(p)}) for p={p}")
    n = db.shape[0]
    spans = substring_spans(p, m)
    if len(state["tables"]) != m:
        raise ValueError(f"{len(state['tables'])} tables for m={m}")
    tables = []
    for (lo, hi), t in zip(spans, state["tables"]):
        if (int(t["lo"]), int(t["hi"])) != (lo, hi):
            raise ValueError(f"table span {(t['lo'], t['hi'])} != {(lo, hi)}")
        vals = np.asarray(t["sorted_vals"], dtype=np.uint64)
        ids = np.asarray(t["sorted_ids"], dtype=np.int64)
        if vals.shape != (n,) or ids.shape != (n,):
            raise ValueError("table arrays must have one entry per code")
        if n and np.any(vals[1:] < vals[:-1]):
            raise ValueError("sorted_vals is not sorted")
        tables.append(_SubTable(lo=lo, hi=hi, sorted_vals=vals,
                                sorted_ids=ids))
    return AMIHIndex.from_tables(
        db, p, m, tables, id_offset=int(state["id_offset"]), **options
    )


def params_from_reference(tree, device=None):
    """The port's parameters from the reference's tree of numpy arrays,
    on ``device`` (None: the CUDA device)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        a = np.asarray(x)
        if not a.flags.writeable:          # torch wants memory it may own
            a = a.copy()
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return conv(tree)
