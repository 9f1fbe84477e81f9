"""K2 and K3: the fused AMIH probing walk and its exhaustive fallback.

Four entry points, each the counterpart of one reference function, each a
wrapper over a CUDA kernel with a plain PyTorch version beside it:

- ``device_probe_walk_batched`` (reference ``device_probe_walk_batched``):
  the cross-z-group walk, ONE launch of ``csrc/probe_walk.cu`` per batch.
- ``device_probe_walk`` (reference ``device_probe_walk``): the same walk
  for one z-group — the same kernel with G = 1, one cursor starting at 0
  and one ``inv_pos`` row. The reference's own docstring states that the
  batched walk reproduces the per-group one group by group; with G = 1 the
  two differ only in how they spell the loop test, the step lookup and
  the inverse-position row.
- ``device_probe_scan_multi`` / ``device_probe_scan`` (reference
  functions of the same names): every stored code's exact walk position
  for each query, one launch of ``csrc/probe_scan.cu``.
- ``device_probe_scan_topk``: the same scan fused with the AMIH
  extraction (each query's k smallest (position, id) pairs within its
  ``t_stop``, and its ``verified`` count), two launches of
  ``csrc/probe_scan.cu`` that never write the (B, n_pad) map. Its plain
  version is the map scan followed by ``extract_map``.

The walks take a position map that holds POS_INF everywhere and lower
entries of it; besides the reference's outputs they return each query's
touched list (the ids whose entry left POS_INF, in no particular order on
the card), its length and the histogram of walk positions, from which
``extract_touched`` selects the results and resets the map.

On a CPU tensor each wrapper runs its ``*_plain`` version, a line-for-line
port of the reference's jnp code; on a CUDA tensor it launches the kernel
(or raises). Every output is an integer, so kernel, plain version and
reference agree exactly (touched lists as sets: ``walk_canonical``).

The reference's ``mode="drop"`` scatters silently drop out-of-range
indices; torch raises on them. The plain versions mask those indices
explicitly (``_scatter_max_cols``, ``_scatter_min_rows``), and the kernels
skip them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .ref import popcount32, verify_tuples_grouped_ref

__all__ = [
    "KCAP_MAX",
    "LAUNCHES",
    "POS_INF",
    "WALK_FORMS",
    "device_probe_scan",
    "device_probe_scan_multi",
    "device_probe_scan_multi_plain",
    "device_probe_scan_plain",
    "device_probe_scan_topk",
    "device_probe_scan_topk_plain",
    "device_probe_walk",
    "device_probe_walk_batched",
    "device_probe_walk_batched_plain",
    "device_probe_walk_plain",
    "extract_map",
    "extract_touched",
    "extract_touched_plain",
    "scan_topk_plan",
    "touched_capacity",
    "walk_canonical",
]

POS_INF = 0x7FFFFFFF
_I32 = torch.int32
_KEY_NONE = (1 << 63) - 1          # an int64 key above every (pos, id) key

# kernel launches so far (bumped where a kernel is launched, nowhere else)
# (the walk's cooperative-grid form under probe_walk, its cluster form
# under probe_walk_cluster)
LAUNCHES = {"probe_walk": 0, "probe_walk_cluster": 0, "probe_extract": 0,
            "probe_scan": 0, "probe_scan_topk": 0}

# the walk kernel's forms (csrc: WALK_FORM_*): "auto" takes the cluster
# (which takes only one z-group of at most 4 queries) where it can, the
# cooperative grid otherwise
WALK_FORMS = {"auto": 0, "grid": 1, "cluster": 2}

# the last walk launch's blocks, threads per block and form, for reports
LAST_WALK_GRID = [0, 0, "none"]

# the largest k of the fused scan (its keys per query: a power of two)
KCAP_MAX = 1024
# threads of a fused-scan block (csrc: TOPK_THREADS), queries a pass-1
# block takes at most (csrc: SCAN_TOPK_QMAX), and the shared memory its
# queries' keys may take
_TOPK_THREADS = 256
_SCAN_QMAX = 16
_KEY_BYTES = 64 * 1024


# ------------------------------------------------------------------ helpers
def _scatter_max_cols(rows: int, ncols: int, idx, vals):
    """``zeros((rows, ncols)).at[brow, idx].max(vals, mode="drop")``:
    indices outside [0, ncols) land in a spare column that is cut off."""
    out = torch.zeros((rows, ncols + 1), dtype=_I32, device=vals.device)
    idx = torch.where((idx >= 0) & (idx < ncols), idx, ncols)
    out.scatter_reduce_(1, idx.long(), vals, reduce="amax", include_self=True)
    return out[:, :ncols]


def _scatter_min_rows(posmap, cand, pos) -> None:
    """``posmap.at[brow, cand].min(pos, mode="drop")`` in place: pad
    candidates (``cand >= n_pad``) are dropped."""
    B, n_pad = posmap.shape
    keep = cand < n_pad
    rows = torch.arange(B, device=cand.device)[:, None].expand_as(cand)
    flat = (rows[keep] * n_pad + cand[keep].long())
    posmap.view(-1).scatter_reduce_(0, flat, pos[keep], reduce="amin",
                                    include_self=True)


def _gather_rows(a, idx):
    """``jnp.take_along_axis(a, idx, axis=1)``."""
    return torch.gather(a, 1, idx.long())


def touched_capacity(budget, cap: int) -> int:
    """Room of a query's touched list: ``cap`` slots for each of at most
    ``budget`` iterations (the kernel writes slot s of iteration it at
    it * cap + s)."""
    return max(1, int(budget) * int(cap))


def _walk_extras(posmap, lt: int, H: int):
    """The plain walks' touched lists (the lowered ids of each row in
    ascending order, -1 past their count), counts and (B, H) histograms of
    walk positions, read from the final map."""
    B, n_pad = posmap.shape
    dev = posmap.device
    rows, ids = torch.nonzero(posmap != POS_INF, as_tuple=True)
    n_touched = torch.bincount(rows, minlength=B).to(_I32)
    starts = torch.cumsum(n_touched, 0) - n_touched
    rank = torch.arange(rows.numel(), device=dev) - starts[rows]
    touched = torch.full((B, lt), -1, dtype=_I32, device=dev)
    touched[rows, rank] = ids.to(_I32)
    pos = posmap[rows, ids].long()
    hist = torch.bincount(rows * H + pos, minlength=B * H).to(_I32)
    return touched, n_touched, hist.view(B, H)


def walk_canonical(out, cap: int):
    """A walk's outputs with each touched list cut to its first iters *
    ``cap`` entries, its ids sorted and -1 after them, so that the
    kernel's (one entry per slot, -1 where the slot lowered nothing) and
    the plain version's (ascending) compare by equality."""
    out = tuple(out)
    touched = out[6][:, :int(out[5]) * int(cap)]
    t = torch.where(touched >= 0, touched, POS_INF).sort(dim=1).values
    return out[:6] + (torch.where(t == POS_INF, -1, t),) + out[7:]


# ------------------------------------------------------- plain: one group
def device_probe_walk_plain(
    q_words, q_sub, z_sub, pow1, pow0, t_stop, k, s_len, budget, tbl,
    step_ext, idx1, idx0, maxi1, maxi0, widths, offsets, bucket_ids, db_pad,
    inv_pos, *, p, tile, cap, kmax, check_every, posmap_in=None,
):
    """The per-z-group walk in plain PyTorch (a port of the reference's
    ``device_probe_walk``) on ``posmap_in`` (all POS_INF; a new map if
    None). Returns (posmap (B, n_pad) int32, probes (B,) int32, retrieved
    (B,) int32, done (B,) bool, cursor int, iters int, touched (B, lt),
    n_touched (B,), hist (B, (p+1)^2)), lt = ``touched_capacity``."""
    dev = q_words.device
    B = q_words.shape[0]
    n_pad = db_pad.shape[0]
    V = offsets.shape[1]
    wp1 = pow1.shape[2]
    col = torch.arange(tile, dtype=_I32, device=dev)
    slot = torch.arange(cap, dtype=_I32, device=dev)
    pow1f = pow1.reshape(B, -1)
    pow0f = pow0.reshape(B, -1)
    offsf = offsets.reshape(-1)
    idsf = bucket_ids.reshape(-1)
    k, s_len, budget = int(k), int(s_len), int(budget)

    posmap = (torch.full((B, n_pad), POS_INF, dtype=_I32, device=dev)
              if posmap_in is None else posmap_in)
    cursor, off, it = 0, 0, 0
    done = t_stop < 0
    probes = torch.zeros(B, dtype=_I32, device=dev)
    retrieved = torch.zeros(B, dtype=_I32, device=dev)

    while cursor < s_len and not bool(done.all()) and it < budget:
        t_tbl = tbl[cursor : cursor + tile]
        t_idx1 = idx1[cursor : cursor + tile]
        t_idx0 = idx0[cursor : cursor + tile]
        t_m1 = maxi1[cursor : cursor + tile]
        t_m0 = maxi0[cursor : cursor + tile]
        in_stream = (cursor + col) < s_len
        tl = t_tbl.long()
        zq = z_sub[:, tl]                                   # (B, tile)
        wd = widths[tl]                                     # (tile,)
        valid = (
            in_stream[None, :]
            & (~done)[:, None]
            & (t_m1[None, :] < zq)
            & (t_m0[None, :] < (wd[None, :] - zq))
        )
        mask = torch.zeros((B, tile), dtype=_I32, device=dev)
        for j in range(kmax):
            mask = (
                mask
                | pow1f[:, (t_tbl * wp1 + t_idx1[:, j]).long()]
                | pow0f[:, (t_tbl * wp1 + t_idx0[:, j]).long()]
            )
        vals = torch.clamp(q_sub[:, tl] ^ mask, 0, V - 2)
        foff = (t_tbl[None, :] * V + vals).long()
        lo = offsf[foff]
        hi = offsf[foff + 1]
        sizes = torch.where(valid, hi - lo, 0)
        adj = torch.clamp(sizes - ((col == 0).to(_I32) * off)[None, :], min=0)
        csum = torch.cumsum(adj, dim=1, dtype=_I32)
        fits = csum.max(dim=0).values <= cap
        n_take = int(fits.sum())
        partial = n_take == 0
        if partial:
            take_sizes = torch.where(
                col[None, :] == 0, torch.clamp(adj, max=cap), 0
            )
        else:
            take_sizes = torch.where(col[None, :] < n_take, adj, 0)
        starts = torch.cumsum(take_sizes, dim=1, dtype=_I32) - take_sizes
        totals = take_sizes.sum(dim=1, dtype=_I32)
        marks = _scatter_max_cols(
            B, cap, starts, (col[None, :] + 1) * (take_sizes > 0).to(_I32)
        )
        ent = torch.clamp(torch.cummax(marks, dim=1).values - 1, min=0)
        within = slot[None, :] - _gather_rows(starts, ent)
        base = (
            _gather_rows(lo, ent)
            + (ent == 0).to(_I32) * off
            + within
        )
        vslot = slot[None, :] < totals[:, None]
        tt = t_tbl[ent.long()]                              # (B, cap)
        cand = idsf[tt.long() * n_pad + torch.clamp(base, 0, n_pad - 1).long()]
        cand = torch.where(vslot, cand, n_pad)
        gathered = db_pad[torch.clamp(cand, max=n_pad - 1).long()]
        keys = verify_tuples_grouped_ref(q_words, gathered, totals, p)
        pos = torch.where(
            keys >= 0, inv_pos[torch.clamp(keys, min=0).long()], POS_INF
        )
        _scatter_min_rows(posmap, cand, pos)
        if partial:
            probes = probes + (valid[:, 0] & (off == 0)).to(_I32)
        else:
            probes = probes + (
                valid
                & (col[None, :] < n_take)
                & ~((col[None, :] == 0) & (off > 0))
            ).sum(dim=1, dtype=_I32)
        retrieved = retrieved + totals
        cursor2 = cursor if partial else cursor + n_take
        off2 = off + cap if partial else 0
        it2 = it + 1
        if it2 % check_every == 0 or cursor2 >= s_len:
            T_comp = int(step_ext[cursor2]) - 1
            eff = torch.clamp(t_stop, max=T_comp)
            cnt = (posmap <= eff[:, None]).sum(dim=1)
            done = done | (cnt >= k) | (T_comp >= t_stop)
        cursor, off, it = cursor2, off2, it2
    extras = _walk_extras(posmap, touched_capacity(budget, cap),
                          (p + 1) ** 2)
    return (posmap, probes, retrieved, done, cursor, it) + extras


# ------------------------------------------------------ plain: all groups
def device_probe_walk_batched_plain(
    posmap_in, q_words, q_sub, z_sub, pow1, pow0, gid, t_stop, k, budget,
    g_start, g_end, tbl, step_flat, idx1, idx0, maxi1, maxi0, widths,
    offsets, bucket_ids, db_pad, inv_pos, *, p, tile, cap, kmax, check_every,
):
    """The cross-z-group walk in plain PyTorch (a port of the reference's
    ``device_probe_walk_batched``). ``posmap_in`` must hold POS_INF
    everywhere; the walk lowers its entries and returns it as the position
    map. Returns (posmap, probes, retrieved, done, cursor (G,) int32,
    iters int, touched, n_touched, hist) as ``device_probe_walk_plain``."""
    dev = q_words.device
    B = q_words.shape[0]
    G = g_start.shape[0]
    n_pad = db_pad.shape[0]
    Pt = tbl.shape[0]
    V = offsets.shape[1]
    wp1 = pow1.shape[2]
    pp2 = inv_pos.shape[1]
    col = torch.arange(tile, dtype=_I32, device=dev)
    slot = torch.arange(cap, dtype=_I32, device=dev)
    pow1f = pow1.reshape(B, -1)
    pow0f = pow0.reshape(B, -1)
    offsf = offsets.reshape(-1)
    idsf = bucket_ids.reshape(-1)
    inv_posf = inv_pos.reshape(-1)
    gl = gid.long()
    g_end_q = g_end[gl]
    k, budget = int(k), int(budget)

    posmap = posmap_in
    cursor = g_start.clone()
    off = torch.zeros(G, dtype=_I32, device=dev)
    done = t_stop < 0
    probes = torch.zeros(B, dtype=_I32, device=dev)
    retrieved = torch.zeros(B, dtype=_I32, device=dev)
    it = 0

    def group_active(cursor, done):
        g_undone = torch.zeros(G, dtype=_I32, device=dev).scatter_reduce(
            0, gl, (~done).to(_I32), reduce="amax", include_self=True
        ) > 0
        return g_undone & (cursor < g_end)

    while bool(group_active(cursor, done).any()) and it < budget:
        active_g = group_active(cursor, done)
        curq = cursor[gl]
        offq = off[gl]
        raw = curq[:, None] + col[None, :]                  # (B, tile)
        tidx = torch.clamp(raw, max=Pt - 1).long()
        t_tbl = tbl[tidx]
        t_m1 = maxi1[tidx]
        t_m0 = maxi0[tidx]
        in_stream = raw < g_end_q[:, None]
        zq = _gather_rows(z_sub, t_tbl)
        wd = widths[t_tbl.long()]
        valid = (
            in_stream
            & (~done)[:, None]
            & (t_m1 < zq)
            & (t_m0 < (wd - zq))
        )
        mask = torch.zeros((B, tile), dtype=_I32, device=dev)
        for j in range(kmax):
            i1 = idx1[:, j][tidx]
            i0 = idx0[:, j][tidx]
            mask = (
                mask
                | _gather_rows(pow1f, t_tbl * wp1 + i1)
                | _gather_rows(pow0f, t_tbl * wp1 + i0)
            )
        vals = torch.clamp(_gather_rows(q_sub, t_tbl) ^ mask, 0, V - 2)
        foff = (t_tbl * V + vals).long()
        lo = offsf[foff]
        hi = offsf[foff + 1]
        sizes = torch.where(valid, hi - lo, 0)
        adj = torch.clamp(
            sizes - torch.where(col[None, :] == 0, offq[:, None], 0), min=0
        )
        csum = torch.cumsum(adj, dim=1, dtype=_I32)
        gmax = torch.zeros((G, tile), dtype=_I32, device=dev).scatter_reduce(
            0, gl[:, None].expand(B, tile), csum, reduce="amax",
            include_self=True,
        )
        fits_g = gmax <= cap
        n_take_g = fits_g.sum(dim=1, dtype=_I32)            # (G,)
        partial_g = n_take_g == 0
        n_take_q = n_take_g[gl]
        partial_q = partial_g[gl]
        take_sizes = torch.where(col[None, :] < n_take_q[:, None], adj, 0)
        take_sizes = torch.where(
            partial_q[:, None],
            torch.where(col[None, :] == 0, torch.clamp(adj, max=cap), 0),
            take_sizes,
        )
        starts = torch.cumsum(take_sizes, dim=1, dtype=_I32) - take_sizes
        totals = take_sizes.sum(dim=1, dtype=_I32)
        marks = _scatter_max_cols(
            B, cap, starts, (col[None, :] + 1) * (take_sizes > 0).to(_I32)
        )
        ent = torch.clamp(torch.cummax(marks, dim=1).values - 1, min=0)
        within = slot[None, :] - _gather_rows(starts, ent)
        base = (
            _gather_rows(lo, ent)
            + torch.where(ent == 0, offq[:, None], 0)
            + within
        )
        vslot = slot[None, :] < totals[:, None]
        tt = _gather_rows(t_tbl, ent)
        cand = idsf[tt.long() * n_pad + torch.clamp(base, 0, n_pad - 1).long()]
        cand = torch.where(vslot, cand, n_pad)
        gathered = db_pad[torch.clamp(cand, max=n_pad - 1).long()]
        keys = verify_tuples_grouped_ref(q_words, gathered, totals, p)
        pos = torch.where(
            keys >= 0,
            inv_posf[gl[:, None] * pp2 + torch.clamp(keys, min=0).long()],
            POS_INF,
        )
        _scatter_min_rows(posmap, cand, pos)
        probes = probes + torch.where(
            partial_q,
            (valid[:, 0] & (offq == 0)).to(_I32),
            (
                valid
                & (col[None, :] < n_take_q[:, None])
                & ~((col[None, :] == 0) & (offq > 0)[:, None])
            ).sum(dim=1, dtype=_I32),
        )
        retrieved = retrieved + totals
        adv = active_g & ~partial_g
        cursor2 = torch.where(adv, cursor + n_take_g, cursor)
        off2 = torch.where(
            active_g, torch.where(partial_g, off + cap, 0), off
        )
        it2 = it + 1
        if (it2 % check_every) == 0 or not bool(
            group_active(cursor2, done).any()
        ):
            cq = torch.clamp(cursor2[gl], max=Pt - 1)
            T_comp = step_flat[cq.long()] - 1
            eff = torch.minimum(T_comp, t_stop)
            cnt = (posmap <= eff[:, None]).sum(dim=1)
            done = done | (cnt >= k) | (T_comp >= t_stop)
        cursor, off, it = cursor2, off2, it2
    extras = _walk_extras(posmap, touched_capacity(budget, cap), pp2)
    return (posmap, probes, retrieved, done, cursor, it) + extras


# ------------------------------------------------------------ plain: scans
def device_probe_scan_multi_plain(q_words, gid, db_pad, inv_pos, n_valid, *,
                                  p, chunk):
    """Every code's exact walk position per query, in plain PyTorch (a port
    of the reference's ``device_probe_scan_multi``): (B, n_pad) int32."""
    dev = q_words.device
    B, W = q_words.shape
    n_pad = db_pad.shape[0]
    pp2 = inv_pos.shape[1]
    inv_posf = inv_pos.reshape(-1)
    if n_pad % chunk:
        raise ValueError(f"n_pad={n_pad} is not a multiple of chunk={chunk}")
    lens = torch.full((B,), chunk, dtype=_I32, device=dev)
    gl = gid.long()
    out = torch.empty((B, n_pad), dtype=_I32, device=dev)
    for ci in range(n_pad // chunk):
        db_chunk = db_pad[ci * chunk : (ci + 1) * chunk]
        gathered = db_chunk[None].expand(B, chunk, W)
        keys = verify_tuples_grouped_ref(q_words, gathered, lens, p)
        rowid = ci * chunk + torch.arange(chunk, dtype=torch.int64, device=dev)
        out[:, ci * chunk : (ci + 1) * chunk] = torch.where(
            (keys >= 0) & (rowid[None, :] < int(n_valid)),
            inv_posf[gl[:, None] * pp2 + torch.clamp(keys, min=0).long()],
            POS_INF,
        )
    return out


def device_probe_scan_plain(q_words, db_pad, inv_pos, n_valid, *, p, chunk):
    """``device_probe_scan_multi_plain`` with one inverse-position row (a
    port of the reference's ``device_probe_scan``)."""
    gid = torch.zeros(q_words.shape[0], dtype=_I32, device=q_words.device)
    return device_probe_scan_multi_plain(
        q_words, gid, db_pad, inv_pos[None, :], n_valid, p=p, chunk=chunk
    )


# ------------------------------------------------------------- extraction
def _decode(keys, k: int):
    """(B, k') ascending int64 keys (pos << 32) | id, ``_KEY_NONE`` where
    none -> (ids, pos) int32 (B, k), -1 past the last key."""
    none = keys == _KEY_NONE
    ids = torch.where(none, -1, keys & 0xFFFFFFFF).to(_I32)
    pos = torch.where(none, -1, keys >> 32).to(_I32)
    pad = k - keys.shape[1]
    if pad > 0:
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        pos = torch.nn.functional.pad(pos, (0, pad), value=-1)
    return ids, pos


def extract_map(posmap, t_stop, k: int):
    """The AMIH extraction from whole map rows: per row the k smallest
    (position, id) pairs with position <= ``t_stop[row]``, ascending (ties
    at a position to the smallest ids, the reference's ``pos * n + id``
    order), as (ids, pos) int32 (B, k) with -1 past the last, and
    ``verified`` (B,) int32, the row's entries that are not POS_INF.
    Torch ops over every entry: the fused scan's plain version, and the
    bail route above ``KCAP_MAX``."""
    B, n_pad = posmap.shape
    dev = posmap.device
    kk = min(int(k), n_pad)
    ids, pos, ver = [], [], []
    step = max(1, (1 << 26) // max(n_pad, 1))     # rows per chunk
    col = torch.arange(n_pad, dtype=torch.int64, device=dev)
    for lo in range(0, B, step):
        pm = posmap[lo:lo + step]
        keys = torch.where(pm <= t_stop[lo:lo + step, None],
                           (pm.to(torch.int64) << 32) | col, _KEY_NONE)
        top = torch.topk(keys, kk, dim=1, largest=False).values
        i, q = _decode(top, k)
        ids.append(i)
        pos.append(q)
        ver.append((pm != POS_INF).sum(dim=1, dtype=_I32))
    if not ids:
        empty = torch.empty((0, k), dtype=_I32, device=dev)
        return empty, empty.clone(), torch.empty(0, dtype=_I32, device=dev)
    return torch.cat(ids), torch.cat(pos), torch.cat(ver)


def extract_touched_plain(posmap, touched, hist, t_stop, k: int, rows,
                          width: int):
    """``extract_touched`` in torch ops (its plain version, and its route
    above ``KCAP_MAX`` on the card). Only the first ``width`` entries of
    each list are read, once (-1 marks a slot that lowered nothing; its
    reset goes to the row's entry at the slot's column mod n_pad, harmless,
    as the row ends all POS_INF, and spread over the row); a row's entries
    at or below min(k-th, t_stop) are compacted (one wait for the card) and
    sorted, as one key (row, position, id) each."""
    B, n_pad = posmap.shape
    dev = posmap.device
    rows = torch.as_tensor(rows, dtype=torch.int64).to(dev)
    R = rows.numel()
    out = torch.full((2, R * k + 1), -1, dtype=_I32, device=dev)
    if width == 0 or B == 0:
        return out[0, :-1].view(R, k), out[1, :-1].view(R, k)
    t = touched[:, :width].to(torch.int64)
    live = t >= 0
    col = torch.arange(width, device=dev) % n_pad
    flat = (torch.where(live, t, col[None, :])
            + torch.arange(B, device=dev)[:, None] * n_pad)
    flat_map = posmap.view(-1)
    if R:
        kth = (torch.cumsum(hist[rows], dim=1) < k).sum(dim=1)
        thr = torch.minimum(kth, t_stop[rows].to(torch.int64))
        pos = flat_map[flat[rows]].to(torch.int64)
        r, c = torch.nonzero(live[rows] & (pos <= thr[:, None]),
                             as_tuple=True)
        # (row, position, id): row < 2^16, position < 2^15, id < 2^32
        keys = torch.sort((r << 47) | (pos[r, c] << 32) | t[rows][r, c]).values
        srow = keys >> 47
        rank = (torch.arange(keys.numel(), device=dev)
                - torch.searchsorted(srow, srow))
        dst = torch.where(rank < k, srow * k + rank, R * k)
        out[0].index_put_((dst,), (keys & 0xFFFFFFFF).to(_I32))
        out[1].index_put_((dst,), ((keys >> 32) & 0x7FFF).to(_I32))
    flat_map.index_fill_(0, flat.view(-1), POS_INF)
    return out[0, :-1].view(R, k), out[1, :-1].view(R, k)


def extract_touched(posmap, touched, hist, t_stop, k: int, rows,
                    width: int):
    """The AMIH extraction from a walk's touched lists, for the map rows
    ``rows`` (indices, host or device): the k smallest (position, id)
    pairs with position <= ``t_stop`` of each, as ``extract_map`` returns
    them ((R, k) ids and positions, -1 past the last). The k-th position
    of a row is the first histogram bin whose prefix count reaches k, so
    only touched ids at or below min(k-th, t_stop) are ranked. Then every
    touched entry of EVERY row is reset to POS_INF, so the map holds
    POS_INF everywhere again. ``width``: the list entries the walk wrote
    (iterations x cap). One kernel launch (``csrc/probe_walk.cu``,
    ``probe_extract_launch``) on the card for k <= ``KCAP_MAX``; the plain
    version on the CPU, and in torch ops above that k."""
    if posmap.device.type == "cpu" or k > KCAP_MAX:
        return extract_touched_plain(posmap, touched, hist, t_stop, k, rows,
                                     width)
    _require_cuda(posmap)
    out = _extract_kernel(_build.load("probe_walk"), posmap, touched, hist,
                          t_stop, k, rows, width,
                          stream=_build.stream_of(posmap.device))
    LAUNCHES["probe_extract"] += 1
    return out


def device_probe_scan_topk_plain(q_words, gid, t_stop, db_pad, inv_pos,
                                 n_valid, k, *, p, chunk):
    """The fused scan's plain version: the plain map
    (``device_probe_scan_multi_plain``), then ``extract_map``."""
    pm = device_probe_scan_multi_plain(q_words, gid, db_pad, inv_pos,
                                       n_valid, p=p, chunk=chunk)
    return extract_map(pm, t_stop, k)


# ------------------------------------------------------------------ kernels
def _walk_kernel(lib, posmap, q_words, q_sub, z_sub, pow1, pow0, gid, t_stop,
                 k, budget, g_start, g_end, tbl, step, idx1, idx0, maxi1,
                 maxi0, widths, offsets, bucket_ids, db_pad, inv_pos, *, p,
                 tile, cap, kmax, check_every, stream, form="auto"):
    """Launch ``csrc/probe_walk.cu`` on already-placed operands (``posmap``
    all POS_INF) in ``form`` (``WALK_FORMS``). Returns (posmap, probes,
    retrieved, done bool, cursor (G,), iters (1,), touched (B, lt),
    n_touched (B,), hist (B, pp2))."""
    dev = q_words.device
    B, W = q_words.shape
    m = q_sub.shape[1]
    wp1 = pow1.shape[2]
    G = g_start.shape[0]
    Pt = tbl.shape[0]
    V = offsets.shape[1]
    n_pad = db_pad.shape[0]
    pp2 = inv_pos.shape[1]
    lt = touched_capacity(budget, cap)

    def new(*shape):
        return torch.empty(shape, dtype=_I32, device=dev)

    scratch = dict(
        lo=new(B, tile), adj=new(B, tile), vfl=new(B, tile),
        csum=new(B, tile), ntake=new(G), cursor=new(2 * G), off=new(2 * G),
        done=new(2 * B),
    )
    out = dict(probes=new(B), retrieved=new(B), done=new(B),
               cursor=new(G), iters=new(1), touched=new(B, lt),
               hist=new(B, pp2))
    req = _build.require
    ptrs = [
        req(posmap, "posmap", (B, n_pad), dev),
        out["hist"].data_ptr(),
        req(q_words, "q_words", (B, W), dev),
        req(q_sub, "q_sub", (B, m), dev),
        req(z_sub, "z_sub", (B, m), dev),
        req(pow1, "pow1", (B, m, wp1), dev),
        req(pow0, "pow0", (B, m, wp1), dev),
        req(gid, "gid", (B,), dev),
        req(t_stop, "t_stop", (B,), dev),
        req(g_start, "g_start", (G,), dev),
        req(g_end, "g_end", (G,), dev),
        req(tbl, "tbl", (Pt,), dev),
        req(step, "step", (Pt,), dev),
        req(idx1, "idx1", (Pt, kmax), dev),
        req(idx0, "idx0", (Pt, kmax), dev),
        req(maxi1, "maxi1", (Pt,), dev),
        req(maxi0, "maxi0", (Pt,), dev),
        req(widths, "widths", (m,), dev),
        req(offsets, "offsets", (m, V), dev),
        req(bucket_ids, "bucket_ids", (m, n_pad), dev),
        req(db_pad, "db_pad", (n_pad, W), dev),
        req(inv_pos, "inv_pos", (G, pp2), dev),
        scratch["lo"].data_ptr(), scratch["adj"].data_ptr(),
        scratch["vfl"].data_ptr(), scratch["csum"].data_ptr(),
        scratch["ntake"].data_ptr(), scratch["cursor"].data_ptr(),
        scratch["off"].data_ptr(), scratch["done"].data_ptr(),
        out["probes"].data_ptr(), out["retrieved"].data_ptr(),
        out["done"].data_ptr(), out["cursor"].data_ptr(),
        out["iters"].data_ptr(), out["touched"].data_ptr(),
    ]
    sc = [B, G, W, m, wp1, V, n_pad, Pt, pp2, pp2, tile, cap, kmax,
          max(1, int(check_every)), int(k), int(budget), p, lt,
          WALK_FORMS[form]]
    info = (ctypes.c_int * 3)()
    _build.call(lib, "probe_walk", ptrs, sc, stream, info)
    LAST_WALK_GRID[:] = [info[0], info[1],
                         {v: f for f, v in WALK_FORMS.items()}[info[2]]]
    # a query's verified codes: its histogram's total
    n_touched = out["hist"].sum(dim=1, dtype=_I32)
    return (posmap, out["probes"], out["retrieved"], out["done"].bool(),
            out["cursor"], out["iters"], out["touched"], n_touched,
            out["hist"])


def _scan_kernel(lib, q_words, gid, db_pad, inv_pos, n_valid, out, *, p,
                 stream):
    """Launch ``csrc/probe_scan.cu``'s map scan into ``out`` (B, n_pad)."""
    dev = q_words.device
    B, W = q_words.shape
    n_pad = db_pad.shape[0]
    pp2 = inv_pos.shape[1]
    if W > 8:
        raise ValueError(f"W={W} words exceeds the scan kernel's 8")
    ptrs = [
        _build.require(q_words, "q_words", (B, W), dev),
        _build.require(gid, "gid", (B,), dev),
        _build.require(db_pad, "db_pad", (n_pad, W), dev),
        _build.require(inv_pos, "inv_pos", (inv_pos.shape[0], pp2), dev),
        _build.require(out, "out", (B, n_pad), dev),
    ]
    _build.call(lib, "probe_scan", ptrs, [B, W, n_pad, int(n_valid), pp2, p],
                stream)
    return out


def _extract_kernel(lib, posmap, touched, hist, t_stop, k: int, rows,
                    width: int, *, stream):
    """Launch ``probe_extract_launch`` (one block per map row): (ids, pos)
    int32 (R, k) for the rows ``rows`` (host or device indices)."""
    dev = posmap.device
    B, n_pad = posmap.shape
    lt = touched.shape[1]
    H = hist.shape[1]
    if not 0 < k <= KCAP_MAX:
        raise ValueError(f"k={k}: the extraction kernel takes 1 <= k <= "
                         f"{KCAP_MAX}")
    if isinstance(rows, torch.Tensor):
        rows = rows.to(dev, torch.int64)
        slot = torch.full((B,), -1, dtype=_I32, device=dev)
        slot[rows] = torch.arange(rows.numel(), dtype=_I32, device=dev)
    else:
        rows = np.asarray(rows, dtype=np.int64)
        host = np.full(B, -1, dtype=np.int32)
        host[rows] = np.arange(rows.size, dtype=np.int32)
        slot = torch.from_numpy(host).to(dev)
    R = rows.shape[0]
    ids = torch.empty((R, k), dtype=_I32, device=dev)
    pos = torch.empty((R, k), dtype=_I32, device=dev)
    kcap = 1 << max(0, k - 1).bit_length()
    req = _build.require
    ptrs = [req(posmap, "posmap", (B, n_pad), dev),
            req(touched, "touched", (B, lt), dev),
            req(hist, "hist", (B, H), dev), req(t_stop, "t_stop", (B,), dev),
            slot.data_ptr(), ids.data_ptr(), pos.data_ptr()]
    _build.call(lib, "probe_extract", ptrs,
                [B, n_pad, lt, min(int(width), lt), H, k,
                 2 * max(kcap, _TOPK_THREADS)], stream)
    return ids, pos


def _smem_bytes(QT: int, L: int, W: int, tbl_cap: int) -> int:
    """Pass 1's dynamic shared memory (csrc: ``scan_topk_smem``)."""
    up = lambda x: -(-x // 16) * 16  # noqa: E731
    cnt = up(QT * L * 8 + _SCAN_QMAX * W * 4) + QT * 8
    return up(cnt + QT * 4 + _SCAN_QMAX * 4) + up(tbl_cap * 2)


# shared memory a pass-1 block of the fused scan may take: two an SM
_SCAN_SMEM = 110 * 1024


def scan_topk_plan(gid, z, k: int, n_valid: int, n_sm: int, W: int, p: int,
                   tile_rows=None) -> dict:
    """The fused scan's shape: queries in (gid, z) order (``order``: the
    position of each in that order), cut into segments of ``QT`` ((n_segs,
    4) int32 rows: first query, queries, first table, tables); each
    segment's distinct (gid, z) as tables ((n_tabs, 3) int32 rows: offset
    in 16-bit entries, inv_pos row, z; ``qtab``: each query's table); ``L``
    keys per query in shared memory (the best k plus at least a step of
    staging, a power of two); ``QT`` the largest of 16, 8, 4, 2, 1 (and at
    most the batch) whose keys take at most 64 KiB and whose segments' keys
    and tables fit ``_SCAN_SMEM``; ``tbl_cap`` the largest segment's table
    entries; and row tiles over [0, n_valid): without ``tile_rows``, one
    wave of the pass-1 blocks that fit on ``n_sm`` SMs (two an SM), no
    more than keep pass 1's keys within 1% of a (B, n) int32 map
    (``tiles <= n / (200 k)``), and at least one step long."""
    gid = np.asarray(gid, dtype=np.int64)
    z = np.asarray(z, dtype=np.int64)
    B = gid.size
    kcap = 1 << max(0, k - 1).bit_length()
    L = 2 * max(kcap, _TOPK_THREADS)
    order = np.lexsort((np.arange(B), z, gid))
    for QT in (16, 8, 4, 2, 1):
        if QT > max(B, 1) or QT * L * 8 > _KEY_BYTES:
            continue
        segs, tabs, qtab, tbl_cap = [], [], np.zeros(B, np.int32), 0
        for first in range(0, B, QT):
            rows = order[first:first + QT]
            seen, off = {}, 0
            for j, r in enumerate(rows):
                key = (int(gid[r]), int(z[r]))
                if key not in seen:
                    seen[key] = len(tabs)
                    tabs.append((off, key[0], key[1]))
                    off += (key[1] + 1) * (p - key[1] + 1)
                qtab[first + j] = seen[key]
            segs.append((first, rows.size, len(tabs) - len(seen), len(seen)))
            tbl_cap = max(tbl_cap, off)
        if QT == 1 or _smem_bytes(QT, L, W, tbl_cap) <= _SCAN_SMEM:
            break
    n_segs = max(1, len(segs))
    if tile_rows is None:
        smem = _smem_bytes(QT, L, W, tbl_cap)
        per_sm = max(1, min(2, 232448 // (smem + 1024)))
        tiles = -(-per_sm * n_sm // n_segs)
        tiles = max(1, min(tiles, n_valid // (200 * max(k, 1)),
                           -(-n_valid // _TOPK_THREADS)))
        tile_rows = -(-max(n_valid, 1) // tiles)
        tile_rows = -(-tile_rows // _TOPK_THREADS) * _TOPK_THREADS
    tile_rows = max(1, int(tile_rows))
    return {"order": order, "segs": np.asarray(segs, np.int32).reshape(-1, 4),
            "tabs": np.asarray(tabs, np.int32).reshape(-1, 3), "qtab": qtab,
            "L": L, "QT": QT, "tbl_cap": int(max(tbl_cap, 1)),
            "tile_rows": tile_rows,
            "n_tiles": max(1, -(-n_valid // tile_rows))}


def _scan_topk_kernel(lib, q_words, gid, t_stop, db_pad, inv_pos, n_valid,
                      k, *, p, stream, plan=None, n_sm=None, tile_rows=None):
    """Launch ``csrc/probe_scan.cu``'s fused position-and-top-k: (ids,
    pos) int32 (B, k) and verified (B,) int32, in the caller's query
    order. ``plan`` (``scan_topk_plan``) is made here from the queries'
    rows and popcounts, read from the card, unless the caller has it."""
    dev = q_words.device
    B, W = q_words.shape
    n_pad = db_pad.shape[0]
    G, pp2 = inv_pos.shape
    n_valid = int(n_valid)
    if W > 8:
        raise ValueError(f"W={W} words exceeds the scan kernel's 8")
    if not 0 < k <= KCAP_MAX:
        raise ValueError(f"k={k}: the fused scan takes 1 <= k <= {KCAP_MAX}")
    if W % 4 == 0 and db_pad.data_ptr() % 16:
        raise ValueError("db_pad: codes of 4 or 8 words must start on a "
                         "16-byte boundary (the kernel's vector loads)")
    if not 0 <= n_valid <= n_pad:
        raise ValueError(f"n_valid={n_valid} outside [0, {n_pad}]")
    req = _build.require
    req(gid, "gid", (B,), dev)
    req(t_stop, "t_stop", (B,), dev)
    ids = torch.empty((B, k), dtype=_I32, device=dev)
    pos = torch.empty((B, k), dtype=_I32, device=dev)
    verified = torch.empty(B, dtype=_I32, device=dev)
    if B == 0:
        return ids, pos, verified
    if plan is None:
        z = popcount32(q_words).sum(dim=1, dtype=_I32)
        host = torch.stack([gid, z]).cpu().numpy()
        if n_sm is None:
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = scan_topk_plan(host[0], host[1], k, n_valid, n_sm, W, p,
                              tile_rows)
    # the plan's index arrays in one copy to the card (unless the caller
    # placed them there: ``plan["flat"]``)
    parts = [plan["order"].astype(np.int32), plan["segs"].reshape(-1),
             plan["tabs"].reshape(-1), plan["qtab"]]
    flat = plan.get("flat")
    if flat is None:
        flat = torch.from_numpy(np.concatenate(parts)).to(dev)
    order, segs, tabs, qtab = torch.split(flat, [x.size for x in parts])
    q_s = q_words.index_select(0, order).contiguous()
    t_s = t_stop.index_select(0, order).contiguous()
    nt = plan["n_tiles"]
    part = torch.empty((B, nt, k), dtype=torch.int64, device=dev)
    part_cnt = torch.empty((B, nt), dtype=_I32, device=dev)
    ids_s = torch.empty((B, k), dtype=_I32, device=dev)
    pos_s = torch.empty((B, k), dtype=_I32, device=dev)
    ver_s = torch.empty(B, dtype=_I32, device=dev)
    ptrs = [q_s.data_ptr(), t_s.data_ptr(),
            req(db_pad, "db_pad", (n_pad, W), dev),
            req(inv_pos, "inv_pos", (G, pp2), dev), segs.data_ptr(),
            tabs.data_ptr(), qtab.data_ptr(), part.data_ptr(),
            part_cnt.data_ptr(), ids_s.data_ptr(), pos_s.data_ptr(),
            ver_s.data_ptr()]
    _build.call(lib, "probe_scan_topk", ptrs,
                [B, W, n_valid, pp2, p, k, plan["L"], plan["QT"],
                 plan["tile_rows"], nt, plan["segs"].shape[0],
                 plan["tbl_cap"]], stream)
    ids[order] = ids_s
    pos[order] = pos_s
    verified[order] = ver_s
    return ids, pos, verified


def _count_walk() -> None:
    """One walk launch, under the form the kernel ran in."""
    LAUNCHES["probe_walk_cluster" if LAST_WALK_GRID[2] == "cluster"
             else "probe_walk"] += 1


def _require_cuda(t) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


# ---------------------------------------------------------------- wrappers
def device_probe_walk_batched(
    posmap_in, q_words, q_sub, z_sub, pow1, pow0, gid, t_stop, k, budget,
    g_start, g_end, tbl, step_flat, idx1, idx0, maxi1, maxi0, widths,
    offsets, bucket_ids, db_pad, inv_pos, *, p, tile, cap, kmax, check_every,
    form="auto",
):
    """Cross-z-group fused walk: ONE kernel launch per batch. Same operands
    and outputs as ``device_probe_walk_batched_plain`` (which runs for CPU
    tensors); ``posmap_in`` must hold POS_INF everywhere and is returned as
    the map. ``form`` picks the kernel's barrier (``WALK_FORMS``)."""
    args = (posmap_in, q_words, q_sub, z_sub, pow1, pow0, gid, t_stop, k,
            budget, g_start, g_end, tbl, step_flat, idx1, idx0, maxi1, maxi0,
            widths, offsets, bucket_ids, db_pad, inv_pos)
    kw = dict(p=p, tile=tile, cap=cap, kmax=kmax, check_every=check_every)
    if q_words.device.type == "cpu":
        return device_probe_walk_batched_plain(*args, **kw)
    _require_cuda(q_words)
    out = _walk_kernel(_build.load("probe_walk"), *args, **kw,
                       stream=_build.stream_of(q_words.device), form=form)
    _count_walk()
    return out


def device_probe_walk(
    q_words, q_sub, z_sub, pow1, pow0, t_stop, k, s_len, budget, tbl,
    step_ext, idx1, idx0, maxi1, maxi0, widths, offsets, bucket_ids, db_pad,
    inv_pos, *, p, tile, cap, kmax, check_every, posmap_in=None,
    form="auto",
):
    """One z-group's fused walk: the batched kernel with G = 1, on
    ``posmap_in`` (all POS_INF; a new map if None). Same operands and
    outputs as ``device_probe_walk_plain``."""
    kw = dict(p=p, tile=tile, cap=cap, kmax=kmax, check_every=check_every)
    if q_words.device.type == "cpu":
        return device_probe_walk_plain(
            q_words, q_sub, z_sub, pow1, pow0, t_stop, k, s_len, budget, tbl,
            step_ext, idx1, idx0, maxi1, maxi0, widths, offsets, bucket_ids,
            db_pad, inv_pos, **kw, posmap_in=posmap_in,
        )
    _require_cuda(q_words)
    dev = q_words.device
    B = q_words.shape[0]
    P = tbl.shape[0]
    posmap = posmap_in
    if posmap is None:
        posmap = torch.full((B, db_pad.shape[0]), POS_INF, dtype=_I32,
                            device=dev)
    gid = torch.zeros(B, dtype=_I32, device=dev)
    g_start = torch.zeros(1, dtype=_I32, device=dev)
    g_end = torch.full((1,), int(s_len), dtype=_I32, device=dev)
    out = _walk_kernel(
        _build.load("probe_walk"), posmap, q_words, q_sub, z_sub, pow1, pow0,
        gid, t_stop, k, budget, g_start, g_end, tbl, step_ext[:P], idx1,
        idx0, maxi1, maxi0, widths, offsets, bucket_ids, db_pad,
        inv_pos[None, :], **kw, stream=_build.stream_of(dev), form=form,
    )
    _count_walk()
    return out[:4] + (out[4][0],) + out[5:]


def device_probe_scan_multi(q_words, gid, db_pad, inv_pos, n_valid, *, p,
                            chunk):
    """Exhaustive position map with a per-query inverse-position row: ONE
    kernel launch. Same operands and output as the plain version."""
    if q_words.device.type == "cpu":
        return device_probe_scan_multi_plain(
            q_words, gid, db_pad, inv_pos, n_valid, p=p, chunk=chunk
        )
    _require_cuda(q_words)
    out = torch.empty((q_words.shape[0], db_pad.shape[0]), dtype=_I32,
                      device=q_words.device)
    _scan_kernel(_build.load("probe_scan"), q_words, gid, db_pad, inv_pos,
                 n_valid, out, p=p, stream=_build.stream_of(q_words.device))
    LAUNCHES["probe_scan"] += 1
    return out


def device_probe_scan(q_words, db_pad, inv_pos, n_valid, *, p, chunk):
    """``device_probe_scan_multi`` with one inverse-position row."""
    if q_words.device.type == "cpu":
        return device_probe_scan_plain(
            q_words, db_pad, inv_pos, n_valid, p=p, chunk=chunk
        )
    gid = torch.zeros(q_words.shape[0], dtype=_I32, device=q_words.device)
    return device_probe_scan_multi(
        q_words, gid, db_pad, inv_pos[None, :], n_valid, p=p, chunk=chunk
    )


def device_probe_scan_topk(q_words, gid, t_stop, db_pad, inv_pos, n_valid,
                           k, *, p, chunk, plan=None):
    """The scan fused with the AMIH extraction: per query the k smallest
    (position, id) pairs with position <= ``t_stop`` among the first
    ``n_valid`` codes, as (ids, pos) int32 (B, k), -1 past the last, and
    verified (B,) int32 (codes with a walk position); two kernel launches,
    no (B, n_pad) map. Same operands and outputs as the plain version
    (``chunk`` is its chunk); the kernel takes 1 <= k <= ``KCAP_MAX``.
    ``plan`` (``scan_topk_plan``, from host copies of ``gid`` and the
    queries' popcounts) spares the kernel route a wait for the card."""
    if q_words.device.type == "cpu":
        return device_probe_scan_topk_plain(
            q_words, gid, t_stop, db_pad, inv_pos, n_valid, k, p=p,
            chunk=chunk,
        )
    _require_cuda(q_words)
    out = _scan_topk_kernel(_build.load("probe_scan"), q_words, gid, t_stop,
                            db_pad, inv_pos, n_valid, k, p=p,
                            stream=_build.stream_of(q_words.device),
                            plan=plan)
    LAUNCHES["probe_scan_topk"] += 1
    return out
