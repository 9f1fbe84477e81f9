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

On a CPU tensor each wrapper runs its ``*_plain`` version, a line-for-line
port of the reference's jnp code; on a CUDA tensor it launches the kernel
(or raises). Every output is an integer, so kernel, plain version and
reference agree exactly.

The reference's ``mode="drop"`` scatters silently drop out-of-range
indices; torch raises on them. The plain versions mask those indices
explicitly (``_scatter_max_cols``, ``_scatter_min_rows``), and the kernels
skip them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import verify_tuples_grouped_ref

__all__ = [
    "LAUNCHES",
    "POS_INF",
    "device_probe_scan",
    "device_probe_scan_multi",
    "device_probe_scan_multi_plain",
    "device_probe_scan_plain",
    "device_probe_walk",
    "device_probe_walk_batched",
    "device_probe_walk_batched_plain",
    "device_probe_walk_plain",
]

POS_INF = 0x7FFFFFFF
_I32 = torch.int32

# kernel launches so far (bumped where a kernel is launched, nowhere else)
LAUNCHES = {"probe_walk": 0, "probe_scan": 0}

# the last walk launch's grid (blocks, threads per block), for reports
LAST_WALK_GRID = [0, 0]


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


# ------------------------------------------------------- plain: one group
def device_probe_walk_plain(
    q_words, q_sub, z_sub, pow1, pow0, t_stop, k, s_len, budget, tbl,
    step_ext, idx1, idx0, maxi1, maxi0, widths, offsets, bucket_ids, db_pad,
    inv_pos, *, p, tile, cap, kmax, check_every,
):
    """The per-z-group walk in plain PyTorch (a port of the reference's
    ``device_probe_walk``). Returns (posmap (B, n_pad) int32, probes (B,)
    int32, retrieved (B,) int32, done (B,) bool, cursor int, iters int)."""
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

    posmap = torch.full((B, n_pad), POS_INF, dtype=_I32, device=dev)
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
    return posmap, probes, retrieved, done, cursor, it


# ------------------------------------------------------ plain: all groups
def device_probe_walk_batched_plain(
    posmap_in, q_words, q_sub, z_sub, pow1, pow0, gid, t_stop, k, budget,
    g_start, g_end, tbl, step_flat, idx1, idx0, maxi1, maxi0, widths,
    offsets, bucket_ids, db_pad, inv_pos, *, p, tile, cap, kmax, check_every,
):
    """The cross-z-group walk in plain PyTorch (a port of the reference's
    ``device_probe_walk_batched``). ``posmap_in`` is filled with POS_INF
    and returned as the position map. Returns (posmap, probes, retrieved,
    done, cursor (G,) int32, iters int)."""
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

    posmap = posmap_in.fill_(POS_INF)
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
    return posmap, probes, retrieved, done, cursor, it


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


# ------------------------------------------------------------------ kernels
def _walk_kernel(lib, posmap, q_words, q_sub, z_sub, pow1, pow0, gid, t_stop,
                 k, budget, g_start, g_end, tbl, step, idx1, idx0, maxi1,
                 maxi0, widths, offsets, bucket_ids, db_pad, inv_pos, *, p,
                 tile, cap, kmax, check_every, stream):
    """Launch ``csrc/probe_walk.cu`` on already-placed operands. Returns
    (posmap, probes, retrieved, done bool, cursor (G,), iters (1,))."""
    dev = q_words.device
    B, W = q_words.shape
    m = q_sub.shape[1]
    wp1 = pow1.shape[2]
    G = g_start.shape[0]
    Pt = tbl.shape[0]
    V = offsets.shape[1]
    n_pad = db_pad.shape[0]
    pp2 = inv_pos.shape[1]
    if n_pad % 4 or posmap.data_ptr() % 16:
        raise ValueError("the position map must be 16-byte aligned rows "
                         "of a multiple of 4 words")

    def new(*shape):
        return torch.empty(shape, dtype=_I32, device=dev)

    scratch = dict(
        hist=new(B, pp2), lo=new(B, tile), adj=new(B, tile),
        vfl=new(B, tile), csum=new(B, tile), ntake=new(G),
        cursor=new(2 * G), off=new(2 * G), done=new(2 * B),
    )
    out = dict(probes=new(B), retrieved=new(B), done=new(B),
               cursor=new(G), iters=new(1))
    req = _build.require
    ptrs = [
        req(posmap, "posmap", (B, n_pad), dev),
        scratch["hist"].data_ptr(),
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
        out["iters"].data_ptr(),
    ]
    sc = [B, G, W, m, wp1, V, n_pad, Pt, pp2, pp2, tile, cap, kmax,
          max(1, int(check_every)), int(k), int(budget), p]
    info = (ctypes.c_int * 2)()
    _build.call(lib, "probe_walk", ptrs, sc, stream, info)
    LAST_WALK_GRID[:] = [info[0], info[1]]
    return (posmap, out["probes"], out["retrieved"], out["done"].bool(),
            out["cursor"], out["iters"])


def _scan_kernel(lib, q_words, gid, db_pad, inv_pos, n_valid, out, *, p,
                 stream):
    """Launch ``csrc/probe_scan.cu`` into ``out`` (B, n_pad)."""
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


def _require_cuda(t) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


# ---------------------------------------------------------------- wrappers
def device_probe_walk_batched(
    posmap_in, q_words, q_sub, z_sub, pow1, pow0, gid, t_stop, k, budget,
    g_start, g_end, tbl, step_flat, idx1, idx0, maxi1, maxi0, widths,
    offsets, bucket_ids, db_pad, inv_pos, *, p, tile, cap, kmax, check_every,
):
    """Cross-z-group fused walk: ONE kernel launch per batch. Same operands
    and outputs as ``device_probe_walk_batched_plain`` (which runs for CPU
    tensors); ``posmap_in`` is overwritten and returned as the map."""
    args = (posmap_in, q_words, q_sub, z_sub, pow1, pow0, gid, t_stop, k,
            budget, g_start, g_end, tbl, step_flat, idx1, idx0, maxi1, maxi0,
            widths, offsets, bucket_ids, db_pad, inv_pos)
    kw = dict(p=p, tile=tile, cap=cap, kmax=kmax, check_every=check_every)
    if q_words.device.type == "cpu":
        return device_probe_walk_batched_plain(*args, **kw)
    _require_cuda(q_words)
    out = _walk_kernel(_build.load("probe_walk"), *args, **kw,
                       stream=_build.stream_of(q_words.device))
    LAUNCHES["probe_walk"] += 1
    return out


def device_probe_walk(
    q_words, q_sub, z_sub, pow1, pow0, t_stop, k, s_len, budget, tbl,
    step_ext, idx1, idx0, maxi1, maxi0, widths, offsets, bucket_ids, db_pad,
    inv_pos, *, p, tile, cap, kmax, check_every,
):
    """One z-group's fused walk: the batched kernel with G = 1. Same
    operands and outputs as ``device_probe_walk_plain``."""
    kw = dict(p=p, tile=tile, cap=cap, kmax=kmax, check_every=check_every)
    if q_words.device.type == "cpu":
        return device_probe_walk_plain(
            q_words, q_sub, z_sub, pow1, pow0, t_stop, k, s_len, budget, tbl,
            step_ext, idx1, idx0, maxi1, maxi0, widths, offsets, bucket_ids,
            db_pad, inv_pos, **kw,
        )
    _require_cuda(q_words)
    dev = q_words.device
    B = q_words.shape[0]
    P = tbl.shape[0]
    posmap = torch.empty((B, db_pad.shape[0]), dtype=_I32, device=dev)
    gid = torch.zeros(B, dtype=_I32, device=dev)
    g_start = torch.zeros(1, dtype=_I32, device=dev)
    g_end = torch.full((1,), int(s_len), dtype=_I32, device=dev)
    posmap, probes, retrieved, done, cursor, iters = _walk_kernel(
        _build.load("probe_walk"), posmap, q_words, q_sub, z_sub, pow1, pow0,
        gid, t_stop, k, budget, g_start, g_end, tbl, step_ext[:P], idx1,
        idx0, maxi1, maxi0, widths, offsets, bucket_ids, db_pad,
        inv_pos[None, :], **kw, stream=_build.stream_of(dev),
    )
    LAUNCHES["probe_walk"] += 1
    return posmap, probes, retrieved, done, cursor[0], iters


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
