"""The port's CUDA kernel sources, compiled with g++ against a CPU
emulation of the CUDA subset they use (``tests/cuda_emu/``), held against
their plain PyTorch versions on the CPU by equality.

The emulation runs a cooperative launch as one block of threads (a grid
sync is then a block barrier), so it checks each kernel's arithmetic,
phase order, scans and atomics — not its speed, its multi-block
distribution or the real compiler, which only the card has. The tests
skip where no ``g++`` is installed.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.engine import make_engine
from repro_torch.data.synthetic import (
    synthetic_binary_codes_packed,
    synthetic_queries_packed,
)
from repro_torch.kernels import _build
from repro_torch.kernels import blockmax_scan as bm
from repro_torch.kernels import device_probe as dp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hamming_scan as hs
from repro_torch.kernels import ops
from repro_torch.kernels import verify_tuples as vt

EMU = Path(__file__).resolve().parent / "cuda_emu"


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for the CPU emulation")
    out = tmp_path_factory.mktemp("cuda_emu")
    procs = {}
    for name, src in _build.KERNELS.items():
        lib = out / f"lib{name}.so"
        cmd = [gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
               "-Wno-unknown-pragmas", f"-I{EMU}", "-x", "c++",
               str(_build.CSRC / src), "-o", str(lib), "-lpthread"]
        procs[name] = (subprocess.Popen(cmd, stderr=subprocess.PIPE,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _same(got, want):
    for g, w in zip(got, want):
        g = torch.as_tensor(g).to(torch.int64)
        w = torch.as_tensor(w).to(torch.int64)
        assert torch.equal(g.reshape(w.shape), w)


def _offset(t):
    """A copy of ``t`` in a view that starts 4 bytes past a 16-byte
    boundary (the kernels' vector loads must not take it)."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = buf[1 : 1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


def _verify_operands(p, B, C, N, seed):
    """Random codes and candidates; lens 0, C, a ragged middle value and
    random ones; a live slot that holds the last row."""
    rng = np.random.default_rng(seed)
    W = (p + 31) // 32
    words = rng.integers(0, 1 << 32, size=(N + B, W), dtype=np.uint64)
    words = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    db, q = words[:N].contiguous(), words[N:].contiguous()
    idx = torch.from_numpy(rng.integers(0, N, size=(B, C)).astype(np.int32))
    idx[1, -1] = N - 1
    lens = torch.from_numpy(rng.integers(0, C + 1, size=B).astype(np.int32))
    lens[:3] = torch.tensor([0, C, C // 2 + 1], dtype=torch.int32)[:B]
    return q, db, idx, lens


# (p, B, C, offset idx, offset codes): W = 1 to 8 and 10 (the runtime-W
# form), C in {1, 7, 300, 1024, 2100} (2100: blocks wholly past a length),
# index and code views off their 16-byte boundary (codes so placed take
# the scalar-load form)
VERIFY_CASES = [
    pytest.param((64, 5, 300, False, False), id="64"),
    pytest.param((128, 5, 300, False, False), id="128"),
    pytest.param((32, 3, 1, False, False), id="w1-c1"),
    pytest.param((64, 3, 7, False, True), id="w2-c7-offset-codes"),
    pytest.param((96, 3, 7, True, False), id="w3-c7-offset-idx"),
    pytest.param((128, 4, 1024, False, True), id="w4-c1024-offset-codes"),
    pytest.param((160, 5, 1024, False, False), id="w5-c1024"),
    pytest.param((192, 4, 300, True, True), id="w6-c300-offset-both"),
    pytest.param((224, 3, 2100, False, False), id="w7-c2100"),
    pytest.param((256, 5, 1024, True, False), id="w8-c1024-offset-idx"),
    pytest.param((256, 3, 300, False, True), id="w8-c300-offset-codes"),
    pytest.param((320, 3, 300, False, False), id="w10-c300"),
]


@pytest.mark.parametrize("case", VERIFY_CASES)
def test_emulated_grouped_verify_equals_plain(emu, case):
    p, B, C, off_idx, off_db = case
    q, db, idx, lens = _verify_operands(p, B, C, 400, seed=p + C)
    if off_idx:
        idx = _offset(idx)
    if off_db:
        db = _offset(db)
    out = torch.empty((B, C), dtype=torch.int32)
    vt._launch(emu["verify_grouped"], q, db, idx, lens, out, p, 0)
    assert torch.equal(out,
                       vt.gather_verify_grouped_plain(q, db, idx, lens, p))


def _record_calls(db, q, p, **engine_kw):
    """Operands of the walk and scan launches of a CPU device-path run: a
    fused batch, then per-group walks over its first four queries."""
    calls = {}
    names = ("device_probe_walk_batched", "device_probe_walk",
             "device_probe_scan_topk")
    orig = {nm: getattr(dp, nm) for nm in names}

    def keep(nm):
        def f(*a, **kw):
            calls.setdefault(nm, (a, kw))
            if nm == "device_probe_scan_topk":    # fused, then per group
                calls.setdefault("scan_calls", []).append((a, kw))
            return orig[nm](*a, **kw)
        return f

    for nm in names:
        setattr(dp, nm, keep(nm))
    try:
        eng = make_engine("amih", db, p, m=4, probe_backend="device",
                          query_cache_size=0, device="cpu", **engine_kw)
        eng.knn_batch(q, 8)                   # fused walk (+ scan)
        eng.index.probe_fused = False
        eng.knn_batch(q[:4], 8)               # per-group walks (+ scans)
    finally:
        for nm in names:
            setattr(dp, nm, orig[nm])
    return calls


@pytest.fixture(scope="module")
def walk_calls():
    """Mixed z-groups, a truncated stream so queries bail to the scan."""
    p, n = 64, 3000
    db = synthetic_binary_codes_packed(n, p, seed=3)
    q = synthetic_queries_packed(db, p, 12, seed=4)
    return _record_calls(db, q, p, probe_stream_cap=256)


@pytest.fixture(scope="module")
def dup_walk_calls():
    """30 distinct codes, each stored 100 times: buckets of 100 and more
    ids, over a small cap."""
    p, n = 64, 3000
    base = synthetic_binary_codes_packed(30, p, seed=5)
    db = base[np.arange(n) % 30]
    q = synthetic_queries_packed(base, p, 12, seed=6)
    return _record_calls(db, q, p)


def _inf_map(like):
    return torch.full_like(like, dp.POS_INF)


def _batched_walk(emu, walk_calls, check_every, form, cap=None):
    a, kw = walk_calls["device_probe_walk_batched"]
    kw = dict(kw, check_every=check_every, cap=cap or kw["cap"])
    want = dp.device_probe_walk_batched_plain(_inf_map(a[0]), *a[1:], **kw)
    pm = _inf_map(a[0])
    got = dp._walk_kernel(emu["probe_walk"], pm, *a[1:], **kw, stream=0,
                          form=form)
    assert dp.LAST_WALK_GRID[2] == form
    _same(dp.walk_canonical(got, kw["cap"]),
          dp.walk_canonical(want, kw["cap"]))
    # the lists name exactly the lowered entries, and the histograms count
    # their positions
    touched, n_touched, hist = got[6:]
    touched = touched[:, :int(got[5]) * kw["cap"]]
    for b in range(pm.shape[0]):
        ids = touched[b][touched[b] >= 0].long()
        assert int(n_touched[b]) == ids.numel()
        assert torch.equal(ids.sort().values,
                           torch.nonzero(pm[b] != dp.POS_INF).flatten())
        assert torch.equal(torch.bincount(pm[b, ids].long(),
                                          minlength=hist.shape[1]),
                           hist[b].long())
    _extractions(emu, pm, got, want, a[7], kw["cap"])


def _extractions(emu, pm, got, want, t_stop, cap):
    """The extraction kernel after the kernel walk against the plain
    extraction after the plain walk, on the rows the walk finished, at
    k = 1, 8 and 300; both maps all POS_INF after."""
    done = torch.nonzero(want[3]).flatten().numpy()
    width = int(want[5]) * cap
    for k in (1, 8, 300):
        pm_k, pm_p = pm.clone(), want[0].clone()
        ids, pos = dp._extract_kernel(emu["probe_walk"], pm_k, got[6],
                                      got[8], t_stop, k, done, width,
                                      stream=0)
        w_ids, w_pos = dp.extract_touched_plain(pm_p, want[6], want[8],
                                                t_stop, k, done, width)
        _same((ids, pos), (w_ids, w_pos))
        assert bool((pm_k == dp.POS_INF).all())
        assert bool((pm_p == dp.POS_INF).all())


def _group_walk(emu, walk_calls, check_every, form, cap=None):
    a, kw = walk_calls["device_probe_walk"]
    kw = dict(kw, check_every=check_every, cap=cap or kw["cap"])
    kw.pop("posmap_in", None)          # the engine's pooled map
    (q_words, q_sub, z_sub, pow1, pow0, t_stop, k, s_len, budget, tbl,
     step_ext, idx1, idx0, maxi1, maxi0, widths, offsets, ids, db_pad,
     inv_pos) = a
    want = dp.device_probe_walk_plain(*a, **kw)
    B, P = q_words.shape[0], tbl.shape[0]
    i32 = torch.int32
    got = dp._walk_kernel(
        emu["probe_walk"],
        torch.full((B, db_pad.shape[0]), dp.POS_INF, dtype=i32),
        q_words, q_sub, z_sub, pow1, pow0, torch.zeros(B, dtype=i32), t_stop,
        k, budget, torch.zeros(1, dtype=i32),
        torch.full((1,), s_len, dtype=i32), tbl, step_ext[:P], idx1, idx0,
        maxi1, maxi0, widths, offsets, ids, db_pad, inv_pos[None, :], **kw,
        stream=0, form=form,
    )
    assert dp.LAST_WALK_GRID[2] == form
    _extractions(emu, got[0], got, want, t_stop, kw["cap"])
    got = dp.walk_canonical(got, kw["cap"])
    want = dp.walk_canonical(want, kw["cap"])
    _same(got[:4] + got[6:], want[:4] + want[6:])
    assert int(got[4][0]) == want[4] and int(got[5][0]) == want[5]


@pytest.mark.parametrize("check_every", [1, 3])
def test_emulated_batched_walk_equals_plain(emu, walk_calls, check_every):
    _batched_walk(emu, walk_calls, check_every, "grid")


@pytest.mark.parametrize("check_every", [1, 3])
def test_emulated_group_walk_equals_plain(emu, walk_calls, check_every):
    _group_walk(emu, walk_calls, check_every, "grid")


@pytest.mark.parametrize("check_every", [1, 3])
def test_emulated_cluster_walk_equals_plain(emu, walk_calls, check_every):
    """K2's cluster form (one cluster, the tile in each block's shared
    memory) on the same operands as the grid form's one-group walk; a
    launch it cannot take (several z-groups) is refused."""
    _group_walk(emu, walk_calls, check_every, "cluster")
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _batched_walk(emu, walk_calls, check_every, "cluster")


@pytest.mark.parametrize("form", ["grid", "cluster"])
def test_emulated_walks_with_buckets_over_cap(emu, dup_walk_calls, form):
    """The walks with cap = 8 candidate slots an iteration over buckets of
    100 and more ids (both in the grid form, the one-group walk in the
    cluster form): entry 0 is taken in parts (the resume offset), and the
    walk runs into its budget."""
    for ce in (1, 3):
        if form == "grid":
            _batched_walk(emu, dup_walk_calls, ce, form, cap=8)
        _group_walk(emu, dup_walk_calls, ce, form, cap=8)


def test_emulated_scans_equal_plain(emu, walk_calls):
    """The map-writing K3 on the bail scans' operands: the cross-group
    call (an inv_pos row per query) and a per-group one (one row)."""
    (multi, kw), (group, _) = walk_calls["scan_calls"][:2]
    assert group[4].shape[0] == 1 and multi[4].shape[0] > 1
    q_words, gid, _, db_pad, inv_pos, n_valid, _ = multi
    out = torch.empty((q_words.shape[0], db_pad.shape[0]), dtype=torch.int32)
    dp._scan_kernel(emu["probe_scan"], q_words, gid, db_pad, inv_pos,
                    n_valid, out, p=kw["p"], stream=0)
    assert torch.equal(out, dp.device_probe_scan_multi_plain(
        q_words, gid, db_pad, inv_pos, n_valid, **kw))
    q_words, _, _, db_pad, inv_pos, n_valid, _ = group
    out = torch.empty((q_words.shape[0], db_pad.shape[0]), dtype=torch.int32)
    dp._scan_kernel(emu["probe_scan"], q_words,
                    torch.zeros(q_words.shape[0], dtype=torch.int32), db_pad,
                    inv_pos, n_valid, out, p=kw["p"], stream=0)
    assert torch.equal(out, dp.device_probe_scan_plain(
        q_words, db_pad, inv_pos[0], n_valid, **kw))


def _fused_scan_case(p, n, B, seed, dup):
    """Operands of one fused-scan call from a CPU device-path index:
    queries of mixed popcount (several share one), their stack rows and
    t_stop (full walks, short ones that leave fewer than k, and -1);
    ``dup`` repeats five codes, so positions tie across every row tile."""
    from repro_torch.core.probe_device import get_schedule_stack

    db = synthetic_binary_codes_packed(n, p, seed=seed, n_clusters=4)
    if dup:
        db = db[np.arange(n) % 5]
    q = synthetic_queries_packed(db, p, B, seed=seed + 1)
    q[1] = q[0]
    eng = make_engine("amih", db, p, probe_backend="device",
                      query_cache_size=0, device="cpu")
    index = eng.index
    csr = index.device_csr
    stack = get_schedule_stack(p, index.m, csr["widths"],
                               index.probe_stream_cap)
    zs = np.bitwise_count(q).sum(axis=1)
    gid = np.array([stack.row(int(z)) for z in zs], dtype=np.int32)
    L = np.array([stack.scheds[g].L for g in gid])
    t_stop = (L - 1).astype(np.int32)
    t_stop[2 % B] = 3                       # fewer than k within t_stop
    t_stop[-1] = -1 if B > 3 else t_stop[-1]
    bundle = stack.device_arrays("cpu")
    return (torch.from_numpy(q.view(np.int32)), torch.from_numpy(gid),
            torch.from_numpy(t_stop), csr["db_pad"], bundle["inv_pos"],
            csr["n"])


# (p, n, B, k, tile_rows, dup): p in {32, 64, 128}, row tiles of one and of
# several steps, segments of one query and of several (the QT cut at
# k = 1024), k = 1 and at the kernel's cap, ties across tiles
FUSED_SCAN_CASES = [
    (32, 1500, 6, 1, 256, False),
    (64, 2000, 9, 10, 512, True),
    (128, 1200, 5, 100, 256, True),
    (64, 2600, 7, 1024, 1024, True),
    (128, 900, 3, 7, 768, False),
]


@pytest.mark.parametrize("case", FUSED_SCAN_CASES)
def test_emulated_fused_scan_equals_plain(emu, case):
    """The fused K3 (both passes) against its plain version (the map scan,
    then ``extract_map``) by equality: ids, positions, verified."""
    p, n, B, k, tile_rows, dup = case
    a = _fused_scan_case(p, n, B, seed=p + B, dup=dup)
    got = dp._scan_topk_kernel(emu["probe_scan"], *a, k, p=p, stream=0,
                               n_sm=1, tile_rows=tile_rows)
    want = dp.device_probe_scan_topk_plain(*a, k, p=p, chunk=256 if
                                           a[3].shape[0] % 256 == 0 else 8)
    _same(got, want)
    plan = dp.scan_topk_plan(*(x.numpy() for x in (a[1],)),
                             np.bitwise_count(a[0].numpy().view(np.uint32))
                             .sum(axis=1), k, int(a[5]), 1, a[0].shape[1], p,
                             tile_rows)
    assert plan["n_tiles"] > 1
    if B > 3:                  # segments that hold queries of several z
        assert plan["tabs"].shape[0] > plan["segs"].shape[0]
    if dup:                                   # ties cross the k-th slot
        pm = dp.device_probe_scan_multi_plain(*a[:2], *a[3:6], p=p, chunk=8)
        kth = want[1][0, -1]
        assert int(kth) >= 0 and int((pm[0] == kth).sum()) > int(
            (want[1][0] == kth).sum())


def test_emulated_fused_scan_on_the_engines_bails(emu, walk_calls):
    """The fused K3 on the engine's own bail calls (cross-group and per
    group), with a row tile that cuts the codes into several tiles."""
    for a, kw in walk_calls["scan_calls"]:
        k = a[6]
        got = dp._scan_topk_kernel(emu["probe_scan"], *a[:6], k, p=kw["p"],
                                   stream=0, n_sm=1, tile_rows=512)
        _same(got, dp.device_probe_scan_topk_plain(*a, **kw))


def _scan_operands(p, B, N, seed):
    """Clustered codes with an all-zero code, and queries near them with a
    zero-norm query: every branch of the Eq. 3 score."""
    db = synthetic_binary_codes_packed(N, p, seed=seed, n_clusters=8)
    q = synthetic_queries_packed(db, p, B, seed=seed + 1)
    db[5] = 0
    if B > 1:
        q[1] = 0
    q = torch.from_numpy(q.view(np.int32))
    return q, ops.query_popcounts(q), torch.from_numpy(db.view(np.int32))


@pytest.mark.parametrize("p", [64, 128, 200])
def test_emulated_hamming_scan_equals_plain(emu, p):
    q, z, db = _scan_operands(p, 11, 300, seed=p)   # ragged query tile
    out = torch.empty((11, 300), dtype=torch.float32)
    hs._launch(emu["hamming_scan"], q, z, db, out, 0)
    want = hs.hamming_scan_scores_plain(q, z, db)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


# (p, B, N, k, tile_rows, codes, n_valid, row_ids): several row tiles of
# several steps, code widths of 2, 3, 4, 7 and 8 words (scalar and 16-byte
# loads), B in {1, 2, 3, 8, 17} (17: two query tiles; 1: four rows a thread
# per step), k in {1, 10, 100} and at a key cap (128, and 1024: L = 2048);
# codes "dup": five distinct codes (ties across every tile boundary, and
# staging areas that fill within a step), "tile": every row tile a copy of
# the first (pass 2 gets ~20 x 99 keys above its starting bound, more than
# its staging area holds); n_valid as an int with row ids and as a device
# scalar below k
TOPK_EMU_CASES = [
    (64, 1, 700, 1, 512, None, None, False),
    (128, 3, 1000, 10, 512, None, None, False),
    (200, 8, 1500, 100, 512, "dup", None, False),
    (256, 17, 1500, 128, 512, "dup", None, False),
    (128, 3, 2600, 1024, 1024, "dup", None, False),
    (128, 1, 3000, 100, 2048, "dup", None, False),
    (64, 2, 20 * 512, 100, 512, "tile", None, False),
    (96, 8, 900, 10, 512, None, 600, True),
    (64, 3, 800, 50, 512, "dup", "tensor", False),
]


@pytest.mark.parametrize("case", TOPK_EMU_CASES)
def test_emulated_fused_topk_equals_plain(emu, case):
    """The fused K4 top-k (both passes) against ``hamming_scan_topk_plain``
    by equality: the sims' bits and the ids."""
    p, B, N, k, tile_rows, codes, n_valid, row_ids = case
    q, z, db = _scan_operands(p, B, N, seed=B + k)
    if codes is not None:
        db = db[torch.arange(N) % (5 if codes == "dup" else tile_rows)]
        db = db.contiguous()
    if n_valid == "tensor":
        n_valid = torch.tensor(k // 2, dtype=torch.int32)
    rid = torch.arange(N, dtype=torch.int32) * 3 if row_ids else None
    plan = hs.topk_plan(B, N, k, 1, tile_rows=tile_rows)
    assert plan["n_tiles"] > 1 and tile_rows > hs.TOPK_THREADS
    sims = torch.empty((B, k), dtype=torch.float32)
    ids = torch.empty((B, k), dtype=torch.int32)
    part = torch.empty((B, plan["n_tiles"], k), dtype=torch.int64)
    hs._launch_topk(emu["hamming_scan"], q, z, db, k, n_valid, rid, sims, ids,
                    part, plan, 0)
    ws, wi = hs.hamming_scan_topk_plain(q, z, db, k, n_valid, rid, chunk=97)
    assert torch.equal(sims.view(torch.int32), ws.view(torch.int32))
    assert torch.equal(ids, wi)
    if codes == "dup" and n_valid is None:   # ties cross the k-th slot
        scores = hs.hamming_scan_scores_plain(q, z, db)
        kth = ws[:, -1:]
        assert bool(((scores == kth).sum(1) > (ws == kth).sum(1)).all())


# (p, B, N, blk, offset codes): W = 1, 2, 3, 4, 7 and 8; B = 1 (the
# one-query form, four rows a thread per step), 11, 17 and 33 (ragged
# query tiles); blk 1, 37, 128, 2048 and N + 5 (below and above a step,
# not a multiple of it, a ragged last block, one block past N); codes in a
# view off its 16-byte boundary (the scalar-load form). Three kernel
# blocks a query tile, each walking several row blocks.
BLOCKMAX_CASES = [
    pytest.param((128, 11, 700, 128, False), id="128"),
    pytest.param((128, 11, 700, 2048, False), id="2048"),
    pytest.param((32, 1, 300, 1, False), id="w1-b1-blk1"),
    pytest.param((64, 17, 700, 37, False), id="w2-b17-blk37"),
    pytest.param((96, 33, 600, 128, False), id="w3-b33-blk128"),
    pytest.param((200, 11, 500, 37, False), id="w7-b11-blk37"),
    pytest.param((256, 17, 900, 2048, False), id="w8-b17-blk2048"),
    pytest.param((256, 1, 1500, 128, False), id="w8-b1-blk128"),
    pytest.param((128, 1, 2500, 2048, False), id="w4-b1-blk2048"),
    pytest.param((64, 33, 150, 1, False), id="w2-b33-blk1"),
    pytest.param((128, 17, 705, "N+5", True), id="w4-b17-blkN5-offset"),
    pytest.param((256, 11, 600, "N+5", True), id="w8-b11-blkN5-offset"),
    pytest.param((96, 1, 400, 37, True), id="w3-b1-blk37-offset"),
]


@pytest.mark.parametrize("case", BLOCKMAX_CASES)
def test_emulated_blockmax_equals_plain(emu, case):
    p, B, N, blk, off = case
    blk = N + 5 if blk == "N+5" else blk
    q, z, db = _scan_operands(p, B, N, seed=blk + B)
    if off:
        db = _offset(db)
    out = torch.empty((B, -(-N // blk)), dtype=torch.float32)
    plan = bm.blockmax_plan(B, N, blk, 1, W=q.shape[1])
    bm._launch(emu["blockmax_scan"], q, z, db, out, blk, plan, 0)
    want = bm.blockmax_scores_plain(q, z, db, blk)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("p", [64, 128])
def test_emulated_verify_tuples_equals_plain(emu, p):
    q, _, db = _scan_operands(p, 2, 600, seed=p + 1)
    r10 = torch.empty(600, dtype=torch.int32)
    r01 = torch.empty(600, dtype=torch.int32)
    vt._launch_one(emu["verify_tuples"], q[0].contiguous(), db, r10, r01, 0)
    _same((r10, r01), vt.verify_tuples_plain(q[0], db))


# (B, Sq, Sk, Hq, Hkv, D, causal, window, valid_len): GQA and MQA, a ragged
# query tile, a window, decode over part of a cache, no key at all
FLASH_CASES = [
    (1, 20, 20, 2, 2, 32, True, 0, None),
    (1, 37, 50, 4, 1, 64, False, 0, None),
    (1, 33, 40, 2, 1, 32, True, 16, None),
    (2, 3, 60, 4, 2, 32, False, 8, 37),
    (1, 4, 20, 2, 1, 32, False, 0, 0),
    # head dims between the instantiation widths (16, 48, kimi-k2's 112)
    # and one the bf16 path pads for TMA (20)
    (1, 20, 20, 2, 2, 16, True, 0, None),
    (1, 37, 50, 4, 1, 48, False, 16, None),
    (2, 3, 60, 4, 2, 112, False, 8, 37),
    (1, 9, 30, 2, 1, 20, True, 0, None),
    # head dims above 256 (the wide kernel: 256-column chunks of the
    # scores, 256-wide output slices) and 96 q heads per kv head (two head
    # tiles of the bf16 path)
    (1, 20, 30, 2, 1, 320, True, 0, None),
    (2, 3, 40, 2, 2, 512, False, 8, 37),
    (1, 5, 40, 96, 1, 64, True, 0, None),
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_flash_attention_matches_plain(emu, case, dtype):
    """K7 against its plain version in float32: within 2e-5 for float32
    inputs (the sums run in other orders), and for bf16 inputs within 4e-3,
    half a bf16 step below 1 plus that slack (v is drawn from [-1, 1), so
    every output, an average of v rows, lies below 1)."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, valid_len = case
    rng = np.random.default_rng(Sq + Sk)
    q = torch.from_numpy(rng.normal(size=(B, Sq, Hq, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-1, 1, size=(B, Sk, Hkv, D))
                         .astype(np.float32))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    out = torch.empty_like(q)
    fa._launch(emu["flash_attention"], q, k, v, out, causal, window,
               valid_len, 0)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=causal, window=window,
                                    valid_len=valid_len)
    tol = 2e-5 if dtype == torch.float32 else 4e-3
    assert out.dtype == dtype
    assert float((out.float() - want).abs().max()) <= tol


# bf16 only, the tensor-core path: G = 8 with 64-row tiles that straddle
# positions, Sk over three kv tiles, a window of 24, decode at D = 256 with
# valid_len = 37, and G = 3 (tiles that straddle a head group)
FLASH_BF16_CASES = [
    (1, 130, 130, 8, 1, 128, True, 0, None),
    (1, 130, 130, 8, 1, 256, True, 0, None),
    (1, 100, 160, 8, 1, 128, True, 24, None),
    (1, 70, 70, 8, 1, 256, False, 24, None),
    (2, 1, 160, 8, 1, 256, False, 0, 37),
    (1, 4, 160, 8, 1, 256, False, 16, 100),
    (1, 37, 50, 6, 2, 64, True, 0, None),
]


@pytest.mark.parametrize("case", FLASH_BF16_CASES)
def test_emulated_flash_attention_bf16_tiles_match_plain(emu, case):
    """K7's bf16 path (GQA-packed 64-row tiles, wgmma products emulated)
    against the plain version in float32, within 4e-3 (half a bf16 step
    below 1 plus that slack, as above)."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, valid_len = case
    rng = np.random.default_rng(Sq * 7 + Sk + D)
    q = torch.from_numpy(rng.normal(size=(B, Sq, Hq, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-1, 1, size=(B, Sk, Hkv, D))
                         .astype(np.float32))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    out = torch.empty_like(q)
    fa._launch(emu["flash_attention"], q, k, v, out, causal, window,
               valid_len, 0)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=causal, window=window,
                                    valid_len=valid_len)
    assert float((out.float() - want).abs().max()) <= 4e-3


def _sw128(off):
    """The 128-byte swizzle of shared-memory byte offsets (16-byte chunk
    index XOR the 128-byte row index mod 8)."""
    return off ^ ((off >> 3) & 0x70)


def _desc(addr, lbo, sbo):
    """A wgmma shared-memory descriptor in the 128-byte swizzle."""
    return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | \
        ((sbo >> 4) << 32) | (1 << 62)


@pytest.mark.parametrize("trans_b", [0, 1])
@pytest.mark.parametrize("step", [0, 3])
def test_emulated_wgmma_tile_matches_matmul(emu, trans_b, step):
    """The emulated m64n64k16 product alone on one tile, against
    ``torch.matmul`` in float32: A and B are laid out here from the PTX
    ISA's canonical layouts (rows of 64 bf16, 128-byte swizzle; B K-major,
    or MN-major with the transpose bit), the descriptors start ``step``
    16-deep slices in, and the 128 threads' registers are read back through
    the documented accumulator fragment. Sums of 16 exact products in
    float32: within 1e-5."""
    rng = np.random.default_rng(10 + trans_b + step)
    a = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    r, c = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    img = np.zeros(8192, np.uint16)                # A at 0, B at 8192
    for base, x in ((0, a), (8192, b)):
        img[(base + _sw128(r * 128 + 2 * c)) // 2] = \
            x.view(torch.int16).numpy().astype(np.uint16)
    if trans_b:     # B (k, n) = b[16 step + k, n]: k rows, n contiguous
        db = _desc(8192 + 2048 * step, 1024, 1024)
        bm_ = b[16 * step:16 * step + 16, :]
    else:           # B (k, n) = b[n, 16 step + k]: n rows, k contiguous
        db = _desc(8192 + 32 * step, 16, 1024)
        bm_ = b[:, 16 * step:16 * step + 16].T
    want = torch.matmul(a[:, 16 * step:16 * step + 16].float(), bm_.float())
    frag = np.zeros((128, 32), np.float32)
    lib = emu["flash_attention"]
    fn = lib.sm90_emu_mma_tile
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong,
                   ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    raw = img.view(np.uint8)
    assert fn(raw.ctypes.data, raw.nbytes, _desc(32 * step, 16, 1024), db,
              trans_b, frag.ctypes.data) == 0
    t, i = np.meshgrid(np.arange(128), np.arange(32), indexing="ij")
    w, lane = t // 32, t % 32
    m = 16 * w + lane // 4 + 8 * ((i // 2) % 2)
    n = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    got = torch.zeros((64, 64))
    got[torch.from_numpy(m), torch.from_numpy(n)] = torch.from_numpy(frag)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_flash_attention_bf16_operands_the_kernel_cannot_take_raise():
    """The bf16 kernel's TMA copies need 16-byte aligned operands:
    anything else raises before a launch."""
    flat = torch.zeros(4 * 2 * 64 + 1, dtype=torch.bfloat16)
    q = flat[1:].view(1, 4, 2, 64)                 # 2 bytes off 16
    kv = torch.zeros((1, 4, 1, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa._launch(None, q, kv, kv, torch.empty(q.shape, dtype=q.dtype), True,
                   0, None, 0)


class _RecordLaunch:
    """A stand-in kernel library: records the scalars of each launch."""

    def __init__(self):
        self.scalars = []

    def __getattr__(self, name):
        def launch(ptrs, scalars, stream):
            self.scalars.append(list(scalars[:11]))
            return 0
        return launch


@pytest.mark.parametrize("D", [16, 48, 112, 20, 3, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_takes_every_head_dim_up_to_256(D, dtype):
    """No head dim 1 <= D <= 256 is refused before the launch: the kernel
    gets the row width it reads (a multiple of 8 for bf16, whose TMA row
    strides need 16 bytes: D is padded with zero columns there) and the
    true D for the scale."""
    q = torch.zeros((1, 4, 2, D), dtype=dtype)
    kv = torch.zeros((1, 4, 1, D), dtype=dtype)
    lib = _RecordLaunch()
    fa._launch(lib, q, kv, kv, torch.empty_like(q), True, 0, None, 0)
    row = -(-D // 8) * 8 if dtype == torch.bfloat16 else D
    assert lib.scalars == [[1, 4, 4, 2, 1, row,
                            int(dtype == torch.bfloat16), 1, 0, -1, D]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_runs_head_dims_above_256(dtype):
    """D > 256 and more than 64 q heads per kv head reach the kernel: the
    wide route gets the true D (bf16 on float32 copies), and 96 heads over
    one kv head launch as they are."""
    for D, Hq in ((257, 2), (512, 2), (64, 96)):
        q = torch.zeros((1, 4, Hq, D), dtype=dtype)
        kv = torch.zeros((1, 4, 1, D), dtype=dtype)
        lib = _RecordLaunch()
        fa._launch(lib, q, kv, kv, torch.empty_like(q), True, 0, None, 0)
        wide = D > fa.MAX_HEAD_DIM
        bf16 = int(dtype == torch.bfloat16 and not wide)
        assert lib.scalars == [[1, 4, 4, Hq, 1, D, bf16, 1, 0, -1, D]]


def test_ptxas_report_reads_registers_smem_and_spills(monkeypatch):
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z27flash_attention_bf16_kernelILi256EEv12FlashTmaArgs' for 'sm_90a'
ptxas info    : Function properties for _Z27flash_attention_bf16_kernelILi256EEv12FlashTmaArgs
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 238 registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_Z22flash_attention_kernelIfLi32EEv9FlashArgs' for 'sm_90a'
ptxas info    : Function properties for _Z22flash_attention_kernelIfLi32EEv9FlashArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 13312 bytes smem, 400 bytes cmem[0]
"""
    monkeypatch.setattr(_build, "build_log", lambda name: log)
    assert _build.ptxas_report("flash_attention") == {
        "_Z27flash_attention_bf16_kernelILi256EEv12FlashTmaArgs":
            {"registers": 238, "smem": 0, "spill": 12},
        "_Z22flash_attention_kernelIfLi32EEv9FlashArgs":
            {"registers": 48, "smem": 13312, "spill": 0},
    }
