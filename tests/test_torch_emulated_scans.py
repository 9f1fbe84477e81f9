"""The scan kernels (the fused K3, K4's scores and fused top-k, K5's
block maxima, K6's one-query tuples), compiled with g++ against the CPU
emulation of the CUDA subset they use and held against their plain
versions by equality (the ``emu`` fixture and the checks of
``test_torch_emulated.py``), in a module of its own so that they run
beside the other emulated tests.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.core.engine import make_engine
from repro_torch.data.synthetic import (
    synthetic_binary_codes_packed,
    synthetic_queries_packed,
)
from repro_torch.kernels import blockmax_scan as bm
from repro_torch.kernels import device_probe as dp
from repro_torch.kernels import hamming_scan as hs
from repro_torch.kernels import ops

from test_torch_emulated import _offset, _same, emu  # noqa: F401  (a fixture)

vt = importlib.import_module("repro_torch.kernels.verify_tuples")


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
