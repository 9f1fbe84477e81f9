"""The port's CUDA kernels against their plain PyTorch versions, on a
CUDA device (marked ``gpu``; every test skips without one). This file
imports neither JAX nor the reference package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_tiny
from repro_torch.core.engine import make_engine
from repro_torch.data.synthetic import (
    synthetic_binary_codes_packed,
    synthetic_queries_packed,
)
from repro_torch.kernels import blockmax_scan as bm
from repro_torch.kernels import device_probe as dp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hamming_scan as hs
from repro_torch.kernels import ops
from repro_torch.kernels import verify_tuples as vt
from repro_torch.models.api import Model
from repro_torch.serve.retrieval import RetrievalConfig, RetrievalService

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")
    return torch.device("cuda")


def _words(rng, shape):
    return torch.from_numpy(
        rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
        .astype(np.uint32).view(np.int32))


def _offset(t):
    """A copy of ``t`` in a view that starts 4 bytes past a 16-byte
    boundary (the kernels' vector loads must not take it)."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = buf[1 : 1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


# (p, B, C, offset idx, offset codes): W = 1 to 8 and 10 (the runtime-W
# form), C from 1 to 5000 (blocks wholly past a length), index and code
# views off their 16-byte boundary (codes so placed take the scalar-load
# form)
VERIFY_CASES = [
    pytest.param((32, 16, 300, False, False), id="32"),
    pytest.param((64, 16, 300, False, False), id="64"),
    pytest.param((128, 16, 300, False, False), id="128"),
    pytest.param((32, 3, 1, False, False), id="w1-c1"),
    pytest.param((64, 5, 7, False, True), id="w2-c7-offset-codes"),
    pytest.param((96, 5, 7, True, False), id="w3-c7-offset-idx"),
    pytest.param((128, 9, 1024, False, True), id="w4-c1024-offset-codes"),
    pytest.param((160, 9, 1024, False, False), id="w5-c1024"),
    pytest.param((192, 9, 300, True, True), id="w6-c300-offset-both"),
    pytest.param((224, 5, 5000, False, False), id="w7-c5000"),
    pytest.param((256, 9, 1024, True, False), id="w8-c1024-offset-idx"),
    pytest.param((256, 9, 300, False, True), id="w8-c300-offset-codes"),
    pytest.param((320, 5, 300, False, False), id="w10-c300"),
]


@pytest.mark.parametrize("case", VERIFY_CASES)
def test_grouped_verify_kernel_equals_plain(cuda, case):
    p, B, C, off_idx, off_db = case
    rng = np.random.default_rng(p + C)
    W, N = (p + 31) // 32, 5000
    db, q = _words(rng, (N, W)).to(cuda), _words(rng, (B, W)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, N, size=(B, C)).astype(np.int32))
    idx[1, -1] = N - 1
    lens = torch.from_numpy(rng.integers(0, C + 1, size=B).astype(np.int32))
    lens[:3] = torch.tensor([0, C, C // 2 + 1], dtype=torch.int32)
    idx, lens = idx.to(cuda), lens.to(cuda)
    if off_idx:
        idx = _offset(idx)
    if off_db:
        db = _offset(db)
    before = vt.LAUNCHES["verify_grouped"]
    got = vt.gather_verify_grouped(q, db, idx, lens, p=p)
    assert vt.LAUNCHES["verify_grouped"] == before + 1
    assert torch.equal(got, vt.gather_verify_grouped_plain(q, db, idx, lens,
                                                           p))


@pytest.mark.parametrize("p,m,B", [(64, 4, 64), (64, 4, 1), (128, 8, 16)])
def test_device_path_on_card_equals_plain_on_cpu(cuda, p, m, B):
    n, k = 40_000, 10
    db = synthetic_binary_codes_packed(n, p, seed=p)
    q = synthetic_queries_packed(db, p, B, seed=p + 1)
    gpu = make_engine("amih", db, p, m=m, probe_backend="device",
                      query_cache_size=0)
    cpu = make_engine("amih", db, p, m=m, probe_backend="device",
                      query_cache_size=0, device="cpu")
    walks = dp.LAUNCHES["probe_walk"] + dp.LAUNCHES["probe_walk_cluster"]
    gi, gs, gst = gpu.knn_batch(q, k)
    assert (dp.LAUNCHES["probe_walk"] + dp.LAUNCHES["probe_walk_cluster"]
            == walks + 1)
    ci, cs, cst = cpu.knn_batch(q, k)
    assert np.array_equal(gi, ci) and np.array_equal(gs, cs)
    assert gst.per_query == cst.per_query


def _same_walk(got, want, cap):
    for g, w in zip(dp.walk_canonical(got, cap), dp.walk_canonical(want, cap)):
        assert torch.equal(torch.as_tensor(g).cpu().reshape(-1).long(),
                           torch.as_tensor(w).cpu().reshape(-1).long())


def _same_scan(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("check_every", [1, 3])
def test_walk_and_scan_kernels_equal_plain(cuda, check_every):
    """The batched walk (the cooperative grid; the cluster form refuses a
    launch of several z-groups), the extraction kernel after it, the map
    scan and the fused scan on a batch's operands, against their plain
    versions on the card."""
    p, m, n, B, k = 64, 4, 30_000, 24, 7
    db = synthetic_binary_codes_packed(n, p, seed=5)
    q = synthetic_queries_packed(db, p, B, seed=6)
    eng = make_engine("amih", db, p, m=m, probe_backend="device",
                      query_cache_size=0, probe_stream_cap=512)
    seen = {}
    names = ("device_probe_walk_batched", "device_probe_scan_topk")
    orig = {name: getattr(dp, name) for name in names}

    def keeper(name):
        def keep(*a, **kw):
            seen.setdefault(name, (a, kw))
            return orig[name](*a, **kw)
        return keep

    for name in names:
        setattr(dp, name, keeper(name))
    try:
        eng.knn_batch(q, k)
    finally:
        for name, fn in orig.items():
            setattr(dp, name, fn)
    assert set(seen) == set(names)
    a, kw = seen["device_probe_walk_batched"]
    kw = dict(kw, check_every=check_every)
    want = dp.device_probe_walk_batched_plain(
        torch.full_like(a[0], dp.POS_INF), *a[1:], **kw)
    pm = torch.full_like(a[0], dp.POS_INF)
    got = dp.device_probe_walk_batched(pm, *a[1:], **kw, form="grid")
    assert dp.LAST_WALK_GRID[2] == "grid"
    _same_walk(got, want, kw["cap"])
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        dp.device_probe_walk_batched(torch.full_like(a[0], dp.POS_INF),
                                     *a[1:], **kw, form="cluster")
    # the extraction kernel after the kernel walk, against the plain
    # extraction after the plain walk
    done = torch.nonzero(want[3]).flatten()
    width = int(got[5]) * kw["cap"]
    for k in (1, 7, 300):
        pm_k, pm_p = pm.clone(), want[0].clone()
        before = dp.LAUNCHES["probe_extract"]
        ids, pos = dp.extract_touched(pm_k, got[6], got[8], a[7], k, done,
                                      width)
        assert dp.LAUNCHES["probe_extract"] == before + 1
        w_ids, w_pos = dp.extract_touched_plain(pm_p, want[6], want[8], a[7],
                                                k, done, width)
        assert torch.equal(ids, w_ids) and torch.equal(pos, w_pos)
        assert bool((pm_k == dp.POS_INF).all())
    s, skw = seen["device_probe_scan_topk"]
    plain_kw = {key: v for key, v in skw.items() if key != "plan"}
    q_words, gid, t_stop, db_pad, inv_pos, n_valid, kk = s
    scan = dp.device_probe_scan_multi(q_words, gid, db_pad, inv_pos, n, p=p,
                                      chunk=2048)
    assert torch.equal(scan, dp.device_probe_scan_multi_plain(
        q_words, gid, db_pad, inv_pos, n, p=p, chunk=2048))
    before = dp.LAUNCHES["probe_scan_topk"]
    got = dp.device_probe_scan_topk(*s, **skw)
    assert dp.LAUNCHES["probe_scan_topk"] == before + 1
    _same_scan(got, dp.device_probe_scan_topk_plain(*s, **plain_kw))


def test_per_group_walk_and_scan_kernels_equal_plain(cuda):
    """The G = 1 wrappers: ``probe_fused=False`` walks one z-group per
    launch (in both forms), and a truncated stream sends its queries to
    the per-group scan (map and fused)."""
    p, m, n, B, k = 64, 4, 30_000, 24, 7
    db = synthetic_binary_codes_packed(n, p, seed=5)
    q = synthetic_queries_packed(db, p, B, seed=6)
    eng = make_engine("amih", db, p, m=m, query_cache_size=0,
                      probe_stream_cap=256, probe_fused=False)
    names = ("device_probe_walk", "device_probe_scan_topk")
    orig = {name: getattr(dp, name) for name in names}
    seen = {}

    def keeper(name):
        def keep(*a, **kw):
            seen.setdefault(name, (a, kw))
            return orig[name](*a, **kw)
        return keep

    for name in names:
        setattr(dp, name, keeper(name))
    try:
        eng.knn_batch(q, k)
    finally:
        for name, fn in orig.items():
            setattr(dp, name, fn)
    assert set(seen) == set(names)
    a, kw = seen["device_probe_walk"]
    kw = {key: v for key, v in kw.items() if key != "posmap_in"}
    for check_every in (1, 3):
        kw2 = dict(kw, check_every=check_every)
        want = dp.device_probe_walk_plain(*a, **kw2)
        for form in ("grid", "cluster"):
            _same_walk(dp.device_probe_walk(*a, **kw2, form=form), want,
                       kw["cap"])
    s, skw = seen["device_probe_scan_topk"]
    plain_kw = {key: v for key, v in skw.items() if key != "plan"}
    q_words, gid, t_stop, db_pad, inv_pos, n_valid, kk = s
    assert inv_pos.shape[0] == 1
    assert torch.equal(
        dp.device_probe_scan(q_words, db_pad, inv_pos[0], n_valid,
                             **plain_kw),
        dp.device_probe_scan_plain(q_words, db_pad, inv_pos[0], n_valid,
                                   **plain_kw))
    _same_scan(dp.device_probe_scan_topk(*s, **skw),
               dp.device_probe_scan_topk_plain(*s, **plain_kw))


def test_pooled_map_holds_pos_inf_after_card_batches(cuda):
    """On the card, the pooled maps of the walk (batched and per group)
    hold POS_INF everywhere after batches with and without bails."""
    p, n = 64, 30_000
    db = synthetic_binary_codes_packed(n, p, seed=5)
    q = synthetic_queries_packed(db, p, 24, seed=6)
    for cap in (1 << 16, 256):
        eng = make_engine("amih", db, p, m=4, query_cache_size=0,
                          probe_stream_cap=cap)
        eng.knn_batch(q, 7)
        eng.knn_batch(q[:1], 7)
    bufs = [b for bs in ops._POSMAP_POOL.values() for b in bs]
    assert bufs and all(bool((b == dp.POS_INF).all()) for b in bufs)


def test_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros((2, 2), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        vt.gather_verify_grouped(x, x, x, x[0], p=64)
    assert ops.resolve_device(None).type == "cuda"


def _scan_operands(p, B, N, seed, device):
    db = synthetic_binary_codes_packed(N, p, seed=seed)
    q = synthetic_queries_packed(db, p, B, seed=seed + 1)
    db[5] = 0                                   # an all-zero code
    if B > 1:
        q[1] = 0                                # a zero-norm query
    q = torch.from_numpy(q.view(np.int32)).to(device)
    db = torch.from_numpy(db.view(np.int32)).to(device)
    return q, ops.query_popcounts(q), db


def _bits(t):
    return t.cpu().view(torch.int32)


@pytest.mark.parametrize("p,B", [(64, 64), (128, 64), (128, 1), (200, 9)])
def test_hamming_scan_kernel_equals_plain(cuda, p, B):
    q, z, db = _scan_operands(p, B, 70_001, seed=p + B, device=cuda)
    before = hs.LAUNCHES["hamming_scan"]
    got = hs.hamming_scan_scores(q, z, db)
    assert hs.LAUNCHES["hamming_scan"] == before + 1
    assert torch.equal(_bits(got), _bits(hs.hamming_scan_scores_plain(q, z,
                                                                      db)))
    assert torch.equal(_bits(got), _bits(hs.hamming_scan_scores_plain(
        q.cpu(), z.cpu(), db.cpu())))


# (p, B, blk, offset codes) over 70,001 codes: W = 1, 2, 3, 4, 7 and 8;
# B = 1 (the one-query form), 9, 11, 17, 33 and 64; blk 1, 37, 128, 1000,
# 2048 and N + 5; codes in a view off its 16-byte boundary
BLOCKMAX_CASES = [
    pytest.param((64, 64, 2048, False), id="64-64-2048"),
    pytest.param((128, 1, 2048, False), id="128-1-2048"),
    pytest.param((128, 9, 1000, False), id="128-9-1000"),
    pytest.param((32, 1, 1, False), id="w1-b1-blk1"),
    pytest.param((64, 17, 37, False), id="w2-b17-blk37"),
    pytest.param((96, 33, 128, False), id="w3-b33-blk128"),
    pytest.param((200, 11, 37, False), id="w7-b11-blk37"),
    pytest.param((256, 17, 2048, False), id="w8-b17-blk2048"),
    pytest.param((256, 1, 128, False), id="w8-b1-blk128"),
    pytest.param((64, 33, 1, False), id="w2-b33-blk1"),
    pytest.param((128, 17, "N+5", True), id="w4-b17-blkN5-offset"),
    pytest.param((256, 11, 2048, True), id="w8-b11-blk2048-offset"),
    pytest.param((96, 1, 37, True), id="w3-b1-blk37-offset"),
]


@pytest.mark.parametrize("case", BLOCKMAX_CASES)
def test_blockmax_kernel_equals_plain(cuda, case):
    p, B, blk, off = case
    N = 70_001
    blk = N + 5 if blk == "N+5" else blk
    q, z, db = _scan_operands(p, B, N, seed=p + B, device=cuda)
    if off:
        db = _offset(db)
    before = bm.LAUNCHES["blockmax_scan"]
    got = bm.blockmax_scores(q, z, db, blk_n=blk)
    assert bm.LAUNCHES["blockmax_scan"] == before + 1
    assert torch.equal(_bits(got),
                       _bits(bm.blockmax_scores_plain(q, z, db, blk)))


@pytest.mark.parametrize("p", [64, 128])
def test_verify_tuples_kernel_equals_plain(cuda, p):
    q, _, db = _scan_operands(p, 2, 300_001, seed=p, device=cuda)
    before = vt.LAUNCHES["verify_tuples"]
    got = vt.verify_tuples(q[0].contiguous(), db)
    assert vt.LAUNCHES["verify_tuples"] == before + 1
    for g, w in zip(got, vt.verify_tuples_plain(q[0], db)):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("p,B,k", [(64, 64, 10), (128, 1, 100)])
def test_linear_scan_on_card_equals_plain_on_cpu(cuda, p, B, k):
    n = 200_000
    db = synthetic_binary_codes_packed(n, p, seed=p)
    q = synthetic_queries_packed(db, p, B, seed=p + 1)
    gpu = make_engine("linear_scan", db, p)
    cpu = make_engine("linear_scan", db, p, device="cpu")
    before = dict(hs.LAUNCHES)
    gi, gs, _ = gpu.knn_batch(q, k)
    # one fused top-k call, no (B, N) score launch
    assert hs.LAUNCHES["hamming_scan_topk"] == before["hamming_scan_topk"] + 1
    assert hs.LAUNCHES["hamming_scan"] == before["hamming_scan"]
    ci, cs, _ = cpu.knn_batch(q, k)
    assert np.array_equal(gi, ci) and np.array_equal(gs, cs)
    qt = torch.from_numpy(q.view(np.int32)).to(cuda)
    dt = torch.from_numpy(db.view(np.int32)).to(cuda)
    full = ops.scan_topk(qt, dt, k)
    pruned = ops.scan_topk_pruned(qt, dt, k)
    assert torch.equal(full[0], pruned[0]) and torch.equal(full[1], pruned[1])


# (p, B, N, k, duplicates, n_valid, row_ids): B = 1 and 64 at the main
# path's fetch sizes, a ragged query tile at the largest k the kernel
# takes, a database of five distinct codes (ties across every tile and
# staging overflows), n_valid as a device scalar below k, and row ids
TOPK_CASES = [
    (128, 1, 300_001, 32, False, None, False),
    (128, 64, 300_001, 128, False, None, False),
    (64, 17, 100_003, 1024, False, None, False),
    (256, 3, 70_001, 100, True, None, False),
    (64, 9, 70_001, 10, True, "tensor", False),
    (128, 5, 70_001, 50, False, 40_000, True),
]


@pytest.mark.parametrize("case", TOPK_CASES)
def test_fused_scan_topk_kernel_equals_plain(cuda, case):
    """The fused K4 top-k against its plain version (the chunk loop over
    the plain scores) on the same card: sims and ids bit for bit."""
    p, B, N, k, dup, n_valid, row_ids = case
    q, z, db = _scan_operands(p, B, N, seed=p + B + k, device=cuda)
    if dup:
        db = db[torch.arange(N, device=cuda) % 5].contiguous()
    if n_valid == "tensor":
        n_valid = torch.tensor(k // 2, dtype=torch.int32, device=cuda)
    rid = (torch.arange(N, dtype=torch.int32, device=cuda) * 3
           if row_ids else None)
    before = hs.LAUNCHES["hamming_scan_topk"]
    sims, ids = hs.hamming_scan_topk(q, z, db, k, n_valid, rid)
    assert hs.LAUNCHES["hamming_scan_topk"] == before + 1
    ws, wi = hs.hamming_scan_topk_plain(q, z, db, k, n_valid, rid)
    assert torch.equal(_bits(sims), _bits(ws))
    assert torch.equal(ids.cpu(), wi.cpu())


def test_scan_topk_above_the_fused_cap_takes_the_chunked_route(cuda):
    """k > KCAP_MAX is chosen by shape: one K4 score launch per chunk,
    counted under ``scan_scores``, and no fused call; the result equals the
    plain version's."""
    from repro_torch.obs.metrics import REGISTRY

    q, z, db = _scan_operands(64, 3, 70_001, seed=9, device=cuda)
    k = hs.KCAP_MAX + 1
    n0 = REGISTRY.value("launches.scan_scores")
    t0 = REGISTRY.value("launches.scan_topk")
    fused = hs.LAUNCHES["hamming_scan_topk"]
    sims, ids = ops.scan_topk(q, db, k, chunk=1 << 15)
    assert REGISTRY.value("launches.scan_scores") - n0 == 3
    assert REGISTRY.value("launches.scan_topk") == t0
    assert hs.LAUNCHES["hamming_scan_topk"] == fused
    ws, wi = hs.hamming_scan_topk_plain(q, z, db, k)
    assert torch.equal(_bits(sims), _bits(ws))
    assert torch.equal(ids.cpu(), wi.cpu())


def test_scan_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros((2, 2), dtype=torch.int64, device=cuda)
    z = torch.zeros(2, dtype=torch.int32, device=cuda)
    for call in (lambda: hs.hamming_scan_scores(x, z, x),
                 lambda: bm.blockmax_scores(x, z, x),
                 lambda: vt.verify_tuples(x[0], x)):
        with pytest.raises(TypeError, match="int32"):
            call()
    wide = torch.zeros((2, 9), dtype=torch.int32, device=cuda)   # p > 256
    with pytest.raises(ValueError, match="W=9"):
        hs.hamming_scan_scores(wide, z, wide)
    with pytest.raises(ValueError, match="W=9"):
        hs.hamming_scan_topk(wide, z, wide, 4)
    codes = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="1 <= k <= 1024"):
        hs.hamming_scan_topk(codes, z, codes, hs.KCAP_MAX + 1)


# (B, Sq, Sk, Hq, Hkv, D, causal, window, valid_len): MHA, GQA and MQA,
# causal or not, windows, decode over part of a cache, a ragged Sq, and
# the encoder's own shape at a smaller batch; D = 32 is the tiny gemma's;
# then ragged G = 8 tiles over three kv tiles, a windowed D = 32, decode with
# no valid key, and G = 3 (64-row tiles that straddle a head group)
FLASH_CASES = [
    (2, 128, 128, 4, 4, 64, True, 0, None),
    (2, 24, 24, 4, 1, 32, True, 0, None),
    (2, 100, 100, 8, 2, 128, False, 0, None),
    (2, 128, 128, 8, 1, 256, True, 0, None),
    (1, 160, 160, 4, 4, 64, True, 16, None),
    (1, 160, 160, 4, 1, 128, True, 64, None),
    (2, 1, 160, 8, 2, 128, False, 0, 37),
    (2, 1, 160, 8, 1, 256, False, 24, 100),
    (1, 1, 160, 8, 1, 64, False, 0, 1),
    (4, 128, 128, 8, 1, 256, True, 0, None),
    (2, 130, 130, 8, 1, 256, True, 0, None),
    (1, 70, 70, 2, 1, 32, False, 8, None),
    (1, 4, 160, 8, 1, 256, False, 0, 0),
    (1, 37, 50, 6, 2, 64, True, 0, None),
    # head dims between the instantiation widths: the reference configs'
    # tiny 16, 48, kimi-k2's 112, and 20 (bf16: a TMA-padded copy)
    (2, 40, 40, 4, 1, 16, True, 0, None),
    (1, 70, 90, 4, 2, 48, False, 16, None),
    (2, 1, 160, 8, 1, 112, False, 0, 37),
    (1, 130, 130, 8, 1, 112, True, 0, None),
    (1, 33, 33, 2, 1, 20, True, 8, None),
    # head dims above 256 (256-column chunks, 256-wide output slices) and
    # 96 q heads per kv head (two bf16 head tiles)
    (2, 70, 90, 4, 1, 320, True, 0, None),
    (1, 130, 130, 2, 2, 512, False, 24, None),
    (2, 1, 160, 4, 1, 512, False, 0, 37),
    (2, 40, 60, 96, 1, 64, True, 0, None),
    (1, 3, 160, 96, 1, 256, False, 16, 100),
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    """K7 against its plain version in float32 on the same inputs: within
    2e-5 for float32 inputs, and within 4e-3 for bf16 ones (half a bf16
    step below 1 plus float32 slack; v in [-1, 1) keeps outputs below 1)."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, valid_len = case
    g = torch.Generator(device=cuda).manual_seed(Sq + D)
    q = torch.randn((B, Sq, Hq, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Sk, Hkv, D), generator=g, device=cuda).to(dtype)
    v = (torch.rand((B, Sk, Hkv, D), generator=g, device=cuda) * 2 - 1
         ).to(dtype)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             valid_len=valid_len)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=causal, window=window,
                                    valid_len=valid_len)
    tol = 2e-5 if dtype == torch.float32 else 4e-3
    assert got.dtype == dtype
    assert float((got.float() - want).abs().max()) <= tol


def test_flash_attention_bf16_kernel_matches_plain_on_random_shapes(cuda):
    """K7's bf16 path on 100 seeded random shapes (G up to 16 with tiles
    that straddle positions and head groups, empty and ragged kv, windows,
    valid_len 0 to Sk): finite, within 4e-3 * max(1, |plain|) of the plain
    version in float32."""
    rng = np.random.default_rng(15)
    g = torch.Generator(device=cuda).manual_seed(15)
    for _ in range(100):
        B, Hkv = int(rng.integers(1, 4)), int(rng.choice([1, 2, 4]))
        G, D = int(rng.choice([1, 2, 3, 5, 8, 16])), int(rng.choice(
            fa.SUPPORTED_HEAD_DIMS))
        Sq = int(rng.choice([1, 4, rng.integers(1, 200)]))
        Sk = int(rng.choice([0, 1, rng.integers(1, 200), Sq]))
        kw = {"causal": bool(rng.integers(2)),
              "window": int(rng.choice([0, 0, 1, 8, 24, 100])),
              "valid_len": [None, 0, int(rng.integers(0, Sk + 1))][
                  int(rng.integers(3))]}
        q = torch.randn((B, Sq, Hkv * G, D), generator=g, device=cuda)
        k = torch.randn((B, Sk, Hkv, D), generator=g, device=cuda)
        v = torch.rand((B, Sk, Hkv, D), generator=g, device=cuda) * 2 - 1
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        got = fa.flash_attention(q, k, v, **kw).float()
        want = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        assert bool(torch.isfinite(got).all()), (q.shape, k.shape, kw)
        assert bool(((got - want).abs()
                     <= 4e-3 * want.abs().clamp(min=1.0)).all()), \
            (q.shape, k.shape, kw)


def test_flash_attention_bf16_library_runs_on_the_tensor_cores(cuda):
    """K7's library holds HGMMA (wgmma) instructions, and ptxas reports no
    spill for any bf16 instantiation."""
    from repro_torch.kernels import _build

    _build.load("flash_attention")
    code = _build.sass("flash_attention")
    if code is None:
        pytest.skip("needs cuobjdump to read the kernel's SASS")
    assert "HGMMA" in code
    bf16 = {fn: r for fn, r in _build.ptxas_report("flash_attention").items()
            if "flash_attention_bf16_kernel" in fn}
    assert len(bf16) == len(fa.SUPPORTED_HEAD_DIMS)
    assert all(r["spill"] == 0 for r in bf16.values()), bf16


def test_flash_attention_raises_instead_of_falling_back(cuda):
    q = torch.zeros((1, 4, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="flash_attention takes"):
        fa.flash_attention(q, q[:, :, :1], q[:, :, :1])
    flat = torch.zeros(4 * 2 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    q = flat[1:].view(1, 4, 2, 64)                   # 2 bytes off 16
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.flash_attention(q, q[:, :, :1].contiguous(),
                           q[:, :, :1].contiguous())


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_tiny_encoder_on_card_runs_k7_and_equals_plain_on_cpu(cuda):
    """The tiny gemma (head_dim 32) in float32 embeds through K7 on the
    card, one launch per layer and encode batch, within 1e-4 of the same
    weights embedded on the CPU through K7's plain version (the GEMMs and
    the kernel sum in other orders)."""
    cfg = get_tiny("gemma_2b").replace(compute_dtype="float32")
    params = Model(cfg).init_params(0, device=cuda)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (10, 24)).astype(np.int32)
    card = RetrievalService(cfg, params,
                            RetrievalConfig(batch_size=4, device=cuda))
    host = RetrievalService(cfg, _to(params, "cpu"),
                            RetrievalConfig(batch_size=4, device="cpu"))
    before = fa.LAUNCHES["flash_attention"]
    got = card.embed(toks)
    assert fa.LAUNCHES["flash_attention"] == before + cfg.n_layers * 3
    want = host.embed(toks)
    assert got.shape == (10, cfg.d_model) and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-4
