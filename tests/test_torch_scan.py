"""The port's exact linear scan against the JAX package's, on the CPU.

The scoring kernels' plain versions (K4 ``hamming_scan``, scores and the
fused top-k, K5 ``blockmax_scan``, K6 ``verify_tuples``), the launch
layer's ``scan_scores`` / ``scan_topk`` / ``merge_topk`` /
``scan_topk_pruned`` / ``verify_tuples_op``, and
``make_engine("linear_scan", ..., compute_backend="cuda", device="cpu")``,
each on the same numpy inputs as the reference's counterpart.

Tolerances. The port's float32 scores are ``num * (1 / sqrt(den_sq))``
with every step correctly rounded, and are held bit for bit against that
arithmetic done in numpy. The reference's jitted jnp scores (XLA rewrites
``1 / sqrt`` to an approximate ``rsqrt``) and its Pallas kernel
(``lax.rsqrt``) are not: they differ from it by an ulp or two of scores
below 1. So float32 scores are held to the reference within
``ATOL = 1.2e-7`` (one ulp at 1.0, the ``1e-6`` of the reference's own
kernel tests made tight), a top-K's exact cosines to the reference's, and
its ids to the reference's on every row whose float32 sims are bit-equal
(against the jnp reference; see ``_hold_topk`` for the Pallas one); the
port's top-K is also held exactly against
a stable numpy selection over its own scores (score descending, ties to
the lowest id). Integer tuples and the engine's ids and float64 sims are
held by equality.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pack_bits
from repro.core.engine import make_engine as r_make
from repro.core.linear_scan import linear_scan_knn
from repro.data.synthetic import synthetic_binary_codes, synthetic_queries
from repro.kernels import ops as r_ops
from repro.obs.metrics import REGISTRY as R_REG
from repro_torch.core.engine import make_engine as t_make
from repro_torch.kernels import blockmax_scan as t_bm
from repro_torch.kernels import hamming_scan as t_hs
from repro_torch.kernels import ops as t_ops
from repro_torch.obs.metrics import REGISTRY as T_REG


def _t(a):
    """A numpy array as the port's int32 tensor (uint32 words viewed)."""
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False))


def _random_codes(seed, n, p):
    """Uniform i.i.d. codes (the worst case for hashing), packed."""
    return pack_bits(synthetic_binary_codes(n, p, seed=seed, mode="uniform"))


def _clustered(n, p, B, seed, n_clusters=4, flip_prob=0.02):
    """Duplicate-heavy clustered codes and queries near them."""
    bits = synthetic_binary_codes(n, p, seed=seed, n_clusters=n_clusters,
                                  flip_prob=flip_prob)
    q = synthetic_queries(bits, B, seed=seed + 1)
    return pack_bits(bits), pack_bits(q)


ATOL = 1.2e-7


def _close(a, b):
    """Float32 scores within ATOL of each other."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max(initial=0.0)) <= ATOL


def _eq3_float32(q, db):
    """Correctly rounded float32 Eq. 3 scores in numpy: the port's
    arithmetic, independent of torch."""
    z = np.bitwise_count(q).sum(axis=1).astype(np.float32)[:, None]
    r10 = np.bitwise_count(q[:, None, :] & ~db[None]).sum(-1)
    r01 = np.bitwise_count(~q[:, None, :] & db[None]).sum(-1)
    num = z - r10.astype(np.float32)
    den = z * (z - r10.astype(np.float32) + r01.astype(np.float32))
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.float32(1.0) / np.sqrt(np.where(den > 0, den, 1.0))
    return np.where(den > 0, num * inv, np.float32(0.0)).astype(np.float32)


def _stable_topk(scores, k):
    """Score descending, ties to the lowest id: (sims, ids) per row."""
    ids = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, ids, axis=1), ids


def _exact_cos2(q, codes):
    """Exact squared Eq. 3 cosines of one packed query against packed codes,
    as Fractions (every cosine is >= 0, so they order as the cosines)."""
    z = int(np.bitwise_count(q).sum())
    out = []
    for c in codes:
        r10 = int(np.bitwise_count(q & ~c).sum())
        r01 = int(np.bitwise_count(~q & c).sum())
        den = z * (z - r10 + r01)
        out.append(Fraction((z - r10) ** 2, den) if den > 0 else Fraction(0))
    return out


def _hold_topk(t_sims, t_ids, r_sims, r_ids, q, db, *, same_row_ids=True):
    """Port vs reference top-K: sims within ATOL (-inf slots equal) and,
    on every row, the same multiset of exact cosines. With
    ``same_row_ids``, ids are equal on every row whose float32 sims are
    bit-equal. The reference's Pallas kernel (``lax.rsqrt``) can round two
    codes of equal exact cosine but different tuples apart, so its tie
    groups are not those of exact arithmetic and its ids are held by the
    exact cosines alone. Returns the number of rows whose ids were held."""
    t_sims, t_ids = t_sims.numpy(), t_ids.numpy()
    r_sims, r_ids = np.asarray(r_sims), np.asarray(r_ids)
    assert t_sims.shape == r_sims.shape and t_ids.shape == r_ids.shape
    fin = np.isfinite(r_sims)
    assert np.array_equal(fin, np.isfinite(t_sims))
    assert np.all(t_ids[~fin] == -1) and np.all(r_ids[~fin] == -1)
    assert _close(t_sims[fin], r_sims[fin])
    for b in range(t_ids.shape[0]):
        assert (sorted(_exact_cos2(q[b], db[t_ids[b][fin[b]]]))
                == sorted(_exact_cos2(q[b], db[r_ids[b][fin[b]]])))
    if same_row_ids:
        same = np.array([np.array_equal(a.view(np.int32), b.view(np.int32))
                         for a, b in zip(t_sims, r_sims)])
        assert np.array_equal(t_ids[same], r_ids[same])
        return int(same.sum())
    return 0


# ------------------------------------------------------------------ scores
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("p", [16, 32, 64, 128, 200])
def test_scan_scores_match_jax(p, use_pallas):
    q = _random_codes(p, 5, p)
    db = _random_codes(p + 1, 300, p)
    q[0] = 0                                   # a zero-norm query
    db[7] = 0                                  # an all-zero code
    want = np.asarray(r_ops.scan_scores(jnp.asarray(q), jnp.asarray(db),
                                        use_pallas=use_pallas))
    got = t_ops.scan_scores(_t(q), _t(db)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _close(got, want)
    assert np.all(got[0] == 0.0) and np.all(got[:, 7] == 0.0)
    # and bit for bit the correctly rounded float32 arithmetic
    assert np.array_equal(got.view(np.int32), _eq3_float32(q, db).view(np.int32))


def test_blockmax_plain_is_the_max_of_the_scores():
    p, N, blk = 96, 5000, 256                  # a ragged last block
    q, db = _t(_random_codes(5, 3, p)), _t(_random_codes(6, N, p))
    z = t_ops.query_popcounts(q)
    got = t_bm.blockmax_scores(q, z, db, blk_n=blk)
    full = t_ops.scan_scores(q, db)
    pad = torch.nn.functional.pad(full, (0, -N % blk))
    assert torch.equal(got, pad.reshape(3, -1, blk).amax(-1))


# ------------------------------------------------------------------ verify
@pytest.mark.parametrize("n", [64, 1000])
@pytest.mark.parametrize("p", [32, 64, 128])
def test_verify_tuples_op_matches_jax(p, n):
    q = _random_codes(p + n, 1, p)[0]
    cand = _random_codes(p + n + 1, n, p)
    cand[3] = q                                 # an exact match
    r0, t0 = R_REG.value("launches.verify"), T_REG.value("launches.verify")
    r10, r01 = r_ops.verify_tuples_op(jnp.asarray(q), jnp.asarray(cand),
                                      use_pallas=True)
    t10, t01 = t_ops.verify_tuples_op(_t(q), _t(cand))
    assert np.array_equal(t10.numpy(), np.asarray(r10))
    assert np.array_equal(t01.numpy(), np.asarray(r01))
    assert t10[3] == 0 and t01[3] == 0
    assert (T_REG.value("launches.verify") - t0
            == R_REG.value("launches.verify") - r0 == 1)


# ----------------------------------------------------------- streaming top-K
# (name, p, B, N, k, chunk, n_valid, use_pallas)
_TOPK_CASES = [
    ("chunks", 64, 3, 2500, 10, 256, None, False),
    ("n_valid", 64, 4, 1000, 20, 128, 700, False),
    ("n_valid_below_k", 32, 2, 300, 50, 64, 30, False),
    ("k_ge_n", 32, 2, 37, 50, 16, None, False),
    ("zero_query_and_codes", 64, 3, 500, 10, 128, None, False),
    ("ties_across_chunks", 32, 5, 2000, 40, 100, None, False),
    ("ties_pallas", 64, 4, 1500, 30, 512, None, True),
]


@pytest.mark.parametrize("case", _TOPK_CASES, ids=[c[0] for c in _TOPK_CASES])
def test_scan_topk_matches_jax(case):
    name, p, B, N, k, chunk, n_valid, use_pallas = case
    if name.startswith("ties"):
        db, q = _clustered(N, p, B, seed=p)
    else:
        db, q = _random_codes(N, N, p), _random_codes(N + 1, B, p)
    if name == "zero_query_and_codes":
        q[1] = 0
        db[::7] = 0
    r_sims, r_ids = r_ops.scan_topk(
        jnp.asarray(q), jnp.asarray(db), k, chunk=chunk,
        use_pallas=use_pallas,
        n_valid=None if n_valid is None else jnp.int32(n_valid),
    )
    t_sims, t_ids = t_ops.scan_topk(_t(q), _t(db), k, chunk=chunk,
                                    n_valid=n_valid)
    held = _hold_topk(t_sims, t_ids, r_sims, r_ids, q, db,
                      same_row_ids=not use_pallas)
    # exactly the stable selection over the port's own scores
    full = t_ops.scan_scores(_t(q), _t(db)).numpy()
    if n_valid is not None:
        full[:, n_valid:] = -np.inf
    w_sims, w_ids = _stable_topk(full, min(k, N))
    w_ids = np.where(np.isfinite(w_sims), w_ids, -1)
    assert np.array_equal(t_sims.numpy(), w_sims)
    assert np.array_equal(t_ids.numpy(), w_ids)
    if name.startswith("ties"):
        # the case does what it says: tie groups cross the k-th slot
        kth = w_sims[:, -1:]
        assert np.all((full == kth).sum(axis=1) > (w_sims == kth).sum(axis=1))
        assert use_pallas or held > 0


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("B", [1, 3, 64])
@pytest.mark.parametrize("p", [32, 64, 128, 256])
def test_fused_topk_plain_matches_pallas_reference(p, B, k):
    """``hamming_scan_topk_plain`` (the fused K4 top-k's plain version) and
    ``ops.scan_topk`` against the reference's ``scan_topk`` on its Pallas
    kernel (interpret mode), with chunks smaller than N, a zero-norm query
    (B > 1), ``n_valid`` below N and, at k = 100, below k (-inf/-1 slots).
    Sims within ATOL and the same exact cosines (``_hold_topk``; the Pallas
    ``rsqrt`` splits tie groups, so its ids are held by cosines); the
    port's sims and ids exactly the stable selection over the correctly
    rounded numpy scores."""
    N, chunk = 600, 256
    n_valid = {1: None, 10: 450, 100: 60}[k]
    db, q = _clustered(N, p, B, seed=p * 7 + B + k)
    if B > 1:
        q[-1] = 0
    r_sims, r_ids = r_ops.scan_topk(
        jnp.asarray(q), jnp.asarray(db), k, chunk=chunk, use_pallas=True,
        n_valid=None if n_valid is None else jnp.int32(n_valid))
    tq = _t(q)
    plain = t_hs.hamming_scan_topk_plain(tq, t_ops.query_popcounts(tq), _t(db),
                                         k, n_valid, chunk=chunk)
    t0 = T_REG.value("launches.scan_topk")
    t_sims, t_ids = t_ops.scan_topk(tq, _t(db), k, chunk=chunk,
                                    n_valid=n_valid)
    assert T_REG.value("launches.scan_topk") - t0 == 1
    assert torch.equal(t_sims, plain[0]) and torch.equal(t_ids, plain[1])
    _hold_topk(t_sims, t_ids, r_sims, r_ids, q, db, same_row_ids=False)
    full = _eq3_float32(q, db)
    if n_valid is not None:
        full[:, n_valid:] = -np.inf
    w_sims, w_ids = _stable_topk(full, k)
    w_ids = np.where(np.isfinite(w_sims), w_ids, -1)
    assert np.array_equal(t_sims.numpy().view(np.int32), w_sims.view(np.int32))
    assert np.array_equal(t_ids.numpy(), w_ids)
    if k == 100:
        assert np.all(t_ids.numpy()[:, n_valid:] == -1)


@pytest.mark.parametrize("B,N,k", [(1, 10_000_000, 32), (1, 10_000_000, 128),
                                   (64, 10_000_000, 128), (64, 10_000_000, 32),
                                   (17, 100_003, 1024), (3, 500, 10)])
def test_fused_topk_plan_fills_the_card_within_its_memory(B, N, k):
    """The fused kernel's shape on a 132-SM card: at n = 10M and B = 1 at
    least two blocks per SM; pass 1's (B, tiles, k) int64 keys within 1%
    of the (B, N) float32 scores wherever N allows a tile per 200 k rows;
    row tiles of whole steps that cover N; L a power of two holding the
    best k and a step of staging; QT queries whose keys fit 64 KiB."""
    plan = t_hs.topk_plan(B, N, k, 132)
    L, QT, rows, tiles = (plan["L"], plan["QT"], plan["tile_rows"],
                          plan["n_tiles"])
    assert L & (L - 1) == 0 and L - k >= t_hs.TOPK_THREADS
    assert 1 <= QT <= B and QT * L * 8 <= 64 * 1024
    assert plan["n_qtiles"] * QT >= B > (plan["n_qtiles"] - 1) * QT
    assert rows % t_hs.TOPK_THREADS == 0
    assert tiles * rows >= N > (tiles - 1) * rows
    if N >= 200 * k:
        assert B * tiles * k * 8 <= 0.01 * B * N * 4
    if B == 1 and N == 10_000_000:
        assert tiles * plan["n_qtiles"] >= 2 * 132


@pytest.mark.parametrize("k", [1, 7, 64])
def test_merge_topk_matches_jax(k):
    rng = np.random.default_rng(k)
    sims = (rng.integers(0, 6, size=(4, 48)) / 5).astype(np.float32)
    sims[rng.random(sims.shape) < 0.2] = -np.inf   # invalid slots
    ids = rng.permutation(4 * 48).reshape(4, 48).astype(np.int32)
    r_s, r_i = r_ops.merge_topk(jnp.asarray(sims), jnp.asarray(ids), k)
    t_s, t_i = t_ops.merge_topk(torch.from_numpy(sims), torch.from_numpy(ids),
                                k)
    assert np.array_equal(t_s.numpy(), np.asarray(r_s))
    assert np.array_equal(t_i.numpy(), np.asarray(r_i))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("mode", ["clustered", "uniform"])
def test_scan_topk_pruned_matches_jax(mode, use_pallas):
    p, B, N, k, blk = 64, 4, 8192 + 100, 5, 128   # a ragged last block
    bits = synthetic_binary_codes(N, p, seed=3, mode=mode)
    q = pack_bits(synthetic_queries(bits, B, seed=4))
    db = pack_bits(bits)
    r_sims, r_ids, r_frac = r_ops.scan_topk_pruned(
        jnp.asarray(q), jnp.asarray(db), k, blk=blk, use_pallas=use_pallas)
    t_sims, t_ids, t_frac = t_ops.scan_topk_pruned(_t(q), _t(db), k, blk=blk)
    assert t_frac.dtype == torch.float32
    assert float(t_frac) == float(r_frac)
    _hold_topk(t_sims, t_ids, r_sims, r_ids, q, db)
    f_sims, f_ids = t_ops.scan_topk(_t(q), _t(db), k)
    assert torch.equal(t_sims, f_sims) and torch.equal(t_ids, f_ids)
    if mode == "clustered":                     # pruning bites
        assert float(t_frac) < 0.5


# ------------------------------------------------------------------ engine
@pytest.mark.parametrize("p,B,k", [(32, 1, 10), (32, 8, 25), (64, 64, 10),
                                   (64, 8, 100)])
def test_linear_scan_cuda_backend_equals_reference(p, B, k):
    db, q = _clustered(3000, p, B, seed=p + B)
    q[-1] = 0                                   # a zero-norm query
    ri, rs, _ = r_make("linear_scan", db, p,
                       compute_backend="pallas").knn_batch(q, k)
    eng = t_make("linear_scan", db, p, compute_backend="cuda", device="cpu")
    n0 = T_REG.value("launches.scan_scores")
    t0 = T_REG.value("launches.scan_topk")
    ti, ts, st = eng.knn_batch(q, k)
    # one fused top-k call, no (B, N) score launch
    assert T_REG.value("launches.scan_topk") - t0 == 1
    assert T_REG.value("launches.scan_scores") - n0 == 0
    assert np.array_equal(ti, ri) and np.array_equal(ts, rs)
    assert ti.dtype == np.int64 and ts.dtype == np.float64
    assert st.total("retrieved") == B * 3000
    for i in range(B):
        assert len(set(ti[i].tolist())) == k    # unique ids per row
        li, ls = linear_scan_knn(q[i], db, k)
        assert np.array_equal(ts[i], ls)
        # linear_scan_knn picks among the ties at the k-th sim by
        # argpartition; every other id is the same
        off = ls != ls[-1]
        assert np.array_equal(ti[i][off], li[off])


def test_linear_scan_defaults_to_the_card(monkeypatch):
    db, q = _clustered(200, 32, 2, seed=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_make("linear_scan", db, 32)
    with pytest.raises(ValueError, match="pallas"):
        t_make("linear_scan", db, 32, compute_backend="pallas")
    # the float64 host scan, asked for by name, needs no device
    host = t_make("linear_scan", db, 32, compute_backend="numpy")
    cpu = t_make("linear_scan", db, 32, device="cpu")
    hi, hs, _ = host.knn_batch(q, 5)
    ci, cs, _ = cpu.knn_batch(q, 5)
    assert np.array_equal(hs, cs)
