"""The port's plain kernel versions against the JAX package's: the SWAR
popcount, the grouped verify against the Pallas kernel in interpret mode,
and the plain probing walks and scans against the reference's
``device_probe_walk_batched`` / ``device_probe_walk`` /
``device_probe_scan_multi`` / ``device_probe_scan`` (``use_pallas=False``),
output by output, with equality. The CUDA kernels themselves are held
against these plain versions in ``tests/test_torch_gpu.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import pack_bits
from repro.core import probe_device as r_pd
from repro.core.amih import AMIHIndex as RIndex
from repro.kernels import device_probe as r_dp
from repro.kernels.verify_tuples import verify_tuples_grouped as r_grouped
from repro_torch.kernels import device_probe as t_dp
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import verify_tuples as t_vt

KMAX = r_pd.KMAX
WALK_OUT = ("posmap", "probes", "retrieved", "done", "cursor", "iters")


def _t(a):
    """A numpy array as the port's int32 tensor (uint32 words viewed)."""
    a = np.array(a)                  # a writable copy (jax arrays are not)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False))


def _eq(port, ref, what):
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    if ref.dtype == bool:
        port = port.astype(bool)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert np.array_equal(port.astype(np.int64), ref.astype(np.int64)), what


# ------------------------------------------------------------------ verify
def test_popcount32_matches_numpy():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 1 << 32, size=5000, dtype=np.uint64).astype(np.uint32)
    v[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    got = t_ref.popcount32(_t(v)).numpy()
    assert np.array_equal(got, np.bitwise_count(v).astype(np.int32))


@pytest.mark.parametrize("p,B,C", [(32, 3, 128), (64, 5, 256), (128, 4, 128)])
def test_grouped_verify_ref_matches_pallas_interpret(p, B, C):
    rng = np.random.default_rng(p + B)
    W = (p + 31) // 32
    q = rng.integers(0, 1 << 32, size=(B, W), dtype=np.uint64).astype(np.uint32)
    cand = rng.integers(0, 1 << 32, size=(B, C, W),
                        dtype=np.uint64).astype(np.uint32)
    lens = rng.integers(0, C + 1, size=B).astype(np.int32)
    lens[0] = 0
    want = r_grouped(jnp.asarray(q), jnp.asarray(cand), jnp.asarray(lens),
                     p=p, blk_c=128)
    got = t_ref.verify_tuples_grouped_ref(_t(q), _t(cand), _t(lens), p)
    _eq(got, want, "keys")
    # the wrapper on a CPU tensor is the plain gather + verify
    db = cand.reshape(B * C, W)
    idx = np.arange(B * C, dtype=np.int32).reshape(B, C)
    got = t_vt.gather_verify_grouped(_t(q), _t(db), _t(idx), _t(lens), p=p)
    _eq(got, want, "gathered keys")


# ------------------------------------------------------------- walk inputs
def _walk_case(p, n, B, seed, m=None, stream_cap=1 << 16):
    """A reference index and the numpy operands of one batched walk."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2, size=(n, p)).astype(np.uint8)
    q_bits = base[rng.integers(0, n, size=B)].copy()
    for i in range(B):
        q_bits[i, rng.choice(p, size=2 + i % 5, replace=False)] ^= 1
    db = pack_bits(base)
    q = pack_bits(q_bits)
    index = RIndex.build(db, p, m=m, probe_backend="device",
                         probe_stream_cap=stream_cap)
    csr = index.device_csr
    return index, csr, q


def _batched_args(index, csr, q, k):
    stack = r_pd.get_schedule_stack(index.p, index.m, csr["widths"],
                                    index.probe_stream_cap)
    zs = np.bitwise_count(q).sum(axis=1)
    B = q.shape[0]
    Bp = 1 << max(B - 1, 0).bit_length()
    gid = np.zeros(Bp, dtype=np.int32)
    t_stop = np.full(Bp, -1, dtype=np.int32)
    for b in range(B):
        gid[b] = stack.row(int(zs[b]))
        t_stop[b] = stack.scheds[gid[b]].L - 1
    q_sub, z_sub = r_pd._query_substrings(index, q)
    pow1, pow0 = r_pd._pow_arrays(q_sub, z_sub, csr["widths"], csr["wmax"])

    def pad(a):
        out = np.zeros((Bp,) + a.shape[1:], dtype=a.dtype)
        out[:B] = a
        return out

    bundle = stack.device_arrays(None)
    host = [pad(q), pad(q_sub.astype(np.int32)), pad(z_sub), pad(pow1),
            pad(pow0), gid, t_stop]
    tables = [np.asarray(bundle[nm]) for nm in
              ("g_start", "g_end", "tbl", "step", "idx1", "idx0", "maxi1",
               "maxi0", "widths")]
    tables += [np.asarray(csr[nm]) for nm in ("offsets", "ids", "db_pad")]
    tables.append(np.asarray(bundle["inv_pos"]))
    return host, tables, Bp


_STATIC = dict(p=None, tile=1024, cap=2048, kmax=KMAX)


@pytest.mark.parametrize("check_every,budget", [(1, None), (3, None), (1, 2)])
def test_plain_batched_walk_matches_reference(check_every, budget):
    p, n, B, k = 64, 1500, 12, 9
    index, csr, q = _walk_case(p, n, B, seed=5, m=4)
    host, tables, Bp = _batched_args(index, csr, q, k)
    n_pad = csr["n_pad"]
    budget = budget or max(4, n_pad // (4 * 2048 * Bp))
    kw = dict(_STATIC, p=p, check_every=check_every)
    want = jax.jit(
        r_dp.device_probe_walk_batched,
        static_argnames=("p", "tile", "cap", "kmax", "check_every",
                         "use_pallas", "interpret"),
    )(
        jnp.zeros((Bp, n_pad), jnp.int32),
        *[jnp.asarray(a) for a in host],
        jnp.int32(k), jnp.int32(budget),
        *[jnp.asarray(a) for a in tables],
        use_pallas=False, interpret=True, **kw,
    )
    got = t_dp.device_probe_walk_batched(
        torch.full((Bp, n_pad), t_dp.POS_INF, dtype=torch.int32),
        *[_t(a) for a in host], k, budget, *[_t(a) for a in tables], **kw,
    )
    assert int(np.asarray(want[5])) >= 1
    for g, w, name in zip(got, want, WALK_OUT):
        _eq(torch.as_tensor(g), w, name)


@pytest.mark.parametrize("check_every,budget", [(1, None), (3, None), (1, 1)])
def test_plain_group_walk_matches_reference(check_every, budget):
    p, n, B, k = 32, 900, 4, 6
    index, csr, _ = _walk_case(p, n, B, seed=8, m=2)
    z = 16                                   # one z-group: every query z ones
    rng = np.random.default_rng(9)
    q_bits = np.zeros((B, p), dtype=np.uint8)
    for i in range(B):
        q_bits[i, rng.choice(p, size=z, replace=False)] = 1
    q = pack_bits(q_bits)
    sched = r_pd.get_schedule(p, index.m, csr["widths"], z,
                              index.probe_stream_cap)
    q_sub, z_sub = r_pd._query_substrings(index, q)
    pow1, pow0 = r_pd._pow_arrays(q_sub, z_sub, csr["widths"], csr["wmax"])
    t_stop = np.full(q.shape[0], sched.L - 1, dtype=np.int32)
    budget = budget or max(4, csr["n_pad"] // (4 * 2048))
    host = [q, q_sub.astype(np.int32), z_sub, pow1, pow0, t_stop]
    tables = [sched.tbl, sched.step_ext, sched.idx1, sched.idx0, sched.maxi1,
              sched.maxi0, np.asarray(sched.widths, dtype=np.int32)]
    tables += [np.asarray(csr[nm]) for nm in ("offsets", "ids", "db_pad")]
    tables.append(sched.inv_pos)
    kw = dict(_STATIC, p=p, check_every=check_every)
    want = r_dp.device_probe_walk(
        *[jnp.asarray(a) for a in host], jnp.int32(k), jnp.int32(sched.s_len),
        jnp.int32(budget), *[jnp.asarray(a) for a in tables],
        use_pallas=False, interpret=True, **kw,
    )
    got = t_dp.device_probe_walk(
        *[_t(a) for a in host], k, sched.s_len, budget,
        *[_t(a) for a in tables], **kw,
    )
    for g, w, name in zip(got, want, WALK_OUT):
        _eq(torch.as_tensor(g), w, name)


def test_plain_scans_match_reference():
    p, n, B = 64, 700, 6
    index, csr, q = _walk_case(p, n, B, seed=13, m=4)
    host, tables, Bp = _batched_args(index, csr, q, 5)
    inv = tables[-1]
    db_pad = np.asarray(csr["db_pad"])
    chunk = 256
    want = r_dp.device_probe_scan_multi(
        jnp.asarray(host[0]), jnp.asarray(host[5]), jnp.asarray(db_pad),
        jnp.asarray(inv), jnp.int32(n), p=p, chunk=chunk, use_pallas=False,
        interpret=True,
    )
    got = t_dp.device_probe_scan_multi(
        _t(host[0]), _t(host[5]), _t(db_pad), _t(inv), n, p=p, chunk=chunk,
    )
    _eq(got, want, "scan_multi")
    want1 = r_dp.device_probe_scan(
        jnp.asarray(host[0]), jnp.asarray(db_pad), jnp.asarray(inv[0]),
        jnp.int32(n), p=p, chunk=chunk, use_pallas=False, interpret=True,
    )
    got1 = t_dp.device_probe_scan(_t(host[0]), _t(db_pad), _t(inv[0]), n,
                                  p=p, chunk=chunk)
    _eq(got1, want1, "scan")


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_vt.gather_verify_grouped(x, x, x, x[0, :1], p=64)


# ------------------------------------------------- extraction (slice 6)
def _ref_rows(pm, t_stop, n, k, sims64):
    """The reference's host ``_extract`` of each map row: (ids, pos)."""
    out = []
    for b in range(pm.shape[0]):
        ids, pos, _ = r_pd._extract(pm[b], int(t_stop[b]), n, k, sims64)
        out.append((ids, pos))
    return out


def _eq_rows(ids, pos, want):
    ids, pos = ids.numpy(), pos.numpy()
    for b, (w_ids, w_pos) in enumerate(want):
        take = w_ids.size
        assert np.array_equal(ids[b, :take], w_ids), b
        assert np.array_equal(pos[b, :take], w_pos), b
        assert (ids[b, take:] == -1).all() and (pos[b, take:] == -1).all()


@settings(max_examples=8, deadline=None)
@given(p=st.sampled_from([32, 64, 128]), seed=st.integers(0, 1 << 16),
       k=st.sampled_from([1, 4, 17, 300]), n=st.sampled_from([300, 700]))
def test_plain_fused_scan_matches_reference_extract(p, seed, k, n):
    """The fused K3's plain version against the reference's
    ``device_probe_scan_multi`` map followed by its host ``_extract``: the
    same ids, positions and ``verified`` per query, with queries whose
    ``t_stop`` leaves fewer than k, ties at the k-th position (many codes
    share a tuple) and padded rows (``t_stop`` -1)."""
    index, csr, q = _walk_case(p, n, 6, seed=seed, m=max(2, p // 16))
    host, tables, Bp = _batched_args(index, csr, q, k)
    q_p, gid, t_stop = host[0], host[5], host[6].copy()
    t_stop[1] = min(t_stop[1], 2)
    inv = tables[-1]
    db_pad = np.asarray(csr["db_pad"])
    pm = np.asarray(r_dp.device_probe_scan_multi(
        jnp.asarray(q_p), jnp.asarray(gid), jnp.asarray(db_pad),
        jnp.asarray(inv), jnp.int32(n), p=p, chunk=256, use_pallas=False,
        interpret=True))
    stack = r_pd.get_schedule_stack(index.p, index.m, csr["widths"],
                                    index.probe_stream_cap)
    want = [_ref_rows(pm[b:b + 1], t_stop[b:b + 1], n, k,
                      stack.scheds[gid[b]].sims64)[0] for b in range(Bp)]
    ids, pos, ver = t_dp.device_probe_scan_topk(
        _t(q_p), _t(gid), _t(t_stop), _t(db_pad), _t(inv), n, k, p=p,
        chunk=256)
    _eq_rows(ids, pos, want)
    _eq(ver, (pm != r_pd.POS_INF).sum(axis=1), "verified")


@settings(max_examples=8, deadline=None)
@given(p=st.sampled_from([32, 64, 128]), seed=st.integers(0, 1 << 16),
       k=st.sampled_from([1, 5, 30]), cut=st.booleans())
def test_touched_list_extraction_matches_reference_extract(p, seed, k, cut):
    """The walk's touched lists and histograms, through
    ``extract_touched``, against the reference walk's map through its host
    ``_extract``, on the rows the walk finished: the same ids and
    positions; ``n_touched`` is the reference's ``verified``; and the map
    holds POS_INF everywhere afterwards."""
    n, B = 900, 10
    index, csr, q = _walk_case(p, n, B, seed=seed, m=max(2, p // 16))
    host, tables, Bp = _batched_args(index, csr, q, k)
    if cut:                                  # t_stop below the walk's end
        host[6][:B] = np.minimum(host[6][:B], 5)
    n_pad = csr["n_pad"]
    budget = max(4, n_pad // (4 * 2048 * Bp))
    kw = dict(_STATIC, p=p, check_every=1)
    want = jax.jit(
        r_dp.device_probe_walk_batched,
        static_argnames=("p", "tile", "cap", "kmax", "check_every",
                         "use_pallas", "interpret"),
    )(
        jnp.zeros((Bp, n_pad), jnp.int32), *[jnp.asarray(a) for a in host],
        jnp.int32(k), jnp.int32(budget), *[jnp.asarray(a) for a in tables],
        use_pallas=False, interpret=True, **kw,
    )
    pm = torch.full((Bp, n_pad), t_dp.POS_INF, dtype=torch.int32)
    got = t_dp.device_probe_walk_batched(
        pm, *[_t(a) for a in host], k, budget, *[_t(a) for a in tables], **kw)
    ref_pm = np.asarray(want[0])
    _eq(got[7], (ref_pm != r_pd.POS_INF).sum(axis=1), "n_touched")
    done = np.flatnonzero(np.asarray(want[3]))
    stack = r_pd.get_schedule_stack(index.p, index.m, csr["widths"],
                                    index.probe_stream_cap)
    gid, t_stop = host[5], host[6]
    ref = [_ref_rows(ref_pm[b:b + 1], t_stop[b:b + 1], n, k,
                     stack.scheds[gid[b]].sims64)[0] for b in done]
    ids, pos = t_dp.extract_touched(pm, got[6], got[8], _t(t_stop), k, done,
                                    int(got[5]) * kw["cap"])
    _eq_rows(ids, pos, ref)
    assert bool((pm == t_dp.POS_INF).all())
