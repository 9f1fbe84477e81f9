#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card; builds the kernels

It imports nothing of JAX and nothing of the reference package. Phases,
each of which fails the run (non-zero exit) on any error or mismatch:

1. the card (``nvidia-smi``), torch and nvcc versions; the six kernels
   built from ``src/repro_torch/kernels/csrc`` (one nvcc per source, all in
   parallel), with each build's register report;
2. each kernel against its plain PyTorch version on the card, by equality:
   K1 (grouped verify) at p in {64, 128}, B = 64, C = 2048 with ragged
   lengths that include 0; K2 (probing walk) and K3 (scan) on the operands
   the main path hands them at n = 2^18 clustered codes, B = 64 mixed z:
   the batched walk (G > 1) and the per-group walk (G = 1), each with
   check_every in {1, 3}, the cross-group scan, and the per-group scan
   (``probe_fused=False`` with a truncated stream), timed; K4 (linear-scan
   scores), K5 (block maxima) and K6 (one-query tuples) at n = 2^18,
   p in {64, 128}, B = 64 with a zero-norm query and an all-zero code,
   bit for bit;
3. the two exact paths at full size: n = 10,000,000 clustered codes
   (n_clusters = 256, flip_prob = 0.08), queries from
   ``synthetic_queries_packed`` (flip_prob = 0.05), p in {64, 128},
   B in {1, 64}, K in {10, 100}, median of 5 warm batches per case, 8
   queries per case against the exact float64 linear scan.
   a. AMIH, through ``make_engine("amih", ...)`` (the device walk, m = 4
      and 8), query cache off. Per case: one walk launch and at most one
      scan launch per batch; results equal the same index with
      ``probe_fused=False``. The host walk with the CUDA verify (K1)
      answers 4 queries per p and must equal the device path. One batch
      at p = 128, B in {64, 1}, runs under ``torch.profiler`` (card busy
      time, idle share, kernels by device time; Chrome traces in
      ``chiprun_out/``) and once more with the port's tracer on (host
      time by layer span).
   b. The linear scan, through ``make_engine("linear_scan", ...)`` (the
      CUDA backend: K4 per 65,536-code chunk, a running top-K, a float64
      host rerank). Per case: one K4 launch per chunk; the checked rows
      bit-identical to the float64 scan's sims; every B = 64 row equal to
      AMIH's but for equal-cosine ties (ROADMAP C-R1).
      ``ops.scan_topk_pruned`` (K5, then K4 on the surviving blocks) at
      B in {1, 64}, K = 10 equals ``ops.scan_topk``; ``ops.verify_tuples_op``
      (K6) on one query against all n codes equals the host's tuples. One
      batch at p = 128, B = 64 runs under the profiler and the tracer.
   Every kernel launch counter is set to 0 just before each path (a, b)
   at each p and read just after it;
4. each kernel against its plain version again, on operands captured from
   the main path at full size, with CUDA-event times beside each kernel's
   bound (the bytes it must move at 3.35 TB/s, or its 32-bit integer
   operations and population counts at the card's peak issue rates for
   them, whichever takes longest; see ``op_rates``).

Every time is printed with the card's name and power limit. The last two
lines are the ``kernels`` JSON record and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
N_MAIN = 10_000_000            # codes in the main-path index
SEED = 0
K_CHECK = 8                    # queries per case held against the linear scan


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def op_rates():
    """Peak 32-bit integer add/logic results and population counts per
    second of card 0: 64 and 16 per clock per SM on compute capability 9.0
    (CUDA C++ Programming Guide, throughput of native arithmetic
    instructions), times the card's SMs and its maximum SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    per_clock = sms * float(out.stdout.split()[0]) * 1e6
    return 64 * per_clock, 16 * per_clock


def bound_ms(nbytes, int_ops, popcs):
    """Least time for the work: bytes at the memory rate, or 32-bit integer
    operations and population counts at their peak rates, whichever takes
    longest; with what bounds it."""
    int_rate, popc_rate = op_rates()
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = max(int_ops / int_rate, popcs / popc_rate)
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


class Recorder:
    """Wraps the kernel entry points the launch layer calls (``sites``: the
    walk and scan wrappers of ``kernels.device_probe``, the grouped verify
    as ``kernels.ops`` calls it, or the linear scan's three kernel wrappers
    as ``kernels.ops`` calls them) to keep the operands of
    the first ``keep`` calls of each — of the grouped verify, its largest
    call — so each kernel can be checked and timed at the shapes the main
    path gives it. Launch counts are untouched: the wrapped function runs
    as before."""

    WALKS = ("device_probe_walk_batched", "device_probe_walk",
             "device_probe_scan_multi", "device_probe_scan")
    SCANS = ("hamming_scan_scores", "blockmax_scores", "verify_tuples")

    def __init__(self, sites, keep: int = 1):
        self.sites = sites          # (module, function name) pairs to wrap
        self.keep = keep
        self.calls = {}
        self.orig = []

    def __enter__(self):
        for mod, name in self.sites:
            fn = getattr(mod, name)
            self.orig.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _name=name, **kw):
                calls = self.calls.setdefault(_name, [])
                if _name == "gather_verify_grouped":
                    if self.keep and (not calls or a[2].numel()
                                      > calls[0][0][2].numel()):
                        calls[:] = [(a, kw)]
                elif len(calls) < self.keep:
                    calls.append((a, kw))
                return _fn(*a, **kw)

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.orig:
            setattr(mod, name, fn)
        return False


def sites(mod, names):
    """The (module, name) pairs of ``names`` in ``mod``, for ``Recorder``."""
    return [(mod, name) for name in names]


def cuda_ms(fn, reps: int) -> float:
    """Card time per call of ``fn``: CUDA events around ``reps`` calls.
    A spin kernel queued first (~0.1 ms per call at ~2 GHz) holds the
    stream until every call is enqueued, so the host's time to launch a
    short kernel does not show as card time between calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 2e5))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_err(outs, refs) -> int:
    """Largest absolute difference over paired integer outputs (0: equal),
    computed on the card in chunks; raises on any mismatch."""
    import torch

    worst = 0
    for o, r in zip(outs, refs):
        o = torch.as_tensor(o).reshape(-1)
        r = torch.as_tensor(r).reshape(-1).to(o.device)
        if o.shape != r.shape:
            raise AssertionError(f"shape {tuple(o.shape)} != {tuple(r.shape)}")
        for lo in range(0, o.numel(), 1 << 26):
            d = (o[lo : lo + (1 << 26)].to(torch.int64)
                 - r[lo : lo + (1 << 26)].to(torch.int64)).abs()
            worst = max(worst, int(d.max()))
    if worst:
        raise AssertionError(f"kernel differs from its plain version by {worst}")
    return worst


def profile_batch(fn, label, out_dir):
    """One traced call of ``fn`` under ``torch.profiler``: wall time, the
    card's busy time (the sum of its kernels) and the kernels that took
    it, by device time. The Chrome trace goes to ``out_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, busy = [], 0.0
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((dt / 1e3, e.count, e.key))
        busy += dt / 1e3
    rows.sort(reverse=True)
    log(f"  profile {label}: wall {wall:.3f} ms (under the profiler), card "
        f"busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}")
    for dt, cnt, key in rows[:10]:
        log(f"    {dt:10.4f} ms  x{cnt:<5d} {key[:80]}")
    out_dir.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out_dir / f"trace_{label}.json"))


def span_breakdown(fn, label):
    """One call of ``fn`` with the port's tracer on: host-clock ms summed
    by span name (``engine.knn_batch`` is the whole call; the ``probe.*``
    and ``launch.*`` spans are its layers; a span that waits on the card
    includes the card's time)."""
    from repro_torch.obs import trace

    fn()
    tr = trace.enable()
    try:
        fn()
    finally:
        trace.disable()
    by = {}
    for sp in tr.drain():
        by[sp["name"]] = by.get(sp["name"], 0.0) + sp["dur"] / 1e3
    log(f"  spans {label} (host clock, ms): " + ", ".join(
        f"{name} {ms:.3f}" for name, ms in
        sorted(by.items(), key=lambda kv: -kv[1])))


# ------------------------------------------------------------------ checks
def check_walk_calls(dp, rec, label, timed=frozenset(), reps=3):
    """Kernel vs plain on every recorded walk/scan call, timing the kernels
    named in ``timed``; returns per-kernel measurements {name: dict}."""
    import torch

    from repro_torch.kernels import verify_tuples as vt

    res = {}
    for name, calls in rec.calls.items():
        for (a, kw) in calls:
            if name == "gather_verify_grouped":
                kernel = vt.gather_verify_grouped
                cadences = (None,)

                def plain(q, db, idx, lens, p):
                    return vt.gather_verify_grouped_plain(q, db, idx, lens, p)
            elif name == "device_probe_walk_batched":
                kernel, plain = dp.device_probe_walk_batched, \
                    dp.device_probe_walk_batched_plain
                cadences = (1, 3)
            elif name == "device_probe_walk":
                kernel, plain = dp.device_probe_walk, dp.device_probe_walk_plain
                cadences = (1, 3)
            elif name == "device_probe_scan_multi":
                kernel, plain = dp.device_probe_scan_multi, \
                    dp.device_probe_scan_multi_plain
                cadences = (None,)
            else:
                kernel, plain = dp.device_probe_scan, dp.device_probe_scan_plain
                cadences = (None,)
            for ce in cadences:
                kw2 = dict(kw) if ce is None else dict(kw, check_every=ce)
                if name == "device_probe_walk_batched":
                    buf = a[0]
                    args = lambda: (torch.empty_like(buf),) + tuple(a[1:])
                else:
                    args = lambda: tuple(a)
                saved = dict(dp.LAUNCHES), dict(vt.LAUNCHES)
                got = kernel(*args(), **kw2)
                torch.cuda.synchronize()
                ref = plain(*args(), **kw2)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                err = max_err(got, ref)
                entry = res.setdefault(name, {"max_abs_err": 0, "calls": 0})
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                entry["calls"] += 1
                if name in timed and ce in (None, kw.get("check_every", 1)):
                    entry["ms"] = cuda_ms(lambda: kernel(*args(), **kw2), reps)
                    t0 = time.perf_counter()
                    plain(*args(), **kw2)
                    torch.cuda.synchronize()
                    entry["plain_ms"] = (time.perf_counter() - t0) * 1e3
                    entry["args"], entry["kw"], entry["out"] = a, kw2, got
                dp.LAUNCHES.update(saved[0])   # comparisons do not count
                vt.LAUNCHES.update(saved[1])
            rows = a[1 if name.endswith("batched") else 0].shape[0]
            if name == "gather_verify_grouped":
                rows = f"{rows}, C={a[2].shape[1]}"
            how = ("check_every 1 and 3" if cadences[0] is not None
                   else "one launch")
            log(f"  {label} {name} ({how}, B={rows}): equal")
    return res


# One verify of a code of W words: per word two and-nots, two population
# counts and two adds; then the key's multiply-add and a few compares,
# indexing and masking (``extra``).
def walk_bound_ms(entry, W):
    """Least time of one walk launch: posmap written once, every retrieved
    candidate's id and code read once, two CSR offsets per probe."""
    posmap, probes, retrieved = entry["out"][:3]
    live = int(retrieved.sum())
    nbytes = posmap.numel() * 4 + live * (4 + 4 * W) + int(probes.sum()) * 8
    return bound_ms(nbytes, live * (4 * W + 8), live * 2 * W)


# A scan of B queries over N codes needs less: r10 = z - |q & c| and
# r01 = |c| - |q & c|, so per pair W ands, population counts and adds for
# |q & c| and ``extra`` operations after them, and per code W population
# counts and adds for |c|, which the B queries share.
def pair_bound_ms(nbytes, B, N, W, extra):
    return bound_ms(nbytes, B * N * (2 * W + extra) + N * W,
                    B * N * W + N * W)


def scan_bound_ms(q_words, db_pad):
    """Least time of a K3 launch: codes and queries read once, the (B,
    n_pad) keys written once; per pair the key's r10, r01 and multiply-add."""
    B, W = q_words.shape
    n_pad = db_pad.shape[0]
    nbytes = db_pad.numel() * 4 + B * n_pad * 4 + q_words.numel() * 4
    return pair_bound_ms(nbytes, B, n_pad, W, 3)


def verify_bound_ms(B, C, W, live):
    nbytes = B * W * 4 + B * C * 4 + B * 4 + live * W * 4 + B * C * 4
    return bound_ms(nbytes, live * (4 * W + 3), live * 2 * W)


def check_verify(vt, torch, dev, p, B=64, C=2048, N=1 << 18, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    W = (p + 31) // 32
    db = torch.from_numpy(
        rng.integers(0, 1 << 32, size=(N, W), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).to(dev)
    q = torch.from_numpy(
        rng.integers(0, 1 << 32, size=(B, W), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).to(dev)
    idx = torch.from_numpy(
        rng.integers(0, N, size=(B, C)).astype(np.int32)).to(dev)
    lens_np = rng.integers(0, C + 1, size=B).astype(np.int32)
    lens_np[0], lens_np[1] = 0, C
    lens = torch.from_numpy(lens_np).to(dev)
    saved = dict(vt.LAUNCHES)
    got = vt.gather_verify_grouped(q, db, idx, lens, p=p)
    torch.cuda.synchronize()
    ref = vt.gather_verify_grouped_plain(q, db, idx, lens, p)
    torch.cuda.synchronize()
    err = max_err([got], [ref])
    ms = cuda_ms(lambda: vt.gather_verify_grouped(q, db, idx, lens, p=p), 20)
    pl = cuda_ms(lambda: vt.gather_verify_grouped_plain(q, db, idx, lens, p),
                 5)
    vt.LAUNCHES.update(saved)
    bound, by = verify_bound_ms(B, C, W, int(lens_np.sum()))
    return {"max_abs_err": err, "ms": ms, "plain_ms": pl, "bound_ms": bound,
            "bound_by": by}


def scan_bound_ms_pairs(B, N, W, out_elems):
    """Least time of a K4/K5 launch: codes and queries read once, the
    ``out_elems`` float32 results written once; per (query, code) pair
    the Eq. 3 numerator |q & c| and the denominator's multiply z * |c|.
    The float work after it (a conversion and a multiply per pair, the
    square root and reciprocal per distinct z * |c|) is not counted."""
    nbytes = N * W * 4 + B * (W + 1) * 4 + out_elems * 4
    return pair_bound_ms(nbytes, B, N, W, 1)


def scan_kernels(hs, bm, vt):
    """name -> (kernel, plain, LAUNCHES dict) of the linear scan's three
    kernel wrappers, keyed as ``Recorder.SCANS`` names them."""
    return {
        "hamming_scan_scores": (hs.hamming_scan_scores,
                                hs.hamming_scan_scores_plain, hs.LAUNCHES),
        "blockmax_scores": (bm.blockmax_scores, bm.blockmax_scores_plain,
                            bm.LAUNCHES),
        "verify_tuples": (vt.verify_tuples, vt.verify_tuples_plain,
                          vt.LAUNCHES),
    }


def check_scan_call(kernels, name, a, kw, timed=False, reps=20):
    """K4/K5/K6 on one call's operands against the plain version on the
    same tensors, bit for bit (float32 scores compared as their bits);
    with ``timed``, the kernel's CUDA-event time, the plain version's
    host-clock time around one call, and the bound."""
    import torch

    kernel, plain, counts = kernels[name]
    call_plain = lambda: plain(*a, **kw)
    saved = dict(counts)
    got = kernel(*a, **kw)
    torch.cuda.synchronize()
    ref = call_plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    bits = [t.view(torch.int32) if t.dtype == torch.float32 else t
            for t in got + ref]
    max_err(bits[:len(got)], bits[len(got):])     # raises unless equal
    err = max(float((g.double() - r.double()).abs().max()) if g.numel()
              else 0.0 for g, r in zip(got, ref))
    entry = {"max_abs_err": err}
    if timed:
        entry["ms"] = cuda_ms(lambda: kernel(*a, **kw), reps)
        t0 = time.perf_counter()
        call_plain()
        torch.cuda.synchronize()
        entry["plain_ms"] = (time.perf_counter() - t0) * 1e3
        if name == "verify_tuples":
            q, cand = a
            N, W = cand.shape
            entry["bound_ms"], entry["bound_by"] = bound_ms(
                N * W * 4 + W * 4 + 2 * N * 4, N * 4 * W, N * 2 * W)
        else:
            q, _, db = a
            B, W = q.shape
            entry["bound_ms"], entry["bound_by"] = scan_bound_ms_pairs(
                B, db.shape[0], W, got[0].numel())
        entry["shape"] = (f"q {tuple(a[0].shape)}, codes "
                          f"{tuple(a[-1].shape)}")
    counts.update(saved)                          # comparisons do not count
    return entry


def check_scan_kernels(kernels, ops, torch, dev, p, n=1 << 18, B=64):
    """Phase 2: K4, K5 and K6 against their plain versions at n codes,
    with a zero-norm query, an all-zero code and a ragged last block."""
    from repro_torch.data.synthetic import (
        synthetic_binary_codes_packed,
        synthetic_queries_packed,
    )

    db = synthetic_binary_codes_packed(n - 100, p, seed=SEED + p)
    q = synthetic_queries_packed(db, p, B, seed=SEED + p + 1)
    db[5] = 0
    q[1] = 0
    db_t, q_t = ops.to_device(db, dev), ops.to_device(q, dev)
    z = ops.query_popcounts(q_t)
    calls = (("hamming_scan_scores", (q_t, z, db_t), {}),
             ("blockmax_scores", (q_t, z, db_t), {"blk_n": 2048}),
             ("verify_tuples", (q_t[0], db_t), {}))
    for name, a, kw in calls:
        check_scan_call(kernels, name, a, kw)
    return [name for name, _, _ in calls]


def same_but_ties(ids, sims, o_ids, o_sims, atol=1e-12):
    """Rows of two exact top-Ks: equal, or equal but for equal-cosine ties
    (ROADMAP C-R1: AMIH emits two tuples of equal exact cosine in tuple
    order, and their float64 sims may round 1 ulp apart). Sims must agree
    within ``atol``, and ids at every position whose sim has no partner
    within ``atol`` in the row and is not within ``atol`` of the k-th.
    Returns the number of rows that are equal outright; raises otherwise."""
    import numpy as np

    exact = 0
    for i in range(ids.shape[0]):
        if (np.array_equal(ids[i], o_ids[i])
                and np.array_equal(sims[i], o_sims[i])):
            exact += 1
            continue
        s = sims[i]
        near = np.abs(s[:, None] - s[None, :]) <= atol
        tied = (near.sum(axis=1) > 1) | (np.abs(s - s[-1]) <= atol)
        if not (np.allclose(s, o_sims[i], rtol=0, atol=atol)
                and np.array_equal(ids[i][~tied], o_ids[i][~tied])):
            raise AssertionError(f"row {i}: the two exact paths differ "
                                 "beyond equal-cosine ties")
    return exact


def scan_path(p, db, batch, singles, chk, want_topk, amih_rows, *, dev,
              tag, timings):
    """Phase 3b at one p: the CUDA linear scan's cases (appended to
    ``timings``), its pruned scan and its one-query verify, each checked
    as the module docstring says. ``want_topk(row, k)`` is the float64
    scan's top-k of row ``row`` of ``chk``; ``amih_rows[k]`` the AMIH
    path's B = 64 result."""
    import numpy as np
    import torch

    from repro_torch.core.engine import make_engine
    from repro_torch.core.linear_scan import sims_for_ids
    from repro_torch.core.packing import hamming_tuples
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import REGISTRY

    chunks = -(-N_MAIN // (1 << 16))   # K4 launches per batch
    eng = make_engine("linear_scan", db, p)

    def check_exact(ids, sims, k, off):
        for j in range(K_CHECK):
            w_ids, w_sims = want_topk(off + j, k)
            tie = w_sims == w_sims[-1]
            if not (np.array_equal(sims[j], w_sims)
                    and np.array_equal(ids[j][~tie], w_ids[~tie])
                    and len(set(ids[j].tolist())) == k
                    and np.array_equal(sims_for_ids(chk[off + j], db,
                                                    ids[j]), sims[j])):
                raise AssertionError(f"linear scan p={p} k={k}: query "
                                     f"{j} differs from the float64 scan")

    for B in (64, 1):
        for K in (10, 100):
            s0 = REGISTRY.value("launches.scan_scores")
            ms = []
            if B == 64:
                eng.knn_batch(batch, K)                      # warm
                for _ in range(5):
                    t0 = time.perf_counter()
                    ids, sims, _ = eng.knn_batch(batch, K)
                    ms.append((time.perf_counter() - t0) * 1e3 / B)
                n_batches = 6
                check_exact(ids, sims, K, 0)
                a_ids, a_sims = amih_rows[K]
                exact = same_but_ties(ids, sims, a_ids, a_sims)
                vs_amih = (f"; {exact}/{B} rows equal to AMIH's, the "
                           f"rest but for equal-cosine ties")
            else:
                eng.knn_batch(singles[:1], K)                # warm
                res = []
                for j in range(1, 1 + K_CHECK):
                    t0 = time.perf_counter()
                    res.append(eng.knn_batch(singles[j:j + 1], K))
                    if j <= 5:
                        ms.append((time.perf_counter() - t0) * 1e3)
                n_batches = 1 + K_CHECK
                check_exact(np.stack([r[0][0] for r in res]),
                            np.stack([r[1][0] for r in res]), K, K_CHECK)
                vs_amih = ""
            per = (REGISTRY.value("launches.scan_scores") - s0) / n_batches
            if per != chunks:
                raise AssertionError(f"linear scan p={p} B={B} K={K}: "
                                     f"{per} K4 launches per batch, "
                                     f"expected {chunks}")
            med = statistics.median(ms)
            timings.append((p, B, K, med))
            log(f"  linear scan p={p} B={B} K={K}: {med:.4f} ms/query "
                f"(median of 5 warm batches) {tag}; {per:.0f} K4 "
                f"launches/batch; exact vs the float64 scan{vs_amih}")
    db_t = ops.to_device(db, dev)
    q_t = ops.to_device(batch, dev)
    for B in (64, 1):
        f_sims, f_ids = ops.scan_topk(q_t[:B], db_t, 10)
        p_sims, p_ids, frac = ops.scan_topk_pruned(q_t[:B], db_t, 10)
        if not (torch.equal(f_sims, p_sims) and torch.equal(f_ids, p_ids)):
            raise AssertionError(f"p={p} B={B}: scan_topk_pruned differs "
                                 "from scan_topk")
        log(f"  scan_topk_pruned p={p} B={B} K=10: equal to scan_topk; "
            f"scanned_fraction {float(frac):.6f}")
    r10, r01 = ops.verify_tuples_op(q_t[0], db_t)
    h10, h01 = hamming_tuples(batch[0], db)
    if not (np.array_equal(r10.cpu().numpy(), h10)
            and np.array_equal(r01.cpu().numpy(), h01)):
        raise AssertionError(f"p={p}: verify_tuples_op differs from the "
                             "host's tuples")
    log(f"  verify_tuples_op p={p}, one query x {N_MAIN:,} codes: equal "
        f"to the host's tuples")
    if p == 128:
        profile_batch(lambda: eng.knn_batch(batch, 10),
                      "scan_p128_B64_K10", ROOT / "chiprun_out")
        span_breakdown(lambda: eng.knn_batch(batch, 10),
                       "scan_p128_B64_K10")


# --------------------------------------------------------------- main path
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and phase 2 only (no main path, no result)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch.convert import index_from_reference, index_state
    from repro_torch.core.engine import make_engine
    from repro_torch.core.linear_scan import (
        sims_batch_against_db,
        sims_for_ids,
        topk_from_sims,
    )
    from repro_torch.data.synthetic import (
        synthetic_binary_codes_packed,
        synthetic_queries_packed,
    )
    from repro_torch.kernels import _build, device_probe as dp, ops
    from repro_torch.kernels import blockmax_scan as bm
    from repro_torch.kernels import hamming_scan as hs
    from repro_torch.kernels import verify_tuples as vt
    from repro_torch.obs.metrics import REGISTRY

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    tag = f"[{card}]"
    log(f"card: {card}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}); nvcc: "
        f"{nvcc.stdout.strip().splitlines()[-1]}")
    int_rate, popc_rate = op_rates()
    log(f"peak rates for the bounds: {int_rate / 1e12:.2f} T 32-bit integer "
        f"ops/s, {popc_rate / 1e12:.2f} T population counts/s, "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s {tag}")

    # ---- phase 1: build
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"phase 1: built {sorted(built)} in "
        f"{time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for name in _build.KERNELS:
        rep = _build.build_log(name) or ""
        regs = [ln.strip() for ln in rep.splitlines() if "registers" in ln]
        log(f"  {name}: {regs[-1] if regs else 'no ptxas report'}")
        _build.load(name)

    # ---- phase 2: kernels vs plain at n = 2^18
    log("phase 2: kernels vs plain versions on the card (equality)")
    k1 = {}
    for p in (64, 128):
        k1[p] = check_verify(vt, torch, dev, p)
        log(f"  K1 verify_grouped p={p} B=64 C=2048: equal; "
            f"{k1[p]['ms']:.4f} ms {tag}")
    n_small = 1 << 18
    db_s = synthetic_binary_codes_packed(n_small, 64, seed=SEED)
    q_s = synthetic_queries_packed(db_s, 64, 64, seed=SEED + 1)
    eng = make_engine("amih", db_s, 64, m=4, query_cache_size=0)
    with Recorder(sites(dp, Recorder.WALKS), keep=3) as rec:
        eng.knn_batch(q_s, 10)                    # batched walk, G > 1
        eng.knn_batch(q_s[:1], 10)                # per-group walk, G = 1
        eng.index.probe_fused = False
        eng.knn_batch(q_s[:16], 10)               # per-group walks + scans
        eng.index.probe_fused = True
        # a truncated probe stream sends queries to the scan
        eng2 = make_engine("amih", db_s, 64, m=4, query_cache_size=0,
                           probe_stream_cap=256)
        eng2.knn_batch(q_s, 10)
        eng2.index.probe_fused = False            # ... and the per-group scan
        eng2.knn_batch(q_s, 10)
    missing = set(Recorder.WALKS) - set(rec.calls)
    if missing:
        raise AssertionError(f"phase 2 never called {sorted(missing)}")
    small = check_walk_calls(dp, rec, "n=2^18",
                             timed={"device_probe_scan"})["device_probe_scan"]
    a = small["args"]
    small["bound_ms"], small["bound_by"] = scan_bound_ms(a[0], a[1])
    log(f"  device_probe_scan (G = 1) n=2^18 B={a[0].shape[0]}: kernel "
        f"{small['ms']:.4f} ms, plain {small['plain_ms']:.2f} ms, bound "
        f"{small['bound_ms']:.4f} ms ({small['bound_by']}) {tag}")
    log(f"  K2 grid: {dp.LAST_WALK_GRID[0]} co-resident blocks x "
        f"{dp.LAST_WALK_GRID[1]} threads")
    kernels46 = scan_kernels(hs, bm, vt)
    for p in (64, 128):
        names = check_scan_kernels(kernels46, ops, torch, dev, p)
        log(f"  {', '.join(names)} p={p} n=2^18 B=64: equal bit for bit")
    torch.cuda.synchronize()
    del eng, eng2, rec
    gc.collect()
    torch.cuda.empty_cache()
    if args.quick:
        log(f"quick run done in {time.perf_counter() - t_start:.1f} s")
        return 0

    # ---- phase 3: the main path at full size
    log(f"phase 3: main paths, n={N_MAIN:,} clustered codes {tag}")
    counted = (dp, vt, hs, bm)

    def zero_counts():
        for mod in counted:
            for c in mod.LAUNCHES:
                mod.LAUNCHES[c] = 0
        REGISTRY.reset("launches.")

    def add_counts(total):
        for mod in counted:
            for c, v in mod.LAUNCHES.items():
                total[c] = total.get(c, 0) + v

    amih_counts, scan_counts = {}, {}
    captured = {}
    captured_scan = {}
    timings = []
    scan_timings = []
    for p, m in ((64, 4), (128, 8)):
        t0 = time.perf_counter()
        db = synthetic_binary_codes_packed(N_MAIN, p, seed=SEED)
        qs = synthetic_queries_packed(db, p, 64 + 1 + 5 + K_CHECK,
                                      seed=SEED + 1)
        t_gen = time.perf_counter() - t0
        zero_counts()                     # path a: AMIH
        t0 = time.perf_counter()
        eng = make_engine("amih", db, p, m=m, query_cache_size=0)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        log(f"  p={p} m={m}: data {t_gen:.1f} s, index build + placement "
            f"{t_build:.1f} s (host numpy sort)")
        batch = qs[:64]
        singles = qs[64:]
        # the exact float64 oracle for the checked queries
        t0 = time.perf_counter()
        chk = np.concatenate([batch[:K_CHECK], singles[1 : 1 + K_CHECK]])
        oracle = sims_batch_against_db(chk, db, chunk=1 << 16)
        log(f"  p={p}: linear-scan oracle for {len(chk)} queries "
            f"{time.perf_counter() - t0:.1f} s (host numpy)")

        wanted = {}

        def want_topk(row, k):
            if (row, k) not in wanted:
                wanted[row, k] = topk_from_sims(oracle[row], k)
            return wanted[row, k]

        def check_scan(rows, ids, sims, k, off):
            for j, r in enumerate(rows):
                _, want = want_topk(off + r, k)
                if not np.allclose(sims[j], want, rtol=0, atol=1e-9):
                    raise AssertionError(f"p={p} k={k}: sims differ from "
                                         f"the linear scan (query {r})")
                got = sims_for_ids(chk[off + r], db, ids[j])
                if not np.allclose(got, sims[j], rtol=0, atol=1e-9):
                    raise AssertionError(f"p={p} k={k}: ids do not carry "
                                         f"their sims (query {r})")

        amih_rows = {}
        for B in (64, 1):
            for K in (10, 100):
                walks0 = REGISTRY.value("launches.device_probe")
                scans0 = REGISTRY.value("launches.device_probe_scan")
                # operands of the main path's launches, kept for phase 4
                with Recorder(sites(dp, Recorder.WALKS),
                              keep=1 if K == 10 else 0) as rec:
                    if B == 64:
                        ids, sims, st = eng.knn_batch(batch, K)   # warm
                        n_batches = 1
                        ms = []
                        for _ in range(5):
                            t0 = time.perf_counter()
                            ids, sims, st = eng.knn_batch(batch, K)
                            ms.append((time.perf_counter() - t0) * 1e3 / B)
                            n_batches += 1
                        check_scan(range(K_CHECK), ids[:K_CHECK],
                                   sims[:K_CHECK], K, 0)
                        res_ids, res_sims = ids, sims
                        amih_rows[K] = (ids, sims)
                    else:
                        eng.knn_batch(singles[:1], K)             # warm
                        n_batches = 1
                        ms = []
                        res_ids, res_sims = [], []
                        for j in range(1, 1 + K_CHECK):
                            t0 = time.perf_counter()
                            ids, sims, st = eng.knn_batch(singles[j:j + 1], K)
                            if j <= 5:
                                ms.append((time.perf_counter() - t0) * 1e3)
                            n_batches += 1
                            res_ids.append(ids[0])
                            res_sims.append(sims[0])
                        res_ids = np.stack(res_ids)
                        res_sims = np.stack(res_sims)
                        check_scan(range(K_CHECK), res_ids, res_sims, K,
                                   K_CHECK)
                walks = REGISTRY.value("launches.device_probe") - walks0
                scans = REGISTRY.value("launches.device_probe_scan") - scans0
                if walks != n_batches or scans > n_batches:
                    raise AssertionError(
                        f"p={p} B={B} K={K}: {walks} walk and {scans} scan "
                        f"launches for {n_batches} batches")
                bails = sum(s.fell_back_to_scan for s in st.per_query)
                # parity oracle: the same index, one walk per z-group
                eng.index.probe_fused = False
                try:
                    if B == 64:
                        o_ids, o_sims, _ = eng.knn_batch(batch, K)
                    else:
                        outs = [eng.knn_batch(singles[j:j + 1], K)
                                for j in range(1, 1 + K_CHECK)]
                        o_ids = np.stack([o[0][0] for o in outs])
                        o_sims = np.stack([o[1][0] for o in outs])
                finally:
                    eng.index.probe_fused = True
                if not (np.array_equal(o_ids, res_ids)
                        and np.array_equal(o_sims, res_sims)):
                    raise AssertionError(f"p={p} B={B} K={K}: fused walk "
                                         "differs from probe_fused=False")
                med = statistics.median(ms)
                timings.append((p, B, K, med, walks / n_batches,
                                scans / n_batches, bails))
                log(f"  p={p} B={B} K={K}: {med:.4f} ms/query (median of 5 "
                    f"warm batches) {tag}; walk launches/batch "
                    f"{walks / n_batches:.0f}, scan launches/batch "
                    f"{scans / n_batches:.2f}, bailed {bails}/{B} in the "
                    f"last batch; equal to probe_fused=False and exact vs "
                    f"the linear scan")
                for name, calls in rec.calls.items():
                    captured.setdefault((p, B, K, name), calls)
        if p == 128:
            # where the time goes: one traced batch per shape
            out_dir = ROOT / "chiprun_out"
            profile_batch(lambda: eng.knn_batch(batch, 10), "p128_B64_K10",
                          out_dir)
            profile_batch(lambda: eng.knn_batch(singles[1:2], 10),
                          "p128_B1_K10", out_dir)
            span_breakdown(lambda: eng.knn_batch(batch, 10), "p128_B64_K10")
            span_breakdown(lambda: eng.knn_batch(singles[1:2], 10),
                           "p128_B1_K10")
        # the host walk with the CUDA grouped verify (K1), on the same tables
        t0 = time.perf_counter()
        host = index_from_reference(index_state(eng.index),
                                    verify_backend="cuda",
                                    probe_backend="host")
        with Recorder(sites(dp, Recorder.WALKS)
                      + [(ops, "gather_verify_grouped")]) as krec:
            h_ids, h_sims = host.knn_batch(batch[:4], 10)
        captured[(p, 4, 10, "gather_verify_grouped")] = krec.calls.get(
            "gather_verify_grouped", [])
        t_host = time.perf_counter() - t0
        d_ids, d_sims, _ = eng.knn_batch(batch[:4], 10)
        if not (np.array_equal(h_ids, d_ids)
                and np.array_equal(h_sims, d_sims)):
            raise AssertionError(f"p={p}: host walk differs from device walk")
        log(f"  p={p}: host walk + CUDA verify, 4 queries K=10: equal to the "
            f"device path; {host.verify_launches} verify launches, "
            f"{t_host:.1f} s")
        add_counts(amih_counts)
        del host, eng
        gc.collect()
        torch.cuda.empty_cache()

        zero_counts()                     # path b: the linear scan
        with Recorder(sites(ops, Recorder.SCANS)) as srec:
            scan_path(p, db, batch, singles, chk, want_topk, amih_rows,
                      dev=dev, tag=tag, timings=scan_timings)
        add_counts(scan_counts)
        captured_scan[p] = srec.calls
        del db
        gc.collect()
        torch.cuda.empty_cache()
    launches = {"verify_grouped": amih_counts["verify_grouped"],
                "probe_walk": amih_counts["probe_walk"],
                "probe_scan": amih_counts["probe_scan"],
                "hamming_scan": scan_counts["hamming_scan"],
                "blockmax_scan": scan_counts["blockmax_scan"],
                "verify_tuples": scan_counts["verify_tuples"]}
    log(f"  kernel launches, AMIH path: {amih_counts}")
    log(f"  kernel launches, linear-scan path: {scan_counts}")
    for name, cnt in launches.items():
        if cnt == 0:
            raise AssertionError(f"kernel {name} never ran on its main path")

    # ---- phase 4: kernels vs plain on main-path operands, timed
    log(f"phase 4: kernels vs plain at main-path shapes, times {tag}")
    per = {}
    for (p, B, K, name), calls in sorted(captured.items(),
                                         key=lambda kv: str(kv[0])):
        if K != 10:
            continue
        sub = Recorder([])
        sub.calls = {name: calls}
        res = check_walk_calls(dp, sub, f"p={p} B={B}", timed={name})
        for nm, entry in res.items():
            W = (p + 31) // 32
            if nm == "gather_verify_grouped":
                q_words, _, idx, lens = entry["args"]
                bound, by = verify_bound_ms(q_words.shape[0], idx.shape[1], W,
                                            int(lens.sum()))
            elif nm.startswith("device_probe_walk"):
                bound, by = walk_bound_ms(entry, W)
            else:
                a = entry["args"]
                q_words = a[0]
                db_pad = a[2] if nm == "device_probe_scan_multi" else a[1]
                bound, by = scan_bound_ms(q_words, db_pad)
            entry.update(bound_ms=bound, bound_by=by)
            per[(p, B, nm)] = entry
            log(f"  {nm} p={p} B={B}: kernel {entry['ms']:.4f} ms, plain "
                f"{entry['plain_ms']:.2f} ms, bound {bound:.4f} ms ({by}) "
                f"{tag}")

    scan_meas = {}
    for p in (64, 128):
        for name in Recorder.SCANS:
            calls = captured_scan[p].get(name)
            if not calls:
                raise AssertionError(f"the linear-scan path at p={p} never "
                                     f"called {name}")
            (a, kw), = calls
            e = check_scan_call(kernels46, name, a, kw, timed=True)
            scan_meas[p, name] = e
            log(f"  {name} p={p} ({e['shape']}): kernel {e['ms']:.4f} ms, "
                f"plain {e['plain_ms']:.2f} ms, bound {e['bound_ms']:.4f} ms "
                f"({e['bound_by']}), equal bit for bit {tag}")

    def pick(names):
        best = None
        for key, e in per.items():
            if key[2] in names and (best is None or key[1] > best[0][1]
                                    or (key[1] == best[0][1]
                                        and key[0] > best[0][0])):
                best = (key, e)
        return best

    kernels = []
    k1_main = pick(("gather_verify_grouped",))
    walk = pick(("device_probe_walk_batched",))
    scan = pick(("device_probe_scan_multi",))
    for name, src_file, replaces, launches_n, meas in (
        ("verify_grouped", "src/repro_torch/kernels/csrc/verify_grouped.cu",
         "src/repro/kernels/verify_tuples.py:93", launches["verify_grouped"],
         k1_main[1] if k1_main else None),
        ("probe_walk", "src/repro_torch/kernels/csrc/probe_walk.cu",
         "src/repro/kernels/device_probe.py:309", launches["probe_walk"],
         walk[1] if walk else None),
        ("probe_scan", "src/repro_torch/kernels/csrc/probe_scan.cu",
         "src/repro/kernels/device_probe.py:534", launches["probe_scan"],
         scan[1] if scan else None),
        ("hamming_scan", "src/repro_torch/kernels/csrc/hamming_scan.cu",
         "src/repro/kernels/hamming_scan.py:62", launches["hamming_scan"],
         scan_meas[128, "hamming_scan_scores"]),
        ("blockmax_scan", "src/repro_torch/kernels/csrc/blockmax_scan.cu",
         "src/repro/kernels/blockmax_scan.py:53", launches["blockmax_scan"],
         scan_meas[128, "blockmax_scores"]),
        ("verify_tuples", "src/repro_torch/kernels/csrc/verify_tuples.cu",
         "src/repro/kernels/verify_tuples.py:134", launches["verify_tuples"],
         scan_meas[128, "verify_tuples"]),
    ):
        if meas is None:
            raise AssertionError(f"no main-path measurement of {name}")
        kernels.append({
            "name": name, "route": "cuda", "source": src_file,
            "replaces": replaces, "launches": int(launches_n),
            "max_abs_err": float(meas["max_abs_err"]),
            "ms": round(float(meas["ms"]), 6),
            "plain_ms": round(float(meas["plain_ms"]), 6),
            "bound_ms": round(float(meas["bound_ms"]), 6),
            "bound_by": meas["bound_by"], "library_ms": None,
        })
    log("summary (ms/query, median of 5 warm batches) " + tag)
    for (p, B, K, med, wpb, spb, bails) in timings:
        log(f"  p={p:3d} B={B:2d} K={K:3d}: {med:.4f} ms/query; "
            f"walk/batch {wpb:.0f}, scan/batch {spb:.2f}")
    for (p, B, K, med) in scan_timings:
        log(f"  linear scan p={p:3d} B={B:2d} K={K:3d}: {med:.4f} ms/query")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
