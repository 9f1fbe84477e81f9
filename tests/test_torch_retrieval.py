"""The port's AQBC and retrieval service (``repro_torch.core.aqbc``,
``repro_torch.serve``) against the JAX reference on the same inputs: the
tiny gemma in float32 with the reference's random init carried across,
numpy-seeded documents and queries, and the reference's initial AQBC
rotation handed to the port.

Tolerances: AQBC codes are compared exactly, except rows whose two best
prefix scores lie within ``MARGIN`` = 1e-6 of each other (float32 sums in
another order may pick either; they are counted); the learned rotation
within 1e-4 and the objective trace within 1e-5 (float32 SVDs of the
same matrix). Search results on the same codes are compared bit for bit:
ids and float64 sims.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as r_get_tiny
from repro.core import aqbc as r_aqbc
from repro.core import linear_scan_knn as r_linear_scan_knn
from repro.core.engine import make_engine as r_make
from repro.models import Model as RModel
from repro.serve.retrieval import RetrievalConfig as RConfig
from repro.serve.retrieval import RetrievalService as RService

from repro_torch.configs import get_tiny
from repro_torch.convert import params_from_reference
from repro_torch.core import aqbc as t_aqbc
from repro_torch.models import Model
from repro_torch.obs import trace as t_trace
from repro_torch.serve import RetrievalConfig, RetrievalService

MARGIN = 1e-6
BITS = 32


def _margin_rows(v):
    """Rows of projections v (n, c) whose two best AQBC prefix scores lie
    within MARGIN: float32 noise may decide between them."""
    v = np.asarray(v, np.float64)
    c = v.shape[1]
    s = np.sort(-v, axis=1, kind="stable")
    scores = np.cumsum(-s, axis=1) / np.sqrt(np.arange(1, c + 1))
    top2 = np.sort(scores, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) <= MARGIN


def _init_rotation(d, c):
    """The reference ``learn``'s default initial rotation (its key 0)."""
    g = jax.random.normal(jax.random.key(0), (d, c), dtype=jnp.float32)
    return torch.from_numpy(np.array(jnp.linalg.qr(g)[0]))


# -------------------------------------------------------------------- AQBC
def test_encode_projected_matches_reference():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(600, BITS)).astype(np.float32)
    v[:50] = np.round(v[:50] * 2) / 2          # equal values: stable order
    v[50:60] = 0.25                             # all equal
    want = np.asarray(r_aqbc.encode_projected(jnp.asarray(v)))
    got = t_aqbc.encode_projected(torch.from_numpy(v)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    margin = _margin_rows(v)
    assert margin.sum() < 60, margin.sum()      # counted, and few
    np.testing.assert_array_equal(got[~margin], want[~margin])


def test_learn_from_reference_init_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.random((300, 24)).astype(np.float32)
    want = r_aqbc.learn(x, 12, iters=6)
    got = t_aqbc.learn(torch.from_numpy(x), 12, iters=6,
                       init_rotation=_init_rotation(24, 12))
    np.testing.assert_allclose(got.rotation.numpy(),
                               np.asarray(want.rotation), atol=1e-4)
    np.testing.assert_allclose(got.objective_trace.numpy(),
                               np.asarray(want.objective_trace), atol=1e-5)
    codes_r = np.asarray(r_aqbc.encode(jnp.asarray(x), want.rotation))
    codes_t = t_aqbc.encode(torch.from_numpy(x), got.rotation).numpy()
    x_hat = x / np.linalg.norm(x, axis=1, keepdims=True)
    margin = _margin_rows(x_hat @ np.asarray(want.rotation))
    np.testing.assert_array_equal(codes_t[~margin], codes_r[~margin])
    # the default initial rotation is seeded and orthonormal
    own = t_aqbc.learn(torch.from_numpy(x), 12, iters=1)
    again = t_aqbc.learn(torch.from_numpy(x), 12, iters=1)
    assert torch.equal(own.rotation, again.rotation)
    np.testing.assert_allclose((own.rotation.T @ own.rotation).numpy(),
                               np.eye(12), atol=1e-5)


# ----------------------------------------------------------------- service
@pytest.fixture(scope="module")
def setup():
    r_cfg = r_get_tiny("gemma_2b").replace(compute_dtype="float32")
    t_cfg = get_tiny("gemma_2b").replace(compute_dtype="float32")
    r_params = RModel(r_cfg).init_params(jax.random.key(0))
    t_params = params_from_reference(jax.tree.map(np.asarray, r_params),
                                     device="cpu")
    rng = np.random.default_rng(0)
    docs = rng.integers(1, r_cfg.vocab_size, (60, 24)).astype(np.int32)
    queries = np.concatenate(
        [docs[:6], rng.integers(1, r_cfg.vocab_size, (6, 24))
         .astype(np.int32)])
    ref = RService(r_cfg, r_params,
                   RConfig(code_bits=BITS, aqbc_iters=5, m_tables=4))
    ref.build_index(docs)
    return {"t_cfg": t_cfg, "t_params": t_params, "docs": docs,
            "queries": queries, "ref": ref,
            "init": _init_rotation(r_cfg.d_model, BITS)}


# port service options -> the reference engine it is held against
BACKENDS = {
    "amih-host-numpy": (
        dict(backend="amih", m_tables=4, probe_backend="host",
             verify_backend="numpy"),
        ("amih", dict(m=4, verify_backend="numpy"))),
    "amih-device-walk": (
        dict(backend="amih", m_tables=4),
        ("amih", dict(m=4, verify_backend="numpy"))),
    # the reference's "pallas" scan is the counterpart of the port's
    # "cuda" one: both keep the lowest ids of a tie group at the k-th
    # place, where the numpy scan's argpartition keeps any of them
    "linear-scan-cuda": (
        dict(backend="linear_scan"),
        ("linear_scan", dict(compute_backend="pallas"))),
    "single-table": (
        dict(backend="single_table"),
        ("single_table", {})),
    "sharded-scan": (
        dict(backend="sharded_scan", num_shards=3),
        ("sharded_scan", dict(num_shards=3))),
    "sharded-amih-device-walk": (
        dict(backend="sharded_amih", num_shards=3, m_tables=4),
        ("sharded_amih", dict(num_shards=3, m=4, probe_backend="device"))),
    # pipelined: the verify overlap on the host walk, and the shard-probe
    # pool (standing down on this tiny corpus: the sequential chain)
    "amih-host-pipelined": (
        dict(backend="amih", m_tables=4, probe_backend="host",
             pipelined=True),
        ("amih", dict(m=4, verify_backend="pallas"))),
    "sharded-amih-host-pipelined": (
        dict(backend="sharded_amih", num_shards=3, m_tables=4,
             probe_backend="host", verify_backend="numpy", pipelined=True),
        ("sharded_amih", dict(num_shards=3, m=4))),
    # the cross-host tier: two spawned port workers (3 shards over 2
    # hosts), bit-identical to sharded AMIH over the same plan
    "cluster-sharded-amih": (
        dict(backend="sharded_amih", cluster=True, num_shards=3,
             m_tables=4),
        ("sharded_amih", dict(num_shards=3, m=4))),
}


def _closed(svc):
    """Close a service, and check that no worker process it spawned is
    left."""
    fleet = getattr(svc.engine, "_fleet", None)
    svc.close()
    assert fleet is None or not any(pr.is_alive() for pr in fleet.procs)


def _service(setup, **options):
    svc = RetrievalService(
        setup["t_cfg"], setup["t_params"],
        RetrievalConfig(code_bits=BITS, aqbc_iters=5, device="cpu",
                        **options))
    svc.build_index(setup["docs"], aqbc_init=setup["init"])
    return svc


def _eq(a, b):
    assert np.array_equal(a, b) and np.asarray(a).dtype == \
        np.asarray(b).dtype


def test_service_codes_match_reference(setup):
    """Document and query codes equal the reference service's outside the
    AQBC margin."""
    ref = setup["ref"]
    svc = _service(setup, m_tables=4, probe_backend="host",
                   verify_backend="numpy")
    x = ref._shifted(ref.embed(setup["docs"]), fit=False)
    x_hat = x / np.linalg.norm(x, axis=1, keepdims=True)
    margin = _margin_rows(x_hat @ np.asarray(ref.rotation))
    same = (svc.db_words == ref.db_words).all(axis=1)
    assert same[~margin].all(), np.flatnonzero(~same)
    np.testing.assert_allclose(svc.shift, ref.shift, atol=1e-5)
    qx = ref._shifted(ref.embed(setup["queries"]), fit=False)
    q_hat = qx / np.linalg.norm(qx, axis=1, keepdims=True)
    q_margin = _margin_rows(q_hat @ np.asarray(ref.rotation))
    q_same = (svc.encode_query(setup["queries"])
              == ref.encode_query(setup["queries"])).all(axis=1)
    assert q_same[~q_margin].all()
    if not margin.any() and not q_margin.any():
        # no row near the margin: the two services answer alike end to end
        for got, want in zip(svc.search_batch(setup["queries"], 5)[:2],
                             ref.search_batch(setup["queries"], 5)[:2]):
            _eq(got, want)


@pytest.mark.parametrize("name", sorted(BACKENDS))
def test_service_search_bit_identical_on_same_codes(setup, name, request):
    options, (r_backend, r_cfg) = BACKENDS[name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")    # spawned workers inherit it
        svc = _service(setup, **options)
    request.addfinalizer(lambda: _closed(svc))
    r_eng = r_make(r_backend, svc.db_words, BITS, **r_cfg)
    qs = setup["queries"]
    qc = svc.encode_query(qs)
    want_ids, want_sims, _ = r_eng.knn_batch(qc, 5)
    ids, sims, stats = svc.search_batch(qs, 5)
    _eq(ids, want_ids)
    _eq(sims, want_sims)
    assert stats.queries == len(qs)
    i1, s1, st1 = svc.search(qs[3], 5)
    _eq(i1, want_ids[3])
    _eq(s1, want_sims[3])
    assert st1 is not None
    # the queued loop, drained at once and streamed
    tickets = [svc.submit(q) for q in qs]
    out = svc.run_queued(k=5)
    assert set(out) == {int(t) for t in tickets}
    for row, t in enumerate(tickets):
        _eq(out[t][0], want_ids[row])
        _eq(out[t][1], want_sims[row])
        _eq(t.result(timeout=5)[0], want_ids[row])
    tickets = [svc.submit(q) for q in qs]
    steps = list(svc.run_queued(k=5, stream=True))
    assert len(steps) == 1 and steps[0].stats.queue_depth == 0
    for row, t in enumerate(tickets):
        got_ids, got_sims = t.result(timeout=5)
        _eq(got_ids, want_ids[row])
        _eq(got_sims, want_sims[row])
    lin_ids, lin_sims = svc.search_linear(qs[7], 5)
    want_lin = r_linear_scan_knn(qc[7], svc.db_words, 5)
    _eq(lin_ids, want_lin[0])
    _eq(lin_sims, want_lin[1])


def test_streaming_steps_queue_depth_and_thread_safe_submit(setup):
    import threading

    svc = _service(setup, m_tables=4, search_batch_size=4)
    docs = setup["docs"]
    tickets, lock = [], threading.Lock()

    def submitter(lo):
        for qi in range(lo, lo + 5):
            t = svc.submit(docs[qi])
            with lock:
                tickets.append(t)

    threads = [threading.Thread(target=submitter, args=(lo,))
               for lo in (0, 5, 10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert svc.queue_depth() == 15
    assert sorted(int(t) for t in tickets) == list(range(15))
    steps = list(svc.run_queued(k=3, stream=True))
    assert svc.queue_depth() == 0
    assert [s.step for s in steps] == [0, 1, 2, 3]
    assert [s.stats.queue_depth for s in steps] == [11, 7, 3, 0]
    for s in steps:
        assert {"p50", "p99"} <= set(s.stats.latency_ms)
    want_ids, want_sims, _ = svc.search_batch(docs[:15], 3)
    for t in tickets:
        ids, sims = t.result(timeout=5)
        _eq(ids, want_ids[int(t)])
        _eq(sims, want_sims[int(t)])


def test_failed_drain_fails_tickets_and_requeues(setup):
    """As the reference's test of the same name: a drain that raises
    mid-stream re-queues the unanswered queries and fails their current
    futures; a retry resolves the replacements; an abandoned stream
    re-queues with futures left pending."""
    svc = _service(setup, m_tables=4, search_batch_size=2)
    docs = setup["docs"]
    tickets = [svc.submit(docs[qi]) for qi in range(4)]
    real_knn = svc.engine.knn_batch
    calls = {"n": 0}

    def flaky(q, k):
        calls["n"] += 1
        if calls["n"] == 2:            # second batch step dies
            raise RuntimeError("device fell over")
        return real_knn(q, k)

    svc.engine.knn_batch = flaky
    pre_futures = [t.future for t in tickets]
    with pytest.raises(RuntimeError, match="device fell over"):
        for _ in svc.run_queued(k=3, stream=True):
            pass
    assert pre_futures[0].done() and pre_futures[1].done()
    assert svc.queue_depth() == 2
    for f in pre_futures[2:]:
        with pytest.raises(RuntimeError, match="device fell over"):
            f.result(timeout=1)
    svc.engine.knn_batch = real_knn
    out = svc.run_queued(k=3)
    assert set(out) == {2, 3}
    for t in tickets[2:]:
        assert t.result(timeout=5)[0].shape == (3,)
    t5, t6, t7 = (svc.submit(docs[qi]) for qi in (5, 6, 7))
    for _ in svc.run_queued(k=3, stream=True):
        break                              # the consumer walks away
    assert svc.queue_depth() == 1
    assert t5.future.done() and not t7.future.done()
    svc.run_queued(k=3)
    assert t7.result(timeout=5)[0].shape == (3,)
    svc.close()
    svc.close()


def test_trace_installs_the_port_tracer(setup):
    prev = t_trace.current()
    try:
        svc = _service(setup, m_tables=4, trace=True)
        assert svc.engine.tracer is t_trace.current()
        assert svc.engine.tracer.enabled
        svc.search_batch(setup["queries"][:2], 3)
        names = {s["name"] for s in svc.engine.tracer.drain()}
        assert "engine.knn_batch" in names
    finally:
        t_trace.set_tracer(prev)


def test_layers_not_ported_raise_and_default_is_the_card(setup,
                                                         monkeypatch):
    """Nothing is refused any more: ``cluster=True`` (slice 9),
    ``pipelined=True`` and the backends ported since build and serve."""
    for options in (dict(cluster=True, hosts=2, m_tables=4),
                    dict(cluster=True, backend="sharded_scan", num_shards=2),
                    dict(pipelined=True, probe_backend="host"),
                    dict(backend="single_table"),
                    dict(backend="sharded_amih", m_tables=4, num_shards=2),
                    dict(backend="sharded_scan", num_shards=2)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("OMP_NUM_THREADS", "1")
            svc = _service(setup, **options)
        ids, sims, _ = svc.search_batch(setup["queries"][:2], 3)
        assert ids.shape == sims.shape == (2, 3)
        if options.get("cluster"):
            assert svc.engine.name == "cluster"
            assert len(svc.search_batch(setup["queries"][:2], 3)[2]
                       .per_host) == 2
        _closed(svc)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = RetrievalService(setup["t_cfg"], setup["t_params"],
                           RetrievalConfig(code_bits=BITS))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.build_index(setup["docs"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(setup["t_cfg"]).init_params(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_reference({"w": np.zeros(2, np.float32)})
