"""Token serving in the port (``repro_torch.data.pipeline``,
``models.layers.decode_attention``, ``models.lm`` prefill and decode,
``serve.engine.ServeEngine``, ``launch.serve``) against the JAX reference
on the same inputs: numpy seeds, the reference's random init of the tiny
gemma in float32 carried across with ``params_from_reference``, and its
decode cache with ``cache_from_reference``.

Tolerances: 1e-5 for logits and cache leaves (float32, the same
operations on the same weights; the sums differ in order only), 2e-5 for
decode attention (two online softmaxes, the bound of
``tests/test_torch_models.py``). The token pipeline is held bit for bit,
and the engines' tokens and stats by equality: greedy tokens up to the
first step whose reference top-2 logit margin is below 10x the logit
tolerance (a tie, named by the test, not a fault).
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as r_data
import repro.models as r_models
import repro.serve as r_serve
from repro.configs import get_tiny as r_get_tiny
from repro.data import DataConfig as RDataConfig
from repro.data import TokenPipeline as RTokenPipeline
from repro.models import Model as RModel
from repro.models import layers as r_layers
from repro.models import lm as r_lm

import repro_torch.data as t_data
import repro_torch.models as t_models
import repro_torch.serve as t_serve
from repro_torch.configs import get_tiny
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import Model
from repro_torch.models import layers as t_layers
from repro_torch.models import lm as t_lm
from repro_torch.serve import ServeConfig, ServeEngine

t_fa = importlib.import_module("repro_torch.kernels.flash_attention")

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
ATTN_TOL = 2e-5
TIE = 10 * TOL


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ------------------------------------------------------------ the pipeline
@pytest.mark.parametrize("seed,shard_id,num_shards,step", [
    (0, 0, 1, 0), (0, 1, 2, 3), (7, 3, 4, 5), (123, 0, 8, 11)])
def test_token_pipeline_bit_equal_to_reference(seed, shard_id, num_shards,
                                               step):
    kw = dict(vocab_size=1000, seq_len=40, global_batch=8, seed=seed)
    t = TokenPipeline(DataConfig(**kw), shard_id, num_shards, start_step=step)
    r = RTokenPipeline(RDataConfig(**kw), shard_id, num_shards,
                       start_step=step)
    for _ in range(2):
        a, b = t.next_batch()["tokens"], r.next_batch()["tokens"]
        assert a.dtype == b.dtype == np.int32
        assert np.array_equal(a, b)
    assert t.state_dict() == r.state_dict()
    # the checkpoint round trip, across the packages and a reshard
    t2 = TokenPipeline(DataConfig(**kw), 0, 1)
    t2.load_state_dict(r.state_dict())
    r2 = RTokenPipeline(RDataConfig(**kw), 0, 1)
    r2.load_state_dict(t.state_dict())
    assert np.array_equal(t2.next_batch()["tokens"],
                          r2.next_batch()["tokens"])
    assert np.array_equal(t.global_batch_at(step)["tokens"],
                          r.global_batch_at(step)["tokens"])
    with pytest.raises(ValueError, match="seed mismatch"):
        t.load_state_dict(dict(t.state_dict(), seed=seed + 1))


def test_pipeline_errors_and_features_match_reference():
    for pipe in (TokenPipeline, RTokenPipeline):
        cfg = (DataConfig if pipe is TokenPipeline else RDataConfig)(
            vocab_size=50, seq_len=8, global_batch=6)
        with pytest.raises(ValueError, match="not divisible"):
            pipe(cfg, 0, 4)
    # motif rows: a seq_len below 2 * motif_len keeps the unigram draws
    kw = dict(vocab_size=300, seq_len=20, global_batch=4, seed=5)
    assert np.array_equal(TokenPipeline(DataConfig(**kw)).next_batch()
                          ["tokens"],
                          RTokenPipeline(RDataConfig(**kw)).next_batch()
                          ["tokens"])
    for args in ((50, 16, 4, 0), (300, 128, 64, 9)):
        assert np.array_equal(t_data.clustered_features(*args),
                              r_data.clustered_features(*args))


def test_exports_hold_the_reference_names():
    assert set(r_data.__all__) <= set(t_data.__all__)
    assert set(t_data.__all__) - set(r_data.__all__) == {
        "synthetic_binary_codes_packed", "synthetic_queries_packed"}
    assert set(t_serve.__all__) == set(r_serve.__all__)
    assert set(t_models.__all__) <= set(r_models.__all__)
    for mod in (t_data, t_serve, t_models):
        for name in mod.__all__:
            assert getattr(mod, name) is not None


# ----------------------------------------------------------- decode attn
@pytest.mark.parametrize("valid_len", [1, 37, 96])
@pytest.mark.parametrize("window", [0, 24])
def test_decode_attention_matches_reference(valid_len, window):
    rng = np.random.default_rng(valid_len + window)
    q = rng.normal(size=(3, 1, 8, 32)).astype(np.float32)
    k = rng.normal(size=(3, 96, 2, 32)).astype(np.float32)
    v = rng.normal(size=(3, 96, 2, 32)).astype(np.float32)
    want = r_layers._decode_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(valid_len),
        window=window)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = t_fa.LAUNCHES["flash_attention"]
    got = t_layers.decode_attention(tq, tk, tv, valid_len, window=window)
    assert t_fa.LAUNCHES["flash_attention"] == before   # plain on the CPU
    _close(got, want, ATTN_TOL)
    assert torch.equal(got, t_fa.flash_attention_plain(
        tq, tk, tv, causal=False, window=window, valid_len=valid_len))
    _close(t_layers._decode_attention_impl(tq, tk, tv, valid_len,
                                           window=window), want, ATTN_TOL)
    # the ring buffer (ported): K7 over the slots below the count, the
    # window ignored, as the reference's ring branch has it
    want = r_layers._decode_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(valid_len),
        window=window, ring=True)
    _close(t_layers.decode_attention(tq, tk, tv, valid_len, window=window,
                                     ring=True), want, ATTN_TOL)
    _close(t_layers._decode_attention_impl(tq, tk, tv, valid_len,
                                           window=window, ring=True), want,
           ATTN_TOL)


# ------------------------------------------------------ prefill and decode
@pytest.fixture(scope="module")
def tiny():
    r_cfg = r_get_tiny("gemma_2b").replace(compute_dtype="float32")
    t_cfg = get_tiny("gemma_2b").replace(compute_dtype="float32")
    r_params = RModel(r_cfg).init_params(jax.random.key(0))
    t_params = params_from_reference(jax.tree.map(np.asarray, r_params),
                                     device="cpu")
    return r_cfg, t_cfg, r_params, t_params


def _leaves(cache):
    a = cache["layers"].attn
    return {"k": a.k, "v": a.v}


def test_prefill_and_forward_match_reference(tiny):
    r_cfg, t_cfg, r_params, t_params = tiny
    toks = np.random.default_rng(1).integers(
        1, r_cfg.vocab_size, (2, 13)).astype(np.int32)
    r_logits, r_cache = r_lm.prefill(r_cfg, r_params,
                                     {"tokens": jnp.asarray(toks)})
    t_logits, t_cache = Model(t_cfg).prefill(t_params, {"tokens": toks},
                                             device="cpu")
    assert t_logits.shape == (2, r_cfg.vocab_size)
    assert t_logits.dtype == torch.float32
    _close(t_logits, r_logits)
    assert r_cache["layers"].ssm is None and t_cache["layers"].ssm is None
    for name, leaf in _leaves(t_cache).items():
        want = _leaves(r_cache)[name]
        assert tuple(leaf.shape) == want.shape == (2, 2, 13, 1, 32)
        _close(leaf, want)
    # the scoring forward: the prefill's logits are its last position
    r_full, _ = RModel(r_cfg).forward(r_params, {"tokens": jnp.asarray(toks)})
    t_full, aux = Model(t_cfg).forward(t_params, {"tokens": toks},
                                       device="cpu")
    assert aux == {}
    _close(t_full, r_full)
    _close(t_full[:, -1], t_logits)


def test_cache_template_and_init_match_reference(tiny):
    r_cfg, t_cfg, _, t_params = tiny
    r_tpl = RModel(r_cfg).cache_template(3, 20)
    t_tpl = Model(t_cfg).cache_template(3, 20)
    for name, leaf in _leaves(t_tpl).items():
        want = _leaves(r_tpl)[name]
        assert leaf.device.type == "meta"       # nothing allocated
        assert tuple(leaf.shape) == want.shape == (2, 3, 20, 1, 32)
        assert leaf.dtype == torch.float32
    cache = Model(t_cfg).init_cache(3, 20, device="cpu")
    assert all(not bool(t.any()) for t in _leaves(cache).values())
    bf = get_tiny("gemma_2b")                    # bf16 compute
    assert Model(bf).cache_template(1, 4)["layers"].attn.k.dtype == \
        torch.bfloat16
    # the hybrid's cache (ported): a ring of min(max_seq, window) slots
    # beside the SSM state, as the reference's; the vlm's (ported) too
    hyb = dict(family="hybrid", ssm_state=8, ssm_heads=4, ssm_head_dim=16,
               sliding_window=16)
    assert [tuple(t.shape) for t in jax.tree.leaves(t_lm.cache_template(
        t_cfg.replace(**hyb), 1, 20), is_leaf=torch.is_tensor)] == [
        s.shape for s in jax.tree.leaves(r_lm.cache_template(
            r_cfg.replace(**hyb), 1, 20))]
    assert t_lm.cache_template(t_cfg.replace(**hyb), 1, 20)[
        "layers"].attn.k.shape[2] == 16
    assert [tuple(t.shape) for t in jax.tree.leaves(t_lm.cache_template(
        t_cfg.replace(family="vlm"), 1, 8), is_leaf=torch.is_tensor)] == [
        s.shape for s in jax.tree.leaves(r_lm.cache_template(
            r_cfg.replace(family="vlm"), 1, 8))]
    # a vlm prefill: the patch embeddings through the adapter in front of
    # the prompt, in the cache as in the reference's
    vlm = dict(family="vlm", vision_tokens=4)
    r_vlm = RModel(r_cfg.replace(**vlm))
    r_params = r_vlm.init_params(jax.random.key(3))
    batch = {"tokens": np.ones((1, 3), np.int32),
             "vision_embeds": np.random.default_rng(3).normal(
                 size=(1, 4, r_cfg.d_model)).astype(np.float32)}
    t_logits, t_cache = Model(t_cfg.replace(**vlm)).prefill(
        params_from_reference(jax.tree.map(np.asarray, r_params),
                              device="cpu"), batch, device="cpu")
    r_logits, r_cache = r_vlm.prefill(
        r_params, {k: jnp.asarray(v) for k, v in batch.items()})
    _close(t_logits, r_logits)
    assert t_cache["layers"].attn.k.shape == r_cache["layers"].attn.k.shape \
        == (2, 1, 7, 1, 32)
    _close(t_cache["layers"].attn.k, r_cache["layers"].attn.k)
    with pytest.raises(ValueError, match="unknown family"):
        t_lm.cache_template(t_cfg.replace(family="vision"), 1, 8)
    # the ssm family's cache (ported) has the reference's leaves
    ssm = get_tiny("mamba2_1_3b").replace(compute_dtype="float32")
    r_ssm_tpl = RModel(r_get_tiny("mamba2_1_3b").replace(
        compute_dtype="float32")).cache_template(3, 20)
    t_ssm_tpl = Model(ssm).cache_template(3, 20)
    assert t_ssm_tpl["layers"].attn is None
    assert [(tuple(t.shape), t.dtype) for t in t_ssm_tpl["layers"].ssm] == [
        (s.shape, torch.float32) for s in r_ssm_tpl["layers"].ssm]


def test_decode_steps_match_reference(tiny):
    """Several decode steps from the same padded prefill cache: logits and
    every cache leaf, the next token each step chosen by the reference."""
    r_cfg, t_cfg, r_params, t_params = tiny
    rng = np.random.default_rng(2)
    toks = rng.integers(1, r_cfg.vocab_size, (2, 9)).astype(np.int32)
    _, pre = r_lm.prefill(r_cfg, r_params, {"tokens": jnp.asarray(toks)})
    r_cache = jax.tree.map(lambda full, part: full.at[:, :, :9].set(part),
                           r_lm.init_cache(r_cfg, 2, 16), pre)
    t_cache = cache_from_reference(jax.tree.map(np.asarray, r_cache),
                                   device="cpu")
    tok = rng.integers(1, r_cfg.vocab_size, (2, 1)).astype(np.int32)
    model = Model(t_cfg)
    for pos in (9, 10, 11, 12):
        r_logits, r_cache = r_lm.decode_step(r_cfg, r_params, r_cache,
                                             jnp.asarray(tok), jnp.int32(pos))
        t_logits, t_cache2 = model.decode_step(t_params, t_cache, tok, pos,
                                               device="cpu")
        assert t_cache2 is t_cache                # written in place
        _close(t_logits, r_logits)
        for name, leaf in _leaves(t_cache).items():
            _close(leaf, _leaves(r_cache)[name])
        tok = np.asarray(r_logits).argmax(-1)[:, None].astype(np.int32)


def test_cache_from_reference_takes_bf16_leaves():
    r_cfg = r_get_tiny("gemma_2b")
    cache = r_lm.init_cache(r_cfg, 1, 4)
    cache = jax.tree.map(lambda a: a + jnp.asarray(1.5, a.dtype), cache)
    got = cache_from_reference(jax.tree.map(np.asarray, cache), device="cpu")
    k = got["layers"].attn.k
    assert k.dtype == torch.bfloat16 and bool((k == 1.5).all())


# ------------------------------------------------------------ the engines
PROMPT_LENS = (5, 9, 13, 5, 9, 13, 5)


def _serve(engine_cls, config_cls, cfg, params, greedy, **kw):
    """Serve PROMPT_LENS' prompts through 3 slots; returns the engine, the
    results and, per request, the top-2 logit margin of every token
    choice in order."""
    rng = np.random.default_rng(4)
    eng = engine_cls(cfg, params, config_cls(
        max_batch=3, max_seq=32, max_new_tokens=6, greedy=greedy, seed=3,
        **kw))
    margins = {}
    choose = eng._select_token

    def recorded(logits_row, slot):
        row = np.sort(np.asarray(logits_row).reshape(-1))
        margins.setdefault(eng.slot_req[slot].rid, []).append(
            float(row[-1] - row[-2]))
        return choose(logits_row, slot)

    eng._select_token = recorded
    for n in PROMPT_LENS:
        eng.submit(rng.integers(1, cfg.vocab_size, n))
    return eng, eng.run_until_drained(), margins


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_serve_engine_matches_reference(tiny, greedy):
    r_cfg, t_cfg, r_params, t_params = tiny
    r_eng, want, margins = _serve(r_serve.ServeEngine, r_serve.ServeConfig,
                                  r_cfg, r_params, greedy)
    t_eng, got, _ = _serve(ServeEngine, ServeConfig, t_cfg, t_params, greedy,
                           device="cpu")
    assert t_eng.stats == r_eng.stats
    assert t_eng.stats["prefills"] == len(PROMPT_LENS)
    assert sorted(got) == sorted(want) == list(range(len(PROMPT_LENS)))
    ties = {}
    for rid, toks in want.items():
        tie = next((j for j, m in enumerate(margins[rid]) if m < TIE), None)
        if greedy and tie is not None:
            ties[rid] = tie
            assert got[rid][:tie] == toks[:tie], (rid, tie)
        else:
            assert got[rid] == toks, rid
    if ties:
        print(f"greedy tokens compared up to a tie (margin < {TIE}): "
              f"request: step {ties}")
    else:                 # the slots' caches at the end, masked rows too
        for name, leaf in _leaves(t_eng.cache).items():
            _close(leaf, _leaves(r_eng.cache)[name])


def test_engine_refuses_parameters_elsewhere_and_long_prompts(tiny):
    _, t_cfg, _, t_params = tiny
    meta = {k: v for k, v in t_params.items()}
    meta["final_norm"] = {"scale": t_params["final_norm"]["scale"].to("meta")}
    with pytest.raises(ValueError, match="final_norm/scale lies on meta"):
        ServeEngine(t_cfg, meta, ServeConfig(device="cpu"))
    eng = ServeEngine(t_cfg, t_params, ServeConfig(max_seq=16, device="cpu"))
    eng.submit(np.arange(1, 10), max_new_tokens=8)
    with pytest.raises(ValueError, match="prompt too long"):
        eng.run_until_drained()


def test_default_placement_needs_a_cuda_device(tiny, monkeypatch):
    _, t_cfg, _, t_params = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Model(t_cfg)
    toks = np.ones((1, 4), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(t_cfg, t_params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.prefill(t_params, {"tokens": toks})
    cache = model.init_cache(1, 8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.decode_step(t_params, cache, toks[:, :1], 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)


# ---------------------------------------------------------------- the CLI
def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma_2b", "--tiny", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)


@pytest.mark.parametrize("mode,expect", [
    ("generate", "served 6 requests / 36 tokens"),
    ("retrieval", "indexed 40 docs"),
])
def test_serve_cli_runs_on_the_cpu(mode, expect):
    out = _cli("--mode", mode, "--device", "cpu", "--requests", "6",
               "--max-new-tokens", "6", "--max-batch", "2", "--max-seq", "32",
               "--docs", "40", "--queries", "2")
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout
    if mode == "retrieval":
        assert out.stdout.count("(exact vs scan: OK)") == 2


def test_serve_cli_without_a_device_names_the_missing_card():
    out = _cli("--requests", "1")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
