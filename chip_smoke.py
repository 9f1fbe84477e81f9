#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card; builds the kernels

It imports nothing of JAX and nothing of the reference package. Phases,
each of which fails the run (non-zero exit) on any error or mismatch:

1. the card (``nvidia-smi``), torch and nvcc versions; the seven kernels
   built from ``src/repro_torch/kernels/csrc`` (one nvcc per source, all in
   parallel), with each build's register report; K7's registers, shared
   memory and spill bytes per instantiation, and its HGMMA instructions
   (``cuobjdump -sass``): a bf16 instantiation that spills, or a library
   without HGMMA, fails the run;
2. each kernel against its plain PyTorch version on the card, by equality:
   K1 (grouped verify) at p in {64, 128}, B = 64, C = 2048 with ragged
   lengths that include 0, and at every code width (W = 1 to 8 and 10)
   and the edge shapes of ``K1_EDGE``; K2 (probing walk) and K3 (scan) on the operands
   the main path hands them at n = 2^18 clustered codes, B = 64 mixed z:
   the batched walk (G > 1) and the per-group walk (G = 1), each in both
   forms (cooperative grid, one thread-block cluster) with check_every in
   {1, 3}, touched lists as sets, and the touched-list extraction after
   each against the plain extraction of the plain walk's whole map (the
   kernel's map all POS_INF after it); the fused scan (cross-group and
   per group, timed at G = 1) and the map-writing scan on the same
   operands, and the map route above k = 1024 (``probe_stream_cap`` 256
   sends queries to the scans); K4 (linear-scan
   scores, and the fused score-and-top-k at k in {32, 128} and at B = 1,
   k = 1024, also over a database of five distinct codes), K5 (block
   maxima) and K6 (one-query tuples) at n = 2^18 (a ragged last tile),
   p in {64, 128}, B = 64 with a zero-norm query and an all-zero code,
   bit for bit, and K5 at every code width (W = 1 to 8) and the edge
   shapes of ``K5_EDGE`` (B = 1, ragged query tiles, blk from 1 to past
   n, codes off their 16-byte boundary); K7 (flash attention) on ``FLASH_CASES`` (G = 1 to 8, 3,
   5, 7 and 96, ragged tiles, windows, decode rows, llava's prefill and
   decode operands at G = 7 and 8, head dims 16 to 512 with
   16, 20, 48, 112, 320 and 512 between and above the kernel's widths) in
   float32 and bf16 against its
   plain version in float32 (float32 within 2e-5, bf16 within
   4e-3 * max(1, |plain|)); the reference's kernel API (ROADMAP C-P4):
   ``repro_torch.kernels.verify_tuples_grouped`` on a padded (B, C, W)
   block, ``ops.verify_tuples_grouped_op``, ``ops.device_probe_scan_launch``
   and ``ops.device_probe_scan_multi_launch`` on the phase's index, each
   equal to the same call on CPU copies;
3. the two exact paths at full size: n = 10,000,000 clustered codes
   (n_clusters = 256, flip_prob = 0.08), queries from
   ``synthetic_queries_packed`` (flip_prob = 0.05), p in {64, 128},
   B in {1, 64}, K in {10, 100}, median of 5 warm batches per case, 8
   queries per case against the exact float64 linear scan.
   a. AMIH, through ``make_engine("amih", ...)`` (the device walk, m = 4
      and 8), query cache off. Per case: one walk launch and at most one
      scan launch per batch; bailed queries and K2's iterations per
      launch logged; results equal the same index with
      ``probe_fused=False``. One B = 64 batch at K = 2048, above the fused
      scan's cap, takes the map route for its bails. The host walk with the
      CUDA verify (K1)
      answers 4 queries per p and must equal the device path. One batch
      at p = 128, B in {64, 1}, runs under ``torch.profiler`` (card busy
      time, idle share, kernels by device time; Chrome traces in
      ``chiprun_out/``; a trace with no device time is taken again, and
      reported as empty if it stays so) and once more with the port's
      tracer on (host time by layer span).
   b. The linear scan, through ``make_engine("linear_scan", ...)`` (the
      CUDA backend: one fused K4 score-and-top-k call, a float64 host
      rerank). Per case: one fused call and no K4 score launch per batch;
      the checked rows bit-identical to the float64 scan's sims; every
      B = 64 row equal to AMIH's but for equal-cosine ties (ROADMAP C-R1);
      at B = 64 one batch allocates at most 1% of the (B, N) float32
      scores beyond what is resident. ``ops.scan_topk`` at k = 2048, above
      the fused kernel's cap, takes the chunked route (K4 scores per
      65,536 codes, a running top-K) and its first 1024 equal the fused
      kernel's. ``ops.scan_topk_pruned`` (K5, then the fused top-k on the
      surviving blocks) at B in {1, 64}, K = 10 equals ``ops.scan_topk``,
      and both are timed (ms/query, median of 5 warm batches, host clock
      to a synchronize) with its scanned_fraction;
      ``ops.verify_tuples_op``
      (K6) on one query against all n codes equals the host's tuples. One
      batch at p = 128, B in {64, 1}, runs under the profiler and the
      tracer.
   c. Retrieval serving, through ``RetrievalService`` with the gemma-2b
      encoder at full width (``get_config("gemma_2b")``: 18 layers,
      d_model 2048, 8 q heads of 256 over 1 kv head, d_ff 16384, vocab
      256,000; random weights from a seeded generator, float32 parameters,
      bf16 compute), ``RetrievalConfig(code_bits=64, batch_size=32,
      search_batch_size=64)``, AMIH through the device walk, over 8,192
      topic-structured documents of 128 tokens (256 topics of 512 token
      ids, seed 0; each document draws from one topic). Queries: 64
      held-out documents and 32 corpus documents as self-queries. It
      prints the distinct codes and the build times (encode, AQBC, index),
      ms/query at B in {64, 1}, K = 10 (median of 5 warm batches, encoding
      included), and profiles one encoder batch (K7 time against the
      GEMMs'). Checks: the B = 64 and B = 1 rows equal the float64 linear
      scan over the service's codes but for equal-cosine ties; every
      self-query tops at its own code; two ``run_queued(stream=True)``
      steps equal ``search_batch``; ``backend="linear_scan"`` on the same
      codes equals AMIH but for ties; one batch's pooled embeddings through
      K7 lie within one bf16 step of the largest of them from the same
      forward through K7's plain version; K7 launched layers x encoder
      batches times.
   d. The shard and pipeline layers on the codes of a (``shard_path``).
      At both p the host walk's 4 queries with the verify overlap (K1 on
      a side CUDA stream) equal a's sequential host walk bit for bit, with
      the same K1 launch count. At p = 64 ``make_engine("single_table",
      ...)`` (host code; enumeration cap 2^20, past which a query takes
      the exact host scan) answers 8 queries at K = 10, equal to the
      float64 scan but for equal-cosine ties. At p = 128, 8 shards all on
      the one card: ``sharded_amih`` with the device walk at B in {64, 1},
      K in {10, 100} (one K2 launch and one extraction per batch over the
      card's super index; float64 sims bit-identical to a's AMIH as a
      multiset, ids equal but for ties); ``sharded_scan`` (8 fused K4
      calls per batch; ids and sims bit-identical to the linear scan);
      ``sharded_amih`` on the host walk with the CUDA verify (the
      thread-mode shard pool equal to its sequential chain). Each prints
      ms/query. Shards over several cards need several cards.
   e. The cluster tier on the codes of a at p = 128 (``cluster_path``):
      ``make_engine("cluster", db, 128, hosts=2, num_shards=8,
      probe_backend="device")`` spawns a local fleet of two port worker
      processes, both on the card (each opens its own context), and ships
      each its half of the codes (4 shards). Inner ``sharded_amih`` at
      B in {64, 1}, K in {10, 100}: float64 sims bit-identical to a's
      AMIH on the same queries as a multiset, ids equal but for ties, and
      ids and sims bit-identical to d's in-process ``sharded_amih`` over
      the same plan; the 8 checked queries of the B = 64 batch equal to
      the float64 scan as in a. Inner ``sharded_scan`` (a second fleet)
      at B = 64, K = 10: bit-identical to d's. Each case prints ms/query,
      the median of 5 warm batches, and the build seconds. The workers'
      launch counters live in their own processes, so one B = 64 batch
      runs traced: among the worker spans the coordinator ingests, each
      host's lane must hold exactly one K2 launch span on the card.
      ``python -m repro_torch.obs.smoke`` then runs on the card (its
      workers on the host walk with K1), its trace goes beside the
      profiler's traces, ``python -m repro_torch.obs.report --min-hosts 2
      --min-stages 4`` must accept it, and both worker lanes must hold
      launch spans on the card. No child process may be left.
   f. Token serving, through ``ServeEngine`` with gemma-2b at full width
      (c's config, parameters drawn again from seed 0 on the card after c
      freed its own), ``ServeConfig(max_batch=8, max_seq=256,
      max_new_tokens=32)``: 16 greedy requests whose prompts are the first
      16 of c's documents cut to 16–128 tokens (seed 1), so that the
      lagging-group step and slot refills both run. Prefill runs K7
      causal, each decode step K7 with ``valid_len = pos + 1`` on the
      (8, 256, 1, 256) bf16 cache. It prints prefill ms by prompt length,
      the decode step's ms (median, and at the largest group), tokens/s,
      the decode steps and K7's launches, and profiles one engine decode
      step at B = 8 (K7, the GEMMs and the weight casts; Chrome trace in
      ``chiprun_out/``). Checks: K7 launched layers x (prefills + decode
      steps) times; for 2 requests every greedy token is the argmax of
      ``Model.forward``'s causal logits at its position wherever their
      top-2 margin exceeds ``TIE_TOL`` (4 x the largest gap between the
      decode and forward logits that the run measures, a gap itself at
      most 2^-4 of the largest logit), and so in float32 compute (the same
      2 requests through an engine on ``compute_dtype="float32"``, the gap
      at most 2^-10 of the largest logit); 4 requests served again one at a
      time (``max_batch=1``) give the batch's tokens up to the first step
      whose margin is within ``TIE_TOL``; ``python -m
      repro_torch.launch.serve --arch gemma_2b --tiny --requests 4`` exits
      0 on the card.
   g. Training (``train_path``): (a) K7's gradient (the autograd Function:
      K7 forward, the blocked recompute in float32 backward) at the
      training operand, q (8, 128, 8, 256), k and v (8, 128, 1, 256), bf16,
      causal, against plain autograd through K7's plain version in float32,
      within 4e-3 * max(1, |plain|), and K7 timed there beside its bound,
      SDPA and its plain version; (b) gemma-2b at full width and depth (c's
      config, parameters from seed 0 on the card with their AdamW state,
      40 GB), ``make_train_step`` with ``OptimConfig(peak_lr=3e-4,
      warmup_steps=1, decay_steps=8)``, remat "full", the full float32
      logits, 8 steps on ``TokenPipeline`` batches of 8 x 128 tokens
      (vocab 256,000): every loss finite, the mean of the last 3 below the
      first, K7 launched exactly 2 x 18 times a step (the forward and
      remat's recompute), the peak allocation under the card's memory; it
      prints the median step ms of steps 2-8, tokens/s, the model flops
      share (``mfu``: ``model_flops``, 6 x parameters x tokens, over the
      step at 989 TFLOP/s), one profiled step by kernel kind and by range
      (AdamW, the attention recompute, the loss; Chrome trace in
      ``chiprun_out/``), and the step with each stacked leaf indexed per
      layer against split once; (c) at the tiny gemma, the ``Trainer`` on
      the card (one injected failure recovered from the last checkpoint,
      giving up after ``max_restarts``, a resume from a checkpoint equal
      bit for bit to the uninterrupted run) and ``python -m
      repro_torch.launch.train --arch gemma_2b --tiny --steps 8``,
      checkpoints under a temporary directory.
   h. Token serving with llama3-8b at full width, 16 of its 32 layers
      (``LLAMA_SERVE_LAYERS``: the cut keeps the script near 600 s; d_model
      4096, 32 q heads over 8 kv heads of 128, d_ff 14336, SwiGLU, vocab
      128,256, untied ``unembed``; random float32 parameters from seed 0,
      bf16 compute), exactly as f: the same 16 requests'
      lengths and engine settings, the same checks (K7 launched 16 x
      (prefills + decode steps), the teacher-forced argmax, one at a time,
      the tiny CLI with ``--arch llama3_8b``) and the same prints, plus the
      phase's peak allocation.
   i. Training llama3-8b at full width, 8 of its 32 layers (2.80 B
      parameters; the depth is the cut), as g (b): 8 steps of 8 x 128
      tokens (vocab 128,256), remat "full": losses finite and falling, K7
      2 x 8 times a step, the median step, tokens/s, ``mfu`` and the peak;
      then ``python -m repro_torch.launch.train --arch llama3_8b --tiny``.
   j. granite-3-8b and granite-34b at full width, 4 layers each (1.20 B
      and 2.72 B parameters): one 96-token request through ``ServeEngine``
      (``max_batch=8, max_seq=256, max_new_tokens=9``), one prefill and 8
      decode steps, K7 launched 4 x 9 times, every token the causal
      forward's argmax but where its margin is within ``TIE_FACTOR`` x the
      measured gap, in bf16 and again in float32 compute, as f;
      granite-34b's 48 q heads share one kv head (G = 48).
   k. The four examples (``repro_torch.examples``) through their
      ``main()`` at their reference's defaults (train_embedder: its
      ~100M model, 30 of its 300 steps, checkpoints under a temporary
      directory), each success line checked, each example's launches and
      peak allocation printed; K2, the fused K4 and K7 must launch.
   l. whisper-tiny's encoder-decoder at full width and depth (4 encoder
      and 4 decoder layers, d_model 384, 6 heads of 64, d_ff 1536, vocab
      51,865, 1,500 frames), bf16 compute, float32 parameters drawn with
      numpy from seed 0 in the reference's tree and init rule and carried
      across with ``params_from_reference`` (``whisper_path``): a prefill
      of 8 prompts of 16 tokens over seeded frames (8, 1500, 384), then 32
      greedy decode steps, each token the teacher-forced forward's argmax
      where its top-2 margin exceeds ``TIE_FACTOR`` x the measured gap,
      in bf16 and again in float32 compute (gaps within ``GAP_BOUND`` and
      ``GAP_BOUND_F32`` of the largest logit); K7 launched (4 + 2 x 4) +
      32 x 2 x 4 times, on five kinds of operand: the encoder's 1,500-key
      non-causal self-attention, the decoder's causal self-attention, its
      cross-attention (16 queries against 1,500 keys), the decode step's
      self-attention and its cross-attention (``valid_len`` 1,500); then 8
      ``make_train_step`` steps of 8 x 128 tokens with their frames
      (remat "full" on the decoder: K7 4 + 2 x 2 x 4 times a step), losses
      finite and falling, ms a step, tokens/s and the peak.
   m. mamba2-1.3b at full width (d_model 2048, 64 SSM heads of 64, state
      128, vocab 50,280; float32 parameters from seed 0, bf16 compute; no
      attention, so no kernel): token serving exactly as f at 24 of its 48
      layers (``MAMBA_SERVE_LAYERS``, the cut as h's) (16 requests in 8 slots, ``max_seq`` 256, the
      teacher-forced, float32 and one-at-a-time checks, one profiled
      decode step, the tiny CLI), which holds the engine's masked restore
      of the SSM state; then ``python -m repro_torch.launch.train --arch
      mamba2_1_3b --steps 8`` through its ``main()`` (8 x 128 tokens,
      remat "full", its checkpoints every 2 steps under a temporary
      directory, their 17.4 GB of arrays each counted but not written:
      see ``mamba_train_path``): the summary line, losses finite and
      falling, ms a step from the trainer's history, tokens/s, ``mfu`` and
      the peak.
   n. hymba-1.5b at full width and depth (32 layers, d_model 1600, 25 q
      heads over 5 kv heads of 64 beside 25 SSM heads of 64 with state 16,
      d_ff 5504, vocab 32,001, sliding window 2,048; 1.39 B float32
      parameters from seed 0, bf16 compute): (a) token serving exactly as
      f at 16 of its 32 layers (``HYMBA_SERVE_LAYERS``, the cut as h's;
      the K/V cache a ring of min(256, 2,048) slots); (b) the ring set
      (``hymba_path``): 8 prompts of 2,000 tokens, 128 new tokens each,
      ``max_seq`` 2,176, so the ring of 2,048 slots wraps at the 48th
      step and K7 decodes with ``valid_len`` 2,048; every token the
      argmax of the teacher-forced forward over the 2,127 positions (K7
      with the window) where its margin exceeds ``TIE_FACTOR`` x the gap,
      in bf16 and in float32 compute; one profiled decode step on the
      wrapped ring (no tiny CLI in a process of its own, which f, h and m
      run); (c) ``make_train_step``: 8 steps of 8 x 128 tokens
      (as g (b)), then 2 of 2 x 4,096 (the window bites in K7's forward
      and in its gradient's recompute), losses finite and falling.
   o. The MoE family at full width, 2 layers each (the cut: depth and
      traffic; bf16 parameters drawn on the card from seed 0): arctic-480b
      (128 experts top-2 with the dense residual FFN, G = 7, D = 128;
      27.7 B parameters, 55.4 GB) and then kimi-k2 (its dense front layer
      and one MoE layer of 384 experts top-8 with the shared expert, G =
      8, D = 112, vocab 163,840; 19.6 B, 39.3 GB): ``ServeEngine`` with 8
      slots, 8 requests of 19-123 tokens, 16 new tokens each, K7 launched
      2 x (prefills + decode steps); 2 requests held against the causal
      forward (argmax and margin, bf16); one ``loss`` forward on 8 x 128
      tokens under ``no_grad`` (ce, ``moe_lb``, ``moe_rz``,
      ``dropped_fraction``); one profiled decode step against the bytes
      bound of every weight read once (C = T = 8 runs every expert).
      Training the MoE family at full width needs several cards.
   p. (run first, before a, while the card holds nothing else)
      llava-next-34b (the vlm family) at full width and depth (60 layers,
      d_model 7168, 56 q heads over 8 kv heads of 128, d_ff 20,480, vocab
      64,000, 576 vision tokens; 34.4 B bf16 parameters, 68.9 GB, drawn on
      the card from seed 0; ``llava_path``): one ``Model.prefill`` of 8
      rows of random bf16 patch embeddings (8, 576, 7168) and 100-token
      prompts, the cache padded to 576 + 100 + 32 positions through
      ``init_cache``, 32 ``Model.decode_step``s from pos 676 (K7 60 x (1
      + 32) times), every token the teacher-forced forward's argmax where
      its margin exceeds ``TIE_FACTOR`` x the bf16 gap, the prefill's
      logits within ``GAP_BOUND`` of the largest (the decode steps' bf16
      gap exceeds it at 60 layers and is reported); 2 requests again in
      float32 compute, 16 steps, within ``GAP_BOUND_F32`` of the float32
      forward and every token its argmax; one profiled decode step
      against the bytes bound of every weight and the cache read once; one
      loss forward at full depth on 2 x (576 + 128) positions;
      ``make_train_step`` at 4 of the 60 layers (one card holds no more of
      its training state), 4 steps of 2 x (576 + 128), losses finite and
      falling; then the optimized profile (``optimized_overrides``: 64 q
      heads, G = 8) at full depth, one prefill and 8 decode steps held as
      before. The vlm has no serving-engine path: the reference's engine
      prefills tokens only.
   The roofline on one card (``repro_torch.roofline``): after the
   profiled step of g (b) (a train step), of f, h, m and n (a) (an engine
   decode step of 8 rows), of each model of o and of p (a) and (d) (a
   decode step), the same step is counted on ``meta`` tensors
   (``roofline.counter.count_step``: matmul FLOPs, the eager bytes model
   by scope, bytes per device) and ``analyze``d at the H100's data-sheet
   rates (989 TFLOP/s bf16, 3.35 TB/s): ``compute_s``, ``memory_s``,
   ``step_s``, ``useful_ratio`` and the bytes per device are printed
   beside the step's card busy time and ``max_memory_allocated`` over
   it, with the host time of the step's ``record_function`` ranges (their
   count times one pair's timed cost, ``range_pair_us``), and the run
   fails if ``compute_s`` exceeds 1.05 x the busy time
   (``roofline_check``); the summary repeats them and
   ``chiprun_out/roofline.json`` keeps them. ``mfu`` is the roofline's
   ``model_flops`` of the train step over its time at 989 TFLOP/s.
   Every kernel launch counter is set to 0 just before each path (a, d,
   b) at each p, and before c, f, g's 8 steps, h, i's steps, each model
   of j, each example of k, l's generation and its 8 steps, m's serving
   and training, n's serving, ring set and training, each model of o,
   and p, and read just after it; K2 launches count by
   form (grid, cluster), K3 by kernel (fused, map), and on path a also by
   wrapper and query rows;
4. each kernel against its plain version again, on operands captured from
   the main path at full size, with CUDA-event times beside each kernel's
   bound (the bytes it must move at 3.35 TB/s, or its 32-bit integer
   operations and population counts at the card's peak issue rates for
   them, or K7's multiply-adds at the dense bf16 tensor rate, whichever
   takes longest; see ``op_rates`` and ``flash_bound_ms``); K2 in both
   forms with its iterations (ms per iteration) and the extraction after
   it, the fused K3 beside the map-writing K3 and the map's extraction;
   the fused top-k and K5
   at the main path's B = 64 call and at its first query alone (B = 1);
   K1 at the host walk's largest call and at B = 1, C = 8 (the card's
   per-launch floor for it); K7 at c's encoder call, at f's and h's
   decode call with the most valid keys and their longest prefill, at i's
   training call (q (8, 128, 32, 128) causal), at j's granite-34b
   prefill and decode calls (G = 48) and at l's encoder self-attention
   (q = k = (8, 1500, 6, 64)), cross-attention (q (8, 16, 6, 64) against
   (8, 1500, 6, 64)) and cross-attention decode (q (8, 1, 6, 64),
   ``valid_len`` 1,500), at n's windowed forward (q (8, 2127, 25, 64),
   window 2,048), ring decode (q (8, 1, 25, 64) against (8, 2048, 5, 64),
   ``valid_len`` 2,048) and 4,096-token training call, at o's arctic
   and kimi prefill and decode calls, and at p's llava prefill (q (8,
   676, 56, 128) causal) and decode (q (8, 1, 56, 128) over 708 valid
   keys) calls and the profile's (64 q heads), each also beside
   ``scaled_dot_product_attention`` on the same tensors and valid keys
   (with a window, under the same boolean mask; its ``library_ms``, c's
   call in the ``kernels`` record; the port never calls it).

Every time is printed with the card's name and power limit. The last two
lines are the ``kernels`` JSON record and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import importlib
import json
import multiprocessing
import os
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
    as ``kernels.ops`` calls it, or the linear scan's four kernel wrappers
    as ``kernels.ops`` calls them) to keep the operands of
    the first ``keep`` calls of each — of the grouped verify, its largest
    call — so each kernel can be checked and timed at the shapes the main
    path gives it. Launch counts are untouched: the wrapped function runs
    as before."""

    WALKS = ("device_probe_walk_batched", "device_probe_walk",
             "device_probe_scan_topk", "device_probe_scan_multi")
    SCANS = ("hamming_scan_scores", "hamming_scan_topk", "blockmax_scores",
             "verify_tuples")

    def __init__(self, sites, keep: int = 1):
        self.sites = sites          # (module, function name) pairs to wrap
        self.keep = keep
        self.calls = {}
        self.counts = {}            # (function name, query rows) -> calls
        self.iters = []             # (walk name, rows, iters tensor)
        self.orig = []

    def __enter__(self):
        for mod, name in self.sites:
            fn = getattr(mod, name)
            self.orig.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _name=name, **kw):
                q = a[1] if _name == "device_probe_walk_batched" else a[0]
                shape = getattr(q, "shape", ())
                key = (_name, int(shape[0]) if len(shape) else 0)
                self.counts[key] = self.counts.get(key, 0) + 1
                calls = self.calls.setdefault(_name, [])
                if _name == "gather_verify_grouped":
                    if self.keep and (not calls or a[2].numel()
                                      > calls[0][0][2].numel()):
                        calls[:] = [(a, kw)]
                elif len(calls) < self.keep:
                    calls.append((a, kw))
                out = _fn(*a, **kw)
                if _name.startswith("device_probe_walk"):
                    self.iters.append((_name, key[1], out[5]))
                return out

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.orig:
            setattr(mod, name, fn)
        return False


def sites(mod, names):
    """The (module, name) pairs of ``names`` in ``mod``, for ``Recorder``."""
    return [(mod, name) for name in names]


def _hold_cycles(host_s: float, calls: int) -> int:
    """Cycles of a spin kernel that outlasts the host's enqueueing of
    ``calls`` calls that took ``host_s`` seconds each to enqueue: twice
    that at 2 GHz, and at least 0.1 ms a call."""
    return int(calls * max(2e5, host_s * 4e9))


def cuda_ms(fn, reps: int) -> float:
    """Card time per call of ``fn``: CUDA events around ``reps`` calls.
    A spin kernel queued first holds the stream until every call is
    enqueued (twice the host's time to enqueue one call, timed on a warm
    call, so a wrapper's host work does not show as card time between
    calls); ``fn`` must not wait for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_hold_cycles(host_s, reps))
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


def _device_ms(prof, name):
    """Device ms of the kernels launched under the ``record_function``
    ranges called ``name`` (their children included), or None where the
    trace attributes none to them."""
    total = 0.0
    for e in prof.events():
        # the range's host-side event: its children's kernels (the trace
        # also holds the range's span on the card, which is not kernel time)
        if e.name == name and "CUDA" not in str(e.device_type):
            dt = getattr(e, "device_time_total", None)
            if dt is None:
                dt = getattr(e, "cuda_time_total", 0.0)
            total += dt / 1e3
    return total or None


def profile_batch(fn, label, out_dir, expect=(), ranges=None, stats=None):
    """One traced call of ``fn`` under ``torch.profiler``: wall time, the
    card's busy time (the sum of its kernels), the kernels that took it by
    device time, and the host's ops by their own time. The Chrome trace
    goes to ``out_dir``. A trace that records no device time, or no kernel
    named in ``expect`` (which ``fn`` launches), is taken once more; if it
    is empty again it is reported as empty, with no busy time or idle
    share, and if it still lacks an expected kernel, as incomplete, its
    busy time a lower bound. Where ``ranges`` is given, each of its keys
    names ``record_function`` ranges whose kernels' device ms it gets
    (None where the trace attributes none); ``stats`` (a dict) gets the
    wall and busy ms. Returns the kernels as (ms, count, name), longest
    first ([] for an empty profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows, busy = [], 0.0
        for e in prof.key_averages():
            if ("CUDA" not in str(getattr(e, "device_type", ""))
                    or getattr(e, "is_user_annotation", False)):
                continue                  # host ops; ranges' spans on the card
            dt = getattr(e, "self_device_time_total", None)
            if dt is None:
                dt = getattr(e, "self_cuda_time_total", 0.0)
            rows.append((dt / 1e3, e.count, e.key))
            busy += dt / 1e3
        missing = [x for x in expect
                   if not any(x in key for _, _, key in rows)]
        if busy > 0 and not missing:
            break
        log(f"  profile {label}: attempt {attempt} recorded "
            + (f"no kernel named {missing}" if busy > 0
               else "no device time"))
    if busy <= 0:
        log(f"  profile {label}: EMPTY (no device time recorded twice; wall "
            f"{wall:.3f} ms under the profiler); not a measurement")
        return []
    rows.sort(reverse=True)
    if stats is not None:
        stats.update(wall_ms=wall, busy_ms=busy)
    for name in ranges or ():
        ranges[name] = _device_ms(prof, name)
    if missing:
        log(f"  profile {label}: INCOMPLETE (no kernel named {missing} "
            f"recorded twice): wall {wall:.3f} ms under the profiler, card "
            f"busy at least {busy:.3f} ms")
    else:
        log(f"  profile {label}: wall {wall:.3f} ms (under the profiler), "
            f"card busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}")
    for dt, cnt, key in rows[:12]:
        log(f"    {dt:10.4f} ms  x{cnt:<5d} {key[:80]}")
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if "CUDA" not in str(getattr(e, "device_type", ""))),
                  reverse=True)
    log(f"    host ops by self time (ms): " + "; ".join(
        f"{key[:40]} {dt:.3f} x{cnt}" for dt, cnt, key in host[:10]))
    out_dir.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out_dir / f"trace_{label}.json"))
    return rows


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
def cuda_ms_split(fns, reps: int):
    """Card time per call of each of ``fns``, run in turn ``reps`` times
    (state may pass from one to the next: a walk, then the extraction that
    resets its map): CUDA events around each call, the stream held as in
    ``cuda_ms``; none of ``fns`` may wait for the card. Returns the mean
    ms of each."""
    import torch

    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in fns:
        f()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(len(fns) + 1)]
          for _ in range(reps)]
    torch.cuda._sleep(_hold_cycles(host_s, reps))
    for r in range(reps):
        for i, f in enumerate(fns):
            ev[r][i].record()
            f()
        ev[r][-1].record()
    torch.cuda.synchronize()
    return [sum(ev[r][i].elapsed_time(ev[r][i + 1]) for r in range(reps))
            / reps for i in range(len(fns))]


def _walk_fn(dp, name):
    if name == "device_probe_walk_batched":
        return dp.device_probe_walk_batched, dp.device_probe_walk_batched_plain
    return dp.device_probe_walk, dp.device_probe_walk_plain


def _walk_args(torch, dp, name, a, kw):
    """A fresh all-POS_INF map in the walk's operands: (args, kw)."""
    kw = {key: v for key, v in kw.items() if key != "posmap_in"}
    if name == "device_probe_walk_batched":
        return (torch.full_like(a[0], dp.POS_INF),) + tuple(a[1:]), kw
    B, n_pad = a[0].shape[0], a[18].shape[0]
    return tuple(a), dict(kw, posmap_in=torch.full(
        (B, n_pad), dp.POS_INF, dtype=torch.int32, device=a[0].device))


def _walk_forms(name, a):
    """The walk's forms for one call: the cluster takes one z-group of at
    most 4 queries (the per-group walk's small launches)."""
    if name == "device_probe_walk" and a[0].shape[0] <= 4:
        return ("grid", "cluster")
    return ("grid",)


def _walk_tstop_k(name, a):
    if name == "device_probe_walk_batched":
        return a[7], a[8]
    return a[5], a[6]


def check_walk_call(dp, name, a, kw, timed=False, reps=3):
    """K2 in its forms (cooperative grid; one cluster where the launch
    allows it) at check_every 1 and 3 against the plain walk, bit for bit
    (touched lists as sets), and the extraction kernel after the kernel
    walk against the plain
    extraction of the plain walk's whole map (``extract_map``), bit for
    bit, the kernel's map all POS_INF after it. With ``timed``: at the
    call's own cadence, the card time of the walk in each form and of the
    extraction after it (one POS_INF map, reset by each extraction), the
    plain walk's and the plain extraction's host-clock times, the walk's
    iterations and outputs."""
    import torch

    kernel, plain = _walk_fn(dp, name)
    saved = dict(dp.LAUNCHES)
    entry = {"max_abs_err": 0, "extract_err": 0, "calls": 0}
    for ce in (1, 3):
        args, kw2 = _walk_args(torch, dp, name, a, dict(kw, check_every=ce))
        ref = plain(*args, **kw2)
        torch.cuda.synchronize()
        t_stop, k = _walk_tstop_k(name, a)
        done = torch.nonzero(ref[3]).flatten()
        want = dp.extract_map(ref[0][done], t_stop[done], k)
        for form in _walk_forms(name, a):
            args, kw2 = _walk_args(torch, dp, name, a,
                                   dict(kw, check_every=ce))
            got = kernel(*args, **kw2, form=form)
            torch.cuda.synchronize()
            if dp.LAST_WALK_GRID[2] != form:
                raise AssertionError(f"{name} ran as {dp.LAST_WALK_GRID[2]}, "
                                     f"not {form}")
            cap = kw["cap"]
            err = max_err(dp.walk_canonical(got, cap)[1:],
                          dp.walk_canonical(ref, cap)[1:])
            err = max(err, max_err([got[0]], [ref[0]]))
            ids, pos = dp.extract_touched(got[0], got[6], got[8], t_stop, k,
                                          done, int(got[5]) * cap)
            entry["extract_err"] = max(entry["extract_err"],
                                       max_err([ids, pos], want[:2]))
            if not bool((got[0] == dp.POS_INF).all()):
                raise AssertionError(f"{name}: the extraction left entries "
                                     "of the map below POS_INF")
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            entry["calls"] += 1
            del got
        if timed and ce == kw.get("check_every", 1):
            entry["out"] = (None, ref[1].clone(), ref[2].clone(), None, None,
                            int(ref[5]), None, ref[7].clone(), None)
            entry["iters"] = int(ref[5])
            entry["done_rows"] = int(done.numel())
            rows = done.clone()
            width = int(ref[5]) * kw["cap"]
            for form in _walk_forms(name, a):
                args, kw3 = _walk_args(torch, dp, name, a,
                                       dict(kw, check_every=ce))
                pm = args[0] if name.endswith("batched") else kw3["posmap_in"]
                hold = {}

                def walk():
                    hold["out"] = kernel(*args, **kw3, form=form)

                def extract():
                    o = hold["out"]
                    dp.extract_touched(pm, o[6], o[8], t_stop, k, rows,
                                       width)

                (entry[f"ms_{form}"],
                 entry[f"extract_ms_{form}"]) = cuda_ms_split([walk, extract],
                                                              reps)
            walk()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = hold["out"]
            dp.extract_touched_plain(pm, o[6], o[8], t_stop, k, rows, width)
            torch.cuda.synchronize()
            entry["extract_plain_ms"] = (time.perf_counter() - t0) * 1e3
            entry["width"], entry["k"] = width, k
            t0 = time.perf_counter()
            plain(*_walk_args(torch, dp, name, a,
                              dict(kw, check_every=ce))[0], **kw2)
            torch.cuda.synchronize()
            entry["plain_ms"] = (time.perf_counter() - t0) * 1e3
            entry["args"], entry["kw"] = a, dict(kw, check_every=ce)
        del ref
    dp.LAUNCHES.update(saved)                   # comparisons do not count
    return entry


def check_scan_topk_call(dp, a, kw, timed=False, reps=5):
    """The fused K3 against its plain version (the map scan, then
    ``extract_map``), and the map-writing K3 against its plain map, both
    on one bail call's operands, bit for bit. With ``timed``: both
    kernels' card times, the map route's extraction after the map kernel,
    and the plain version's host-clock time."""
    import numpy as np
    import torch

    q_words, gid, t_stop, db_pad, inv_pos, n_valid, k = a
    kw_map = {key: v for key, v in kw.items() if key != "plan"}
    saved = dict(dp.LAUNCHES)
    got = dp.device_probe_scan_topk(*a, **kw)
    torch.cuda.synchronize()
    pm_plain = dp.device_probe_scan_multi_plain(q_words, gid, db_pad,
                                                inv_pos, n_valid, **kw_map)
    ref = dp.extract_map(pm_plain, t_stop, k)
    torch.cuda.synchronize()
    entry = {"max_abs_err": max_err(got, ref)}
    pm = dp.device_probe_scan_multi(q_words, gid, db_pad, inv_pos, n_valid,
                                    **kw_map)
    torch.cuda.synchronize()
    entry["map_max_abs_err"] = max_err([pm], [pm_plain])
    del pm_plain
    if timed:
        # the plan's arrays placed on the card once, so that no call waits
        plan = dict(kw["plan"])
        plan["flat"] = torch.from_numpy(np.concatenate(
            [plan["order"].astype(np.int32), plan["segs"].reshape(-1),
             plan["tabs"].reshape(-1), plan["qtab"]])).to(q_words.device)
        kw_t = dict(kw, plan=plan)
        entry["ms"] = cuda_ms(lambda: dp.device_probe_scan_topk(*a, **kw_t),
                              reps)
        entry["map_ms"] = cuda_ms(lambda: dp.device_probe_scan_multi(
            q_words, gid, db_pad, inv_pos, n_valid, **kw_map), reps)
        pm = dp.device_probe_scan_multi(q_words, gid, db_pad, inv_pos,
                                        n_valid, **kw_map)
        entry["map_extract_ms"] = cuda_ms(
            lambda: dp.extract_map(pm, t_stop, k), 2)
        t0 = time.perf_counter()
        dp.device_probe_scan_topk_plain(*a, **kw_map)
        torch.cuda.synchronize()
        entry["plain_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        dp.device_probe_scan_multi_plain(q_words, gid, db_pad, inv_pos,
                                         n_valid, **kw_map)
        torch.cuda.synchronize()
        entry["map_plain_ms"] = (time.perf_counter() - t0) * 1e3
        entry["args"] = a
    del pm
    dp.LAUNCHES.update(saved)                   # comparisons do not count
    return entry


def check_walk_calls(dp, rec, label, timed=frozenset(), reps=3):
    """Kernel vs plain on every recorded walk/scan call (the grouped
    verify, both walks, the fused scan and the map scan), timing the first
    call of each name in ``timed``; returns per-name measurements."""
    import torch

    vt = importlib.import_module("repro_torch.kernels.verify_tuples")

    res = {}
    for name, calls in rec.calls.items():
        for (a, kw) in calls:
            is_timed = name in timed and "ms" not in res.get(name, {})
            if name == "gather_verify_grouped":
                saved = dict(vt.LAUNCHES)
                got = vt.gather_verify_grouped(*a, **kw)
                torch.cuda.synchronize()
                ref = vt.gather_verify_grouped_plain(*a[:4], kw["p"])
                entry = {"max_abs_err": max_err([got], [ref])}
                if is_timed:
                    # a few microseconds a launch: many launches a timing
                    entry["ms"] = cuda_ms(
                        lambda: vt.gather_verify_grouped(*a, **kw),
                        max(reps, 100))
                    t0 = time.perf_counter()
                    vt.gather_verify_grouped_plain(*a[:4], kw["p"])
                    torch.cuda.synchronize()
                    entry["plain_ms"] = (time.perf_counter() - t0) * 1e3
                    entry["args"] = a
                vt.LAUNCHES.update(saved)
                how = f"B={a[0].shape[0]}, C={a[2].shape[1]}: equal"
            elif name.startswith("device_probe_walk"):
                entry = check_walk_call(dp, name, a, kw, is_timed, reps)
                rows = a[1 if name.endswith("batched") else 0].shape[0]
                how = (f"B={rows}, {' and '.join(_walk_forms(name, a))} "
                       "form, check_every 1 and 3, and the extraction kernel "
                       "after it: equal")
            elif name == "device_probe_scan_topk":
                entry = check_scan_topk_call(dp, a, kw, is_timed, reps)
                how = (f"B={a[0].shape[0]}, k={a[6]}, {a[4].shape[0]} "
                       "inv_pos rows, fused and map kernels: equal")
            else:
                q_words, gid, db_pad, inv_pos, n_valid = a
                saved = dict(dp.LAUNCHES)
                got = dp.device_probe_scan_multi(*a, **kw)
                torch.cuda.synchronize()
                entry = {"max_abs_err": max_err(
                    [got], [dp.device_probe_scan_multi_plain(*a, **kw)])}
                del got
                dp.LAUNCHES.update(saved)
                how = f"B={a[0].shape[0]} (the map route): equal"
            prev = res.get(name)
            if prev is None or ("ms" in entry and "ms" not in prev):
                if prev is not None:
                    entry["max_abs_err"] = max(entry["max_abs_err"],
                                               prev["max_abs_err"])
                res[name] = entry
            else:
                prev["max_abs_err"] = max(prev["max_abs_err"],
                                          entry["max_abs_err"])
            log(f"  {label} {name} ({how})")
    return res


# One verify of a code of W words: per word two and-nots, two population
# counts and two adds; then the key's multiply-add and a few compares,
# indexing and masking (``extra``).
def walk_bound_ms(out, W, k=0):
    """Least time of one walk launch: every retrieved candidate's id and
    code read once, two CSR offsets per probe, and per touched entry its
    map write and its list entry; no fill of the (B, n_pad) map. With
    ``k``, the extraction after it too: per touched entry its list entry
    and map entry read and its map entry reset, and (B, k) ids and
    positions written."""
    probes, retrieved, n_touched = out[1], out[2], out[7]
    live = int(retrieved.sum())
    touched = int(n_touched.sum())
    nbytes = live * (4 + 4 * W) + int(probes.sum()) * 8 + touched * 8
    if k:
        nbytes += touched * 12 + n_touched.numel() * k * 8
    return bound_ms(nbytes, live * (4 * W + 8), live * 2 * W)


def extract_bound_ms(entry):
    """Least time of one extraction kernel launch: every row's list read
    once (width entries), each touched entry's map entry read and reset,
    and (rows done, k) ids and positions written."""
    B = entry["out"][7].numel()
    touched = int(entry["out"][7].sum())
    nbytes = (B * entry["width"] * 4 + touched * 8
              + entry["done_rows"] * entry["k"] * 8)
    return bound_ms(nbytes, B * entry["width"], 0)


# A scan of B queries over N codes needs less: r10 = z - |q & c| and
# r01 = |c| - |q & c|, so per pair W ands, population counts and adds for
# |q & c| and ``extra`` operations after them, and per code W population
# counts and adds for |c|, which the B queries share.
def pair_bound_ms(nbytes, B, N, W, extra):
    return bound_ms(nbytes, B * N * (2 * W + extra) + N * W,
                    B * N * W + N * W)


def scan_bound_ms(q_words, db_pad):
    """Least time of a map-writing K3 launch: codes and queries read once,
    the (B, n_pad) positions written once; per pair the key's r10, r01 and
    multiply-add."""
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


def offset_view(torch, t):
    """A copy of ``t`` in a view that starts 4 bytes past a 16-byte
    boundary (the kernels' vector loads must not take it)."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = buf[1 : 1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


# K1's edge shapes (p, B, C, offset idx, offset codes): W = 1 to 8 and 10
# (its runtime-W form), C from 1 to 5000 (blocks wholly past a length),
# lengths 0, C and ragged, the last row as a candidate; K5's (p, B, blk,
# offset codes) over 70,001 codes: W = 1 to 8, B = 1 and ragged query
# tiles, blk 1, 37, 128, 1000, 2048 and N + 5 (None). An offset array
# starts 4 bytes past a 16-byte boundary (codes so placed take the
# kernels' scalar-load forms).
K1_EDGE = [(32, 3, 1, False, False), (64, 5, 7, False, True),
           (96, 5, 7, True, False), (128, 9, 1024, False, True),
           (160, 9, 1024, False, False), (192, 9, 300, True, True),
           (224, 5, 5000, False, False), (256, 9, 1024, True, False),
           (256, 9, 300, False, True), (320, 5, 300, False, False)]
K5_EDGE = [(32, 1, 1, False), (64, 17, 37, False), (96, 33, 128, False),
           (128, 11, None, True), (160, 64, 2048, False),
           (192, 1, 1000, True), (224, 17, 2048, False),
           (256, 33, 37, True), (128, 1, 2048, True), (256, 64, 1, False),
           (64, 11, 2048, True)]


def check_edge_shapes(vt, bm, ops, torch, dev, n=70_001):
    """Phase 2: K1 and K5 against their plain versions at every code width
    and at the edge shapes of ``K1_EDGE`` and ``K5_EDGE``, exactly (K5's
    float32 maxima as their bits); the comparison launches do not count."""
    import numpy as np

    from repro_torch.data.synthetic import (
        synthetic_binary_codes_packed,
        synthetic_queries_packed,
    )

    saved = (dict(vt.LAUNCHES), dict(bm.LAUNCHES))
    for p, B, C, off_idx, off_db in K1_EDGE:
        rng = np.random.default_rng(p + C)
        W, N = (p + 31) // 32, 5000
        words = rng.integers(0, 1 << 32, size=(N + B, W), dtype=np.uint64)
        words = torch.from_numpy(words.astype(np.uint32).view(np.int32))
        db, q = words[:N].to(dev), words[N:].to(dev)
        idx = rng.integers(0, N, size=(B, C)).astype(np.int32)
        idx[1, -1] = N - 1
        lens = rng.integers(0, C + 1, size=B).astype(np.int32)
        lens[:3] = [0, C, C // 2 + 1]
        idx = torch.from_numpy(idx).to(dev)
        lens = torch.from_numpy(lens).to(dev)
        if off_idx:
            idx = offset_view(torch, idx)
        if off_db:
            db = offset_view(torch, db)
        got = vt.gather_verify_grouped(q, db, idx, lens, p=p)
        max_err([got], [vt.gather_verify_grouped_plain(q, db, idx, lens, p)])
    for p, B, blk, off in K5_EDGE:
        blk = n + 5 if blk is None else blk
        db = synthetic_binary_codes_packed(n, p, seed=SEED + p)
        q = synthetic_queries_packed(db, p, B, seed=SEED + p + 1)
        db[5] = 0
        if B > 1:
            q[1] = 0
        db_t, q_t = ops.to_device(db, dev), ops.to_device(q, dev)
        z = ops.query_popcounts(q_t)
        if off:
            db_t = offset_view(torch, db_t)
        got = bm.blockmax_scores(q_t, z, db_t, blk_n=blk)
        want = bm.blockmax_scores_plain(q_t, z, db_t, blk)
        max_err([got.view(torch.int32)], [want.view(torch.int32)])
    torch.cuda.synchronize()
    vt.LAUNCHES.update(saved[0])
    bm.LAUNCHES.update(saved[1])
    return len(K1_EDGE), len(K5_EDGE)


def k1_floor(vt, torch, a, p, reps=100):
    """K1 at B = 1, C = 8 on the first row of a main-path call (the card's
    per-launch floor for it), checked against its plain version: ms."""
    q, db, idx, lens = a
    a1 = (q[:1].contiguous(), db, idx[:1, :8].contiguous(),
          lens[:1].clamp(max=8).contiguous())
    saved = dict(vt.LAUNCHES)
    got = vt.gather_verify_grouped(*a1, p=p)
    max_err([got], [vt.gather_verify_grouped_plain(*a1, p)])
    ms = cuda_ms(lambda: vt.gather_verify_grouped(*a1, p=p), reps)
    vt.LAUNCHES.update(saved)
    return ms


def scan_bound_ms_pairs(B, N, W, out_elems):
    """Least time of a K4/K5 launch: codes and queries read once, the
    ``out_elems`` float32 results written once; per (query, code) pair
    the Eq. 3 numerator |q & c| and the denominator's multiply z * |c|.
    The float work after it (a conversion and a multiply per pair, the
    square root and reciprocal per distinct z * |c|) is not counted."""
    nbytes = N * W * 4 + B * (W + 1) * 4 + out_elems * 4
    return pair_bound_ms(nbytes, B, N, W, 1)


def scan_kernels(hs, bm, vt):
    """name -> (kernel, plain, LAUNCHES dict) of the linear scan's four
    kernel wrappers, keyed as ``Recorder.SCANS`` names them."""
    return {
        "hamming_scan_scores": (hs.hamming_scan_scores,
                                hs.hamming_scan_scores_plain, hs.LAUNCHES),
        "hamming_scan_topk": (hs.hamming_scan_topk,
                              hs.hamming_scan_topk_plain, hs.LAUNCHES),
        "blockmax_scores": (bm.blockmax_scores, bm.blockmax_scores_plain,
                            bm.LAUNCHES),
        "verify_tuples": (vt.verify_tuples, vt.verify_tuples_plain,
                          vt.LAUNCHES),
    }


def check_scan_call(kernels, name, a, kw, timed=False, reps=20):
    """K4 (scores or the fused top-k), K5 or K6 on one call's operands
    against the plain version on the same tensors, bit for bit (float32
    outputs compared as their bits); with ``timed``, the kernel's
    CUDA-event time, the plain version's host-clock time around one call,
    and the bound (the fused top-k's outputs are its (B, k) sims and ids,
    its pairs all B x N)."""
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
    # (equal slots count 0, -inf ones of the top-k included)
    err = max(float(torch.where(g == r, 0.0, (g.double() - r.double()).abs())
                    .max()) if g.numel() else 0.0 for g, r in zip(got, ref))
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
            q, _, db = a[:3]
            B, W = q.shape
            entry["bound_ms"], entry["bound_by"] = scan_bound_ms_pairs(
                B, db.shape[0], W, sum(g.numel() for g in got))
        entry["shape"] = (f"q {tuple(a[0].shape)}, codes "
                          f"{tuple(a[2 if len(a) > 2 else 1].shape)}")
        entry["args"] = ", ".join(f"{x}" for x in a[3:]) or "-"
    counts.update(saved)                          # comparisons do not count
    return entry


def check_scan_kernels(kernels, ops, torch, dev, p, n=1 << 18, B=64):
    """Phase 2: K4 (scores and the fused top-k), K5 and K6 against their
    plain versions at n codes, with a zero-norm query, an all-zero code and
    a ragged last block or row tile; the fused top-k also at B = 1 with
    k = 1024 (its largest), and over a database of five distinct codes
    (ties across every row tile, staging areas that fill again and
    again)."""
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
    dup = db_t[torch.arange(db_t.shape[0], device=dev) % 5].contiguous()
    calls = (("hamming_scan_scores", (q_t, z, db_t), {}),
             ("hamming_scan_topk", (q_t, z, db_t, 32, None, None), {}),
             ("hamming_scan_topk", (q_t, z, dup, 128, None, None), {}),
             ("hamming_scan_topk", (q_t[:1], z[:1], db_t, 1024, None, None),
              {}),
             ("blockmax_scores", (q_t, z, db_t), {"blk_n": 2048}),
             ("verify_tuples", (q_t[0], db_t), {}))
    for name, a, kw in calls:
        check_scan_call(kernels, name, a, kw)
    return list(dict.fromkeys(name for name, _, _ in calls))


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
              tag, timings, pruned):
    """Phase 3b at one p: the CUDA linear scan's cases (appended to
    ``timings``), its pruned scan beside ``ops.scan_topk`` (appended to
    ``pruned``) and its one-query verify, each checked as the module
    docstring says. ``want_topk(row, k)`` is the float64
    scan's top-k of row ``row`` of ``chk``; ``amih_rows[k]`` the AMIH
    path's B = 64 result."""
    import numpy as np
    import torch

    from repro_torch.core.engine import make_engine
    from repro_torch.core.linear_scan import sims_for_ids
    from repro_torch.core.packing import hamming_tuples
    from repro_torch.kernels import ops
    from repro_torch.kernels.hamming_scan import KCAP_MAX
    from repro_torch.obs.metrics import REGISTRY

    chunks = -(-N_MAIN // (1 << 16))   # K4 launches of a chunked top-k
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
            f0 = REGISTRY.value("launches.scan_topk")
            ms = []
            if B == 64:
                eng.knn_batch(batch, K)                      # warm
                # what one batch allocates beyond what is resident (the
                # codes, uploaded once, and earlier phases' tensors)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                eng.knn_batch(batch, K)
                extra = torch.cuda.max_memory_allocated() - base
                limit = 0.01 * B * N_MAIN * 4
                if extra > limit:
                    raise AssertionError(
                        f"linear scan p={p} B={B} K={K}: a batch allocates "
                        f"{extra:,} bytes beyond the resident codes, over "
                        f"1% of the (B, N) scores ({limit:,.0f})")
                log(f"  linear scan p={p} B={B} K={K}: peak allocation of "
                    f"one batch {extra:,} bytes beyond the resident codes "
                    f"({N_MAIN * db.shape[1] * 4:,} bytes), limit "
                    f"{limit:,.0f} (1% of the (B, N) float32 scores)")
                for _ in range(5):
                    t0 = time.perf_counter()
                    ids, sims, _ = eng.knn_batch(batch, K)
                    ms.append((time.perf_counter() - t0) * 1e3 / B)
                n_batches = 7
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
            per = (REGISTRY.value("launches.scan_topk") - f0) / n_batches
            scores = REGISTRY.value("launches.scan_scores") - s0
            if per != 1 or scores:
                raise AssertionError(f"linear scan p={p} B={B} K={K}: "
                                     f"{per} fused top-k calls and "
                                     f"{scores / n_batches} K4 score launches "
                                     f"per batch, expected 1 and 0")
            med = statistics.median(ms)
            timings.append((p, B, K, med))
            log(f"  linear scan p={p} B={B} K={K}: {med:.4f} ms/query "
                f"(median of 5 warm batches) {tag}; 1 fused top-k call and "
                f"0 K4 score launches per batch; exact vs the float64 "
                f"scan{vs_amih}")
    db_t = ops.to_device(db, dev)
    q_t = ops.to_device(batch, dev)
    # a top-k above the fused kernel's cap takes the chunked route (K4
    # scores per 65,536 codes and the running top-K); its first 1024 equal
    # the fused kernel's top 1024
    s0 = REGISTRY.value("launches.scan_scores")
    f0 = REGISTRY.value("launches.scan_topk")
    c_sims, c_ids = ops.scan_topk(q_t, db_t, 2 * KCAP_MAX)
    if (REGISTRY.value("launches.scan_scores") - s0 != chunks
            or REGISTRY.value("launches.scan_topk") != f0):
        raise AssertionError(f"p={p}: k = {2 * KCAP_MAX} did not take the "
                             f"chunked route ({chunks} K4 launches)")
    f_sims, f_ids = ops.scan_topk(q_t, db_t, KCAP_MAX)
    if not (torch.equal(c_sims[:, :KCAP_MAX], f_sims)
            and torch.equal(c_ids[:, :KCAP_MAX], f_ids)):
        raise AssertionError(f"p={p}: the chunked route's top {KCAP_MAX} "
                             "differs from the fused kernel's")
    log(f"  scan_topk p={p} B=64 k={2 * KCAP_MAX}: chunked route, {chunks} "
        f"K4 launches; its top {KCAP_MAX} equal to the fused kernel's")
    del c_sims, c_ids
    for B in (64, 1):
        q_b = q_t[:B]
        f_sims, f_ids = ops.scan_topk(q_b, db_t, 10)
        p_sims, p_ids, frac = ops.scan_topk_pruned(q_b, db_t, 10)
        if not (torch.equal(f_sims, p_sims) and torch.equal(f_ids, p_ids)):
            raise AssertionError(f"p={p} B={B}: scan_topk_pruned differs "
                                 "from scan_topk")
        # ms/query of each, median of 5 warm batches (host clock to a
        # synchronize: the pruned scan waits for the card in its nonzero)
        ms = []
        for fn in (lambda: ops.scan_topk(q_b, db_t, 10),
                   lambda: ops.scan_topk_pruned(q_b, db_t, 10)):
            runs = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3 / B)
            ms.append(statistics.median(runs))
        pruned.append((p, B, ms[0], ms[1], float(frac)))
        log(f"  scan_topk_pruned p={p} B={B} K=10: equal to scan_topk; "
            f"scanned_fraction {float(frac):.6f}; {ms[1]:.4f} ms/query "
            f"(scan_topk {ms[0]:.4f}; median of 5 warm batches) {tag}")
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
                      "scan_p128_B64_K10", ROOT / "chiprun_out",
                      expect=("scan_topk",))
        span_breakdown(lambda: eng.knn_batch(batch, 10),
                       "scan_p128_B64_K10")
        profile_batch(lambda: eng.knn_batch(singles[1:2], 10),
                      "scan_p128_B1_K10", ROOT / "chiprun_out",
                      expect=("scan_topk",))
        span_breakdown(lambda: eng.knn_batch(singles[1:2], 10),
                       "scan_p128_B1_K10")


# ------------------------------------------------------- phase 3d: shards
N_SHARDS = 8


def _ms_runs(fn, B, runs=5):
    """Median ms/query of ``runs`` calls of ``fn`` (host clock; every
    engine call ends in host copies of its results) and the last result."""
    ms, out = [], None
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        ms.append((time.perf_counter() - t0) * 1e3 / B)
    return statistics.median(ms), out


def shard_path(p, m, db, batch, singles, eng, host, h_out, *, dev, tag,
               chk, want_topk, rows, keep):
    """Phase 3d at one p: the shard and pipeline layers on phase 3a's
    codes, the shards all on ``dev`` (the module docstring lists the
    checks). ``eng`` is phase 3a's AMIH engine, ``host`` its host walk
    with the CUDA verify and ``h_out`` that walk's (ids, sims, K1
    launches) on ``batch[:4]``. Appends (label, ms/query) to ``rows``
    and keeps in ``keep`` what phase 3e compares with: the in-process
    engines' (ids, sims, ms/query) by (engine, B, K)."""
    import numpy as np

    from repro_torch.core.engine import make_engine
    from repro_torch.kernels import device_probe as dp
    from repro_torch.kernels import hamming_scan as hs
    vt = importlib.import_module("repro_torch.kernels.verify_tuples")
    from repro_torch.pipeline import VerifyOverlap

    def walks():
        return (dp.LAUNCHES["probe_walk"] + dp.LAUNCHES["probe_walk_cluster"],
                dp.LAUNCHES["probe_extract"], dp.LAUNCHES["probe_scan_topk"])

    # the host walk's 4 queries with the verify overlap (K1 on a side
    # stream): bit-identical to phase 3a's sequential walk, same K1 count
    h_ids, h_sims, h_launches = h_out
    ov = VerifyOverlap()
    l0, k0 = host.verify_launches, vt.LAUNCHES["verify_grouped"]
    o_ids, o_sims = host.knn_batch(batch[:4], 10, overlap=ov)
    launched = host.verify_launches - l0
    k_ovl = vt.LAUNCHES["verify_grouped"] - k0
    # timed in turns after that first (checked) call: sequential,
    # overlapped, sequential, overlapped; the better of each pair
    t_seq, t_ovl = float("inf"), float("inf")
    for _ in range(2):
        for over in (None, ov):
            t0 = time.perf_counter()
            host.knn_batch(batch[:4], 10, overlap=over)
            ms = (time.perf_counter() - t0) * 1e3 / 4
            if over is None:
                t_seq = min(t_seq, ms)
            else:
                t_ovl = min(t_ovl, ms)
    ov.close()
    if not (np.array_equal(o_ids, h_ids) and np.array_equal(o_sims, h_sims)
            and launched == h_launches == k_ovl
            and ov.device_steps > 0):
        raise AssertionError(f"p={p}: the verify overlap differs from the "
                             f"sequential host walk ({launched} K1 launches "
                             f"against {h_launches})")
    rows.append((f"host walk + K1, overlap_verify, p={p} B=4 K=10", t_ovl))
    rows.append((f"host walk + K1, sequential, p={p} B=4 K=10", t_seq))
    log(f"  p={p}: host walk with overlap_verify, 4 queries K=10: "
        f"bit-identical to phase 3a's sequential walk, {launched} K1 "
        f"launches (the same), {ov.device_steps} steps on the side stream "
        f"over three calls; {t_ovl:.2f} ms/query (sequential {t_seq:.2f}; "
        f"the better of two calls each, in turns) {tag}")

    if p == 64:
        # the single table (host code) on 8 queries, against the float64
        # scan up to equal-cosine ties; the enumeration cap sends the
        # queries whose k-th neighbour lies far to the exact host scan
        t0 = time.perf_counter()
        st_eng = make_engine("single_table", db, p, enumeration_cap=1 << 20)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids, sims, st = st_eng.knn_batch(batch[:8], 10)
        ms = (time.perf_counter() - t0) * 1e3 / 8
        w = [want_topk(j, 10) for j in range(8)]
        exact = same_but_ties(ids, sims, np.stack([x[0] for x in w]),
                              np.stack([x[1] for x in w]))
        falls = sum(s.fell_back_to_scan for s in st.per_query)
        rows.append((f"single_table p={p} B=8 K=10", ms))
        log(f"  single_table p={p} B=8 K=10: {ms:.2f} ms/query (host code; "
            f"build {t_build:.1f} s), {falls}/8 queries past the enumeration "
            f"cap to the exact scan; {exact}/8 rows equal to the float64 "
            f"scan, the rest but for equal-cosine ties")
        return

    # sharded AMIH, the device walk: one super index for the card's 8
    # shards, one K2 launch and one extraction per batch
    t0 = time.perf_counter()
    sh = make_engine("sharded_amih", db, p, m=m, num_shards=N_SHARDS,
                     devices=[dev])
    sh._fused_groups()
    t_build = time.perf_counter() - t0
    log(f"  sharded_amih p={p}: {N_SHARDS} shards on {dev}, build {t_build:.1f}"
        f" s (the shard indexes and the card's super index)")
    for B in (64, 1):
        for K in (10, 100):
            if B == 64:
                u_ids, u_sims, _ = eng.knn_batch(batch, K)
                sh.knn_batch(batch, K)                     # warm
                w0 = walks()
                ms, (ids, sims, st) = _ms_runs(
                    lambda: sh.knn_batch(batch, K), B)
                n_b = 5
            else:
                us = [eng.knn_batch(singles[j:j + 1], K) for j in range(1, 6)]
                u_ids = np.concatenate([u[0] for u in us])
                u_sims = np.concatenate([u[1] for u in us])
                sh.knn_batch(singles[:1], K)               # warm
                w0 = walks()
                outs, ms_l = [], []
                for j in range(1, 6):
                    t0 = time.perf_counter()
                    outs.append(sh.knn_batch(singles[j:j + 1], K))
                    ms_l.append((time.perf_counter() - t0) * 1e3)
                ms, n_b = statistics.median(ms_l), 5
                ids = np.concatenate([o[0] for o in outs])
                sims = np.concatenate([o[1] for o in outs])
                st = outs[-1][2]
            dw = [b - a for a, b in zip(w0, walks())]
            if dw[0] != n_b or dw[1] != n_b or dw[2] > n_b:
                raise AssertionError(
                    f"sharded_amih p={p} B={B} K={K}: {dw[0]} K2 launches, "
                    f"{dw[1]} extractions, {dw[2]} fused K3 calls for {n_b} "
                    f"batches, expected one K2 and one extraction a batch")
            for i in range(ids.shape[0]):
                if not np.array_equal(np.sort(sims[i]), np.sort(u_sims[i])):
                    raise AssertionError(f"sharded_amih p={p} B={B} K={K}: "
                                         f"row {i}'s sims differ from AMIH's")
            exact = same_but_ties(ids, sims, u_ids, u_sims)
            lead = st.per_shard[0]
            keep["sharded_amih", B, K] = (ids, sims, ms)
            if (B, K) == (64, 10):
                span_breakdown(lambda: sh.knn_batch(batch, K),
                               f"sharded_amih p{p}_B64_K10")
            rows.append((f"sharded_amih device walk p={p} B={B} K={K}", ms))
            log(f"  sharded_amih p={p} B={B} K={K}: {ms:.4f} ms/query "
                f"(median of 5) {tag}; per batch 1 K2 launch, 1 extraction, "
                f"{dw[2] / n_b:.2f} fused K3 calls; lead shard launches "
                f"{lead['launches']}, riders "
                f"{sum(d['launches'] for d in st.per_shard[1:])}; sims "
                f"bit-identical to the unsharded AMIH, ids on "
                f"{exact}/{ids.shape[0]} rows, the rest but for ties")
    del sh

    # the sharded scan: one fused K4 top-K call per shard, bit-identical
    # to the linear scan
    lin = make_engine("linear_scan", db, p, device=dev)
    ss = make_engine("sharded_scan", db, p, num_shards=N_SHARDS,
                     devices=[dev])
    for B in (64, 1):
        for K in (10, 100):
            qs = [batch] if B == 64 else [singles[j:j + 1]
                                          for j in range(1, 6)]
            want = [lin.knn_batch(q, K) for q in qs]
            ss.knn_batch(qs[0], K)                         # warm
            f0 = hs.LAUNCHES["hamming_scan_topk"]
            c0 = hs.LAUNCHES["hamming_scan"]
            if B == 64:
                ms, got = _ms_runs(lambda: ss.knn_batch(batch, K), B)
                got, n_b = [got], 5
            else:
                got, ms_l = [], []
                for q in qs:
                    t0 = time.perf_counter()
                    got.append(ss.knn_batch(q, K))
                    ms_l.append((time.perf_counter() - t0) * 1e3)
                ms, n_b = statistics.median(ms_l), 5
            calls = hs.LAUNCHES["hamming_scan_topk"] - f0
            if calls != N_SHARDS * n_b or hs.LAUNCHES["hamming_scan"] != c0:
                raise AssertionError(f"sharded_scan p={p} B={B} K={K}: "
                                     f"{calls} fused K4 calls for {n_b} "
                                     f"batches, expected {N_SHARDS} a batch")
            for g, w in zip(got, want):
                if not (np.array_equal(g[0], w[0])
                        and np.array_equal(g[1], w[1])):
                    raise AssertionError(f"sharded_scan p={p} B={B} K={K}: "
                                         "differs from the linear scan")
            if B == 64:
                keep["sharded_scan", B, K] = (want[0][0], want[0][1], ms)
            rows.append((f"sharded_scan p={p} B={B} K={K}", ms))
            log(f"  sharded_scan p={p} B={B} K={K}: {ms:.4f} ms/query "
                f"(median of 5) {tag}; {N_SHARDS} fused K4 calls per batch; "
                f"ids and sims bit-identical to the linear scan")
    del lin, ss

    # sharded AMIH on the host walk with the CUDA verify: the sequential
    # chain, then the thread-mode shard pool, equal
    t0 = time.perf_counter()
    hp = make_engine("sharded_amih", db, p, m=m, num_shards=N_SHARDS,
                     devices=[dev], probe_backend="host",
                     verify_backend="cuda")
    t_build = time.perf_counter() - t0
    ms_c, (c_ids, c_sims, _) = _ms_runs(lambda: hp.knn_batch(batch[:8], 10),
                                        8, runs=1)
    hp.probe_workers, hp.probe_mode = N_SHARDS, "thread"
    hp.PARALLEL_MIN_SHARD_ROWS = hp.PARALLEL_MIN_CPUS = 0
    hp.PARALLEL_MIN_BATCH = 0
    ms_p, (p_ids, p_sims, _) = _ms_runs(lambda: hp.knn_batch(batch[:8], 10),
                                        8, runs=1)
    mode = hp._pool.mode
    hp.close()
    if not (mode == "thread" and np.array_equal(p_ids, c_ids)
            and np.array_equal(p_sims, c_sims)):
        raise AssertionError(f"p={p}: the {mode} shard pool differs from the "
                             "sequential chain")
    rows.append((f"sharded_amih host walk + K1, chain, p={p} B=8 K=10", ms_c))
    rows.append((f"sharded_amih host walk + K1, thread pool, p={p} B=8 "
                 f"K=10", ms_p))
    log(f"  sharded_amih host walk + K1 p={p} B=8 K=10 (build {t_build:.1f} "
        f"s): the thread pool ({N_SHARDS} workers) equal to the sequential "
        f"chain; {ms_p:.2f} ms/query (chain {ms_c:.2f}) {tag}")


# ------------------------------------------------------ phase 3e: cluster
N_HOSTS = 2


@contextlib.contextmanager
def _child_threads(n):
    """``n`` intra-op threads in the worker processes spawned inside
    (they inherit the environment); the environment is restored after."""
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(n)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = saved


def _lane_spans(tracer):
    """Host-clock ms summed by span name in each trace lane (the
    coordinator's, and each worker's shifted onto its clock)."""
    out = {}
    for s in tracer.snapshot():
        lane = out.setdefault(s.get("host", "?"), {})
        lane[s["name"]] = lane.get(s["name"], 0.0) + s["dur"] / 1e3
    return out


def _spawn_cluster(p, db, threads, **cfg):
    """A cluster engine over a fleet it spawns (``N_HOSTS`` port workers
    on their default device, the card), and its build seconds."""
    from repro_torch.core.engine import make_engine

    t0 = time.perf_counter()
    with _child_threads(threads):
        eng = make_engine("cluster", db, p, hosts=N_HOSTS,
                          num_shards=N_SHARDS, **cfg)
    return eng, time.perf_counter() - t0


def cluster_path(p, m, db, batch, singles, eng, keep, *, dev, tag,
                 want_topk, rows, out_dir):
    """Phase 3e at p = 128: the cluster tier over ``N_HOSTS`` spawned
    port workers on the card, against phase 3a's AMIH (``eng``) on the
    same queries and phase 3d's in-process engines over the same plan
    (``keep``); the module docstring lists the checks. Appends (label,
    ms/query) to ``rows``; returns the K2 launch spans per worker lane of
    the traced batch."""
    import numpy as np

    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.export import load_chrome_trace
    from repro_torch.obs.report import summarize

    t_phase = time.perf_counter()
    dkey = str(dev)
    # the workers share the machine's cores, as the hosts of a real
    # deployment would have their own
    threads = max(1, (os.cpu_count() or 1) // N_HOSTS)
    cl, t_build = _spawn_cluster(p, db, threads, m=m, probe_backend="device")
    procs = list(cl._fleet.procs)
    prev = obs_trace.current()
    try:
        t0 = time.perf_counter()
        cl.knn_batch(batch[:1], 10)
        t_first = time.perf_counter() - t0
        log(f"  cluster p={p}: {N_HOSTS} spawned workers on {dkey} ({threads} "
            f"CPU threads each), spawn + build {t_build:.1f} s "
            f"({db.shape[0]:,} codes in build frames, {N_SHARDS // N_HOSTS} "
            f"shards a worker); first search {t_first:.1f} s (the workers' "
            f"super indexes)")
        for B in (64, 1):
            for K in (10, 100):
                if B == 64:
                    a_ids, a_sims, _ = eng.knn_batch(batch, K)
                    cl.knn_batch(batch, K)                 # warm
                    ms, (ids, sims, st) = _ms_runs(
                        lambda: cl.knn_batch(batch, K), B)
                else:
                    us = [eng.knn_batch(singles[j:j + 1], K)
                          for j in range(1, 6)]
                    a_ids = np.concatenate([u[0] for u in us])
                    a_sims = np.concatenate([u[1] for u in us])
                    cl.knn_batch(singles[:1], K)           # warm
                    outs, ms_l = [], []
                    for j in range(1, 6):
                        t0 = time.perf_counter()
                        outs.append(cl.knn_batch(singles[j:j + 1], K))
                        ms_l.append((time.perf_counter() - t0) * 1e3)
                    ms = statistics.median(ms_l)
                    ids = np.concatenate([o[0] for o in outs])
                    sims = np.concatenate([o[1] for o in outs])
                    st = outs[-1][2]
                for i in range(ids.shape[0]):
                    if not np.array_equal(np.sort(sims[i]),
                                          np.sort(a_sims[i])):
                        raise AssertionError(
                            f"cluster p={p} B={B} K={K}: row {i}'s sims "
                            "differ from AMIH's")
                exact = same_but_ties(ids, sims, a_ids, a_sims)
                w_ids, w_sims, w_ms = keep["sharded_amih", B, K]
                if not (np.array_equal(ids, w_ids)
                        and np.array_equal(sims, w_sims)):
                    raise AssertionError(
                        f"cluster p={p} B={B} K={K}: ids or sims differ "
                        "from the in-process sharded_amih's")
                scan_note = ""
                if B == 64:
                    for r in range(K_CHECK):
                        _, want = want_topk(r, K)
                        if not np.allclose(sims[r], want, rtol=0, atol=1e-9):
                            raise AssertionError(
                                f"cluster p={p} B={B} K={K}: row {r}'s sims "
                                "differ from the float64 scan's")
                    scan_note = (f", the first {K_CHECK} rows equal to the "
                                 "float64 scan")
                bounds = sum(h["bound_frames"] for h in st.per_host)
                rows.append((f"cluster sharded_amih device walk p={p} B={B} "
                             f"K={K}", ms))
                log(f"  cluster p={p} B={B} K={K}: {ms:.4f} ms/query (median "
                    f"of 5 warm batches; build {t_build:.1f} s) {tag}, "
                    f"in-process sharded_amih {w_ms:.4f}; sims bit-identical "
                    f"to AMIH's as a multiset ({exact}/{ids.shape[0]} rows "
                    f"equal outright, the rest but for ties), ids and sims "
                    f"bit-identical to the in-process sharded_amih"
                    f"{scan_note}; rpc ms by host "
                    f"{[h['rpc_ms'] for h in st.per_host]}, {bounds} bound "
                    f"frames in the last batch")
        tr = obs_trace.Tracer(enabled=True, host="coordinator")
        obs_trace.set_tracer(tr)
        try:
            _, _, st = cl.knn_batch(batch, 10)
        finally:
            obs_trace.set_tracer(prev)
        k2 = {f"host{h}": 0 for h in range(N_HOSTS)}
        for s in tr.snapshot():
            if (s["name"] in ("launch.device_probe",
                              "launch.device_probe.dispatch")
                    and (s.get("args") or {}).get("device") == dkey):
                k2[s.get("host")] = k2.get(s.get("host"), 0) + 1
        if k2 != {f"host{h}": 1 for h in range(N_HOSTS)}:
            raise AssertionError(f"cluster p={p}: K2 launch spans on {dkey} "
                                 f"by lane in one traced B=64 batch: {k2}, "
                                 "expected one per host")
        bails = sum(s.fell_back_to_scan for s in st.per_query)
        for lane, by in sorted(_lane_spans(tr).items()):
            log(f"  cluster spans p={p} B=64 K=10, {lane} (host clock, ms): "
                + ", ".join(f"{name} {ms:.3f}" for name, ms in
                            sorted(by.items(), key=lambda kv: -kv[1])))
        log(f"  cluster p={p}: one traced B=64 batch, K2 launch spans on "
            f"{dkey} by worker lane {k2}; {bails}/64 rows bailed to K3")
    finally:
        obs_trace.set_tracer(prev)
        cl.close()

    # the sharded scan in the workers: one fused K4 call per shard
    cs, t_build_s = _spawn_cluster(p, db, threads,
                                   inner_backend="sharded_scan")
    procs += cs._fleet.procs
    try:
        cs.knn_batch(batch, 10)        # warm: the workers upload their shards
        ms, (ids, sims, _) = _ms_runs(lambda: cs.knn_batch(batch, 10), 64)
    finally:
        cs.close()
    w_ids, w_sims, w_ms = keep["sharded_scan", 64, 10]
    if not (np.array_equal(ids, w_ids) and np.array_equal(sims, w_sims)):
        raise AssertionError(f"cluster sharded_scan p={p}: differs from "
                             "d's sharded_scan (the linear scan)")
    rows.append((f"cluster sharded_scan p={p} B=64 K=10", ms))
    log(f"  cluster sharded_scan p={p} B=64 K=10: {ms:.4f} ms/query (median "
        f"of 5 warm batches; spawn + build {t_build_s:.1f} s) {tag}, "
        f"in-process {w_ms:.4f}; ids and sims bit-identical to the linear "
        f"scan's")
    if any(pr.is_alive() for pr in procs):
        raise AssertionError("phase 3e: a worker process outlived its fleet")

    # the traced 2-worker cluster smoke on the card, and its report
    out_dir.mkdir(parents=True, exist_ok=True)
    trace_path = out_dir / "obs_smoke_trace.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS=str(threads))
    t0 = time.perf_counter()
    smoke = subprocess.run([sys.executable, "-m", "repro_torch.obs.smoke",
                            "--out", str(trace_path)], env=env,
                           capture_output=True, text=True, timeout=300)
    if smoke.returncode != 0:
        raise AssertionError(f"repro_torch.obs.smoke failed:\n"
                             f"{smoke.stdout}\n{smoke.stderr}")
    report = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                             str(trace_path), "--min-hosts", "2",
                             "--min-stages", "4"], env=env,
                            capture_output=True, text=True, timeout=120)
    if report.returncode != 0:
        raise AssertionError(f"repro_torch.obs.report refused the smoke's "
                             f"trace:\n{report.stdout}\n{report.stderr}")
    doc = load_chrome_trace(str(trace_path))
    summary = summarize(doc)
    lanes = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M"}
    on_card = {lanes[e["pid"]] for e in doc["traceEvents"]
               if e["ph"] == "X" and e["name"].startswith("launch.")
               and (e.get("args") or {}).get("device") == dkey}
    if on_card != {"host0", "host1"}:
        raise AssertionError(f"obs smoke trace: launch spans on {dkey} in "
                             f"lanes {sorted(on_card)}, not both workers")
    log(f"  obs smoke on the card: {smoke.stdout.strip().splitlines()[-1]}; "
        f"report (floors 2 hosts, 4 stages) passed: "
        f"{len(summary['hosts'])} hosts, {len(summary['stages'])} stages, "
        f"wall {summary['wall_ms']:.3f} ms, launch.* spans on {dkey} in "
        f"both worker lanes; {time.perf_counter() - t0:.1f} s")
    leftover = multiprocessing.active_children()
    if leftover:
        raise AssertionError(f"phase 3e left child processes {leftover}")
    log(f"  phase 3e p={p}: {time.perf_counter() - t_phase:.1f} s")
    return k2


# ------------------------------------------------------------------- K7
# Dense rates of one H100 SXM for the K7 bound (NVIDIA's data sheet): bf16
# on the tensor cores, float32 on the CUDA cores.
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

# (B, Sq, Sk, Hq, Hkv, D, causal, window, valid_len): MHA, GQA and MQA,
# causal or not, windows 8, 16, 24 and 64, valid_len in {0, 1, 37, 100,
# 160}, ragged Sq and Sk (100, 130, 160), D in {32, 64, 128, 256} and
# between them (the reference configs' tiny 16, 48, kimi-k2's 112, and 20,
# which the bf16 path pads to 24 for TMA), D = 320 and 512 above them
# (256-column chunks and output slices), G in {1, 2, 3, 4, 5, 7, 8, 96}
# (G = 3: 64-row tiles that straddle a head group; G = 5 and 7, hymba's
# and arctic's: tiles of 60 and 63 live rows, windowed causal and with
# valid_len; G = 96: two head tiles); llava-next-34b's operands, its
# prefill (8 x 676 positions, G = 7) and decode (700 of 708 keys valid),
# and the same under its optimized profile (G = 8)
FLASH_CASES = [
    (2, 128, 128, 8, 8, 64, True, 0, None),
    (2, 128, 128, 8, 2, 128, False, 0, None),
    (2, 128, 128, 8, 1, 256, True, 0, None),
    (2, 100, 100, 8, 1, 256, True, 0, None),
    (1, 160, 160, 4, 4, 64, True, 16, None),
    (1, 160, 160, 8, 2, 128, True, 64, None),
    (2, 1, 160, 8, 1, 256, False, 0, 1),
    (2, 1, 160, 8, 2, 128, False, 0, 37),
    (2, 1, 160, 8, 1, 64, False, 16, 100),
    (2, 4, 160, 8, 1, 256, False, 0, 160),
    (2, 130, 130, 8, 1, 256, True, 0, None),
    (1, 4, 160, 8, 1, 256, False, 0, 0),
    (1, 130, 160, 4, 1, 128, True, 8, None),
    (1, 100, 130, 8, 1, 256, False, 24, None),
    (1, 37, 50, 6, 2, 32, True, 0, None),
    (2, 128, 128, 8, 2, 16, True, 0, None),
    (1, 130, 160, 4, 1, 48, False, 24, None),
    (2, 128, 128, 8, 1, 112, True, 0, None),
    (2, 1, 160, 8, 2, 112, False, 0, 37),
    (1, 100, 100, 4, 2, 20, True, 16, None),
    (2, 100, 130, 4, 1, 320, True, 0, None),
    (1, 160, 160, 2, 2, 512, False, 24, None),
    (2, 1, 160, 4, 1, 512, False, 0, 37),
    (2, 100, 100, 96, 1, 64, True, 0, None),
    (1, 4, 160, 96, 1, 256, False, 16, 100),
    (2, 160, 160, 10, 2, 64, True, 64, None),
    (2, 1, 160, 5, 1, 64, False, 0, 100),
    (2, 130, 130, 14, 2, 128, True, 24, None),
    (2, 1, 160, 7, 1, 128, False, 0, 160),
    (8, 676, 676, 56, 8, 128, True, 0, None),
    (8, 1, 708, 56, 8, 128, False, 0, 700),
    (8, 676, 676, 64, 8, 128, True, 0, None),
    (8, 1, 708, 64, 8, 128, False, 0, 700),
]


def check_flash_build(_build):
    """Phase 1: K7's registers, static shared memory and spill bytes per
    instantiation from the build's ptxas report, and its HGMMA
    instructions; raises if a bf16 instantiation spills or the library
    holds no HGMMA (its bf16 path would not run on the tensor cores)."""
    import re

    rep = _build.ptxas_report("flash_attention")
    bf16 = {}
    for fn, r in sorted(rep.items()):
        m = re.search(r"flash_attention_(bf16_kernelI|kernelIf)Li(\d+)E", fn)
        if not m:
            continue
        kind = "bf16" if m.group(1).startswith("bf16") else "float32"
        log(f"    K7 {kind} D={m.group(2)}: {r['registers']} registers, "
            f"{r['smem']} bytes static smem, {r['spill']} bytes spilled")
        if kind == "bf16":
            bf16[int(m.group(2))] = r
    if len(bf16) != 4 or any(r["spill"] for r in bf16.values()):
        raise AssertionError(f"K7's bf16 instantiations: {bf16} (want four, "
                             "none spilling)")
    code = _build.sass("flash_attention")
    if code is None:
        raise AssertionError("no cuobjdump to read K7's SASS")
    n = sum("HGMMA" in ln for ln in code.splitlines())
    if n == 0:
        raise AssertionError("K7's library holds no HGMMA instruction")
    serial = (_build.build_log("flash_attention") or "").count("C7520")
    log(f"    K7: {n} HGMMA instructions in its SASS; {serial} ptxas notes "
        f"of serialized wgmma (C7520)")


def flash_err(fa, got, q, k, v, kw):
    """Largest difference of K7's output from its plain version computed
    in float32 on the same inputs; raises beyond the tolerance: 2e-5 for
    float32 inputs (sums in other orders), and for bf16 inputs
    4e-3 * max(1, |plain|) elementwise (rounding to bf16 moves a value by
    at most 2^-9 of it, below 1 by at most 2^-9, plus that slack)."""
    import torch

    want = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    d = (got.float() - want).abs()
    if got.dtype == torch.float32:
        bad = d > 2e-5
    else:
        bad = d > 4e-3 * torch.clamp(want.abs(), min=1.0)
    if bool(bad.any()):
        raise AssertionError(f"K7 differs from its plain version by "
                             f"{float(d.max())} ({got.dtype}, {kw})")
    return float(d.max())


def check_flash_cases(fa, torch, dev):
    """Phase 2: K7 against its plain version on ``FLASH_CASES``, float32
    and bf16, v drawn from [-1, 1). Returns the largest difference by
    dtype."""
    worst = {}
    saved = dict(fa.LAUNCHES)
    g = torch.Generator(device=dev).manual_seed(SEED)
    for (B, Sq, Sk, Hq, Hkv, D, causal, window, vl) in FLASH_CASES:
        kw = {"causal": causal, "window": window, "valid_len": vl}
        q = torch.randn((B, Sq, Hq, D), generator=g, device=dev)
        k = torch.randn((B, Sk, Hkv, D), generator=g, device=dev)
        v = torch.rand((B, Sk, Hkv, D), generator=g, device=dev) * 2 - 1
        for dt in (torch.float32, torch.bfloat16):
            qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
            got = fa.flash_attention(qd, kd, vd, **kw)
            torch.cuda.synchronize()
            name = str(dt).split(".")[-1]
            worst[name] = max(worst.get(name, 0.0),
                              flash_err(fa, got, qd, kd, vd, kw))
    fa.LAUNCHES.update(saved)                 # comparisons do not count
    return worst


def flash_bound_ms(q, k, kw):
    """Least time of one K7 call: q, k and v read once (with
    ``valid_len``, only the valid key slots) and the output written once at
    the memory rate, or the QK^T and PV multiply-adds of the (query, key)
    pairs the masks keep at the dense rate of the input type, whichever
    takes longest (``flash_count``'s work)."""
    import torch

    flops, nbytes = flash_count(q, k, kw)
    rate = BF16_TENSOR_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def flash_count(q, k, kw):
    """(FLOPs, bytes) of one K7 call: 4 D FLOPs a (batch, query head) over
    the (query, key) pairs the masks keep, and q, k, v (with
    ``valid_len``, their valid key slots) and the output moved once."""
    import numpy as np

    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if kw.get("valid_len") is not None:
        ok &= kp < kw["valid_len"]
        if kw.get("window", 0) > 0:
            ok &= kp >= kw["valid_len"] - kw["window"]
    if kw.get("causal"):
        ok &= qp >= kp
    if kw.get("window", 0) > 0 and kw.get("valid_len") is None:
        ok &= qp - kp < kw["window"]
    flops = 4.0 * D * B * Hq * int(ok.sum())
    keys = k.numel()
    if kw.get("valid_len") is not None:
        keys = keys // Sk * min(Sk, kw["valid_len"])
    return flops, (2 * q.numel() + 2 * keys) * q.element_size()


def check_flash_call(fa, a, kw, reps=20):
    """Phase 4: K7 on one main-path call's operands: its difference from
    the plain version (both in the call's dtype, and checked against the
    plain version in float32), CUDA-event times of K7 and of
    ``scaled_dot_product_attention`` (the library call, on views of the
    same tensors; with ``valid_len``, of the valid key slots), the plain
    version's host-clock time around one call, and the bound."""
    import torch
    import torch.nn.functional as F

    q, k, v = a
    saved = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    flash_err(fa, got, q, k, v, kw)
    plain = fa.flash_attention_plain(q, k, v, **kw)
    entry = {"max_abs_err": float((got.float() - plain.float()).abs().max())}
    entry["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), reps)
    t0 = time.perf_counter()
    fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    entry["plain_ms"] = (time.perf_counter() - t0) * 1e3
    vl = kw.get("valid_len")
    window = kw.get("window", 0)
    if vl is not None and (window or kw.get("causal")):
        raise AssertionError("the library yardstick takes no window and no "
                             "causal mask beside valid_len")
    kv = (k, v) if vl is None else (k[:, :vl], v[:, :vl])
    mask = None
    if window:
        # a sliding window: SDPA with the same (Sq, Sk) boolean mask
        qp = torch.arange(q.shape[1], device=q.device)[:, None]
        kp = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = qp - kp < window
        if kw.get("causal"):
            mask &= qp >= kp

    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kv[0].transpose(1, 2), kv[1].transpose(1, 2),
            attn_mask=mask, is_causal=mask is None and bool(kw.get("causal")),
            enable_gqa=True)

    lib = sdpa().transpose(1, 2)
    entry["library_diff"] = float((lib.float() - plain.float()).abs().max())
    entry["library_ms"] = cuda_ms(sdpa, reps)
    entry["bound_ms"], entry["bound_by"] = flash_bound_ms(q, k, kw)
    entry["shape"] = (f"q {tuple(q.shape)}, k/v {tuple(k.shape)} {q.dtype}, "
                      f"{kw}")
    fa.LAUNCHES.update(saved)                 # comparisons do not count
    return entry


# ------------------------------------------------------- retrieval serving
N_DOCS = 8192          # corpus documents
DOC_LEN = 128          # tokens per document
N_TOPICS = 256         # topics of the synthetic corpus
TOPIC_VOCAB = 512      # token ids per topic


def topic_docs(rng, topics, n):
    """``n`` documents of ``DOC_LEN`` tokens, each drawn from one of
    ``topics`` (N_TOPICS rows of TOPIC_VOCAB token ids)."""
    t = rng.integers(0, N_TOPICS, n)
    cols = rng.integers(0, TOPIC_VOCAB, (n, DOC_LEN))
    return topics[t[:, None], cols].astype("int32")


def retrieval_path(dev, tag, zero_counts):
    """Phase 3c: retrieval serving at the encoder's full width (see the
    module docstring). Returns its measurements and K7's main-path call."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.engine import make_engine
    from repro_torch.core.linear_scan import (
        sims_against_db,
        sims_for_ids,
        topk_from_sims,
    )
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.models import Model
    from repro_torch.models import layers as layers_mod
    from repro_torch.obs import trace
    from repro_torch.serve import RetrievalConfig, RetrievalService

    cfg = get_config("gemma_2b")
    t0 = time.perf_counter()
    params = Model(cfg).init_params(SEED, device=dev)
    torch.cuda.synchronize()
    log(f"  gemma-2b at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}x{cfg.head_dim_} q heads over "
        f"{cfg.n_kv_heads} kv head, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size:,}): {cfg.param_count():,} params, "
        f"{cfg.param_dtype} (compute {cfg.compute_dtype}), init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")

    # topic-structured documents: each draws its tokens from one topic
    rng = np.random.default_rng(SEED)
    topics = rng.integers(1, cfg.vocab_size, (N_TOPICS, TOPIC_VOCAB))

    def draw(n):
        return topic_docs(rng, topics, n)

    docs = draw(N_DOCS)
    held = draw(64)                                   # held-out queries
    self_ids = np.sort(rng.choice(N_DOCS, 32, replace=False))
    selfq = docs[self_ids]                            # self-queries

    svc = RetrievalService(cfg, params, RetrievalConfig(
        code_bits=64, batch_size=32, search_batch_size=64))
    pooled = svc._pooled
    batches = [0]

    def counted_pooled(tokens):
        batches[0] += 1
        return pooled(tokens)

    svc._pooled = counted_pooled
    res = {}
    zero_counts()
    with Recorder([(layers_mod, "flash_attention")]) as frec:
        tr = trace.enable()
        try:
            info = svc.build_index(docs)
        finally:
            trace.disable()
        built = {s["name"]: s["dur"] / 1e6 for s in tr.drain()
                 if s["name"].startswith("retrieval.")}
        res["encode_s"] = built["retrieval.encode"]
        res["aqbc_s"] = built["retrieval.aqbc"]
        res["index_s"] = built["retrieval.index"]
        distinct = len(np.unique(svc.db_words, axis=0))
        log(f"  build: {N_DOCS:,} docs x {DOC_LEN} tokens, encode "
            f"{res['encode_s']:.2f} s ({res['encode_s'] * 1e3 / N_DOCS:.4f} "
            f"ms/doc, {N_DOCS * DOC_LEN / res['encode_s']:,.0f} tokens/s), "
            f"AQBC learn {res['aqbc_s']:.3f} s ({svc.rcfg.aqbc_iters} iters, "
            f"objective {info['aqbc_objective']:.4f}), index "
            f"{res['index_s']:.3f} s (AMIH m={info['m_tables']:.0f}) {tag}")
        log(f"  {distinct:,} distinct codes among {N_DOCS:,}"
            + ("" if distinct > N_DOCS // 100 else
               " (the codes collapse: the reference's AQBC on the random "
               "encoder's pooled states)"))

        svc.search_batch(held, 10)                    # warm
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            ids, sims, _ = svc.search_batch(held, 10)
            ms.append((time.perf_counter() - t0) * 1e3 / 64)
        res["ms_b64"] = statistics.median(ms)
        svc.search_batch(held[:1], 10)                # warm
        ms, singles = [], []
        for j in range(1, 6):
            t0 = time.perf_counter()
            singles.append(svc.search_batch(held[j:j + 1], 10))
            ms.append((time.perf_counter() - t0) * 1e3)
        res["ms_b1"] = statistics.median(ms)
        log(f"  search_batch K=10: B=64 {res['ms_b64']:.4f} ms/query, B=1 "
            f"{res['ms_b1']:.4f} ms/query (median of 5 warm batches, "
            f"encoding included) {tag}")

        # (a) exact against the float64 linear scan over the same codes
        qcodes = svc.encode_query(held)
        want = [topk_from_sims(sims_against_db(qc, svc.db_words), 10)
                for qc in qcodes]
        exact = same_but_ties(ids, sims, np.stack([w[0] for w in want]),
                              np.stack([w[1] for w in want]))
        exact1 = same_but_ties(
            np.stack([s[0][0] for s in singles]),
            np.stack([s[1][0] for s in singles]),
            np.stack([w[0] for w in want[1:6]]),
            np.stack([w[1] for w in want[1:6]]))
        ordered = int(np.sum(sims[:, 0] > sims[:, -1]))
        # (b) every self-query tops at its own code
        s_ids, s_sims, _ = svc.search_batch(selfq, 10)
        scodes = svc.encode_query(selfq)
        at_one = 0
        for j, i in enumerate(self_ids):
            own = sims_for_ids(scodes[j], svc.db_words, np.array([i]))[0]
            if not (own >= 1 - 1e-12 and s_sims[j, 0] == own):
                raise AssertionError(f"self-query {i} does not top at its "
                                     f"own code ({s_sims[j, 0]} vs {own})")
            at_one += int(own == 1.0)
        # (c) two streamed steps equal search_batch
        tickets = [svc.submit(q) for q in np.concatenate([held, selfq])]
        steps = list(svc.run_queued(k=10, stream=True))
        if len(steps) != 2:
            raise AssertionError(f"{len(steps)} streamed steps, expected 2")
        for sr, (w_ids, w_sims) in zip(steps, ((ids, sims),
                                               (s_ids, s_sims))):
            if not (np.array_equal(sr.ids, w_ids)
                    and np.array_equal(sr.sims, w_sims)):
                raise AssertionError(f"streamed step {sr.step} differs from "
                                     "search_batch")
        if not all(t.future.done() for t in tickets):
            raise AssertionError("a streamed ticket was left unresolved")
    n_batches = batches[0]
    k7 = fa.LAUNCHES["flash_attention"]
    if k7 != cfg.n_layers * n_batches:
        raise AssertionError(f"{k7} K7 launches for {n_batches} encoder "
                             f"batches of {cfg.n_layers} layers")
    res["launches"] = k7
    res["encoder_batches"] = n_batches
    # (d) the linear scan on the same codes equals AMIH but for ties
    lin = make_engine("linear_scan", svc.db_words, 64)
    l_ids, l_sims, _ = lin.knn_batch(qcodes, 10)
    exact_lin = same_but_ties(l_ids, l_sims, ids, sims)
    # (e) pooled embeddings through K7 against K7's plain version
    saved = dict(fa.LAUNCHES)
    tok = torch.from_numpy(docs[:32].astype(np.int64)).to(dev)
    with torch.no_grad():
        with_k7 = pooled(tok)
        layers_mod.flash_attention = fa.flash_attention_plain
        try:
            with_plain = pooled(tok)
        finally:
            layers_mod.flash_attention = fa.flash_attention
    diff = float((with_k7 - with_plain).abs().max())
    scale = float(with_plain.abs().max())
    if not diff <= 2 ** -7 * max(1.0, scale):
        raise AssertionError(f"pooled embeddings through K7 differ from the "
                             f"plain version's by {diff} (largest {scale})")
    log(f"  checks: {exact}/64 B=64 rows and {exact1}/5 B=1 rows equal to "
        f"the float64 linear scan over the service's codes, the rest but "
        f"for ids inside equal-cosine ties; {ordered}/64 B=64 rows decided "
        f"by order (the 10th sim below the first), the rest one all-tied "
        f"group; 32/32 self-queries top at their own code ({at_one} at "
        f"exactly 1.0, the rest 1 - 2^-53: Eq. 3 in float64); 2 streamed "
        f"steps equal to search_batch; linear_scan on the same codes equal "
        f"to AMIH on {exact_lin}/64 rows, the rest but for ties; pooled "
        f"embeddings of one batch through K7 within {diff:.3g} of the plain "
        f"version's (bound {2 ** -7 * max(1.0, scale):.3g}: one bf16 step "
        f"of the largest, {scale:.3g}); K7 launches {k7} = "
        f"{cfg.n_layers} layers x {n_batches} encoder batches")
    res.update(distinct=distinct, exact=exact, ordered=ordered,
               pooled_diff=diff)

    rows = profile_batch(lambda: pooled(tok), "encode_gemma2b_B32",
                         ROOT / "chiprun_out", expect=("flash_attention",))
    fa.LAUNCHES.update(saved)                 # comparisons do not count
    k7_ms = sum(dt for dt, _, key in rows if "flash_attention" in key)
    gemm_ms = sum(dt for dt, _, key in rows
                  if any(w in key.lower() for w in
                         ("gemm", "nvjet", "xmma", "cutlass", "cublas")))
    res.update(k7_ms=k7_ms, gemm_ms=gemm_ms)
    log(f"  one encoder batch (32 x {DOC_LEN} tokens): K7 {k7_ms:.4f} ms "
        f"({cfg.n_layers} launches) against GEMMs {gemm_ms:.4f} ms of card "
        f"time {tag}")
    (a, kw), = frec.calls["flash_attention"]
    svc.close()
    del svc, params, pooled
    return res, (a, kw)


# ----------------------------------------------------------- token serving
SERVE_CFG = dict(max_batch=8, max_seq=256, max_new_tokens=32)
SERVE_REQUESTS = 16      # greedy requests, prompts of 16 to 128 tokens
TEACHER_FORCED = 2       # requests held against the causal forward
ONE_AT_A_TIME = 4        # requests served again with max_batch = 1
# TIE_TOL = TIE_FACTOR x the largest |decode logit - forward logit| this
# run measures on the teacher-forced requests: where a row's top-2 margin
# exceeds twice the gap between two computations, both take the same
# argmax; the second factor of 2 covers the one-at-a-time run's own gap,
# which comes from other GEMM shapes of the same bf16 operands
TIE_FACTOR = 4.0
# the gap itself may be at most 2^-4 of the largest forward logit (eight
# or more bf16 steps of it): K/V of a wrong slot or a stale row moves the
# logits by the size of the logits themselves
GAP_BOUND = 2.0 ** -4


# the same gap with float32 compute, where decode and forward differ by
# float32 rounding only, may be at most 2^-10 of the largest logit: it
# decides the tokens whose bf16 margins fall within the bf16 gap (a
# random-init llama3-8b's logits span < 1, and its bf16 gap is ~5% of
# the largest)
GAP_BOUND_F32 = 2.0 ** -10


def teacher_forced(model, params, prompt, toks, rows, bound, dev):
    """One request's greedy tokens ``toks`` against the causal forward of
    ``model`` over the prompt and the tokens: the decode logits ``rows``
    (one per token) within ``bound`` x the largest forward logit, and each
    token the forward's argmax wherever its top-2 margin exceeds
    ``TIE_FACTOR`` x the measured gap. Returns (gap, scale, margin-limited
    tokens)."""
    import numpy as np
    import torch

    with torch.no_grad():
        seq = np.concatenate([prompt, toks[:-1]])
        logits, _ = model.forward(params, {"tokens": seq[None]}, device=dev)
        f = logits[0, len(prompt) - 1:].cpu().numpy()
        del logits
    gap = float(np.abs(np.stack(rows) - f).max())
    scale = float(np.abs(f).max())
    if not gap <= bound * scale:
        raise AssertionError(f"{model.cfg.name} ({model.cfg.compute_dtype}): "
                             f"decode logits differ from the causal "
                             f"forward's by {gap} (largest logit {scale})")
    limited = 0
    for j, tok in enumerate(toks):
        if top2_margin(f[j]) <= TIE_FACTOR * gap:
            limited += 1
        elif tok != int(np.argmax(f[j])):
            raise AssertionError(f"{model.cfg.name} token {j}: {tok}, the "
                                 f"forward's argmax {int(np.argmax(f[j]))}")
    return gap, scale, limited


def top2_margin(row):
    """The largest logit of a row minus the second largest."""
    import numpy as np

    a, b = np.partition(row, -2)[-2:]
    return float(b - a)


def _k7_capture(fa, calls, kinds=None, counts=None):
    """A stand-in for ``models.layers.flash_attention`` that keeps copies
    of the operands of the decode call with the most valid keys, the
    longest prefill, and (``kinds`` = {"train"}) the first call, then
    calls K7 as the layer would; ``counts`` (a dict) tallies the calls by
    kind."""

    def capture(q, k, v, **kw):
        if kinds and "train" in kinds:
            kind, size = "train", 1
        else:
            kind = "prefill" if kw.get("valid_len") is None else "decode"
            size = q.shape[1] if kind == "prefill" else kw["valid_len"]
        if counts is not None:
            counts[kind] = counts.get(kind, 0) + 1
        if size > calls.get(kind, (0,))[0]:
            calls[kind] = (size, tuple(t.detach().clone() for t in (q, k, v)),
                           dict(kw))
        return fa.flash_attention(q, k, v, **kw)

    return capture


def serve_path(dev, tag, zero_counts, arch="gemma_2b", label="3f",
               layers=None, cli=True):
    """Phase 3f (gemma-2b), 3h (llama3-8b), 3m (mamba2-1.3b) or 3n (a)
    (hymba-1.5b, its K/V cache a ring of min(max_seq, 2,048) slots): token
    serving at the architecture's full width and depth through
    ``ServeEngine`` (see the module docstring); ``layers`` cuts the depth,
    and ``cli`` runs the tiny CLI in a process of its own at the end.
    Returns its measurements and K7's main-path decode and prefill calls
    (none for the SSM, which runs no attention)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.models import Model
    from repro_torch.models import layers as layers_mod
    from repro_torch.models.common import ShapeConfig
    from repro_torch.serve import ServeConfig, ServeEngine

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    model = Model(cfg)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()      # what earlier phases keep
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(SEED, device=dev)
    torch.cuda.synchronize()
    log(f"  {cfg.name} at full width, {cfg.n_layers} of "
        f"{get_config(arch).n_layers} layers ({cfg.param_count():,} float32 "
        f"parameters), random weights from "
        f"seed {SEED}: init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    rng = np.random.default_rng(SEED)           # phase 3c's corpus
    topics = rng.integers(1, cfg.vocab_size, (N_TOPICS, TOPIC_VOCAB))
    docs = topic_docs(rng, topics, SERVE_REQUESTS)
    lens = np.random.default_rng(SEED + 1).integers(16, DOC_LEN + 1,
                                                    SERVE_REQUESTS)
    prompts = [docs[i, :n] for i, n in enumerate(lens)]
    checked = max(TEACHER_FORCED, ONE_AT_A_TIME)

    def instrument(eng, rows, prefill_ms=None, step_ms=None):
        """Record the logits rows of requests < ``checked`` and, where
        given, host-clock ms of each prefill (by prompt length) and each
        decode step (by group size); each ends in a host copy."""
        prefill, step, decode = (eng._prefill_into_slot, eng._step,
                                 eng._decode)
        choose = eng._select_token
        group = [0]

        def select(row, slot):
            rid = eng.slot_req[slot].rid
            if rid < checked:
                rows.setdefault(rid, []).append(np.array(row).reshape(-1))
            return choose(row, slot)

        def timed_prefill(slot, req):
            t0 = time.perf_counter()
            prefill(slot, req)
            prefill_ms.append((len(req.prompt),
                               (time.perf_counter() - t0) * 1e3))

        def counted_decode(tokens, pos, mask):
            group[0] = int(mask.sum())
            return decode(tokens, pos, mask)

        def timed_step():
            group[0] = 0
            t0 = time.perf_counter()
            step()
            if group[0]:
                step_ms.append((group[0], (time.perf_counter() - t0) * 1e3))

        eng._select_token = select
        if prefill_ms is not None:
            eng._prefill_into_slot = timed_prefill
            eng._decode = counted_decode
            eng._step = timed_step

    # K7's operands on this path, for phase 4: the decode call with the
    # most valid keys and the longest prefill (copies: the cache moves on)
    calls = {}
    eng = ServeEngine(cfg, params, ServeConfig(**SERVE_CFG, device=dev))
    rows, prefill_ms, step_ms = {}, [], []
    instrument(eng, rows, prefill_ms, step_ms)
    zero_counts()
    layers_mod.flash_attention = _k7_capture(fa, calls)
    try:
        for pr in prompts:
            eng.submit(pr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = eng.run_until_drained()
        wall = time.perf_counter() - t0
    finally:
        layers_mod.flash_attention = fa.flash_attention
    st = eng.stats
    k7 = fa.LAUNCHES["flash_attention"]
    k7_layers = 0 if cfg.family == "ssm" else cfg.n_layers
    if k7 != k7_layers * (st["prefills"] + st["decode_steps"]):
        raise AssertionError(f"{k7} K7 launches for {st['prefills']} "
                             f"prefills and {st['decode_steps']} decode "
                             f"steps of {k7_layers} attention layers")
    if sorted(results) != list(range(SERVE_REQUESTS)) or any(
            len(t) != SERVE_CFG["max_new_tokens"] for t in results.values()):
        raise AssertionError("the engine did not serve every request in full")
    res = {"launches": k7, "wall_s": wall, "tokens_s": st["tokens_out"] / wall,
           **st}
    groups = [g for g, _ in step_ms]
    big = max(groups)
    res["step_ms"] = statistics.median(ms for _, ms in step_ms)
    res["step_ms_big"] = statistics.median(ms for g, ms in step_ms if g == big)
    res["group_big"] = big
    res["prefill_ms"] = sorted(prefill_ms)
    log(f"  served {SERVE_REQUESTS} greedy requests (prompts "
        f"{min(lens)}-{max(lens)} tokens, {SERVE_CFG}) in {wall:.2f} s: "
        f"{st['tokens_out']} tokens, {res['tokens_s']:.1f} tokens/s; "
        f"{st['prefills']} prefills, {st['decode_steps']} decode steps "
        f"(group sizes {dict(sorted((g, groups.count(g)) for g in set(groups)))}); "
        f"K7 launches {k7} = {k7_layers} attention layers x "
        f"({st['prefills']} + {st['decode_steps']}) {tag}")
    log("  prefill ms by prompt length (host clock, B = 1, to the chosen "
        "token): " + ", ".join(f"{n}: {ms:.2f}" for n, ms in res["prefill_ms"])
        + f" {tag}")
    log(f"  decode step (B = {SERVE_CFG['max_batch']} rows on the card, host "
        f"clock to the chosen tokens): median {res['step_ms']:.3f} ms over "
        f"{len(step_ms)} steps, {res['step_ms_big']:.3f} ms at the largest "
        f"group ({big} rows) {tag}")

    # teacher-forced: each greedy token is the argmax of the causal
    # forward's logits at its position, where that margin is not a tie
    fwd, gap, scale = {}, 0.0, 0.0
    with torch.no_grad():
        for rid in range(TEACHER_FORCED):
            seq = np.concatenate([prompts[rid], results[rid][:-1]])
            logits, _ = model.forward(params, {"tokens": seq[None]},
                                      device=dev)
            f = logits[0, len(prompts[rid]) - 1:].cpu().numpy()
            del logits
            fwd[rid] = f
            gap = max(gap, float(np.abs(np.stack(rows[rid]) - f).max()))
            scale = max(scale, float(np.abs(f).max()))
    tie_tol = TIE_FACTOR * gap
    if not gap <= GAP_BOUND * scale:
        raise AssertionError(f"decode logits differ from the causal "
                             f"forward's by {gap} (largest logit {scale})")
    limited = 0
    for rid in range(TEACHER_FORCED):
        for j, tok in enumerate(results[rid]):
            if top2_margin(fwd[rid][j]) <= tie_tol:
                limited += 1
            elif tok != int(np.argmax(fwd[rid][j])):
                raise AssertionError(f"request {rid} token {j}: {tok}, the "
                                     f"forward's argmax "
                                     f"{int(np.argmax(fwd[rid][j]))}")
    del fwd
    n_tf = TEACHER_FORCED * SERVE_CFG["max_new_tokens"]
    res.update(gap=gap, tie_tol=tie_tol, scale=scale, limited=limited)
    log(f"  teacher-forced ({TEACHER_FORCED} requests, {n_tf} tokens): "
        f"decode logits within {gap:.4g} of the causal forward's (largest "
        f"logit {scale:.4g}; bound {GAP_BOUND * scale:.4g}); tie tolerance "
        f"{TIE_FACTOR:g} x {gap:.4g} = {tie_tol:.4g}; every token the "
        f"forward's argmax, {limited}/{n_tf} steps margin-limited")

    # the same requests through an engine computing in float32 (the same
    # parameters, K7's float32 path), held against the float32 forward
    f32 = Model(cfg.replace(compute_dtype="float32"))
    eng32 = ServeEngine(f32.cfg, params, ServeConfig(**SERVE_CFG, device=dev))
    rows32 = {}
    instrument(eng32, rows32)
    for pr in prompts[:TEACHER_FORCED]:
        eng32.submit(pr)
    served32 = eng32.run_until_drained()
    del eng32
    gap32 = scale32 = 0.0
    limited32 = 0
    for rid in range(TEACHER_FORCED):
        g, sc, lim = teacher_forced(f32, params, prompts[rid], served32[rid],
                                    rows32[rid], GAP_BOUND_F32, dev)
        gap32, scale32 = max(gap32, g), max(scale32, sc)
        limited32 += lim
    res.update(gap32=gap32, limited32=limited32)
    log(f"  float32 compute, teacher-forced ({TEACHER_FORCED} requests, "
        f"{n_tf} tokens): decode logits within {gap32:.4g} of the float32 "
        f"forward's (largest logit {scale32:.4g}; bound "
        f"{GAP_BOUND_F32 * scale32:.4g}); every token the forward's argmax, "
        f"{limited32}/{n_tf} steps margin-limited (tie tolerance "
        f"{TIE_FACTOR:g} x {gap32:.4g})")

    # one at a time: the same tokens up to the first margin-limited step
    solo = ServeEngine(cfg, params, ServeConfig(
        **dict(SERVE_CFG, max_batch=1), device=dev))
    solo_rows = {}
    instrument(solo, solo_rows)
    for pr in prompts[:ONE_AT_A_TIME]:
        solo.submit(pr)
    alone = solo.run_until_drained()
    same, cut, gap1 = 0, 0, 0.0
    for rid in range(ONE_AT_A_TIME):
        a, b = results[rid], alone[rid]
        diff = next((j for j in range(len(a)) if a[j] != b[j]), len(a))
        tie = next((j for j, r in enumerate(rows[rid])
                    if top2_margin(r) <= tie_tol), len(a))
        if diff < tie:
            raise AssertionError(f"request {rid}: batch of 8 and one at a "
                                 f"time differ at token {diff}, margin "
                                 f"{top2_margin(rows[rid][diff])} > "
                                 f"{tie_tol}")
        same += diff == len(a)
        cut += tie < len(a)
        for j in range(min(diff + 1, len(a))):
            gap1 = max(gap1, float(np.abs(rows[rid][j]
                                          - solo_rows[rid][j]).max()))
    res.update(solo_same=same, solo_gap=gap1)
    log(f"  one at a time (max_batch=1, {ONE_AT_A_TIME} requests, "
        f"{solo.stats['decode_steps']} decode steps): {same}/"
        f"{ONE_AT_A_TIME} identical, {cut} compared up to a margin-limited "
        f"step; logits within {gap1:.4g} of the batch's where the inputs "
        f"agree")
    del solo, solo_rows

    # one profiled engine decode step, all 8 rows at one position
    saved = dict(fa.LAUNCHES)
    B = SERVE_CFG["max_batch"]
    toks = np.array([[results[i][-1]] for i in range(B)], np.int32)
    every = np.ones(B, bool)
    pos = SERVE_CFG["max_seq"] // 2
    with torch.no_grad():
        prof, peak, before = step_peak(lambda: profile_batch(
            lambda: eng._decode(toks, pos, every).float().cpu(),
            f"decode_{arch}_B8", ROOT / "chiprun_out",
            expect=("flash_attention",) if k7_layers else ()))
        head = params["embed" if cfg.tie_embeddings else "unembed"]
        head_cast = cuda_ms(lambda: head.to(torch.bfloat16), 5)
    fa.LAUNCHES.update(saved)                 # measurements do not count

    def card_ms(words):
        return sum(dt for dt, _, key in prof
                   if any(w in key.lower() for w in words))

    res.update(prof_k7=card_ms(("flash_attention",)),
               prof_gemm=card_ms(("gemm", "gemv", "nvjet", "xmma", "cutlass",
                                  "cublas", "splitk")),
               prof_copy=card_ms(("copy",)), head_cast_ms=head_cast,
               prof_busy=sum(dt for dt, _, _ in prof))
    n_w = cfg.param_count()
    log(f"  one decode step at B = {B}, pos {pos}: K7 {res['prof_k7']:.4f} "
        f"ms ({k7_layers} launches), GEMMs {res['prof_gemm']:.4f} ms, "
        f"copies (the float32-to-bf16 weight casts) {res['prof_copy']:.4f} "
        f"ms, of {res['prof_busy']:.4f} ms card busy; the LM head's "
        f"weight cast alone {head_cast:.4f} ms; a step reads "
        f"{n_w * 4 / 1e9:.2f} GB of float32 weights, writes and re-reads "
        f"{n_w * 2 / 1e9:.2f} GB of casts: {n_w * 8 / HBM_BYTES_PER_S * 1e3:.2f}"
        f" ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s ({n_w * 2 / HBM_BYTES_PER_S * 1e3:.2f}"
        f" ms for resident bf16 weights) {tag}")
    res["roofline"] = roofline_check(
        f"{label} {cfg.name} decode step", cfg,
        ShapeConfig(label, SERVE_CFG["max_seq"], B, "decode"),
        res["prof_busy"], peak, held, tag, pos=pos)

    # the tiny CLI on the card, in a process of its own
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         arch, "--tiny", "--requests", "4"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"))) if cli else None
    if out and out.returncode:
        raise AssertionError(f"python -m repro_torch.launch.serve --tiny "
                             f"exited {out.returncode}: {out.stderr[-2000:]}")
    if out:
        log(f"  python -m repro_torch.launch.serve --arch {arch} --tiny "
            f"--requests 4 on the card: {out.stdout.strip()} "
            f"({time.perf_counter() - t0:.1f} s with the interpreter's "
            f"start)")
    del eng, params, head
    res["peak_gb"] = (max(before, torch.cuda.max_memory_allocated())
                      - held) / 1e9
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase {label}: {res['phase_s']:.1f} s; peak allocated "
        f"{res['peak_gb']:.2f} GB besides the {held / 1e9:.2f} GB that "
        f"earlier phases hold {tag}")
    return res, {k: (a, kw) for k, (_, a, kw) in calls.items()}


# ------------------------------------------------------------ the roofline
ROOFLINE_SLACK = 1.05           # compute_s may exceed card busy by 5%
RANGE_PAIRS = 20_000            # record_function pairs a round, timed


def step_peak(fn):
    """``fn()``'s result and ``torch.cuda.max_memory_allocated`` over it,
    with the peak before it: the caller keeps the larger of the two for
    its own peak."""
    import torch

    before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    return out, torch.cuda.max_memory_allocated(), before


@functools.lru_cache(maxsize=None)
def range_pair_us() -> float:
    """Host µs of one ``record_function`` enter/exit pair with no profiler
    on, the median of 5 rounds of ``RANGE_PAIRS``: what each scope range
    of the port (``mlp``, ``decode_attn``, ...) adds to a step's host
    time."""
    import torch

    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(RANGE_PAIRS):
            with torch.profiler.record_function("mlp"):
                pass
        rounds.append((time.perf_counter() - t0) / RANGE_PAIRS * 1e6)
    return statistics.median(rounds)


def roofline_check(label, cfg, shape, busy_ms, peak, held, tag, **kw):
    """The one-card roofline of a step that a phase has just profiled: the
    same step counted on ``meta`` tensors (``roofline.counter.count_step``,
    ``kw`` its ``ocfg`` or ``pos``) and ``analyze``d at the H100's
    data-sheet rates, logged beside the step's card busy time and
    ``max_memory_allocated`` over it (``peak``, of which ``held`` is held
    by earlier phases), and the host time of the step's
    ``record_function`` ranges at ``range_pair_us``. Fails if
    ``compute_s`` exceeds ``ROOFLINE_SLACK`` x the busy time; a
    ``memory_s`` above it is reported as what the eager bytes model
    over-counts."""
    from repro_torch.roofline import analyze
    from repro_torch.roofline.counter import count_step

    t0 = time.perf_counter()
    counted = count_step(cfg, shape, **kw)
    rep = analyze(cfg, shape, "1 card", 1, "", counted.bytes_per_device,
                  costs=counted.costs)
    host_s = time.perf_counter() - t0
    pair_us = range_pair_us()
    res = dict(compute_ms=rep.compute_s * 1e3, memory_ms=rep.memory_s * 1e3,
               step_ms=rep.step_s * 1e3, dominant=rep.dominant,
               fused_ms=rep.memory_s_fused_attn * 1e3,
               useful_ratio=rep.useful_ratio, flops=counted.costs.flops,
               model_flops=rep.model_flops,
               hbm_gb=counted.costs.hbm_bytes / 1e9,
               bytes_gb=counted.bytes_per_device / 1e9,
               peak_gb=(peak - held) / 1e9, held_gb=held / 1e9,
               busy_ms=busy_ms, kernels=counted.kernels, host_s=host_s,
               ranges=counted.ranges, range_pair_us=pair_us,
               ranges_host_ms=counted.ranges * pair_us / 1e3,
               scopes={k: v / 1e9 for k, v in sorted(
                   counted.costs.hbm_bytes_by_scope.items())})
    over = rep.memory_s * 1e3 / busy_ms
    log(f"  {label} roofline, one card ({shape.kind}, B = "
        f"{shape.global_batch}, {shape.seq_len} positions; counted on meta "
        f"in {host_s:.2f} s): compute_s {res['compute_ms']:.4f} ms "
        f"({res['flops']:.4g} FLOPs at 989 TFLOP/s), memory_s "
        f"{res['memory_ms']:.4f} ms ({res['hbm_gb']:.2f} GB at 3.35 TB/s; "
        f"with K7's fused traffic {res['fused_ms']:.4f} ms), step_s "
        f"{res['step_ms']:.4f} ms ({rep.dominant}), useful_ratio "
        f"{res['useful_ratio']:.4f} (model flops {res['model_flops']:.4g}); "
        f"against the card busy {busy_ms:.4f} ms: compute "
        f"{res['compute_ms'] / busy_ms:.4f}, memory {over:.4f} of it"
        + (" (the eager bytes model over-counts the card's traffic)"
           if over > 1 else "")
        + f"; {counted.kernels} counted kernel ops, {counted.ranges} "
        f"record_function ranges ({res['ranges_host_ms']:.4f} ms of host "
        f"time at {pair_us:.3f} us a pair); bytes per device "
        f"{res['bytes_gb']:.2f} GB against max_memory_allocated over the "
        f"step {res['peak_gb']:.2f} GB beside {res['held_gb']:.2f} GB of "
        f"earlier phases; HBM GB by scope " + ", ".join(
            f"{k} {v:.3f}" for k, v in res["scopes"].items()) + f" {tag}")
    if rep.compute_s * 1e3 > ROOFLINE_SLACK * busy_ms:
        raise AssertionError(f"{label}: compute_s {rep.compute_s * 1e3} ms "
                             f"exceeds {ROOFLINE_SLACK} x the card busy "
                             f"{busy_ms} ms")
    return res


# ---------------------------------------------------------------- training
TRAIN_STEPS = 8                 # gemma-2b steps at full width and depth
TRAIN_DATA = dict(vocab_size=256_000, seq_len=128, global_batch=8)
SELECT_STEPS = 3                # steps of the per-layer select comparison


def _train_steps(built, params, opt, pipe, steps, first, fa, n_layers,
                 losses, step_ms):
    """``steps`` train steps from pipeline step ``first``: host-clock ms to
    the loss on the host, each step's loss; K7 must launch exactly twice a
    layer a step (the forward and remat's recompute)."""
    import torch

    for s in range(first, first + steps):
        batch = pipe.global_batch_at(s)
        before = fa.LAUNCHES["flash_attention"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = built["step"](params, opt, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        k7 = fa.LAUNCHES["flash_attention"] - before
        if k7 != 2 * n_layers:
            raise AssertionError(f"step {s}: {k7} K7 launches, not 2 x "
                                 f"{n_layers}")
    return params, opt


def _steps_report(losses, step_ms, launches, n_layers, cfg, B, S,
                  held, tag, steps=TRAIN_STEPS):
    """The gates on ``steps`` train steps (every loss finite, the mean of
    the last 3 below the first, K7 launched 2 x layers a step, the peak
    under the card's memory) and their metrics, logged: the median step of
    steps 2 on, tokens/s, ``mfu`` (the roofline's ``model_flops`` of a
    train step of B x S over the step at 989 TFLOP/s), the peak beyond
    ``held``."""
    import numpy as np
    import torch

    from repro_torch.models.common import ShapeConfig
    from repro_torch.roofline import model_flops

    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if launches != 2 * n_layers * steps:
        raise AssertionError(f"{launches} K7 launches in {steps} steps")
    if not peak < total:
        raise AssertionError(f"peak {peak} bytes of {total}")
    tokens = B * S
    med = statistics.median(step_ms[1:])
    mf = model_flops(cfg, ShapeConfig("train", S, B, "train"))
    res = dict(launches=launches, losses=losses, step_ms=med,
               first_ms=step_ms[0], tokens_s=tokens / (med / 1e3),
               mfu=mf / (med / 1e3 * BF16_TENSOR_FLOPS),
               peak_gb=(peak - held) / 1e9, total_gb=total / 1e9)
    log(f"  {steps} steps, B = {B} x {S} tokens: losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; K7 launches {launches} = 2 x {n_layers} x {steps} {tag}")
    log(f"  train step (host clock to the loss on the host): median of steps "
        f"2-{steps} {med:.3f} ms (first {step_ms[0]:.1f} ms), "
        f"{res['tokens_s']:,.0f} tokens/s, model flops share (mfu) "
        f"{res['mfu']:.4f} = model_flops {mf:.4g} (6 x "
        f"{cfg.param_count():.4g} x {tokens}) / ({med:.3f} ms x "
        f"{BF16_TENSOR_FLOPS / 1e12:.0f} TFLOP/s); peak allocated by the "
        f"steps {res['peak_gb']:.2f} GB ({peak / 1e9:.2f} GB with earlier "
        f"phases' of {res['total_gb']:.2f} GB) {tag}")
    return res


def _tiny_trainer_checks(dev, tag):
    """Phase 3g (c): the fault-tolerant Trainer on the card at the tiny
    gemma (checkpoints under a temporary directory, removed after): crash
    recovery, giving up after max_restarts, a resume equal bit for bit to
    the uninterrupted run, and ``python -m repro_torch.launch.train``."""
    import tempfile

    from repro_torch.configs import get_tiny
    from repro_torch.data import DataConfig
    from repro_torch.optim import OptimConfig
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig

    cfg = get_tiny("gemma_2b")
    ocfg = OptimConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)

    def trainer(d, steps, **kw):
        return Trainer(cfg=cfg, ocfg=ocfg, tcfg=TrainConfig(),
                       rcfg=TrainerConfig(total_steps=steps,
                                          checkpoint_every=4,
                                          checkpoint_dir=d,
                                          **kw.pop("rcfg", {})),
                       data_cfg=dcfg, device=dev, **kw)

    with tempfile.TemporaryDirectory() as root:
        boom = {"armed": True}

        def inject(step):
            if step == 5 and boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("injected failure")

        tr = trainer(os.path.join(root, "crash"), 7, failure_injector=inject)
        out = tr.run()
        steps = [h["step"] for h in tr.history]
        if out["final_step"] != 7 or out["restarts"] != 1 or steps != [
                0, 1, 2, 3, 4, 4, 5, 6] or tr.history[4]["loss"] != \
                tr.history[5]["loss"]:
            raise AssertionError(f"crash recovery: {out}, steps {steps}")

        def always_fail(step):
            raise RuntimeError("permanently broken")

        tr = trainer(os.path.join(root, "giveup"), 5,
                     rcfg={"max_restarts": 2}, failure_injector=always_fail)
        try:
            tr.run()
        except RuntimeError:
            pass
        else:
            raise AssertionError("the trainer did not give up")
        if tr.restarts != 3:
            raise AssertionError(f"gave up after {tr.restarts} restarts")

        d = os.path.join(root, "resume")
        first = trainer(d, 4).run()["losses"]
        tail = trainer(d, 6).run()["losses"]
        whole = trainer(os.path.join(root, "whole"), 6).run()["losses"]
        if first != whole[:4] or tail != whole[4:]:
            raise AssertionError(f"resume not bit-exact: {first} + {tail} "
                                 f"against {whole}")
        log(f"  Trainer, tiny gemma on the card: crash at step 5 recovered "
            f"from the step-4 checkpoint (steps {steps}, step 4's loss "
            f"repeated bit for bit); gave up after max_restarts=2 with 3 "
            f"restarts; steps 0-4, checkpoint, a new Trainer 4-6 equal bit "
            f"for bit to an uninterrupted 0-6 run (losses {whole[0]:.6f} -> "
            f"{whole[-1]:.6f}) {tag}")

        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "gemma_2b", "--tiny", "--steps", "8", "--ckpt-dir",
             os.path.join(root, "cli")],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        if out.returncode or not out.stdout.startswith(
                "arch=gemma-2b steps=8 restarts=0 loss"):
            raise AssertionError(f"python -m repro_torch.launch.train --tiny "
                                 f"exited {out.returncode}: {out.stdout} "
                                 f"{out.stderr[-2000:]}")
        log(f"  python -m repro_torch.launch.train --arch gemma_2b --tiny "
            f"--steps 8 on the card: {out.stdout.strip()} "
            f"({time.perf_counter() - t0:.1f} s with the interpreter's start)")


def train_path(dev, tag, zero_counts):
    """Phase 3g: training on the card. (a) K7's gradient at the training
    operand against plain autograd, and K7 timed there; (b) gemma-2b at
    full width and depth, ``TRAIN_STEPS`` steps of ``make_train_step``
    (remat "full", the full float32 logits), one profiled step, and the
    same step with the stack indexed per layer instead of split once;
    (c) the Trainer and the CLI at the tiny gemma. Returns its
    measurements."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.models import layers as layers_mod
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models import lm as lm_mod
    from repro_torch.optim import OptimConfig
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    cfg = get_config("gemma_2b")
    res = {}

    # (a) K7's gradient at the training operand: q (8, 128, 8, 256), k and
    # v (8, 128, 1, 256), bf16, causal
    B, S = TRAIN_DATA["global_batch"], TRAIN_DATA["seq_len"]
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn((B, S, Hq, D), generator=g, device=dev).bfloat16()
    k = torch.randn((B, S, Hkv, D), generator=g, device=dev).bfloat16()
    v = (torch.rand((B, S, Hkv, D), generator=g, device=dev) * 2
         - 1).bfloat16()
    up = torch.randn(q.shape, generator=g, device=dev).bfloat16()
    saved = dict(fa.LAUNCHES)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = layers_mod.blocked_attention(*a, causal=True, q_chunk=cfg.q_chunk,
                                       kv_chunk=cfg.kv_chunk)
    got = torch.autograd.grad(out, a, up)
    if fa.LAUNCHES["flash_attention"] != saved["flash_attention"] + 1:
        raise AssertionError("the attention Function did not launch K7")
    b = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_plain(*b, causal=True), b,
                               up.float())
    worst = []
    for name, x, y in zip("qkv", got, want):
        d = (x.float() - y).abs()
        if not bool((d <= 4e-3 * torch.clamp(y.abs(), min=1)).all()):
            raise AssertionError(f"K7's d{name} differs from plain autograd "
                                 f"by {float(d.max())}")
        worst.append(float(d.max()))

    def fwd_bwd():
        o = layers_mod.blocked_attention(*a, causal=True)
        return torch.autograd.grad(o, a, up)

    res["attn_fwd_bwd_ms"] = cuda_ms(fwd_bwd, 10)
    fa.LAUNCHES.update(saved)                 # comparisons do not count
    k7 = check_flash_call(fa, (q, k, v), {"causal": True})
    res["k7_train"] = k7
    log(f"  K7's gradient at q {tuple(q.shape)}, k/v {tuple(k.shape)} bf16 "
        f"causal (the Function: K7 forward, the blocked recompute in float32 "
        f"backward) against plain autograd in float32: dq, dk, dv within "
        f"{worst[0]:.4g}, {worst[1]:.4g}, {worst[2]:.4g} (tolerance 4e-3 * "
        f"max(1, |plain|)); forward and backward {res['attn_fwd_bwd_ms']:.4f}"
        f" ms {tag}")
    log(f"  flash_attention, 3g training operand ({k7['shape']}): kernel "
        f"{k7['ms']:.6f} ms, plain {k7['plain_ms']:.2f} ms, "
        f"scaled_dot_product_attention {k7['library_ms']:.6f} ms, bound "
        f"{k7['bound_ms']:.6f} ms ({k7['bound_by']}); within "
        f"{k7['max_abs_err']:.4g} of plain {tag}")
    del q, k, v, up, a, b, got, want, out

    # (b) gemma-2b at full width and depth
    ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=8)
    built = make_train_step(cfg, ocfg, TrainConfig(microbatches=1),
                            device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()      # what earlier phases keep
    t0 = time.perf_counter()
    params, opt = built["init"](SEED)
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    state_gb = (torch.cuda.memory_allocated() - held) / 1e9
    log(f"  gemma-2b at full width and depth ({cfg.n_layers} layers, remat "
        f"{cfg.remat!r}, ce_chunk {cfg.ce_chunk}): {n_params:,} parameters, "
        f"init from seed {SEED} with AdamW state in "
        f"{time.perf_counter() - t0:.1f} s, {state_gb:.2f} GB on the card "
        f"(besides {held / 1e9:.2f} GB that earlier phases hold for phase "
        f"4)")
    pipe = TokenPipeline(DataConfig(**TRAIN_DATA))
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    zero_counts()
    params, opt = _train_steps(built, params, opt, pipe, TRAIN_STEPS, 0, fa,
                               cfg.n_layers, losses, step_ms)
    res.update(_steps_report(losses, step_ms, fa.LAUNCHES["flash_attention"],
                             cfg.n_layers, cfg, B, S, held, tag))
    med = res["step_ms"]

    # one profiled step, by kernel kind and by range
    saved = dict(fa.LAUNCHES)
    ranges = {"adamw": None, "flash_attn_bwd": None, "ce_loss": None}
    nxt = [TRAIN_STEPS]

    def one_step():
        nonlocal params, opt
        params, opt, m = built["step"](params, opt,
                                       pipe.global_batch_at(nxt[0]))
        nxt[0] += 1
        return m["loss"].item()

    prof, peak, _ = step_peak(lambda: profile_batch(
        one_step, "train_gemma2b_B8", ROOT / "chiprun_out",
        expect=("flash_attention",), ranges=ranges))

    def card_ms(words):
        return sum(dt for dt, _, key in prof
                   if any(w in key.lower() for w in words))

    weights = [p for p in leaves(params, torch.is_tensor)]
    cast_ms = cuda_ms(lambda: [p.to(torch.bfloat16) for p in weights], 3)
    fa.LAUNCHES.update(saved)                 # measurements do not count
    res.update(prof_busy=sum(dt for dt, _, _ in prof),
               prof_k7=card_ms(("flash_attention",)),
               prof_gemm=card_ms(("gemm", "gemv", "nvjet", "xmma", "cutlass",
                                  "cublas", "splitk")),
               prof_copy=card_ms(("copy",)),
               prof_embed=card_ms(("indexing_backward", "index_put",
                                   "radixsort", "onesweep", "fillfunctor")),
               ranges=ranges, cast_ms=cast_ms)
    names = {"adamw": "AdamW", "flash_attn_bwd": "the attention recompute "
             "(18 backward ranges)", "ce_loss": "the forward and the loss"}
    rng_txt = ", ".join(f"{names[k]} {v:.4f} ms" if v is not None else
                        f"{names[k]} not measured" for k, v in ranges.items())
    log(f"  one profiled step by kind: GEMMs {res['prof_gemm']:.4f} ms, copy "
        f"kernels (weight and activation casts) {res['prof_copy']:.4f} ms, "
        f"K7 {res['prof_k7']:.4f} ms, the embedding gradient (its 2.1 GB "
        f"zero fill, the index sort, index_put with accumulate) "
        f"{res['prof_embed']:.4f} ms, "
        f"of {res['prof_busy']:.4f} ms card busy ({res['prof_busy'] / med:.3f}"
        f" of the unprofiled median step); kernels by range: {rng_txt}; "
        f"every weight cast to bf16 once {cast_ms:.4f} ms (CUDA events) "
        f"{tag}")
    res["roofline"] = roofline_check(
        "3g gemma-2b train step", cfg, ShapeConfig("3g", S, B, "train"),
        res["prof_busy"], peak, held, tag, ocfg=ocfg)

    # the same steps with each stacked leaf indexed per layer (a select a
    # layer, each with a full-size zero gradient of its stacked leaf)
    split = lm_mod._split_layers
    lm_mod._split_layers = lambda sp: [lm_mod._layer(sp, i)
                                       for i in range(lm_mod._n_layers(sp))]
    sel_losses, sel_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    try:
        params, opt = _train_steps(built, params, opt, pipe, SELECT_STEPS,
                                   nxt[0], fa, cfg.n_layers, sel_losses,
                                   sel_ms)
    finally:
        lm_mod._split_layers = split
    sel_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    torch.cuda.reset_peak_memory_stats()
    spl_losses, spl_ms = [], []
    params, opt = _train_steps(built, params, opt, pipe, SELECT_STEPS,
                               nxt[0] + SELECT_STEPS, fa, cfg.n_layers,
                               spl_losses, spl_ms)
    spl_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    fa.LAUNCHES.update(saved)
    res.update(select_ms=statistics.median(sel_ms[1:]),
               split_ms=statistics.median(spl_ms[1:]), select_peak_gb=sel_peak,
               split_peak_gb=spl_peak)
    log(f"  stack indexed per layer (select) against split once (unbind), "
        f"{SELECT_STEPS} steps each, in turns: select {res['select_ms']:.3f} "
        f"ms a step (median of the last {SELECT_STEPS - 1}; peak "
        f"{sel_peak:.2f} GB), split {res['split_ms']:.3f} ms (peak "
        f"{spl_peak:.2f} GB) {tag}")
    del params, opt, built, weights, prof
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the Trainer and the CLI at the tiny gemma
    _tiny_trainer_checks(dev, tag)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 3g: {res['phase_s']:.1f} s")
    return res


# ------------------------------------------------- the swiglu dense family
LLAMA_TRAIN_LAYERS = 8          # llama3-8b's training depth on one card
LLAMA_SERVE_LAYERS = 16         # llama3-8b's serving depth (3h; of 32)
MAMBA_SERVE_LAYERS = 24         # mamba2-1.3b's serving depth (3m; of 48)
HYMBA_SERVE_LAYERS = 16         # hymba-1.5b's depth through 3f's engine
                                # (3n (a); of 32; its ring set and
                                # training run all 32)
GRANITE_LAYERS = 4              # granite-3-8b's and granite-34b's depth
GRANITE_SERVE = dict(max_batch=8, max_seq=256, max_new_tokens=9)
GRANITE_PROMPT = 96             # tokens of the one granite request
EMBED_STEPS = 30                # train_embedder's steps (its default: 300)


def dense_train_path(dev, tag, zero_counts):
    """Phase 3i: llama3-8b training at full width, ``LLAMA_TRAIN_LAYERS``
    of its 32 layers (the depth is the cut: 32 layers need ~128 GB of
    parameters, gradients and float32 moments), ``TRAIN_STEPS`` steps of
    ``make_train_step`` on 8 x 128-token ``TokenPipeline`` batches, remat
    "full"; then ``python -m repro_torch.launch.train --arch llama3_8b
    --tiny`` on the card. Returns its measurements and K7's training
    call."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.models import layers as layers_mod
    from repro_torch.optim import OptimConfig
    from repro_torch.train import TrainConfig, make_train_step

    t_phase = time.perf_counter()
    cfg = get_config("llama3_8b").replace(n_layers=LLAMA_TRAIN_LAYERS)
    data = dict(TRAIN_DATA, vocab_size=cfg.vocab_size)
    B, S = data["global_batch"], data["seq_len"]
    ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=TRAIN_STEPS)
    built = make_train_step(cfg, ocfg, TrainConfig(microbatches=1),
                            device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()      # what earlier phases keep
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt = built["init"](SEED)
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    state_gb = (torch.cuda.memory_allocated() - held) / 1e9
    log(f"  llama3-8b at full width, {cfg.n_layers} of 32 layers (remat "
        f"{cfg.remat!r}, ce_chunk {cfg.ce_chunk}): {n_params:,} parameters, "
        f"init from seed {SEED} with AdamW state in "
        f"{time.perf_counter() - t0:.1f} s, {state_gb:.2f} GB on the card "
        f"(besides {held / 1e9:.2f} GB that earlier phases hold)")
    pipe = TokenPipeline(DataConfig(**data))
    calls = {}
    losses, step_ms = [], []
    zero_counts()
    layers_mod.flash_attention = _k7_capture(fa, calls, {"train"})
    try:
        params, opt = _train_steps(built, params, opt, pipe, TRAIN_STEPS, 0,
                                   fa, cfg.n_layers, losses, step_ms)
    finally:
        layers_mod.flash_attention = fa.flash_attention
    res = _steps_report(losses, step_ms, fa.LAUNCHES["flash_attention"],
                        cfg.n_layers, cfg, B, S, held, tag)
    del params, opt, built
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "llama3_8b", "--tiny", "--steps", "8", "--ckpt-dir",
             os.path.join(root, "cli")],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if out.returncode or not out.stdout.startswith(
            "arch=llama3-8b steps=8 restarts=0 loss"):
        raise AssertionError(f"python -m repro_torch.launch.train --arch "
                             f"llama3_8b --tiny exited {out.returncode}: "
                             f"{out.stdout} {out.stderr[-2000:]}")
    log(f"  python -m repro_torch.launch.train --arch llama3_8b --tiny "
        f"--steps 8 on the card: {out.stdout.strip()} "
        f"({time.perf_counter() - t0:.1f} s with the interpreter's start)")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 3i: {res['phase_s']:.1f} s")
    _, a, kw = calls["train"]
    return res, (a, kw)


def _record_rows(eng):
    """The logits row of every token ``eng`` chooses, in order."""
    import numpy as np

    rows = []
    choose = eng._select_token

    def select(row, slot):
        rows.append(np.array(row).reshape(-1))
        return choose(row, slot)

    eng._select_token = select
    return rows


def granite_path(dev, tag, zero_counts):
    """Phase 3j: granite-3-8b and granite-34b at full width,
    ``GRANITE_LAYERS`` layers each (the depth is the cut), one request of
    ``GRANITE_PROMPT`` tokens through ``ServeEngine``: one prefill and 8
    decode steps, K7 launched layers x 9 times, every token the causal
    forward's argmax where its top-2 margin exceeds ``TIE_FACTOR`` x the
    measured gap. granite-34b's 48 q heads share one kv head (G = 48).
    Returns each model's measurements and K7 calls."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.models import Model
    from repro_torch.models import layers as layers_mod
    from repro_torch.serve import ServeConfig, ServeEngine

    out_res, out_calls = {}, {}
    for arch in ("granite_3_8b", "granite_34b"):
        t_phase = time.perf_counter()
        cfg = get_config(arch).replace(n_layers=GRANITE_LAYERS)
        model = Model(cfg)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params = model.init_params(SEED, device=dev)
        prompt = np.random.default_rng(SEED + 2).integers(
            1, cfg.vocab_size, GRANITE_PROMPT)
        eng = ServeEngine(cfg, params, ServeConfig(**GRANITE_SERVE,
                                                   device=dev))
        rows = _record_rows(eng)
        calls = {}
        zero_counts()
        layers_mod.flash_attention = _k7_capture(fa, calls)
        try:
            eng.submit(prompt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            served = eng.run_until_drained()
            wall = time.perf_counter() - t0
        finally:
            layers_mod.flash_attention = fa.flash_attention
        st, k7 = eng.stats, fa.LAUNCHES["flash_attention"]
        steps = GRANITE_SERVE["max_new_tokens"] - 1
        if st["prefills"] != 1 or st["decode_steps"] != steps:
            raise AssertionError(f"{arch}: {st}")
        if k7 != cfg.n_layers * (1 + steps):
            raise AssertionError(f"{arch}: {k7} K7 launches")
        toks = served[0]
        gap, scale, limited = teacher_forced(model, params, prompt, toks,
                                             rows, GAP_BOUND, dev)
        # the same request with float32 compute, against the float32 forward
        f32 = Model(cfg.replace(compute_dtype="float32"))
        eng32 = ServeEngine(f32.cfg, params, ServeConfig(**GRANITE_SERVE,
                                                         device=dev))
        rows32 = _record_rows(eng32)
        eng32.submit(prompt)
        toks32 = eng32.run_until_drained()[0]
        gap32, _, limited32 = teacher_forced(f32, params, prompt, toks32,
                                             rows32, GAP_BOUND_F32, dev)
        del eng, eng32, params
        gc.collect()
        torch.cuda.empty_cache()
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        G = cfg.n_heads // cfg.n_kv_heads
        out_res[arch] = dict(launches=k7, wall_s=wall, gap=gap, scale=scale,
                             limited=limited, gap32=gap32,
                             limited32=limited32, peak_gb=peak, G=G,
                             n_params=cfg.param_count(),
                             phase_s=time.perf_counter() - t_phase)
        out_calls[arch] = {k: (a, kw) for k, (_, a, kw) in calls.items()}
        log(f"  {cfg.name} at full width, {cfg.n_layers} layers "
            f"({cfg.param_count():,} parameters; {cfg.n_heads} q heads over "
            f"{cfg.n_kv_heads} kv head(s) of {cfg.head_dim_}, G = {G}): one "
            f"request of {GRANITE_PROMPT} tokens, 1 prefill and {steps} "
            f"decode steps in {wall:.3f} s, K7 launches {k7} = "
            f"{cfg.n_layers} x (1 + {steps}); decode logits within "
            f"{gap:.4g} of the causal forward's (largest {scale:.4g}), every "
            f"token its argmax, {limited}/{len(toks)} margin-limited; in "
            f"float32 compute within {gap32:.4g}, {limited32}/{len(toks32)} "
            f"margin-limited; peak "
            f"allocated {peak:.2f} GB besides {held / 1e9:.2f} GB; "
            f"{out_res[arch]['phase_s']:.1f} s {tag}")
    return out_res, out_calls


def examples_path(dev, tag, zero_counts, read_counts):
    """Phase 3k: the four examples on the card through their ``main()``,
    the entry point ``python -m repro_torch.examples.<name>`` calls, each
    at its reference's defaults but train_embedder's steps (``EMBED_STEPS``
    of its 300), checkpoints under a temporary directory; each success
    line checked, each example's kernel launches and peak allocation
    printed. Returns them by example."""
    import io
    import tempfile

    import torch

    from repro_torch.examples import (
        distributed_search,
        quickstart,
        retrieval_serving,
        train_embedder,
    )

    res = {}
    with tempfile.TemporaryDirectory() as root:
        for name, mod, argv, lines in (
            ("quickstart", quickstart, [],
             ("all queries exact", "sims bit-identical")),
            ("distributed_search", distributed_search, [],
             ("shards: 8 on 1 device(s) (cuda:0)",
              "single-host linear scan for every query (exact)")),
            ("retrieval_serving", retrieval_serving, [],
             ("indexed 400 docs", "(exact, streamed)",
              "generated 48 tokens for 6 requests")),
            ("train_embedder", train_embedder,
             ["--steps", str(EMBED_STEPS), "--ckpt-dir",
              os.path.join(root, "embedder")],
             (f"steps: {EMBED_STEPS}  restarts: 0", "loss: first10 ")),
        ):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                mod.main(argv)
            secs = time.perf_counter() - t0
            out = buf.getvalue()
            missing = [ln for ln in lines if ln not in out]
            if missing:
                raise AssertionError(f"{name}: no {missing} in:\n{out}")
            counts = {k: v for k, v in read_counts().items() if v}
            gc.collect()
            torch.cuda.empty_cache()
            peak = (torch.cuda.max_memory_allocated() - held) / 1e9
            res[name] = dict(s=secs, peak_gb=peak, launches=counts,
                             out=out.strip().splitlines())
            log(f"  python -m repro_torch.examples.{name} {' '.join(argv)}: "
                f"{secs:.1f} s, peak allocated {peak:.2f} GB, kernel "
                f"launches {counts} {tag}")
            for ln in res[name]["out"]:
                log(f"    | {ln}")
    for kernel in ("probe_walk", "hamming_scan_topk", "flash_attention"):
        if not any(r["launches"].get(kernel) for r in res.values()):
            raise AssertionError(f"no example launched {kernel}")
    return res


# --------------------------------------------- whisper-tiny and mamba2-1.3b
WHISPER_B = 8                   # prompts served and sequences trained
WHISPER_PROMPT = 16             # tokens of each prompt
WHISPER_STEPS = 32              # greedy decode steps after the prefill
WHISPER_TRAIN_S = 128           # tokens of each training sequence
MAMBA_TRAIN_STEPS = 8           # steps of the training CLI


def reference_layout_params(cfg, seed):
    """Random parameters in the reference's tree and init rule (normal,
    std 0.02 and 0.02 / sqrt(2 L) for output projections, norms' scales 1
    and biases 0), as numpy arrays from ``seed``: what a reference
    checkpoint hands ``params_from_reference``."""
    import math

    import numpy as np

    from repro_torch.models import lm
    from repro_torch.tree import leaves_with_path

    rng = np.random.default_rng(seed)
    tree = {}
    for path, spec in leaves_with_path(lm.model_template(cfg), lm._is_pspec):
        if spec.init in ("zeros", "ones"):
            a = (np.ones if spec.init == "ones" else np.zeros)(spec.shape,
                                                               np.float32)
        else:
            std = 0.02 / math.sqrt(2 * cfg.n_layers) if spec.init == "out" \
                else 0.02
            a = rng.standard_normal(spec.shape, dtype=np.float32) * \
                np.float32(std)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return tree


def _whisper_capture(fa, calls, counts, enc_seq):
    """A stand-in for ``models.layers.flash_attention`` that keeps copies
    of the operands of the first K7 call of each kind on whisper's path
    (the encoder's self-attention, the decoder's causal self-attention
    and its cross-attention, the decode step's self- and
    cross-attention) and counts the calls by kind, then calls K7 as the
    layer would."""

    def capture(q, k, v, **kw):
        if kw.get("valid_len") is None:
            kind = "prefill" if kw.get("causal") else (
                "encoder" if q.shape[1] == k.shape[1] else "cross")
        else:
            kind = "cross_decode" if k.shape[1] == enc_seq else "decode"
        if kind not in calls:
            calls[kind] = (tuple(t.detach().clone() for t in (q, k, v)),
                           dict(kw))
        counts[kind] = counts.get(kind, 0) + 1
        return fa.flash_attention(q, k, v, **kw)

    return capture


def whisper_generate(model, params, batch, steps, dev):
    """Prefill ``batch`` and take ``steps`` greedy decode steps from the
    prefill's cache pasted into a zero cache of prompt + steps slots.
    Returns (tokens (B, steps + 1), the logits row of each (steps + 1, B,
    V), prefill ms, median decode-step ms), host clock to the chosen
    tokens."""
    import numpy as np
    import torch

    from repro_torch.models.encdec import EncDecCache

    S = batch["tokens"].shape[1]
    B = batch["tokens"].shape[0]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, pre = model.prefill(params, batch, device=dev)
        rows = [logits.float().cpu().numpy()]
        prefill_ms = (time.perf_counter() - t0) * 1e3
        full = model.init_cache(B, S + steps, device=dev)
        for f, p in zip(full.self_kv, pre.self_kv):
            f[:, :, :S] = p
        cache = EncDecCache(self_kv=full.self_kv, cross_kv=pre.cross_kv)
        toks = [rows[0].argmax(-1)]
        step_ms = []
        for j in range(steps):
            t0 = time.perf_counter()
            logits, _ = model.decode_step(params, cache, toks[-1][:, None],
                                          S + j, device=dev)
            rows.append(logits.float().cpu().numpy())
            toks.append(rows[-1].argmax(-1))
            step_ms.append((time.perf_counter() - t0) * 1e3)
    return (np.stack(toks, 1).astype(np.int32), np.stack(rows), prefill_ms,
            statistics.median(step_ms))


def whisper_teacher_forced(model, params, batch, toks, rows, bound, dev):
    """The greedy tokens ``toks`` (B, n) against the teacher-forced
    forward over each prompt and its tokens: the decode logits within
    ``bound`` x the largest forward logit, each token the forward's
    argmax wherever its top-2 margin exceeds ``TIE_FACTOR`` x the
    measured gap. Returns (gap, scale, margin-limited tokens)."""
    import numpy as np
    import torch

    S = batch["tokens"].shape[1]
    seq = np.concatenate([batch["tokens"], toks[:, :-1]], axis=1)
    with torch.no_grad():
        logits, _ = model.forward(params, dict(batch, tokens=seq),
                                  device=dev)
        f = logits[:, S - 1:].cpu().numpy()          # (B, n, V)
        del logits
    d = np.swapaxes(rows, 0, 1)                       # (B, n, V)
    gap = float(np.abs(d - f).max())
    scale = float(np.abs(f).max())
    if not gap <= bound * scale:
        raise AssertionError(f"{model.cfg.name} ({model.cfg.compute_dtype}): "
                             f"decode logits differ from the teacher-forced "
                             f"forward's by {gap} (largest logit {scale})")
    limited = 0
    for b in range(toks.shape[0]):
        for j in range(toks.shape[1]):
            if top2_margin(f[b, j]) <= TIE_FACTOR * gap:
                limited += 1
            elif toks[b, j] != int(np.argmax(f[b, j])):
                raise AssertionError(
                    f"{model.cfg.name} row {b} token {j}: {toks[b, j]}, the "
                    f"forward's argmax {int(np.argmax(f[b, j]))}")
    return gap, scale, limited


def whisper_path(dev, tag, zero_counts):
    """Phase 3l: whisper-tiny at full width and depth (4 encoder and 4
    decoder layers, d_model 384, 6 heads of 64, 1,500 frames), bf16
    compute, its parameters drawn in the reference's layout with numpy and
    carried across with ``params_from_reference``. (a) A prefill of
    ``WHISPER_B`` prompts of ``WHISPER_PROMPT`` tokens over seeded frames
    and ``WHISPER_STEPS`` greedy decode steps; each token the
    teacher-forced forward's argmax where its margin allows, in bf16 and
    again in float32 compute. (b) 8 ``make_train_step`` steps of
    ``WHISPER_B`` x ``WHISPER_TRAIN_S`` tokens with their frames: losses
    finite and falling. K7 launches counted on (a) and (b). Returns the
    measurements and K7's operands by kind."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_reference
    from repro_torch.data import DataConfig, TokenPipeline
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.models import Model
    from repro_torch.models import layers as layers_mod
    from repro_torch.optim import OptimConfig, init_state
    from repro_torch.train import TrainConfig, make_train_step

    t_phase = time.perf_counter()
    cfg = get_config("whisper_tiny")
    model = Model(cfg)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tree = reference_layout_params(cfg, SEED)
    params = params_from_reference(tree, device=dev)
    rng = np.random.default_rng(SEED + 3)
    B, S, n = WHISPER_B, WHISPER_PROMPT, WHISPER_STEPS
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "enc_frames": rng.standard_normal(
                 (B, cfg.encoder_seq, cfg.d_model), dtype=np.float32)}
    log(f"  {cfg.name} at full width and depth ({cfg.n_encoder_layers} + "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"of {cfg.head_dim_}, {cfg.encoder_seq} frames; "
        f"{cfg.param_count():,} float32 parameters drawn from seed {SEED} in "
        f"the reference's layout, bf16 compute)")
    calls, by_kind = {}, {}
    capture = _whisper_capture(fa, calls, by_kind, cfg.encoder_seq)
    zero_counts()
    layers_mod.flash_attention = capture
    try:
        toks, rows, prefill_ms, step_ms = whisper_generate(
            model, params, batch, n, dev)
    finally:
        layers_mod.flash_attention = fa.flash_attention
    k7 = fa.LAUNCHES["flash_attention"]
    per_prefill = cfg.n_encoder_layers + 2 * cfg.n_layers
    if k7 != per_prefill + n * 2 * cfg.n_layers:
        raise AssertionError(f"whisper: {k7} K7 launches for one prefill "
                             f"and {n} decode steps")
    if set(calls) != {"encoder", "prefill", "cross", "decode",
                      "cross_decode"}:
        raise AssertionError(f"whisper's K7 calls: {sorted(calls)}")
    res = dict(launches=k7, prefill_ms=prefill_ms, step_ms=step_ms,
               tokens_s=B / (step_ms / 1e3))
    gap, scale, limited = whisper_teacher_forced(model, params, batch, toks,
                                                 rows, GAP_BOUND, dev)
    f32 = Model(cfg.replace(compute_dtype="float32"))
    toks32, rows32, _, _ = whisper_generate(f32, params, batch, n, dev)
    gap32, scale32, limited32 = whisper_teacher_forced(
        f32, params, batch, toks32, rows32, GAP_BOUND_F32, dev)
    res.update(gap=gap, gap32=gap32, limited=limited, limited32=limited32)
    log(f"  prefill of {B} prompts x {S} tokens {prefill_ms:.2f} ms, then {n} "
        f"greedy decode steps: median {step_ms:.3f} ms a step "
        f"({res['tokens_s']:.1f} tokens/s), host clock to the chosen tokens; "
        f"K7 launches {k7} = ({cfg.n_encoder_layers} + 2 x {cfg.n_layers}) + "
        f"{n} x 2 x {cfg.n_layers}; decode logits within {gap:.4g} of the "
        f"teacher-forced forward's (largest {scale:.4g}), every token its "
        f"argmax, {limited}/{toks.size} margin-limited; in float32 compute "
        f"within {gap32:.4g} (largest {scale32:.4g}), {limited32}/"
        f"{toks32.size} margin-limited {tag}")
    del rows, rows32
    gen_peak = (torch.cuda.max_memory_allocated() - held) / 1e9

    # (b) training: the encoder once, the decoder rematerialised
    ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=TRAIN_STEPS)
    built = make_train_step(cfg, ocfg, TrainConfig(), device=dev)
    params = params_from_reference(tree, device=dev)
    opt = init_state(ocfg, params)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=WHISPER_TRAIN_S,
                                    global_batch=B))
    per_step = cfg.n_encoder_layers + 2 * 2 * cfg.n_layers
    losses, train_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    layers_mod.flash_attention = capture
    try:
        for s in range(TRAIN_STEPS):
            tb = {"tokens": pipe.global_batch_at(s)["tokens"],
                  "enc_frames": rng.standard_normal(
                      (B, cfg.encoder_seq, cfg.d_model), dtype=np.float32)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = built["step"](params, opt, tb)
            losses.append(float(m["loss"]))
            train_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        layers_mod.flash_attention = fa.flash_attention
    train_k7 = fa.LAUNCHES["flash_attention"]
    if train_k7 != per_step * TRAIN_STEPS:
        raise AssertionError(f"whisper training: {train_k7} K7 launches, not "
                             f"{per_step} x {TRAIN_STEPS}")
    if not all(np.isfinite(losses)) or not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"whisper training losses {losses}")
    med = statistics.median(train_ms[1:])
    if sum(by_kind.values()) != k7 + train_k7:
        raise AssertionError(f"whisper's K7 calls by kind {by_kind}, "
                             f"launches {k7} + {train_k7}")
    res.update(train_launches=train_k7, losses=losses, train_ms=med,
               by_kind=by_kind,
               train_tokens_s=B * WHISPER_TRAIN_S / (med / 1e3),
               train_peak_gb=(torch.cuda.max_memory_allocated() - held) / 1e9,
               gen_peak_gb=gen_peak)
    log(f"  {TRAIN_STEPS} make_train_step steps of {B} x {WHISPER_TRAIN_S} "
        f"tokens with {cfg.encoder_seq} frames each: losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; median of steps 2-{TRAIN_STEPS} {med:.3f} ms (first "
        f"{train_ms[0]:.1f} ms), {res['train_tokens_s']:,.0f} decoder "
        f"tokens/s; K7 launches {train_k7} = {TRAIN_STEPS} x "
        f"({cfg.n_encoder_layers} + 2 x 2 x {cfg.n_layers}: the decoder's "
        f"remat recompute); peak allocated {res['train_peak_gb']:.2f} GB "
        f"training, {gen_peak:.2f} GB generating {tag}")
    del params, opt, built
    gc.collect()
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 3l: {res['phase_s']:.1f} s")
    return res, calls


def mamba_train_path(dev, tag, zero_counts):
    """Phase 3m (b): ``python -m repro_torch.launch.train --arch
    mamba2_1_3b --steps 8`` through its ``main()`` (the CLI's batch of 8 x
    128 tokens, remat "full", a checkpoint every 2 steps under a temporary
    directory): its summary line, each step's host-clock ms from the
    trainer's history, tokens/s, the losses and the peak allocation.

    The CLI's four checkpoints hold 17.4 GB of arrays each, 69 GB in all:
    more than this smoke run keeps its disk writes under (45 GiB). So
    here each checkpoint's ``arrays.npz`` is written empty (``np.savez``
    replaced for the call, its bytes counted); everything else a save
    does runs: the host copy, the write thread, the manifest, the atomic
    rename and the retention."""
    import io
    import tempfile

    import numpy as np
    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.models.common import ShapeConfig
    from repro_torch.roofline import model_flops
    from repro_torch.train import Trainer

    cfg = get_config("mamba2_1_3b")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    seen = []
    run = Trainer.run

    def kept(self):
        seen.append(self)
        return run(self)

    savez, payload = np.savez, []

    def empty_savez(file, **arrays):
        payload.append(sum(a.nbytes for a in arrays.values()))
        open(file, "wb").close()

    buf = io.StringIO()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        Trainer.run = kept
        np.savez = empty_savez
        zero_counts()
        try:
            with contextlib.redirect_stdout(buf):
                train_cli.main(["--arch", "mamba2_1_3b", "--steps",
                                str(MAMBA_TRAIN_STEPS), "--ckpt-dir",
                                os.path.join(root, "ck")])
        finally:
            Trainer.run = run
            np.savez = savez
        saved = sorted(os.listdir(os.path.join(root, "ck")))
    wall = time.perf_counter() - t0
    out = buf.getvalue().strip()
    want = (f"arch=mamba2-1.3b steps={MAMBA_TRAIN_STEPS} restarts=0 loss")
    if not out.startswith(want):
        raise AssertionError(f"the training CLI printed {out!r}")
    hist = seen[0].history
    losses = [h["loss"] for h in hist]
    step_ms = [h["time_s"] * 1e3 for h in hist]
    if not all(np.isfinite(losses)) or not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"mamba2 training losses {losses}")
    if fa.LAUNCHES["flash_attention"]:
        raise AssertionError("the SSM trained through attention")
    med = statistics.median(step_ms[1:])
    tokens = 8 * 128
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    res = dict(losses=losses, step_ms=med, first_ms=step_ms[0],
               tokens_s=tokens / (med / 1e3), peak_gb=peak, wall_s=wall,
               mfu=model_flops(cfg, ShapeConfig("train", 128, 8, "train"))
               / (med / 1e3 * BF16_TENSOR_FLOPS), checkpoints=saved,
               saves=len(payload))
    log(f"  python -m repro_torch.launch.train --arch mamba2_1_3b --steps "
        f"{MAMBA_TRAIN_STEPS} on the card: {out}; {wall:.1f} s in all with "
        f"{len(payload)} saves, kept {saved}, their arrays "
        + ", ".join(f"{b / 1e9:.2f}" for b in payload)
        + f" GB each counted, not written {tag}")
    log(f"  mamba2-1.3b train step (B = 8 x 128, remat {cfg.remat!r}; the "
        f"trainer's host clock to the loss): median of steps "
        f"2-{MAMBA_TRAIN_STEPS} {med:.3f} ms (first {step_ms[0]:.1f} ms), "
        f"{res['tokens_s']:,.0f} tokens/s, mfu {res['mfu']:.4f}; losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; peak allocated {peak:.2f} GB besides {held / 1e9:.2f} GB "
        f"{tag}")
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ------------------------------------------- hymba-1.5b and the MoE family
RING_PROMPT = 2000              # tokens of each ring-wrap prompt
RING_SERVE = dict(max_batch=8, max_seq=2176, max_new_tokens=128)
RING_CHECKED = 2                # requests served again in float32 compute
HYMBA_LONG = dict(seq_len=4096, global_batch=2)   # steps past the window
HYMBA_LONG_STEPS = 2
MOE_LAYERS = 2                  # arctic's and kimi's depth on one card
MOE_SERVE = dict(max_batch=8, max_seq=160, max_new_tokens=16)
MOE_PROMPTS = (19, 123)         # prompt lengths, evenly spread


def _engine_probe(eng, rows, prefill_ms, step_ms):
    """Record every logits row the engine chooses a token from, by
    request, and host-clock ms of each prefill (by prompt length) and each
    decode step (by group size)."""
    import numpy as np

    prefill, step, decode = (eng._prefill_into_slot, eng._step,
                             eng._decode)
    choose = eng._select_token
    group = [0]

    def select(row, slot):
        rows.setdefault(eng.slot_req[slot].rid, []).append(
            np.array(row).reshape(-1))
        return choose(row, slot)

    def timed_prefill(slot, req):
        t0 = time.perf_counter()
        prefill(slot, req)
        prefill_ms.append((len(req.prompt), (time.perf_counter() - t0) * 1e3))

    def counted_decode(tokens, pos, mask):
        group[0] = int(mask.sum())
        return decode(tokens, pos, mask)

    def timed_step():
        group[0] = 0
        t0 = time.perf_counter()
        step()
        if group[0]:
            step_ms.append((group[0], (time.perf_counter() - t0) * 1e3))

    eng._select_token = select
    eng._prefill_into_slot = timed_prefill
    eng._decode = counted_decode
    eng._step = timed_step


def teacher_forced_batch(model, params, prompts, served, rows, bound, dev,
                         extra=None):
    """``teacher_forced`` for requests whose prompts have one length, in
    one causal forward over all of them (B = len(prompts)); ``extra``
    holds the batch's other inputs (the vlm's ``vision_embeds``). Returns
    (gap, scale, margin-limited tokens)."""
    import numpy as np
    import torch

    n = len(prompts[0])
    seqs = np.stack([np.concatenate([p, served[i][:-1]])
                     for i, p in enumerate(prompts)])
    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": seqs, **(extra or {})},
                                  device=dev)
        f = logits[:, n - 1:].cpu().numpy()
        del logits
    gap = max(float(np.abs(np.stack(rows[i]) - f[i]).max())
              for i in range(len(prompts)))
    scale = float(np.abs(f).max())
    if not gap <= bound * scale:
        raise AssertionError(f"{model.cfg.name} ({model.cfg.compute_dtype}): "
                             f"decode logits differ from the causal "
                             f"forward's by {gap} (largest logit {scale})")
    limited = 0
    for i in range(len(prompts)):
        for j, tok in enumerate(served[i]):
            if top2_margin(f[i, j]) <= TIE_FACTOR * gap:
                limited += 1
            elif tok != int(np.argmax(f[i, j])):
                raise AssertionError(f"{model.cfg.name} request {i} token "
                                     f"{j}: {tok}, the forward's argmax "
                                     f"{int(np.argmax(f[i, j]))}")
    return gap, scale, limited


def hymba_path(dev, tag, zero_counts):
    """Phase 3n (b) and (c): hymba-1.5b at full width and depth past its
    sliding window. (b) 8 prompts of ``RING_PROMPT`` tokens and 128 new
    tokens each through ``ServeEngine`` (``RING_SERVE``: a ring of 2,048
    K/V slots that wraps at the 48th decode step), every token the
    teacher-forced forward's argmax over the 2,127 positions (K7 with the
    window) where its margin exceeds ``TIE_FACTOR`` x the gap, in bf16 and
    again in float32 compute for ``RING_CHECKED`` requests; one profiled
    decode step on the wrapped ring. (c) ``make_train_step``: 8 steps of
    8 x 128 tokens, then ``HYMBA_LONG_STEPS`` of 2 x 4,096 tokens (the
    window bites in K7's forward and in its gradient's recompute), losses
    finite and falling. Returns its measurements, K7's calls (the ring
    decode, the windowed forward, the long training step) and K7's
    launches by kind."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.models import Model
    from repro_torch.models import layers as layers_mod
    from repro_torch.optim import OptimConfig
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.train import TrainConfig, make_train_step

    t_phase = time.perf_counter()
    cfg = get_config("hymba_1_5b")
    model = Model(cfg)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(SEED, device=dev)
    rng = np.random.default_rng(SEED + 2)
    topics = rng.integers(1, cfg.vocab_size, (N_TOPICS, TOPIC_VOCAB))
    B = RING_SERVE["max_batch"]
    prompts = [topics[t][rng.integers(0, TOPIC_VOCAB, RING_PROMPT)]
               for t in rng.integers(0, N_TOPICS, B)]
    calls, counts, res = {}, {}, {}

    # (b) the ring-wrap set
    eng = ServeEngine(cfg, params, ServeConfig(**RING_SERVE, device=dev))
    kv_len = eng.cache["layers"].attn.k.shape[2]
    if kv_len != cfg.sliding_window:
        raise AssertionError(f"hymba's K/V cache holds {kv_len} slots")
    rows, prefill_ms, step_ms = {}, [], []
    _engine_probe(eng, rows, prefill_ms, step_ms)
    zero_counts()
    layers_mod.flash_attention = _k7_capture(fa, calls, counts=counts)
    try:
        for pr in prompts:
            eng.submit(pr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = eng.run_until_drained()
        wall = time.perf_counter() - t0
    finally:
        layers_mod.flash_attention = fa.flash_attention
    st = eng.stats
    k7 = fa.LAUNCHES["flash_attention"]
    if k7 != cfg.n_layers * (st["prefills"] + st["decode_steps"]) or any(
            len(served[i]) != RING_SERVE["max_new_tokens"] for i in range(B)):
        raise AssertionError(f"ring set: {k7} K7 launches, {st}")
    if calls["decode"][2]["valid_len"] != kv_len:
        raise AssertionError(f"the ring decode ran K7 over "
                             f"{calls['decode'][2]['valid_len']} slots")
    wrap = kv_len - RING_PROMPT
    res.update(ring_launches=k7, ring_wall_s=wall,
               ring_tokens_s=st["tokens_out"] / wall,
               ring_step_ms=statistics.median(ms for _, ms in step_ms),
               ring_step_ms_wrapped=statistics.median(
                   ms for _, ms in step_ms[wrap:]),
               ring_prefill_ms=statistics.median(ms for _, ms in prefill_ms),
               **{f"ring_{k}": v for k, v in st.items()})
    log(f"  ring set: {B} prompts of {RING_PROMPT} tokens, "
        f"{RING_SERVE['max_new_tokens']} new tokens each, {RING_SERVE}: "
        f"{st['tokens_out']} tokens in {wall:.2f} s, "
        f"{res['ring_tokens_s']:.1f} tokens/s; {st['prefills']} prefills "
        f"(median {res['ring_prefill_ms']:.2f} ms at B = 1), "
        f"{st['decode_steps']} decode steps (median {res['ring_step_ms']:.3f}"
        f" ms, {res['ring_step_ms_wrapped']:.3f} ms after the ring wrapped "
        f"at step {wrap}); K7 launches {k7} = {cfg.n_layers} x "
        f"({st['prefills']} + {st['decode_steps']}), the ring decode at "
        f"valid_len {kv_len} {tag}")

    # the tokens against the teacher-forced windowed forward (K7's call
    # at B = 8 over the 2,127 positions kept for phase 4)
    fwd_calls, fwd_counts = {}, {}
    layers_mod.flash_attention = _k7_capture(fa, fwd_calls, {"train"},
                                             counts=fwd_counts)
    try:
        gap, scale, limited = teacher_forced_batch(
            model, params, prompts, served, rows, GAP_BOUND, dev)
    finally:
        layers_mod.flash_attention = fa.flash_attention
    calls["window"] = fwd_calls["train"]
    n_tf = B * RING_SERVE["max_new_tokens"]
    res.update(ring_gap=gap, ring_scale=scale, ring_limited=limited)
    log(f"  ring set teacher-forced ({B} requests, {n_tf} tokens, the "
        f"forward over {RING_PROMPT + RING_SERVE['max_new_tokens'] - 1} "
        f"positions with window {cfg.sliding_window}): decode logits within "
        f"{gap:.4g} of the forward's (largest logit {scale:.4g}; bound "
        f"{GAP_BOUND * scale:.4g}); every token the forward's argmax, "
        f"{limited}/{n_tf} steps margin-limited")
    f32 = Model(cfg.replace(compute_dtype="float32"))
    eng32 = ServeEngine(f32.cfg, params, ServeConfig(**RING_SERVE,
                                                     device=dev))
    rows32 = {}
    _engine_probe(eng32, rows32, [], [])
    for pr in prompts[:RING_CHECKED]:
        eng32.submit(pr)
    served32 = eng32.run_until_drained()
    del eng32
    gap32, scale32, limited32 = teacher_forced_batch(
        f32, params, prompts[:RING_CHECKED], served32, rows32,
        GAP_BOUND_F32, dev)
    res.update(ring_gap32=gap32, ring_limited32=limited32)
    n32 = RING_CHECKED * RING_SERVE["max_new_tokens"]
    log(f"  ring set in float32 compute ({RING_CHECKED} requests, {n32} "
        f"tokens): decode logits within {gap32:.4g} of the float32 forward's "
        f"(largest logit {scale32:.4g}; bound {GAP_BOUND_F32 * scale32:.4g}); "
        f"every token the forward's argmax, {limited32}/{n32} steps "
        f"margin-limited")

    # one profiled decode step of 8 rows on the wrapped ring
    saved = dict(fa.LAUNCHES)
    toks = np.array([[served[i][-1]] for i in range(B)], np.int32)
    every = np.ones(B, bool)
    with torch.no_grad():
        prof = profile_batch(
            lambda: eng._decode(toks, RING_SERVE["max_seq"] - 8,
                                every).float().cpu(),
            "decode_hymba_1_5b_ring_B8", ROOT / "chiprun_out",
            expect=("flash_attention",))
    fa.LAUNCHES.update(saved)

    def card_ms(words):
        return sum(dt for dt, _, key in prof
                   if any(w in key.lower() for w in words))

    res.update(ring_prof_k7=card_ms(("flash_attention",)),
               ring_prof_gemm=card_ms(("gemm", "gemv", "nvjet", "xmma",
                                       "cutlass", "cublas", "splitk")),
               ring_prof_copy=card_ms(("copy",)),
               ring_prof_busy=sum(dt for dt, _, _ in prof),
               ring_prof_kernels=sum(c for _, c, _ in prof))
    log(f"  one decode step at B = {B} on the wrapped ring: K7 "
        f"{res['ring_prof_k7']:.4f} ms ({cfg.n_layers} launches), GEMMs "
        f"{res['ring_prof_gemm']:.4f} ms, copies {res['ring_prof_copy']:.4f} "
        f"ms, of {res['ring_prof_busy']:.4f} ms card busy in "
        f"{res['ring_prof_kernels']} kernels {tag}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) training: 8 steps of 8 x 128, then 2 of 2 x 4,096 tokens
    data = dict(TRAIN_DATA, vocab_size=cfg.vocab_size)
    ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=1,
                       decay_steps=TRAIN_STEPS + HYMBA_LONG_STEPS)
    built = make_train_step(cfg, ocfg, TrainConfig(), device=dev)
    params, opt = built["init"](SEED)
    losses, step_ms = [], []
    zero_counts()
    params, opt = _train_steps(built, params, opt,
                               TokenPipeline(DataConfig(**data)), TRAIN_STEPS,
                               0, fa, cfg.n_layers, losses, step_ms)
    res.update(train=_steps_report(
        losses, step_ms, fa.LAUNCHES["flash_attention"], cfg.n_layers,
        cfg, data["global_batch"], data["seq_len"], held, tag))
    long_losses, long_ms, long_calls, long_counts = [], [], {}, {}
    layers_mod.flash_attention = _k7_capture(fa, long_calls, {"train"},
                                             counts=long_counts)
    try:
        params, opt = _train_steps(
            built, params, opt,
            TokenPipeline(DataConfig(**dict(data, **HYMBA_LONG))),
            HYMBA_LONG_STEPS, 0, fa, cfg.n_layers, long_losses, long_ms)
    finally:
        layers_mod.flash_attention = fa.flash_attention
    if not all(np.isfinite(long_losses)) or not max(long_losses) < losses[0]:
        raise AssertionError(f"hymba's 4,096-token losses {long_losses} "
                             f"(first step {losses[0]})")
    calls["train"] = long_calls["train"]
    long_tokens = HYMBA_LONG["seq_len"] * HYMBA_LONG["global_batch"]
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    res.update(long_losses=long_losses, long_ms=long_ms,
               long_tokens_s=long_tokens / (statistics.median(long_ms) / 1e3),
               train_launches=fa.LAUNCHES["flash_attention"],
               peak_gb=peak)
    log(f"  then {HYMBA_LONG_STEPS} steps of {HYMBA_LONG['global_batch']} x "
        f"{HYMBA_LONG['seq_len']} tokens (window {cfg.sliding_window} in K7's "
        f"forward and its gradient's recompute): losses "
        + ", ".join(f"{x:.4f}" for x in long_losses) + "; ms "
        + ", ".join(f"{x:.1f}" for x in long_ms)
        + f", {res['long_tokens_s']:,.0f} tokens/s at the last; peak of the "
        f"phase {peak:.2f} GB besides {held / 1e9:.2f} GB {tag}")
    del params, opt, built
    gc.collect()
    torch.cuda.empty_cache()
    res["by_kind"] = dict(counts, window=fwd_counts["train"],
                          train=long_counts["train"])
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 3n (ring set and training): {res['phase_s']:.1f} s; K7 "
        f"launches by kind {res['by_kind']} (window: the teacher-forced "
        f"forward; train: the {HYMBA_LONG['seq_len']}-token steps, forward "
        f"and recompute)")
    return res, {k: (a, kw) for k, (_, a, kw) in calls.items()}


def _weight_bytes(params):
    """Bytes of every parameter leaf but the embedding (a decode step
    gathers 8 of its rows, not all of it)."""
    from repro_torch.tree import leaves_with_path

    return sum(t.numel() * t.element_size()
               for path, t in leaves_with_path(params) if path[0] != "embed")


def _route_recorder(route, ctx, routes):
    """A stand-in for ``models.moe.route`` that, while ``ctx[0]`` names a
    context, appends each call's experts (sorted a token) to ``routes``
    as (context, [one (T, k) tensor a MoE layer]); a context's calls are
    its MoE layers in order. The tensors stay on the card."""
    import torch

    def recorded(x, router, top_k):
        out = route(x, router, top_k)
        if ctx[0] is not None:
            experts = torch.sort(out[3], dim=-1).values
            if routes and routes[-1][0] is ctx[0]:
                routes[-1][1].append(experts)
            else:
                routes.append((ctx[0], [experts]))
        return out

    return recorded


def _engine_routes(routes, rid, n_prompt):
    """Request ``rid``'s experts a MoE layer, (positions, k), as the
    engine routed them: its prefill, then its row of each decode step."""
    import torch

    pre = next(ts for c, ts in routes if c == ("prefill", rid))
    steps = sorted((c[1], ts, c[2][rid]) for c, ts in routes
                   if c[0] == "decode" and rid in c[2])
    if [pos for pos, _, _ in steps] != list(range(n_prompt,
                                                  n_prompt + len(steps))):
        raise AssertionError(f"request {rid}'s decode positions "
                             f"{[pos for pos, _, _ in steps]}")
    return [torch.cat([pre[i]] + [ts[i][slot:slot + 1]
                                  for _, ts, slot in steps]).cpu()
            for i in range(len(pre))]


def moe_teacher_forced(model, params, prompt, toks, rows, eng_routes,
                       record, dev):
    """``teacher_forced`` for a MoE model, up to the first position whose
    experts the engine and the causal forward chose differently: top-k
    routing is discontinuous, and bf16 operands of other GEMM shapes can
    flip a near-tie choice, after which that token's layer output (and
    every later position's attention to it) legitimately differs. Before
    that position the decode logits must lie within ``GAP_BOUND`` x the
    largest forward logit, and each token be the forward's argmax where
    its margin exceeds ``TIE_FACTOR`` x the gap. ``record`` = (ctx,
    routes) of ``_route_recorder``. Returns (gap, scale, margin-limited
    tokens, tokens held, first differing position or None)."""
    import numpy as np
    import torch

    ctx, routes = record
    seq = np.concatenate([prompt, toks[:-1]])
    ctx[0] = ("forward",)
    try:
        with torch.no_grad():
            logits, _ = model.forward(params, {"tokens": seq[None]},
                                      device=dev)
            f = logits[0, len(prompt) - 1:].cpu().numpy()
            del logits
    finally:
        ctx[0] = None
    fwd = [t.cpu() for t in routes.pop()[1]]
    flip = None
    for a, b in zip(eng_routes, fwd):
        if a.shape != b.shape:
            raise AssertionError(f"routes over {a.shape} and {b.shape}")
        bad = (a != b).any(dim=-1).nonzero()
        if len(bad):
            flip = int(bad[0]) if flip is None else min(flip, int(bad[0]))
    # logits row j is position len(prompt) - 1 + j
    held = len(toks) if flip is None else max(0, flip - len(prompt) + 1)
    scale = float(np.abs(f).max())
    if not held:
        return 0.0, scale, 0, 0, flip
    gap = float(np.abs(np.stack(rows[:held]) - f[:held]).max())
    if not gap <= GAP_BOUND * scale:
        raise AssertionError(f"{model.cfg.name}: decode logits differ from "
                             f"the causal forward's by {gap} (largest logit "
                             f"{scale}) before any expert choice differs")
    limited = 0
    for j in range(held):
        if top2_margin(f[j]) <= TIE_FACTOR * gap:
            limited += 1
        elif toks[j] != int(np.argmax(f[j])):
            raise AssertionError(f"{model.cfg.name} token {j}: {toks[j]}, "
                                 f"the forward's argmax {int(np.argmax(f[j]))}")
    return gap, scale, limited, held, flip


def moe_one(arch, dev, tag, zero_counts):
    """Phase 3o for one MoE config at full width and ``MOE_LAYERS``
    layers (kimi's: its dense front layer and one MoE layer): random bf16
    parameters from seed 0 drawn on the card; ``ServeEngine`` with 8
    slots, 8 requests of 19-123 tokens, 16 new tokens each, K7 launched
    ``MOE_LAYERS`` x (prefills + decode steps); every request held
    against the causal forward (argmax and margin) up to the first
    position whose experts the engine and the forward chose differently
    (``moe_teacher_forced``); one ``loss`` forward on 8 x 128 tokens under
    ``no_grad`` (ce and the MoE terms); one profiled decode step of 8 rows
    against the bytes bound of reading every weight once. Returns its
    measurements and K7's calls."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.models import Model
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import ShapeConfig
    from repro_torch.serve import ServeConfig, ServeEngine

    t_phase = time.perf_counter()
    cfg = get_config(arch).replace(n_layers=MOE_LAYERS)
    model = Model(cfg)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = _weight_bytes(params)
    log(f"  {cfg.name} at full width, {MOE_LAYERS} of "
        f"{get_config(arch).n_layers} layers (first_k_dense "
        f"{cfg.first_k_dense}, {cfg.n_experts} experts top-"
        f"{cfg.experts_per_token}, G = {cfg.n_heads // cfg.n_kv_heads}, D = "
        f"{cfg.head_dim_}): {cfg.param_count():,} {cfg.param_dtype} "
        f"parameters ({cfg.active_param_count():,} active a token), drawn "
        f"on the card from seed {SEED} in {init_s:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated {tag}")
    rng = np.random.default_rng(SEED + 3)
    topics = rng.integers(1, cfg.vocab_size, (N_TOPICS, TOPIC_VOCAB))
    B = MOE_SERVE["max_batch"]
    lens = np.linspace(*MOE_PROMPTS, B).astype(int)
    prompts = [topics[t][rng.integers(0, TOPIC_VOCAB, n)]
               for t, n in zip(rng.integers(0, N_TOPICS, B), lens)]
    calls, counts = {}, {}
    eng = ServeEngine(cfg, params, ServeConfig(**MOE_SERVE, device=dev))
    rows, prefill_ms, step_ms = {}, [], []
    _engine_probe(eng, rows, prefill_ms, step_ms)
    # each route call's experts, by the requests its rows served
    ctx, routes = [None], []
    prefill, decode = eng._prefill_into_slot, eng._decode

    def prefill_routed(slot, req):
        ctx[0] = ("prefill", req.rid)
        try:
            prefill(slot, req)
        finally:
            ctx[0] = None

    def decode_routed(tokens, pos, mask):
        ctx[0] = ("decode", pos, {eng.slot_req[i].rid: int(i)
                                  for i in np.flatnonzero(mask)})
        try:
            return decode(tokens, pos, mask)
        finally:
            ctx[0] = None

    eng._prefill_into_slot, eng._decode = prefill_routed, decode_routed
    route = moe_mod.route
    moe_mod.route = _route_recorder(route, ctx, routes)
    try:
        zero_counts()
        layers_mod.flash_attention = _k7_capture(fa, calls, counts=counts)
        try:
            for pr in prompts:
                eng.submit(pr)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            served = eng.run_until_drained()
            wall = time.perf_counter() - t0
        finally:
            layers_mod.flash_attention = fa.flash_attention
        st = eng.stats
        k7 = fa.LAUNCHES["flash_attention"]
        if k7 != cfg.n_layers * (st["prefills"] + st["decode_steps"]) or any(
                len(served[i]) != MOE_SERVE["max_new_tokens"]
                for i in range(B)):
            raise AssertionError(f"{cfg.name}: {k7} K7 launches, {st}")
        checked = [moe_teacher_forced(
            model, params, prompts[rid], served[rid], rows[rid],
            _engine_routes(routes, rid, len(prompts[rid])), (ctx, routes),
            dev) for rid in range(B)]
    finally:
        moe_mod.route = route
        eng._prefill_into_slot, eng._decode = prefill, decode
    del routes
    groups = [g for g, _ in step_ms]
    big = max(groups)
    res = dict(launches=k7, wall_s=wall, tokens_s=st["tokens_out"] / wall,
               step_ms=statistics.median(ms for _, ms in step_ms),
               step_ms_big=statistics.median(ms for g, ms in step_ms
                                             if g == big), group_big=big,
               prefill_ms=sorted(prefill_ms), init_s=init_s,
               G=cfg.n_heads // cfg.n_kv_heads, **st)
    log(f"  served {B} greedy requests (prompts {min(lens)}-{max(lens)} "
        f"tokens, {MOE_SERVE}) in {wall:.2f} s: {st['tokens_out']} tokens, "
        f"{res['tokens_s']:.1f} tokens/s; {st['prefills']} prefills, "
        f"{st['decode_steps']} decode steps (median {res['step_ms']:.3f} ms, "
        f"{res['step_ms_big']:.3f} ms at {big} rows); K7 launches {k7} = "
        f"{cfg.n_layers} x ({st['prefills']} + {st['decode_steps']}) {tag}")
    log("  prefill ms by prompt length (host clock, B = 1): " + ", ".join(
        f"{n}: {ms:.2f}" for n, ms in res["prefill_ms"]) + f" {tag}")
    gap = max(c[0] for c in checked)
    scale = max(c[1] for c in checked)
    limited = sum(c[2] for c in checked)
    n_held = sum(c[3] for c in checked)
    flips = [c[4] - len(prompts[i]) if c[4] is not None else None
             for i, c in enumerate(checked)]
    n_tf = B * MOE_SERVE["max_new_tokens"]
    res.update(gap=gap, scale=scale, limited=limited, held=n_held,
               flips=flips)
    log(f"  teacher-forced ({B} requests, {n_tf} tokens): "
        f"{n_held} tokens held, up to each request's first position whose "
        f"experts the engine and the forward chose differently (by request, "
        f"relative to the prompt's end; None: none differs): {flips}; decode "
        f"logits within {gap:.4g} of the causal forward's there (largest "
        f"logit {scale:.4g}; bound {GAP_BOUND * scale:.4g}); every held "
        f"token the forward's argmax, {limited}/{n_held} margin-limited")

    # one loss forward on 8 x 128 tokens
    batch = TokenPipeline(DataConfig(**dict(
        TRAIN_DATA, vocab_size=cfg.vocab_size))).global_batch_at(0)
    saved = dict(fa.LAUNCHES)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = model.loss(params, batch, device=dev)
        m = {k: float(v) for k, v in m.items()}
        loss_ms = (time.perf_counter() - t0) * 1e3
    fa.LAUNCHES.update(saved)
    if not all(np.isfinite(list(m.values()))) or not {
            "moe_lb", "moe_rz", "dropped_fraction"} <= set(m):
        raise AssertionError(f"{cfg.name} loss metrics {m}")
    res.update(loss=m, loss_ms=loss_ms)
    log(f"  loss forward on 8 x 128 tokens (no_grad, host clock "
        f"{loss_ms:.1f} ms): " + ", ".join(f"{k} {v:.6g}"
                                          for k, v in sorted(m.items()))
        + f" {tag}")

    # one profiled decode step, all 8 rows at one position
    toks = np.array([[served[i][-1]] for i in range(B)], np.int32)
    every = np.ones(B, bool)
    saved = dict(fa.LAUNCHES)
    pos = MOE_SERVE["max_seq"] - 8
    with torch.no_grad():
        prof, peak, before = step_peak(lambda: profile_batch(
            lambda: eng._decode(toks, pos, every).float().cpu(),
            f"decode_{arch}_{MOE_LAYERS}L_B8", ROOT / "chiprun_out",
            expect=("flash_attention",)))
    fa.LAUNCHES.update(saved)
    busy = sum(dt for dt, _, _ in prof)
    gemm = sum(dt for dt, _, key in prof if any(
        w in key.lower() for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                                   "cublas", "splitk")))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    res.update(prof_busy=busy, prof_gemm=gemm, bytes=nbytes, bound_ms=bound)
    log(f"  one decode step at B = {B}: card busy {busy:.4f} ms (GEMMs "
        f"{gemm:.4f} ms) against the bytes bound {bound:.4f} ms (every "
        f"weight but the embedding read once, {nbytes / 1e9:.2f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s: C = T = {B}, so each expert's "
        f"GEMMs run) {tag}")
    res["roofline"] = roofline_check(
        f"3o {cfg.name} decode step", cfg,
        ShapeConfig("3o", MOE_SERVE["max_seq"], B, "decode"), busy, peak,
        held, tag, pos=pos)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    res["peak_gb"] = (max(before, torch.cuda.max_memory_allocated())
                      - held) / 1e9
    res["counts"] = counts
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 3o {cfg.name}: {res['phase_s']:.1f} s; peak allocated "
        f"{res['peak_gb']:.2f} GB besides {held / 1e9:.2f} GB {tag}")
    return res, {k: (a, kw) for k, (_, a, kw) in calls.items()}


# ------------------------------------------------------- the vlm family
LLAVA_B = 8                     # rows of 3p's prefill and decode steps
LLAVA_PROMPT = 100              # text tokens of each prompt
LLAVA_NEW = 32                  # decode steps after the prefill
LLAVA_PROFILE_NEW = 8           # decode steps under the optimized profile
LLAVA_TRAIN_LAYERS = 4          # llava's training depth on one card
LLAVA_TRAIN = dict(seq_len=128, global_batch=2)   # the text of a batch
LLAVA_TRAIN_STEPS = 4
LLAVA_F32_ROWS = 2              # requests served again in float32 compute
LLAVA_F32_NEW = 16              # their decode steps


def _patch_embeds(cfg, n, seed, dev):
    """(n, vision_tokens, d_model) random patch embeddings in bf16, drawn
    on the card from ``seed``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((n, cfg.vision_tokens, cfg.d_model), generator=g,
                       device=dev).to(torch.bfloat16)


def llava_generate(model, params, prompts, vis, steps, dev):
    """Greedy generation at B = len(prompts): one ``Model.prefill`` of the
    patch embeddings and the prompts, the cache padded to vision_tokens +
    prompt + ``steps`` positions through ``init_cache``, then ``steps``
    ``Model.decode_step``s from pos = vision_tokens + prompt. Returns
    (tokens (B, steps + 1), the logits rows they were chosen from (B,
    steps + 1, V) on the host, prefill ms and each decode step's ms on the
    host clock to the chosen tokens, the cache)."""
    import numpy as np
    import torch

    from repro_torch.tree import leaves

    B, T = prompts.shape
    n_vis = vis.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, pre = model.prefill(params, {"tokens": prompts,
                                             "vision_embeds": vis},
                                    device=dev)
        rows = [logits.float().cpu().numpy()]
    prefill_ms = (time.perf_counter() - t0) * 1e3
    cache = model.init_cache(B, n_vis + T + steps, device=dev)
    for full, part in zip(leaves(cache), leaves(pre)):
        full[:, :, :part.shape[2]].copy_(part)
    del pre, logits
    toks = [rows[0].argmax(-1).astype(np.int32)]
    step_ms = []
    with torch.no_grad():
        for i in range(steps):
            t0 = time.perf_counter()
            logits, _ = model.decode_step(params, cache, toks[-1][:, None],
                                          n_vis + T + i, device=dev)
            rows.append(logits.float().cpu().numpy())
            toks.append(rows[-1].argmax(-1).astype(np.int32))
            step_ms.append((time.perf_counter() - t0) * 1e3)
    return np.stack(toks, 1), np.stack(rows, 1), prefill_ms, step_ms, cache


def llava_forward_rows(model, params, prompts, vis, toks, dev):
    """The causal forward over the patch embeddings, the prompts and the
    generated tokens but the last (teacher forcing): its logits at the
    positions each token was chosen from, (B, steps + 1, V) on the
    host."""
    import numpy as np
    import torch

    seq = np.concatenate([prompts, toks[:, :-1]], axis=1)
    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": seq,
                                           "vision_embeds": vis}, device=dev)
        f = logits[:, prompts.shape[1] - 1:].cpu().numpy()
    return f


def llava_path(dev, tag, zero_counts):
    """Phase 3p: llava-next-34b at full width and depth (60 layers, 34.4 B
    bf16 parameters drawn on the card from seed 0): (a) serving, one
    ``Model.prefill`` of ``LLAVA_B`` rows of 576 patch embeddings and
    ``LLAVA_PROMPT`` text tokens, then ``LLAVA_NEW`` decode steps from the
    padded cache, every token the teacher-forced forward's argmax where
    its margin exceeds ``TIE_FACTOR`` x the bf16 gap, the prefill's logits
    within ``GAP_BOUND`` of the largest (the decode steps' bf16 gap, GEMMs
    at M = 8 against M = 5,664 over 60 layers, exceeds it and is
    reported), and ``LLAVA_F32_ROWS`` requests served again in float32
    compute for ``LLAVA_F32_NEW`` steps, their decode logits within
    ``GAP_BOUND_F32`` of the float32 forward's and every token its argmax
    where the margin is not a tie; one profiled decode step against the
    bytes bound of every weight and the cache read once; (b) one loss
    forward at full depth on 2 x (576 + 128) positions; (c)
    ``make_train_step`` at full width and ``LLAVA_TRAIN_LAYERS`` layers,
    ``LLAVA_TRAIN_STEPS`` steps of 2 x (576 + 128); (d) the optimized
    profile (``optimized_overrides``: 64 q heads, G = 8) at full depth,
    one prefill and ``LLAVA_PROFILE_NEW`` decode steps held in bf16 as in
    (a).
    Returns its measurements and K7's calls (prefill and decode, and the
    profile's)."""
    import types

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.profiles import optimized_overrides
    from repro_torch.data import DataConfig, TokenPipeline
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.models import Model
    from repro_torch.models import layers as layers_mod
    from repro_torch.models.common import ShapeConfig
    from repro_torch.optim import OptimConfig
    from repro_torch.train import TrainConfig, make_train_step

    t_phase = time.perf_counter()
    arch = "llava_next_34b"
    cfg = get_config(arch)
    n_vis, T, B = cfg.vision_tokens, LLAVA_PROMPT, LLAVA_B
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(SEED + 4)
    topics = rng.integers(1, cfg.vocab_size, (N_TOPICS, TOPIC_VOCAB))
    prompts = np.stack([topics[t][rng.integers(0, TOPIC_VOCAB, T)]
                        for t in rng.integers(0, N_TOPICS, B)]).astype(
                            np.int32)
    vis = _patch_embeds(cfg, B, SEED + 4, dev)
    res, calls, counts = {}, {}, {}
    zero_counts()

    def serve(label, model, steps, calls_, counts_):
        """Draw the parameters, generate, hold the tokens against the
        teacher-forced forward, profile one decode step. Returns the
        parameters and the cache."""
        c = model.cfg
        t0 = time.perf_counter()
        params = model.init_params(SEED, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        log(f"  {label}: {c.name} at full width, {c.n_layers} layers, "
            f"{c.n_heads_padded} q heads over {c.n_kv_heads} kv heads (G = "
            f"{c.n_heads_padded // c.n_kv_heads}, D = {c.head_dim_}): "
            f"{c.param_count():,} {c.param_dtype} parameters drawn on the "
            f"card from seed {SEED} in {init_s:.1f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated {tag}")
        k0 = fa.LAUNCHES["flash_attention"]
        layers_mod.flash_attention = _k7_capture(fa, calls_, counts=counts_)
        try:
            toks, rows, prefill_ms, step_ms, cache = llava_generate(
                model, params, prompts, vis, steps, dev)
        finally:
            layers_mod.flash_attention = fa.flash_attention
        k7 = fa.LAUNCHES["flash_attention"] - k0
        if k7 != c.n_layers * (1 + steps):
            raise AssertionError(f"{label}: {k7} K7 launches for 1 prefill "
                                 f"and {steps} decode steps of {c.n_layers} "
                                 f"layers")
        if not np.isfinite(rows).all():
            raise AssertionError(f"{label}: non-finite logits")
        if calls_["decode"][2]["valid_len"] != n_vis + T + steps:
            raise AssertionError(f"{label}: K7 decoded over "
                                 f"{calls_['decode'][2]['valid_len']} keys")
        step = statistics.median(step_ms)
        out = dict(init_s=init_s, prefill_ms=prefill_ms, step_ms=step,
                   step_ms_all=step_ms, tokens_s=B / (step / 1e3),
                   launches=k7)
        log(f"  {label}: prefill of {B} x ({n_vis} patch embeddings + {T} "
            f"tokens) {prefill_ms:.1f} ms (host clock to the logits on the "
            f"host); {steps} decode steps at B = {B} from pos {n_vis + T}, "
            f"median {step:.3f} ms (first {step_ms[0]:.3f}, host clock to "
            f"the chosen tokens), {out['tokens_s']:.1f} tokens/s; K7 "
            f"launches {k7} = {c.n_layers} x (1 + {steps}) {tag}")
        k0 = fa.LAUNCHES["flash_attention"]
        f = llava_forward_rows(model, params, prompts, vis, toks, dev)
        if fa.LAUNCHES["flash_attention"] - k0 != c.n_layers:
            raise AssertionError(f"{label}: the forward launched K7 "
                                 f"{fa.LAUNCHES['flash_attention'] - k0} "
                                 f"times")
        # bf16: the prefill's row (the shapes of the forward's GEMMs) within
        # GAP_BOUND; the decode rows' gap (GEMMs at M = 8 against the
        # forward's M = 5,664, over 60 layers) is measured and bounds the
        # margins, but exceeds GAP_BOUND at this depth: float32 compute
        # holds the decode below
        scale = float(np.abs(f).max())
        gap0 = float(np.abs(rows[:, 0] - f[:, 0]).max())
        gap = float(np.abs(rows - f).max())
        if not gap0 <= GAP_BOUND * scale:
            raise AssertionError(f"{label}: prefill logits differ from the "
                                 f"causal forward's by {gap0} (largest "
                                 f"logit {scale})")
        srt = np.sort(f, axis=-1)
        clear = srt[..., -1] - srt[..., -2] > TIE_FACTOR * gap
        bad = clear & (toks != f.argmax(-1))
        if bad.any():
            i, j = np.argwhere(bad)[0]
            raise AssertionError(f"{label} request {i} token {j}: "
                                 f"{toks[i, j]}, the forward's argmax "
                                 f"{f[i, j].argmax()}")
        n_tf = B * (steps + 1)
        out.update(gap0=gap0, gap=gap, scale=scale,
                   limited=int(n_tf - clear.sum()), checked=n_tf,
                   launches=out["launches"] + c.n_layers)
        log(f"  {label} teacher-forced, bf16 ({B} requests, {n_tf} tokens, "
            f"one forward over {n_vis} + {T + steps} positions): the "
            f"prefill's logits within {gap0:.4g} of the forward's (largest "
            f"logit {scale:.4g}; bound {GAP_BOUND * scale:.4g}); the decode "
            f"steps' within {gap:.4g} ({gap / scale:.4f} of the largest "
            f"logit, GAP_BOUND {GAP_BOUND:.4f}); every token the forward's "
            f"argmax but {out['limited']}/{n_tf} margin-limited (margin <= "
            f"{TIE_FACTOR:g} x {gap:.4g}) {tag}")
        # one profiled decode step: the last one again (the same token at
        # the same position writes the same K/V)
        pos = n_vis + T + steps - 1
        last = toks[:, steps - 1:steps]
        saved = dict(fa.LAUNCHES)
        pst = {}
        with torch.no_grad():
            prof, peak, before = step_peak(lambda: profile_batch(
                lambda: model.decode_step(params, cache, last, pos,
                                          device=dev)[0].float().cpu(),
                f"decode_{arch}_{label.replace(' ', '_')}_B{B}",
                ROOT / "chiprun_out",
                expect=("flash_attention",), stats=pst))
        fa.LAUNCHES.update(saved)

        def card_ms(words):
            return sum(dt for dt, _, key in prof
                       if any(w in key.lower() for w in words))

        from repro_torch.tree import leaves
        cache_bytes = sum(t.numel() * t.element_size() for t in leaves(cache))
        nbytes = _weight_bytes(params) + cache_bytes
        busy = sum(dt for dt, _, _ in prof)
        out.update(prof_busy=busy, prof_wall=pst.get("wall_ms"),
                   prof_idle=1 - busy / pst["wall_ms"] if pst else None,
                   prof_k7=card_ms(("flash_attention",)),
                   prof_gemm=card_ms(("gemm", "gemv", "nvjet", "xmma",
                                      "cutlass", "cublas", "splitk")),
                   prof_copy=card_ms(("copy",)),
                   prof_kernels=sum(n for _, n, _ in prof), bytes=nbytes,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        log(f"  {label}: one decode step at B = {B}, pos {pos}: card busy "
            f"{busy:.4f} ms (idle share "
            f"{out['prof_idle'] if pst else float('nan'):.3f}) in "
            f"{out['prof_kernels']} kernels: K7 {out['prof_k7']:.4f} ms, "
            f"GEMMs {out['prof_gemm']:.4f} ms, copies {out['prof_copy']:.4f} "
            f"ms; the bytes bound {out['bound_ms']:.4f} ms (every weight "
            f"but the embedding and the {cache_bytes / 1e9:.2f} GB cache read "
            f"once: {nbytes / 1e9:.2f} GB at {HBM_BYTES_PER_S / 1e12:.2f} "
            f"TB/s) {tag}")
        slots = leaves(cache)[0].shape[2]
        out["roofline"] = roofline_check(
            f"{label} {c.name} decode step", c,
            ShapeConfig(label, slots, B, "decode"), busy, peak, held, tag,
            pos=pos)
        out["peak_before"] = before
        return params, cache, out

    # (a) serving at full depth
    model = Model(cfg)
    params, cache, res["serve"] = serve("3p", model, LLAVA_NEW, calls,
                                        counts)
    del cache
    # the same requests in float32 compute (the same bf16 parameters, K7's
    # float32 path), held against the float32 forward within GAP_BOUND_F32
    f32 = Model(cfg.replace(compute_dtype="float32"))
    k0 = fa.LAUNCHES["flash_attention"]
    n32 = LLAVA_F32_ROWS
    toks32, rows32, pre32_ms, step32_ms, cache = llava_generate(
        f32, params, prompts[:n32], vis[:n32], LLAVA_F32_NEW, dev)
    del cache
    gap32, scale32, limited32 = teacher_forced_batch(
        f32, params, list(prompts[:n32]),
        {i: list(toks32[i]) for i in range(n32)},
        {i: list(rows32[i]) for i in range(n32)}, GAP_BOUND_F32, dev,
        extra={"vision_embeds": vis[:n32]})
    k32 = fa.LAUNCHES["flash_attention"] - k0
    if k32 != cfg.n_layers * (LLAVA_F32_NEW + 2):
        raise AssertionError(f"3p float32: {k32} K7 launches")
    n_tf = n32 * (LLAVA_F32_NEW + 1)
    res["f32"] = dict(gap=gap32, scale=scale32, limited=limited32,
                      checked=n_tf, launches=k32, prefill_ms=pre32_ms,
                      step_ms=statistics.median(step32_ms))
    log(f"  3p float32 compute ({n32} requests, {LLAVA_F32_NEW} decode "
        f"steps: prefill {pre32_ms:.1f} ms, a step "
        f"{res['f32']['step_ms']:.1f} ms): decode logits within "
        f"{gap32:.4g} of the float32 forward's (largest logit "
        f"{scale32:.4g}; bound {GAP_BOUND_F32 * scale32:.4g}); every token "
        f"the forward's argmax, {limited32}/{n_tf} margin-limited; K7 "
        f"launches {k32} {tag}")

    # (b) one loss forward at full depth on 2 x (576 + 128) positions
    data = dict(LLAVA_TRAIN, vocab_size=cfg.vocab_size)
    pipe = TokenPipeline(DataConfig(**data))
    nb = data["global_batch"]
    batch = dict(pipe.global_batch_at(0), vision_embeds=vis[:nb])
    k0 = fa.LAUNCHES["flash_attention"]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = model.loss(params, batch, device=dev)
        m = {k: float(v) for k, v in m.items()}
        loss_ms = (time.perf_counter() - t0) * 1e3
    if not all(np.isfinite(list(m.values()))) or \
            fa.LAUNCHES["flash_attention"] - k0 != cfg.n_layers:
        raise AssertionError(f"llava loss forward: {m}, "
                             f"{fa.LAUNCHES['flash_attention'] - k0} K7 "
                             f"launches")
    res.update(loss=m, loss_ms=loss_ms)
    log(f"  3p loss forward on {nb} x ({n_vis} + {data['seq_len']}) positions "
        f"(no_grad, host clock {loss_ms:.1f} ms): " + ", ".join(
            f"{k} {v:.6g}" for k, v in sorted(m.items())) + f" {tag}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["serve_peak_gb"] = (max(res["serve"]["peak_before"],
                                torch.cuda.max_memory_allocated())
                            - held) / 1e9
    torch.cuda.reset_peak_memory_stats()

    # (c) training at full width, LLAVA_TRAIN_LAYERS layers
    tcfg = cfg.replace(n_layers=LLAVA_TRAIN_LAYERS)
    ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=1,
                       decay_steps=LLAVA_TRAIN_STEPS)
    built = make_train_step(tcfg, ocfg, TrainConfig(), device=dev)
    t0 = time.perf_counter()
    tparams, opt = built["init"](SEED)
    torch.cuda.synchronize()
    log(f"  3p training: {tcfg.name} at full width, {tcfg.n_layers} of "
        f"{cfg.n_layers} layers: {tcfg.param_count():,} {tcfg.param_dtype} "
        f"parameters with their AdamW state from seed {SEED} in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{(torch.cuda.memory_allocated() - held) / 1e9:.2f} GB {tag}")
    vis_t = _patch_embeds(cfg, nb, SEED + 5, dev)
    with_vis = types.SimpleNamespace(global_batch_at=lambda s: dict(
        pipe.global_batch_at(s), vision_embeds=vis_t))
    losses, step_ms = [], []
    k0 = fa.LAUNCHES["flash_attention"]
    tparams, opt = _train_steps(built, tparams, opt, with_vis,
                                LLAVA_TRAIN_STEPS, 0, fa, tcfg.n_layers,
                                losses, step_ms)
    res["train"] = _steps_report(
        losses, step_ms, fa.LAUNCHES["flash_attention"] - k0, tcfg.n_layers,
        tcfg, nb, n_vis + data["seq_len"], held, tag,
        steps=LLAVA_TRAIN_STEPS)
    del tparams, opt, built, vis_t
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the optimized profile at full depth
    over = optimized_overrides(arch)
    pcalls, pcounts = {}, {}
    params, cache, res["profile"] = serve(
        "3p profile", Model(cfg.replace(**over)), LLAVA_PROFILE_NEW, pcalls,
        pcounts)
    res["profile"]["overrides"] = over
    del params, cache, vis
    gc.collect()
    torch.cuda.empty_cache()
    res["launches"] = fa.LAUNCHES["flash_attention"]
    want = (res["serve"]["launches"] + res["f32"]["launches"] + cfg.n_layers
            + 2 * LLAVA_TRAIN_LAYERS * LLAVA_TRAIN_STEPS
            + res["profile"]["launches"])
    if res["launches"] != want:
        raise AssertionError(f"3p: {res['launches']} K7 launches, not {want}")
    res["counts"] = counts
    res["profile_counts"] = pcounts
    res["peak_gb"] = max(res["serve_peak_gb"], (max(
        res["profile"]["peak_before"], torch.cuda.max_memory_allocated())
        - held) / 1e9)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 3p: {res['phase_s']:.1f} s; K7 launches {res['launches']} "
        f"(serving {res['serve']['launches']}, float32 "
        f"{res['f32']['launches']}, the loss forward "
        f"{cfg.n_layers}, training "
        f"{2 * LLAVA_TRAIN_LAYERS * LLAVA_TRAIN_STEPS}, the profile "
        f"{res['profile']['launches']}); peak allocated "
        f"{res['peak_gb']:.2f} GB besides {held / 1e9:.2f} GB {tag}")
    k7 = {k: (a, kw) for k, (_, a, kw) in calls.items()}
    k7.update({f"profile_{k}": (a, kw) for k, (_, a, kw) in pcalls.items()})
    return res, k7


def check_kernel_api(torch, dev, index, q_words, p):
    """Phase 2: the reference's kernel API (ROADMAP C-P4) on the card: the
    package's ``verify_tuples_grouped`` on a padded (B, C, W) block (one K1
    launch), ``ops.verify_tuples_grouped_op`` on the index's resident
    codes, and ``ops.device_probe_scan_launch`` and
    ``device_probe_scan_multi_launch`` on its CSR, each equal to the same
    call on CPU copies (the plain versions); the package's other four
    names are the wrappers phase 2 checks. Returns the calls checked."""
    import numpy as np

    import repro_torch.kernels as kpkg
    from repro_torch.core import probe_device as pd
    from repro_torch.kernels import ops, ref

    vt = importlib.import_module("repro_torch.kernels.verify_tuples")
    for name, mod in (("blockmax_scores", "blockmax_scan"),
                      ("flash_attention", "flash_attention"),
                      ("hamming_scan_scores", "hamming_scan"),
                      ("verify_tuples", "verify_tuples")):
        mod = importlib.import_module(f"repro_torch.kernels.{mod}")
        if getattr(kpkg, name) is not getattr(mod, name):
            raise AssertionError(f"repro_torch.kernels.{name} is not the "
                                 f"kernel wrapper")
    rng = np.random.default_rng(SEED)
    W = (p + 31) // 32
    B, C = 8, 512
    q = torch.from_numpy(rng.integers(0, 1 << 32, (B, W), dtype=np.uint64)
                         .astype(np.uint32).view(np.int32))
    cand = torch.from_numpy(rng.integers(0, 1 << 32, (B, C, W),
                                         dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))
    lens = torch.tensor([0, 1, 17, 100, 511, 512, 300, 2], dtype=torch.int32)
    saved = dict(vt.LAUNCHES)
    got = kpkg.verify_tuples_grouped(q.to(dev), cand.to(dev), lens.to(dev),
                                     p=p)
    if vt.LAUNCHES["verify_grouped"] != saved["verify_grouped"] + 1:
        raise AssertionError("verify_tuples_grouped did not launch K1 once")
    if not torch.equal(got.cpu(), ref.verify_tuples_grouped_ref(q, cand,
                                                                lens, p)):
        raise AssertionError("verify_tuples_grouped differs from its plain "
                             "version")
    db = index.db_dev
    n = db.shape[0]
    idx = rng.integers(0, n, (B, C)).astype(np.int32)
    dkey = ops.device_key(db.device)
    before = ops.LAUNCH_COUNTS_BY_DEVICE.get(dkey, 0)
    got = ops.verify_tuples_grouped_op(q.numpy(), db, idx, lens.numpy(), p=p)
    want = ops.verify_tuples_grouped_op(q.numpy(), db.cpu(), idx,
                                        lens.numpy(), p=p)
    if not np.array_equal(got, want):
        raise AssertionError("verify_tuples_grouped_op differs on the card")
    if ops.LAUNCH_COUNTS_BY_DEVICE.get(dkey, 0) != before + 1:
        raise AssertionError("LAUNCH_COUNTS_BY_DEVICE missed the launch")
    csr = index.device_csr
    csr_cpu = {k: (v.cpu() if torch.is_tensor(v) else v)
               for k, v in csr.items()}
    qh = np.ascontiguousarray(q_words[:4])
    zs = np.bitwise_count(qh.view(np.uint32)).sum(axis=1)
    sched = pd.get_schedule(p, index.m, csr["widths"], int(zs[0]),
                            index.probe_stream_cap)
    got = ops.device_probe_scan_launch(qh, sched=sched, csr=csr, p=p)
    if not np.array_equal(got, ops.device_probe_scan_launch(
            qh, sched=sched, csr=csr_cpu, p=p)):
        raise AssertionError("device_probe_scan_launch differs on the card")
    stack = pd.ScheduleStack(p, index.m, tuple(csr["widths"]),
                             index.probe_stream_cap)
    gid = np.array([stack.row(int(z)) for z in zs], np.int32)
    got = ops.device_probe_scan_multi_launch(qh, gid, stack=stack, csr=csr,
                                             p=p)
    if not np.array_equal(got, ops.device_probe_scan_multi_launch(
            qh, gid, stack=stack, csr=csr_cpu, p=p)):
        raise AssertionError("device_probe_scan_multi_launch differs on the "
                             "card")
    return (f"verify_tuples_grouped (B={B}, C={C}, W={W}), "
            f"verify_tuples_grouped_op, device_probe_scan_launch and "
            f"device_probe_scan_multi_launch (4 queries over n={n:,})")


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
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.kernels import hamming_scan as hs
    vt = importlib.import_module("repro_torch.kernels.verify_tuples")
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
    check_flash_build(_build)

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
    with Recorder(sites(dp, Recorder.WALKS), keep=8) as rec:
        eng.knn_batch(q_s, 10)                    # batched walk, G > 1
        eng.knn_batch(q_s[:1], 10)                # per-group walk, G = 1
        eng.index.probe_fused = False
        eng.knn_batch(q_s[:16], 10)               # per-group walks + scans
        eng.index.probe_fused = True
        # a truncated probe stream sends queries to the scan
        eng2 = make_engine("amih", db_s, 64, m=4, query_cache_size=0,
                           probe_stream_cap=256)
        eng2.knn_batch(q_s, 10)
        # k above the fused scan's cap: the map route
        eng2.knn_batch(q_s[:8], 2 * dp.KCAP_MAX)
        eng2.index.probe_fused = False            # ... and the per-group scan
        eng2.knn_batch(q_s, 10)
    missing = set(Recorder.WALKS) - set(rec.calls)
    if missing:
        raise AssertionError(f"phase 2 never called {sorted(missing)}")
    check_walk_calls(dp, rec, "n=2^18")
    # B4b: the fused scan with one inv_pos row (a per-group bail), timed
    g1 = [c for c in rec.calls["device_probe_scan_topk"]
          if c[0][4].shape[0] == 1]
    if not g1:
        raise AssertionError("phase 2 never ran a per-group bail scan")
    small = check_scan_topk_call(dp, *g1[0], timed=True, reps=20)
    a = small["args"]
    Bs, Ws = a[0].shape
    small["bound_ms"], small["bound_by"] = scan_bound_ms_pairs(
        Bs, int(a[5]), Ws, Bs * a[6] * 2)
    log(f"  device_probe_scan_topk (G = 1) n=2^18 B={Bs} k={a[6]}: kernel "
        f"{small['ms']:.4f} ms (map kernel {small['map_ms']:.4f} ms), plain "
        f"{small['plain_ms']:.2f} ms, bound {small['bound_ms']:.4f} ms "
        f"({small['bound_by']}) {tag}")
    log(f"  K2 last launch: {dp.LAST_WALK_GRID[0]} blocks x "
        f"{dp.LAST_WALK_GRID[1]} threads, {dp.LAST_WALK_GRID[2]} form")
    kernels46 = scan_kernels(hs, bm, vt)
    for p in (64, 128):
        names = check_scan_kernels(kernels46, ops, torch, dev, p)
        log(f"  {', '.join(names)} p={p} n=2^18 B=64: equal bit for bit")
    n1, n5 = check_edge_shapes(vt, bm, ops, torch, dev)
    log(f"  K1 at {n1} edge shapes (W = 1 to 8 and 10, C 1 to 5000, lengths "
        f"0, C and ragged, the last row, offset index and code views) and K5 "
        f"at {n5} (W = 1 to 8, B 1 to 64, blk 1, 37, 128, 1000, 2048 and "
        f"N + 5 over 70,001 codes, offset code views): equal bit for bit")
    worst = check_flash_cases(fa, torch, dev)
    log(f"  K7 flash_attention, {len(FLASH_CASES)} cases x float32/bf16 "
        f"(MHA, GQA, MQA, G = 3, 5, 7; causal or not; windows 8, 16, 24, 64; "
        f"llava's 676-position prefill and 708-key decode at G = 7 and 8; "
        f"valid_len 0, 1, 37, 100, 160; Sq, Sk 100, 130, 160; D 16, 20, 32, "
        f"48, 64, 112, 128, 256, 320, 512; G up to 96) against the plain "
        f"version in "
        f"float32: within tolerance (float32 2e-5, bf16 "
        f"4e-3 * max(1, |plain|)), largest differences {worst}")
    api = check_kernel_api(torch, dev, eng.index, q_s, 64)
    log(f"  the reference's kernel API (C-P4) on the card: {api}: equal to "
        f"the same calls on CPU copies; the package's five names are the "
        f"kernel wrappers")
    torch.cuda.synchronize()
    del eng, eng2, rec
    gc.collect()
    torch.cuda.empty_cache()
    if args.quick:
        log(f"quick run done in {time.perf_counter() - t_start:.1f} s")
        return 0

    # ---- phase 3: the main path at full size
    log(f"phase 3: main paths, n={N_MAIN:,} clustered codes {tag}")
    counted = (dp, vt, hs, bm, fa)

    def zero_counts():
        for mod in counted:
            for c in mod.LAUNCHES:
                mod.LAUNCHES[c] = 0
        REGISTRY.reset("launches.")

    def add_counts(total):
        for mod in counted:
            for c, v in mod.LAUNCHES.items():
                total[c] = total.get(c, 0) + v

    def read_counts():
        total = {}
        add_counts(total)
        return total

    # 3p first: llava's 68.9 GB of parameters (70.6 GB under its profile)
    # need a card that holds nothing else, and the operands a to e keep
    # for phase 4 take ~9.3 GB
    log(f"phase 3p: llava-next-34b at full width and depth {tag}")
    llava, k7_llava = llava_path(dev, tag, zero_counts)
    gc.collect()
    torch.cuda.empty_cache()
    amih_counts, scan_counts, shard_counts = {}, {}, {}
    shard_rows = []                       # phase 3d (label, ms/query)
    cluster_rows, cluster_counts = [], {}  # phase 3e
    walk_shapes = {}                      # K2/K3 launches by wrapper and B
    captured = {}
    captured_scan = {}
    timings = []
    scan_timings = []
    pruned_timings = []
    for p, m in ((64, 4), (128, 8)):
        t0 = time.perf_counter()
        db = synthetic_binary_codes_packed(N_MAIN, p, seed=SEED)
        qs = synthetic_queries_packed(db, p, 64 + 1 + 5 + K_CHECK,
                                      seed=SEED + 1)
        t_gen = time.perf_counter() - t0
        zero_counts()                     # path a: AMIH
        walk_rec = Recorder(sites(dp, Recorder.WALKS), keep=0).__enter__()
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
                its = [int(t) for _, _, t in rec.iters]
                log(f"  p={p} B={B} K={K}: {med:.4f} ms/query (median of 5 "
                    f"warm batches) {tag}; walk launches/batch "
                    f"{walks / n_batches:.0f}, scan launches/batch "
                    f"{scans / n_batches:.2f}, bailed {bails}/{B} in the "
                    f"last batch; K2 iterations per launch {its}; equal to "
                    f"probe_fused=False and exact vs the linear scan")
                for name, calls in rec.calls.items():
                    captured.setdefault((p, B, K, name), calls)
        # k above the fused scan's cap: the bails take the map route (the
        # map-writing K3, then the map extraction)
        K = 2 * dp.KCAP_MAX
        m0 = dp.LAUNCHES["probe_scan"]
        with Recorder(sites(dp, Recorder.WALKS), keep=1) as rec:
            ids, sims, st = eng.knn_batch(batch, K)
        check_scan(range(K_CHECK), ids[:K_CHECK], sims[:K_CHECK], K, 0)
        eng.index.probe_fused = False
        try:
            o_ids, o_sims, _ = eng.knn_batch(batch, K)
        finally:
            eng.index.probe_fused = True
        if not (np.array_equal(o_ids, ids) and np.array_equal(o_sims, sims)):
            raise AssertionError(f"p={p} K={K}: fused walk differs from "
                                 "probe_fused=False")
        bails = sum(s.fell_back_to_scan for s in st.per_query)
        log(f"  p={p} B=64 K={K}: bailed {bails}/64, "
            f"{dp.LAUNCHES['probe_scan'] - m0} map-scan launches (two "
            f"batches); equal to probe_fused=False and exact vs the linear "
            f"scan")
        for name, calls in rec.calls.items():
            captured.setdefault((p, 64, K, name), calls)
        if p == 128:
            # where the time goes: one traced batch per shape
            out_dir = ROOT / "chiprun_out"
            profile_batch(lambda: eng.knn_batch(batch, 10), "p128_B64_K10",
                          out_dir, expect=("probe_walk", "probe_scan_topk"))
            profile_batch(lambda: eng.knn_batch(singles[1:2], 10),
                          "p128_B1_K10", out_dir, expect=("probe_walk",))
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
        h_launches = host.verify_launches
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
        walk_rec.__exit__(None, None, None)
        for key, n in walk_rec.counts.items():
            walk_shapes[key] = walk_shapes.get(key, 0) + n
        add_counts(amih_counts)

        zero_counts()                     # path d: shards and pipeline
        t0 = time.perf_counter()
        shard_keep = {}
        shard_path(p, m, db, batch, singles, eng, host,
                   (h_ids, h_sims, h_launches), dev=dev, tag=tag, chk=chk,
                   want_topk=want_topk, rows=shard_rows, keep=shard_keep)
        add_counts(shard_counts)
        log(f"  phase 3d p={p}: {time.perf_counter() - t0:.1f} s")
        if p == 128:                      # path e: the cluster tier
            cluster_counts = cluster_path(
                p, m, db, batch, singles, eng, shard_keep, dev=dev, tag=tag,
                want_topk=want_topk, rows=cluster_rows, out_dir=out_dir)
        del shard_keep
        del host, eng
        gc.collect()
        torch.cuda.empty_cache()

        zero_counts()                     # path b: the linear scan
        with Recorder(sites(ops, Recorder.SCANS)) as srec:
            scan_path(p, db, batch, singles, chk, want_topk, amih_rows,
                      dev=dev, tag=tag, timings=scan_timings,
                      pruned=pruned_timings)
        add_counts(scan_counts)
        captured_scan[p] = srec.calls
        del db
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 3c: retrieval serving, gemma-2b encoder at full width "
        f"{tag}")
    retrieval, k7_call = retrieval_path(dev, tag, zero_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3f: token serving, gemma-2b at full width {tag}")
    serving, k7_serve = serve_path(dev, tag, zero_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3g: training, gemma-2b at full width and depth {tag}")
    training = train_path(dev, tag, zero_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3h: token serving, llama3-8b at full width, "
        f"{LLAMA_SERVE_LAYERS} of 32 layers {tag}")
    llama_serving, k7_llama = serve_path(dev, tag, zero_counts,
                                         arch="llama3_8b", label="3h",
                                         layers=LLAMA_SERVE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3i: training, llama3-8b at full width, "
        f"{LLAMA_TRAIN_LAYERS} of 32 layers {tag}")
    llama_training, k7_llama_train = dense_train_path(dev, tag, zero_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3j: granite-3-8b and granite-34b at full width, "
        f"{GRANITE_LAYERS} layers each {tag}")
    granite, k7_granite = granite_path(dev, tag, zero_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3k: the four examples on the card {tag}")
    examples = examples_path(dev, tag, zero_counts, read_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3l: whisper-tiny's encoder-decoder at full width and depth "
        f"{tag}")
    whisper, k7_whisper = whisper_path(dev, tag, zero_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3m: mamba2-1.3b at full width, {MAMBA_SERVE_LAYERS} of 48 "
        f"layers, token serving {tag}")
    mamba_serving, _ = serve_path(dev, tag, zero_counts, arch="mamba2_1_3b",
                                  label="3m", layers=MAMBA_SERVE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3m: mamba2-1.3b training through the CLI {tag}")
    mamba_training = mamba_train_path(dev, tag, zero_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3n: hymba-1.5b at full width, {HYMBA_SERVE_LAYERS} of 32 "
        f"layers, token serving {tag}")
    hymba_serving, _ = serve_path(dev, tag, zero_counts, arch="hymba_1_5b",
                                  label="3n", layers=HYMBA_SERVE_LAYERS,
                                  cli=False)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3n: hymba-1.5b past its window of 2,048: the ring set and "
        f"training {tag}")
    hymba, k7_hymba = hymba_path(dev, tag, zero_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3o: arctic-480b and kimi-k2 at full width, {MOE_LAYERS} "
        f"layers each {tag}")
    moe, k7_moe = {}, {}
    for arch in ("arctic_480b", "kimi_k2_1t_a32b"):
        moe[arch], k7_moe[arch] = moe_one(arch, dev, tag, zero_counts)
        gc.collect()
        torch.cuda.empty_cache()
    launches = {"verify_grouped": amih_counts["verify_grouped"],
                "probe_walk": amih_counts["probe_walk"],
                "probe_walk_cluster": amih_counts["probe_walk_cluster"],
                "probe_extract": amih_counts["probe_extract"],
                "probe_scan_topk": amih_counts["probe_scan_topk"],
                "probe_scan": amih_counts["probe_scan"],
                "hamming_scan": scan_counts["hamming_scan"],
                "hamming_scan_topk": scan_counts["hamming_scan_topk"],
                "blockmax_scan": scan_counts["blockmax_scan"],
                "verify_tuples": scan_counts["verify_tuples"],
                "flash_attention": retrieval["launches"]
                + serving["launches"] + training["launches"]
                + llama_serving["launches"] + llama_training["launches"]
                + sum(g["launches"] for g in granite.values())
                + whisper["launches"] + whisper["train_launches"]
                + hymba_serving["launches"] + hymba["ring_launches"]
                + hymba["train_launches"]
                + sum(r["launches"] for r in moe.values())
                + llava["launches"]}
    log(f"  kernel launches, AMIH path: {amih_counts}; K2/K3 by wrapper "
        f"and query rows: " + ", ".join(
            f"{name} B={rows}: {n}"
            for (name, rows), n in sorted(walk_shapes.items())))
    log(f"  kernel launches, linear-scan path: {scan_counts}")
    log(f"  kernel launches, shard and pipeline path (3d): {shard_counts}")
    log(f"  K2 launch spans by worker lane in one traced B=64 batch, "
        f"cluster path (3e): {cluster_counts}")
    for name, cnt in launches.items():
        if cnt == 0:
            raise AssertionError(f"kernel {name} never ran on its main path")
    for name in ("verify_grouped", "probe_walk", "probe_extract",
                 "hamming_scan_topk"):
        if shard_counts.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} never ran on path 3d")

    # ---- phase 4: kernels vs plain on main-path operands, timed
    log(f"phase 4: kernels vs plain at main-path shapes, times {tag}")
    per = {}
    for (p, B, K, name), calls in sorted(captured.items(),
                                         key=lambda kv: str(kv[0])):
        if K != 10 and name != "device_probe_scan_multi":
            continue
        sub = Recorder([])
        sub.calls = {name: calls}
        timed = {name} if K == 10 else set()
        res = check_walk_calls(dp, sub, f"p={p} B={B} K={K}", timed=timed)
        W = (p + 31) // 32
        for nm, entry in res.items():
            if "ms" not in entry and "ms_grid" not in entry:
                continue
            if nm == "gather_verify_grouped":
                q_words, _, idx, lens = entry["args"]
                bound, by = verify_bound_ms(q_words.shape[0], idx.shape[1], W,
                                            int(lens.sum()))
                floor = k1_floor(vt, torch, entry["args"], p)
                entry.update(bound_ms=bound, bound_by=by, floor_ms=floor)
                log(f"  {nm} p={p} B={B} (B={q_words.shape[0]}, "
                    f"C={idx.shape[1]}): kernel {entry['ms']:.6f} ms, plain "
                    f"{entry['plain_ms']:.2f} ms, bound {bound:.6f} ms ({by}); "
                    f"at B=1, C=8 (the launch floor) {floor:.6f} ms {tag}")
            elif nm.startswith("device_probe_walk"):
                a = entry["args"]
                k = _walk_tstop_k(nm, a)[1]
                bound, by = walk_bound_ms(entry["out"], W)
                xbound, xby = walk_bound_ms(entry["out"], W, k)
                main = "cluster" if "ms_cluster" in entry else "grid"
                entry.update(bound_ms=bound, bound_by=by, xbound_ms=xbound,
                             xbound_by=xby, ms=entry[f"ms_{main}"],
                             form=main)
                it = max(1, entry["iters"])
                forms = "; ".join(
                    f"{f} form {entry[f'ms_{f}']:.4f} ms "
                    f"({entry[f'ms_{f}'] / it:.5f} ms/iteration)"
                    for f in ("grid", "cluster") if f"ms_{f}" in entry)
                log(f"  {nm} p={p} B={B}: {entry['iters']} iterations, "
                    f"{entry['done_rows']} rows done; {forms}; extraction "
                    f"kernel after it {entry[f'extract_ms_{main}']:.4f} ms "
                    f"(plain {entry['extract_plain_ms']:.2f} ms, bound "
                    f"{extract_bound_ms(entry)[0]:.4f} ms); plain walk "
                    f"{entry['plain_ms']:.2f} ms; bound {bound:.4f} ms "
                    f"({by}), with the extraction {xbound:.4f} ms ({xby}); "
                    f"main-path form {main} {tag}")
            else:
                a = entry["args"]
                q_words, db_pad, n_valid, k = a[0], a[3], int(a[5]), a[6]
                Bq, Wq = q_words.shape
                bound, by = scan_bound_ms_pairs(Bq, n_valid, Wq, Bq * k * 2)
                mbound, mby = scan_bound_ms(q_words, db_pad)
                entry.update(bound_ms=bound, bound_by=by, map_bound_ms=mbound,
                             map_bound_by=mby)
                log(f"  {nm} p={p} B={B} k={k}: fused kernel "
                    f"{entry['ms']:.4f} ms, bound {bound:.4f} ms ({by}), plain "
                    f"{entry['plain_ms']:.2f} ms; map kernel "
                    f"{entry['map_ms']:.4f} ms, bound {mbound:.4f} ms ({mby}), "
                    f"plain {entry['map_plain_ms']:.2f} ms, its extraction "
                    f"{entry['map_extract_ms']:.4f} ms {tag}")
            per[(p, B, nm)] = entry

    scan_meas = {}
    for p in (64, 128):
        for name in Recorder.SCANS:
            calls = captured_scan[p].get(name)
            if not calls:
                raise AssertionError(f"the linear-scan path at p={p} never "
                                     f"called {name}")
            (a, kw), = calls
            shapes = [(name, a)]
            if name in ("hamming_scan_topk", "blockmax_scores"):
                # the same call for the first query alone: B = 1
                shapes.append((name + "_b1",
                               (a[0][:1].contiguous(), a[1][:1].contiguous())
                               + tuple(a[2:])))
            for key, aa in shapes:
                e = check_scan_call(kernels46, name, aa, kw, timed=True)
                scan_meas[p, key] = e
                log(f"  {name} p={p} ({e['shape']}, {e['args']}): kernel "
                    f"{e['ms']:.4f} ms, plain {e['plain_ms']:.2f} ms, bound "
                    f"{e['bound_ms']:.4f} ms ({e['bound_by']}), equal bit for "
                    f"bit {tag}")

    k7 = check_flash_call(fa, *k7_call)
    log(f"  flash_attention ({k7['shape']}): kernel {k7['ms']:.4f} ms, "
        f"plain {k7['plain_ms']:.2f} ms, scaled_dot_product_attention "
        f"{k7['library_ms']:.4f} ms (differs from plain by "
        f"{k7['library_diff']:.4g}), bound {k7['bound_ms']:.4f} ms "
        f"({k7['bound_by']}); within {k7['max_abs_err']:.4g} of plain {tag}")
    k7_path = {}
    for kind in ("decode", "prefill"):
        e = k7_path[kind] = check_flash_call(fa, *k7_serve[kind])
        log(f"  flash_attention, 3f {kind} ({e['shape']}): kernel "
            f"{e['ms']:.4f} ms, plain {e['plain_ms']:.2f} ms, "
            f"scaled_dot_product_attention {e['library_ms']:.4f} ms on the "
            f"same valid keys (differs from plain by "
            f"{e['library_diff']:.4g}), bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}); within {e['max_abs_err']:.4g} of plain "
            f"{tag}")
    for label, calls_, kind in (
            ("3h llama3-8b", k7_llama, "prefill"),
            ("3h llama3-8b", k7_llama, "decode"),
            ("3i llama3-8b", {"train": k7_llama_train}, "train"),
            ("3j granite-34b", k7_granite["granite_34b"], "prefill"),
            ("3j granite-34b", k7_granite["granite_34b"], "decode")):
        e = k7_path[label, kind] = check_flash_call(fa, *calls_[kind])
        log(f"  flash_attention, {label} {kind} ({e['shape']}): kernel "
            f"{e['ms']:.6f} ms, plain {e['plain_ms']:.2f} ms, "
            f"scaled_dot_product_attention {e['library_ms']:.6f} ms on the "
            f"same valid keys (differs from plain by "
            f"{e['library_diff']:.4g}), bound {e['bound_ms']:.6f} ms "
            f"({e['bound_by']}); within {e['max_abs_err']:.4g} of plain "
            f"{tag}")
    # whisper's three operands no earlier path gives K7: the encoder's
    # 1,500-key self-attention, the cross-attention (Sq != Sk) and the
    # cross-attention decode (valid_len 1,500); launches on 3l by kind
    for kind in ("encoder", "cross", "cross_decode"):
        e = k7_path["3l whisper-tiny", kind] = check_flash_call(
            fa, *k7_whisper[kind])
        e["launches"] = whisper["by_kind"][kind]
        log(f"  flash_attention, 3l whisper-tiny {kind} ({e['shape']}): "
            f"kernel {e['ms']:.6f} ms, plain {e['plain_ms']:.2f} ms, "
            f"scaled_dot_product_attention {e['library_ms']:.6f} ms on the "
            f"same keys (differs from plain by {e['library_diff']:.4g}), "
            f"bound {e['bound_ms']:.6f} ms ({e['bound_by']}); "
            f"{e['launches']} launches on 3l; within "
            f"{e['max_abs_err']:.4g} of plain {tag}")

    # K7 on the hybrid's and the MoE family's operands: hymba's windowed
    # forward (the teacher-forced check over 2,127 positions, window
    # 2,048), its ring decode (valid_len 2,048) and its 4,096-token
    # training step; arctic's (G = 7, D = 128) and kimi's (G = 8, D = 112)
    # longest prefill and fullest decode; launches on 3n and 3o by kind
    for label, calls_, kind, n in (
            ("3n hymba-1.5b", k7_hymba, "window", hymba["by_kind"]["window"]),
            ("3n hymba-1.5b", k7_hymba, "decode", hymba["by_kind"]["decode"]),
            ("3n hymba-1.5b", k7_hymba, "train", hymba["by_kind"]["train"]),
            *((f"3o {arch}", k7_moe[arch], kind, moe[arch]["counts"][kind])
              for arch in ("arctic_480b", "kimi_k2_1t_a32b")
              for kind in ("prefill", "decode")),
            # llava's prefill (G = 7 over 676 positions) and decode (708
            # valid keys), and the profile's (G = 8)
            *(("3p llava-next-34b", k7_llava, kind, llava["counts"][kind])
              for kind in ("prefill", "decode")),
            *(("3p llava-next-34b", k7_llava, f"profile_{kind}",
               llava["profile_counts"][kind])
              for kind in ("prefill", "decode"))):
        e = k7_path[label, kind] = check_flash_call(fa, *calls_[kind])
        e["launches"] = n
        log(f"  flash_attention, {label} {kind} ({e['shape']}): kernel "
            f"{e['ms']:.6f} ms, plain {e['plain_ms']:.2f} ms, "
            f"scaled_dot_product_attention {e['library_ms']:.6f} ms on the "
            f"same keys (differs from plain by {e['library_diff']:.4g}), "
            f"bound {e['bound_ms']:.6f} ms ({e['bound_by']}); "
            f"{e['launches']} launches; within {e['max_abs_err']:.4g} of "
            f"plain {tag}")

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
    walk1 = pick(("device_probe_walk",))
    scan = pick(("device_probe_scan_topk",))
    extract = None
    if walk:
        e = walk[1]
        bound, by = extract_bound_ms(e)
        extract = {"max_abs_err": e["extract_err"],
                   "ms": e[f"extract_ms_{e['form']}"],
                   "plain_ms": e["extract_plain_ms"], "bound_ms": bound,
                   "bound_by": by}
    scan_map = None
    if scan:
        e = scan[1]
        scan_map = {"max_abs_err": e["map_max_abs_err"], "ms": e["map_ms"],
                    "plain_ms": e["map_plain_ms"],
                    "bound_ms": e["map_bound_ms"],
                    "bound_by": e["map_bound_by"]}
    for name, src_file, replaces, launches_n, meas in (
        ("verify_grouped", "src/repro_torch/kernels/csrc/verify_grouped.cu",
         "src/repro/kernels/verify_tuples.py:93", launches["verify_grouped"],
         k1_main[1] if k1_main else None),
        ("probe_walk", "src/repro_torch/kernels/csrc/probe_walk.cu",
         "src/repro/kernels/device_probe.py:309", launches["probe_walk"],
         walk[1] if walk else None),
        ("probe_walk_cluster", "src/repro_torch/kernels/csrc/probe_walk.cu",
         "src/repro/kernels/device_probe.py:81",
         launches["probe_walk_cluster"], walk1[1] if walk1 else None),
        ("probe_extract", "src/repro_torch/kernels/csrc/probe_walk.cu",
         "src/repro/core/probe_device.py:614 (the reference's host "
         "extraction after B2/B4a; no Pallas kernel)",
         launches["probe_extract"], extract),
        ("probe_scan_topk", "src/repro_torch/kernels/csrc/probe_scan.cu",
         "src/repro/kernels/device_probe.py:534 with the extraction of "
         "src/repro/core/probe_device.py:614", launches["probe_scan_topk"],
         scan[1] if scan else None),
        ("probe_scan", "src/repro_torch/kernels/csrc/probe_scan.cu",
         "src/repro/kernels/device_probe.py:534", launches["probe_scan"],
         scan_map),
        ("hamming_scan", "src/repro_torch/kernels/csrc/hamming_scan.cu",
         "src/repro/kernels/hamming_scan.py:62", launches["hamming_scan"],
         scan_meas[128, "hamming_scan_scores"]),
        ("hamming_scan_topk", "src/repro_torch/kernels/csrc/hamming_scan.cu",
         "src/repro/kernels/hamming_scan.py:62 with the chunk loop of "
         "src/repro/kernels/ops.py:173", launches["hamming_scan_topk"],
         scan_meas[128, "hamming_scan_topk"]),
        ("blockmax_scan", "src/repro_torch/kernels/csrc/blockmax_scan.cu",
         "src/repro/kernels/blockmax_scan.py:53", launches["blockmax_scan"],
         scan_meas[128, "blockmax_scores"]),
        ("verify_tuples", "src/repro_torch/kernels/csrc/verify_tuples.cu",
         "src/repro/kernels/verify_tuples.py:134", launches["verify_tuples"],
         scan_meas[128, "verify_tuples"]),
        ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:125",
         launches["flash_attention"], k7),
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
            "bound_by": meas["bound_by"],
            "library_ms": (round(float(meas["library_ms"]), 6)
                           if "library_ms" in meas else None),
        })
    log("summary (ms/query, median of 5 warm batches) " + tag)
    for (p, B, K, med, wpb, spb, bails) in timings:
        log(f"  p={p:3d} B={B:2d} K={K:3d}: {med:.4f} ms/query; "
            f"walk/batch {wpb:.0f}, scan/batch {spb:.2f}")
    for (p, B, K, med) in scan_timings:
        log(f"  linear scan p={p:3d} B={B:2d} K={K:3d}: {med:.4f} ms/query")
    for (p, B, full, prn, frac) in pruned_timings:
        log(f"  pruned scan p={p:3d} B={B:2d} K= 10: {prn:.4f} ms/query "
            f"(scan_topk {full:.4f}), scanned_fraction {frac:.6f}")
    for p in (64, 128):
        e = scan_meas[p, "blockmax_scores"]
        e1 = scan_meas[p, "blockmax_scores_b1"]
        log(f"  K5 p={p:3d}: B=64 {e['ms']:.6f} ms (bound "
            f"{e['bound_ms']:.6f}), B=1 {e1['ms']:.6f} ms (bound "
            f"{e1['bound_ms']:.6f})")
    if k1_main:
        e = k1_main[1]
        log(f"  K1 p={k1_main[0][0]}: {e['ms']:.6f} ms (bound "
            f"{e['bound_ms']:.6f}), launch floor (B=1, C=8) "
            f"{e['floor_ms']:.6f} ms")
    for label, ms in shard_rows:
        log(f"  3d {label}: {ms:.4f} ms/query")
    for label, ms in cluster_rows:
        log(f"  3e {label}: {ms:.4f} ms/query")
    r = retrieval
    log(f"  retrieval (gemma-2b, p=64, K=10): B=64 {r['ms_b64']:.4f}, B=1 "
        f"{r['ms_b1']:.4f} ms/query; encode "
        f"{r['encode_s'] * 1e3 / N_DOCS:.4f} ms/doc "
        f"({N_DOCS * DOC_LEN / r['encode_s']:,.0f} tokens/s); AQBC "
        f"{r['aqbc_s']:.3f} s, index {r['index_s']:.3f} s; per encoder batch "
        f"K7 {r['k7_ms']:.4f} ms vs GEMMs {r['gemm_ms']:.4f} ms")
    r = serving
    e = k7_path["decode"]
    log(f"  token serving (gemma-2b, B = 8): {r['tokens_s']:.1f} tokens/s, "
        f"decode step {r['step_ms']:.3f} ms (median; {r['step_ms_big']:.3f} "
        f"at {r['group_big']} rows), {r['decode_steps']} decode steps, "
        f"{r['prefills']} prefills, K7 launches {r['launches']}; K7 at the "
        f"decode operand {e['ms']:.6f} ms (bound {e['bound_ms']:.6f}, SDPA "
        f"{e['library_ms']:.6f})")
    r = training
    e = r["k7_train"]
    log(f"  training (gemma-2b, B = 8 x 128): step {r['step_ms']:.3f} ms "
        f"(median of steps 2-{TRAIN_STEPS}), {r['tokens_s']:,.0f} tokens/s, "
        f"mfu {r['mfu']:.4f}, peak {r['peak_gb']:.2f} GB, losses "
        f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, K7 launches "
        f"{r['launches']}; stack by select {r['select_ms']:.3f} ms vs split "
        f"{r['split_ms']:.3f} ms; K7 at the training operand "
        f"{e['ms']:.6f} ms (bound {e['bound_ms']:.6f}, SDPA "
        f"{e['library_ms']:.6f})")
    r = llama_serving
    e = k7_path["3h llama3-8b", "decode"]
    log(f"  token serving (llama3-8b, {LLAMA_SERVE_LAYERS} layers, B = 8): "
        f"{r['tokens_s']:.1f} tokens/s, decode step {r['step_ms']:.3f} ms "
        f"(median; {r['step_ms_big']:.3f} at {r['group_big']} rows), card "
        f"busy {r['prof_busy']:.4f} ms a profiled step, peak "
        f"{r['peak_gb']:.2f} GB, K7 launches {r['launches']}; K7 at the "
        f"decode operand {e['ms']:.6f} ms (bound {e['bound_ms']:.6f}, SDPA "
        f"{e['library_ms']:.6f})")
    r = llama_training
    e = k7_path["3i llama3-8b", "train"]
    log(f"  training (llama3-8b, {LLAMA_TRAIN_LAYERS} layers, B = 8 x 128): "
        f"step {r['step_ms']:.3f} ms (median of steps 2-{TRAIN_STEPS}), "
        f"{r['tokens_s']:,.0f} tokens/s, mfu {r['mfu']:.4f}, peak "
        f"{r['peak_gb']:.2f} GB, losses {r['losses'][0]:.4f} -> "
        f"{r['losses'][-1]:.4f}, K7 launches {r['launches']}; K7 at the "
        f"training operand {e['ms']:.6f} ms (bound {e['bound_ms']:.6f}, "
        f"SDPA {e['library_ms']:.6f})")
    for arch, r in granite.items():
        log(f"  {arch} ({GRANITE_LAYERS} layers, G = {r['G']}): 1 prefill + "
            f"8 decode steps {r['wall_s']:.3f} s, peak {r['peak_gb']:.2f} GB,"
            f" K7 launches {r['launches']}")
    e = k7_path["3j granite-34b", "decode"]
    log(f"  K7 at granite-34b's decode operand (G = 48): {e['ms']:.6f} ms "
        f"(bound {e['bound_ms']:.6f}, SDPA {e['library_ms']:.6f})")
    for name, r in examples.items():
        log(f"  example {name}: {r['s']:.1f} s, peak {r['peak_gb']:.2f} GB")
    r = whisper
    log(f"  whisper-tiny (4 + 4 layers, B = {WHISPER_B}): prefill "
        f"{r['prefill_ms']:.2f} ms, decode step {r['step_ms']:.3f} ms "
        f"({r['tokens_s']:.1f} tokens/s), K7 launches {r['launches']}; "
        f"train step {r['train_ms']:.3f} ms ({r['train_tokens_s']:,.0f} "
        f"tokens/s), peak {r['train_peak_gb']:.2f} GB, losses "
        f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, K7 launches "
        f"{r['train_launches']}; K7 at the encoder, cross and cross-decode "
        + "; ".join(f"{k7_path['3l whisper-tiny', k]['ms']:.6f} ms (bound "
                    f"{k7_path['3l whisper-tiny', k]['bound_ms']:.6f}, SDPA "
                    f"{k7_path['3l whisper-tiny', k]['library_ms']:.6f})"
                    for k in ("encoder", "cross", "cross_decode")))
    r = mamba_serving
    log(f"  token serving (mamba2-1.3b, {MAMBA_SERVE_LAYERS} layers, B = 8): "
        f"{r['tokens_s']:.1f} tokens/s, decode step {r['step_ms']:.3f} ms "
        f"(median; {r['step_ms_big']:.3f} at {r['group_big']} rows), card "
        f"busy {r['prof_busy']:.4f} ms a profiled step, peak "
        f"{r['peak_gb']:.2f} GB")
    r = mamba_training
    log(f"  training (mamba2-1.3b, 48 layers, B = 8 x 128, the CLI): step "
        f"{r['step_ms']:.3f} ms (median of steps 2-{MAMBA_TRAIN_STEPS}), "
        f"{r['tokens_s']:,.0f} tokens/s, mfu {r['mfu']:.4f}, peak "
        f"{r['peak_gb']:.2f} GB, losses {r['losses'][0]:.4f} -> "
        f"{r['losses'][-1]:.4f}; {r['wall_s']:.1f} s with its checkpoints")
    r = hymba_serving
    log(f"  token serving (hymba-1.5b, {HYMBA_SERVE_LAYERS} layers, B = 8, "
        f"max_seq 256): "
        f"{r['tokens_s']:.1f} tokens/s, decode step {r['step_ms']:.3f} ms "
        f"(median; {r['step_ms_big']:.3f} at {r['group_big']} rows), card "
        f"busy {r['prof_busy']:.4f} ms a profiled step, peak "
        f"{r['peak_gb']:.2f} GB, K7 launches {r['launches']}")
    r = hymba
    e = k7_path["3n hymba-1.5b", "decode"]
    log(f"  hymba-1.5b ring set (8 x {RING_PROMPT} + 128 tokens): "
        f"{r['ring_tokens_s']:.1f} tokens/s, decode step "
        f"{r['ring_step_ms']:.3f} ms ({r['ring_step_ms_wrapped']:.3f} after "
        f"the wrap) against {r['ring_prof_busy']:.4f} ms of card time, "
        f"prefill {r['ring_prefill_ms']:.2f} ms; K7 at the ring decode "
        f"{e['ms']:.6f} ms (bound {e['bound_ms']:.6f}, SDPA "
        f"{e['library_ms']:.6f})")
    t = r["train"]
    log(f"  training (hymba-1.5b, B = 8 x 128): step {t['step_ms']:.3f} ms, "
        f"{t['tokens_s']:,.0f} tokens/s, mfu {t['mfu']:.4f}, losses "
        f"{t['losses'][0]:.4f} -> {t['losses'][-1]:.4f}; 2 x 4096: "
        + ", ".join(f"{x:.1f}" for x in r["long_ms"]) + " ms, losses "
        + ", ".join(f"{x:.4f}" for x in r["long_losses"])
        + f"; peak {r['peak_gb']:.2f} GB")
    for arch, r in moe.items():
        e = k7_path[f"3o {arch}", "decode"]
        log(f"  {arch} ({MOE_LAYERS} layers, G = {r['G']}): {r['tokens_s']:.1f}"
            f" tokens/s, decode step {r['step_ms_big']:.3f} ms at "
            f"{r['group_big']} rows against {r['prof_busy']:.4f} ms of card "
            f"time and a {r['bound_ms']:.4f} ms bytes bound; loss forward "
            f"ce {r['loss']['ce']:.4f}, moe_lb {r['loss']['moe_lb']:.6f}, "
            f"moe_rz {r['loss']['moe_rz']:.6f}, dropped_fraction "
            f"{r['loss']['dropped_fraction']:.6f}; K7 decode {e['ms']:.6f} "
            f"ms (bound {e['bound_ms']:.6f}, SDPA {e['library_ms']:.6f})")
    r, pr, t = llava["serve"], llava["profile"], llava["train"]
    log(f"  llava-next-34b (60 layers, B = {LLAVA_B}, {LLAVA_NEW} steps): "
        f"prefill {r['prefill_ms']:.1f} ms, decode step {r['step_ms']:.3f} ms "
        f"({r['tokens_s']:.1f} tokens/s) against {r['prof_busy']:.4f} ms of "
        f"card time (idle share {r['prof_idle']:.3f}) and a "
        f"{r['bound_ms']:.4f} ms bytes bound; bf16 gap {r['gap']:.4g} "
        f"({r['gap'] / r['scale']:.4f} of the largest logit), "
        f"{r['limited']}/{r['checked']} margin-limited; float32 gap "
        f"{llava['f32']['gap']:.4g} "
        f"({llava['f32']['gap'] / llava['f32']['scale']:.2e}), "
        f"{llava['f32']['limited']}/{llava['f32']['checked']} "
        f"margin-limited; loss forward ce {llava['loss']['ce']:.4f}; "
        f"training ({LLAVA_TRAIN_LAYERS} layers) step {t['step_ms']:.3f} ms, "
        f"{t['tokens_s']:,.0f} tokens/s, mfu {t['mfu']:.4f}, losses "
        f"{t['losses'][0]:.4f} -> {t['losses'][-1]:.4f}; the profile "
        f"(G = 8) decode step {pr['step_ms']:.3f} ms against "
        f"{pr['prof_busy']:.4f} ms of card time; peak {llava['peak_gb']:.2f} "
        f"GB")
    for kind in ("prefill", "decode", "profile_prefill", "profile_decode"):
        e = k7_path["3p llava-next-34b", kind]
        log(f"  K7 at llava's {kind} operand: {e['ms']:.6f} ms (bound "
            f"{e['bound_ms']:.6f}, SDPA {e['library_ms']:.6f}), "
            f"{e['launches']} launches")
    steps = [("3g gemma-2b train", training),
             ("3f gemma-2b decode", serving),
             ("3h llama3-8b decode", llama_serving),
             ("3m mamba2-1.3b decode", mamba_serving),
             ("3n hymba-1.5b decode", hymba_serving)] + [
        (f"3o {a} decode", r) for a, r in moe.items()] + [
        ("3p llava-next-34b decode", llava["serve"]),
        ("3p profile decode", llava["profile"])]
    roof = {}
    for name, r in steps:
        x = roof[name] = r["roofline"]
        log(f"  roofline, one card, {name}: compute_s {x['compute_ms']:.4f} "
            f"ms, memory_s {x['memory_ms']:.4f} ms, step_s "
            f"{x['step_ms']:.4f} ms, useful_ratio {x['useful_ratio']:.4f}; "
            f"card busy {x['busy_ms']:.4f} ms; bytes per device "
            f"{x['bytes_gb']:.2f} GB against {x['peak_gb']:.2f} GB "
            f"allocated over the step; {x['ranges']} ranges, "
            f"{x['ranges_host_ms']:.4f} ms of host time")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "roofline.json").write_text(json.dumps(
        {"card": card, "steps": roof}, indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
