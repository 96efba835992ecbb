#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through the entry points a user calls and
fails (non-zero exit, no result line) on any failed check:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels of `src/repro_torch/csrc/` into `build/`,
   while the scale phase's store is made in a process of its own
   (`ScaleStore`);
3. NAI serving at the full size of the repo's PubMed-shaped
   configuration (`gnn_phases`): one real packed batch; each kernel (B1
   spmm_block_ell, B2 nap_step_fused, B3 nap_exit) against its plain
   PyTorch version on the card, B1 also against the dense Â of a smaller
   pack's edge list (`ref_spmm_dense`), B2's `out` bitwise against B1's and B2
   against the two-launch composition B1 + B3; B1 and B2 again with NaN,
   +Inf and -Inf planted in x rows that only zero coefficients name, and
   in rows that non-zero ones name (`nonfinite_phase`); then 2,000 requests
   through `NAIServingEngine(mode="compiled")` for each backend (fused,
   block_ell, segment) at pipeline depth 2, after one warm pass, held
   against the port's host-mode engine; then the device sampler
   (`device_sampler_phase`): on the benchmark cell's ogbn-arxiv-sized
   graph (arxiv-like at scale 1.0), three batches of 500 test-split ids
   sampled 2 hops deep by `DeviceSampler` on the card, array-equal to the
   numpy `sample_support`, with both samplers' ms per batch; then seven
   more NAI phases, each with the launch counters zeroed before it and
   read after it:
   - sharded (`sharded_phase`, ROADMAP A7): D shards on the one card
     (`make_serving_mesh(D, devices=(cuda:0,) * D)`, printed as the mesh
     it is beside `torch.cuda.device_count()`): the first 1,000 of the
     2,000 requests through every backend at D = 2 (halo, dense,
     alltoall) and D = 4 (halo, alltoall), each after two warm passes,
     in turns with the D = 1 engine: predictions and exit orders bitwise
     D = 1's on fused and block_ell, outside the margin on segment;
     `halo_frac` < 1 in the halo modes; no pack allocation in the
     measured pass; B1-B3 launched D times per step; req/s, p50, p99,
     host/dispatch/sync ms per batch, `halo_stats` and the bytes each
     step moves between shards; one fused D = 4 alltoall pass under the
     profiler (the exchange's device time against B2's, idle share);
     the whole graph offline at D = 2 alltoall on every backend, equal
     to D = 1 and, killed after superstep 1 and resumed, to itself;
   - store: the graph saved with `save_graph_store`, `MmapStore.verify()`
     checking every array, a copy with one flipped byte raising
     `StoreCorruption`, and the 2,000 requests served from the
     `MmapStore` through fused and block_ell, equal to the in-memory
     passes exactly;
   - faults (`faults_phase`): 8 batches of 500 test-split requests on
     fused at depth 2 with the watchdog armed (1 s) and one seeded
     `FaultPlan` (host, device, nan, slow and hang faults at fixed
     batches): every request ends exactly once, exactly the named batches
     fail with their typed errors, the others bitwise equal to a
     fault-free run, the hang declared within the watchdog plus 0.1 s;
     with `retry_failed` the failed batches complete on the host path,
     equal to the host-mode engine; a `FaultyStore` over the store
     phase's `MmapStore` with a `store_read` fault fails only its batch
     on block_ell;
   - scale: a 1e6-node power-law store made by `make_graph` (256
     features, 1.02 GB) in a process of its own, 32 batches of 64
     uniform ids served from it once on fused and once on
     block_ell, which must agree exactly; generation seconds, req/s, host
     ms per batch, B2's launches and the peak RSS beside the feature
     bytes;
   - offline (`offline_phase`): `run_full_graph_infer` over the whole
     pubmed-like graph (T_s the median first-step distance, T_max 3) on
     block_ell, fused and segment: equal to `make_compiled_infer` on the
     same pack, a run killed after superstep 1 and resumed equal to the
     uninterrupted one (bitwise on the tile backends, outside the margin
     on segment), a flipped byte in a step falling back one superstep,
     B1-B3 launched once per superstep; then the scale phase's 1e6-node
     store on segment (one run; the tile bytes its graph would need),
     each with pack, superstep, checkpoint and classification seconds;
   - cache: 1,024 Zipf(1.0) requests over the test split in batches of
     64 through every backend with the propagated-feature cache on
     (4,096 nodes) and off, and a no-hit control (fills off): cached ==
     cold outside the margin, hits, fewer rows packed than sampled,
     fused == block_ell exactly, no pack allocation in the steady pass,
     and the same after a mutation round that stales cached entries;
   - frontend (`frontend_phase`): `default_slo_classes` (gold at T_max 3,
     best_effort at T_max 1) on fused: a virtual-clock replay of a bursty
     stream (pipelined == serial == direct per-class engines, no pack
     allocation in the steady pass), a wall-clock open loop at 0.5x and
     2x the serve phase's fused req/s (per-class goodput, shed, p50, p99,
     conservation), and a breaker trip (a `device` fault plan on gold
     demotes it to best_effort; the breaker closes after its cooldown);
4. LM serving (`lm_phases`) at full width in bf16, the depth cut to 4
   and 5 layers, with random
   weights from `torch.Generator("cuda").manual_seed(0)`, with the
   rwkv mixes mu_* drawn from U(0, 1) and the attention projections
   scaled to a fan-in of d (`condition_weights`): rwkv6-3b (prefill 4 x
   2048 tokens, kernel B5 wkv6 in each of its 4 layers), then
   recurrentgemma-9b (prefill 2 x 4096 tokens, kernel B4 flash_attention
   in its `local` layer, band 2048 active). For each: the
   kernel against its plain version on the first such layer's real
   operands (B5 also against the f64 per-step recurrence,
   `ref_wkv6_sequential`, on 2 x 2 heads x 64 of its steps), then the
   prefill, 32 greedy decode steps from its cache (with a profile of one
   decode step), 8 requests through `LMServingEngine` (4 slots, 32-token
   prompts, 16 new tokens each), and the end-to-end gates on prompts of
   2048 (rwkv6-3b) and 2200 (recurrentgemma-9b: above the window, not a
   multiple of it) tokens:
   the prefill's last logits, and one more token decoded from the
   prefill's cache, against decoding the same prompts token by token in
   f32 (a path with no kernel), for the f32 and for the bf16 prefill;
   with the bf16-against-f32 error of the last logits after 1, 2, 4, 8,
   16 and all layers;
   then the MoE models (`moe_phase`, ROADMAP A10.1), after the dense ones
   are freed: dbrx-132b (16 experts top-4, SwiGLU experts, layernorm) and
   grok-1-314b (8 experts top-2, gated tanh-GELU experts, attention and
   final logit soft-caps 30) at full width in bf16, their depth cut to 6
   of 40 and 4 of 64 layers so that the weights (41.6 and 42.6 GB) fit
   the card, random weights (conditioned as above); the parameter
   arithmetic is checked against `count_params` and printed. For each:
   (a) B4 against its plain version on the first layer's q, k, v at the
   prefill's shape (4 x 2048, 48 / 8 heads, hd 128, causal, grok's cap),
   timed beside the plain version, SDPA (which has no cap) and the kernel
   with the cap off, with the largest |logit|; for grok first on the
   unconditioned projections, whose logits reach the thousands, where the
   kernel must be far from the uncapped plain version; (b) the main path:
   prefill 4 x 2048 (B4 once per layer, no other kernel) and 32 greedy
   decode steps from its cache, tokens/s, ms per step, peak memory and
   each layer's share of assignments dropped by the capacity (C = 640);
   (c) 8 requests through `LMServingEngine` as above; (d) the gates on
   2 x 2200 tokens (not a multiple of 128: B4 pads): the reference is an
   f32 prefill through the plain attention (the reference's `_sdpa`, no
   kernel) and one decode step from its cache, made one layer at a time
   from f32 copies of that layer's weights (the f32 model would take 83-85
   GB); the same layers through B4's f32 kernel, and the bf16 model
   through `prefill_step` / `decode_step`, are held against it, with the
   share of the last position's top-k expert choices that bf16 and f32
   agree on. (Token-by-token decoding is no reference here: decode routes
   the batch as one row at capacity 8, the prefill each sequence at
   ~688, so they drop different assignments, in the reference too.)
   Then the cross-attention and encoder models (`xattn_phase`, ROADMAP
   A10.2) at full width and depth in bf16 (weights 19.55 and 0.56 GB;
   parameter arithmetic checked against `count_params`), conditioned as
   above (the `xattn` gates set to 1), stub frontends drawn from a CUDA
   generator seeded 1: llama-3.2-vision-11b (32 `attn` + 8 gated `xattn`
   layers; prefill 4 x 2048 tokens with 4 x 1600 image rows) and
   whisper-small (12 `enc` + 12 `encdec` layers; 16 clips of 1500 frames,
   224-token prompts). For each: (a) B4 with its key bound on the first
   `xattn` layer's, or the first `enc` layer's and the first `encdec`
   layer's cross-attention, real q, k, v (`bounded_attention_check`:
   queries and keys zero-padded to multiples of 128, kv_len the true
   key count; the kernel against its plain version in bf16 and f32, NaN
   in every padded key and value giving the same bits, timed beside the
   plain version and SDPA over the unpadded operands, the bound counting
   the true pairs); (c) the main path, prefill (B4 40 and 36 times) and
   32 greedy decode steps, then 8 requests through `LMServingEngine`
   with its cache seeded from 4 frontends by `seed_frontend_cache`; (d)
   `seed_frontend_cache` equal to the prefill's xk / xv bit for bit, and
   a decode from it at position 0 finite; (e) the gates on 2 x 2200
   (llama) and 2 x 200 (whisper) tokens against an f32 prefill through
   the plain attention (`plain_layer`: `_sdpa`, no kernel) and one
   decode step from its cache, made one layer at a time from f32 copies
   of that layer's weights (the f32 llama would take 39.1 GB beside the
   bf16 one), beside the same layers through B4's f32 kernel and the
   bf16 model through `prefill_step` / `decode_step`.
   Then the LM's train -> checkpoint -> adaptive serve path
   (`adaptive_phase`, ROADMAP A10.3-A10.5). At smoke size: B4's f32
   head-dim-32 instance against its plain version in all 12 (causal,
   window, cap, bound) cases and timed at 4 x 2048 (`hd32_check`);
   `launch.serve --arch granite-34b --smoke` on the card (B4 once) and
   on the CPU giving the same continuation; one f32 training step of
   granite smoke with exit heads on the card against the CPU (loss,
   every gradient and updated parameter within 1e-4 relative); and
   `launch.train --arch rwkv6-3b --smoke` for 6 steps (no B5 launch:
   training runs `_wkv_chunked`), its checkpoint loaded back bit-equal,
   then `--resume` to 12 steps. At full width: granite-34b (d 6144, 48
   query heads and 1 KV head of 128, SwiGLU d_ff 24576, vocab 49152)
   with its depth cut to 4 of 88 layers and exit heads at blocks 0-2,
   bf16, random weights (conditioned as above; 2.838e9 parameters,
   checked against `count_params`): 40 training steps of `loss_fn` with
   the inception term (batch 8 x 128, lr 1e-3, in-place AdamW, per-block
   remat; every gradient of the first step finite and nonzero, every
   loss finite, the mean of the last 5 below the first 5's by more than
   0.5), step ms, tokens/s, peak memory; then, the optimizer freed, B4
   at the prefill's causal MQA shape (`attention_check`), the prefill 4
   x 2048 (B4 once per layer), 32 decode steps at full depth and with
   `adaptive_decode_step` at t_s 0, 0.35 and 1e9 on the prompts' next
   tokens (t_s 0 bit-equal to `decode_step`), with ms per step, the
   depth-FLOPs share saved, the exit histogram and the argmax agreement
   with full depth; the adaptive engine (8 requests, 4 slots); and the
   gates on 2 x 2200 tokens against the f32 plain prefill made one layer
   at a time.
   Then the LMs tensor- and data-parallel (`sharded_lm_phase`, ROADMAP A
   items 4 and 4a) on ("data", "model") meshes of the one card repeated
   (the sharded path and its exchanges, not the capacity of several
   cards): first the analytic parameter bytes a position of the whole
   mistral-large-123b (88 layers) at model 1, 4 and 8, from the fitted
   shard shapes of `abstract_params`; then mistral-large-123b (d 12288,
   96 / 8 heads of 128, d_ff 28672, vocab 32768) at full width with its
   depth cut to 4 of 88 layers on the meshes (1, 1), (1, 2), (1, 4) and
   (2, 2), gemma-7b (14 of 28 layers, 16 heads of 256, tied embedding,
   GeGLU) on (1, 1) and (1, 2), and on (1, 1), (1, 2) and (2, 2)
   dbrx-132b (3 of 40 layers) and grok-1-314b (4 of 64) with their
   experts FSDP over "data", rwkv6-3b (3 of 32 layers; also on (1,
   16), where 2.5 of its 40 heads lie on a position: the time mix on
   (batch row, head) pairs, the state over its key dim) and
   recurrentgemma-9b (8 of 38), and
   the frontend models llama-3.2-vision-11b (5 of 40 layers, 4 x 1600
   image rows) and whisper-small (6 of 12 decoder layers, its encoder
   whole; 16 x 224 tokens, 16 x 1500
   frames; its odd vocab puts "model" on d of the embedding and the
   head; also on (1, 8), which its 12 heads do not divide: "model" on d
   of wq and the head dim of wo, the query rows split), and
   deepseek-coder-33b (2 of 62 layers, full width) on (1, 1) and (1,
   16), where its 56 heads do not divide "model" and its prefill of
   2048 splits the query rows as the reference's `_seq_shard` does
   (context-parallel attention, B4 on each position's rows at its query
   offset); bf16, random weights drawn anew for each mesh (conditioned as
   above) and placed by `shard_params`. For each mesh: the bytes each
   position holds, measured on the placed tensors; B4 (B5 for rwkv) on
   position 0's operands of the first layer that runs it, at the
   per-position shape, against its plain version and timed beside SDPA
   (for the frontend models the key-bound launches of the first `xattn`,
   `enc` and cross-attention, `bounded_attention_check`), and where the
   rows split B4's query-offset instance on the last position's rows
   (deepseek's timed for the summary's row); the main path
   inside `use_mesh`: prefill 4 x 2048 (the kernel once per layer and
   position, twice per `encdec` layer; the query-offset instances once
   per causal layer whose rows split and position but the first along
   "model"), 16 decode steps fed the (1, 1)
   mesh's greedy tokens, `seed_frontend_cache` into a cache placed by
   `init_cache` equal to the prefill's xk / xv bit for bit, on the
   TRACED meshes one traced prefill and decode step (the device time of
   each collective), and 4
   requests through `LMServingEngine` (its cache seeded from the
   frontend); prefill tokens/s, decode ms a step, the exchange's bytes
   (the collectives' counter), for MoE the prefill's drops per layer
   (within MOE_DROP_GAP of the assignments of (1, 1)'s), and the
   relative L2 of the logits and the argmax agreement against the (1, 1)
   mesh, which must stay under the model's SHARDED_REL. Then rwkv6-3b
   (8 of 32 layers) and whisper-small whole in f32 on their meshes,
   (1, 16) and (1, 8)
   included (`sharded_f32_check`),
   whose logits must stay within F32_REL of (1, 1)'s. Last, adaptive
   decoding on a placed model (`sharded_adaptive_phase`): granite-34b at
   full width, 4 of 88 layers, exit heads at blocks 0-2, in f32 on (1,
   1), (1, 2) and (2, 2): B4's f32 kernel on position 0's causal MQA
   operands, the prefill 4 x 2048, 16 decode steps at full depth and
   adaptive at t_s 0, a middle t_s and 1e9, the adaptive engine; exit
   blocks equal to (1, 1)'s outside the margin, the FLOPs share equal,
   the logits within F32_REL. Then training on a placed model
   (`sharded_train_phase`, ROADMAP A item 4a): granite-34b at full
   width, 3 of 88 layers, exit heads at blocks 0-1, bf16, on (1, 1),
   (1, 2), (1, 4) and (2, 2), placed by `shard_params(...,
   trainable=True, release=True)` with f32 moments: one `loss_fn`
   backward and `sync_grads` (every gradient finite, each leaf's
   nonzero), then 5 steps of `launch.dryrun.build_train_step` (lr 1e-3)
   on `synthetic_stream(0, 8, 128)` and one traced; bytes a position
   (parameters, gradients, moments), step ms and training tokens/s, peak
   memory, each step's loss and grad_norm, the exchange of a step
   (counted bytes, traced device ms) with the gradient sync apart; every
   copy of every block bitwise equal after each step, B4 and B5 not
   launched, the loss lower at step 5 than at step 1, step 1's loss and
   grad_norm within SHARDED_TRAIN_BF16_REL of (1, 1)'s; then one f32
   step at smoke size for every family on two meshes of the card
   against (1, 1) on the card and on the CPU (`train_f32_checks`).
   Then checkpoints of a placed training state (`placed_ckpt_phase`,
   ROADMAP A item 1): whisper-small whole, bf16, trained on (1, 2), a
   run of 4 steps against 2 steps, a save, a load into a fresh placement
   and 2 more steps: the state, the losses and both models' prefill
   logits (B4 through its key bound) bitwise equal, the file loaded onto
   (2, 2) gathering to its arrays bit for bit; the file's bytes and the
   save and load seconds. Last, the dry run (`dryrun_lines`, ROADMAP
   A11): `launch.dryrun.lower_combo` on `meta` devices for granite-34b's
   training and mistral-large-123b's prefill at the sizes above, on (1,
   1) and (1, 4), each record's data-sheet roofline terms beside the
   step or prefill ms and the device busy ms measured above. Then a
   batch that the data axes do not divide and the MoE over ("pod",
   "data") (`batch_one_phase`, ROADMAP C.9, C.11, C.12), on meshes of
   the card repeated against (1, 1): mistral-large-123b (4 of 88
   layers) prefills one prompt of 8,192 tokens, replicated over "data",
   into a cache of long_500k's 524,288 positions split over "data" on
   its sequence and decodes 16 steps (the split-key combine); rwkv6-3b
   (12 of 32) at batch 1 on (2, 2) in bf16 and f32, its state over its
   key dim; dbrx-132b (2 of 40) with its batch of 4 over ("pod",
   "data"): B4 at the 8,192-row shape against its plain version on its
   first and last rows (`long_attention_check`), B5 by `wkv_check`, the
   prefill and decode times, the traced step's device busy ms, the
   exchange counted and traced, the caches' layouts, the logits and MoE
   drops against (1, 1)'s. The serve phase's traced passes (pipeline
   depth 2, and fused at depth 1) also give the stream `Memcpy HtoD`
   ran on (the engine's copy stream), its device ms, the ms of it beside
   kernels (`copy_overlap`) and the new shape keys of the steady-state
   pass (`jit_stats`), which must be none.
5. train (`train_phase`, last, so that nothing it leaves behind runs
   beside the LM timings): the paper's training procedure (`train_nai`,
   Inception Distillation, `DistillConfig()`'s 300/200/200 epochs) on the
   card on phase 3's graph with `serve_gnn`'s config (dropout 0.1): (a)
   50 AdamW steps of the base loss at dropout 0 on the card and on the
   CPU from the same heads (every step's loss within 1e-3 relative, >=
   99% of test predictions equal), then 10 more card steps under the
   profiler (wall against device busy time per step); (b) `train_nai`
   with its stage seconds and steps/s, the `info` losses (finite) and
   every order's test accuracy (above 1.5/C); (c) the trained heads
   through host mode, fused, block_ell and segment on the 2,000
   requests, under the serve phase's gates, with accuracy, req/s and
   B1-B3's launches (counters zeroed before each backend's pass); (d) T_s
   at 0, the 25th and 75th percentiles of the order-1 distances and above
   all of them (T_max 3): accuracy, exit histogram, the host path's
   propagation MACs per node, fused req/s of one pass after the pass
   that sizes its pool, that pass == host outside the margin; (e) `python -m
   repro_torch.launch.serve --gnn pubmed-like` and `... launch.train
   --gnn pubmed-like` at their defaults as subprocesses (exit 0 and their
   lines), then the four Table 3 baselines (GLNN, TinyGNN, INT8, vanilla)
   from the trained teacher.

The launch counters of the kernels are zeroed just before each main path
(the measured serving passes; each prefill and its decode) and read just
after it. Kernel timings: warm CUDA events around 10 back-to-back calls,
per call, median of 25 (of MIN_REPS or more once they hold TIMED_MS of
device time), beside the least time the card could take for
the same work at the operands' type (B4's bf16 products on the tensor
cores), the plain version (which synchronises with the host: one call a
timing, and of B4/B5 the median of 5) and, where one PyTorch call
computes the same function, that call. The summary also gives the
kernel's and the library call's time at one call per event pair, which
adds the host's launch gap, and for B3 the device time alone: a CUDA
graph of 10 calls replayed between events (`graph_ms`).

Tolerances: propagated values allclose at rtol = atol = 1e-5 and squared
distances at rtol = 1e-5, atol = 1e-4 (f32 sums in another order than
the plain versions'); exit flags, exit orders and predictions equal
outside a 1e-4 relative margin around the squared threshold, which may
hold at most 5% of the nodes; B2 against B1 and against the two-launch
composition, and the fused backend against block_ell, exactly. With
non-finite x: NaN and +-Inf in exactly the places of the plain version's
output, the finite values as above. B5 at
rtol = 1e-4, atol = 1e-5 of its largest value (the same f32 chunked
factorization summed in another order; against the f64 recurrence too);
B4 at rtol = atol = 1e-2 (the
kernel rounds the softmax weights to bf16 for the tensor cores, 2^-9
relative each, and both round the output to bf16). End to end,
relative L2 error against f32 token-by-token decoding, about twice the
errors an H100 gave at the phases' depths (4 and 5 layers): for the f32
paths 4e-5 (rwkv6-3b) and 4e-6 (recurrentgemma-9b) (f32 sums in other
orders through every layer); for the bf16 paths 0.1 and 0.02 (bf16 keeps
8 significant bits, and random weights amplify its rounding with depth,
as the by-depth line shows: rwkv6-3b's error doubles with each doubling
of the depth, to 0.52 at 32 layers, where unrelated logits would give
1.41). The MoE gates: 1e-3 for the f32 kernel path against the f32 plain
path; for bf16, MOE_BF16_REL, about twice what an H100 gave (bf16 and
f32 chose the same experts there; a bf16 rounding that flips a near-tied
top-k choice sends that token to another expert and moves the error).
The cross-attention gates: 1e-3 for the f32 kernel path; for bf16,
XATTN_BF16_REL, about twice what an H100 gave. granite-34b's gates: 1e-3
for the f32 kernel path; for bf16, GRANITE_BF16_REL, about twice what an
H100 gave after the 40 training steps. The placed training step: in bf16
step 1's loss and grad_norm within SHARDED_TRAIN_BF16_REL (5e-4, about
twice what an H100 gave) of the (1, 1) mesh's (the row-parallel partial
products round to bf16 before their f32 sums, and the gradient sync adds
in another order); in f32 at smoke size each parameter and moment after
the step within TRAIN_F32_REL (1e-4) relative L2 of (1, 1)'s on the card
and of the CPU's; every copy of a block equal bit for bit. The batch-one
and multi-pod meshes: bf16 logits within SHARDED_REL of (1, 1)'s (the
split-key combine and the row-parallel sums round otherwise), f32 within
F32_REL, argmax agreement at least BATCH_ONE_AGREE (bf16 rwkv6-3b only
reports it), MoE drops within MOE_DROP_GAP.

The third-to-last line is a JSON object {"phase_seconds": {...},
"phase_checks": {...}, "checks_passed": N, "total_s": t}: each phase's
wall seconds (a phase runs from its "== name" line to the next; "start"
is the time before the first), the checks that passed in it (a check is
one `check()` call site in one phase, however often it ran there), their
sum, and the seconds since the script started. The second-to-last line is a JSON object {"kernels":
[...]}, the last {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))
from repro_torch.common import H100_SXM  # noqa: E402

# NVIDIA's data-sheet figures of the H100 SXM (`repro_torch.common`)
PEAK_BYTES_S = H100_SXM.hbm_bw               # HBM3
PEAK_F32_FLOP_S = H100_SXM.peak_flops_f32    # f32 outside the tensor cores
PEAK_BF16_FLOP_S = H100_SXM.peak_flops       # bf16 tensor cores, dense
D2_MARGIN = 1e-4
F32_REL = 1e-3
MAX_NEAR_SHARE = 0.05
REPS = 25
# a ruler stops after MIN_REPS timings once they hold more than TIMED_MS of
# device time (a 7.5 ms kernel: 5 windows of 10 calls, not 25)
MIN_REPS, TIMED_MS = 5, 250.0


class Budget:
    """Wall seconds and passed checks per phase, from the script's start:
    a phase runs from its `phase()` call to the next one. A check is one
    `check()` call site in one phase, counted once however often it
    passes there (a loop over meshes or passes repeats it)."""

    def __init__(self):
        self.start = self.t = time.perf_counter()
        self.name = "start"
        self.seconds = {}
        self.sites = {}

    def enter(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[self.name] = self.seconds.get(self.name, 0.0) + now - self.t
        self.name, self.t = name, now

    def passed(self, site: str) -> None:
        self.sites.setdefault(self.name, set()).add(site)

    def line(self) -> dict:
        self.enter(self.name)
        checks = {k: len(v) for k, v in self.sites.items()}
        return {"phase_seconds": {k: round(v, 1)
                                  for k, v in self.seconds.items()},
                "phase_checks": checks,
                "checks_passed": sum(checks.values()),
                "total_s": round(time.perf_counter() - self.start, 1)}


BUDGET = Budget()


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")
    caller = sys._getframe(1)
    BUDGET.passed(f"{caller.f_code.co_name}:{caller.f_lineno}")


def phase(name: str) -> None:
    BUDGET.enter(name)
    print(f"\n== {name}", flush=True)


def time_ms(torch, fn, reps: int = REPS, warm: int = 3,
            calls: int = 10) -> float:
    """Device time of one fn() call: median over `reps` CUDA-event
    timings of `calls` back-to-back calls (so the host's launch gap
    between calls stays off the card's timeline), after `warm` calls;
    fewer timings, MIN_REPS at least, once they hold TIMED_MS."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
        if len(times) >= MIN_REPS and sum(times) * calls > TIMED_MS:
            break
    return float(np.median(times))


def graph_ms(torch, fn, calls: int = 10, reps: int = REPS) -> float:
    """Device time of one fn() call with the host out of the way: a CUDA
    graph of `calls` back-to-back calls, replayed between CUDA events;
    median of `reps`, per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return float(np.median(times))


def timings(torch, kernel, plain, library=None, plain_reps: int = REPS):
    """A kernel's, its plain version's and the library call's times.
    `ms` and `library_ms` time 10 back-to-back calls per event pair; their
    `_one_call` twins time one call per pair, which adds the host's launch
    gap, so that times taken either way can be compared. The plain
    versions synchronise with the host and are timed one call per pair."""
    t = dict(ms=time_ms(torch, kernel),
             ms_one_call=time_ms(torch, kernel, calls=1),
             plain_ms=time_ms(torch, plain, plain_reps, calls=1),
             library_ms=None, library_ms_one_call=None)
    if library is not None:
        t.update(library_ms=time_ms(torch, library),
                 library_ms_one_call=time_ms(torch, library, calls=1))
    return t


def bound(nbytes: float, flops: float, peak_flop_s: float = PEAK_F32_FLOP_S):
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate of the operands' type, the larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak_flop_s
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def same_bits(torch, a, b) -> bool:
    """Bitwise equality of two f32 tensors, NaN payloads included."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def nonfinite_equal(torch, got, want, rtol=1e-5, atol=1e-5) -> bool:
    """NaN and +-Inf in exactly the same places (and signs), the finite
    values allclose (f32 sums in another order than the plain
    version's)."""
    fin = torch.isfinite(want)
    return (torch.equal(torch.isfinite(got), fin)
            and torch.equal(got.isnan(), want.isnan())
            and torch.equal(got[got.isinf()], want[want.isinf()])
            and torch.allclose(got[fin], want[fin], rtol=rtol, atol=atol))


def nonfinite_phase(torch, tiles, tile_col, valid, active, x0, c, s,
                    node_active, ts2) -> None:
    """B1 and B2 on the real step-1 operands with NaN, +Inf and -Inf
    planted in x rows that only zero coefficients of the active tiles name,
    then (separately) in rows that a non-zero coefficient names. Each
    output against its plain version: non-finite entries identical,
    finite ones allclose; B2's `out` and flags bitwise B1's; exit flags
    equal to the plain version's outside the threshold margin."""
    from repro_torch.kernels.nap_step import nap_step_fused, ref_nap_step
    from repro_torch.kernels.spmm import (CB, RB, nonfinite_blocks,
                                          ref_spmm_block_ell, spmm_block_ell,
                                          zero_flags)
    phase("non-finite x")
    use = (valid != 0) & (active[:, None] != 0)
    cols = tile_col[use].long()                       # (n_use,)
    nz = (tiles[use] != 0).any(dim=1)                 # (n_use, CB)
    named = torch.zeros(x0.shape[0], dtype=torch.bool, device=x0.device)
    named[(cols[:, None] * CB + torch.arange(CB, device=x0.device))[nz]] = 1
    reached = torch.zeros_like(named)
    reached.view(-1, CB)[cols.unique()] = True
    nb, F = node_active.shape[0], x0.shape[1]
    n_rb = tile_col.shape[0]
    for behind, pick in (("zero", reached & ~named), ("nonzero", named)):
        cand = torch.nonzero(pick).flatten()
        check(cand.numel() > 0, f"x rows behind {behind} coefficients")
        rows = cand[torch.linspace(0, cand.numel() - 1, min(3, cand.numel()),
                                   device=cand.device).long()]
        x = x0.clone()
        for i, (row, val) in enumerate(zip(rows.tolist(), (
                float("nan"), float("inf"), float("-inf")))):
            x[row, [i, F // 2 + i, F - 1 - i]] = val
        bad = nonfinite_blocks(x)
        ob1, ob2 = (zero_flags(n_rb * RB, F, x.device) for _ in range(2))
        o1 = spmm_block_ell(tiles, tile_col, valid, active, x, x_bad=bad,
                            out_bad=ob1)
        f_out, f_ex, f_blk = nap_step_fused(tiles, tile_col, valid, active,
                                            x, c, s, node_active, ts2,
                                            x_bad=bad, out_bad=ob2)
        r_out, r_ex, _ = ref_nap_step(tiles, tile_col, valid, active, x, c,
                                      s, node_active, ts2)
        r1 = ref_spmm_block_ell(tiles, tile_col, valid, active, x)
        torch.cuda.synchronize()
        n_nan, n_inf = int(r1.isnan().sum()), int(r1.isinf().sum())
        check(n_nan > 0, f"the planted values reach the output ({behind})")
        check(nonfinite_equal(torch, o1, r1),
              f"spmm_block_ell vs plain on non-finite x behind {behind} "
              f"coefficients")
        check(nonfinite_equal(torch, f_out, r_out),
              f"nap_step_fused vs plain on non-finite x behind {behind} "
              f"coefficients")
        check(same_bits(torch, f_out, o1) and torch.equal(ob1, ob2)
              and torch.equal(ob1, nonfinite_blocks(r1)),
              f"B2 out and flags bitwise B1's, flags as the plain output's "
              f"({behind})")
        d2 = ((r_out[:nb] - c[:, None] * s) ** 2).sum(1)
        far = ~((d2 - ts2).abs() <= D2_MARGIN * ts2)   # NaN counts as far
        check(torch.equal(f_ex.flatten()[far], r_ex.flatten()[far]),
              f"nap_step_fused exit flags vs plain ({behind})")
        print(f"behind {behind} coefficients: rows {rows.tolist()}; plain "
              f"output NaN {n_nan}, Inf {n_inf}; B1 NaN "
              f"{int(o1.isnan().sum())}, Inf {int(o1.isinf().sum())}; B2 "
              f"NaN {int(f_out.isnan().sum())}; batch nodes with a NaN "
              f"distance {int(d2.isnan().sum())}, exits {int(f_ex.sum())}")


def serve_requests(torch, eng, nodes, batches=None):
    """Serve `nodes` through `eng` (all submitted at once, or one
    submit-and-step per batch of `batches`), drain it, and return
    (predictions, exit orders, wall seconds); checks that every request
    completed, in FIFO order."""
    t = time.perf_counter()
    done = []
    if batches is None:
        eng.submit(nodes)
        while eng.queue:
            done += eng.step()
    else:
        for b in batches:
            eng.submit(b)
            done += eng.step()
    done += eng.flush()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check([r.node_id for r in done] == list(map(int, nodes)),
          "requests complete in FIFO order")
    check(all(r.status == "completed" for r in done),
          f"every request completed ({eng.stats.failed} failed: "
          f"{next((r.error for r in done if r.error), '')})")
    return (np.array([r.prediction for r in done]),
            np.array([r.exit_order for r in done]), wall)


def request_distances(cfg, nai, store, nodes, batch_size):
    """(len(nodes), t_max - t_min) float64: each request's decision-step
    distances in the batch the engine forms it in (they depend on the
    graph, the batching and t_min/t_max, not on t_s or the heads)."""
    from repro_torch.gnn.nai import decision_distances
    out = np.zeros((len(nodes), nai.t_max - nai.t_min))
    for lo in range(0, len(nodes), batch_size):
        chunk = nodes[lo:lo + batch_size]
        uniq, inv = np.unique(chunk, return_inverse=True)
        out[lo:lo + len(chunk)] = decision_distances(cfg, nai, store,
                                                     uniq)[inv]
    return out


def within_margin(d, t_s):
    """Bool per request: does a decision-step d² lie within D2_MARGIN of
    t_s²?"""
    ts2 = float(np.float32(t_s) ** 2)
    return (np.abs(d ** 2 - ts2) <= D2_MARGIN * ts2).any(axis=1)


def near_margin(cfg, nai, store, nodes, batch_size):
    """Bool per request: does a decision-step d² of the node, in the batch
    the engine forms it in, lie within D2_MARGIN of t_s²?"""
    return within_margin(request_distances(cfg, nai, store, nodes,
                                           batch_size), nai.t_s)


def same_outside(a, b, near) -> bool:
    """Predictions and exit orders of two passes equal outside `near`."""
    keep = ~near
    return (np.array_equal(a[0][keep], b[0][keep])
            and np.array_equal(a[1][keep], b[1][keep]))


def zipf_requests(ids, n: int, exponent: float = 1.0, seed: int = 0):
    """Seeded Zipf(`exponent`) request stream over `ids`: a seeded
    permutation assigns popularity ranks, then requests are drawn i.i.d.
    with p(rank k) ∝ k^-exponent (the draw of the JAX package's cache
    benchmark, written here with numpy)."""
    ids = np.asarray(ids)
    rng = np.random.default_rng(seed)
    ranked = rng.permutation(ids)
    p = np.arange(1, len(ids) + 1, dtype=np.float64) ** -exponent
    p /= p.sum()
    return rng.choice(ranked, size=n, p=p)


def launch_counts(kernels) -> dict:
    return {n: k.launches for n, k in kernels.items()}


def zero_counts(kernels) -> None:
    for k in kernels.values():
        k.launches = 0
        if hasattr(k, "offset_launches"):      # B4's query-offset instances
            k.offset_launches = 0


def gnn_phases(torch, dev, kernels, tmp, scale):
    """The NAI serving path (kernels B1-B3) at the full pubmed-like size,
    its stores and checkpoints in the directory `tmp`, the scale phase's
    store made by `scale`: returns the kernel rows, each with its launches
    in the measured serving passes, and the train phase on the same graph
    and requests, for the caller to run later."""
    from repro_torch.gnn import (GNNConfig, NAIConfig, init_classifiers,
                                 load_dataset, pack_support, sample_support,
                                 step_active_blocks)
    from repro_torch.gnn.nai import support_stationary_factors
    from repro_torch.gnn.packing import batch_bucket
    from repro_torch.gnn.store import as_store
    from repro_torch.kernels.nap_exit import nap_exit, ref_nap_exit
    from repro_torch.kernels.nap_step import (fused_step, nap_step_fused,
                                              ref_nap_step, two_launch_step)
    from repro_torch.kernels.spmm import (CB, RB, nonfinite_blocks,
                                          ref_spmm_block_ell, ref_spmm_dense,
                                          spmm_block_ell, zero_flags)
    from repro_torch.serving import NAIServingEngine

    # ---------------------------------------------------- configuration
    g = load_dataset("pubmed-like", scale=1.0, seed=0)
    cfg = GNNConfig("sgc", g.features.shape[1], g.num_classes, k=4,
                    hidden=64, mlp_layers=2)
    nai = NAIConfig(t_s=20.0, t_min=1, t_max=3, batch_size=500)
    heads = init_classifiers(cfg, torch.Generator().manual_seed(0),
                             device=dev)
    requests = np.random.default_rng(0).choice(g.test_idx, size=2000,
                                               replace=False)
    print(f"graph {g.name}: n={g.n} edges={g.num_edges} f={cfg.feat_dim} "
          f"classes={cfg.num_classes}; {cfg}; {nai}")

    # ----------------------------------------------------------- kernels
    phase("kernels")
    store = as_store(g)
    batch = np.unique(requests[:nai.batch_size])   # the engine's batch 1
    sup = sample_support(store, batch, nai.t_max, cfg.r)
    x0_np = store.gather_features(sup.nodes).astype(np.float32)
    c64, s64 = support_stationary_factors(store, sup, x0_np, cfg.r)
    c_np, s_np = c64.astype(np.float32), s64.astype(np.float32)
    p = pack_support(sup, x0_np, c_np[:, None] * s_np[None, :],
                     nb_bucket=batch_bucket(sup.n_batch),
                     x_inf_factors=(c_np, s_np))
    sa = step_active_blocks(p.hop_rb, nai.t_max)
    nb, n_rb, tb = p.n_batch, p.n_rb, p.tiles.shape[1]
    F = p.x0.shape[1]
    print(f"support rows {len(sup)}, edges {len(sup.src)}, n_pad "
          f"{p.n_pad}, row blocks x tile slots {n_rb} x {tb}, valid tiles "
          f"{int(p.valid.sum())}, F_pad {F}, tiles {p.tiles.nbytes / 1e9:.3f}"
          f" GB, x0 {p.x0.nbytes / 1e6:.1f} MB, active row blocks per step "
          f"{[int(r.sum()) for r in sa]}")
    up = {"fused": ("tiles", "tile_col", "valid", "c_inf", "s_inf", "x0"),
          "block_ell": ("tiles", "tile_col", "valid", "x0", "x_inf"),
          "segment": ("src", "dst", "coef", "x0", "x_inf")}
    for impl, names in up.items():
        nbytes = sum(getattr(p, k).nbytes for k in names)
        if impl != "segment":
            nbytes += sa.nbytes
        print(f"host-to-device bytes per batch, {impl}: {nbytes}")

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    tiles, tile_col, valid = on_dev(p.tiles), on_dev(p.tile_col), \
        on_dev(p.valid)
    x0, x_inf = on_dev(p.x0), on_dev(p.x_inf)
    c, s = on_dev(p.c_inf), on_dev(p.s_inf)
    active = on_dev(sa[0])                          # step 1 of the loop
    node_active = torch.ones((nb, 1), dtype=torch.int32, device=dev)
    ts2 = float(np.float32(nai.t_s) ** 2)
    rows = []
    # the non-finite flags of x0, as the NAP loop makes them once per batch
    bad0 = nonfinite_blocks(x0)
    flags_ms = time_ms(torch, lambda: nonfinite_blocks(x0), calls=1)
    print(f"non-finite flags of x0 ({tuple(bad0.shape)}), once per batch: "
          f"{flags_ms:.4f} ms; set: {int(bad0.sum())}")
    ob = zero_flags(n_rb * RB, F, dev)

    # B1: block-ELL SpMM, called as the NAP loop calls it (flags in, out)
    out = spmm_block_ell(tiles, tile_col, valid, active, x0, x_bad=bad0,
                         out_bad=ob)
    ref = ref_spmm_block_ell(tiles, tile_col, valid, active, x0)
    torch.cuda.synchronize()
    err_b1 = float((out - ref).abs().max())
    check(torch.allclose(out, ref, rtol=1e-5, atol=1e-5),
          f"spmm_block_ell vs plain, max abs err {err_b1}")
    use = (valid != 0) & (active[:, None] != 0)
    n_use = int(use.sum())
    nnz = int((tiles[use] != 0).sum())
    n_xblk = int(torch.unique(tile_col[use]).numel())
    b1_bytes = (n_use * RB * CB * 4 + (int(active.sum()) * tb + n_use) * 4
                + n_rb * 4 + n_xblk * CB * F * 4 + n_rb * RB * F * 4
                + bad0.numel() + ob.numel())
    b1_flops = 2 * nnz * F
    # the library yardstick: one sparse product over the same active rows
    keep = np.repeat(sa[0] != 0, RB)[p.dst[:len(sup.src)]]
    e_dst = p.dst[:len(sup.src)][keep]
    e_src = p.src[:len(sup.src)][keep]
    csr = torch.sparse_coo_tensor(
        on_dev(np.stack([e_dst, e_src]).astype(np.int64)),
        on_dev(p.coef[:len(sup.src)][keep]), (n_rb * RB, p.n_pad)
    ).coalesce().to_sparse_csr()
    lib_out = torch.sparse.mm(csr, x0)
    torch.cuda.synchronize()
    check(torch.allclose(lib_out, out, rtol=1e-5, atol=1e-5),
          "torch.sparse.mm yardstick vs spmm_block_ell")
    rows.append(dict(
        name="spmm_block_ell",
        source="src/repro_torch/csrc/spmm_block_ell.cu",
        replaces="src/repro/kernels/spmm/kernel.py:51",
        max_abs_err=err_b1,
        **timings(torch,
                  lambda: spmm_block_ell(tiles, tile_col, valid, active, x0,
                                         x_bad=bad0, out_bad=ob),
                  lambda: ref_spmm_block_ell(tiles, tile_col, valid, active,
                                             x0),
                  lambda: torch.sparse.mm(csr, x0)),
        bound=bound(b1_bytes, b1_flops)))
    b1 = rows[-1]
    # counted here from the tiles: the kernel reports no count of its own
    print(f"B1 active valid tiles {n_use}, non-zeros in the active tiles "
          f"{nnz} ({nnz / max(n_use, 1):.2f} per 1,024-entry tile), x "
          f"blocks {n_xblk}; kernel {b1['ms']:.4f} ms = "
          f"{b1['bound'][0] / b1['ms']:.1%} of its bound, "
          f"{b1['ms'] / b1['library_ms']:.2f}x torch.sparse.mm")
    del csr, lib_out
    # B1 against the dense Â of the edge list (`ref_spmm_dense`, in f64:
    # not the packed tiles that B1 and its plain version read, so a fault
    # of the converter shows), on the pack of the first 16 requests'
    # support at its step-1 active row blocks (n_pad 6,144)
    sup_d = sample_support(store, np.unique(requests[:16]), nai.t_max, cfg.r)
    x_d = store.gather_features(sup_d.nodes).astype(np.float32)
    c_d, s_d = (a.astype(np.float32) for a in support_stationary_factors(
        store, sup_d, x_d, cfg.r))
    p_d = pack_support(sup_d, x_d, c_d[:, None] * s_d[None, :],
                       nb_bucket=batch_bucket(sup_d.n_batch))
    act_d = on_dev(step_active_blocks(p_d.hop_rb, nai.t_max)[0])
    e_d = len(sup_d.src)
    xp_d = on_dev(p_d.x0)
    got = spmm_block_ell(on_dev(p_d.tiles), on_dev(p_d.tile_col),
                         on_dev(p_d.valid), act_d, xp_d)
    want = ref_spmm_dense(p_d.src[:e_d], p_d.dst[:e_d], p_d.coef[:e_d],
                          p_d.n_pad, xp_d, act_d)
    torch.cuda.synchronize()
    err_d = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
          f"spmm_block_ell vs ref_spmm_dense (f64 dense product of the edge "
          f"list; rtol = atol = 1e-5), max abs err {err_d}")
    print(f"B1 against the dense Â of the edge list: support rows "
          f"{len(sup_d)}, edges {e_d}, n_pad {p_d.n_pad}, active row blocks "
          f"{int(act_d.sum())} of {p_d.tile_col.shape[0]}; max abs err "
          f"{err_d:.3g} of values up to {float(want.abs().max()):.3g}")
    del sup_d, p_d, x_d, xp_d, got, want

    # B3: exit decision on the propagated batch rows
    xb = out[:nb]
    d2, ex, blk = nap_exit(xb, x_inf, node_active, ts2)
    r_d2, r_ex, r_blk = ref_nap_exit(xb, x_inf, node_active, ts2)
    torch.cuda.synchronize()
    err_b3 = float((d2 - r_d2).abs().max())
    check(torch.allclose(d2, r_d2, rtol=1e-5, atol=1e-4),
          f"nap_exit dist2 vs plain, max abs err {err_b3}")
    far = ((r_d2 - ts2).abs() > D2_MARGIN * ts2).flatten()
    check(float((~far).float().mean()) <= MAX_NEAR_SHARE,
          "share of nodes within the threshold margin")
    check(torch.equal(ex.flatten()[far], r_ex.flatten()[far]),
          "nap_exit flags vs plain outside the margin")
    if far.all():
        check(torch.equal(blk, r_blk), "nap_exit block flags vs plain")
    print(f"B3 exits at step 1: {int(ex[:sup.n_batch].sum())} of "
          f"{sup.n_batch}; nodes "
          f"within the margin {int((~far).sum())}")
    b3_bytes = 2 * nb * F * 4 + nb * 4 + nb * 8 + nb // RB * 4
    rows.append(dict(
        name="nap_exit", source="src/repro_torch/csrc/nap_exit.cu",
        replaces="src/repro/kernels/nap_exit/kernel.py:47",
        max_abs_err=err_b3,
        **timings(torch, lambda: nap_exit(xb, x_inf, node_active, ts2),
                  lambda: ref_nap_exit(xb, x_inf, node_active, ts2),
                  lambda: ((xb - c[:, None] * s) ** 2).sum(1)),
        bound=bound(b3_bytes, 3 * nb * F)))
    # device time alone (CUDA graph replay: no launch gaps), to tell the
    # kernel from the host's launch rate that both event rulers include
    b3 = rows[-1]
    b3["device_ms"] = graph_ms(
        torch, lambda: nap_exit(xb, x_inf, node_active, ts2))
    b3["library_device_ms"] = graph_ms(
        torch, lambda: ((xb - c[:, None] * s) ** 2).sum(1))
    print(f"B3 device time (CUDA graph of 10 calls): kernel "
          f"{b3['device_ms']:.4f} ms, library "
          f"{b3['library_device_ms']:.4f} ms; events around 10 calls: "
          f"{b3['ms']:.4f} / {b3['library_ms']:.4f} ms, one call: "
          f"{b3['ms_one_call']:.4f} / {b3['library_ms_one_call']:.4f} ms")

    # B2: fused step, called as the NAP loop calls it (flags in, out)
    f_args = (tiles, tile_col, valid, active, x0, c, s, node_active)
    f_ob = zero_flags(n_rb * RB, F, dev)
    f_out, f_ex, f_blk = nap_step_fused(*f_args, ts2, x_bad=bad0,
                                        out_bad=f_ob)
    r_out, r_ex2, r_blk2 = ref_nap_step(*f_args, ts2)
    torch.cuda.synchronize()
    check(torch.equal(f_out, out) and torch.equal(f_ob, ob),
          "nap_step_fused out and its flags bitwise == spmm_block_ell's")
    check(torch.equal(f_ex, ex) and torch.equal(f_blk[:nb // RB], blk),
          "nap_step_fused flags == spmm_block_ell + nap_exit flags")
    err_b2 = float((f_out - r_out).abs().max())
    check(torch.allclose(f_out, r_out, rtol=1e-5, atol=1e-5),
          f"nap_step_fused out vs plain, max abs err {err_b2}")
    check(torch.equal(f_ex.flatten()[far], r_ex2.flatten()[far]),
          "nap_step_fused flags vs plain outside the margin")
    two = two_launch_step(*f_args, nai.t_s)
    one = fused_step(*f_args, nai.t_s)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(one, two)),
          "fused_step == two_launch_step (all outputs)")
    b2_bytes = b1_bytes + nb * 4 + F * 4 + nb * 4 + nb * 4 + n_rb * 4
    rows.append(dict(
        name="nap_step_fused",
        source="src/repro_torch/csrc/nap_step_fused.cu",
        replaces="src/repro/kernels/nap_step/kernel.py:109",
        max_abs_err=err_b2,
        **timings(torch, lambda: nap_step_fused(*f_args, ts2, x_bad=bad0,
                                                out_bad=f_ob),
                  lambda: ref_nap_step(*f_args, ts2)),
        bound=bound(b2_bytes, b1_flops + 4 * nb * F)))
    b2 = rows[-1]
    print(f"B2 kernel {b2['ms']:.4f} ms = {b2['bound'][0] / b2['ms']:.1%} of "
          f"its bound, {b2['ms'] / b1['ms']:.2f}x B1")
    del out, ref, f_out, r_out, one, two
    nonfinite_phase(torch, tiles, tile_col, valid, active, x0, c, s,
                    node_active, ts2)
    del tiles, tile_col, valid, x0, x_inf
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- serve
    phase("serve")

    def serve(eng, nodes):
        return serve_requests(torch, eng, nodes)

    engines = {impl: NAIServingEngine(cfg, nai, heads, g, device=dev,
                                      mode="compiled", spmm_impl=impl,
                                      pipeline_depth=2, max_wait_s=10.0)
               for impl in ("fused", "block_ell", "segment")}
    warm_packs = {}
    for impl, eng in engines.items():
        # a first pass over the same requests sizes the bucket high-water
        # marks and allocates (and pins) the pack pool; the measured pass
        # below is the steady state
        serve(eng, requests)
        eng.reset_stats()
        warm_packs[impl] = dict(eng.pack_stats)
    host = NAIServingEngine(cfg, nai, heads, g, device=dev, mode="host",
                            max_wait_s=10.0)
    hp, ho, h_wall = serve(host, requests)
    print(f"host: {len(requests) / h_wall:.1f} req/s, exit histogram "
          f"{dict(sorted(host.stats.exit_hist.items()))}")
    check(set(ho) == {1, 2, 3}, "the host path exercises every order")

    zero_counts(kernels)                  # the main path starts here
    results, per_backend = {}, {}
    for impl, eng in engines.items():
        before = launch_counts(kernels)
        results[impl] = serve(eng, requests)
        per_backend[impl] = {n: k.launches - before[n]
                             for n, k in kernels.items()}
        summ = eng.stats.summary()
        t = list(eng.batch_timings)
        print(f"{impl}: {len(requests) / results[impl][2]:.1f} req/s, p50 "
              f"{summ['p50_ms']:.1f} ms, p99 {summ['p99_ms']:.1f} ms, exit "
              f"histogram {dict(sorted(eng.stats.exit_hist.items()))}, "
              f"launches {per_backend[impl]}, per batch host "
              f"{np.mean([b['host_s'] for b in t]) * 1e3:.1f} ms dispatch "
              f"{np.mean([b['dispatch_s'] for b in t]) * 1e3:.1f} ms sync "
              f"{np.mean([b['sync_s'] for b in t]) * 1e3:.1f} ms, pack "
              f"buffers allocated "
              f"{eng.pack_stats['allocs'] - warm_packs[impl]['allocs']} "
              f"reused {eng.pack_stats['reuses'] - warm_packs[impl]['reuses']}")
    launches = launch_counts(kernels)

    # a separate traced pass per backend (after the counted ones): device
    # busy time = union of the intervals of the kernels and copies the
    # profiler saw on the card, against the pass's wall time; the
    # host-to-device copies' stream and their overlap with kernels, also
    # for fused at pipeline depth 1 (ROADMAP A5.3)
    from torch.profiler import ProfilerActivity, profile
    serial = NAIServingEngine(cfg, nai, heads, g, device=dev,
                              mode="compiled", spmm_impl="fused",
                              pipeline_depth=1, max_wait_s=10.0)
    serve(serial, requests)                               # warm
    traced = [(impl, 2, eng) for impl, eng in engines.items()]
    traced.append(("fused", 1, serial))
    for impl, depth, eng in traced:
        keys = eng.jit_stats["compiles"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, wall = serve(eng, requests)
        busy, idle, by_name = device_spans(prof, wall)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        h2d = copy_overlap(prof)
        print(f"{impl} traced pass (pipeline depth {depth}): busy "
              f"{busy:.1f} ms of {1e3 * wall:.1f} ms wall (idle share "
              f"{idle:.3f}); most device time: "
              + ", ".join(f"{k[:48]} {v:.1f} ms" for k, v in top)
              + f"; Memcpy HtoD {h2d['ms']:.2f} ms of device time, "
              f"{h2d['copy_stream_ms']:.2f} ms of it on the copy stream "
              f"(streams {h2d['streams']}; kernels on {h2d['kernel_streams']}"
              f"), {h2d['overlap_ms']:.2f} ms of it beside kernels; new "
              f"shape keys (jit_compiles) {eng.jit_stats['compiles'] - keys}"
              f" of {eng.jit_cache_size()}")
        check(eng.jit_stats["compiles"] == keys,
              f"{impl} depth {depth}: the steady-state pass adds no shape "
              f"key ({eng.jit_stats})")
        if eng.pack_place["host"]:
            check(h2d["copy_stream_ms"] > 0.5 * h2d["ms"],
                  f"{impl} depth {depth}: Memcpy HtoD runs on the copy "
                  f"stream ({h2d})")
    del serial

    dist = request_distances(cfg, nai, g, requests, nai.batch_size)
    near = within_margin(dist, nai.t_s)
    check(near.mean() <= MAX_NEAR_SHARE, f"{near.sum()} requests within "
          f"the threshold margin")
    for impl, (pr, od, _) in results.items():
        keep = ~near
        check(np.array_equal(od[keep], ho[keep])
              and np.array_equal(pr[keep], hp[keep]),
              f"{impl} matches the host path outside the margin")
    check(np.array_equal(results["fused"][0], results["block_ell"][0])
          and np.array_equal(results["fused"][1], results["block_ell"][1]),
          "fused and block_ell give identical predictions and exit orders")
    check(per_backend["block_ell"]["spmm_block_ell"] > 0
          and per_backend["block_ell"]["nap_exit"] > 0,
          "block_ell launched B1 and B3")
    check(per_backend["fused"]["nap_step_fused"] > 0, "fused launched B2")
    check(all(v == 0 for v in per_backend["segment"].values()),
          "segment launched no block-ELL kernel")
    print(f"requests within the threshold margin: {int(near.sum())}")
    n_batches = -(-len(requests) // nai.batch_size)
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["note"] = (f"over {n_batches} batches of the backend that runs it "
                     f"({r['launches'] / n_batches:g} per batch)")
    check(all(eng.sample_stats["host"] == 0
              and eng.sample_stats["device"] > 0
              for eng in engines.values()),
          "the serving engines sampled every batch on the card")
    check(all((eng.pack_place["host"] == 0) == (impl == "segment")
              for impl, eng in engines.items()),
          f"segment built every batch's operands on the card, the tile "
          f"backends on the host "
          f"({ {i: e.pack_place for i, e in engines.items()} })")
    # the serving engines' pinned pools go before the next phases'
    del engines, host, prof
    gc.collect()
    torch.cuda.empty_cache()
    device_sampler_phase(torch, dev)
    sharded = sharded_phase(torch, dev, kernels, g, cfg, nai, heads,
                            requests, near)
    for r in rows:
        r["note"] = (f"({r['launches']} in the serve phase {r['note']}, "
                     f"+ {sharded[r['name']]} in the sharded phase)")
        r["launches"] += sharded[r["name"]]
    store_path = store_phase(torch, dev, kernels, g, cfg, nai, heads,
                             requests, results, tmp)
    faults_phase(torch, dev, kernels, g, cfg, nai, heads, store_path)
    scale_path = scale_phase(torch, dev, kernels, scale)
    offline_phase(torch, dev, kernels, g, cfg, heads, scale_path, tmp)
    cache_phase(torch, dev, kernels, g, cfg, heads)
    frontend_phase(torch, dev, kernels, g, cfg, nai, heads,
                   len(requests) / results["fused"][2])
    return rows, lambda: train_phase(
        torch, dev, kernels, g, dataclasses.replace(cfg, dropout=0.1), nai,
        requests, dist)


def device_sampler_phase(torch, dev, batches: int = 3):
    """The device sampler against the numpy sampler on the benchmark
    cell's graph size (arxiv-like at scale 1.0, 169,343 nodes), `batches`
    batches of 500 test-split ids, 2 hops: every array equal, and each
    sampler's ms per batch (the first device call uploads the CSR)."""
    from repro_torch.gnn import load_dataset
    from repro_torch.gnn.device_sampler import DeviceSampler
    from repro_torch.gnn.sampler import sample_support
    from repro_torch.gnn.store import InMemoryStore
    phase("device sampler")
    g = load_dataset("arxiv-like", scale=1.0, seed=0)
    store = InMemoryStore(g)
    sampler = DeviceSampler(store, 0.5, dev)
    rng = np.random.default_rng(0)
    dev_ms, host_ms = [], []
    for _ in range(batches):
        batch = rng.choice(g.test_idx, size=500, replace=False)
        t = time.perf_counter()
        got = sampler.sample(batch, 2)
        dev_ms.append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        want = sample_support(store, batch, 2, 0.5)
        host_ms.append(1e3 * (time.perf_counter() - t))
        check(all(np.array_equal(getattr(got, k), getattr(want, k))
                  and getattr(got, k).dtype == getattr(want, k).dtype
                  for k in ("nodes", "hop", "src", "dst", "coef"))
              and (got.n_batch, got.sub_edges)
              == (want.n_batch, want.sub_edges),
              "device sampler == numpy sampler on arxiv-like, batch 500")
    print(f"device sampler on {g.name} (n={g.n}): support {len(want)} "
          f"nodes, {len(want.src)} edges; ms per batch, device "
          f"{[round(v, 2) for v in dev_ms]}, numpy "
          f"{[round(v, 2) for v in host_ms]}")


def raises(fn, exc) -> bool:
    """Whether fn() raises `exc` (any other exception propagates)."""
    try:
        fn()
    except exc:
        return True
    return False


def store_phase(torch, dev, kernels, g, cfg, nai, heads, requests, results,
                tmp):
    """The pubmed-like graph saved as a store directory and served from
    it: CRC32 verification, a flipped byte caught, and the serve phase's
    2,000 requests through `fused` and `block_ell` from the `MmapStore`,
    equal to the in-memory passes exactly."""
    import shutil
    from repro_torch.gnn import MmapStore, StoreCorruption, save_graph_store
    from repro_torch.serving import NAIServingEngine
    phase("store")
    t_phase = time.perf_counter()
    path = str(Path(tmp) / "pubmed-like")
    t = time.perf_counter()
    save_graph_store(g, path)
    with MmapStore(path) as st:
        verified = st.verify()
    print(f"saved {g.name} ({sum(f.stat().st_size for f in Path(path).iterdir())}"
          f" bytes) in {time.perf_counter() - t:.2f} s; verify() checked "
          f"{verified}")
    check(verified == ["row_ptr", "col_idx", "features", "degrees",
                       "labels"], "verify() checks every array")
    bad = path + "-flipped"
    shutil.copytree(path, bad)
    feat = Path(bad) / "features.npy"
    with open(feat, "r+b") as fh:
        fh.seek(feat.stat().st_size // 2)
        byte = fh.read(1)[0]
        fh.seek(-1, 1)
        fh.write(bytes([byte ^ 0x01]))
    check(raises(lambda: MmapStore(bad).verify(), StoreCorruption),
          "a flipped byte raises StoreCorruption")
    shutil.rmtree(bad)
    print("a copy with one flipped byte in features.npy: StoreCorruption")
    ms = MmapStore(path)
    zero_counts(kernels)
    for impl in ("fused", "block_ell"):
        eng = NAIServingEngine(cfg, nai, heads, ms, device=dev,
                               mode="compiled", spmm_impl=impl,
                               pipeline_depth=2, max_wait_s=10.0)
        pr, od, wall = serve_requests(torch, eng, requests)
        check(np.array_equal(pr, results[impl][0])
              and np.array_equal(od, results[impl][1]),
              f"{impl} from the MmapStore == from the InMemoryStore")
        print(f"{impl} from the MmapStore (first pass, pools allocated): "
              f"{len(requests) / wall:.1f} req/s; predictions and exit "
              f"orders equal to the in-memory pass")
        del eng
    launches = launch_counts(kernels)
    print(f"store phase launches {launches}")
    check(launches["nap_step_fused"] > 0 and launches["spmm_block_ell"] > 0
          and launches["nap_exit"] > 0, "the store phase launched B1-B3")
    ms.close()
    print(f"store phase {time.perf_counter() - t_phase:.1f} s")
    return path


def _rss_bytes() -> int:
    """VmRSS of this process, in bytes."""
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return -1


def _watch_rss(stop, peak, period_s: float = 0.02) -> None:
    """Sample VmRSS until `stop` is set, keeping the highest reading in
    peak[0] (the sandbox's /proc has no VmHWM)."""
    while not stop.is_set():
        peak[0] = max(peak[0], _rss_bytes())
        stop.wait(period_s)


class ScaleStore:
    """The scale phase's store: `make_graph`'s power-law graph of `n`
    nodes with 256 features (1.02 GB), written into `tmp` by a process of
    its own that starts at once, beside the kernels' build, and prints the
    seconds it took. `main` waits for it after the build, so it runs
    beside no timed phase."""

    def __init__(self, tmp, n: int = 1_000_000):
        self.path = str(Path(tmp) / f"powerlaw-{n}")
        self.gen_s = None
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             "import time; t = time.perf_counter(); "
             "from repro_torch.gnn.store import _main; _main(); "
             "print(time.perf_counter() - t)",
             "--n", str(n), "--avg-deg", "16", "--alpha", "2.2", "--seed",
             "7", "--feat-dim", "256", "--out", self.path],
            stdout=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=str(REPO / "src")))

    def wait(self):
        """(the store's path, the seconds its process took)."""
        if self.gen_s is None:
            out, _ = self.proc.communicate(timeout=300)
            if self.proc.returncode:
                raise subprocess.CalledProcessError(self.proc.returncode,
                                                    self.proc.args, out)
            self.gen_s = float(out.split()[-1])
        return self.path, self.gen_s

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()


def scale_phase(torch, dev, kernels, scale: ScaleStore):
    """The JAX serving bench's 1e6-node row: the power-law store `scale`
    made (by `make_graph`, in a process of its own), then 32 batches of 64
    uniform ids served from the `MmapStore` once on `fused` at depth 2
    and once on `block_ell`, which must give the same predictions and exit
    orders (the passes' req/s include allocating the pools)."""
    from repro_torch.gnn import (GNNConfig, MmapStore, NAIConfig,
                                 init_classifiers)
    from repro_torch.serving import NAIServingEngine
    phase("scale")
    t_phase = time.perf_counter()
    path, gen_s = scale.wait()
    store = MmapStore(path)
    feat_bytes = store.n * store.feat_dim * 4
    cfg = GNNConfig("sgc", store.feat_dim, store.num_classes, k=2,
                    hidden=32, mlp_layers=2)
    nai = NAIConfig(t_s=6.0, t_min=1, t_max=2, batch_size=64)
    heads = init_classifiers(cfg, torch.Generator().manual_seed(0),
                             device=dev)
    rng = np.random.default_rng(7)
    batches = [np.unique(rng.integers(0, store.n, size=nai.batch_size))
               for _ in range(32)]
    nodes = np.concatenate(batches)
    print(f"{store!r}: generated in {gen_s:.1f} s (a process of its own, "
          f"beside the build); "
          f"features {feat_bytes} bytes; {len(batches)} batches, "
          f"{len(nodes)} requests")
    rss0 = _rss_bytes()
    stop, peak = threading.Event(), [rss0]
    watcher = threading.Thread(target=_watch_rss, args=(stop, peak),
                               daemon=True)
    watcher.start()
    engines = {impl: NAIServingEngine(cfg, nai, heads, store, device=dev,
                                      mode="compiled", spmm_impl=impl,
                                      pipeline_depth=2, max_wait_s=10.0)
               for impl in ("fused", "block_ell")}
    fused = engines["fused"]
    zero_counts(kernels)
    res = {"fused": serve_requests(torch, fused, nodes, batches)}
    launches = launch_counts(kernels)
    tm = list(fused.batch_timings)
    res["block_ell"] = serve_requests(torch, engines["block_ell"], nodes,
                                      batches)
    stop.set()
    watcher.join()
    peak = peak[0]
    pool = sum(t.numel() * t.element_size() for d in fused._pinned.values()
               for t in d.values())
    check(np.array_equal(res["fused"][0], res["block_ell"][0])
          and np.array_equal(res["fused"][1], res["block_ell"][1]),
          "scale: fused and block_ell give identical predictions and exit "
          "orders")
    check(launches["nap_step_fused"] > 0, "scale: fused launched B2")
    print(f"fused (first pass, pools allocated): "
          f"{len(nodes) / res['fused'][2]:.1f} req/s, "
          f"per batch host {np.mean([b['host_s'] for b in tm]) * 1e3:.1f} "
          f"ms dispatch {np.mean([b['dispatch_s'] for b in tm]) * 1e3:.1f} "
          f"ms sync {np.mean([b['sync_s'] for b in tm]) * 1e3:.1f} ms, B2 "
          f"launches {launches['nap_step_fused']}, exit histogram "
          f"{dict(sorted(fused.stats.exit_hist.items()))}; block_ell "
          f"(first pass) {len(nodes) / res['block_ell'][2]:.1f} req/s, "
          f"equal predictions and exit orders")
    print(f"RSS while serving (VmRSS sampled every 20 ms): peak {peak} "
          f"bytes, {rss0} at the start (earlier phases' cached pinned host "
          f"memory included), growth {peak - rss0} bytes = "
          f"{(peak - rss0) / feat_bytes:.2f}x the feature bytes "
          f"{feat_bytes}; pinned pack pool of the fused engine {pool} bytes")
    for eng in engines.values():
        eng.close()       # closes the shared store too (idempotent)
    del engines, fused
    gc.collect()
    torch.cuda.empty_cache()
    print(f"scale phase {time.perf_counter() - t_phase:.1f} s")
    return path


def cache_phase(torch, dev, kernels, g, cfg, heads):
    """The propagated-feature cache at the full pubmed-like size: 1,024
    Zipf(1.0) requests over the test split, batches of 64, served with
    the cache on (4,096 nodes) and off on every backend (and, on `fused`,
    with fills off: a no-hit control): two warm passes, a steady pass
    with no pack allocation, and a pass after a mutation round."""
    from repro_torch.gnn import InMemoryStore, NAIConfig
    from repro_torch.serving import NAIServingEngine
    phase("cache")
    t_phase = time.perf_counter()
    nai = NAIConfig(t_s=20.0, t_min=1, t_max=3, batch_size=64)
    requests = zipf_requests(g.test_idx, 1024, exponent=1.0, seed=0)
    store = InMemoryStore(g)      # mutated below; `g` keeps its topology
    kw = dict(device=dev, mode="compiled", pipeline_depth=2,
              max_wait_s=10.0)
    engines = {}
    for impl in ("fused", "block_ell", "segment"):
        engines[impl, "on"] = NAIServingEngine(
            cfg, nai, heads, store, spmm_impl=impl, cache_nodes=4096, **kw)
        engines[impl, "off"] = NAIServingEngine(cfg, nai, heads, store,
                                                spmm_impl=impl, **kw)
    engines["fused", "no fills"] = NAIServingEngine(
        cfg, nai, heads, store, spmm_impl="fused", cache_nodes=4096,
        cache_fill=False, **kw)
    print(f"{len(requests)} requests ({len(np.unique(requests))} distinct) "
          f"of {len(g.test_idx)} test nodes, batches of {nai.batch_size}; "
          f"{nai}")

    def run_pass(name, near, reuse=None):
        """Serve the requests through every engine but those whose
        results `reuse` gives, and check the pass."""
        out, allocs = dict(reuse or {}), {}
        for key, eng in engines.items():
            if key in out:
                continue
            a0 = eng.pack_stats["allocs"]
            eng.reset_stats()
            out[key] = serve_requests(torch, eng, requests)
            allocs[key] = eng.pack_stats["allocs"] - a0
        for impl in ("fused", "block_ell", "segment"):
            check(same_outside(out[impl, "on"], out[impl, "off"], near),
                  f"cache {name}: {impl} cached == cold outside the margin")
        check(same_outside(out["fused", "no fills"], out["fused", "off"],
                           near), f"cache {name}: the no-hit control == cold")
        for state in ("on", "off"):
            check(all(np.array_equal(a, b) for a, b in zip(
                out["fused", state][:2], out["block_ell", state][:2])),
                f"cache {name}: fused == block_ell exactly, cache {state}")
        stats = {k: e.cache_stats for k, e in engines.items()}
        for impl in ("fused", "block_ell", "segment"):
            cs = stats[impl, "on"]
            check(cs["hits"] > 0 and cs["rows_packed"] < cs["rows_support"],
                  f"cache {name}: {impl} hits and saves rows ({cs})")
        check(stats["fused", "no fills"]["hits"] == 0,
              f"cache {name}: the no-hit control hits nothing")
        cs = stats["fused", "on"]
        rate = {k: len(requests) / out[k][2] for k in allocs}
        print(f"{name}: requests within the margin {int(near.sum())}; "
              f"fused hit rate {cs['hit_rate']:.4f} ({cs['hits']} hits, "
              f"{cs['stale']} stale, {cs['size']} cached), rows saved "
              f"{1 - cs['rows_packed'] / cs['rows_support']:.4f} "
              f"({cs['rows_packed']} of {cs['rows_support']} packed); req/s "
              + ", ".join(f"{i} {s} {r:.1f}" for (i, s), r in rate.items())
              + f"; pack allocations {allocs}")
        return out, allocs, stats

    # the margin depends on the graph and the batches only: once per graph
    near = near_margin(cfg, nai, store, requests, nai.batch_size)
    check(near.mean() <= MAX_NEAR_SHARE, f"cache: {near.sum()} requests "
          f"within the threshold margin")
    zero_counts(kernels)
    # two warm passes: the first fills the cache; after the second the
    # bucket marks have settled and every pooled slot a pass takes is
    # allocated at its final shapes (an H100 run's third pass allocated
    # nothing on any engine, the pass that a fourth then repeated). The
    # cold engines and the no-hit control, whose results nothing in the
    # cache changes, sit the second out: their second pass allocated
    # nothing, and pass 1's results stand in for it
    first, _, _ = run_pass("pass 1 (warm)", near)
    run_pass("pass 2 (warm)", near,
             reuse={k: v for k, v in first.items() if k[1] != "on"})
    _, allocs, _ = run_pass("pass 3 (steady)", near)
    check(all(a == 0 for a in allocs.values()),
          f"cache: zero pack allocations in the steady pass ({allocs})")
    rng = np.random.default_rng(7)
    served = np.unique(requests)
    src = rng.choice(served, size=8, replace=False)
    dst = (src + 1) % store.n
    store.add_edges(src, dst)
    new = store.add_nodes(rng.standard_normal(
        (2, store.feat_dim)).astype(np.float32))
    print(f"mutation: add_edges {list(zip(src.tolist(), dst.tolist()))}, "
          f"add_nodes {new.tolist()}; mutation clock "
          f"{store.mutation_clock}")
    near = near_margin(cfg, nai, store, requests, nai.batch_size)
    check(near.mean() <= MAX_NEAR_SHARE, f"cache: {near.sum()} requests "
          f"within the threshold margin after the mutation")
    _, _, stats = run_pass("pass 4 (after the mutation)", near)
    check(stats["fused", "on"]["stale"] > 0,
          "cache: the mutation staled cached entries")
    launches = launch_counts(kernels)
    print(f"cache phase launches {launches}")
    check(launches["nap_step_fused"] > 0 and launches["spmm_block_ell"] > 0
          and launches["nap_exit"] > 0, "the cache phase launched B1-B3")
    print(f"cache phase {time.perf_counter() - t_phase:.1f} s")
    del engines
    gc.collect()
    torch.cuda.empty_cache()

def faults_phase(torch, dev, kernels, g, cfg, nai, heads, store_path):
    """Failure-domain isolation at the full pubmed-like size: 8 batches of
    500 test-split requests through `fused` at depth 2 with the watchdog
    armed and one seeded `FaultPlan` (host, device, nan, slow and hang
    faults at fixed batches): conservation, exactly the named batches
    failed with their typed errors, every other batch bitwise equal to a
    fault-free run, the hang declared within the watchdog plus its slack;
    the same plan with `retry_failed` (the failed batches completed on the
    host path, equal to the host-mode engine's); then a `FaultyStore`
    over the store phase's `MmapStore` with a `store_read` fault on
    `block_ell`, failing only its batch."""
    from repro_torch.gnn import MmapStore
    from repro_torch.serving import (FaultPlan, FaultSpec, FaultyStore,
                                     NAIServingEngine)
    phase("faults")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(17)
    batches = [rng.choice(g.test_idx, size=nai.batch_size, replace=False)
               for _ in range(8)]
    watchdog_s, slack_s = 1.0, 0.1
    # event counters tick per stage: host and slow once per batch, device
    # once per batch past the host stage, nan once per dispatched batch,
    # hang once per dispatched batch nan left alone; so these indices put
    # the faults on batches 1 (host), 3 (device), 5 (nan), 6 (slow) and 7
    # (hang, the last: flush() meets it before its deadline)
    plan = FaultPlan([FaultSpec("host", at=(1,)),
                      FaultSpec("device", at=(2,)),
                      FaultSpec("nan", at=(3,)),
                      FaultSpec("slow", at=(6,), delay_s=0.3),
                      FaultSpec("hang", at=(4,))], seed=17)
    named = {1: "InjectedFault", 3: "InjectedFault", 5: "NaNGuardError",
             7: "WatchdogTimeout"}
    kw = dict(device=dev, mode="compiled", pipeline_depth=2,
              max_wait_s=10.0)
    print(f"{len(batches)} batches of {nai.batch_size} test-split requests;"
          f" {plan}; watchdog {watchdog_s} s (slack {slack_s} s)")

    def run(eng, bs, hung=None):
        """Serve `bs` one batch per step; returns (requests per batch,
        terminal requests, wall seconds, dispatch time of batch `hung`)."""
        eng.reset_stats()
        t0 = time.perf_counter()
        per_batch, done, t_hung = [], [], None
        for i, b in enumerate(bs):
            eng.submit(b)
            per_batch.append(list(eng.queue))
            done += eng.step()
            if i == hung:
                t_hung = eng._inflight[-1].t_submit
        done += eng.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ids = [id(r) for r in done]
        check(len(ids) == len(set(ids)) and set(ids) == {
            id(r) for rs in per_batch for r in rs}
            and eng.stats.served + eng.stats.failed == len(ids),
            "faults: every accepted request ended exactly once")
        return per_batch, done, wall, t_hung

    def outcome(rs):
        return (np.array([r.prediction for r in rs]),
                np.array([r.exit_order for r in rs]))

    zero_counts(kernels)
    clean_eng = NAIServingEngine(cfg, nai, heads, g, spmm_impl="fused",
                                 **kw)
    run(clean_eng, batches)                       # warm: pools pinned
    clean, _, wall, _ = run(clean_eng, batches)
    print(f"fault-free fused: {len(batches) * nai.batch_size / wall:.1f} "
          f"req/s")
    del clean_eng
    eng = NAIServingEngine(cfg, nai, heads, g, spmm_impl="fused",
                           faults=plan, watchdog_s=watchdog_s, **kw)
    got, done, wall, t_hung = run(eng, batches, hung=7)
    for i, rs in enumerate(got):
        if i in named:
            errs = {r.error.split(":")[0] for r in rs}
            check(all(r.status == "failed" for r in rs)
                  and errs == {named[i]},
                  f"faults: batch {i} failed with {named[i]} ({errs})")
        else:
            check(all(r.status == "completed" for r in rs)
                  and all(np.array_equal(a, b) for a, b in
                          zip(outcome(rs), outcome(clean[i]))),
                  f"faults: batch {i} completed, bitwise equal to the "
                  f"fault-free run")
    lat = [r.done_s - t_hung for r in got[7]]
    check(watchdog_s <= min(lat) and max(lat) <= watchdog_s + slack_s,
          f"faults: hang declared {min(lat):.4f}-{max(lat):.4f} s after "
          f"dispatch (watchdog {watchdog_s} s + slack {slack_s} s)")
    print(f"faulted fused: {wall:.2f} s for {len(done)} requests, failed "
          f"{eng.stats.failed} in batches {sorted(named)}; hang declared "
          f"{max(lat):.4f} s after dispatch; fault_stats {eng.fault_stats}")
    del eng
    retry = NAIServingEngine(cfg, nai, heads, g, spmm_impl="fused",
                             faults=plan, watchdog_s=watchdog_s,
                             retry_failed=True, **kw)
    got, _, wall, _ = run(retry, batches)
    host = NAIServingEngine(cfg, nai, heads, g, device=dev, mode="host",
                            max_wait_s=10.0)
    t0 = time.perf_counter()
    for i, rs in enumerate(got):
        want = clean[i]
        if i in named:
            check(all(r.retried for r in rs),
                  f"faults: batch {i} completed on the host path")
            want, _, _, _ = run(host, [batches[i]])
            want = want[0]
        check(all(r.status == "completed" for r in rs)
              and all(np.array_equal(a, b) for a, b in
                      zip(outcome(rs), outcome(want))),
              f"faults: retry_failed batch {i} equal to "
              f"{'the host-mode engine' if i in named else 'fault-free'}")
    print(f"retry_failed: every request completed ({retry.stats.retried} "
          f"on the host path, {wall:.2f} s; host-mode engine on the "
          f"failed batches {time.perf_counter() - t0:.2f} s), equal to the "
          f"host-mode engine on those batches")
    del retry, host
    store = FaultyStore(MmapStore(store_path), FaultPlan(
        [FaultSpec("store_read", at=(1,))], seed=17).injector())
    feng = NAIServingEngine(cfg, nai, heads, store, spmm_impl="block_ell",
                            **kw)
    got, _, wall, _ = run(feng, batches[:4])
    for i, rs in enumerate(got):
        if i == 1:
            check(all(r.status == "failed" and
                      r.error.startswith("StoreIOError") for r in rs),
                  "faults: the store_read batch failed with StoreIOError")
        else:
            check(all(r.status == "completed" for r in rs)
                  and all(np.array_equal(a, b) for a, b in
                          zip(outcome(rs), outcome(clean[i]))),
                  f"faults: FaultyStore batch {i} equal to the fault-free "
                  f"run")
    print(f"FaultyStore over the MmapStore, block_ell: batch 1 failed "
          f"(StoreIOError), batches 0, 2, 3 equal to the fault-free run; "
          f"{wall:.2f} s; {store.injector.summary()}")
    feng.close()
    del feng
    launches = launch_counts(kernels)
    print(f"faults phase launches {launches}")
    check(launches["nap_step_fused"] > 0 and launches["spmm_block_ell"] > 0
          and launches["nap_exit"] > 0, "the faults phase launched B1-B3")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"faults phase {time.perf_counter() - t_phase:.1f} s")


def _full_graph_near(torch, store, r, t_s, t_min, t_max):
    """Bool per node: does a decision-step d² under full-graph propagation
    (float64, on the CPU) lie within D2_MARGIN of t_s²?"""
    from repro_torch.gnn.distributed import graph_as_support
    from repro_torch.gnn.nai import support_stationary_factors
    sup = graph_as_support(store, r)
    x0 = np.asarray(store.features, np.float32)
    c, s = support_stationary_factors(store, sup, x0, r)
    x_inf = torch.from_numpy(c[:, None] * s[None, :])
    x = torch.from_numpy(x0).double()
    src = torch.from_numpy(sup.src).long()
    dst = torch.from_numpy(sup.dst).long()
    coef = torch.from_numpy(sup.coef).double()[:, None]
    ts2 = float(np.float32(t_s) ** 2)
    near = np.zeros(store.n, bool)
    for l in range(1, t_max):
        x = torch.zeros_like(x).index_add_(0, dst, coef * x[src])
        if l >= t_min:
            d2 = ((x - x_inf) ** 2).sum(1).numpy()
            near |= np.abs(d2 - ts2) <= D2_MARGIN * ts2
    return near


SHARD_REQUESTS = 1000         # per sharded configuration (2 batches of 500)
SHARD_CONFIGS = ((2, "halo"), (2, "dense"), (2, "alltoall"), (4, "halo"),
                 (4, "alltoall"))


def offline_times(st) -> str:
    """One offline run's seconds per stage and nodes/s."""
    return (f"pack {st['pack_s']:.3f} s, {st['supersteps_run']} "
            f"supersteps {st['compute_s']:.4f} s "
            f"({st['compute_s'] / max(st['supersteps_run'], 1):.4f} s "
            f"each) + to host {st['to_host_s']:.3f} s, checkpoints "
            f"{st['ckpt_s']:.3f} s / {st['ckpt_bytes']} bytes, classify "
            f"{st['classify_s']:.3f} s, total {st['total_s']:.3f} s, "
            f"{st['nodes_per_s']:.1f} nodes/s")


def device_events(prof):
    """The kernels, copies and memsets a profiler saw on the card: its
    CUDA events less the device-side shadows of host ranges (`serve.*`,
    `exchange.*`), which cover the gaps between the kernels they launched
    on every stream they launched on."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_spans(prof, wall_s):
    """(busy ms, idle share, {kernel name: device ms}) of a profiled
    window: busy = the union of the device events' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in device_events(prof))
    busy_us, reach, by_name = 0.0, -np.inf, {}
    for lo, hi, kname in spans:
        busy_us += max(0.0, hi - max(lo, reach))
        reach = max(reach, hi)
        by_name[kname] = by_name.get(kname, 0.0) + (hi - lo) / 1e3
    return busy_us / 1e3, 1 - busy_us / 1e3 / (1e3 * wall_s), by_name


def copy_overlap(prof):
    """The host-to-device copies of a profiled window: their device ms,
    the streams they ran on, the ms of them on a stream that runs no
    kernel (the engine's copy stream), the streams the kernels ran on,
    and the ms of the copies during which a kernel ran."""
    ev = device_events(prof)
    copies = [e for e in ev if "HtoD" in e.name]
    kern = [e for e in ev if "Memcpy" not in e.name
            and "Memset" not in e.name]
    kstreams = sorted({e.device_resource_id for e in kern})
    spans, reach = [], -np.inf
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in kern):
        if lo > reach:
            spans.append([lo, hi])
        else:
            spans[-1][1] = max(spans[-1][1], hi)
        reach = max(reach, hi)
    overlap = sum(max(0.0, min(hi, e.time_range.end)
                      - max(lo, e.time_range.start))
                  for e in copies for lo, hi in spans)
    return dict(
        ms=sum(e.time_range.end - e.time_range.start for e in copies) / 1e3,
        copy_stream_ms=sum(e.time_range.end - e.time_range.start
                           for e in copies
                           if e.device_resource_id not in kstreams) / 1e3,
        streams=sorted({e.device_resource_id for e in copies}),
        kernel_streams=kstreams, overlap_ms=overlap / 1e3)


def sharded_phase(torch, dev, kernels, g, cfg, nai, heads, requests, near):
    """Sharded serving and offline inference (ROADMAP A7) with D shards on
    the one card (`make_serving_mesh(D, devices=(dev,) * D)`): the mesh
    code path and its exchanges, not the capacity of D cards. Serve: the
    first 1,000 of the serve phase's requests through every backend at
    D = 2 (halo, dense, alltoall) and D = 4 (halo, alltoall), each after
    two warm passes, in turns with the D = 1 engine (before and after);
    predictions and exit orders bitwise D = 1's on block_ell and fused,
    outside the margin on segment; halo_frac < 1 in the halo modes; no
    pack allocation in the measured pass; B1-B3 launched D times per step.
    Then one fused D = 4 alltoall pass under the profiler (device time of
    the exchange's kernels and copies against B2's, idle share). Offline:
    the whole graph at D = 2 alltoall on every backend, equal to the D = 1
    run and, killed after superstep 1 and resumed, to itself. Returns the
    phase's launches per kernel."""
    import shutil
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.gnn import NAIConfig
    from repro_torch.gnn.store import as_store
    from repro_torch.launch.full_graph_infer import (
        OfflineConfig, PreemptionSimulated, first_step_distance_quantile,
        run_full_graph_infer)
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import NAIServingEngine
    phase("sharded")
    t_phase = time.perf_counter()
    meshes = {D: make_serving_mesh(D, devices=(dev,) * D) for D in (2, 4)}
    print(f"{meshes[2]}, {meshes[4]}; torch.cuda.device_count() "
          f"{torch.cuda.device_count()}: the shards share one card (device "
          f"to device copies), so this phase measures the sharded path and "
          f"its exchange, not the capacity of several cards")
    reqs = requests[:SHARD_REQUESTS]
    near = near[:SHARD_REQUESTS]
    n_batches = -(-len(reqs) // nai.batch_size)
    zero_counts(kernels)                  # the phase's path starts here

    def engine(impl, mesh=None, gm="halo"):
        return NAIServingEngine(cfg, nai, heads, g,
                                device=None if mesh else dev,
                                mode="compiled", spmm_impl=impl,
                                pipeline_depth=2, max_wait_s=10.0,
                                mesh=mesh, gather_mode=gm)

    def warm(eng):
        # 2 batches a pass over 3 pool slots: after two passes every slot
        # holds the final bucket shapes, so the next pass is steady
        for _ in range(2):
            serve_requests(torch, eng, reqs)
        eng.reset_stats()
        return eng.pack_stats["allocs"]

    def line(eng, res, launches):
        summ = eng.stats.summary()
        t = list(eng.batch_timings)
        return (f"{len(reqs) / res[2]:.1f} req/s, p50 {summ['p50_ms']:.1f} "
                f"ms, p99 {summ['p99_ms']:.1f} ms, per batch host "
                f"{np.mean([b['host_s'] for b in t]) * 1e3:.1f} ms dispatch "
                f"{np.mean([b['dispatch_s'] for b in t]) * 1e3:.1f} ms sync "
                f"{np.mean([b['sync_s'] for b in t]) * 1e3:.1f} ms, "
                f"launches {launches}")

    for impl in ("fused", "block_ell", "segment"):
        base = engine(impl)
        warm(base)
        before = launch_counts(kernels)
        ref = serve_requests(torch, base, reqs)
        d1 = {n: k.launches - before[n] for n, k in kernels.items()}
        print(f"{impl} D=1: {line(base, ref, d1)}")
        for D, gm in SHARD_CONFIGS:
            eng = engine(impl, meshes[D], gm)
            allocs = warm(eng)
            before = launch_counts(kernels)
            res = serve_requests(torch, eng, reqs)
            launches = {n: k.launches - before[n] for n, k in kernels.items()}
            hs = eng.halo_stats
            print(f"{impl} D={D} {gm}: {line(eng, res, launches)}; "
                  f"halo_stats {hs}; exchange "
                  f"{hs['exchange_bytes_per_step'] / 1e6:.1f} MB per step "
                  f"(f32 rows between shards); pack allocations in the "
                  f"measured pass {eng.pack_stats['allocs'] - allocs}")
            tag = f"sharded {impl} D={D} {gm}"
            if impl == "segment":
                check(same_outside(res, ref, near),
                      f"{tag} == D=1 outside the margin")
            else:
                check(np.array_equal(res[0], ref[0])
                      and np.array_equal(res[1], ref[1]),
                      f"{tag}: predictions and exit orders bitwise D=1's")
            check(eng.pack_stats["allocs"] == allocs,
                  f"{tag}: no pack allocation in a steady pass")
            if gm != "dense":
                check(hs["halo_frac"] < 1.0, f"{tag}: halo_frac < 1")
            per_pass = n_batches * nai.t_max * D
            want = {"fused": {"nap_step_fused": per_pass},
                    "block_ell": {"spmm_block_ell": per_pass,
                                  "nap_exit": per_pass},
                    "segment": {}}[impl]
            check(all(launches[n] == want.get(n, 0)
                      for n in ("spmm_block_ell", "nap_step_fused",
                                "nap_exit")),
                  f"{tag}: B1-B3 launched D times per step ({want})")
            del eng
        again = serve_requests(torch, base, reqs)
        print(f"{impl} D=1 again: {len(reqs) / again[2]:.1f} req/s")
        if impl != "segment":
            check(np.array_equal(again[0], ref[0])
                  and np.array_equal(again[1], ref[1]),
                  f"{impl} D=1 repeats itself")
        del base
        gc.collect()

    # one traced fused D=4 alltoall pass
    eng = engine("fused", meshes[4], "alltoall")
    warm(eng)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = serve_requests(torch, eng, reqs)
    busy, idle, by_name = device_spans(prof, wall)
    b2 = sum(v for k, v in by_name.items() if "nap_step" in k)
    # the exchange's work, by kernel name: block gathers (indexing),
    # concatenations and device-to-device copies (a few small ones of the
    # loop itself, the live flag's stack and the un-permutation, count too)
    xch = {k: v for k, v in by_name.items()
           if any(w in k for w in ("gather", "index", "CatArray", "DtoD"))}
    h2d = sum(v for k, v in by_name.items() if "HtoD" in k)
    print(f"traced fused D=4 alltoall pass ({n_batches} batches): busy "
          f"{busy:.2f} ms of {1e3 * wall:.1f} ms wall (idle share "
          f"{idle:.3f}); B2 {b2:.3f} ms; exchange (gathers, "
          f"concatenations, DtoD copies) {sum(xch.values()):.3f} ms; "
          f"Memcpy HtoD {h2d:.2f} ms; device time by kernel:")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {v:8.3f} ms  {'[exchange] ' if k in xch else ''}"
              f"{k[:110]}")
    del eng, prof
    gc.collect()

    # offline: the whole graph at D = 2 alltoall against D = 1
    store = as_store(g)
    t_s = first_step_distance_quantile(store, cfg.r, 0.5)
    onai = NAIConfig(t_s=t_s, t_min=1, t_max=3)
    fnear = _full_graph_near(torch, store, cfg.r, t_s, 1, 3)
    tmp = Path(tempfile.mkdtemp(dir=REPO / "build"))

    def run(impl, ck, mesh=None, **kw):
        return run_full_graph_infer(store, cfg, heads, onai, OfflineConfig(
            ckpt_dir=str(tmp / ck), spmm_impl=impl, device=str(dev),
            gather_mode="alltoall", watchdog_s=10.0, **kw), mesh=mesh)

    def equal(a, b, impl):
        keep = ~fnear if impl == "segment" else np.ones(store.n, bool)
        return (np.array_equal(a.predictions[keep], b.predictions[keep])
                and np.array_equal(a.exit_orders[keep],
                                   b.exit_orders[keep]))

    try:
        for impl in ("block_ell", "fused", "segment"):
            one = run(impl, f"{impl}-1")
            two = run(impl, f"{impl}-2", meshes[2])
            check(equal(two, one, impl), f"offline {impl} D=2 alltoall == "
                  f"D=1 ({'outside the margin' if impl == 'segment' else 'bitwise'})")
            try:
                run(impl, f"{impl}-k", meshes[2], crash_after=1)
                check(False, "offline D=2: crash_after=1 preempted the run")
            except PreemptionSimulated:
                pass
            res = run(impl, f"{impl}-k", meshes[2])
            check(res.stats["resumed_from"] == 1 and equal(res, two, impl),
                  f"offline {impl} D=2: killed after superstep 1 and "
                  f"resumed == uninterrupted")
            print(f"offline {impl} D=1: {offline_times(one.stats)}")
            print(f"offline {impl} D=2 alltoall: "
                  f"{offline_times(two.stats)}; resumed: "
                  f"{offline_times(res.stats)}")
    finally:
        shutil.rmtree(tmp)
    launches = launch_counts(kernels)
    print(f"sharded phase launches {launches}")
    print(f"sharded phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def offline_phase(torch, dev, kernels, g, cfg, heads, scale_path, tmp):
    """Checkpointed full-graph inference (`run_full_graph_infer`) over the
    whole pubmed-like graph on block_ell, fused and segment (T_s the
    median first-step distance, T_max 3): each equal to the port's
    serving path (`make_compiled_infer`) on the same pack, a run killed
    after superstep 1 and resumed equal to the uninterrupted one (bitwise
    on the tile backends, outside the margin on segment), a corrupted
    step falling back one superstep; then the scale phase's 1e6-node
    store on segment, one run with its times and the tile bytes the tile
    backends would need."""
    import shutil
    from repro_torch.gnn import GNNConfig, MmapStore, NAIConfig
    from repro_torch.gnn import init_classifiers
    from repro_torch.gnn.backends import pack_operands
    from repro_torch.gnn.distributed import pack_graph
    from repro_torch.gnn.nai import make_compiled_infer
    from repro_torch.gnn.packing import batch_bucket, step_active_blocks
    from repro_torch.gnn.store import as_store
    from repro_torch.kernels.spmm import CB, RB
    from repro_torch.launch.full_graph_infer import (
        OfflineConfig, PreemptionSimulated, first_step_distance_quantile,
        run_full_graph_infer)
    phase("offline")
    t_phase = time.perf_counter()
    store = as_store(g)
    t_s = first_step_distance_quantile(store, cfg.r, 0.5)
    nai = NAIConfig(t_s=t_s, t_min=1, t_max=3)
    near = _full_graph_near(torch, store, cfg.r, t_s, nai.t_min, nai.t_max)
    check(near.mean() <= MAX_NEAR_SHARE, f"offline: {near.sum()} nodes "
          f"within the threshold margin")
    print(f"{g.name}: all {store.n} nodes; T_s {t_s:.6f} (median "
          f"first-step distance); {nai}; nodes within the margin "
          f"{int(near.sum())}")

    def run(impl, ck, **kw):
        return run_full_graph_infer(store, cfg, heads, nai, OfflineConfig(
            ckpt_dir=str(Path(tmp) / ck), spmm_impl=impl, device=str(dev),
            watchdog_s=10.0, **kw))

    def equal(a, b, impl):
        pa, oa = a
        pb, ob = b
        keep = ~near if impl == "segment" else np.ones(len(pa), bool)
        return (np.array_equal(pa[keep], pb[keep])
                and np.array_equal(oa[keep], ob[keep]))

    times = offline_times

    results = {}
    for impl in ("block_ell", "fused", "segment"):
        zero_counts(kernels)
        res = run(impl, f"off-{impl}")
        launches = launch_counts(kernels)
        results[impl] = res
        st = res.stats
        print(f"offline {impl}: {times(st)}; exit histogram "
              f"{st['exit_histogram']}; launches {launches}")
        if impl == "fused":
            check(launches["nap_step_fused"] == nai.t_max,
                  "offline fused launched B2 once per superstep")
        elif impl == "block_ell":
            check(launches["spmm_block_ell"] == nai.t_max
                  and launches["nap_exit"] == nai.t_max,
                  "offline block_ell launched B1 and B3 once per superstep")
        else:
            check(all(v == 0 for v in launches.values()),
                  "offline segment launched no block-ELL kernel")
        be, packed = pack_graph(store, 1, cfg.r, impl, stationary=True)
        sa = (step_active_blocks(packed.hop_rb, nai.t_max)
              if be.uses_tiles else None)
        oracle = make_compiled_infer(cfg, nai, spmm_impl=impl, device=dev)
        preds, eo = oracle(heads, pack_operands(be, packed, sa),
                           torch.from_numpy(packed.x0),
                           torch.from_numpy(packed.x_inf))
        want = (preds.cpu().numpy()[:store.n], eo.cpu().numpy()[:store.n])
        del oracle, packed, preds, eo
        got = (res.predictions, res.exit_orders)
        check(equal(got, want, impl), f"offline {impl} == make_compiled_"
              f"infer on the same pack ({'outside the margin' if impl == 'segment' else 'bitwise'})")
        ck = f"off-{impl}-kill"
        try:
            run(impl, ck, crash_after=1)
            check(False, "offline: crash_after=1 preempted the run")
        except PreemptionSimulated:
            pass
        res2 = run(impl, ck)
        check(res2.stats["resumed_from"] == 1
              and res2.stats["supersteps_run"] == nai.t_max - 1
              and equal((res2.predictions, res2.exit_orders), got, impl),
              f"offline {impl}: killed after superstep 1 and resumed == "
              f"uninterrupted")
        print(f"offline {impl}: == make_compiled_infer; killed after "
              f"superstep 1 and resumed == uninterrupted ("
              f"{times(res2.stats)})")
        shutil.rmtree(Path(tmp) / ck)
    # a flipped byte in the newest step: resume falls back one superstep
    ck = Path(tmp) / "off-corrupt"
    try:
        run("fused", ck.name, crash_after=2)
        check(False, "offline: crash_after=2 preempted the run")
    except PreemptionSimulated:
        pass
    x_npy = ck / "step_00002" / "x.npy"
    with open(x_npy, "r+b") as fh:
        fh.seek(x_npy.stat().st_size // 2)
        byte = fh.read(1)[0]
        fh.seek(-1, 1)
        fh.write(bytes([byte ^ 0x01]))
    res3 = run("fused", ck.name)
    st = res3.stats
    check(st["resumed_from"] == 1 and st["corrupt_steps"] == 1
          and equal((res3.predictions, res3.exit_orders),
                    (results["fused"].predictions,
                     results["fused"].exit_orders), "fused"),
          "offline: a corrupted step falls back one superstep")
    print(f"offline fused, a flipped byte in step 2's x.npy: resumed from "
          f"superstep {st['resumed_from']} ({st['fallbacks'][0]['error'][:60]}"
          f"...), equal to the uninterrupted run")
    for impl in results:
        shutil.rmtree(Path(tmp) / f"off-{impl}")
    shutil.rmtree(ck)

    # the 1e6-node store on segment
    ms = MmapStore(scale_path)
    src, dst = ms.coo()
    n_cb = -(-ms.n // CB)
    pairs = np.unique((dst.astype(np.int64) // RB) * n_cb + src // CB)
    per_rb = np.bincount(pairs // n_cb)
    n_rb = -(-batch_bucket(ms.n) // CB) * CB // RB
    padded = n_rb * int(per_rb.max()) * RB * CB * 4
    card = (torch.cuda.get_device_properties(dev).total_memory
            if dev.type == "cuda" else 0)
    print(f"{ms!r}: block-ELL tiles of the whole graph {len(pairs)} "
          f"({len(pairs) * RB * CB * 4} bytes of valid 8x128 f32 tiles; "
          f"{padded} bytes padded to the widest row block's "
          f"{int(per_rb.max())} slots, against the card's {card} bytes: "
          f"the tile operands {'fit' if padded < card else 'do not fit'});"
          f" segment runs it")
    del src, dst, pairs, per_rb
    cfg_s = GNNConfig("sgc", ms.feat_dim, ms.num_classes, k=2, hidden=32,
                      mlp_layers=2)
    nai_s = NAIConfig(t_s=6.0, t_min=1, t_max=2)
    heads_s = init_classifiers(cfg_s, torch.Generator().manual_seed(0),
                               device=dev)
    zero_counts(kernels)
    res = run_full_graph_infer(ms, cfg_s, heads_s, nai_s, OfflineConfig(
        ckpt_dir=str(Path(tmp) / "off-1e6"), spmm_impl="segment",
        device=str(dev), watchdog_s=60.0))
    st = res.stats
    check(len(res.predictions) == ms.n
          and 0 <= res.predictions.min()
          and res.predictions.max() < ms.num_classes
          and set(np.unique(res.exit_orders)) <= {1, 2},
          "offline 1e6: a class and an exit order for every node")
    print(f"offline 1e6 nodes, segment: {times(st)}; exit histogram "
          f"{st['exit_histogram']}; nb_pad {st['nb_pad']}")
    ms.close()
    shutil.rmtree(Path(tmp) / "off-1e6")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"offline phase {time.perf_counter() - t_phase:.1f} s")


def frontend_phase(torch, dev, kernels, g, cfg, nai, heads, closed_rps):
    """The SLO front-end at the full pubmed-like size with
    `default_slo_classes` (gold at T_max 3, best_effort at T_max 1) on
    `fused`: a virtual-clock replay of a bursty stream (each class's
    outcomes equal to direct per-class engines', pipelined equal to
    serial, no pack allocation in the steady pass); a wall-clock open
    loop at about 0.5x and 2x the serve phase's closed-loop fused req/s
    (`closed_rps`), with per-class goodput, shed, p50 and p99 and
    conservation; and a breaker trip: a `device` fault plan on gold
    demotes it to best_effort, and the breaker closes after its
    cooldown."""
    from collections import defaultdict
    from repro_torch.serving import (BreakerConfig, EngineConfig, FaultPlan,
                                     FaultSpec, NAIServingEngine,
                                     ServingFrontend, default_slo_classes)
    phase("frontend")
    t_phase = time.perf_counter()
    classes = default_slo_classes(nai)
    print("classes: " + "; ".join(
        f"{c.name} T_max {c.nai.t_max} deadline {c.deadline_s} s max_wait "
        f"{c.max_wait_s} s queue {c.queue_depth}" for c in classes))
    rng = np.random.default_rng(23)
    events, t = [], 0.0
    for _ in range(3):        # a burst, then a quiet gap
        for nid in rng.choice(g.test_idx, size=int(rng.integers(
                nai.batch_size // 2, 2 * nai.batch_size + 1))):
            events.append((t, "gold" if rng.random() < 0.5
                           else "best_effort", int(nid)))
            t += 1e-4
        t += 1.0

    def frontend(depth, **kw):
        return ServingFrontend(cfg, heads, g, kw.pop("classes", classes),
                               device=dev, mode="compiled",
                               spmm_impl="fused", pipeline_depth=depth, **kw)

    def replay(fe):
        reqs = []
        for t, cls, nid in events:
            reqs.append(fe.submit(nid, cls, now=t))
            fe.step(now=t)
        fe.step(now=events[-1][0] + 100.0)
        fe.flush(now=events[-1][0] + 100.0)
        check(all(r is not None and r.status == "completed" for r in reqs),
              "frontend replay: every request accepted and completed")
        return reqs

    zero_counts(kernels)
    serial = frontend(1)
    t0 = time.perf_counter()
    ref = replay(serial)
    serial_s = time.perf_counter() - t0
    serial.close()
    fe = frontend(2)
    allocs = []
    # three warm passes, then the steady one (an H100 run's fourth pass
    # allocated nothing, the pass that a fifth then repeated)
    for i in range(4):
        fe.reset_stats()      # batch ids count from 0 again
        a0 = {n: e.pack_stats["allocs"] for n, e in fe.engines.items()}
        t0 = time.perf_counter()
        reqs = replay(fe)
        piped_s = time.perf_counter() - t0
        allocs.append({n: e.pack_stats["allocs"] - a0[n]
                       for n, e in fe.engines.items()})
    check(all(v == 0 for v in allocs[-1].values()),
          f"frontend: zero pack allocations in the steady pass ({allocs})")
    check([(r.node_id, r.slo_class, r.batch_id, r.prediction, r.exit_order)
           for r in reqs] ==
          [(r.node_id, r.slo_class, r.batch_id, r.prediction, r.exit_order)
           for r in ref], "frontend: pipelined == serial")
    groups = defaultdict(list)
    for r in reqs:
        groups[r.slo_class, r.batch_id].append(r)
    for c in classes:
        eng = NAIServingEngine(cfg, c.nai, heads, g, device=dev,
                               mode="compiled", spmm_impl="fused",
                               max_wait_s=10.0)
        for key in sorted(k for k in groups if k[0] == c.name):
            eng.submit([r.node_id for r in groups[key]])
            got = eng.step()
            check([(r.node_id, r.prediction, r.exit_order) for r in got] ==
                  [(r.node_id, r.prediction, r.exit_order)
                   for r in groups[key]],
                  f"frontend: {key} == a direct {c.name} engine")
        del eng
    n_b = {c.name: len([k for k in groups if k[0] == c.name])
           for c in classes}
    print(f"virtual clock: {len(events)} requests in 3 bursts, batches "
          f"{n_b}; serial {serial_s:.2f} s, pipelined steady pass "
          f"{piped_s:.2f} s; pack allocations per pass {allocs}; "
          f"pipelined == serial == direct engines; best_effort exit "
          f"orders {sorted({r.exit_order for r in reqs if r.slo_class == 'best_effort'})}")

    for load in (0.5, 2.0):
        rate = load * closed_rps
        n_req = int(rate * 3.0)
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_req))
        nodes = rng.choice(g.test_idx, size=n_req)
        kinds = np.where(rng.random(n_req) < 0.5, "gold", "best_effort")
        fe.reset_stats()
        accepted, terminal = [], []
        t0 = time.perf_counter()
        i = 0
        while i < n_req:
            now = time.perf_counter() - t0
            while i < n_req and arrivals[i] <= now:
                r = fe.submit(int(nodes[i]), str(kinds[i]))
                if r is not None:
                    accepted.append(r)
                i += 1
            terminal += fe.step()
        terminal += fe.flush()
        wall = time.perf_counter() - t0
        ids = [id(r) for r in terminal]
        check(len(ids) == len(set(ids))
              and set(ids) == {id(r) for r in accepted}
              and fe.pending() == 0,
              f"frontend open loop {load}x: every accepted request ended "
              f"exactly once")
        summ = fe.summary()
        for name, s in summ.items():
            check(s["offered"] == s["rejected"] + s["completed"]
                  + s["failed"], f"frontend open loop {load}x: {name} "
                  f"offered == shed + completed + failed")
        print(f"open loop {load}x ({rate:.1f} req/s offered, {n_req} "
              f"requests over {arrivals[-1]:.2f} s, drained in {wall:.2f} "
              f"s): " + "; ".join(
                  f"{n} offered {s['offered']} shed {s['rejected']} "
                  f"completed {s['completed']} goodput {s['deadline_hits']} "
                  f"({s['deadline_hits'] / wall:.1f}/s, "
                  f"{s['goodput_frac']:.3f}) p50 {s['p50_ms']:.1f} ms p99 "
                  f"{s['p99_ms']:.1f} ms batches {s['batches']}"
                  for n, s in summ.items()))
    fe.close()
    del fe, serial

    gold, best = classes
    faulty = (dataclasses.replace(gold, max_wait_s=0.001, engine=EngineConfig(
        mode="compiled", spmm_impl="fused", faults=FaultPlan(
            [FaultSpec("device", at=(0, 1, 2))], seed=3))),
        dataclasses.replace(best, max_wait_s=0.001))
    br = BreakerConfig(window=8, trip_frac=0.5, min_events=8,
                       cooldown_s=0.05, probes=1, count_misses=False)
    fe = frontend(1, classes=faulty, breaker=br)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 60.0:
        for nid in rng.choice(g.test_idx, size=8):
            fe.submit(int(nid), "gold")
        guard = time.perf_counter() + 5.0
        while fe.pending() and time.perf_counter() < guard:
            fe.step()
        if fe.breakers["gold"].state == "closed" and \
                fe.stats["gold"].degraded:
            break
        time.sleep(0.01)
    fe.flush()
    st, brk = fe.stats["gold"], fe.breakers["gold"]
    check(brk.trips >= 1 and st.degraded > 0 and brk.state == "closed"
          and st.offered == st.accepted + st.rejected
          and st.accepted == st.completed + st.failed
          and fe.pending() == 0,
          f"frontend breaker: gold tripped, demoted, closed again ({st}, "
          f"{brk.transitions})")
    print(f"breaker: gold {st}; transitions "
          + ", ".join(f"{a}->{b} at {t - brk.transitions[0][0]:.3f} s"
                      for t, a, b in brk.transitions)
          + f"; {time.perf_counter() - t0:.2f} s")
    fe.close()
    del fe
    launches = launch_counts(kernels)
    print(f"frontend phase launches {launches}")
    check(launches["nap_step_fused"] > 0, "the frontend phase launched B2")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"frontend phase {time.perf_counter() - t_phase:.1f} s")


def train_phase(torch, dev, kernels, g, cfg, nai, requests, dist):
    """Inception Distillation on the card at the serve phase's size, then
    the trained heads served (the serve phase's requests and batching, so
    its decision distances `dist` give every margin): (a) the card's
    `_fit` against the CPU's from the same heads, (b) `train_nai` with its
    stage times, (c) the trained heads through host mode, fused,
    block_ell and segment under the serve phase's gates, (d) accuracy,
    exit histogram, propagation MACs and fused req/s across T_s, (e) both
    GNN launchers at their defaults and the four Table 3 baselines."""
    from repro_torch.core.inception_distill import hard_ce
    from repro_torch.gnn import (DistillConfig, evaluate_classifier,
                                 infer_all, init_classifiers,
                                 order_distribution, train_nai)
    from repro_torch.gnn.baselines import (run_glnn, run_quantized,
                                           run_tinygnn, run_vanilla)
    from repro_torch.gnn.distill import _fit, _tc
    from repro_torch.gnn.graph import propagated_series
    from repro_torch.serving import NAIServingEngine

    phase("train")
    t_phase = time.perf_counter()
    dc = DistillConfig()
    fit_steps = 50
    labels = g.labels[requests]

    # ---------------------------------------------- (a) card against CPU
    series = np.stack(propagated_series(g.train_subgraph(), g.features,
                                        cfg.k, cfg.r))
    fv, y = series[:, g.train_idx], g.labels[g.train_idx]
    fit_cfg = dataclasses.replace(cfg, dropout=0.0)
    full = np.stack(propagated_series(g, g.features, cfg.k, cfg.r))
    runs = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        head = init_classifiers(fit_cfg, torch.Generator().manual_seed(0),
                                device=d).head(cfg.k)
        fd = torch.from_numpy(fv).to(d)
        yd = torch.from_numpy(y).long().to(d)
        hist = []

        def loss_fn(h, rng):
            loss = hard_ce(h(fd, generator=rng), yd)
            hist.append(loss.detach())
            return loss

        t0 = time.perf_counter()
        _fit(loss_fn, head, fit_steps, _tc(dc),
             torch.Generator(d).manual_seed(0))
        losses = np.array([float(v) for v in hist])
        secs = time.perf_counter() - t0
        with torch.inference_mode():
            pred = head(torch.from_numpy(full[:, g.test_idx]).to(d)
                        ).argmax(-1).cpu().numpy()
        runs[name] = (head, losses, secs, pred)
    (hc, lc, sc, pc), (hd, ld, sd, pd) = runs["cpu"], runs["card"]
    gap = float(np.max(np.abs(ld - lc) / np.abs(lc)))
    agree = float((pc == pd).mean())
    wgap = max(float((a.detach().cpu() - b.detach()).abs().max())
               for a, b in zip(hd.parameters(), hc.parameters()))
    print(f"(a) _fit, base loss, dropout 0, {fit_steps} steps from the same "
          f"heads: card {sd:.3f} s, CPU {sc:.3f} s; loss {ld[0]:.6g} -> "
          f"{ld[-1]:.6g}; largest relative loss gap {gap:.3g}; test "
          f"predictions equal {agree:.4f}; largest parameter gap {wgap:.3g}")
    check(gap <= 1e-3, f"card and CPU losses within 1e-3 relative ({gap})")
    check(agree >= 0.99, f"card and CPU heads agree on >= 99% ({agree})")
    # where a training step's time goes: 10 more base-loss steps, traced
    fd = torch.from_numpy(fv).to(dev)
    yd = torch.from_numpy(y).long().to(dev)
    step_profile(torch, lambda: _fit(
        lambda h, rng: hard_ce(h(fd, generator=rng), yd), hd, 10, _tc(dc),
        torch.Generator(dev).manual_seed(0)), "(a) train base step", n=1,
        per_call=10)
    del runs, hc, hd, fd, yd

    # -------------------------------------------- (b) training on the card
    timings = {}
    t0 = time.perf_counter()
    model, info = train_nai(cfg, g, dc, device=dev, timings=timings)
    t_train = time.perf_counter() - t0
    steps = {"base": dc.epochs_base,
             "offline": (cfg.k - 1) * dc.epochs_offline,
             "online": dc.epochs_online}
    print(f"(b) train_nai on {dev}: {t_train:.2f} s; host series and copy "
          f"{timings['series']:.3f} s; " + "; ".join(
              f"{k} {steps[k]} steps {timings[k]:.3f} s "
              f"({steps[k] / timings[k]:.1f} steps/s)" for k in steps))
    print(f"(b) info {info}")
    accs = {l: evaluate_classifier(cfg, model, full, g.labels, g.test_idx, l)
            for l in range(1, cfg.k + 1)}
    print(f"(b) test accuracy per order (the full graph's series, "
          f"{len(g.test_idx)} test nodes): {accs}")
    check(all(np.isfinite(v) for v in info.values()), "finite losses")
    check(all(a > 1.5 / cfg.num_classes for a in accs.values()),
          f"every order above 1.5/C ({accs})")
    del full

    # ----------------------------------------- (c) serving trained heads
    near = within_margin(dist, nai.t_s)
    check(near.mean() <= MAX_NEAR_SHARE, f"{near.sum()} requests within "
          f"the threshold margin")
    host = NAIServingEngine(cfg, nai, model, g, device=dev, mode="host",
                            max_wait_s=10.0)
    hp, ho, h_wall = serve_requests(torch, host, requests)
    print(f"(c) host: {len(requests) / h_wall:.1f} req/s, accuracy "
          f"{(hp == labels).mean():.4f}, exit histogram "
          f"{dict(sorted(host.stats.exit_hist.items()))}")
    res = {}
    for impl in ("fused", "block_ell", "segment"):
        eng = NAIServingEngine(cfg, nai, model, g, device=dev,
                               mode="compiled", spmm_impl=impl,
                               pipeline_depth=2, max_wait_s=10.0)
        serve_requests(torch, eng, requests)          # sizes the pool
        eng.reset_stats()
        zero_counts(kernels)                     # a main path starts here
        res[impl] = serve_requests(torch, eng, requests)
        counts = launch_counts(kernels)
        pr, od, wall = res[impl]
        print(f"(c) {impl}: {len(requests) / wall:.1f} req/s, accuracy "
              f"{(pr == labels).mean():.4f}, exit histogram "
              f"{dict(sorted(eng.stats.exit_hist.items()))}, launches "
              f"{counts}")
        check(same_outside((pr, od), (hp, ho), near),
              f"{impl} on trained heads matches the host path outside the "
              f"margin")
        if impl == "fused":
            check(counts["nap_step_fused"] > 0, "fused launched B2")
        elif impl == "block_ell":
            check(counts["spmm_block_ell"] > 0 and counts["nap_exit"] > 0,
                  "block_ell launched B1 and B3")
        del eng
    check(np.array_equal(res["fused"][0], res["block_ell"][0])
          and np.array_equal(res["fused"][1], res["block_ell"][1]),
          "fused and block_ell give identical predictions and exit orders "
          "on trained heads")
    print(f"(c) requests within the threshold margin: {int(near.sum())}")
    del host, res
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------- (d) the trade-off
    d1 = dist[:, 0]
    sweep = [0.0, float(np.percentile(d1, 25)), float(np.percentile(d1, 75)),
             float(d1.max()) * 1.001 + 1e-3]
    print(f"(d) T_s sweep {[round(t, 4) for t in sweep]} (T_min "
          f"{nai.t_min}, T_max {nai.t_max}; order-1 distances "
          f"{d1.min():.4f} .. {d1.max():.4f})")
    # fused req/s of every T_s in one timed pass after the pass that sizes
    # its pool (three rounds of it spread by up to 50% on H100 hosts: the
    # req/s is the host's, and gates nothing); that pass's predictions are
    # held to the host path's
    for t_s in sweep:
        eng = NAIServingEngine(
            cfg, dataclasses.replace(nai, t_s=t_s), model, g, device=dev,
            mode="compiled", spmm_impl="fused", pipeline_depth=2,
            max_wait_s=10.0)
        serve_requests(torch, eng, requests)          # sizes the pool
        fp, fo, wall = serve_requests(torch, eng, requests)
        del eng
        r = infer_all(cfg, dataclasses.replace(nai, t_s=t_s), model, g,
                      nodes=requests)
        near_t = within_margin(dist, t_s)
        print(f"(d) T_s {t_s:.4f}: accuracy "
              f"{(r.predictions == labels).mean():.4f}, exit histogram "
              f"{order_distribution(r, nai.t_max).tolist()}, host "
              f"propagation MACs/node {r.macs['propagation']:.1f} (feature "
              f"processing {r.fp_macs:.1f}), fused "
              f"{len(requests) / wall:.1f} req/s, within the margin "
              f"{int(near_t.sum())}")
        check(near_t.mean() <= MAX_NEAR_SHARE
              and same_outside((fp, fo), (r.predictions, r.orders), near_t),
              f"fused matches the host path at T_s {t_s}")
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------ (e) entry points and baselines
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    expect = {"serve": ("[serve-gnn] served=", "p50=", "exit histogram"),
              "train": ("[train-gnn] done in", "NAI acc=")}
    t0 = time.perf_counter()
    procs = {m: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.launch.{m}", "--gnn",
         "pubmed-like"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for m in expect}
    try:
        outs = {m: p.communicate(timeout=300) for m, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for m, (out, err) in outs.items():
        for line in out.splitlines():
            print(f"(e) {m}: {line}")
        check(procs[m].returncode == 0
              and all(e in out for e in expect[m]),
              f"launch.{m} --gnn pubmed-like exits 0 and prints its lines "
              f"(exit {procs[m].returncode}; {err[-1500:]})")
    print(f"(e) both launchers, side by side: "
          f"{time.perf_counter() - t0:.1f} s")
    base = {"glnn": lambda: run_glnn(cfg, g, model.head(cfg.k)),
            "tinygnn": lambda: run_tinygnn(cfg, g, model.head(cfg.k)),
            "quantized": lambda: run_quantized(cfg, g, model),
            "vanilla": lambda: run_vanilla(cfg, g, model)}
    for name, run in base.items():
        t0 = time.perf_counter()
        r = run()
        print(f"(e) {name}: acc {r.acc:.4f}, MACs/node {r.macs:.1f} "
              f"(feature processing {r.fp_macs:.1f}), inference "
              f"{r.time_s:.4f} s (feature processing {r.fp_time_s:.4f} s); "
              f"{time.perf_counter() - t0:.1f} s in all")
        check(np.isfinite(r.acc) and r.macs > 0, f"{name} ran")
    print(f"train phase {time.perf_counter() - t_phase:.1f} s")


def step_profile(torch, step, label, n=1, per_call=1):
    """Where one step's time goes: the profiler over `n` calls of `step`,
    each of `per_call` steps, after an untraced call, host time per step
    against device busy time, and the ops that cost the host most."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in ev)
    n_launch = sum(e.count for e in ev if e.self_device_time_total > 0)
    top = sorted(ev, key=lambda e: -e.self_cpu_time_total)[:6]
    n *= per_call
    print(f"{label} profile (traced, {n} step{'s' * (n > 1)}): "
          f"{wall / n * 1e3:.1f} "
          f"ms wall per step, device busy {dev_us / n / 1e3:.2f} ms per step,"
          f" ~{n_launch // n} device ops per step; most host time: "
          + ", ".join(f"{e.key} {e.self_cpu_time_total / n / 1e3:.2f} ms"
                      for e in top))


def band_pairs(S: int, window: int) -> int:
    """(query, key) pairs inside the causal band of `window` keys."""
    q = np.arange(S)
    return int(np.minimum(q + 1, window if window > 0 else S).sum())


def condition_weights(torch, cfg, model, generator) -> None:
    """Three changes to the reference's random initialization, so that the
    checks below can see what they test. It leaves the rwkv token-shift
    mixes mu_* at 0, under which the prefill cache's `x_t` is never read:
    draw them from U(0, 1). It takes the fan-in of the (d, heads, hd)
    attention projections from the heads axis, so random q.k logits run
    into the thousands and the softmax is a hard max whose winner
    rounding flips: scale wq, wk, wv of every self-attention (`local`,
    `attn`, `attn_moe`, `encdec`, the encoder's `enc`) and cross-attention
    (`xattn`, `encdec`) to a fan-in of d (by a power of two at rwkv6-3b's,
    recurrentgemma-9b's and whisper-small's widths, exact in bf16; by
    2^-3.5 and 768^-0.5 at dbrx-132b's and grok-1-314b's, and 2^-3.5 and
    2^-4.5 at llama-3.2-vision-11b's, rounded to bf16). It sets the
    `xattn` gates to 0, where tanh(0) = 0 switches llama-3.2-vision's
    cross-attention layers off entirely: set them to 1 (tanh 0.76)."""
    def soften(p):
        p["wq"].mul_((cfg.num_heads / cfg.d_model) ** 0.5)
        for w in ("wk", "wv"):
            p[w].mul_((cfg.num_kv_heads / cfg.d_model) ** 0.5)

    with torch.no_grad():
        for p, kind in zip(model.layers, cfg.layer_kinds):
            for name, w in p.named_parameters():
                if name.rsplit(".", 1)[-1].startswith("mu_"):
                    w.uniform_(0.0, 1.0, generator=generator)
            if kind in ("local", "attn", "attn_moe", "encdec"):
                soften(p["attn"])
            if kind in ("xattn", "encdec"):
                soften(p["xattn"])
            if kind == "xattn":
                p["gate_attn"].fill_(1.0)
                p["gate_mlp"].fill_(1.0)
        for p in model.encoder:
            soften(p["attn"])


def depth_logits(torch, cfg, model, toks, depths):
    """The last position's logits (final norm and head applied) after the
    first L layers, for each L in `depths`: where rounding grows."""
    from repro_torch.models import decoder_lm as M
    from repro_torch.nn import blocks as TB
    from repro_torch.nn.basic import apply_norm
    pos = torch.arange(toks.shape[1], device=toks.device)[None].expand(
        toks.shape)
    out = {}
    with torch.no_grad():
        x = M._embed_tokens(cfg, model, toks)
        for i, (p, kind) in enumerate(zip(model.layers, cfg.layer_kinds), 1):
            x, _, _ = TB.apply_layer(cfg, kind, p, x, positions=pos)
            if i in depths:
                h = apply_norm(cfg, model["final_norm"], x[:, -1:])
                out[i] = M._project_logits(cfg, model, h)[:, 0].float()
    return out


def wkv_sequential_check(torch, rf, kf, vf, lw, u, B=2, H=2, T=64):
    """B5 on the first T steps of B batch rows and H heads of real (B, T,
    H, hd) operands against `ref_wkv6_sequential`, the per-step recurrence
    in f64 (not the chunked factorization that B5 and its plain version
    share), within rtol 1e-4 and atol 1e-5 of the largest |value| (f32
    chunked sums against the exact recurrence)."""
    from repro_torch.kernels.wkv6 import ref_wkv6_sequential, wkv6_heads
    ops = [a[:B, :T, :H].contiguous() for a in (rf, kf, vf, lw)]
    hd = ops[0].shape[-1]
    out, _ = wkv6_heads(*ops, u[:H].contiguous())
    want = ref_wkv6_sequential(
        *(a.transpose(1, 2).reshape(B * H, T, hd) for a in ops),
        u[:H].repeat(B, 1)).reshape(B, H, T, hd).transpose(1, 2)
    torch.cuda.synchronize()
    err = float((out - want).abs().max())
    scale = float(want.abs().max())
    check(torch.allclose(out, want, rtol=1e-4, atol=1e-5 * scale),
          f"wkv6 vs ref_wkv6_sequential (f64 per-step recurrence; rtol "
          f"1e-4, atol 1e-5 of the largest |value| {scale}), max abs err "
          f"{err}")
    print(f"wkv6 against the f64 per-step recurrence: {B} x {H} heads x {T} "
          f"steps, hd {hd}; max abs err {err:.3g} of values up to "
          f"{scale:.3g}")


def wkv_check(torch, rf, kf, vf, lw, u, label):
    """B5 on real (B, T, H, hd) operands against its plain version, timed
    beside it. Returns the kernel's row (name, source, error, timings,
    bound)."""
    from repro_torch.kernels.wkv6 import ref_wkv6, wkv6_heads
    B_, T, H, hd = rf.shape
    # the kernel reads the model's (B, T, H, hd) layout as the prefill
    # hands it over; the plain version takes (B*H, T, hd)
    flat = [a.transpose(1, 2).reshape(B_ * H, T, hd).contiguous()
            for a in (rf, kf, vf, lw)]
    uf = u[None].expand(B_, H, hd).reshape(B_ * H, hd).contiguous()
    args = (*flat, uf)
    out, state = wkv6_heads(rf, kf, vf, lw, u)
    ref_out, ref_state = ref_wkv6(*args)
    torch.cuda.synchronize()
    ref_out = ref_out.reshape(B_, H, T, hd).transpose(1, 2)
    ref_state = ref_state.reshape(B_, H, hd, hd)
    err = float(max((out - ref_out).abs().max(),
                    (state - ref_state).abs().max()))
    scale = float(max(ref_out.abs().max(), ref_state.abs().max()))
    # tolerance: 1e-5 of the largest value (f32 chunked factorization,
    # another summation order)
    check(torch.allclose(out, ref_out, rtol=1e-4, atol=1e-5 * scale)
          and torch.allclose(state, ref_state, rtol=1e-4,
                             atol=1e-5 * scale),
          f"{label} vs plain, max abs err {err} (values up to {scale})")
    n_el = B_ * H * T * hd
    C = 16
    flops = (B_ * H * (T // C)
             * (4 * C * C * hd + 4 * C * hd * hd + 10 * C * hd))
    nbytes = 5 * n_el * 4 + B_ * H * hd * 4 + B_ * H * hd * hd * 4
    row = dict(name="wkv6", source="src/repro_torch/csrc/wkv6.cu",
               replaces="src/repro/kernels/wkv6/kernel.py:60",
               max_abs_err=err,
               **timings(torch, lambda: wkv6_heads(rf, kf, vf, lw, u),
                         lambda: ref_wkv6(*args), plain_reps=5),
               bound=bound(nbytes, flops))
    ms, by = row["bound"]
    print(f"{label} operands: BH {B_ * H}, T {T}, hd {hd}; max abs err "
          f"{err:.3g} of values up to {scale:.3g}; kernel {row['ms']:.4f} "
          f"ms ({ms / row['ms']:.1%} of its bound {ms:.4f} ms, {by}), plain "
          f"{row['plain_ms']:.4f} ms")
    return row


def lm_phases(torch, dev, kernels, arch, layers, batch, seq, gate_seq,
              f32_rel, bf16_rel, smi_line):
    """The LM serving path of `arch` at full width, its depth cut to
    `layers`, bf16, random weights from a CUDA generator seeded 0
    (conditioned as `condition_weights` says): kernel check and timing on
    the first such layer's real operands, prefill (the counted main path)
    + greedy decode, the engine, then the end-to-end gates on prompts of
    `gate_seq` tokens. Returns the row of the path's kernel."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     ref_attention)
    from repro_torch.models import decoder_lm as M
    from repro_torch.nn import attention, rwkv
    from repro_torch.nn import blocks as TB
    from repro_torch.nn.basic import apply_norm
    from repro_torch.nn.params import count_params
    from repro_torch.serving import LMServingEngine

    phase(f"lm {arch}")
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(0)
    model = M.init_params(cfg, gen, device=dev)
    condition_weights(torch, cfg, model, gen)
    torch.cuda.synchronize()
    n_par = count_params(model)
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{arch}: {cfg.num_layers} of {full.num_layers} layers "
          f"(reduced depth) {cfg.layer_kinds[:3]}..., "
          f"d_model {cfg.d_model}, {n_par} parameters, {n_bytes} bytes "
          f"({cfg.param_dtype}), made in {time.perf_counter() - t0:.1f}s")
    prompts = torch.from_numpy(synthetic_lm_batch(
        np.random.default_rng(0), batch, max(seq, gate_seq + 1),
        cfg.vocab_size)["tokens"]).long().to(dev)
    toks = prompts[:, :seq]
    pos = torch.arange(seq, device=dev)[None].expand(batch, seq)

    # ---- the kernel on the first layer's real operands, at the path's shape
    with torch.no_grad():
        x = M._embed_tokens(cfg, model, toks)
        if "rwkv" in cfg.layer_kinds:
            kname = "wkv6"
            p = model.layers[0]
            rf, kf, vf, lw, u, _ = rwkv.wkv_inputs(
                cfg, p["tmix"], apply_norm(cfg, p["norm1"], x))
            row = wkv_check(torch, rf, kf, vf, lw, u, "wkv6")
            wkv_sequential_check(torch, rf, kf, vf, lw, u)
            del rf, kf, vf, lw
        else:
            kname = "flash_attention"
            i_loc = cfg.layer_kinds.index("local")
            for i in range(i_loc):
                x, _, _ = TB.apply_layer(cfg, cfg.layer_kinds[i],
                                         model.layers[i], x, positions=pos)
            p = model.layers[i_loc]
            q, k, v = (a.contiguous() for a in attention._project_qkv(
                cfg, p["attn"], apply_norm(cfg, p["norm1"], x), pos))
            W = cfg.sliding_window
            out = flash_attention(q, k, v, window=W)
            ref = ref_attention(q, k, v, window=W)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            # tolerance: the kernel rounds P to bf16 for the tensor cores
            # (2^-9 relative), and both round the output to bf16 (2^-8)
            check(torch.allclose(out.float(), ref.float(), rtol=1e-2,
                                 atol=1e-2),
                  f"flash_attention vs plain, max abs err {err}")
            B_, S_, H, hd = q.shape
            KV = k.shape[2]
            flops = 4 * B_ * H * band_pairs(S_, W) * hd
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            # q.k and p.v at the operands' type: bf16 on the tensor cores
            peak = (PEAK_BF16_FLOP_S if q.dtype == torch.bfloat16
                    else PEAK_F32_FLOP_S)
            band = torch.ones((S_, S_), dtype=torch.bool, device=dev).tril()
            band &= ~torch.ones_like(band).tril(-W)
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=band, enable_gqa=True)
            lib_err = float((library().transpose(1, 2).float()
                             - ref.float()).abs().max())
            # how soft the softmax is on these operands: the mean largest
            # probability of a query's row (1 for a hard max)
            lg = (q[0, :, 0].float() @ k[0, :, 0].float().T) / hd ** 0.5
            lg.masked_fill_(~band, float("-inf"))
            p_max = float(lg.softmax(-1).max(-1).values.mean())
            del lg
            print(f"flash_attention operands: B {B_}, S {S_}, {H} q heads, "
                  f"{KV} kv heads, hd {hd}, window {W}, {q.dtype}; band "
                  f"pairs per head {band_pairs(S_, W)}; mean largest "
                  f"probability per row (batch 0, head 0) {p_max:.3f}; max abs err {err:.3g} of values up to "
                  f"{float(ref.float().abs().max()):.3g}; library call's "
                  f"max abs err {lib_err:.3g}")
            row = dict(name=kname,
                       source="src/repro_torch/csrc/flash_attention.cu",
                       replaces="src/repro/kernels/flash_attention/"
                                "kernel.py:77",
                       max_abs_err=err,
                       **timings(torch,
                                 lambda: flash_attention(q, k, v, window=W),
                                 lambda: ref_attention(q, k, v, window=W),
                                 library, plain_reps=5),
                       bound=bound(nbytes, flops, peak))
            print(f"flash_attention kernel {row['ms']:.4f} ms: "
                  f"{flops / row['ms'] / 1e9:.1f} TFLOP/s, "
                  f"{row['bound'][0] / row['ms']:.1%} of its bound; library "
                  f"call {row['library_ms']:.4f} ms "
                  f"({flops / row['library_ms'] / 1e9:.1f} TFLOP/s)")
            del q, k, v, out, ref, band, qt, kt, vt
        del x
    torch.cuda.empty_cache()

    # ---- the main path: prefill, then greedy decode from its cache
    n_kind = sum(kind in ("rwkv", "local") for kind in cfg.layer_kinds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    t0 = time.perf_counter()
    last, cache = M.prefill_step(cfg, model, toks)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    tok = last.argmax(-1, keepdim=True)
    n_dec = 32
    t0 = time.perf_counter()
    for t in range(seq, seq + n_dec):
        logits, cache = M.decode_step(cfg, model, cache, tok, t)
        tok = logits[:, 0].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = launch_counts(kernels)
    row["launches"] = launches[kname]
    row["note"] = f"in one {arch} prefill of {batch} x {seq} tokens"
    peak = torch.cuda.max_memory_allocated()
    check(launches[kname] == n_kind and all(
        v == 0 for n, v in launches.items() if n != kname),
        f"{arch} prefill launched {kname} once per layer ({launches})")
    check(bool(torch.isfinite(last).all()) and last.shape == (
        batch, cfg.vocab_size), f"{arch} prefill logits finite, shaped")
    rates = dict(prefill=batch * seq / t_prefill,
                 decode=batch * n_dec / t_decode)
    print(f"{arch} prefill {batch} x {seq}: {t_prefill:.3f} s, "
          f"{rates['prefill']:.1f} tokens/s; {kname} launches "
          f"{launches[kname]} (band active: "
          f"{0 < cfg.sliding_window < seq})")
    print(f"{arch} decode {n_dec} tokens x {batch}: {t_decode:.3f} s, "
          f"{rates['decode']:.1f} tokens/s ({1e3 * t_decode / n_dec:.2f} "
          f"ms per step); peak memory {peak} bytes")
    step_profile(torch, lambda: M.decode_step(cfg, model, cache, tok,
                                              seq + n_dec), f"{arch} decode")
    del cache, logits
    torch.cuda.empty_cache()

    # ---- the engine: 8 requests, 4 slots, 32-token prompts, 16 new tokens
    eng = LMServingEngine(cfg, model, slots=4, max_len=128, device=dev)
    reqs = synthetic_lm_batch(np.random.default_rng(1), 8, 32,
                              cfg.vocab_size)["tokens"]
    for prompt in reqs:
        eng.submit(prompt.tolist(), max_new=16)
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    t_eng = time.perf_counter() - t0
    check(stats["completed"] == 8 and all(len(r.out) == 16
                                          for r in eng.completed),
          f"{arch} engine served every request in full ({stats})")
    rates["engine"] = 8 * 16 / t_eng
    print(f"{arch} engine: 8 requests in {stats['ticks']} ticks, "
          f"{t_eng:.3f} s, {rates['engine']:.1f} generated tokens/s, "
          f"{stats['ticks'] / t_eng:.1f} ticks/s")
    print(f"{arch} rates: prefill {rates['prefill']:.1f} tokens/s, decode "
          f"{rates['decode']:.1f} tokens/s, engine {rates['engine']:.1f} "
          f"tokens/s, peak memory {peak / 1e9:.2f} GB; {smi_line}")
    del eng
    torch.cuda.empty_cache()

    # ---- end to end, on prompts of gate_seq tokens (above the window and
    # not a multiple of it where there is one): prefill's last logits
    # against decoding the same prompts token by token (a path with no
    # kernel) in f32 on the same weights, then one more token decoded from
    # each path's cache. The bf16 path (prefill, and decode from its
    # cache) is held against the same f32 token-by-token logits; how its
    # rounding grows with depth is printed beside it.
    gtoks, nxt = prompts[:, :gate_seq], prompts[:, gate_seq:gate_seq + 1]
    depths = [L for L in (1, 2, 4, 8, 16) if L < cfg.num_layers] + [
        cfg.num_layers]
    t0 = time.perf_counter()
    d16 = depth_logits(torch, cfg, model, gtoks, depths)
    last16, cache = M.prefill_step(cfg, model, gtoks)
    next16 = M.decode_step(cfg, model, cache, nxt, gate_seq)[0][:, 0]
    del cache
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model.float()
    d32 = depth_logits(torch, cfg32, model, gtoks, depths)
    last32, cache = M.prefill_step(cfg32, model, gtoks)
    next32 = M.decode_step(cfg32, model, cache, nxt, gate_seq)[0][:, 0]
    del cache
    cache = M.init_cache(cfg32, batch, gate_seq + 1, device=dev)
    for t in range(gate_seq + 1):
        step_logits, cache = M.decode_step(cfg32, model, cache,
                                           prompts[:, t:t + 1], t)
        if t == gate_seq - 1:
            ref_last = step_logits[:, 0]
    ref_next = step_logits[:, 0]
    torch.cuda.synchronize()
    errs = {"f32 prefill": rel_l2(last32, ref_last),
            "f32 decode from the prefill cache": rel_l2(next32, ref_next),
            "bf16 prefill": rel_l2(last16, ref_last),
            "bf16 decode from the prefill cache": rel_l2(next16, ref_next)}
    print(f"{arch} end to end on {batch} x {gate_seq} tokens + 1 "
          f"({time.perf_counter() - t0:.1f} s), relative L2 error against "
          f"f32 token-by-token: " + ", ".join(
              f"{k} {v:.4g}" for k, v in errs.items())
          + f"; argmax agreement, bf16 prefill "
          f"{float((last16.argmax(-1) == ref_last.argmax(-1)).float().mean()):.2f}"
          f", f32 prefill "
          f"{float((last32.argmax(-1) == ref_last.argmax(-1)).float().mean()):.2f}")
    print(f"{arch} bf16 against f32 prefill by depth (relative L2 error of "
          f"the last logits after L layers): " + ", ".join(
              f"L={L} {rel_l2(d16[L], d32[L]):.4g}" for L in depths))
    for what, err in errs.items():
        tol = f32_rel if what.startswith("f32") else bf16_rel
        check(err < tol, f"{arch} {what} vs token-by-token, relative L2 "
              f"error {err} (limit {tol})")
    del cache, step_logits, model, d16, d32
    torch.cuda.empty_cache()
    return row


MOE_LAYERS = {"dbrx-132b": 6, "grok-1-314b": 4}   # of 40 and 64: one card
# bf16 limits of the MoE gates: about twice the largest error an H100 gave
# (dbrx 0.01007, grok 0.005629; "NVIDIA H100 80GB HBM3, 700.00 W")
MOE_BF16_REL = {"dbrx-132b": 0.02, "grok-1-314b": 0.012}


def f32_copy(torch, group):
    """A nested dict of f32 copies of a `ParamGroup`'s parameters."""
    return {n: (f32_copy(torch, group[n])
                if isinstance(group[n], torch.nn.Module)
                else group[n].float()) for n in group.defs}


def moe_layer(torch, cfg, p, x, pos, plain):
    """One `attn_moe` layer from the module functions, in the order
    `apply_layer` runs them, with its attention through B4 or (`plain`)
    through the reference's formula `_sdpa` under a causal mask, where no
    kernel runs. Returns (x, (k, v), the last position's top-k experts)."""
    from repro_torch.nn import attention, moe
    from repro_torch.nn.basic import apply_norm
    xa = apply_norm(cfg, p["norm1"], x)
    if plain:
        S = x.shape[1]
        q, k, v = attention._project_qkv(cfg, p["attn"], xa, pos)
        h = attention._sdpa(cfg, q, k, v, attention.causal_mask(
            S, S, device=x.device))
        h = torch.einsum("bshe,hed->bsd", h, p["attn"]["wo"])
        del q
    else:
        h, (k, v) = attention.self_attention(cfg, p["attn"], xa, pos)
    x = x + h
    xn = apply_norm(cfg, p["norm2"], x)
    y, _ = moe.apply_moe(cfg, p["moe"], xn)
    return x + y, (k, v), moe.route(cfg, p["moe"], xn[:, -1:])[2][:, 0]


def attention_check(torch, dev, cfg, q, k, v, label, cap_acts=False,
                    window=0, q_offset=None):
    """B4 against its plain version on one layer's q, k, v, causal and
    banded to `window` keys where it is set, timed beside the plain
    version, SDPA (causal or under the band's mask, GQA; it has no
    soft-cap, so for a capped config it computes the uncapped function)
    and the kernel with the cap off; prints the largest |logit| and, with a cap, the kernel's
    distance to the uncapped plain version, which must be far outside the
    tolerance where `cap_acts`. With `q_offset` the queries are rows of
    the keys' sequence, row 0 at that position (a mesh position's rows of
    the context-parallel split): SDPA takes the offset causal mask, and
    the bound counts the pairs under it and the keys the rows reach.
    Returns the kernel's row (name, source, error, timings, bound).

    Tolerance, twice the bound of the kernel's roundings: P rounded to
    bf16 moves the output by at most 2^-9 of the largest |v| (the output
    is a convex combination of rows of v), and each output is rounded to
    bf16 (2^-9 of |out| each): atol = 2^-8 max|v|, rtol = 2^-7 (the
    unconditioned projections' v reach ~100, where a bf16 step is 0.5).
    The bound takes the peak of the operands' type (f32 on the CUDA
    cores for f32)."""
    from repro_torch.kernels.flash_attention import (BK, BQ, flash_attention,
                                                     gqa_flash_attention,
                                                     ref_attention)
    cap = cfg.attn_logit_softcap
    W = window
    # rows or keys off the block (a position's 28 rows of whisper's 224
    # tokens) go through the wrapper that pads them, as the path does
    kernel = (flash_attention if q.shape[1] % BQ == 0 and k.shape[1] % BK == 0
              else gqa_flash_attention)
    out = kernel(q, k, v, window=W, softcap=cap, q_offset=q_offset)
    ref = ref_attention(q, k, v, window=W, softcap=cap,
                        q_offset=q_offset or 0)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    v_max = float(v.float().abs().max())
    atol = 2.0 ** -8 * v_max
    check(torch.allclose(out.float(), ref.float(), rtol=2.0 ** -7,
                         atol=atol),
          f"{label}: flash_attention vs plain, max abs err {err} (largest "
          f"|v| {v_max})")
    B_, S_, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    o = q_offset or 0
    lg = torch.einsum("qhd,khd->hqk", q[0].float(),
                      k[0].float().repeat_interleave(H // KV, 1)) / hd ** 0.5
    qpos = torch.arange(S_, device=dev)[:, None] + o
    kpos = torch.arange(Sk, device=dev)[None, :]
    band = kpos <= qpos
    if W:
        band &= kpos > qpos - W
    lg.masked_fill_(~band, 0.0)
    max_logit = float(lg.abs().max())
    del lg
    line = (f"{label}: B {B_}, S {S_}"
            + (f" rows at offset {o} of {Sk} keys" if q_offset else "")
            + f", {H} q heads, {KV} kv heads, hd {hd}, "
            f"causal{f', window {W}' if W else ''}, soft-cap {cap}; largest |logit| (batch 0) "
            f"{max_logit:.4g}; max abs err vs plain {err:.3g} of values up "
            f"to {float(ref.float().abs().max()):.3g} (largest |v| "
            f"{v_max:.3g}, atol {atol:.3g})")
    if cap:
        far = float((out.float() - ref_attention(q, k, v, window=W).float()
                     ).abs().max())
        line += f"; vs the uncapped plain version {far:.3g}"
        check(far > 10 * atol or not cap_acts,
              f"{label}: the cap acts (kernel {far} from the uncapped plain "
              f"version)")
    print(line)
    flops = 4 * B_ * H * int(band.sum()) * hd
    reach = min(Sk, o + S_) if q_offset is not None else Sk
    nbytes = (2 * q.numel() + 2 * B_ * reach * KV * hd) * q.element_size()
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))

    def library():
        if W or q_offset is not None:
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=True)
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    t = timings(torch, lambda: kernel(q, k, v, window=W, softcap=cap,
                                      q_offset=q_offset),
                lambda: ref_attention(q, k, v, window=W, softcap=cap,
                                      q_offset=o),
                library, plain_reps=5)
    # without a cap the kernel and "the kernel without the cap" are one call
    t["uncapped_ms"] = (time_ms(torch, lambda: kernel(
        q, k, v, window=W, q_offset=q_offset)) if cap else t["ms"])
    ms, by = bound(nbytes, flops, PEAK_BF16_FLOP_S
                   if q.dtype == torch.bfloat16 else PEAK_F32_FLOP_S)
    print(f"{label} timings: kernel {t['ms']:.4f} ms "
          f"({flops / t['ms'] / 1e9:.1f} TFLOP/s, {ms / t['ms']:.1%} of "
          f"its bound {ms:.4f} ms, {by}); the kernel without the cap "
          f"{t['uncapped_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; SDPA "
          f"{t['library_ms']:.4f} ms{' (uncapped)' if cap else ''}")
    return dict(name="flash_attention",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:77",
                max_abs_err=err, bound=(ms, by), **t)


def moe_phase(torch, dev, kernels, arch, bf16_rel, smi_line):
    """An MoE model (ROADMAP A10.1) at full width, its depth cut to
    MOE_LAYERS[arch] so that the bf16 weights fit the card, random
    weights from a CUDA generator seeded 0 (conditioned as
    `condition_weights` says): (a) B4 on the first layer's real q, k, v
    at the prefill's shape (for a capped config also on the unconditioned
    projections, whose logits reach the thousands); (b) the main path,
    prefill 4 x 2048 + 32 greedy decode steps, with the share of
    assignments the capacity dropped per layer; (c) the engine; (d) the
    end-to-end gates on 2 x 2200 tokens against an f32 prefill through
    the plain attention, made one layer at a time from f32 copies of that
    layer's weights (the f32 model does not fit). Returns B4's launches
    in the prefill."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.models import decoder_lm as M
    from repro_torch.nn import attention, moe
    from repro_torch.nn import blocks as TB
    from repro_torch.nn.basic import apply_norm
    from repro_torch.nn.params import count_params
    from repro_torch.serving import LMServingEngine

    phase(f"moe {arch}")
    torch.cuda.empty_cache()
    print(f"device memory allocated before the model: "
          f"{torch.cuda.memory_allocated()} bytes")
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS[arch])
    batch, seq, n_dec, gate_seq = 4, 2048, 32, 2200
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(0)
    model = M.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    d, E, f, V = cfg.d_model, cfg.num_experts, cfg.d_ff, cfg.vocab_size
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    experts = 3 * E * d * f
    per_layer = experts + 2 * d * H * hd + 2 * d * KV * hd + d * E + (
        4 * d if cfg.norm_kind == "layernorm" else 2 * d)
    outer = 2 * V * d + (2 * d if cfg.norm_kind == "layernorm" else d)
    n_par = count_params(model)
    check(n_par == cfg.num_layers * per_layer + outer
          and count_params(model.layers[0]) == per_layer,
          f"{arch} parameter count {n_par}")
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{arch}: {cfg.num_layers} of {full.num_layers} layers (reduced "
          f"depth), d_model {d}, {H}/{KV} heads of {hd}, {E} experts top-"
          f"{cfg.experts_per_token}, d_ff {f}, {cfg.mlp_kind}, "
          f"{cfg.norm_kind}, vocab {V}, soft-caps {cfg.attn_logit_softcap}"
          f" / {cfg.final_logit_softcap}: {per_layer:.4g} parameters a "
          f"layer (experts {experts:.4g}), embed and head {outer:.4g}, "
          f"{n_par} in all ({n_par:.4g}), {n_bytes} bytes "
          f"({cfg.param_dtype}); made in {time.perf_counter() - t0:.1f}s")
    prompts = torch.from_numpy(synthetic_lm_batch(
        np.random.default_rng(0), batch, max(seq, gate_seq + 1),
        cfg.vocab_size)["tokens"]).long().to(dev)
    toks = prompts[:, :seq]
    pos = torch.arange(seq, device=dev)[None].expand(batch, seq)

    # ---- (a) B4 on the first layer's real operands (for a capped config
    # first on the unconditioned projections)
    def first_qkv():
        p = model.layers[0]
        with torch.no_grad():
            x = apply_norm(cfg, p["norm1"], M._embed_tokens(cfg, model, toks))
            return [a.contiguous() for a in attention._project_qkv(
                cfg, p["attn"], x, pos)]
    if cfg.attn_logit_softcap:
        attention_check(torch, dev, cfg, *first_qkv(),
                        f"flash_attention {arch} unconditioned",
                        cap_acts=True)
        torch.cuda.empty_cache()
    condition_weights(torch, cfg, model, gen)
    attention_check(torch, dev, cfg, *first_qkv(), f"flash_attention {arch}")
    torch.cuda.empty_cache()

    # ---- (b) the main path: prefill, then greedy decode from its cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    moe.apply_moe.drops = []
    t0 = time.perf_counter()
    last, cache = M.prefill_step(cfg, model, toks, length=seq + n_dec)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    drops, moe.apply_moe.drops = moe.apply_moe.drops, None
    tok = last.argmax(-1, keepdim=True)
    t0 = time.perf_counter()
    for t in range(seq, seq + n_dec):
        logits, cache = M.decode_step(cfg, model, cache, tok, t)
        tok = logits[:, 0].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = launch_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    check(launches["flash_attention"] == cfg.num_layers and all(
        v == 0 for n, v in launches.items() if n != "flash_attention"),
        f"{arch} prefill launched flash_attention once per layer "
        f"({launches})")
    check(bool(torch.isfinite(last).all()) and last.shape == (batch, V)
          and bool(torch.isfinite(logits).all()),
          f"{arch} prefill and decode logits finite, shaped")
    share = [int(n) / total for n, total in drops]
    check(len(share) == cfg.num_layers, f"{arch}: one MoE call a layer")
    rates = dict(prefill=batch * seq / t_prefill,
                 decode=batch * n_dec / t_decode)
    print(f"{arch} prefill {batch} x {seq}: {t_prefill:.3f} s, "
          f"{rates['prefill']:.1f} tokens/s; flash_attention launches "
          f"{launches['flash_attention']}; capacity {moe._capacity(cfg, seq)}"
          f" slots an expert a row; share of assignments dropped, by layer: "
          + ", ".join(f"{s:.4f}" for s in share))
    print(f"{arch} decode {n_dec} tokens x {batch}: {t_decode:.3f} s, "
          f"{rates['decode']:.1f} tokens/s ({1e3 * t_decode / n_dec:.2f} "
          f"ms per step); peak memory {peak} bytes")
    step_profile(torch, lambda: M.decode_step(cfg, model, cache, tok,
                                              seq + n_dec - 1),
                 f"{arch} decode")
    del cache, logits
    torch.cuda.empty_cache()

    # ---- (c) the engine: 8 requests, 4 slots, 32-token prompts, 16 new
    eng = LMServingEngine(cfg, model, slots=4, max_len=128, device=dev)
    for prompt in synthetic_lm_batch(np.random.default_rng(1), 8, 32,
                                     V)["tokens"]:
        eng.submit(prompt.tolist(), max_new=16)
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    t_eng = time.perf_counter() - t0
    check(stats["completed"] == 8 and all(len(r.out) == 16
                                          for r in eng.completed),
          f"{arch} engine served every request in full ({stats})")
    rates["engine"] = 8 * 16 / t_eng
    print(f"{arch} engine: 8 requests in {stats['ticks']} ticks, "
          f"{t_eng:.3f} s, {rates['engine']:.1f} generated tokens/s")
    print(f"{arch} rates: prefill {rates['prefill']:.1f} tokens/s, decode "
          f"{1e3 * t_decode / n_dec:.2f} ms per step "
          f"({rates['decode']:.1f} tokens/s), engine {rates['engine']:.1f} "
          f"tokens/s, peak memory {peak / 1e9:.2f} GB; {smi_line}")
    del eng
    torch.cuda.empty_cache()

    # ---- (d) end to end on 2 x gate_seq tokens (not a multiple of 128:
    # B4's padding runs). The reference: an f32 prefill through the plain
    # attention (no kernel), one layer at a time from f32 copies of its
    # weights, and one decode step from its cache; beside it the same
    # layers through B4's f32 kernel, and the bf16 model through
    # prefill_step / decode_step
    B2 = 2
    gtoks = prompts[:B2, :gate_seq]
    nxt = prompts[:B2, gate_seq:gate_seq + 1]
    gpos = torch.arange(gate_seq, device=dev)[None].expand(B2, gate_seq)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    last16, cache = M.prefill_step(cfg, model, gtoks, length=gate_seq + 1)
    next16 = M.decode_step(cfg, model, cache, nxt, gate_seq)[0][:, 0]
    del cache

    def pad1(kv):
        return {n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 1))
                for n, t in zip(("k", "v"), kv)}
    x16 = M._embed_tokens(cfg, model, gtoks)
    xk = xr = M._embed_tokens(cfg32, model, gtoks)
    yk = yr = M._embed_tokens(cfg32, model, nxt)
    agree = []
    with torch.no_grad():
        for i, p16 in enumerate(model.layers):
            p32 = f32_copy(torch, p16)
            x16, _, idx16 = moe_layer(torch, cfg, p16, x16, gpos, False)
            xk, ck, _ = TB.apply_layer(cfg32, "attn_moe", p32, xk,
                                       mode="prefill", positions=gpos)
            yk, _, _ = TB.apply_layer(cfg32, "attn_moe", p32, yk,
                                      mode="decode", cache=pad1(
                                          (ck["k"], ck["v"])), pos=gate_seq)
            del ck
            xr, kv, idx32 = moe_layer(torch, cfg32, p32, xr, gpos, True)
            yr, _, _ = TB.apply_layer(cfg32, "attn_moe", p32, yr,
                                      mode="decode", cache=pad1(kv),
                                      pos=gate_seq)
            del kv, p32
            agree.append(float(sum(
                len(set(a.tolist()) & set(b.tolist()))
                for a, b in zip(idx16, idx32)) / idx16.numel()))
        top32 = {"final_norm": f32_copy(torch, model["final_norm"]),
                 "lm_head": model["lm_head"].float()}

        def head(params, c, x):
            return M._project_logits(c, params, apply_norm(
                c, params["final_norm"], x[:, -1:]))[:, 0]
        lastk, nextk = head(top32, cfg32, xk), head(top32, cfg32, yk)
        lastr, nextr = head(top32, cfg32, xr), head(top32, cfg32, yr)
        loop16 = head(model, cfg, x16)
    torch.cuda.synchronize()
    gate_peak = torch.cuda.max_memory_allocated()
    del top32, xk, xr, yk, yr, x16
    errs = {"f32 kernel prefill": rel_l2(lastk, lastr),
            "f32 kernel decode from its cache": rel_l2(nextk, nextr),
            "bf16 prefill": rel_l2(last16, lastr),
            "bf16 decode from its cache": rel_l2(next16, nextr)}
    print(f"{arch} end to end on {B2} x {gate_seq} tokens + 1 "
          f"({time.perf_counter() - t0:.1f} s, peak memory {gate_peak} "
          f"bytes), relative L2 error against the f32 prefill through the "
          f"plain attention (layer by layer) and its decode step: "
          + ", ".join(f"{k} {v:.4g}" for k, v in errs.items())
          + f"; argmax agreement, bf16 prefill "
          f"{float((last16.argmax(-1) == lastr.argmax(-1)).float().mean()):.2f}"
          f"; bf16 module-function loop == prefill_step: "
          f"{bool(torch.equal(loop16, last16))}")
    print(f"{arch} bf16 against f32: share of the last position's top-"
          f"{cfg.experts_per_token} expert choices that agree, by layer: "
          + ", ".join(f"{a:.3f}" for a in agree)
          + f" (mean {float(np.mean(agree)):.3f})")
    for what, err in errs.items():
        tol = F32_REL if what.startswith("f32") else bf16_rel
        check(err < tol, f"{arch} {what} vs the f32 plain prefill, relative "
              f"L2 error {err} (limit {tol})")
    del model, last16, next16
    torch.cuda.empty_cache()
    return launches["flash_attention"]


# models of the cross-attention phase (ROADMAP A10.2): main-path batch,
# prompt, stub-frontend length, gate batch and prompt. whisper: 16 clips
# of 1500 frames, 224-token previous-text prompts (n_text_ctx / 2)
XATTN_SHAPES = {"llama-3.2-vision-11b": dict(batch=4, seq=2048, gate=(2, 2200)),
                "whisper-small": dict(batch=16, seq=224, gate=(2, 200))}
# bf16 limits of its gates: about twice the largest error an H100 gave
# (llama 0.01181, whisper 0.008961; "NVIDIA H100 80GB HBM3, 700.00 W")
XATTN_BF16_REL = {"llama-3.2-vision-11b": 0.024, "whisper-small": 0.018}


def pad_rows(torch, t, block: int = 128, value: float = 0.0):
    """t (B, S, heads, hd) padded along S to a multiple of `block`."""
    S = t.shape[1]
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, -(-S // block) * block
                                       - S), value=value).contiguous()


def bounded_attention_check(torch, q, k, v, label):
    """B4 with its key bound on one layer's real q (B, Sq, H, hd) and k, v
    (B, Sk, KV, hd), not causal, as the main path launches it: queries and
    keys zero-padded to multiples of 128, kv_len = Sk. The kernel against
    its plain version in bf16 (tolerance of `attention_check`) and in f32
    (rtol 1e-4, atol 2e-5 of the largest |v|: softmax sums in another
    order); NaN in every padded key and value gives the zero-padded bits
    in both; timed beside the plain version and SDPA over the unpadded
    operands (GQA where KV < H). The bound counts the true Sq x Sk pairs.
    Returns (row of timings, line)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     ref_attention)
    B_, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qp, kp, vp = (pad_rows(torch, t) for t in (q, k, v))
    kn, vn = (pad_rows(torch, t, value=float("nan")) for t in (k, v))

    def kernel(k_=kp, v_=vp, q_=qp):
        return flash_attention(q_, k_, v_, causal=False, kv_len=Sk)
    out, nan = kernel(), kernel(kn, vn)
    ref = ref_attention(qp, kp, vp, causal=False, kv_len=Sk)
    f32 = [t.float() for t in (qp, kp, vp, kn, vn)]
    out32 = kernel(f32[1], f32[2], f32[0])
    nan32 = kernel(f32[3], f32[4], f32[0])
    ref32 = ref_attention(*f32[:3], causal=False, kv_len=Sk)
    torch.cuda.synchronize()
    v_max = float(v.float().abs().max())
    err = float((out.float() - ref.float()).abs().max())
    err32 = float((out32 - ref32).abs().max())
    check(torch.allclose(out.float(), ref.float(), rtol=2.0 ** -7,
                         atol=2.0 ** -8 * v_max),
          f"{label}: bf16 kernel vs plain with kv_len {Sk}, max abs err "
          f"{err} (largest |v| {v_max})")
    check(torch.allclose(out32, ref32, rtol=1e-4, atol=2e-5 * v_max),
          f"{label}: f32 kernel vs plain with kv_len {Sk}, max abs err "
          f"{err32}")
    check(torch.equal(nan, out) and torch.equal(nan32, out32),
          f"{label}: NaN in the padded keys and values changes the output")
    del out32, nan32, ref32, f32, nan, kn, vn
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=KV != H)
    lib_err = float((library().transpose(1, 2).float()
                     - ref[:, :Sq].float()).abs().max())
    t = timings(torch, kernel, lambda: ref_attention(
        qp, kp, vp, causal=False, kv_len=Sk), library, plain_reps=5)
    flops = 4 * B_ * H * Sq * Sk * hd
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t["bound"] = bound(nbytes, flops, PEAK_BF16_FLOP_S)
    t.update(max_abs_err=err, max_abs_err_f32=err32)
    ms, by = t["bound"]
    line = (f"{label}: B {B_}, Sq {Sq} (padded {qp.shape[1]}), Sk = kv_len "
            f"{Sk} (padded {kp.shape[1]}), {H} q heads, {KV} kv heads, hd "
            f"{hd}, not causal; max abs err vs plain bf16 {err:.3g}, f32 "
            f"{err32:.3g} (largest |v| {v_max:.3g}); NaN padding: same bits;"
            f" SDPA's max abs err {lib_err:.3g}; kernel {t['ms']:.4f} ms "
            f"({flops / t['ms'] / 1e9:.1f} TFLOP/s, {ms / t['ms']:.1%} of its "
            f"bound {ms:.4f} ms, {by}); plain {t['plain_ms']:.4f} ms; SDPA "
            f"{t['library_ms']:.4f} ms; one call per event pair: kernel "
            f"{t['ms_one_call']:.4f} ms, SDPA {t['library_ms_one_call']:.4f} "
            f"ms")
    print(line, flush=True)
    return t, line


def plain_layer(torch, cfg, kind, p, x, pos, frontend):
    """One `attn`, `xattn`, `encdec` or `enc` layer from the module
    functions, in `apply_layer`'s order, with every attention through the
    reference's formula `_sdpa` (a causal mask for `attn` / `encdec`
    self-attention, none for `enc` and cross-attention), where no kernel
    runs. Returns (x, the layer's prefill cache)."""
    from repro_torch.nn import attention as A
    from repro_torch.nn.basic import apply_mlp, apply_norm

    def attend(pa, q, k, v, causal):
        S = q.shape[1]
        h = A._sdpa(cfg, q, k, v, A.causal_mask(S, S, device=q.device)
                    if causal else None)
        return torch.einsum("bshe,hed->bsd", h, pa["wo"])

    def cross(pa, xn):
        xk, xv = A.project_kv(cfg, pa, frontend)
        q = torch.einsum("bsd,dhe->bshe", xn, pa["wq"])   # no RoPE
        return attend(pa, q, xk, xv, False), {"xk": xk, "xv": xv}
    if kind == "xattn":
        h, cache = cross(p["xattn"], apply_norm(cfg, p["norm1"], x))
        x = x + torch.tanh(p["gate_attn"]) * h
        h = apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
        return x + torch.tanh(p["gate_mlp"]) * h, cache
    q, k, v = A._project_qkv(cfg, p["attn"], apply_norm(cfg, p["norm1"], x),
                             pos)
    x = x + attend(p["attn"], q, k, v, kind != "enc")
    cache = {} if kind == "enc" else {"k": k, "v": v}
    if kind == "encdec":
        h, xc = cross(p["xattn"], apply_norm(cfg, p["normx"], x))
        x = x + h
        cache.update(xc)
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x)), cache


def xattn_param_count(cfg) -> tuple:
    """Parameters of a cross-attention or encoder model from its config
    (nn/basic.py, nn/attention.py): (per decoder layer kind, per encoder
    layer, embed + head + norms, total)."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    norm = 2 * d if cfg.norm_kind == "layernorm" else d
    attn = 2 * d * H * hd + 2 * d * KV * hd
    mlp = (3 if cfg.mlp_kind in ("swiglu", "geglu") else 2) * d * f
    kinds = {"attn": attn + mlp + 2 * norm, "enc": attn + mlp + 2 * norm,
             "xattn": attn + mlp + 2 * norm + 2,
             "encdec": 2 * attn + mlp + 3 * norm}
    enc = kinds["enc"] if cfg.is_encdec else 0
    outer = (1 if cfg.tie_embeddings else 2) * V * d + norm * (
        2 if cfg.is_encdec else 1)
    total = (sum(kinds[k] for k in cfg.layer_kinds)
             + cfg.encoder_layers * enc + outer)
    return kinds, enc, outer, total


def xattn_phase(torch, dev, kernels, arch, smi_line):
    """A cross-attention or encoder model (ROADMAP A10.2) at full width
    and depth in bf16, random weights from a CUDA generator seeded 0
    (conditioned as `condition_weights` says), stub frontends drawn from
    a seeded generator: (a) B4 with its key bound on the first `xattn`
    layer's real q, k, v (llama-3.2-vision-11b), or on the first `enc`
    layer's and the first `encdec` layer's cross-attention (whisper-
    small); (c) the main path, a prefill with the frontend + 32 greedy
    decode steps, B4 counted; then the engine with its cache seeded by
    `seed_frontend_cache`; (d) `seed_frontend_cache` against the prefill's
    xk / xv, bit for bit, and a decode from it at position 0; (e) the
    end-to-end gates against an f32 prefill through the plain attention
    (`plain_layer`, no kernel) and one decode step from its cache, made
    one layer at a time from f32 copies of that layer's weights, beside
    the same layers through B4's f32 kernel and the bf16 model through
    `prefill_step` / `decode_step`. Returns (B4's launches in the
    prefill, the bounded-attention lines)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.models import decoder_lm as M
    from repro_torch.nn import attention as A
    from repro_torch.nn import blocks as TB
    from repro_torch.nn.basic import apply_norm
    from repro_torch.nn.params import count_params
    from repro_torch.serving import LMServingEngine

    phase(f"xattn {arch}")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    shp = XATTN_SHAPES[arch]
    batch, seq, n_dec = shp["batch"], shp["seq"], 32
    B2, gate_seq = shp["gate"]
    n_fe = frontend_rows(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(0)
    model = M.init_params(cfg, gen, device=dev)
    condition_weights(torch, cfg, model, gen)
    torch.cuda.synchronize()
    kinds, enc, outer, total = xattn_param_count(cfg)
    n_par = count_params(model)
    check(n_par == total and all(
        count_params(p) == kinds[k]
        for p, k in zip(model.layers, cfg.layer_kinds)),
        f"{arch} parameter count {n_par} (from the config {total})")
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{arch}: {cfg.num_layers} decoder layers ("
          + ", ".join(f"{cfg.layer_kinds.count(k)} {k}"
                      for k in dict.fromkeys(cfg.layer_kinds))
          + f"), {cfg.encoder_layers} encoder layers, d_model {cfg.d_model},"
          f" {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, {cfg.mlp_kind} d_ff {cfg.d_ff}, "
          f"{cfg.norm_kind}, vocab {cfg.vocab_size}, frontend {n_fe} x "
          f"{cfg.d_model}: per layer " + ", ".join(
              f"{k} {kinds[k]:.4g}" for k in dict.fromkeys(cfg.layer_kinds))
          + (f", enc {enc:.4g}" if enc else "")
          + f", embed + head + norms {outer:.4g}; {n_par} parameters in all "
          f"({n_par:.4g}), {n_bytes} bytes ({cfg.param_dtype}); made in "
          f"{time.perf_counter() - t0:.1f}s")
    frontend = draw_frontend(torch, dev, cfg, batch)
    prompts = torch.from_numpy(synthetic_lm_batch(
        np.random.default_rng(0), batch, max(seq, gate_seq + 1),
        cfg.vocab_size)["tokens"]).long().to(dev)
    toks = prompts[:, :seq]
    pos = torch.arange(seq, device=dev)[None].expand(batch, seq)

    # ---- (a) B4 with the key bound on the first cross / bidirectional
    # layer's real operands, at the main path's shapes
    lines = []
    with torch.no_grad():
        if cfg.is_encdec:
            p = model.encoder[0]
            epos = torch.arange(n_fe, device=dev)[None].expand(batch, n_fe)
            q, k, v = (a.contiguous() for a in A._project_qkv(
                cfg, p["attn"], apply_norm(cfg, p["norm1"], frontend), epos))
            lines.append(bounded_attention_check(
                torch, q, k, v, f"flash_attention {arch} enc (layer 0)"))
            del q, k, v
            enc_out = M._run_encoder(cfg, model, frontend)
            p = model.layers[0]
            x = M._embed_tokens(cfg, model, toks, pos)
            x = x + A.self_attention(cfg, p["attn"], apply_norm(
                cfg, p["norm1"], x), pos)[0]
            xk, xv = A.project_kv(cfg, p["xattn"], enc_out)
            q = torch.einsum("bsd,dhe->bshe", apply_norm(cfg, p["normx"], x),
                             p["xattn"]["wq"])
            lines.append(bounded_attention_check(
                torch, q, xk, xv, f"flash_attention {arch} cross "
                                  f"(layer 0)"))
            del enc_out, x, xk, xv, q
        else:
            i_x = cfg.layer_kinds.index("xattn")
            x = M._embed_tokens(cfg, model, toks, pos)
            for i in range(i_x):
                x, _, _ = TB.apply_layer(cfg, cfg.layer_kinds[i],
                                         model.layers[i], x, positions=pos)
            p = model.layers[i_x]
            xk, xv = A.project_kv(cfg, p["xattn"], frontend)
            q = torch.einsum("bsd,dhe->bshe", apply_norm(cfg, p["norm1"], x),
                             p["xattn"]["wq"])
            lines.append(bounded_attention_check(
                torch, q, xk, xv, f"flash_attention {arch} xattn "
                                  f"(layer {i_x})"))
            del x, xk, xv, q
    torch.cuda.empty_cache()

    # ---- (c) the main path: prefill with the frontend, then greedy decode
    n_b4 = prefill_launches(cfg)["flash_attention"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    t0 = time.perf_counter()
    last, cache = M.prefill_step(cfg, model, toks, frontend=frontend,
                                 length=seq + n_dec)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    tok = last.argmax(-1, keepdim=True)
    t0 = time.perf_counter()
    for t in range(seq, seq + n_dec):
        logits, cache = M.decode_step(cfg, model, cache, tok, t)
        tok = logits[:, 0].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = launch_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    check(launches["flash_attention"] == n_b4 and all(
        v == 0 for n, v in launches.items() if n != "flash_attention"),
        f"{arch} prefill launched flash_attention {n_b4} times ({launches})")
    check(bool(torch.isfinite(last).all()) and last.shape == (
        batch, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
        f"{arch} prefill and decode logits finite, shaped")
    rates = dict(prefill=batch * seq / t_prefill,
                 decode=batch * n_dec / t_decode)
    print(f"{arch} prefill {batch} x {seq} tokens with {batch} x {n_fe} "
          f"frontend rows: {t_prefill:.3f} s, {rates['prefill']:.1f} "
          f"tokens/s; flash_attention launches {launches['flash_attention']}")
    print(f"{arch} decode {n_dec} tokens x {batch}: {t_decode:.3f} s, "
          f"{rates['decode']:.1f} tokens/s ({1e3 * t_decode / n_dec:.2f} "
          f"ms per step); peak memory {peak} bytes")
    step_profile(torch, lambda: M.decode_step(cfg, model, cache, tok,
                                              seq + n_dec - 1),
                 f"{arch} decode")

    # ---- (d) seed_frontend_cache: the prefill's xk / xv, bit for bit; a
    # decode from the seeded cache at position 0 (the reference launcher's
    # path)
    seeded = M.seed_frontend_cache(cfg, model, M.init_cache(
        cfg, batch, seq + n_dec, device=dev), frontend)
    n_x = 0
    for c, sc, kind in zip(cache, seeded, cfg.layer_kinds):
        if kind in ("xattn", "encdec"):
            n_x += 1
            check(torch.equal(c["xk"], sc["xk"])
                  and torch.equal(c["xv"], sc["xv"]),
                  f"{arch} seed_frontend_cache == the prefill's xk / xv")
    first = M.decode_step(cfg, model, seeded, toks[:, :1], 0)[0]
    torch.cuda.synchronize()
    check(bool(torch.isfinite(first).all()),
          f"{arch} decode from the seeded cache at position 0: finite")
    print(f"{arch} seed_frontend_cache: xk / xv of {n_x} layers equal to the"
          f" prefill's bit for bit; a decode from it at position 0 finite")
    del cache, logits, seeded, first
    torch.cuda.empty_cache()

    # ---- the engine, its cache seeded: 8 requests, 4 slots, 32-token
    # prompts, 16 new tokens each
    eng = LMServingEngine(cfg, model, slots=4, max_len=128, device=dev)
    eng.cache = M.seed_frontend_cache(cfg, model, eng.cache, frontend[:4])
    for prompt in synthetic_lm_batch(np.random.default_rng(1), 8, 32,
                                     cfg.vocab_size)["tokens"]:
        eng.submit(prompt.tolist(), max_new=16)
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    t_eng = time.perf_counter() - t0
    check(stats["completed"] == 8 and all(len(r.out) == 16
                                          for r in eng.completed),
          f"{arch} engine served every request in full ({stats})")
    rates["engine"] = 8 * 16 / t_eng
    print(f"{arch} engine (cache seeded from 4 frontends): 8 requests in "
          f"{stats['ticks']} ticks, {t_eng:.3f} s, {rates['engine']:.1f} "
          f"generated tokens/s")
    print(f"{arch} rates: prefill {rates['prefill']:.1f} tokens/s, decode "
          f"{1e3 * t_decode / n_dec:.2f} ms per step "
          f"({rates['decode']:.1f} tokens/s), engine {rates['engine']:.1f} "
          f"tokens/s, peak memory {peak / 1e9:.2f} GB; {smi_line}")
    del eng
    torch.cuda.empty_cache()

    # ---- (e) end to end on B2 x gate_seq tokens: the reference is an f32
    # prefill through the plain attention (no kernel), one layer at a time
    # from f32 copies of its weights, and one decode step from its cache;
    # beside it the same layers through B4's f32 kernel, and the bf16
    # model through prefill_step / decode_step
    gtoks = prompts[:B2, :gate_seq]
    nxt = prompts[:B2, gate_seq:gate_seq + 1]
    gfe = frontend[:B2]
    gpos = torch.arange(gate_seq, device=dev)[None].expand(B2, gate_seq)
    npos = torch.full_like(nxt, gate_seq)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    last16, cache = M.prefill_step(cfg, model, gtoks, frontend=gfe,
                                   length=gate_seq + 1)
    next16 = M.decode_step(cfg, model, cache, nxt, gate_seq)[0][:, 0]
    del cache

    def pad1(c):
        return dict(c, **{n: torch.nn.functional.pad(c[n], (0, 0, 0, 0, 0, 1))
                          for n in ("k", "v") if n in c})
    with torch.no_grad():
        fk = fr = gfe.float()
        if cfg.is_encdec:
            epos = torch.arange(n_fe, device=dev)[None].expand(B2, n_fe)
            for p16 in model.encoder:
                p32 = f32_copy(torch, p16)
                fk = TB.apply_layer(cfg32, "enc", p32, fk, positions=epos)[0]
                fr = plain_layer(torch, cfg32, "enc", p32, fr, epos, None)[0]
            n32 = f32_copy(torch, model["encoder_norm"])
            fk, fr = apply_norm(cfg32, n32, fk), apply_norm(cfg32, n32, fr)
        xk = xr = M._embed_tokens(cfg32, model, gtoks, gpos)
        yk = yr = M._embed_tokens(cfg32, model, nxt, npos)
        for p16, kind in zip(model.layers, cfg.layer_kinds):
            p32 = f32_copy(torch, p16)
            xk, ck, _ = TB.apply_layer(cfg32, kind, p32, xk, mode="prefill",
                                       positions=gpos, frontend=fk)
            yk, _, _ = TB.apply_layer(cfg32, kind, p32, yk, mode="decode",
                                      cache=pad1(ck), pos=gate_seq)
            xr, cr = plain_layer(torch, cfg32, kind, p32, xr, gpos, fr)
            yr, _, _ = TB.apply_layer(cfg32, kind, p32, yr, mode="decode",
                                      cache=pad1(cr), pos=gate_seq)
            del ck, cr, p32
        top32 = {"final_norm": f32_copy(torch, model["final_norm"]),
                 "lm_head": model["lm_head"].float()}

        def head(x):
            return M._project_logits(cfg32, top32, apply_norm(
                cfg32, top32["final_norm"], x[:, -1:]))[:, 0]
        lastk, nextk, lastr, nextr = (head(a) for a in (xk, yk, xr, yr))
    torch.cuda.synchronize()
    gate_peak = torch.cuda.max_memory_allocated()
    del top32, xk, xr, yk, yr, fk, fr
    errs = {"f32 kernel prefill": rel_l2(lastk, lastr),
            "f32 kernel decode from its cache": rel_l2(nextk, nextr),
            "bf16 prefill": rel_l2(last16, lastr),
            "bf16 decode from its cache": rel_l2(next16, nextr)}
    print(f"{arch} end to end on {B2} x {gate_seq} tokens + 1, {B2} x {n_fe}"
          f" frontend rows ({time.perf_counter() - t0:.1f} s, peak memory "
          f"{gate_peak} bytes), relative L2 error against the f32 prefill "
          f"through the plain attention (layer by layer) and its decode "
          f"step: " + ", ".join(f"{k} {v:.4g}" for k, v in errs.items())
          + f"; argmax agreement, bf16 prefill "
          f"{float((last16.argmax(-1) == lastr.argmax(-1)).float().mean()):.2f}")
    for what, err in errs.items():
        tol = F32_REL if what.startswith("f32") else XATTN_BF16_REL[arch]
        check(err < tol, f"{arch} {what} vs the f32 plain prefill, relative "
              f"L2 error {err} (limit {tol})")
    del model, last16, next16, frontend
    torch.cuda.empty_cache()
    print(f"{arch} phase: {time.perf_counter() - t_phase:.1f} s")
    return launches["flash_attention"], [line for _, line in lines]


GRANITE_LAYERS = 4            # of 88: the bf16 weights with the exit heads,
                              # gradients and f32 moments fit the card
GRANITE_EXITS = (0, 1, 2)     # exit heads, t_min 0, t_max 2 (the reference's
                              # adaptive tests)
# lr: 1e-3, between TrainConfig's 3e-4 (which left the lm loss at 7.19
# after 40 steps on an H100) and the launcher's 3e-3
GRANITE_TRAIN = dict(steps=40, batch=8, seq=128, lr=1e-3)
GRANITE_T_S = (0.0, 0.35, 1e9)
# bf16 against the f32 plain path after training: about twice the
# 0.0017 an H100 gave (0.001615-0.001717 in two runs, lr 1e-3 and 3e-4)
GRANITE_BF16_REL = 0.004


def granite_param_count(cfg) -> tuple:
    """(a layer's, embed + head + final norm, the exit heads') parameters
    of a dense SwiGLU rmsnorm model with an untied head."""
    d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    f, V, n = cfg.d_ff, cfg.vocab_size, len(cfg.adaptive.exit_layers)
    per_layer = 2 * d * H * hd + 2 * d * KV * hd + 3 * d * f + 2 * d
    return per_layer, 2 * V * d + d, n * d * d + n * d + V


def hd32_check(torch, dev) -> str:
    """B4's f32 head-dim-32 instance (the smoke configs') against its
    plain version in each (cap, bound) instance, causal, banded and not
    causal, then timed at granite smoke's prefill shape at 4 x 2048
    (4 query heads, 1 kv head) beside the plain version and its bound at
    the f32 peak. Tolerance: rtol 1e-4, atol 2e-5 (f32 softmax sums in
    another order). With a causal mask and a key bound, the rows past
    the bound are compared only where the band still reaches a key:
    a row the band and the bound mask wholly is 0 from the kernel, which
    skips its blocks, and the mean of v from the plain version's uniform
    softmax over -1e30, and no model reads it (a causal layer's bound is
    its true length, and the wrapper cuts the padded rows)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     ref_attention)
    g = torch.Generator(dev).manual_seed(32)
    for causal, window in ((True, 0), (True, 48), (False, 0)):
        for cap in (0.0, 5.0):
            for kv_len in (None, 200):
                q = 3 * torch.randn((2, 256, 4, 32), generator=g, device=dev)
                k = 3 * torch.randn((2, 256, 2, 32), generator=g, device=dev)
                v = torch.randn((2, 256, 2, 32), generator=g, device=dev)
                kw = dict(causal=causal, window=window, softcap=cap,
                          kv_len=kv_len)
                out, ref = flash_attention(q, k, v, **kw), ref_attention(
                    q, k, v, **kw)
                torch.cuda.synchronize()
                if causal and kv_len and window:
                    rows = kv_len + window - 1    # the band reaches a key
                    out, ref = out[:, :rows], ref[:, :rows]
                check(torch.allclose(out, ref, rtol=1e-4, atol=2e-5),
                      f"flash_attention f32 hd 32 {kw} vs plain, max abs err "
                      f"{float((out - ref).abs().max())}")
    B_, S_, H, KV, hd = 4, 2048, 4, 1, 32
    q = torch.randn((B_, S_, H, hd), generator=g, device=dev)
    k = torch.randn((B_, S_, KV, hd), generator=g, device=dev)
    v = torch.randn((B_, S_, KV, hd), generator=g, device=dev)
    out, ref = flash_attention(q, k, v), ref_attention(q, k, v)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(torch.allclose(out, ref, rtol=1e-4, atol=2e-5),
          f"flash_attention f32 hd 32 at {B_} x {S_} vs plain, max abs err "
          f"{err}")
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    t = timings(torch, lambda: flash_attention(q, k, v),
                lambda: ref_attention(q, k, v), library, plain_reps=5)
    flops = 4 * B_ * H * band_pairs(S_, 0) * hd
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 4
    ms, by = bound(nbytes, flops, PEAK_F32_FLOP_S)
    line = (f"flash_attention f32 hd 32 (granite-34b smoke prefill, B {B_}, "
            f"S {S_}, {H} q heads, {KV} kv head, causal): all 12 (causal, "
            f"window, cap, bound) cases within rtol 1e-4 / atol 2e-5 of "
            f"plain; max abs err {err:.3g}; kernel {t['ms']:.4f} ms "
            f"({flops / t['ms'] / 1e9:.1f} TFLOP/s, {ms / t['ms']:.1%} of "
            f"its bound {ms:.4f} ms, {by}, f32 peak), plain "
            f"{t['plain_ms']:.4f} ms, SDPA (f32) {t['library_ms']:.4f} ms")
    print(line)
    return line


def smoke_lm_checks(torch, dev, kernels) -> None:
    """The LM's smoke-size checks on the card: `serve --smoke` (f32, head
    dim 32, through B4's new instance) gives the CPU run's continuation
    (ROADMAP C.7); one f32 training step of granite smoke with exit heads
    (loss, every gradient, the updated parameters) within 1e-4 relative of
    the same step on the CPU, TF32 off; `launch.train --arch rwkv6-3b
    --smoke --steps 6 --ckpt` (B5 not launched: training runs
    `_wkv_chunked`), its checkpoint loaded back bit-equal, then
    `--resume` to 12 steps."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.common import AdaptiveDepthConfig, TrainConfig
    from repro_torch.configs import get_config, smoke
    from repro_torch.data import synthetic_stream
    from repro_torch.launch import serve, train
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import decoder_lm as M
    from repro_torch.optim import adamw_init, adamw_update_, make_schedule

    t0 = time.perf_counter()
    argv = ["--arch", "granite-34b", "--smoke", "--tokens", "40",
            "--batch", "2"]
    zero_counts(kernels)
    on_card = serve.main(argv)
    n_b4 = kernels["flash_attention"].launches
    on_cpu = serve.main(argv + ["--device", "cpu"])
    check(n_b4 == 1 and kernels["flash_attention"].launches == 1,
          f"serve --smoke on the card launched B4 once ({n_b4})")
    check(np.array_equal(on_card["continuation"], on_cpu["continuation"]),
          "serve --arch granite-34b --smoke: the card's continuation is the "
          "CPU's")
    print(f"C.7: serve --arch granite-34b --smoke (f32, head dim 32) on the "
          f"card and on the CPU: the same {on_cpu['continuation'].shape} "
          f"continuation; B4 launched {n_b4} time on the card")

    cfg = dataclasses.replace(
        smoke(get_config("granite-34b")), num_layers=4,
        adaptive=AdaptiveDepthConfig(enabled=True, exit_layers=GRANITE_EXITS,
                                     t_min=0, t_max=2))
    raw = next(synthetic_stream(0, 4, 64, cfg.vocab_size))
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=0, total_steps=10)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for d in (torch.device("cpu"), dev):
        model = M.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        condition_weights(torch, cfg, model, torch.Generator())
        model = model.to(d).requires_grad_(True)
        loss, _ = M.loss_fn(cfg, model, lm_batch(cfg, raw, d))
        loss.backward()
        params = dict(model.named_parameters())
        grads = {n: p.grad.detach().cpu() for n, p in params.items()}
        opt = adamw_init(params, tc)
        adamw_update_({n: p.grad for n, p in params.items()}, opt, params,
                      tc, make_schedule(tc)(opt["count"]))
        out.append((float(loss.detach()), grads,
                    {n: p.detach().cpu() for n, p in params.items()}))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    (l0, g0, p0), (l1, g1, p1) = out
    worst = max(max(rel_l2(g1[n], g0[n]) for n in g0),
                max(rel_l2(p1[n], p0[n]) for n in p0))
    check(abs(l1 - l0) <= 1e-4 * abs(l0) and worst <= 1e-4,
          f"granite smoke training step card vs CPU: loss {l1} vs {l0}, "
          f"worst gradient / parameter relative L2 {worst}")
    print(f"granite-34b smoke (4 layers, exits {GRANITE_EXITS}) one f32 "
          f"training step, card vs CPU: loss {l1:.6f} vs {l0:.6f}, worst "
          f"relative L2 of {len(g0)} gradients and updated parameters "
          f"{worst:.3g} (limit 1e-4)")

    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        ck = str(Path(tmp) / "rwkv.ckpt")
        base = ["--arch", "rwkv6-3b", "--smoke", "--log-every", "3",
                "--ckpt", ck]
        zero_counts(kernels)
        r6 = train.main(base + ["--steps", "6"])
        check(kernels["wkv6"].launches == 0,
              "LM training launched no B5 (no backward)")
        like = {"params": dict(r6["model"].named_parameters()),
                "opt": r6["opt"]}
        back, step = load_checkpoint(ck, like)
        same = all(torch.equal(a, b) for a, b in zip(
            _leaves(back), _leaves(like)))
        check(step == 6 and same, f"rwkv6-3b checkpoint of step {step} "
              f"loads back bit-equal ({same})")
        r12 = train.main(base + ["--steps", "12", "--resume"])
        check(int(r12["opt"]["count"]) == 12 and all(
            bool(torch.isfinite(p).all()) for p in r12["model"].parameters()),
            "rwkv6-3b resumed to 12 steps, finite")
    print(f"launch.train --arch rwkv6-3b --smoke on the card: 6 steps, "
          f"checkpoint loaded back bit-equal, --resume to step 12; B5 not "
          f"launched; smoke checks {time.perf_counter() - t0:.1f} s")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def adaptive_phase(torch, dev, kernels, smi_line):
    """The LM's train -> serve path with adaptive depth (ROADMAP
    A10.3-A10.5) on granite-34b at full width, its depth cut to
    GRANITE_LAYERS, with exit heads at GRANITE_EXITS, bf16, random
    weights from a CUDA generator seeded 0 (conditioned as
    `condition_weights` says): after the smoke-size checks, 40 training
    steps of `loss_fn` with the inception term (in-place AdamW) on
    `synthetic_stream(0, 8, 128)`; then, the optimizer state freed, B4 on
    the first layer's q, k, v at the prefill's causal MQA shape, the
    prefill 4 x 2048 (B4 once per layer, the counted main path), 32
    decode steps at full depth and with `adaptive_decode_step` at each
    t_s of GRANITE_T_S, all on the prompts' next tokens (teacher
    forcing), the adaptive engine, and
    the gates on 2 x 2200 tokens against an f32 prefill through the plain
    attention made one layer at a time. Returns (B4's launches in the
    prefill, the lines for the summary)."""
    from repro_torch.common import AdaptiveDepthConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.adaptive_depth import (adaptive_decode_step,
                                                 saturation_distance)
    from repro_torch.data import synthetic_stream
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.launch.train import lm_batch, lm_train_step
    from repro_torch.models import decoder_lm as M
    from repro_torch.nn import attention
    from repro_torch.nn import blocks as TB
    from repro_torch.nn.basic import apply_norm
    from repro_torch.nn.params import count_params
    from repro_torch.optim import adamw_init, adamw_update_, make_schedule
    from repro_torch.serving import LMServingEngine

    phase("adaptive granite-34b")
    t_phase = time.perf_counter()
    lines = [hd32_check(torch, dev)]
    smoke_lm_checks(torch, dev, kernels)
    torch.cuda.empty_cache()

    full = get_config("granite-34b")
    cfg = dataclasses.replace(
        full, num_layers=GRANITE_LAYERS,
        adaptive=AdaptiveDepthConfig(enabled=True, exit_layers=GRANITE_EXITS,
                                     t_s=GRANITE_T_S[1], t_min=0, t_max=2))
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(0)
    model = M.init_params(cfg, gen, device=dev)
    condition_weights(torch, cfg, model, gen)
    torch.cuda.synchronize()
    per_layer, outer, exits = granite_param_count(cfg)
    n_par = count_params(model)
    check(n_par == cfg.num_layers * per_layer + outer + exits
          and count_params(model.layers[0]) == per_layer,
          f"granite-34b parameter count {n_par}")
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"granite-34b: {cfg.num_layers} of {full.num_layers} layers "
          f"(reduced depth), d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, SwiGLU d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, exit heads at blocks "
          f"{GRANITE_EXITS}: {per_layer:.4g} parameters a layer, embed and "
          f"head {outer:.4g}, exits {exits:.4g}, {n_par} in all "
          f"({n_par:.4g}), {n_bytes} bytes ({cfg.param_dtype}); made in "
          f"{time.perf_counter() - t0:.1f}s")

    # ---- train: loss_fn with the inception term, in-place AdamW
    tr = GRANITE_TRAIN
    tc = TrainConfig(learning_rate=tr["lr"], warmup_steps=tr["steps"] // 10,
                     total_steps=tr["steps"], weight_decay=0.01)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = adamw_init(params, tc)
    sched = make_schedule(tc)
    stream = synthetic_stream(0, tr["batch"], tr["seq"], cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, last = [], [], None
    for i in range(tr["steps"]):
        batch = lm_batch(cfg, next(stream), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:      # the first step by hand, to read every gradient
            loss, m = M.loss_fn(cfg, model, batch)
            loss.backward()
            bad = [n for n, p in params.items()
                   if p.grad is None or not bool(torch.isfinite(p.grad).all())
                   or not bool((p.grad != 0).any())]
            check(not bad, f"every parameter gets a finite, nonzero gradient "
                  f"(not: {bad})")
            m = {k: v.detach() for k, v in m.items()}
            m.update(adamw_update_({n: p.grad for n, p in params.items()},
                                   opt, params, tc, sched(opt["count"])))
            for p in params.values():
                p.grad = None
        else:
            m = lm_train_step(cfg, model, opt, tc, sched, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
        last = m
    train_peak = torch.cuda.max_memory_allocated()
    ms = 1e3 * float(np.median(step_s[5:]))
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"granite-34b train {tr['steps']} steps, batch {tr['batch']} x "
          f"{tr['seq']}, lr {tr['lr']} (cosine, {tc.warmup_steps} warmup "
          f"steps, wd 0.01, in-place AdamW, per-block remat): loss "
          + ", ".join(f"{losses[i]:.3f}" for i in range(0, tr["steps"], 8))
          + f", last {losses[-1]:.3f} (lm {float(last['lm_loss']):.3f}, "
          f"inception {float(last['inception_loss']):.3f}); mean of the "
          f"first 5 {first5:.3f}, last 5 {last5:.3f}; step {ms:.1f} ms "
          f"(median of steps 5-{tr['steps'] - 1}), "
          f"{tr['batch'] * tr['seq'] / ms * 1e3:.0f} tokens/s; peak memory "
          f"{train_peak / 1e9:.2f} GB; {smi_line}")
    check(all(np.isfinite(losses)), "every training loss finite")
    check(last5 < first5 - 0.5, f"granite-34b loss falls by more than 0.5 "
          f"({first5} -> {last5})")
    del opt, params, last, m, batch
    model.requires_grad_(False)
    torch.cuda.empty_cache()

    # ---- serve: B4 at the prefill's shape, prefill, decode at full depth
    # and adaptive on the same input tokens
    batch, seq, n_dec, gate_seq = 4, 2048, 32, 2200
    prompts = torch.from_numpy(synthetic_lm_batch(
        np.random.default_rng(0), batch, max(seq, gate_seq + 1),
        cfg.vocab_size)["tokens"]).long().to(dev)
    toks = prompts[:, :seq]
    pos = torch.arange(seq, device=dev)[None].expand(batch, seq)
    with torch.no_grad():
        p = model.layers[0]
        x = apply_norm(cfg, p["norm1"], M._embed_tokens(cfg, model, toks))
        q, k, v = (a.contiguous() for a in attention._project_qkv(
            cfg, p["attn"], x, pos))
    attention_check(torch, dev, cfg, q, k, v, "flash_attention granite-34b")
    del x, q, k, v
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    t0 = time.perf_counter()
    last, cache = M.prefill_step(cfg, model, toks, length=seq + n_dec)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    launches = launch_counts(kernels)
    check(launches["flash_attention"] == cfg.num_layers and all(
        v == 0 for n, v in launches.items() if n != "flash_attention"),
        f"granite-34b prefill launched flash_attention once per layer "
        f"({launches})")
    check(bool(torch.isfinite(last).all()), "granite-34b prefill finite")
    # decode the prompts' own continuation (teacher forcing: the Markov
    # stream's next tokens, the same in every run), so that the argmax
    # agreement compares predictions of varied inputs
    inputs = [prompts[:, seq + t:seq + t + 1] for t in range(n_dec)]
    tok = inputs[0]
    # the first decode step's saturation distance after each block (the
    # exit test's input), and one untimed step of each kind (the writes
    # at position seq are made again by the timed runs)
    with torch.no_grad():
        x = M._embed_tokens(cfg, model, tok, torch.full_like(tok, seq))
        dist = []
        for p, c in zip(model.layers, cache):
            x_new, _, _ = TB.apply_layer(cfg, "attn", p, x, mode="decode",
                                         cache=c, pos=seq)
            dist.append(saturation_distance(x_new, x))
            x = x_new
    M.decode_step(cfg, model, cache, tok, seq)
    adaptive_decode_step(cfg, model, cache, tok, seq)
    torch.cuda.synchronize()
    ref = []
    t0 = time.perf_counter()
    for t in range(n_dec):
        lg, cache = M.decode_step(cfg, model, cache, inputs[t], seq + t)
        ref.append(lg)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    ref_arg = torch.stack([r[:, 0].argmax(-1) for r in ref])
    print(f"granite-34b prefill {batch} x {seq}: {t_prefill:.3f} s, "
          f"{batch * seq / t_prefill:.1f} tokens/s, flash_attention "
          f"launches {launches['flash_attention']}; decode at full depth "
          f"{1e3 * t_full / n_dec:.2f} ms per step; the first decode "
          f"step's saturation distance after blocks 0-{len(dist) - 1}: "
          + "; ".join(", ".join(f"{float(v):.3f}" for v in d) for d in dist))
    dial = []
    for t_s in GRANITE_T_S:
        acfg = dataclasses.replace(cfg, adaptive=dataclasses.replace(
            cfg.adaptive, t_s=t_s))
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n_dec):
            lg, cache, info = adaptive_decode_step(acfg, model, cache,
                                                   inputs[t], seq + t)
            outs.append((lg, info))
        torch.cuda.synchronize()
        t_ad = time.perf_counter() - t0
        blocks = torch.stack([i["exit_block"] for _, i in outs])
        saved = float(torch.stack([i["flops_saved_frac"]
                                   for _, i in outs]).mean())
        agree = float((torch.stack([lg[:, 0].argmax(-1) for lg, _ in outs])
                       == ref_arg).float().mean())
        hist = {int(b): int(n) for b, n in zip(*torch.unique(
            blocks, return_counts=True))}
        sat = torch.stack([i["saturation"] for _, i in outs]).float()
        if t_s == 0.0:
            same = all(torch.equal(lg, r) for (lg, _), r in zip(outs, ref))
            check(same, "adaptive decode at t_s = 0 equals decode_step bit "
                  "for bit")
        check(all(bool(torch.isfinite(lg).all()) for lg, _ in outs),
              f"adaptive logits finite at t_s {t_s}")
        dial.append(f"t_s {t_s:g}: {1e3 * t_ad / n_dec:.2f} ms per step, "
                    f"flops_saved_frac {saved:.4f}, exit blocks {hist} "
                    f"(-1: full depth), saturation distance (the last "
                    f"measured) quartiles {sat.quantile(0.25):.3f} / "
                    f"{sat.median():.3f} / {sat.quantile(0.75):.3f}, argmax "
                    f"agreement with full depth {agree:.3f}")
    line = (f"granite-34b adaptive decode, {n_dec} steps x {batch} from the "
            f"{seq}-token prefill's cache, the prompts' next tokens fed to "
            f"each, each run after an untimed step (full depth's argmax "
            f"takes {len(set(ref_arg.flatten().tolist()))} distinct "
            f"values; it is the stream's next token at "
            f"{float((ref_arg[:-1] == torch.cat(inputs[1:], 1).T).float().mean()):.3f}"
            f" of the positions): full depth "
            f"{1e3 * t_full / n_dec:.2f} ms per step; "
            + "; ".join(dial) + f" (t_s 0 bit-equal to decode_step); "
            f"{smi_line}")
    print(line)
    lines.append(line)
    del cache, ref, inputs, last
    torch.cuda.empty_cache()

    eng = LMServingEngine(cfg, model, slots=4, max_len=128, adaptive=True,
                          device=dev)
    reqs = synthetic_lm_batch(np.random.default_rng(1), 8, 32,
                              cfg.vocab_size)["tokens"]
    for prompt in reqs:
        eng.submit(prompt.tolist(), max_new=16)
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    t_eng = time.perf_counter() - t0
    check(stats["completed"] == 8 and all(len(r.out) == 16
                                          for r in eng.completed),
          f"granite-34b adaptive engine served every request ({stats})")
    print(f"granite-34b adaptive engine (t_s {cfg.adaptive.t_s}): 8 "
          f"requests on 4 slots in {stats['ticks']} ticks, {t_eng:.3f} s, "
          f"{8 * 16 / t_eng:.1f} generated tokens/s, mean depth-FLOPs "
          f"saved {stats['mean_depth_flops_saved']:.4f}")
    del eng
    torch.cuda.empty_cache()

    # ---- gates: bf16 and the f32 kernel path against an f32 prefill
    # through the plain attention, one layer at a time from f32 copies
    B2 = 2
    gtoks, nxt = prompts[:B2, :gate_seq], prompts[:B2, gate_seq:gate_seq + 1]
    gpos = torch.arange(gate_seq, device=dev)[None].expand(B2, gate_seq)
    npos = torch.full((B2, 1), gate_seq, device=dev)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    last16, cache = M.prefill_step(cfg, model, gtoks, length=gate_seq + 1)
    next16 = M.decode_step(cfg, model, cache, nxt, gate_seq)[0][:, 0]
    del cache

    def pad1(c):
        return dict(c, **{n: torch.nn.functional.pad(c[n], (0, 0, 0, 0, 0, 1))
                          for n in ("k", "v")})
    with torch.no_grad():
        xk = xr = M._embed_tokens(cfg32, model, gtoks, gpos)
        yk = yr = M._embed_tokens(cfg32, model, nxt, npos)
        for p16 in model.layers:
            p32 = f32_copy(torch, p16)
            xk, ck, _ = TB.apply_layer(cfg32, "attn", p32, xk,
                                       mode="prefill", positions=gpos)
            yk, _, _ = TB.apply_layer(cfg32, "attn", p32, yk, mode="decode",
                                      cache=pad1(ck), pos=gate_seq)
            xr, cr = plain_layer(torch, cfg32, "attn", p32, xr, gpos, None)
            yr, _, _ = TB.apply_layer(cfg32, "attn", p32, yr, mode="decode",
                                      cache=pad1(cr), pos=gate_seq)
            del ck, cr, p32
        top32 = {"final_norm": f32_copy(torch, model["final_norm"]),
                 "lm_head": model["lm_head"].float()}

        def head(x):
            return M._project_logits(cfg32, top32, apply_norm(
                cfg32, top32["final_norm"], x[:, -1:]))[:, 0]
        lastk, nextk, lastr, nextr = (head(a) for a in (xk, yk, xr, yr))
    torch.cuda.synchronize()
    errs = {"f32 kernel prefill": rel_l2(lastk, lastr),
            "f32 kernel decode from its cache": rel_l2(nextk, nextr),
            "bf16 prefill": rel_l2(last16, lastr),
            "bf16 decode from its cache": rel_l2(next16, nextr)}
    print(f"granite-34b end to end on {B2} x {gate_seq} tokens + 1 "
          f"({time.perf_counter() - t0:.1f} s), relative L2 error against "
          f"the f32 prefill through the plain attention (layer by layer) and "
          f"its decode step: " + ", ".join(f"{k} {v:.4g}"
                                           for k, v in errs.items()))
    for what, err in errs.items():
        tol = F32_REL if what.startswith("f32") else GRANITE_BF16_REL
        check(err < tol, f"granite-34b {what} vs the f32 plain prefill, "
              f"relative L2 error {err} (limit {tol})")
    del model, top32, xk, xr, yk, yr, last16, next16
    torch.cuda.empty_cache()
    print(f"adaptive granite-34b phase: {time.perf_counter() - t_phase:.1f} s")
    return launches["flash_attention"], lines


# each model's depth in the sharded phase, halved (mistral 8, dbrx 6,
# rwkv6-3b 12, recurrentgemma-9b 14 and llama 10 layers before) when the
# batch-one phase was added: the whole run had taken 1,416.6 s of its
# 1,200 s on a slower host ("NVIDIA H100 80GB HBM3, 700.00 W"; the phases
# before it 1,087.5 s on another), the sharded phase 302.3 s of it.
# gemma-7b, whisper-small and deepseek-coder-33b keep theirs.
SHARDED_LAYERS = {"mistral-large-123b": 4,    # of 88: 11.1 GB of bf16
                  # 3 of 40; grok 4 of 64 as before (at 2 layers its
                  # (1, 2) decode logits were 0.0133 from (1, 1)'s, over
                  # the limit set at 4, where an H100 gave 0.00607)
                  "dbrx-132b": 3, "grok-1-314b": 4,
                  # 14 of 28 (whole, its two meshes took 20.3-23.5 s of
                  # an H100 run's phase)
                  "gemma-7b": 14,
                  # 3 of 32 (6 until its (1, 16) mesh, 10.5 s of the
                  # phase, was halved); 8 of 38 (two repeats of its
                  # (rglru, rglru, local) pattern and two rglru)
                  "rwkv6-3b": 3, "recurrentgemma-9b": 8,
                  # 5 of 40: one repeat of its (attn x 4, xattn) pattern
                  "llama-3.2-vision-11b": 5,
                  # 6 of 12 decoder layers, the encoder's 12 whole (whole,
                  # its four meshes took 37.1 s of an H100 run's phase)
                  "whisper-small": 6,
                  # 2 of 62 at full width (d 7168, 56 / 8 heads of 128):
                  # 1.06 GB a layer and 0.92 GB of embedding and head in
                  # bf16, so that its meshes stay within the run's time
                  "deepseek-coder-33b": 2}
SHARDED_MESHES = {"mistral-large-123b": ((1, 1), (1, 2), (1, 4), (2, 2)),
                  "gemma-7b": ((1, 1), (1, 2)),
                  "dbrx-132b": ((1, 1), (1, 2), (2, 2)),
                  "grok-1-314b": ((1, 1), (1, 2), (2, 2)),
                  # model 16: 2.5 of its 40 heads a position, the time
                  # mix on (batch row, head) pairs, the state over its keys
                  "rwkv6-3b": ((1, 1), (1, 2), (2, 2), (1, 16)),
                  "recurrentgemma-9b": ((1, 1), (1, 2), (2, 2)),
                  "llama-3.2-vision-11b": ((1, 1), (1, 2), (2, 2)),
                  # model 8: its 12 heads do not divide it, the query rows
                  # split (wq on d, wo on the head dim)
                  "whisper-small": ((1, 1), (1, 2), (2, 2), (1, 8)),
                  # model 16: 56 heads do not divide it; its prefill of
                  # 2048 splits the rows (the reference's `_seq_shard`)
                  "deepseek-coder-33b": ((1, 1), (1, 16))}
# where B4's query-offset instances are checked on the last position's
# rows: deepseek-coder-33b's at (1, 16), 4 x 128 rows at offset 1920 of
# 2048 keys (bf16 hd 128, timed for the summary), and whisper-small's
# decoder at (1, 8), 16 x 28 rows at offset 196 of 224 keys (bf16 hd 64)
OFFSET_CHECKS = {("deepseek-coder-33b", (1, 16)), ("whisper-small", (1, 8))}
# the meshes whose decode step and prefill run once more under the
# profiler (the device ms of each collective): mistral's four, which the
# dry run's lines and PERF.md's exchange columns read, and one a model
# elsewhere, by default (1, 2), where its exchange is (deepseek: (1, 1);
# the sharded adaptive phase's granite-34b takes the default); every
# mesh's exchange is counted in bytes. The profiler's parse of a placed
# step's events takes seconds: the traces of the meshes left out took
# 29.6 s of an H100 run's phase ("NVIDIA H100 80GB HBM3, 700.00 W"),
# those of (1, 8) and (1, 16) 8.8-34.8 s each
TRACED = collections.defaultdict(lambda: ((1, 2),), {
    "mistral-large-123b": ((1, 1), (1, 2), (1, 4), (2, 2)),
    "deepseek-coder-33b": ((1, 1),)})
SHARDED_SHAPE = dict(batch=4, seq=2048, n_dec=16)
# the prompt where it is not SHARDED_SHAPE's: whisper-small's 16 clips of
# 224 tokens (the cross-attention phase's), each with its 1500 frames;
# llama-3.2-vision-11b's 4 x 2048 tokens each with 1600 image rows
SHARDED_SHAPES = {"whisper-small": dict(batch=16, seq=224, n_dec=16)}
# limit of the relative L2 distance of a sharded mesh's bf16 logits to the
# (1, 1) mesh's (each position's partial products round to bf16 before the
# f32 all-reduce, so the sums round otherwise): about twice the largest an
# H100 gave (mistral 0.006314, gemma 0.01023; "NVIDIA H100 80GB HBM3,
# 700.00 W")
SHARDED_BF16_REL = 0.02
# per model: about twice the largest an H100 gave for the MoE and recurrent
# models (dbrx 0.00617, grok 0.00607, recurrentgemma 0.0123, rwkv 0.0242
# at the 3 layers of SHARDED_LAYERS: rwkv's bf16 rounding grows with
# depth, as against f32, to 0.4723 whole)
SHARDED_REL = {"mistral-large-123b": SHARDED_BF16_REL,
               "gemma-7b": SHARDED_BF16_REL,
               "dbrx-132b": 0.0125, "grok-1-314b": 0.0125,
               "rwkv6-3b": 0.05, "recurrentgemma-9b": 0.025,
               # twice the 0.01033 (llama whole) and 0.01029 an H100 gave
               "llama-3.2-vision-11b": 0.021, "whisper-small": 0.021,
               # about twice the 0.006247 an H100 gave at (1, 16) (2 of
               # 62 layers; whisper-small's (1, 8) gave 0.009976)
               "deepseek-coder-33b": 0.0125}
# the bf16 limit cannot see a wrong split of rwkv6-3b, so it runs again in
# f32 (8 of its 32 layers, prefill batch x seq and n_dec decode steps) on
# its meshes, held against (1, 1) under about twice the largest an H100
# gave at 8 layers, 3.569e-5 ("NVIDIA H100 80GB HBM3, 700.00 W"; whole,
# 4.311e-4 at (1, 2), under F32_REL; on a CPU smoke model a channel mix
# that drops its all-reduce is 0.49 away; whole it took 15.0 s of an H100
# run). whisper-small whole in f32 (2 x 224 tokens, 2 x 1500 frames, 4
# decode steps) holds the d-sharded embedding and head (its odd vocab),
# the encoder and the cross-attention to F32_REL
SHARDED_F32 = (dict(arch="rwkv6-3b", batch=2, seq=1024, n_dec=4, layers=8,
                    rel=8e-5),
               dict(arch="whisper-small", batch=2, seq=224, n_dec=4))
# limit of the MoE prefill's drops against (1, 1)'s, as a share of the
# assignments: the sum over layers of each layer's difference (the
# routers see residuals rounded otherwise; an H100 gave 47 of 196,608
# for dbrx and 13 of 65,536 for grok, "NVIDIA H100 80GB HBM3, 700.00 W")
MOE_DROP_GAP = 1e-3


def exchange_profile(torch, step):
    """One traced step's wall ms, device busy ms and the device ms of each
    collective (the kernels and copies launched inside its
    ``exchange.<op>`` range), from the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, _, _ = device_spans(prof, wall)
    ops = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("exchange."):
            ops[e.name] = ops.get(e.name, 0.0) + e.device_time_total / 1e3
    return 1e3 * wall, busy, ops


KERNEL_KINDS = {"flash_attention": ("attn", "attn_moe", "local"),
                "wkv6": ("rwkv",)}


def offset_launches(cfg, params, seq: int, data: int, model_ax: int) -> int:
    """B4's launches with a query offset > 0 in one prefill of `seq`
    tokens on a placed model: each causal attention layer whose query rows
    split over "model" (`nn.attention.splits_rows`) launches the offset
    instances on every position but the first along the axis."""
    from repro_torch.nn import attention
    if model_ax == 1:
        return 0
    n = sum(attention.splits_rows(cfg, p["attn"]["wq"], seq)
            for p, k in zip(params["layers"], cfg.layer_kinds)
            if k in ("attn", "attn_moe", "local", "encdec"))
    return n * data * (model_ax - 1)


def prefill_launches(cfg) -> dict:
    """Each LM kernel's launches in one prefill on one mesh position: B4
    once per `attn`, `attn_moe`, `local` and `xattn` layer and encoder
    layer, twice per `encdec` layer (its self- and cross-attention); B5
    once per `rwkv` layer."""
    kinds = cfg.layer_kinds
    return {"flash_attention": sum(k in KERNEL_KINDS["flash_attention"]
                                   + ("xattn",) for k in kinds)
            + 2 * kinds.count("encdec") + cfg.encoder_layers,
            "wkv6": kinds.count("rwkv")}


def frontend_rows(cfg) -> int:
    """The frontend's rows a sequence: encoder frames or image rows (0:
    no frontend)."""
    return cfg.encoder_seq if cfg.is_encdec else cfg.num_image_tokens


def draw_frontend(torch, dev, cfg, batch):
    """The stub frontend (batch, rows, d) in the model's dtype, from a
    CUDA generator seeded 1 (None without a frontend)."""
    from repro_torch.nn.params import torch_dtype
    n = frontend_rows(cfg)
    if not n:
        return None
    return torch.randn((batch, n, cfg.d_model), device=dev,
                       generator=torch.Generator(dev).manual_seed(1)).to(
        torch_dtype(cfg.dtype))


def frontend_operands(torch, cfg, params, toks, frontend, mesh):
    """Mesh position 0's q, k, v of B4's key-bound launches at the
    prefill's shape, as the sharded path hands them over (on a mesh of
    one position, the unplaced path's): llama-3.2-vision's first `xattn`
    layer, or whisper's first `enc` layer and its first `encdec` layer's
    cross-attention. Returns [(what, q, k, v)]."""
    from repro_torch.models import decoder_lm as M
    from repro_torch.nn import attention as A
    from repro_torch.nn import blocks as TB
    from repro_torch.nn.basic import apply_norm
    from repro_torch.sharding import placement as pl
    one = len(mesh.devices) == 1
    if one:
        params, ts, fe = pl.local_tree(params), toks, frontend
    else:
        placed = pl.shard_inputs(cfg, {"tokens": toks, "frontend": frontend},
                                 mesh)
        ts, fe = placed["tokens"], placed["frontend"]

    def pick(q, k, v):
        if one:
            return q, k, v
        if q.spec[1] is not None:         # rows over "model": whole k, v
            rep = (k.spec[0], None, None, None)
            return (q.locals[0], pl.relayout(k, rep).locals[0],
                    pl.relayout(v, rep).locals[0])
        k, v = A._whole_head_dim(k), A._whole_head_dim(v)
        return (q.locals[0], A._kv_for_heads(q, k, 0),
                A._kv_for_heads(q, v, 0))

    def queries(p, xn):
        if one:
            return torch.einsum("bsd,dhe->bshe", xn, p["wq"])
        if A.splits_rows(cfg, p["wq"], xn.shape[1]):
            return A._row_queries(cfg, p["wq"], xn)
        return pl.einsum("bsd,dhe->bshe", xn, p["wq"])

    def cross(p, xn, y):
        return pick(queries(p, xn), *A.project_kv(cfg, p, y))
    out = []
    with torch.no_grad():
        pos = M._positions(ts)
        x = M._embed_tokens(cfg, params, ts, pos)
        if cfg.is_encdec:
            p = params["encoder"][0]
            y = pl.per_position(lambda t: t.to(x.dtype), fe)
            yn = apply_norm(cfg, p["norm1"], y)
            if one:
                qkv = A._project_qkv(cfg, p["attn"], yn, M._positions(y))
            else:
                qkv = (queries(p["attn"], yn), *A._sharded_kv(
                    cfg, p["attn"], yn, M._positions(y)))
            out.append(("enc (layer 0)", *pick(*qkv)))
            p = params["layers"][0]
            x = x + A.self_attention(cfg, p["attn"], apply_norm(
                cfg, p["norm1"], x), pos)[0]
            out.append(("cross (layer 0)", *cross(
                p["xattn"], apply_norm(cfg, p["normx"], x),
                M._frontend(cfg, params, fe))))
        else:
            i_x = cfg.layer_kinds.index("xattn")
            for i in range(i_x):
                x, _, _ = TB.apply_layer(cfg, cfg.layer_kinds[i],
                                         params["layers"][i], x,
                                         positions=pos)
            p = params["layers"][i_x]
            out.append((f"xattn (layer {i_x})", *cross(
                p["xattn"], apply_norm(cfg, p["norm1"], x), fe)))
    return [(what, *(t.contiguous() for t in ops)) for what, *ops in out]


def position_operands(torch, cfg, params, toks, mesh, i=0):
    """Mesh position i's operands of the first layer that runs a kernel
    (an `encdec` layer's self-attention), at the prefill's shape, as the
    sharded path hands them over (on a mesh of one position, the unplaced
    path's): q, k, v for B4 (q the position's
    rows and k, v whole where the rows split over "model"), or r, k, v,
    logw, u for B5 (the position's (batch row, head) pairs as heads of one
    row where its columns split heads); with the layer's kind and B4's
    query offset (None where the rows do not split)."""
    from repro_torch.models import decoder_lm as M
    from repro_torch.nn import attention, rwkv
    from repro_torch.nn import blocks as TB
    from repro_torch.nn.basic import apply_norm
    from repro_torch.sharding import placement as pl
    one = len(mesh.devices) == 1
    offset = None
    with torch.no_grad():
        if one:
            params = pl.local_tree(params)
            ts, positions = toks, M._positions(toks)
        else:
            ts, positions = M._sharded_tokens(cfg, toks, mesh)
        x = M._embed_tokens(cfg, params, ts, positions)
        li, kind = next((j, k) for j, k in enumerate(cfg.layer_kinds)
                        if k in KERNEL_KINDS["flash_attention"]
                        + ("rwkv", "encdec"))
        for j in range(li):
            x, _, _ = TB.apply_layer(cfg, cfg.layer_kinds[j],
                                     params["layers"][j], x,
                                     positions=positions)
        p = params["layers"][li]
        xn = apply_norm(cfg, p["norm1"], x)
        if kind == "rwkv" and (one or rwkv._whole_heads(cfg, p["tmix"])):
            tmix = p["tmix"] if one else pl.local_tree(p["tmix"], i)
            ops = rwkv.wkv_inputs(cfg, tmix, xn if one else xn.locals[i])[:5]
        elif kind == "rwkv":
            pairs, u, _, _ = rwkv.pair_inputs(cfg, p["tmix"], xn)
            ops = (*(t.locals[i][0].transpose(0, 1)[None] for t in pairs),
                   u[i])
        elif one:
            ops = attention._project_qkv(cfg, p["attn"], xn, positions)
        elif attention.splits_rows(cfg, p["attn"]["wq"], xn.shape[1]):
            ks, vs = attention._sharded_kv(cfg, p["attn"], xn, positions)
            qs = attention._row_queries(cfg, p["attn"]["wq"], xn,
                                        positions if cfg.use_rope else None)
            rep = (ks.spec[0], None, None, None)
            ops = (qs.locals[i], pl.relayout(ks, rep).locals[i],
                   pl.relayout(vs, rep).locals[i])
            offset = qs.block(i, 1)[0]
        else:
            qs, ks, vs = attention._sharded_qkv(cfg, p["attn"], xn,
                                                positions)
            ops = (qs.locals[i], attention._kv_for_heads(qs, ks, i),
                   attention._kv_for_heads(qs, vs, i))
        return tuple(a.contiguous() for a in ops), kind, offset


def sharded_f32_check(torch, dev, smi_line, arch, batch, seq, n_dec,
                      layers=None, rel=F32_REL):
    """`arch` in f32 (TF32 off), whole or its first `layers` layers,
    weights drawn as in
    `sharded_lm_phase` (its frontend too), on each of its meshes of
    SHARDED_MESHES inside `use_mesh`: a prefill of batch x seq tokens and
    n_dec decode steps fed (1, 1)'s greedy tokens, the logits held
    against (1, 1)'s under `rel` relative L2 (in bf16 rwkv6-3b's
    rounding at full depth is as large as what a wrong column split,
    head slice or all-reduce would change; whisper-small's row-parallel
    head, encoder and cross-attention are held as closely). Returns the
    line for the summary."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decoder_lm as M
    from repro_torch.sharding import placement as pl
    from repro_torch.sharding import use_mesh

    full = get_config(arch)
    cfg = dataclasses.replace(full, dtype="float32", param_dtype="float32",
                              num_layers=layers or full.num_layers)
    toks = torch.from_numpy(synthetic_lm_batch(
        np.random.default_rng(2), batch, seq, cfg.vocab_size)[
        "tokens"]).long().to(dev)
    fe = draw_frontend(torch, dev, cfg, batch)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    ref, errs, t0 = None, {}, time.perf_counter()
    try:
        for data, model_ax in SHARDED_MESHES[arch]:
            gen = torch.Generator(dev).manual_seed(0)
            model = M.init_params(cfg, gen, device=dev)
            condition_weights(torch, cfg, model, gen)
            mesh = make_mesh((dev,) * (data * model_ax),
                             {"data": data, "model": model_ax})
            params = pl.shard_params(model, mesh, release=True)
            del model
            with use_mesh(mesh):
                last, cache = M.prefill_step(cfg, params, toks, frontend=fe,
                                             length=seq + n_dec)
                outs = [last]
                fed = (ref["tokens"] if ref is not None
                       else [last.argmax(-1, keepdim=True)])
                for t in range(n_dec):
                    lg, cache = M.decode_step(cfg, params, cache, fed[t],
                                              seq + t)
                    outs.append(lg[:, 0])
                    if ref is None:
                        fed.append(lg[:, 0].argmax(-1, keepdim=True))
            logits = torch.stack(outs).float()
            check(bool(torch.isfinite(logits).all()),
                  f"{arch} f32 mesh ({data}, {model_ax}) logits finite")
            if ref is None:
                ref = dict(logits=logits, tokens=fed)
            else:
                errs[data, model_ax] = (
                    rel_l2(logits[0], ref["logits"][0]),
                    rel_l2(logits[1:], ref["logits"][1:]),
                    float((logits.argmax(-1) == ref["logits"].argmax(-1)
                           ).float().mean()))
            del params, cache, outs, logits, last, lg
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    rows = frontend_rows(cfg)
    depth = ("whole" if layers is None
             else f"{layers} of {full.num_layers} layers")
    line = (f"{arch} {depth} in f32 on its meshes, prefill {batch} x {seq} "
            + (f"with {batch} x {rows} frontend rows " if rows else "")
            + f"and {n_dec} decode steps ({time.perf_counter() - t0:.1f} s), "
            f"against (1, 1): " + "; ".join(
                f"mesh (data {d}, model {m}) relative L2 of the prefill "
                f"logits {pre:.4g}, of the decode steps' {dec:.4g}, argmax "
                f"agreement {agree:.4f}"
                for (d, m), (pre, dec, agree) in errs.items())
            + f" (limit {rel}); {smi_line}")
    print(line)
    for (d, m), (pre, dec, _) in errs.items():
        check(pre < rel and dec < rel,
              f"{arch} f32 mesh (data {d}, model {m}) logits within "
              f"{rel} of (1, 1) ({pre}, {dec})")
    return line


def sharded_lm_phase(torch, dev, kernels, smi_line, measured=None):
    """The LMs tensor- and data-parallel (ROADMAP A item 4, 4a) on ("data",
    "model") meshes of the one card repeated (`make_mesh((dev,) * n,
    ...)`): the sharded path and its exchanges, not the capacity of n
    cards. Every model of SHARDED_MESHES at full width, its depth cut to
    SHARDED_LAYERS where it is named there, on each of its meshes: the
    dense `attn` models mistral-large-123b and gemma-7b, the MoE models
    dbrx-132b and grok-1-314b (experts FSDP over "data"), rwkv6-3b and
    recurrentgemma-9b, and the frontend models llama-3.2-vision-11b and
    whisper-small (SHARDED_SHAPES; the frontend drawn by
    `draw_frontend`, placed by `input_shardings`, B4's key-bound
    launches checked at position 0, `seed_frontend_cache` held to the
    placed prefill's xk / xv bit for bit and seeding the engine's cache);
    bf16, random weights from a CUDA generator seeded 0
    (conditioned as `condition_weights` says), made anew for each mesh and
    placed by `shard_params` (releasing the model as it goes). For each
    mesh: the path's kernel (B4, or B5 for rwkv) on position 0's operands
    of the first layer that runs it, at the per-position shape, against
    its plain version (`attention_check`, `wkv_check`); the main path
    inside `use_mesh`: prefill 4 x 2048 (the kernel once per layer and
    position), 16 decode steps fed the (1, 1) mesh's greedy tokens, on
    the TRACED meshes a traced prefill and decode step, and 4 requests
    through `LMServingEngine`. Prints prefill tokens/s, decode ms a step, the
    exchange's bytes (counted) and device ms (traced) for a prefill and
    a step, the bytes placed per position, for MoE the share of
    assignments dropped (held within MOE_DROP_GAP of (1, 1)'s), the
    relative L2 of the logits against (1, 1) (held under SHARDED_REL) and
    the greedy-token agreement with it; the analytic per-position
    parameter bytes of the full-depth mistral at model 4 and 8; and
    `sharded_f32_check`. Into `measured` (when given) goes each mesh's
    prefill ms and traced device busy ms, keyed (arch, "prefill", (data,
    model)). Returns (each kernel's launches in the prefills, the lines
    for the summary, B4's query-offset row)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decoder_lm as M
    from repro_torch.nn import moe
    from repro_torch.nn.params import count_params, tree_bytes
    from repro_torch.serving import LMServingEngine
    from repro_torch.sharding import placement as pl
    from repro_torch.sharding import use_mesh

    phase("sharded lm")
    t_phase = time.perf_counter()
    lines = []
    full = get_config("mistral-large-123b")
    ab, specs = M.abstract_params(full), M.param_specs(full)
    analytic = {m: tree_bytes(pl.abstract_placed(ab, specs, {"data": 1,
                                                            "model": m}))
                for m in (1, 4, 8)}
    line = (f"mistral-large-123b at full depth ({full.num_layers} layers, "
            f"{full.param_dtype}), analytic parameter bytes a position "
            f"(tree_bytes of the fitted shard shapes, nothing allocated): "
            + ", ".join(f"model {m}: {b} ({b / 1e9:.2f} GB)"
                        for m, b in analytic.items())
            + "; one card cannot measure capacity")
    print(line)
    lines.append(line)
    total = {name: 0 for name in KERNEL_KINDS}
    total_offset, offset_row = 0, None
    for arch, meshes in SHARDED_MESHES.items():
        t_arch = time.perf_counter()
        sh = SHARDED_SHAPES.get(arch, SHARDED_SHAPE)
        batch, seq, n_dec = sh["batch"], sh["seq"], sh["n_dec"]
        full = get_config(arch)
        cfg = (dataclasses.replace(full, num_layers=SHARDED_LAYERS[arch])
               if arch in SHARDED_LAYERS else full)
        per_pos = prefill_launches(cfg)
        is_moe = "attn_moe" in cfg.layer_kinds
        prompts = torch.from_numpy(synthetic_lm_batch(
            np.random.default_rng(0), batch, seq + 1, cfg.vocab_size)[
            "tokens"]).long().to(dev)
        toks = prompts[:, :seq]
        fe = draw_frontend(torch, dev, cfg, batch)
        rows = frontend_rows(cfg)
        ref = None
        for data, model_ax in meshes:
            torch.cuda.empty_cache()
            secs, t_mark = {}, time.perf_counter()

            def lap(what):
                nonlocal t_mark
                now = time.perf_counter()
                secs[what] = round(now - t_mark, 2)
                t_mark = now
            label = f"{arch} mesh (data {data}, model {model_ax})"
            gen = torch.Generator(dev).manual_seed(0)
            model = M.init_params(cfg, gen, device=dev)
            condition_weights(torch, cfg, model, gen)
            n_par = count_params(model)
            mesh = make_mesh((dev,) * (data * model_ax),
                             {"data": data, "model": model_ax})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params = pl.shard_params(model, mesh, release=True)
            torch.cuda.synchronize()
            t_place = time.perf_counter() - t0
            del model
            gc.collect()
            torch.cuda.empty_cache()
            placed = pl.position_bytes(params)
            print(f"{label}: {mesh}; {cfg.num_layers} of {full.num_layers} "
                  f"layers {cfg.layer_kinds[:3]}..., d_model {cfg.d_model}, "
                  f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
                  f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
                  f"{cfg.vocab_size}: {n_par} parameters ({n_par:.4g}); "
                  f"placed in {t_place:.2f} s, bytes a position (measured "
                  f"on the placed tensors) {placed}")
            lap("make and place")
            with use_mesh(mesh) as scope:
                # ---- the kernel at the per-position shape, position 0's
                # operands (the key-bound launches for a frontend)
                if fe is not None:
                    for what, *ops in frontend_operands(
                            torch, cfg, params, toks, fe, mesh):
                        lines.append(bounded_attention_check(
                            torch, *ops, f"flash_attention {label} {what}, "
                                         f"position 0")[1])
                    del ops
                else:
                    ops, kind, off = position_operands(torch, cfg, params,
                                                       toks, mesh)
                    if kind == "rwkv":
                        wkv_check(torch, *ops, f"wkv6 {label}, position 0")
                    else:
                        attention_check(torch, dev, cfg, *ops,
                                        f"flash_attention {label}, position "
                                        f"0", window=(cfg.sliding_window
                                                      if kind == "local"
                                                      else 0), q_offset=off)
                    del ops
                if (arch, (data, model_ax)) in OFFSET_CHECKS:
                    # B4's query-offset instances at the last position's
                    # rows of the first causal layer; deepseek's is the
                    # summary's row
                    last_pos = data * model_ax - 1
                    ops, _, off = position_operands(torch, cfg, params, toks,
                                                    mesh, last_pos)
                    row = attention_check(
                        torch, dev, cfg, *ops, f"flash_attention {label}, "
                        f"position {last_pos} (query offset)", q_offset=off)
                    if arch == "deepseek-coder-33b":
                        offset_row = dict(
                            row, name="flash_attention (query offset)",
                            note=f"(instances with a query offset > 0, timed "
                                 f"at {tuple(ops[0].shape)} rows from "
                                 f"position {off} of {ops[1].shape[1]} keys; "
                                 f"launched in the sharded prefills whose "
                                 f"rows split)")
                    del ops
                torch.cuda.empty_cache()
                lap("kernel check")
                # ---- the main path: prefill, decode, the engine
                M.prefill_step(cfg, params, toks[:, :128], frontend=fe)
                torch.cuda.synchronize()                        # warm
                scope.exchange.clear()
                zero_counts(kernels)
                if is_moe:
                    moe.apply_moe.drops = []
                t0 = time.perf_counter()
                last, cache = M.prefill_step(cfg, params, toks, frontend=fe,
                                             length=seq + n_dec + 1)
                torch.cuda.synchronize()
                t_prefill = time.perf_counter() - t0
                launches = launch_counts(kernels)
                n_offset = kernels["flash_attention"].offset_launches
                pre_ex = {k: dict(v) for k, v in scope.exchange.items()}
                want = {name: n * data * model_ax
                        for name, n in per_pos.items()}
                check(all(launches[n] == want.get(n, 0) for n in launches),
                      f"{label} prefill launched each kernel once per layer "
                      f"that runs it and position ({launches}, want {want})")
                want_offset = offset_launches(cfg, params, seq, data,
                                              model_ax)
                check(n_offset == want_offset,
                      f"{label} prefill launched B4's query-offset instances "
                      f"once per causal layer that splits its rows and "
                      f"position but the first along \"model\" ({n_offset}, "
                      f"want {want_offset})")
                for name in total:
                    total[name] += launches[name]
                total_offset += n_offset
                drops = None
                if is_moe:
                    drops = [int(d) for d, _ in moe.apply_moe.drops]
                    n_assign = sum(n for _, n in moe.apply_moe.drops)
                    moe.apply_moe.drops = None
                feed = (last.argmax(-1, keepdim=True) if ref is None
                        else ref["tokens"][0])
                outs, fed = [last], [feed]
                scope.exchange.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for t in range(n_dec):
                    lg, cache = M.decode_step(cfg, params, cache, fed[-1],
                                              seq + t)
                    outs.append(lg[:, 0])
                    fed.append(lg[:, 0].argmax(-1, keepdim=True)
                               if ref is None else ref["tokens"][t + 1])
                torch.cuda.synchronize()
                t_decode = time.perf_counter() - t0
                dec_ex = {k: dict(v) for k, v in scope.exchange.items()}
                seeded = ""
                if fe is not None:
                    # seed_frontend_cache on the mesh: the placed
                    # prefill's xk / xv, bit for bit, in the cache's layout
                    fresh = M.seed_frontend_cache(cfg, params, M.init_cache(
                        cfg, batch, seq + n_dec + 1, dev), fe)
                    n_x = sum(n in c for c in cache for n in ("xk", "xv"))
                    check(n_x > 0 and all(
                        c[n].spec == f[n].spec and all(
                            torch.equal(a, b)
                            for a, b in zip(c[n].locals, f[n].locals))
                        for c, f in zip(cache, fresh)
                        for n in ("xk", "xv") if n in c),
                        f"{label} seed_frontend_cache == the placed "
                        f"prefill's xk / xv, bit for bit")
                    seeded = (f"; seed_frontend_cache == the prefill's xk / "
                              f"xv bit for bit ({n_x} entries)")
                    del fresh
                lap("prefill and decode")
                # one traced step each, warm from the steps above, on
                # the TRACED meshes
                untraced = (data, model_ax) not in TRACED[arch]
                if not untraced:
                    wall, busy, ex_ms = exchange_profile(
                        torch, lambda: M.decode_step(cfg, params, cache,
                                                     fed[n_dec],
                                                     seq + n_dec))
                    pre_wall, pre_busy, pre_ms = exchange_profile(
                        torch, lambda: M.prefill_step(cfg, params, toks,
                                                      frontend=fe,
                                                      length=seq + n_dec
                                                      + 1))
                lap("traced step and prefill")
                check(all(bool(torch.isfinite(o).all()) for o in outs)
                      and last.shape == (batch, cfg.vocab_size),
                      f"{label} logits finite, shaped")
                eng = LMServingEngine(cfg, params, slots=4, max_len=64,
                                      device=dev)
                if fe is not None:     # the engine takes no frontend
                    eng.cache = M.seed_frontend_cache(cfg, params, eng.cache,
                                                      fe[:4])
                reqs = synthetic_lm_batch(np.random.default_rng(1), 4, 8,
                                          cfg.vocab_size)["tokens"]
                for r in reqs:
                    eng.submit(r.tolist(), max_new=8)
                t0 = time.perf_counter()
                stats = eng.run_until_drained()
                torch.cuda.synchronize()
                t_eng = time.perf_counter() - t0
                check(stats["completed"] == 4 and all(
                    len(r.out) == 8 for r in eng.completed),
                    f"{label} engine served every request ({stats})")
                served = sorted((r.rid, r.out) for r in eng.completed)
                del eng
                lap("engine")
            logits = torch.stack([o.float() for o in outs])
            if ref is None:
                ref = dict(logits=logits, tokens=fed, served=served,
                           drops=drops)
            err_pre = rel_l2(logits[0], ref["logits"][0])
            err_dec = rel_l2(logits[1:], ref["logits"][1:])
            agree = float((logits.argmax(-1) == ref["logits"].argmax(-1)
                           ).float().mean())
            eng_agree = float(np.mean([a == b for (_, x), (_, y) in zip(
                served, ref["served"]) for a, b in zip(x, y)]))

            def ex(d):
                return (f"{sum(v['bytes'] for v in d.values())} bytes in "
                        f"{sum(v['copies'] for v in d.values())} copies ("
                        + ", ".join(f"{k} {v['calls']} calls {v['bytes']} B"
                                    for k, v in sorted(d.items())) + ")")

            def traced(ms):
                return (", ".join(f"{k.split('.')[1]} {v:.4f}"
                                  for k, v in sorted(ms.items())) or "0") \
                    + f" (total {sum(ms.values()):.4f})"
            kern = ", ".join(f"{n} launches {launches[n]}" for n in want
                             if want[n]) + (
                f" ({n_offset} of them with a query offset)" if n_offset
                else "")
            gap = (None if drops is None else
                   sum(abs(a - b) for a, b in zip(drops, ref["drops"])))
            dropped = ("" if drops is None else
                       f"; MoE assignments dropped in the prefill "
                       f"{sum(drops)} of {n_assign} "
                       f"({sum(drops) / n_assign:.4f}; per layer {drops}; "
                       f"(1, 1) dropped {sum(ref['drops'])}, difference "
                       f"{sum(drops) - sum(ref['drops'])}, layer by layer "
                       f"{gap})")
            line = (f"{label}: prefill {batch} x {seq}"
                    + (f" with {batch} x {rows} frontend rows" if rows
                       else "")
                    + f" in {t_prefill:.3f} s, "
                    f"{batch * seq / t_prefill:.1f} tokens/s, {kern}, "
                    f"exchange {ex(pre_ex)}; "
                    + ("prefill not traced" if untraced else
                       f"traced prefill {pre_wall:.2f} ms wall, device busy "
                       f"{pre_busy:.2f} ms, exchange device ms "
                       f"{traced(pre_ms)}")
                    + f"; decode "
                    f"{1e3 * t_decode / n_dec:.2f} ms a step, exchange a "
                    f"step {ex({k: {n: x // n_dec for n, x in v.items()} for k, v in dec_ex.items()})}; "
                    + ("decode step not traced" if untraced else
                       f"traced decode step {wall:.2f} ms wall, device busy "
                       f"{busy:.2f} ms, exchange device ms {traced(ex_ms)}")
                    + "; "
                    f"engine 4 requests in {stats['ticks']} ticks, "
                    f"{32 / t_eng:.1f} generated tokens/s; bytes a position "
                    f"{placed}{dropped}; against (1, 1): relative L2 of the "
                    f"prefill logits {err_pre:.4g}, of the {n_dec} decode "
                    f"steps' {err_dec:.4g}, argmax agreement {agree:.4f}, "
                    f"engine token agreement {eng_agree:.4f}{seeded}; "
                    f"{smi_line}")
            print(line)
            lines.append(line)
            print(f"{label} seconds: {secs}")
            if measured is not None:
                measured[arch, "prefill", (data, model_ax)] = dict(
                    ms=1e3 * t_prefill, busy_ms=None if untraced else pre_busy)
            lim = SHARDED_REL[arch]
            check(err_pre < lim and err_dec < lim,
                  f"{label} logits within {lim} of (1, 1) "
                  f"({err_pre}, {err_dec})")
            if drops is not None:
                check(gap <= MOE_DROP_GAP * n_assign,
                      f"{label} prefill drops within {MOE_DROP_GAP} of the "
                      f"assignments of (1, 1)'s, layer by layer ({gap} of "
                      f"{n_assign})")
            del params, cache, outs, logits, last, lg
            gc.collect()
            torch.cuda.empty_cache()
        print(f"sharded lm {arch}: {time.perf_counter() - t_arch:.1f} s")
    for f32 in SHARDED_F32:
        lines.append(sharded_f32_check(torch, dev, smi_line, **f32))
    print(f"sharded lm phase: {time.perf_counter() - t_phase:.1f} s")
    check(total_offset > 0 and offset_row is not None,
          f"B4's query-offset instances launched in the sharded prefills "
          f"({total_offset}) and checked")
    offset_row["launches"] = total_offset
    return total, lines, offset_row


# adaptive decoding on a placed model: granite-34b at full width, 4 of 88
# layers, exit heads at blocks 0-2 (t_min 0, t_max 2), in f32 so that a
# mesh's exit decisions can be held to (1, 1)'s; random heads, the middle
# t_s the median of (1, 1)'s first-step saturation distances after
# blocks 0-2, so that tokens exit at several blocks
SHARDED_ADAPTIVE = dict(arch="granite-34b", layers=4, exits=(0, 1, 2),
                        batch=4, seq=2048, n_dec=16,
                        meshes=((1, 1), (1, 2), (2, 2)))


def sharded_adaptive_phase(torch, dev, kernels, smi_line):
    """Adaptive decoding on a placed model (ROADMAP A item 4a): granite-34b
    by SHARDED_ADAPTIVE in f32 (TF32 off), random weights from a CUDA
    generator seeded 0 (conditioned as `condition_weights` says), drawn
    anew for each mesh and placed by `shard_params(..., release=True)`.
    For each mesh: the bytes a position; B4's f32 kernel on position 0's
    q, k, v of layer 0 (causal MQA, the KV head whole on every position)
    against its plain version; the prefill (B4 once per layer and
    position); n_dec decode steps at full depth, then with
    `adaptive_decode_step` at t_s 0, the middle t_s and 1e9, each on the
    prompts' next tokens; on (1, 2) a traced prefill and adaptive step
    (the exchange's device ms); the adaptive engine (4 requests). Held against
    (1, 1): the exit blocks equal except tokens whose saturation lies
    within D2_MARGIN (relative) of t_s, at most MAX_NEAR_SHARE of them,
    the FLOPs share equal where no exit differs, the logits within
    F32_REL relative L2 (a lane from the step its exit differs on, if
    any, left out). Returns (B4's launches in the prefills, the
    lines for the summary)."""
    from repro_torch.common import AdaptiveDepthConfig
    from repro_torch.configs import get_config
    from repro_torch.core.adaptive_depth import (adaptive_decode_step,
                                                 saturation_distance)
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decoder_lm as M
    from repro_torch.nn import blocks as TB
    from repro_torch.serving import LMServingEngine
    from repro_torch.sharding import placement as pl
    from repro_torch.sharding import use_mesh

    phase("sharded adaptive granite-34b")
    t_phase = time.perf_counter()
    sa = SHARDED_ADAPTIVE
    full = get_config(sa["arch"])
    cfg = dataclasses.replace(
        full, num_layers=sa["layers"], dtype="float32",
        param_dtype="float32", adaptive=AdaptiveDepthConfig(
            enabled=True, exit_layers=sa["exits"], t_s=1e9, t_min=0,
            t_max=max(sa["exits"])))
    batch, seq, n_dec = sa["batch"], sa["seq"], sa["n_dec"]
    prompts = torch.from_numpy(synthetic_lm_batch(
        np.random.default_rng(0), batch, seq + n_dec, cfg.vocab_size)[
        "tokens"]).long().to(dev)
    toks = prompts[:, :seq]
    inputs = [prompts[:, seq + t:seq + t + 1] for t in range(n_dec)]
    reqs = synthetic_lm_batch(np.random.default_rng(1), 4, 8,
                              cfg.vocab_size)["tokens"]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    ref, lines, total = None, [], 0
    try:
        for data, model_ax in sa["meshes"]:
            t_mesh = time.perf_counter()
            label = (f"{sa['arch']} adaptive mesh (data {data}, model "
                     f"{model_ax})")
            gen = torch.Generator(dev).manual_seed(0)
            model = M.init_params(cfg, gen, device=dev)
            condition_weights(torch, cfg, model, gen)
            mesh = make_mesh((dev,) * (data * model_ax),
                             {"data": data, "model": model_ax})
            params = pl.shard_params(model, mesh, release=True)
            del model
            gc.collect()
            torch.cuda.empty_cache()
            placed = pl.position_bytes(params)
            with use_mesh(mesh) as scope:
                ops, _, _ = position_operands(torch, cfg, params, toks,
                                              mesh)
                attention_check(torch, dev, cfg, *ops,
                                f"flash_attention {label}, position 0")
                del ops
                M.prefill_step(cfg, params, toks[:, :128])       # warm
                torch.cuda.synchronize()
                scope.exchange.clear()
                zero_counts(kernels)
                t0 = time.perf_counter()
                last, cache = M.prefill_step(cfg, params, toks,
                                             length=seq + n_dec)
                torch.cuda.synchronize()
                t_prefill = time.perf_counter() - t0
                launches = launch_counts(kernels)
                pre_ex = sum(v["bytes"] for v in scope.exchange.values())
                want = cfg.num_layers * data * model_ax
                check(launches["flash_attention"] == want and all(
                    v == 0 for n, v in launches.items()
                    if n != "flash_attention"),
                    f"{label} prefill launched flash_attention once per "
                    f"layer and position ({launches}, want {want})")
                total += launches["flash_attention"]
                if ref is None:
                    # the first step's distance after each block, on the
                    # unplaced blocks of the mesh of one
                    with torch.no_grad():
                        lp = pl.local_tree(params)
                        x = M._embed_tokens(cfg, lp, inputs[0],
                                            torch.full_like(inputs[0], seq))
                        dist = []
                        for p, c in zip(lp["layers"], pl.local_tree(cache)):
                            x_new, _, _ = TB.apply_layer(
                                cfg, "attn", p, x, mode="decode", cache=c,
                                pos=seq)
                            dist.append(saturation_distance(x_new, x))
                            x = x_new
                    # halfway between the two middle distances, so that no
                    # token of that step lies at t_s
                    d = torch.cat(dist[:len(sa["exits"])]).sort().values
                    mid = float(d[len(d) // 2 - 1: len(d) // 2 + 1].mean())
                    t_list = (0.0, mid, 1e9)
                # full depth, then adaptive at each t_s, the same inputs
                scope.exchange.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = []
                for t in range(n_dec):
                    lg, cache = M.decode_step(cfg, params, cache, inputs[t],
                                              seq + t)
                    outs.append(lg[:, 0])
                torch.cuda.synchronize()
                t_full = time.perf_counter() - t0
                step_ex = sum(v["bytes"] for v in scope.exchange.values())
                runs = {}
                for t_s in t_list:
                    acfg = dataclasses.replace(cfg, adaptive=dataclasses.replace(
                        cfg.adaptive, t_s=t_s))
                    got = []
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for t in range(n_dec):
                        lg, cache, info = adaptive_decode_step(
                            acfg, params, cache, inputs[t], seq + t)
                        got.append((lg[:, 0], info))
                    torch.cuda.synchronize()
                    runs[t_s] = dict(
                        ms=1e3 * (time.perf_counter() - t0) / n_dec,
                        logits=torch.stack([g[0] for g in got]).float(),
                        blocks=torch.stack([g[1]["exit_block"]
                                            for g in got]),
                        sat=torch.stack([g[1]["saturation"] for g in got]),
                        saved=[float(g[1]["flops_saved_frac"])
                               for g in got])
                acfg = dataclasses.replace(cfg, adaptive=dataclasses.replace(
                    cfg.adaptive, t_s=mid))
                untraced = (data, model_ax) not in TRACED["granite-34b"]
                if not untraced:
                    wall, busy, ex_ms = exchange_profile(
                        torch, lambda: adaptive_decode_step(
                            acfg, params, cache, inputs[-1],
                            seq + n_dec - 1))
                    pre_wall, pre_busy, pre_ms = exchange_profile(
                        torch, lambda: M.prefill_step(cfg, params, toks,
                                                      length=seq + n_dec))
                eng = LMServingEngine(acfg, params, slots=4, max_len=64,
                                      adaptive=True, device=dev)
                for r in reqs:
                    eng.submit(r.tolist(), max_new=8)
                t0 = time.perf_counter()
                stats = eng.run_until_drained()
                torch.cuda.synchronize()
                t_eng = time.perf_counter() - t0
                check(stats["completed"] == 4 and all(
                    len(r.out) == 8 for r in eng.completed),
                    f"{label} adaptive engine served every request")
                served = sorted((r.rid, r.out) for r in eng.completed)
                del eng
            full_logits = torch.stack(outs).float()
            check(bool(torch.isfinite(full_logits).all()) and all(
                bool(torch.isfinite(r["logits"]).all())
                for r in runs.values()), f"{label} logits finite")
            if ref is None:
                ref = dict(full=full_logits, runs=runs, served=served,
                           saved=stats["mean_depth_flops_saved"])
            parts = []
            for t_s, r in runs.items():
                r0 = ref["runs"][t_s]
                differ = r["blocks"] != r0["blocks"]
                tol = D2_MARGIN * max(t_s, 1e-30)
                near = ((r["sat"] - t_s).abs() <= tol) | (
                    (r0["sat"] - t_s).abs() <= tol)
                n_diff, n_near = int(differ.sum()), int(near.sum())
                # a lane whose exit differs (in the margin) is compared no
                # more from that step on: its frozen state wrote other keys
                same = (differ.cumsum(0) == 0)[..., None]
                err = rel_l2(r["logits"] * same, r0["logits"] * same)
                hist = {int(b): int(n) for b, n in zip(*torch.unique(
                    r["blocks"], return_counts=True))}
                parts.append(
                    f"t_s {t_s:.6g}: {r['ms']:.2f} ms a step, exit blocks "
                    f"{hist}, flops_saved_frac {np.mean(r['saved']):.4f}, "
                    f"exits unlike (1, 1)'s {n_diff} (within the margin "
                    f"{n_near}) of {differ.numel()}, logits vs (1, 1) "
                    f"{err:.4g} (over {int(same.sum())} of {same.numel()} "
                    f"lane steps)")
                check(bool(near[differ].all())
                      and n_near <= MAX_NEAR_SHARE * differ.numel(),
                      f"{label} t_s {t_s}: exit blocks equal to (1, 1)'s "
                      f"outside the margin ({n_diff} differ, {n_near} near)")
                check(n_diff > 0 or r["saved"] == r0["saved"],
                      f"{label} t_s {t_s}: flops_saved_frac equal to "
                      f"(1, 1)'s")
                check(err < F32_REL, f"{label} t_s {t_s}: logits within "
                      f"{F32_REL} of (1, 1)'s ({err})")
            err_full = rel_l2(full_logits, ref["full"])
            check(err_full < F32_REL, f"{label} full-depth logits within "
                  f"{F32_REL} of (1, 1)'s ({err_full})")
            eng_agree = float(np.mean([a == b for (_, x), (_, y) in zip(
                served, ref["served"]) for a, b in zip(x, y)]))

            def traced(ms):
                return (", ".join(f"{k.split('.')[1]} {v:.4f}"
                                  for k, v in sorted(ms.items())) or "0")
            line = (f"{label}: f32, {cfg.num_layers} of {full.num_layers} "
                    f"layers, exits at blocks {sa['exits']}; bytes a "
                    f"position {placed}; prefill {batch} x {seq} in "
                    f"{t_prefill:.3f} s, {batch * seq / t_prefill:.1f} "
                    f"tokens/s, flash_attention launches "
                    f"{launches['flash_attention']}, exchange {pre_ex} bytes"
                    + (", not traced" if untraced else
                       f", traced {pre_wall:.2f} ms wall, device busy "
                       f"{pre_busy:.2f} ms, exchange device ms "
                       f"{traced(pre_ms)}")
                    + f"; decode at full depth {1e3 * t_full / n_dec:.2f} ms "
                    f"a step, exchange {step_ex // n_dec} bytes a step, "
                    f"logits vs (1, 1) {err_full:.4g}; "
                    + ("adaptive step not traced" if untraced else
                       f"traced adaptive step (t_s {mid:.6g}) {wall:.2f} ms "
                       f"wall, device busy {busy:.2f} ms, exchange device "
                       f"ms {traced(ex_ms)}")
                    + "; " + "; ".join(parts) + f"; engine (t_s {mid:.6g}) 4 "
                    f"requests in {stats['ticks']} ticks, {32 / t_eng:.1f} "
                    f"generated tokens/s, mean depth-FLOPs saved "
                    f"{stats['mean_depth_flops_saved']:.4f} ((1, 1) "
                    f"{ref['saved']:.4f}), token agreement with (1, 1) "
                    f"{eng_agree:.4f}; {time.perf_counter() - t_mesh:.1f} s;"
                    f" {smi_line}")
            print(line)
            lines.append(line)
            del params, cache, outs, runs, last, lg, full_logits
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"sharded adaptive phase: {time.perf_counter() - t_phase:.1f} s")
    return total, lines


# sharded training (ROADMAP A item 4a): granite-34b at full width, 3 of 88
# layers (at (2, 2) the parameters, bf16 gradients and f32 moments of the
# two "data" replicas take ~56 GB of the card; 4 layers would take ~68 GB
# before activations), exit heads at blocks 0-1, bf16, `build_train_step`
# with GRANITE_TRAIN's lr on synthetic_stream(0, 8, 128)
SHARDED_TRAIN = dict(arch="granite-34b", layers=3, exits=(0, 1), batch=8,
                     seq=128, steps=5, lr=GRANITE_TRAIN["lr"],
                     meshes=((1, 1), (1, 2), (1, 4), (2, 2)))
# limit of the relative distance of step 1's loss and grad_norm on a mesh
# to (1, 1)'s, in bf16 (each position's partial products round to bf16
# before the f32 all-reduce, so the sums round otherwise): about twice the
# largest an H100 gave (grad_norm 2.38e-4 at (1, 4), loss 3.57e-6 at
# (1, 2); "NVIDIA H100 80GB HBM3, 700.00 W")
SHARDED_TRAIN_BF16_REL = 5e-4
# the f32 step at smoke size on the card, per family: its meshes beside
# (1, 1) (rwkv6-3b's 2 heads split over model 2 at most)
SHARDED_TRAIN_F32 = {"gemma-7b": ((1, 2), (2, 2)),
                     "mistral-large-123b": ((1, 2), (2, 2)),
                     "dbrx-132b": ((1, 2), (2, 2)),
                     "grok-1-314b": ((1, 2), (2, 2)),
                     "rwkv6-3b": ((1, 2), (2, 1)),
                     "recurrentgemma-9b": ((1, 2), (2, 2)),
                     "llama-3.2-vision-11b": ((1, 2), (2, 2)),
                     "whisper-small": ((1, 2), (2, 2)),
                     "granite-34b": ((1, 2), (2, 2))}
TRAIN_F32_REL = 1e-4


def train_f32_checks(torch, dev, smi_line) -> str:
    """One f32 `build_train_step` step (TF32 off) at `smoke()` size for
    every family of SHARDED_TRAIN_F32 (granite-34b at 4 layers with exit
    heads at blocks 0-2), weights drawn on the host from a generator
    seeded 0 (conditioned as `condition_weights` says), placed trainable:
    on a CPU mesh of one position, on the card's (1, 1) and on its
    meshes; each leaf's parameter and moments after the update against
    the CPU's and (1, 1)'s within TRAIN_F32_REL relative L2, every copy
    of a block equal. The schedule's learning rate is 0 at the first
    step, so the parameters keep their values and the moments carry the
    gradients. Returns the line for the summary."""
    from repro_torch.common import AdaptiveDepthConfig
    from repro_torch.configs import get_config, smoke
    from repro_torch.data import synthetic_stream
    from repro_torch.launch.dryrun import build_train_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import decoder_lm as M
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import placement as pl
    from repro_torch.sharding import use_mesh

    def dist(a, b):      # a zero norm gain stays zero at lr 0
        return float((a - b).norm()) / max(float(b.norm()), 1e-30)

    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {}
    try:
        for arch, meshes in SHARDED_TRAIN_F32.items():
            cfg = smoke(get_config(arch))
            if arch == "granite-34b":
                cfg = dataclasses.replace(
                    cfg, num_layers=4, adaptive=AdaptiveDepthConfig(
                        enabled=True, exit_layers=GRANITE_EXITS, t_min=0,
                        t_max=2))
            raw = next(synthetic_stream(0, 4, 32, cfg.vocab_size, cfg))
            step, tc = build_train_step(cfg, learning_rate=3e-3,
                                        warmup_steps=0, total_steps=10)
            out = {}
            for run, where, (data, model_ax) in [
                    ("host", "cpu", (1, 1)), ("card", dev, (1, 1))] + [
                    ("card", dev, m) for m in meshes]:
                model = M.init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
                condition_weights(torch, cfg, model, torch.Generator())
                mesh = make_mesh((torch.device(where),) * (data * model_ax),
                                 {"data": data, "model": model_ax})
                params = pl.shard_params(model.to(where), mesh,
                                         trainable=True)
                opt = adamw_init(params, tc)
                with use_mesh(mesh):
                    step(params, opt, lm_batch(cfg, raw, where))
                check(pl.copies_equal((params, opt["mu"], opt["nu"])),
                      f"{arch} f32 step on ({data}, {model_ax}): every copy "
                      f"of a block equal")
                out[run, data, model_ax] = {
                    f"{k}.{path}": pl.gather(st, "cpu").detach()
                    for k, tree in (("p", params), ("mu", opt["mu"]),
                                    ("nu", opt["nu"]))
                    for path, st in pl.named_leaves(tree)}
            cpu, one = out.pop(("host", 1, 1)), out.pop(("card", 1, 1))
            worst[arch] = max([dist(one[n], cpu[n]) for n in cpu] + [
                dist(got[n], want[n]) for got in out.values()
                for want in (cpu, one) for n in want])
            check(worst[arch] <= TRAIN_F32_REL,
                  f"{arch} f32 placed training step vs (1, 1) and the CPU: "
                  f"worst relative L2 {worst[arch]} (limit {TRAIN_F32_REL})")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    line = (f"placed training, f32 smoke size, one build_train_step step on "
            f"the card's meshes against (1, 1) and the CPU, worst relative "
            f"L2 of a parameter or moment after the update "
            f"({time.perf_counter() - t0:.1f} s): " + ", ".join(
                f"{a} {SHARDED_TRAIN_F32[a]} {w:.3g}" for a, w in worst.items())
            + f" (limit {TRAIN_F32_REL}); {smi_line}")
    print(line)
    return line


def sharded_train_phase(torch, dev, kernels, smi_line, measured=None):
    """Training a placed LM (ROADMAP A item 4a): granite-34b by
    SHARDED_TRAIN, bf16, random weights from a CUDA generator seeded 0
    (conditioned as `condition_weights` says), drawn anew for each mesh and
    placed by `shard_params(..., trainable=True, release=True)`; the
    moments by `adamw_init` of the placed tree (f32: `_train_cfg`). For each
    mesh, inside `use_mesh`: one `loss_fn` backward and `sync_grads` (every
    gradient finite, each leaf's nonzero; the gradients' bytes), then
    `build_train_step`'s steps (the counted main path: B4 and B5 must not
    launch), every copy of every block equal after each, one more step
    traced. Prints the bytes a position (parameters, gradients, moments),
    the step ms (median of steps 2-5) and tokens/s, the peak memory, each
    step's loss and grad_norm, the exchange of step 2 (counted bytes) and
    of the traced step (device ms), the gradient sync apart; step 1's loss
    and grad_norm held within SHARDED_TRAIN_BF16_REL of (1, 1)'s, the loss
    at the last step below step 1's. Then `train_f32_checks`. Into
    `measured` (when given) goes each mesh's step ms and traced device busy
    ms, keyed (arch, "train", (data, model)). Returns the lines for the
    summary."""
    from repro_torch.common import AdaptiveDepthConfig
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_stream
    from repro_torch.launch.dryrun import build_train_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import decoder_lm as M
    from repro_torch.nn.params import count_params
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import placement as pl
    from repro_torch.sharding import use_mesh

    phase("sharded train granite-34b")
    t_phase = time.perf_counter()
    st_ = SHARDED_TRAIN
    full = get_config(st_["arch"])
    cfg = dataclasses.replace(
        full, num_layers=st_["layers"], adaptive=AdaptiveDepthConfig(
            enabled=True, exit_layers=st_["exits"], t_min=0,
            t_max=max(st_["exits"])))
    step, tc = build_train_step(cfg, learning_rate=st_["lr"], warmup_steps=1,
                                total_steps=st_["steps"], weight_decay=0.01)
    batches = []
    stream = synthetic_stream(0, st_["batch"], st_["seq"], cfg.vocab_size)
    for _ in range(st_["steps"] + 1):
        batches.append(lm_batch(cfg, next(stream), dev))
    tokens = st_["batch"] * st_["seq"]
    ref, lines = None, []
    for data, model_ax in st_["meshes"]:
        t_mesh = time.perf_counter()
        label = (f"{st_['arch']} train mesh (data {data}, model "
                 f"{model_ax})")
        torch.cuda.empty_cache()
        gen = torch.Generator(dev).manual_seed(0)
        model = M.init_params(cfg, gen, device=dev)
        condition_weights(torch, cfg, model, gen)
        n_par = count_params(model)
        mesh = make_mesh((dev,) * (data * model_ax),
                         {"data": data, "model": model_ax})
        params = pl.shard_params(model, mesh, release=True, trainable=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        opt = adamw_init(params, tc)
        by_param = pl.position_bytes(params)
        by_moments = [a + b for a, b in zip(pl.position_bytes(opt["mu"]),
                                             pl.position_bytes(opt["nu"]))]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        with use_mesh(mesh) as scope:
            # the gradients of step 1's batch, read before any update
            loss, _ = M.loss_fn(cfg, params, batches[0], remat=tc.remat)
            loss.backward()
            grads = pl.sync_grads(params)
            by_grad = pl.position_bytes(grads)
            bad = [path for path, g in pl.named_leaves(grads)
                   if not all(bool(torch.isfinite(b).all()) for b in g.locals)
                   or not any(bool((b != 0).any()) for b in g.locals)]
            check(not bad, f"{label}: every gradient finite, each leaf's "
                  f"nonzero (not: {bad})")
            check(pl.copies_equal(grads), f"{label}: every copy of a "
                  f"synced gradient equal")
            del loss, grads
            losses, norms, step_s = [], [], []
            for i in range(st_["steps"]):
                if i == 1:
                    scope.exchange.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, batches[i])
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                if i == 1:
                    ex = {k: dict(v) for k, v in scope.exchange.items()}
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                check(pl.copies_equal((params, opt["mu"], opt["nu"])),
                      f"{label}: every copy of every block equal after "
                      f"step {i + 1}")
            peak = torch.cuda.max_memory_allocated()
            wall, busy, ex_ms = exchange_profile(
                torch, lambda: step(params, opt, batches[st_["steps"]]))
        launches = launch_counts(kernels)
        check(all(v == 0 for v in launches.values()),
              f"{label}: no kernel launched in the training steps "
              f"({launches})")
        check(all(np.isfinite(losses + norms)), f"{label}: losses finite")
        check(losses[-1] < losses[0], f"{label}: the loss falls over "
              f"{st_['steps']} steps ({losses})")
        if ref is None:
            ref = dict(loss=losses[0], norm=norms[0])
        err_loss = abs(losses[0] - ref["loss"]) / abs(ref["loss"])
        err_norm = abs(norms[0] - ref["norm"]) / abs(ref["norm"])
        ms = 1e3 * float(np.median(step_s[1:]))
        sync = ex.get("grad_sync", {"bytes": 0, "copies": 0})
        act = {k: v for k, v in ex.items() if k != "grad_sync"}
        sync_ms = ex_ms.get("exchange.grad_sync", 0.0)
        act_ms = sum(v for k, v in ex_ms.items() if k != "exchange.grad_sync")
        line = (f"{label}: {cfg.num_layers} of {full.num_layers} layers, "
                f"exits at blocks {st_['exits']}, {n_par} parameters "
                f"({n_par:.4g}), {tc.moment_dtype} moments; bytes a position:"
                f" parameters {by_param}, gradients {by_grad}, moments "
                f"{by_moments}; step {ms:.1f} ms (median of steps 2-"
                f"{st_['steps']}), {tokens / ms * 1e3:.0f} training "
                f"tokens/s, batch {st_['batch']} x {st_['seq']}; peak memory "
                f"{peak / 1e9:.2f} GB; loss " + ", ".join(
                    f"{x:.4f}" for x in losses) + "; grad_norm " + ", ".join(
                    f"{x:.4f}" for x in norms)
                + f"; step 1 vs (1, 1): loss {err_loss:.3g}, grad_norm "
                f"{err_norm:.3g}; exchange of step 2: gradient sync "
                f"{sync['bytes']} bytes in {sync['copies']} copies, the "
                f"rest {sum(v['bytes'] for v in act.values())} bytes ("
                + ", ".join(f"{k} {v['calls']} calls {v['bytes']} B"
                            for k, v in sorted(act.items()))
                + f"); traced step {wall:.1f} ms wall, device busy "
                f"{busy:.1f} ms, exchange device ms: gradient sync "
                f"{sync_ms:.3f}, the rest {act_ms:.3f} (" + ", ".join(
                    f"{k.split('.')[1]} {v:.3f}" for k, v in sorted(
                        ex_ms.items()) if k != "exchange.grad_sync")
                + f"); B4 / B5 launches {launches['flash_attention']} / "
                f"{launches['wkv6']}; {time.perf_counter() - t_mesh:.1f} s;"
                f" {smi_line}")
        print(line)
        lines.append(line)
        if measured is not None:
            measured[st_["arch"], "train", (data, model_ax)] = dict(
                ms=ms, busy_ms=busy)
        check(err_loss < SHARDED_TRAIN_BF16_REL
              and err_norm < SHARDED_TRAIN_BF16_REL,
              f"{label}: step 1's loss and grad_norm within "
              f"{SHARDED_TRAIN_BF16_REL} of (1, 1)'s ({err_loss}, "
              f"{err_norm})")
        del params, opt, m
        gc.collect()
        torch.cuda.empty_cache()
    lines.append(train_f32_checks(torch, dev, smi_line))
    print(f"sharded train phase: {time.perf_counter() - t_phase:.1f} s")
    return lines


# a placed training state saved and resumed: whisper-small whole (full
# width and depth, the published config), bf16, trained placed on the
# (data, model) mesh `mesh`, cut after `cut` of `steps` steps, saved,
# loaded into a fresh placement and run on; then loaded onto `load_mesh`
PLACED_CKPT = dict(arch="whisper-small", mesh=(1, 2), load_mesh=(2, 2),
                   batch=8, seq=128, steps=4, cut=2, lr=1e-3,
                   prefill=(16, 224))
# the dry run's records beside the measurements of this run: granite-34b
# training at SHARDED_TRAIN's size and mistral-large-123b's prefill at the
# sharded LM phase's, each on two of the meshes those phases ran
DRYRUN_MESHES = ((1, 1), (1, 4))


def _leaf(tree, dotted: str):
    """The leaf of a nested dict (`read_tree`'s, int keys for list items)
    at a `named_leaves` path."""
    for part in dotted.split("."):
        tree = tree[int(part) if part.isdigit() else part]
    return tree


def placed_ckpt_phase(torch, dev, kernels, smi_line):
    """Checkpoints of a placed training state (ROADMAP A item 1) by
    PLACED_CKPT: whisper-small whole, bf16, random weights from a CUDA
    generator seeded 0 (conditioned as `condition_weights` says), placed
    on the (1, 2) mesh of the card by `shard_params(trainable=True)` with
    f32 moments (`adamw_init`), trained by `build_train_step` on
    `synthetic_stream` with its 1500-frame frontend. A run of 4 steps
    without a break; the same weights drawn again and run 2 steps, saved
    (`save_checkpoint` gathers each placed leaf to the CPU), the
    parameters and the state deleted and the cache emptied, loaded into
    a fresh placement (weights seeded 1) and run on for steps 3-4. Gates:
    every parameter block, both moments' blocks and the count bitwise
    the unbroken run's, the losses of steps 3-4 too; both models'
    prefills of 16 x 224 tokens and 16 x 1500 frames (B4 through its key
    bound) give the same logits bit for bit, B4 launched once per
    attention and position; the file loaded onto (2, 2) gathers every
    leaf to the file's arrays bit for bit. Prints the file's bytes and
    the save and load seconds, deletes the file. Returns (B4's launches
    in the prefills, the line for the summary)."""
    from repro_torch.checkpoint import (load_checkpoint, read_tree,
                                        save_checkpoint)
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_stream
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.launch.dryrun import build_train_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import decoder_lm as M
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import placement as pl
    from repro_torch.sharding import use_mesh

    pc = PLACED_CKPT
    phase(f"placed checkpoint {pc['arch']}")
    t_phase = time.perf_counter()
    cfg = get_config(pc["arch"])
    step, tc = build_train_step(cfg, learning_rate=pc["lr"], warmup_steps=1,
                                total_steps=pc["steps"], weight_decay=0.01)
    stream = synthetic_stream(0, pc["batch"], pc["seq"], cfg.vocab_size, cfg)
    batches = [lm_batch(cfg, next(stream), dev) for _ in range(pc["steps"])]

    def mesh_of(shape):
        data, model_ax = shape
        return make_mesh((dev,) * (data * model_ax),
                         {"data": data, "model": model_ax})
    mesh = mesh_of(pc["mesh"])

    def placed(on, seed):
        gen = torch.Generator(dev).manual_seed(seed)
        model = M.init_params(cfg, gen, device=dev)
        condition_weights(torch, cfg, model, gen)
        params = pl.shard_params(model, on, release=True, trainable=True)
        return params, adamw_init(params, tc)

    def run(params, opt, steps):
        losses = []
        with use_mesh(mesh):
            for i in steps:
                _, _, m = step(params, opt, batches[i])
                losses.append(float(m["loss"]))
        return losses

    def state_leaves(params, opt):
        return [(f"{k}.{path}", st) for k, tree in (
            ("params", params), ("opt.mu", opt["mu"]), ("opt.nu", opt["nu"]))
            for path, st in pl.named_leaves(tree)]

    label = (f"{pc['arch']} placed checkpoint, mesh (data {pc['mesh'][0]}, "
             f"model {pc['mesh'][1]})")
    params_a, opt_a = placed(mesh, 0)
    losses_a = run(params_a, opt_a, range(pc["steps"]))
    params_b, opt_b = placed(mesh, 0)
    losses_b = run(params_b, opt_b, range(pc["cut"]))
    path = REPO / "build" / "placed_state.ckpt"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(str(path), {"params": params_b, "opt": opt_b}, pc["cut"])
    t_save = time.perf_counter() - t0
    size = path.stat().st_size
    del params_b, opt_b
    gc.collect()
    torch.cuda.empty_cache()
    like, like_opt = placed(mesh, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, at = load_checkpoint(str(path), {"params": like, "opt": like_opt})
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    del like, like_opt
    check(at == pc["cut"], f"{label}: the file's step {at}")
    params_b, opt_b = state["params"], state["opt"]
    del state
    losses_b += run(params_b, opt_b, range(pc["cut"], pc["steps"]))
    a_leaves, b_leaves = (state_leaves(params_a, opt_a),
                          state_leaves(params_b, opt_b))
    differ = [n for (n, a), (_, b) in zip(a_leaves, b_leaves)
              if a.spec != b.spec or not all(
                  torch.equal(x, y) for x, y in zip(a.locals, b.locals))]
    check(not differ and len(a_leaves) == len(b_leaves)
          and torch.equal(opt_a["count"], opt_b["count"]),
          f"{label}: every parameter and moment block and the count after "
          f"the resumed steps {pc['cut'] + 1}-{pc['steps']} bitwise the "
          f"unbroken run's (differ: {differ[:5]})")
    check(losses_b == losses_a, f"{label}: the resumed losses {losses_b} "
          f"bitwise the unbroken run's {losses_a}")
    # both models' prefills, B4 with its key bound on the frames
    pb, ps = pc["prefill"]
    toks = torch.from_numpy(synthetic_lm_batch(
        np.random.default_rng(0), pb, ps, cfg.vocab_size)["tokens"]).long(
    ).to(dev)
    fe = draw_frontend(torch, dev, cfg, pb)
    zero_counts(kernels)
    with use_mesh(mesh):
        logits_a, _ = M.prefill_step(cfg, params_a, toks, frontend=fe)
        logits_b, _ = M.prefill_step(cfg, params_b, toks, frontend=fe)
    torch.cuda.synchronize()
    n_b4 = kernels["flash_attention"].launches
    want = 2 * prefill_launches(cfg)["flash_attention"] * len(mesh.devices)
    check(n_b4 == want, f"{label}: B4 launched {n_b4} times in the two "
          f"prefills (want {want}: once per attention and position)")
    check(bool(torch.isfinite(logits_a).all())
          and logits_a.shape == (pb, cfg.vocab_size)
          and torch.equal(logits_a, logits_b),
          f"{label}: the resumed model's prefill logits bitwise the "
          f"unbroken run's")
    del params_a, opt_a, params_b, opt_b, logits_a, logits_b, fe
    gc.collect()
    torch.cuda.empty_cache()
    # the same file onto another mesh
    like, like_opt = placed(mesh_of(pc["load_mesh"]), 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = load_checkpoint(str(path), {"params": like, "opt": like_opt})
    torch.cuda.synchronize()
    t_load2 = time.perf_counter() - t0
    del like, like_opt
    file, _ = read_tree(str(path))
    moved = state_leaves(state["params"], state["opt"])
    differ = [n for n, st in moved
              if not torch.equal(pl.gather(st, "cpu"), _leaf(file, n))]
    check(not differ and torch.equal(state["opt"]["count"],
                                     file["opt"]["count"]),
          f"{label}: the file loaded onto {pc['load_mesh']} gathers every "
          f"leaf to the file's arrays bit for bit (differ: {differ[:5]})")
    del state, file, moved
    os.remove(path)
    gc.collect()
    torch.cuda.empty_cache()
    line = (f"{label}: {cfg.num_layers} + {cfg.encoder_layers} layers, "
            f"bf16, f32 moments, batch {pc['batch']} x {pc['seq']} with "
            f"{cfg.encoder_seq} frames; losses {losses_a} unbroken, "
            f"{losses_b} cut after step {pc['cut']}, saved, loaded into a "
            f"fresh placement and resumed: every block of the state and the "
            f"losses bitwise equal, the {pb} x {ps} prefill logits bitwise "
            f"equal (B4 {n_b4} launches); file {size} bytes ({size / 1e9:.3f}"
            f" GB), saved in {t_save:.2f} s ({size / t_save / 1e9:.2f} GB/s "
            f"from the card to the disk), loaded onto {pc['mesh']} in "
            f"{t_load:.2f} s and onto {pc['load_mesh']} in {t_load2:.2f} s "
            f"(every leaf gathers to the file's arrays bitwise); the phase "
            f"{time.perf_counter() - t_phase:.1f} s; {smi_line}")
    print(line)
    return n_b4, line


def dryrun_lines(measured, smi_line):
    """The dry run (`launch.dryrun.lower_combo`, on `meta` devices, on the
    host's CPU) at the sizes this run measured: granite-34b's training at
    SHARDED_TRAIN's size and mistral-large-123b's prefill at the sharded
    LM phase's, on DRYRUN_MESHES; each record's data-sheet roofline terms
    beside the step or prefill ms and the traced device busy ms measured
    above (a mesh of n positions on the one card runs n positions' work,
    so its terms, which are a position's, go beside it times n). Returns
    the lines for the summary."""
    from repro_torch.common import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import lower_combo

    phase("dry run at this run's sizes")
    t_phase = time.perf_counter()
    st_ = SHARDED_TRAIN
    full = get_config(st_["arch"])
    train_cfg = dataclasses.replace(
        full, num_layers=st_["layers"], adaptive=dataclasses.replace(
            full.adaptive, enabled=True, exit_layers=st_["exits"], t_min=0,
            t_max=max(st_["exits"])))
    arch = "mistral-large-123b"
    sh = SHARDED_SHAPES.get(arch, SHARDED_SHAPE)
    prefill_cfg = dataclasses.replace(get_config(arch),
                                      num_layers=SHARDED_LAYERS[arch])
    combos = [(st_["arch"], train_cfg, ShapeConfig(
        "sharded_train", st_["seq"], st_["batch"], "train")),
        (arch, prefill_cfg, ShapeConfig("sharded_prefill", sh["seq"],
                                        sh["batch"], "prefill"))]
    lines = []
    for name, cfg, shape in combos:
        for data, model_ax in DRYRUN_MESHES:
            rec = lower_combo(name, shape.name, cfg=cfg, shape=shape,
                              mesh={"data": data, "model": model_ax},
                              verbose=False)
            r, mem = rec["roofline"], rec["memory"]
            got = measured.get((name, shape.mode, (data, model_ax)))
            n = data * model_ax
            terms = [1e3 * r[k] for k in ("t_compute_s", "t_memory_s",
                                          "t_collective_s")]
            line = (f"dry run {name} {shape.mode} {cfg.num_layers} of "
                    f"{get_config(name).num_layers} layers, batch "
                    f"{shape.global_batch} x {shape.seq_len}, mesh (data "
                    f"{data}, model {model_ax}): counted a position "
                    f"{r['hlo_flops_per_chip']:.4g} flops, "
                    f"{r['hlo_bytes_per_chip']:.4g} bytes of traffic, "
                    f"{r['collective_bytes_per_chip']:.4g} collective bytes,"
                    f" {mem['per_chip_gb']} GB held; roofline terms "
                    f"(H100 SXM data sheet, a position): compute "
                    f"{terms[0]:.3f} ms, memory {terms[1]:.3f} ms, "
                    f"collective {terms[2]:.3f} ms ({r['dominant']}); x {n} "
                    f"positions: {', '.join(f'{n * t:.3f}' for t in terms)}"
                    f" ms; measured in this run: " + (
                        "not measured" if got is None else
                        f"{'step' if shape.mode == 'train' else 'prefill'} "
                        f"{got['ms']:.2f} ms, device busy "
                        + ("not traced" if got["busy_ms"] is None
                           else f"{got['busy_ms']:.2f} ms"))
                    + f" (lower {rec['lower_s']} s, count "
                    f"{rec['compile_s']} s on the host); {smi_line}")
            print(line)
            lines.append(line)
    print(f"dry run: {time.perf_counter() - t_phase:.1f} s")
    return lines


# ROADMAP C.9, C.11 and C.12 on the card: one sequence prefilled with its
# inputs replicated over the data axes and decoded from a cache of
# long_500k's 524,288 positions split over "data" (split-key decode),
# rwkv6-3b's state split over its key and value dims, and an MoE model
# with its batch over ("pod", "data"); each model at full width, its
# depth cut (mistral 4 of 88 layers: 11.1 GB of bf16 weights and 8.6 GB
# of cache at (1, 1), twice the weights at (2, 1) and (2, 2), where
# every data position holds its copy; rwkv 12 of 32 and dbrx 2 of 40),
# to keep the run within its time. bf16 logits within SHARDED_REL of (1,
# 1)'s; rwkv's within about twice the 0.1517 an H100 gave at 12 layers
# ("NVIDIA H100 80GB HBM3, 700.00 W")
BATCH_ONE = (
    dict(arch="mistral-large-123b", layers=4, batch=1, seq=8192,
         length=524_288, n_dec=16,
         meshes=({"data": 1, "model": 1}, {"data": 2, "model": 1},
                 {"data": 2, "model": 2})),
    dict(arch="rwkv6-3b", layers=12, batch=1, seq=2048, length=None,
         n_dec=16, meshes=({"data": 1, "model": 1}, {"data": 2, "model": 2}),
         f32=True, bf16_rel=0.3),
    dict(arch="dbrx-132b", layers=2, batch=4, seq=2048, length=None,
         n_dec=16, meshes=({"data": 1, "model": 1},
                           {"pod": 2, "data": 2, "model": 1})))
# the argmax agreement with (1, 1) each batch-one and multi-pod mesh must
# reach (bf16 rwkv6-3b only reports it: its rounding grows with depth,
# 0.7353 at 12 layers in the sharded phase); the sharded phase's meshes
# gave 0.9559-1 ("NVIDIA H100 80GB HBM3, 700.00 W")
BATCH_ONE_AGREE = 0.9
# rows of B4's check at the batch-one prefill's per-position shape: the
# first and the last rows of 8,192 (the plain version's scores of all
# rows would take 13 GB)
LONG_ROWS = 1024


def _axes_label(axes) -> str:
    return "(" + ", ".join(f"{a} {n}" for a, n in axes.items()) + ")"


def long_attention_check(torch, q, k, v, label):
    """B4 at a long causal prefill's per-position shape (1, S, H, hd)
    against its plain version on LONG_ROWS rows at each end (rows 0.. of
    the keys up to them; the last rows with their query offset against
    all S keys, which is what the causal mask lets them read), within
    `attention_check`'s bf16 tolerance; the kernel and SDPA timed at the
    whole shape. Returns the line."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     ref_attention)
    S, n = q.shape[1], LONG_ROWS
    out = flash_attention(q, k, v)
    first = ref_attention(q[:, :n], k[:, :n], v[:, :n])
    last = ref_attention(q[:, -n:], k, v, q_offset=S - n)
    torch.cuda.synchronize()
    err = max(float((out[:, :n].float() - first.float()).abs().max()),
              float((out[:, -n:].float() - last.float()).abs().max()))
    atol = 2.0 ** -8 * float(v.float().abs().max())
    check(torch.allclose(out[:, :n].float(), first.float(), rtol=2.0 ** -7,
                         atol=atol)
          and torch.allclose(out[:, -n:].float(), last.float(),
                             rtol=2.0 ** -7, atol=atol),
          f"{label}: flash_attention vs plain on the first and last {n} "
          f"rows, max abs err {err}")
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    ms = time_ms(torch, lambda: flash_attention(q, k, v), reps=5)
    sdpa = time_ms(torch, lambda: torch.nn.functional.
                   scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                enable_gqa=True), reps=5)
    B_, _, H, hd = q.shape
    flops = 4 * B_ * H * (S * (S + 1) // 2) * hd
    b_ms, by = bound((2 * q.numel() + 2 * k.numel()) * q.element_size(),
                     flops, PEAK_BF16_FLOP_S)
    line = (f"{label}: B {B_}, S {S}, {H} q heads, {k.shape[2]} kv heads, "
            f"hd {hd}, causal; max abs err vs plain on rows 0-{n - 1} and "
            f"{S - n}-{S - 1} {err:.3g} (atol {atol:.3g}); kernel {ms:.4f} "
            f"ms ({b_ms / ms:.1%} of its bound {b_ms:.4f} ms, {by}), SDPA "
            f"{sdpa:.4f} ms")
    print(line)
    return line


def _ex_text(d) -> str:
    """A counted exchange: bytes and copies in all, then by op."""
    return (f"{sum(v['bytes'] for v in d.values())} bytes in "
            f"{sum(v['copies'] for v in d.values())} copies ("
            + ", ".join(f"{k} {v['calls']} calls {v['bytes']} B"
                        for k, v in sorted(d.items())) + ")")


def _traced_text(ms) -> str:
    return (", ".join(f"{k.split('.')[1]} {v:.4f}"
                      for k, v in sorted(ms.items())) or "0") \
        + f" (total {sum(ms.values()):.4f})"


def placed_run(torch, dev, kernels, cfg, axes, toks, length, n_dec,
               feed=None, label=""):
    """`cfg` drawn (a CUDA generator seeded 0, `condition_weights`),
    placed on a mesh of the card repeated by `axes` (`shard_params`,
    releasing the model) and run inside `use_mesh`: after a warm prefill
    of 128 tokens, the kernel on position 0's operands of its first
    layer (B4 at the whole prompt's rows by `long_attention_check`, B5 by
    `wkv_check`), then the main path with the launch counters zeroed
    before it: a prefill of `toks` into a cache of `length` positions
    (default the prompt and the decode steps) and `n_dec` decode steps
    fed `feed` (greedy where None), then one traced decode step. Returns
    a dict of what it measured."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decoder_lm as M
    from repro_torch.nn import moe
    from repro_torch.sharding import placement as pl
    from repro_torch.sharding import use_mesh
    seq = toks.shape[1]
    length = length or seq + n_dec + 1
    gen = torch.Generator(dev).manual_seed(0)
    model = M.init_params(cfg, gen, device=dev)
    condition_weights(torch, cfg, model, gen)
    mesh = make_mesh((dev,) * int(np.prod(list(axes.values()))), axes)
    params = pl.shard_params(model, mesh, release=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    placed = pl.position_bytes(params)
    is_moe = "attn_moe" in cfg.layer_kinds
    out = dict(placed=placed)
    with use_mesh(mesh) as scope:
        M.prefill_step(cfg, params, toks[:, :128])
        torch.cuda.synchronize()                                # warm
        ops, kind, _ = position_operands(torch, cfg, params, toks, mesh)
        if kind == "rwkv":
            wkv_check(torch, *ops, f"wkv6 {label}, position 0")
        else:
            out["kernel_line"] = long_attention_check(
                torch, *ops, f"flash_attention {label}, position 0")
        del ops
        torch.cuda.empty_cache()
        scope.exchange.clear()
        zero_counts(kernels)
        if is_moe:
            moe.apply_moe.drops = []
        t0 = time.perf_counter()
        last, cache = M.prefill_step(cfg, params, toks, length=length)
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        out["launches"] = launch_counts(kernels)
        out["offset_launches"] = kernels["flash_attention"].offset_launches
        out["prefill_ex"] = {k: dict(v) for k, v in scope.exchange.items()}
        if is_moe:
            out["drops"] = [int(d) for d, _ in moe.apply_moe.drops]
            out["assignments"] = sum(n for _, n in moe.apply_moe.drops)
            moe.apply_moe.drops = None
        fed = [last.argmax(-1, keepdim=True) if feed is None else feed[0]]
        outs = [last]
        scope.exchange.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n_dec):
            lg, cache = M.decode_step(cfg, params, cache, fed[-1], seq + t)
            outs.append(lg[:, 0])
            fed.append(lg[:, 0].argmax(-1, keepdim=True) if feed is None
                       else feed[t + 1])
        torch.cuda.synchronize()
        out["decode_ms"] = 1e3 * (time.perf_counter() - t0) / n_dec
        out["decode_ex"] = {k: {n: x // n_dec for n, x in v.items()}
                            for k, v in scope.exchange.items()}
        out["specs"] = {n: t.spec for c in cache[:1] for n, t in c.items()}
        out["traced"] = exchange_profile(torch, lambda: M.decode_step(
            cfg, params, cache, fed[n_dec], seq + n_dec))
    out["logits"] = torch.stack([o.float() for o in outs])
    out["tokens"] = fed
    check(bool(torch.isfinite(out["logits"]).all())
          and last.shape == (toks.shape[0], cfg.vocab_size),
          f"{label} logits finite, shaped")
    del params, cache, outs, last, lg
    gc.collect()
    torch.cuda.empty_cache()
    return out


def batch_one_phase(torch, dev, kernels, smi_line):
    """ROADMAP C.9, C.12 and C.11 on meshes of the one card repeated
    (BATCH_ONE; bf16 unless named): mistral-large-123b prefills one
    sequence of 8,192 tokens into a cache of long_500k's 524,288
    positions, its inputs and prefill replicated over "data", the cache
    split over "data" on its sequence, and decodes 16 steps (split-key
    decode, the combine's gather of (m, l, P.v)); rwkv6-3b at batch 1
    with its state over its key dim ("data") and value dim ("model"),
    in bf16 and in f32; dbrx-132b with its batch of 4 over ("pod",
    "data"). Each mesh against the (1, 1) mesh on the same tokens (fed
    (1, 1)'s greedy tokens): the logits within SHARDED_REL (f32 within
    F32_REL) and the argmax agreement, B4 / B5 launched once per layer
    that runs it and position in the prefill, MoE drops within
    MOE_DROP_GAP of (1, 1)'s; prints the prefill's and a decode step's
    time, the traced step's device busy ms, the exchange (counted bytes
    by op, traced device ms) and the cache's layouts. Returns (each
    kernel's launches in the prefills, the lines for the summary)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batch

    phase("batch one and multi-pod")
    t_phase = time.perf_counter()
    total, lines = {name: 0 for name in KERNEL_KINDS}, []
    for job in BATCH_ONE:
        arch, full = job["arch"], get_config(job["arch"])
        runs = [(full.dtype, job)]
        if job.get("f32"):
            runs.append(("float32", job))
        for dtype, _ in runs:
            cfg = dataclasses.replace(full, num_layers=job["layers"],
                                      dtype=dtype, param_dtype=dtype)
            toks = torch.from_numpy(synthetic_lm_batch(
                np.random.default_rng(0), job["batch"], job["seq"],
                cfg.vocab_size)["tokens"]).long().to(dev)
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            ref = None
            try:
                for axes in job["meshes"]:
                    t_mesh = time.perf_counter()
                    label = (f"{arch} {dtype} batch {job['batch']} mesh "
                             f"{_axes_label(axes)}")
                    r = placed_run(torch, dev, kernels, cfg, axes, toks,
                                   job["length"], job["n_dec"],
                                   None if ref is None else ref["tokens"],
                                   label)
                    n_pos = int(np.prod(list(axes.values())))
                    per_pos = prefill_launches(cfg)
                    want = {n: k * n_pos for n, k in per_pos.items()}
                    check(all(r["launches"][n] == want.get(n, 0)
                              for n in r["launches"]),
                          f"{label} prefill launched each kernel once per "
                          f"layer that runs it and position "
                          f"({r['launches']}, want {want})")
                    for n in total:
                        total[n] += r["launches"][n]
                    if ref is None:
                        ref = r
                    lg, lg0 = r["logits"], ref["logits"]
                    err_pre, err_dec = rel_l2(lg[0], lg0[0]), \
                        rel_l2(lg[1:], lg0[1:])
                    agree = float((lg.argmax(-1) == lg0.argmax(-1)).float()
                                  .mean())
                    wall, busy, ex_ms = r["traced"]
                    dropped = ""
                    if "drops" in r:
                        gap = sum(abs(a - b) for a, b in
                                  zip(r["drops"], ref["drops"]))
                        dropped = (f"; MoE assignments dropped in the "
                                   f"prefill {sum(r['drops'])} of "
                                   f"{r['assignments']} (per layer "
                                   f"{r['drops']}; (1, 1) "
                                   f"{sum(ref['drops'])}, layer by layer "
                                   f"{gap})")
                        check(gap <= MOE_DROP_GAP * r["assignments"],
                              f"{label} prefill drops within "
                              f"{MOE_DROP_GAP} of the assignments of "
                              f"(1, 1)'s ({gap})")
                    line = (f"{label}: {cfg.num_layers} of "
                            f"{full.num_layers} layers, prefill "
                            f"{job['batch']} x {job['seq']} into a cache of "
                            f"{job['length'] or job['seq'] + job['n_dec'] + 1} "
                            f"in {r['prefill_s']:.3f} s "
                            f"({job['batch'] * job['seq'] / r['prefill_s']:.1f} "
                            f"tokens/s), launches {r['launches']}, exchange "
                            f"{_ex_text(r['prefill_ex'])}; decode "
                            f"{r['decode_ms']:.2f} ms a step, exchange a step "
                            f"{_ex_text(r['decode_ex'])}; traced decode step "
                            f"{wall:.2f} ms wall, device busy {busy:.2f} ms, "
                            f"exchange device ms {_traced_text(ex_ms)}; "
                            f"cache layouts (layer 0) "
                            + ", ".join(f"{n} {s}" for n, s in
                                        r["specs"].items())
                            + f"; bytes a position {r['placed']}{dropped}; "
                            f"against (1, 1): relative L2 of the prefill "
                            f"logits {err_pre:.4g}, of the {job['n_dec']} "
                            f"decode steps' {err_dec:.4g}, argmax agreement "
                            f"{agree:.4f}; {time.perf_counter() - t_mesh:.1f}"
                            f" s; {smi_line}")
                    print(line)
                    lines.append(line)
                    if "kernel_line" in r:
                        lines.append(r["kernel_line"])
                    lim = (F32_REL if dtype == "float32" else
                           job.get("bf16_rel", SHARDED_REL[arch]))
                    check(err_pre < lim and err_dec < lim,
                          f"{label} logits within {lim} of (1, 1) "
                          f"({err_pre}, {err_dec})")
                    check(agree >= BATCH_ONE_AGREE or (
                        arch == "rwkv6-3b" and dtype != "float32"),
                          f"{label} argmax agreement with (1, 1) {agree} "
                          f">= {BATCH_ONE_AGREE}")
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"batch one and multi-pod phase: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return total, lines


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.nap_exit import nap_exit
    from repro_torch.kernels.nap_step import nap_step_fused
    from repro_torch.kernels.spmm import spmm_block_ell
    from repro_torch.kernels.wkv6 import wkv6
    kernels = {"spmm_block_ell": spmm_block_ell,
               "nap_step_fused": nap_step_fused, "nap_exit": nap_exit,
               "wkv6": wkv6, "flash_attention": flash_attention}

    # ------------------------------------------------------------ device
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    smi_line = smi.splitlines()[0]
    print(smi_line)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{name} count {torch.cuda.device_count()}")

    # ------------------------------------------------------------- build
    phase("build")
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        scale = ScaleStore(tmp)       # made while the kernels build
        try:
            t0 = time.perf_counter()
            lib_path = build.build_library()
            build.library()
            print(f"built {lib_path.name} in "
                  f"{time.perf_counter() - t0:.1f}s")
            for line in Path(str(lib_path) + ".log").read_text(
                    ).splitlines():
                if ("registers" in line or "spill" in line
                        or line.startswith("==")):
                    print("  " + line.strip())
            t0 = time.perf_counter()
            scale.wait()
            print(f"the scale store's process ended "
                  f"{time.perf_counter() - t0:.1f} s after the build")
            rows, train = gnn_phases(torch, dev, kernels, tmp, scale)
        finally:
            scale.stop()
    torch.cuda.empty_cache()
    # depth 4 of 32 and 5 of 38 layers: the end-to-end gates' f32
    # token-by-token reference is a decode step per token and layer (76.1
    # and 116.4 s whole on an H100 host, "NVIDIA H100 80GB HBM3, 700.00 W",
    # where the rest of each phase took 10.8 and 18.0 s); recurrentgemma-
    # 9b's 5 are one (rglru, rglru, local) repeat and its two rglru, whose
    # band the 2200-token prompts pass. Limits, f32 and bf16: about twice
    # the largest error an H100 gave at these depths (rwkv6-3b 1.653e-05
    # and 0.0484, recurrentgemma-9b 1.796e-06 and 0.009207)
    rows.append(lm_phases(torch, dev, kernels, "rwkv6-3b", 4, 4, 2048, 2048,
                          4e-5, 0.1, smi_line))
    rows.append(lm_phases(torch, dev, kernels, "recurrentgemma-9b", 5, 2,
                          4096, 2200, 4e-6, 0.02, smi_line))
    # MoE (ROADMAP A10.1), after the dense models are freed; B4's row adds
    # their prefills' launches
    b4 = rows[-1]
    parts = [f"{b4['launches']} {b4['note']}"]
    for arch, bf16_rel in MOE_BF16_REL.items():
        n = moe_phase(torch, dev, kernels, arch, bf16_rel, smi_line)
        b4["launches"] += n
        parts.append(f"{n} in one {arch} prefill of 4 x 2048 tokens")
    # cross-attention and encoder models (ROADMAP A10.2), full width and
    # depth; B4's row adds their prefills' launches
    bounded = []
    for arch, shp in XATTN_SHAPES.items():
        n, lines = xattn_phase(torch, dev, kernels, arch, smi_line)
        b4["launches"] += n
        parts.append(f"{n} in one {arch} prefill of {shp['batch']} x "
                     f"{shp['seq']} tokens")
        bounded += lines
    # the LM's train -> checkpoint -> adaptive serve path (ROADMAP
    # A10.3-A10.5) on granite-34b at full width; B4's row adds its prefill
    n, lines = adaptive_phase(torch, dev, kernels, smi_line)
    b4["launches"] += n
    parts.append(f"{n} in one granite-34b prefill of 4 x 2048 tokens")
    bounded += lines
    # the dense attn LMs tensor- and data-parallel (ROADMAP A item 4) on
    # meshes of the one card; B4's row adds their prefills' launches
    measured = {}      # the times the dry run's lines go beside
    n, lines, offset_row = sharded_lm_phase(torch, dev, kernels, smi_line,
                                            measured)
    b4["launches"] += n["flash_attention"]
    parts.append(f"{n['flash_attention']} in the sharded prefills (once "
                 f"per attention layer and mesh position, twice per "
                 f"encdec layer)")
    # adaptive decoding on a placed granite-34b (ROADMAP A item 4a)
    n_a, lines_a = sharded_adaptive_phase(torch, dev, kernels, smi_line)
    b4["launches"] += n_a
    parts.append(f"{n_a} in the placed granite-34b prefills of 4 x 2048 "
                 f"tokens (f32)")
    bounded += lines_a
    # training a placed granite-34b (ROADMAP A item 4a): no kernel runs in
    # its steps (B4 and B5 have no backward)
    bounded += sharded_train_phase(torch, dev, kernels, smi_line, measured)
    # a placed training state saved and resumed (ROADMAP A item 1); B4's
    # row adds its prefills' launches
    n_c, line_c = placed_ckpt_phase(torch, dev, kernels, smi_line)
    b4["launches"] += n_c
    parts.append(f"{n_c} in the placed whisper-small prefills after the "
                 f"checkpoint")
    bounded.append(line_c)
    # the dry run (ROADMAP A11) beside what this run measured
    bounded += dryrun_lines(measured, smi_line)
    # a batch the data axes do not divide and the MoE over ("pod",
    # "data") (ROADMAP C.9, C.11, C.12); B4's and B5's rows add their
    # prefills' launches
    n_b, lines_b = batch_one_phase(torch, dev, kernels, smi_line)
    b4["launches"] += n_b["flash_attention"]
    parts.append(f"{n_b['flash_attention']} in the batch-one mistral and "
                 f"multi-pod dbrx prefills")
    bounded += lines_b
    b5 = next(r for r in rows if r["name"] == "wkv6")
    b5["launches"] += n["wkv6"] + n_b["wkv6"]
    b5["note"] = (f"({b5['launches'] - n['wkv6'] - n_b['wkv6']} "
                  f"{b5['note']}, {n['wkv6']} in the sharded rwkv6-3b "
                  f"prefills of 4 x 2048 tokens (once per layer and mesh "
                  f"position), {n_b['wkv6']} in its batch-one prefills)")
    bounded += lines
    b4["note"] = f"({', '.join(parts)})"
    rows.append(offset_row)
    # training last, so that nothing it leaves behind (pinned pools, its
    # subprocesses) runs beside the LM phases' timings
    torch.cuda.empty_cache()
    train()

    phase("kernel summary")
    line = {"kernels": []}
    for r in rows:
        ms, by = r["bound"]
        lib = r["library_ms"]
        print(f"{r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library "
              f"{'n/a' if lib is None else '%.4f ms' % lib}, bound "
              f"{ms:.4f} ms ({by}; kernel at {ms / r['ms']:.1%} of it), "
              f"launches {r['launches']} {r['note']}, "
              f"max abs err {r['max_abs_err']:.3g}; one call per event "
              f"pair: kernel {r['ms_one_call']:.4f} ms, library "
              f"{'n/a' if lib is None else '%.4f ms' % r['library_ms_one_call']}"
              + ("" if "device_ms" not in r else
                 f"; device time (CUDA graph): kernel {r['device_ms']:.4f} "
                 f"ms, library {r['library_device_ms']:.4f} ms"))
        line["kernels"].append(dict(
            name=r["name"], route="cuda", source=r["source"],
            replaces=r["replaces"], launches=r["launches"],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=ms, bound_by=by,
            library_ms=r["library_ms"]))
    for text in bounded:
        print(text)
    print(smi_line)
    print(json.dumps(BUDGET.line()))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
