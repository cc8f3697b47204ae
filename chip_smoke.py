#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout.  Phases, each printing its lines:

1. device: the card's name and power limit (nvidia-smi);
2. build: ``nvcc`` for every kernel source, in parallel, with each
   variant's registers, static shared memory and spills;
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, in fp32 and bf16, with the kernel's, the plain version's and a
   PyTorch yardstick's times and the card's bound:
   * flash-decode and causal prefill (the sequential path) at the serving
     path's shapes (BASE and SMALL heads, prefill buckets 4..256 at
     offsets in a 1024-slot cache, decode at ragged lengths up to 1024)
     and at minitron-4b's attention shape (24 query heads over 8 kv
     heads, hd 128: prefill S=2048, a 256-query chunk at 1792 over 2048
     keys, decode B=8 over 4096), with #2's split over keys;
   * flash-decode with a sliding window (``decode_attention window``) at
     hymba-1.5b's heads (25 over 5, hd 64; B=8 over 4096, window 2048),
     starcoder2-7b's (36 over 4, hd 128; B=8 over 8192, window 4096) and
     a ragged batch whose lengths fall below, at and above the window,
     beside the unwindowed launch of the same cache, SDPA with the same
     boolean mask and the byte bound of the window's keys;
   * the SSD scan (the ssm and hybrid paths) at mamba2-1.3b's heads (H
     64, P 64, N 128, one group) over one ragged chunk (L 7 and 37), one
     full chunk, 300 tokens padded to 384 and 2048 tokens, and at
     hymba-1.5b's mixer heads (H 50, P 64, N 16) at L 37 and 2048, against
     its plain version
     and the sequential oracle, with a state-resume case and the reduced
     G > 1 shapes of tests/test_kernels.py; at L 37 and 2048 also a scan's
     device time (torch.profiler, its launches summed) and its plan
     (route, each launch's grid, registers and shared memory, the
     scratch), held to the Python mirror; no single PyTorch call computes
     the scan, so it has no yardstick;
   * paged flash-decode and paged span attention (the continuous path)
     over shuffled 16-token pages with ragged lengths (0 and 1 among
     them) and two rows aliasing one page, spans T of 5, 16, 64 and 256
     with span_len < T, and minitron-4b's shape: B=8 over 4096 tokens
     (256 pages a row), T = 5 (gamma + 1) and a 64-query chunk; the
     yardstick is SDPA over the pre-gathered dense K/V (gather excluded);
   * the same two with a sliding window (``paged_decode_attention
     window``, ``paged_append_attention window``) at starcoder2-7b's
     heads (36 over 4, hd 128) with its window 4096: decode B=8 over
     8192 and spans T = 64 and 5 over 8192 committed keys, each beside
     the unwindowed launch of the same inputs; and at granite-moe-1b's
     heads (16 over 8, hd 64, no window): decode B=8 over 4096, spans T
     = 64 and 5 over 4096; SDPA with the same boolean mask, a window's
     bound counting its keys only;
   * ``paged_tp`` (#3 and #4 as one rank's launch at tp=2) at one
     rank's share of minitron-4b's heads, 12 over 4: decode B=8 over
     4096, spans T = 64 and 5 over the same context, fp32 and bf16;
   * the cross-attention families' shapes: #2 non-causal over
     whisper-base's encoder (S 1500 over 1500 keys, 8 over 8 heads, hd
     64) and a 64-token cross prefill over its 1500 frames and over
     llama-3.2-vision-11b's 1601 patches (32 over 8, hd 128), #1 over
     the same cross K/V (G 1 and G 4; no 32-key tile divides 1500 or
     1601), SDPA over the same K/V as the yardstick;
   * the causal attention backward (2b) in fp32 at BASE's and SMALL's
     training shapes and minitron-4b's heads over S = 256 to 4096, with
     SDPA's autograd backward as the yardstick;
4. main path, sequential: random-init BASE/SMALL checkpoints written by
   the port, served by ``repro_torch.launch.serve --scheme specreason``
   on the card through its default fused decode loop (CUDA graphs with
   flash-decode inside), 3 requests, greedy and at temperature 0.6;
   launches of the dense kernels must equal n_layers x the engines'
   metered decode steps (a graph replay counts the launches it ran) and
   prefill calls, and the greedy run must see the verifier both accept
   and reject a drafted step;
   fused: the same 3 requests on one engine pair, greedy and at 0.6, in
   turns fused, eager, fused: identical tokens in every turn,
   decode launches == n_layers x decode steps, each engine's graphs over
   one KV pair (one capture per key, none in the second fused turn), at
   most ceil(budget / k) + 1 host waits and 2k wasted steps a fused
   call; tok/s each turn, captures, waits and wasted steps a call, the
   memory the loops hold, and one greedy request profiled each way (idle
   share, device time by kernel; the profiler's count of flash-decode
   launches must equal the wrapper's counter).  Then the same turns at
   a published dense width: minitron-4b (all 32 layers, random init from
   a seed, vocabulary cut to 64) with the testbed SMALL drafter; then
   the minitron-4b base alone at its published vocabulary (256000), 128
   tokens from a 64-token prompt greedy and at 0.6 (probabilities
   collected), fused against eager in turns, and one such greedy call
   profiled each way.  fused rows: the batched engines' fused loop (CUDA
   graphs with paged flash-decode inside) against their per-token loop,
   in the same turns on one pair of batch engines: minitron-4b's base
   and the SMALL drafter through the continuous scheduler, 8 requests
   over 4 rows, greedy and at 0.6, the greedy requests profiled each
   way; then the base alone at vocabulary 256000, a decode-only call of
   4 rows at ragged lengths (64, 300, 700, 1000), 128 tokens each, greedy
   and at 0.6 (probabilities collected), one greedy call profiled each
   way; identical tokens in every turn, paged-decode launches ==
   n_layers x decode steps, no capture in the second fused turn, at most
   ceil(budget / k) + 1 waits and 2k - 1 wasted steps a fused call, and
   the profiler's count of the paged-decode kernel == the counter.
   ``[main] prefix``, on the same minitron-4b base and SMALL drafter:
   the radix prefix cache (zero-copy: a hit adopts cached pool blocks
   into the row's table) on a template family of 2 tasks expanded
   best-of-N 4 over 4 rows at budget 128, one scheduler a run: cache
   on greedy, off greedy, on at 0.6 with the majority vote, on greedy
   under a KV budget that evicts and preempts; in every run paged-decode
   launches == n_layers x decode steps, paged-append launches ==
   n_layers x extends and no dense or SSD launch; hits in every cache-on
   run, the base's lookups == requests + preemptions, empty pools after
   ``clear_prefix_cache()``, the paged-append query tokens with the cache
   on at most those with it off less the hit tokens; a hit's last logits
   against a cold prefill's (LOGIT_TOL); hit rate, prefill tokens saved,
   TTFT, tok/s and evictions on against off, and as information whether
   the greedy tokens agree.  ``[main] overload``, on the same pair: 12
   tasks over 4 rows, greedy, spec decode at gamma 4, the prefix cache
   on, three fresh schedulers: unloaded; overloaded (Poisson arrivals at
   twice the unloaded req/s, the first at 0, deadlines of 3x its median
   latency, an unmeetable TPOT SLO, priority shedding over a queue of 6,
   the degradation ladder, ``FaultPlan.random(seed=7)`` over the
   unloaded run's ticks with 0.05 s stalls and a NaN in request 0's row
   at tick 1, the per-tick audit, an annotating tracer and the metrics);
   traced.  Every request terminal with a known error code, no audit
   violation, a row fault injected, quarantined and retried, the stall
   fired, a retried request ok, ok tokens the unloaded run's, the
   ladder off L0, the captures on keys
   the unloaded run lacked at most the rungs visited, #3 / #4 launches
   == n_layers x the metered calls, the trace's scheduler, engine and
   request tracks, the metrics' TTFT count; the traced run's tokens,
   Meter counts and captures the unloaded run's.  ``[main] tp``: exact tensor parallelism
   (``serve``'s continuous scheduler with a ``TPContext``) at
   minitron-4b's widths and TP_DEPTH layers with the SMALL drafter, two
   rank processes sharing the card over gloo (``serving.tp.run_ranks``;
   each draws its slices of the same seeded parameters on the card, one
   layer at a time), against tp=1 in this process, both on the per-token
   rows loop: 4 greedy requests over 4 rows at budget 128; per rank #3
   and #4 launches == n_layers x the metered decode steps and extends,
   all through ``kernels/paged_tp.py`` (the base's over 12 query and 4 kv
   heads), the ranks' tokens identical, tp=2's tokens tp=1's, one
   64-token extend's last logits within LOGIT_TOL, each rank's peak
   memory below the whole model's bytes; the backend, the gathers' host
   time a forward and the phase's lap; then ``serve --scheduler
   continuous --tp 2`` itself (its own rank processes) over the testbed
   checkpoint, 3 greedy requests, tokens equal to ``--tp 1``'s;
5. check: BASE and SMALL logits on the card against the same checkpoint
   on the CPU, over a prefill and decode steps, and over the batched
   path (one ``prefill_rows`` and one ``decode_rows`` on 3 ragged rows);
   then the batched path at minitron-4b's published widths (2 of its 32
   layers, random init): 3 rows commit about 2K tokens, then 5- and
   64-token spans and one ``feed_rows``, card logits against the CPU's
   and paged launches against n_layers x the metered calls;
6. main path, continuous: ``serve --scheduler continuous
   --no-prefix-cache`` (its default decode loop: the batched rows' fused
   loop), 8 requests over 4 rows, greedy and at 0.6, then
   with ``--spec-decode --gamma 4``, then greedy under a KV budget that
   preempts, then greedy with the prefix cache on (the CLI's default)
   and ``--num-samples 2``; per request latency, TTFT and TPOT, and
   tokens/s, ticks, preemptions and acceptance per run.  Paged-decode
   launches must equal n_layers x the batched engines' decode steps
   (replayed, masked and warm-up steps included), paged-append launches
   n_layers x their extend calls, the dense kernels must not launch, the
   pressured greedy run must give the unpressured greedy tokens, and
   both cache-on samples of each request its cache-off greedy tokens,
   with cache hits.  Then the CLI with ``--spec-decode --inject-faults
   7:3 --audit --deadline 30 --slo-tpot 0.5 --shed-policy priority
   --degrade --trace --metrics-out``: every request terminal, its
   ``[resilience]`` line with ``audit_violations=0``, the same launch
   check, a trace and metrics that parse.
   For information, how many requests' continuous greedy tokens equal
   the sequential path's on the card (batch-size-dependent GEMMs may
   move a logit by an ulp).  Then ``[fused rows]`` on the testbed pair:
   the same 8 requests greedy, at 0.6, and at 0.6 with spec decode (gamma
   4), each in turns fused, eager, fused on one scheduler;
7. main path, ssm (both engines on their default, the fused decode loop:
   the base's CUDA graphs over its static conv/ssm pair, the drafter's
   with flash-decode inside): SpecReason with a mamba2-1.3b base at its
   published widths (48 layers, d_model 2048, 64 SSD heads of 64, state
   128; random init from a seed, vocabulary cut to the toy tokenizer's
   64) and the testbed SMALL drafter, through ``serve.run_scheme``: 3
   requests greedy and at temperature 0.6, then one greedy request with
   hierarchical spec decode (gamma 4, the base rolls back by snapshot
   and replay), then the first greedy and the first sampled request
   again on the per-token loop, whose tokens must equal the fused
   turn's.  SSD scan launches must equal 48 x the base's metered
   extends, the dense kernels' SMALL's layers x its metered decode
   steps and prefill calls, and the greedy run must see the verifier
   both accept and reject; one greedy request profiled each way (idle
   share; the profiler's count of flash-decode launches == the
   counter).  ``[fused ssm]``: the base alone, decode-only, at
   vocabulary 64 and at its published 50280: a 64-token prompt, 128
   tokens greedy and at 0.6 (probabilities collected), in turns fused,
   eager, eager, fused: identical tokens, no capture in the second
   fused turn, waits and wasted steps bounded; tok/s, TPOT, captures,
   the static state's and the graph pools' bytes; one greedy call
   profiled each way at 50280;
8. check, ssm: the base's logits on the card against the same weights on
   the CPU over a 300-token prompt (three chunks, the last padded), a
   resumed 40-token extend and 3 decode steps;
9. main path, hybrid (both engines on the fused loop: the base's CUDA
   graphs over a pooled K/V pair and its static conv/ssm pair, with
   windowed flash-decode and the mamba2 step inside): SpecReason with a
   hymba-1.5b base at its published widths and depth (32 layers,
   d_model 1600, 25 heads over 5 with window 2048 beside 50 SSD heads of
   64 with state 16; random init, vocabulary cut to 64) and the testbed
   SMALL drafter: 3 requests greedy and at 0.6, then greedy req0 and
   sampled req0 on the per-token loop, whose tokens must equal the fused
   turn's; #2 and #5 launches == 32 x the base's extends (#2 plus
   SMALL's layers x its prefill calls), #1 == 32 x the base's decode
   steps + SMALL's layers x its steps, no paged launch; one capture per
   loop key after every request; each greedy request profiled (idle
   share; the profiler's flash-decode count == the counter).  ``[main]
   window``: hymba at 2 layers of its widths, max_len 4096, a 2100-token
   prompt then 48 tokens fused and eager (equal), so the window masks
   keys; card logits at the last prefill position and after decodes 1
   and 48 against the CPU's.  phi3-mini-3.8b and starcoder2-7b at 2
   layers of their widths: prefill 64 tokens, decode 16 fused, card
   logits against the CPU's over every step.  ``[main] paged window``:
   starcoder2-7b at 2 layers of its widths on the batched rows
   (capacity 4608): 2 rows prefill prompts of 4300 and 4250 tokens in
   256-token chunks through #4, then 48 greedy tokens through #3 on the
   fused rows loop, so the window of 4096 masks keys in both; #3 and #4
   launches == n_layers x the metered calls; the sequential Engine (#2
   and #1 with the window) gives the same tokens; row 0's logits after
   the prefill and decodes 1 and 48 against the CPU's;
   ``[main] moe``: SpecReason with a granite-moe-1b-a400m base at its
   published widths and depth (24 layers, 32 experts top-8; random
   init, vocabulary 64) and the SMALL drafter: 3 requests greedy and at
   0.6 on the fused loops (the moe step inside the graphs), greedy req0
   and sampled req0 again per token (equal tokens), #1 and #2 launches
   == n_layers x the metered calls; then the serve CLI's continuous path
   over the pair (the prefix cache on), 8 requests over 4 rows greedy
   and with spec decode, #3 and #4 launches == n_layers x the metered
   calls, latency, TTFT, TPOT, tok/s and the mean dropped fraction of
   the routings; greedy req0 profiled (the profiler's flash-decode count
   == the counter); as information how many continuous greedy requests
   give the sequential tokens; at 2 of the layers one 4-row extend card
   against CPU (the smallest top-k margin, the routing choices that
   differ, the logits where routing agrees) and one training step's
   gradients card against CPU (1e-5 of each one's largest).  ``[fused
   moe]``: the granite base alone at its published vocabulary (49155),
   decode-only, two fused turns; ms a token against the byte
   bounds of every expert's weights (the formulation's read) and of a
   top-8 read.  ``[main] encdec`` and ``[main] vlm``: SpecReason with a
   whisper-base base (6 decoder and 6 encoder layers, d_model 512, 8
   heads of 64) and then a llama-3.2-vision-11b base (40 layers, every
   5th a gated cross layer, d_model 4096, 32 heads over 8 of 128; 37.7
   GiB of fp32 weights drawn on the card one layer a draw, the gates,
   zero at init, drawn nonzero) at published widths and depth
   (vocabulary 64) with the SMALL drafter, each base session over a
   stub source (1500 frame embeddings, which it encodes, or 1601 patch
   embeddings): 3 requests greedy and at 0.6 fused, greedy req0 and
   sampled req0 per token (equal tokens); #2 launches == encoder layers
   x encodes + (self + cross layers) x the base's extends + SMALL's
   layers x its prefill calls, #1 == (self + cross layers) x the base's
   decode steps + SMALL's, no other kernel; one capture per loop key,
   the keys over one pooled KV pair and cross pair; greedy req0
   profiled; card vs CPU logits over a 64-token prompt and 16 decodes
   (whisper at full depth, the vlm at one group of 5 layers); then the
   base alone at its published vocabulary, decode-only, two fused
   turns, ms a token against the byte bound of its decoder weights and
   the K/V and cross K/V a token reads, and the phase's peak memory;
10. train: one BASE and one SMALL step's loss and every gradient on the
   card against the CPU (rtol 1e-4, atol that times each gradient's
   largest magnitude), at launch/train.py's batches; 20 BASE steps run twice from one seed with identical
   losses; ``launch.train.train_testbed_model`` trains BASE 500 steps and
   SMALL 400 into a temporary directory (loss every 50 steps, seconds,
   steps/s, training tokens/s; the backward kernel's launches must equal
   n_layers x the backward passes, each final loss at most half the
   first, and nothing but #2 and 2b may launch); then
   ``load_testbed_engines`` loads the pair and the base alone and
   SpecReason serve 16 tasks greedy through the fused loops at the serve
   CLI's budget and threshold, after one untimed pass over the same tasks
   (accuracy, mean and p50 latency, tok/s; for
   SpecReason the small-model steps accepted and the thinking tokens by
   source);
then the card again, one JSON line of per-kernel numbers, and
``{"ok": true, "device": {...}}`` as the last line.  Any failure exits
non-zero before that line; without CUDA, or outside a checkout, it exits
non-zero at once.

Every ``[profile]`` window is traced (CUDA activity only) with a margin
of host sleep and ``spin_kernel`` pads before and after it, which take
the records a trace loses at its start and after the card idles, and
bound the window on the device's clock (``repro_torch.launch.
trace_window``); each line says how many pads the trace holds before
and after the window, and how much wall the trace added to the same
call's last unprofiled turn.  A trace that lost its end (fewer than all
pads after the window) is taken again, at most TRACE_TRIES times.
"""

import collections
import dataclasses
import gc
import json
import math
import os
import random
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM, data sheet
# traces of one profiled call before the window's lost end fails the run
TRACE_TRIES = 3
# the least time for fp32-accurate products: 3xTF32 on the tensor cores at
# 495 / 3 TFLOP/s (dense TF32, data sheet), above the CUDA cores' 67
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}        # atol = rtol, as the tests
# a bf16 row of the cross-attention shapes, whose outputs are small
# (softmax over 1500 and more keys: RMS about 0.04), is held to the plain
# version in fp32 of the same bf16 inputs at its own scale: |err| <=
# 2^-8 |ref| (the output's rounding) + this x RMS(ref)
BF16_RMS_TOL = 2e-2
LOGIT_TOL = 1e-4       # card vs CPU model logits (fp32 GEMMs, TF32 off)
CACHE = 1024           # the serving engines' max_len
# the random-init pair's step utilities spread over about 2..5.5, so this
# threshold makes the verifier both accept and reject drafted steps
THRESHOLD = 4.5
BUCKETS = (4, 8, 16, 32, 64, 128, 256)
# a KV budget (MB, accounted at 2 bytes an element) under which 8 requests
# over 4 rows of the testbed pair preempt
PRESSURE_MB = 1
SSM_ARCH = "mamba2-1.3b"
# the SSD scan's tolerances, tests/test_kernels.py's: y atol = rtol 1e-4 in
# fp32 and 3e-2 in bf16; the final state (fp32 in both) 1e-4
SSD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SSD_STATE_TOL = 1e-4
SSM_THRESHOLD = 4.5
# [main] hybrid: hymba-1.5b at published widths and depth, the SMALL
# drafter, the ssm phase's threshold; [main] window: hymba at WINDOW_DEPTH
# layers of its widths, a WINDOW_PREFILL-token prompt in a WINDOW_CACHE
# cache, so that its window of 2048 masks keys, then WINDOW_DECODE tokens
# each way; phi3-mini-3.8b and starcoder2-7b at ARCH_DEPTH layers of their
# widths, an ARCH_PREFILL-token prompt, ARCH_DECODE tokens
HYBRID_ARCH = "hymba-1.5b"
HYBRID_THRESHOLD = 4.5
WINDOW_DEPTH = 2
WINDOW_CACHE = 4096
WINDOW_PREFILL = 2100
WINDOW_DECODE = 48
ARCH_CHECKS = ("phi3-mini-3.8b", "starcoder2-7b")
# [main] paged window: starcoder2-7b at WINDOW_DEPTH layers on the batched
# rows, prompts past its window of 4096
PAGED_WINDOW_CACHE = 4608
PAGED_WINDOW_PROMPTS = (4300, 4250)
PAGED_WINDOW_DECODE = 48
# [main] encdec and [main] vlm: whisper-base and llama-3.2-vision-11b at
# published widths and depth, the SMALL drafter; the card-vs-CPU check
# over a CROSS_PREFILL-token prompt and CROSS_DECODE decodes
CROSS_ARCHS = ("whisper-base", "llama-3.2-vision-11b")
CROSS_THRESHOLD = 4.5
CROSS_PREFILL = 64
CROSS_DECODE = 16
# [main] moe: granite-moe-1b-a400m at its published widths and depth
MOE_ARCH = "granite-moe-1b-a400m"
MOE_THRESHOLD = 4.5
MOE_BUDGET = 64
MOE_REQUESTS = 8
MOE_GRAD_TOL = 1e-5
ARCH_DEPTH = 2
ARCH_PREFILL = 64
ARCH_DECODE = 16
DENSE_ARCH = "minitron-4b"
DENSE_DEPTH = 2        # minitron-4b's 32 layers cut to 2 for the rows check
# the [fused rows] phases: the continuous path's 8 requests over 4 rows at
# this budget; minitron-4b's KV partition in MB accounted (2 bytes an
# element: 2 MiB a 16-token block, 400 blocks); the decode-only call's
# ragged rows and tokens a row
ROWS_REQUESTS = 8
ROWS_BUDGET = 128
DENSE_KV_MB = 1000
DECODE_ROWS = (64, 300, 700, 1000)
DECODE_TOKENS = 128
# [main] prefix at minitron-4b: a template family of PREFIX_TASKS tasks
# (4 shared ops, then 4-6 of their own: 39-47 prompt tokens, the first
# 16-token block shared by all, the second by a task's samples), each
# sampled PREFIX_N times over 4 rows at ROWS_BUDGET; the pressured run's
# KV partition: 40 MB accounted, 16 base blocks of 2 MiB (a request may
# need 12), where 60 MB (24 blocks) gave one preemption and one eviction
PREFIX_TASKS = 2
PREFIX_N = 4
PREFIX_PRESSURE_MB = 40
# [main] overload at minitron-4b (the same pair): OVERLOAD_TASKS tasks
# over 4 rows at ROWS_BUDGET with spec decode (gamma 4) and the prefix
# cache, three runs: unloaded, overloaded (Poisson arrivals at twice the
# unloaded req/s, the first at 0, deadlines of OVERLOAD_DEADLINE_X x its
# median latency, an unmeetable TPOT SLO, priority shedding over
# OVERLOAD_MAX_QUEUE, the ladder, FaultPlan.random(seed OVERLOAD_SEED)
# over the ticks the unloaded run took (at most the CLI's FAULT_MAX_TICK)
# with stalls of OVERLOAD_STALL_S, plus a NaN in request 0's base row at
# tick 1, the audit, the tracer and metrics), traced; the phase's lap
# budget in seconds, enforced
OVERLOAD_TASKS = 12
OVERLOAD_SEED = 7
OVERLOAD_FAULTS = 4
OVERLOAD_DEADLINE_X = 3.0
OVERLOAD_SLO_TPOT_S = 1e-6
OVERLOAD_MAX_QUEUE = 6
OVERLOAD_STALL_S = 0.05
OVERLOAD_LAP_S = 45.0
# the terminal error codes of the JAX package's failure model
ERROR_CODES = ("deadline", "shed_infeasible", "shed_overload", "nan_logits",
               "engine_error")
# [main] tp: minitron-4b (vocabulary 64, TP_DEPTH of its 32 layers) with
# the SMALL drafter at tp=TP_SIZE, the rank processes sharing the card
# over gloo, against tp=1 in this process: TP_REQUESTS greedy requests
# over 4 rows at ROWS_BUDGET through the per-token rows loop both ways;
# then one TP_PROMPT-token extend, its last logits within LOGIT_TOL
TP_SIZE = 2
TP_DEPTH = 32
TP_REQUESTS = 4
TP_PROMPT = 64
TP_TIMEOUT_S = 600
# the turns of the decode-only phases: one eager turn between two fused
# ones (each loop's tokens against the other's, and a second fused turn
# that must capture nothing)
TURNS = ("fused", "eager", "fused")
# the attention backward (2b): BASE's and SMALL's training shapes, and
# minitron-4b's heads from S=256 to 2048, where 2b's first version fell
# behind the plain backward, and at 4096, its context, where the sums are
# longest (model, B, S); atol = rtol = the tolerance x the gradient's
# largest magnitude, against the plain backward on the card.
# launch/append_ab.py times the same cases.
BWD_CASES = (("base", 16, 112, 2e-5), ("small", 16, 96, 2e-5),
             ("minitron", 1, 256, 1e-4), ("minitron", 1, 512, 1e-4),
             ("minitron", 1, 1024, 1e-4), ("minitron", 1, 2048, 1e-4),
             ("minitron", 1, 4096, 1e-4))
# [train]: card gradients against CPU gradients (rtol, and atol this times
# the tensor's largest gradient); the pair's steps (launch/train.py's
# settings: 16 rows of 112 and 96 tokens); the trained pair served greedy
# over this many tasks at the serve CLI's budget and threshold
TRAIN_GRAD_TOL = 1e-4
TRAIN_STEPS = (("base", 500, 112), ("small", 400, 96))
TRAIN_REPEAT_STEPS = 20
TRAIN_TASKS = 16


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=30):
    """ms a call of fn, host cost included: the median over five
    CUDA-event windows of ``reps`` calls each, so that one slow window
    does not set the reading."""
    windows = 5
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[windows // 2]


def ptxas_variants(text):
    """(variant, registers, static shared memory bytes, spill-store bytes)
    per kernel entry in an ``nvcc -Xptxas -v`` report; dynamic shared
    memory is not in it (the kernel phase prints #2's, #4's and #5's
    plans)."""
    out, name, spill = [], "?", 0
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name, spill = m.group(1), 0
            t = re.search(r"\d+([a-z_]+_kernel)I(f|13__nv_bfloat16)"
                          r"((?:L[ib]\d+E)*)", name)
            if t:
                args = ["f32" if t.group(2) == "f" else "bf16"]
                ints = re.findall(r"L([ib])(\d+)E", t.group(3))
                if "decode" in t.group(1) and len(ints) == 3:
                    # decode kernels: <T, HD, GB, VB>
                    args += [ints[0][1], f"G<={ints[1][1]}",
                             f"{ints[2][1]}-byte copies"]
                else:       # <T, HD> or <T, HD, kVec>
                    args += [n if k == "i" else ("scalar", "cp.async")[
                        n == "1"] for k, n in ints]
                name = f"{t.group(1)}<{', '.join(args)}>"
            else:       # no element type: <int> or no template arguments
                t = re.search(r"\d+([a-z_]+_kernel)(?:ILi(\d+)E)?E", name)
                if t:
                    name = t.group(1) + (f"<{t.group(2)}>" if t.group(2)
                                         else "")
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append((name, int(m.group(1)),
                        int(smem.group(1)) if smem else 0, spill))
    return out


def leaves(tree):
    for v in tree.values():
        yield from leaves(v) if isinstance(v, dict) else (v,)


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_plan_note(plan, label):
    """One line of a decode launch's plan; the C entry's copy width must
    equal the Python mirror's."""
    if plan["vector_bytes"] != plan["vector_bytes_mirror"]:
        raise AssertionError(f"{label}: copy width {plan['vector_bytes']} "
                             f"bytes, mirror {plan['vector_bytes_mirror']}")
    return (f"split {plan['n_split']} x {plan['split_keys']} keys, "
            f"{plan['vector_bytes']}-byte copies, {plan['slots']} blocks at "
            f"once, {plan['smem_bytes']} bytes of shared memory a block")


def kernel_phase(torch, F, ref, decode_kernel, flash_kernel, minitron,
                 whisper, vlm):
    """Every kernel against its plain version at the path's shapes, the
    cross-attention families' among them: #2 non-causal over
    whisper-base's encoder (S 1500 over 1500 keys) and a 64-token cross
    prefill over its 1500 frames and llama-3.2-vision-11b's 1601
    patches, #1 over the same cross K/V (no key tile of 32 divides 1500
    or 1601); their bf16 rows are held at the output's scale
    (BF16_RMS_TOL).  Returns per-kernel records for the JSON line."""
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import tile_plan
    from repro_torch.kernels.decode_attention import DTYPES
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    heads = {"base": (8, 4, 28), "small": (4, 2, 32),
             "minitron": (minitron.n_heads, minitron.n_kv_heads,
                          minitron.resolved_head_dim),
             # minitron-4b's kv heads and hd with G = 16 (qwen3-moe's G)
             "minitron-g16": (16 * minitron.n_kv_heads, minitron.n_kv_heads,
                              minitron.resolved_head_dim),
             "whisper": (whisper.n_heads, whisper.n_kv_heads,
                         whisper.resolved_head_dim),
             "vlm": (vlm.n_heads, vlm.n_kv_heads, vlm.resolved_head_dim)}
    n_frames, n_patches = whisper.encoder_seq_len, vlm.n_image_tokens
    records = {"decode_attention": [], "flash_attention": []}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def check(name, out, exp, dtype, label, scaled=False):
        """``out`` against ``exp`` at TOL; with ``scaled``, against
        ``exp``, the plain version over the bf16 inputs in fp32, at
        BF16_RMS_TOL of its RMS."""
        diff = (out.float() - exp.float()).abs()
        err = diff.max().item()
        if scaled:
            rms = exp.pow(2).mean().sqrt()
            if (diff > exp.abs() * 2.0 ** -8 + BF16_RMS_TOL * rms).any():
                raise AssertionError(
                    f"{name} {label}: max |err| {err} beyond 2^-8 |ref| + "
                    f"{BF16_RMS_TOL} x RMS {rms.item():.4g} of the fp32 ref")
        elif not torch.allclose(out.float(), exp.float(), atol=TOL[dtype],
                                rtol=TOL[dtype]):
            raise AssertionError(f"{name} {label}: max |err| {err} beyond "
                                 f"atol = rtol = {TOL[dtype]}")
        return err

    decode_cases = [("base", 1, [128]), ("base", 4, [1, 77, 640, 1024]),
                    ("small", 1, [128]), ("small", 4, [1, 300, 777, 1024]),
                    ("minitron", 8, [4096] * 8),
                    ("minitron-g16", 8, [4096] * 8),
                    # one decoded token's cross-attention (G 1, hd 64;
                    # G 4, hd 128)
                    ("whisper", 1, [n_frames]), ("vlm", 1, [n_patches])]
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        esize = torch.tensor([], dtype=dt).element_size()
        for model, b, lens in decode_cases:
            h, kh, hd = heads[model]
            cap = max(CACHE, max(lens))
            kc = randn(b, cap, kh, hd, dtype=dt).permute(0, 2, 1, 3)
            vc = randn(b, cap, kh, hd, dtype=dt).permute(0, 2, 1, 3)
            q = randn(b, h, hd, dtype=dt)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            label = f"{model} {dname} B={b} cache={cap} lengths={lens}"
            scaled = dt == torch.bfloat16 and model in ("whisper", "vlm")
            exp = ref.decode_reference(
                *(t.float() if scaled else t for t in (q, kc, vc)), lengths)
            err = check("decode_attention",
                        decode_kernel(q, kc, vc, lengths), exp, dname, label,
                        scaled)
            mask = (torch.arange(cap, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            ms = time_ms(torch, lambda: decode_kernel(q, kc, vc, lengths))
            plain_ms = time_ms(torch, lambda: ref.decode_reference(
                q, kc, vc, lengths))
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kc, vc, attn_mask=mask, enable_gqa=True))
            keys = sum(lens)
            nbytes = (2 * q.numel() + 2 * keys * kh * hd) * esize + 4 * b
            bound_ms, by = bound(nbytes, 4 * hd * h * keys, dname)
            plan = decode_mod.plan(q, kc, vc)
            records["decode_attention"].append(dict(
                shape=label, dtype=dname, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=by, split=[plan["n_split"], plan["split_keys"]],
                vector_bytes=plan["vector_bytes"]))
            print(f"[kernels] decode_attention {label}: err {err:.3g} | "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({by}) | "
                  + decode_plan_note(plan, label), flush=True)

        prefill_cases = [(m, s, off, CACHE, True, 0)
                         for m in ("base", "small")
                         for s, off in zip(BUCKETS, (0, 100, 100, 500, 200,
                                                     640, 768))]
        prefill_cases += [("small", 64, 300, CACHE, True, 128),  # window
                          ("base", 128, 0, 128, False, 0),       # Pallas,
                          ("base", 128, 0, 128, True, 0),        # contract
                          ("minitron", 2048, 0, 2048, True, 0),
                          ("minitron", 256, 1792, 2048, True, 0),  # a chunk
                          # the encoder, and a 64-token cross prefill
                          ("whisper", n_frames, 0, n_frames, False, 0),
                          ("whisper", 64, 0, n_frames, False, 0),
                          ("vlm", 64, 0, n_patches, False, 0)]
        for model, s, off, cap, causal, window in prefill_cases:
            h, kh, hd = heads[model]
            q = randn(1, s, h, hd, dtype=dt).permute(0, 2, 1, 3)
            kc = randn(1, cap, kh, hd, dtype=dt).permute(0, 2, 1, 3)
            vc = randn(1, cap, kh, hd, dtype=dt).permute(0, 2, 1, 3)
            label = (f"{model} {dname} S={s} q_offset={off} kv={cap} "
                     f"causal={causal} window={window}")
            args = (causal, off, cap, window)
            scaled = dt == torch.bfloat16 and model in ("whisper", "vlm")
            exp = ref.mha_reference(
                *(t.float() if scaled else t for t in (q, kc, vc)), *args)
            err = check("flash_attention", flash_kernel(q, kc, vc, *args),
                        exp, dname, label, scaled)
            # (S, keys): a non-causal mask comes back as one row
            mask = ref.attention_mask(s, cap, causal, off, cap, window,
                                      device=dev).expand(s, cap)
            ms = time_ms(torch, lambda: flash_kernel(q, kc, vc, *args))
            plain_ms = time_ms(torch, lambda: ref.mha_reference(
                q, kc, vc, *args), reps=5 if s >= 2048 else 30)
            # the yardstick takes its fastest form of the same function
            whole = cap == s and off == 0 and window == 0
            sdpa_mask = None if whole or not causal else mask
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, kc, vc, attn_mask=sdpa_mask, is_causal=causal and whole,
                enable_gqa=True))
            pairs = int(mask.sum())
            seen = mask.any(dim=0).nonzero()
            keys = int(seen.max() - seen.min() + 1) if len(seen) else 0
            nbytes = (2 * q.numel() + 2 * keys * kh * hd) * esize
            bound_ms, by = bound(nbytes, 4 * hd * h * pairs, dname)
            slots, smem = tile_plan.card_occupancy(
                "flash_attention", DTYPES[dt], hd,
                min(tile_plan.ROWS, s * (h // kh)),
                torch.cuda.current_device())
            split = flash_mod.split_plan(1, s, h, kh, off, cap, causal,
                                         window, slots)
            records["flash_attention"].append(dict(
                shape=label, dtype=dname, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=by, split=list(split), slots=slots,
                smem_bytes=smem))
            print(f"[kernels] flash_attention {label}: err {err:.3g} | "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({by}) | "
                  f"split {split[0]} x {split[1]} keys from {split[2]}, "
                  f"{slots} blocks at once, {smem} bytes of shared memory "
                  "a block", flush=True)
    return records


def bwd_heads(model, minitron):
    """(query heads, kv heads, head_dim) of a ``BWD_CASES`` model."""
    return {"base": (8, 4, 28), "small": (4, 2, 32),
            "minitron": (minitron.n_heads, minitron.n_kv_heads,
                         minitron.resolved_head_dim)}[model]


def bwd_kernel_phase(torch, F, ref, flash_kernel, bwd_kernel, minitron):
    """The attention backward (2b) against its plain version in fp32 at
    BASE's and SMALL's training shapes and minitron-4b's heads over S=256
    to 4096, with the autograd backward of fp32 SDPA as the yardstick (its
    forward outside the timed window), and the plan the wrapper launched
    (``tile_plan.bwd_plan``: grids, shared memory, the scratch, and the
    longest and mean dK/dV walk that plan makes).  Returns the records for
    the JSON line."""
    from repro_torch.kernels import tile_plan
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    records = []
    for model, b, s, tol in BWD_CASES:
        h, kh, hd = bwd_heads(model, minitron)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev)
        # the training forward's layout: (B, S, heads, hd) permuted
        q = randn(b, s, h, hd).permute(0, 2, 1, 3)
        k = randn(b, s, kh, hd).permute(0, 2, 1, 3)
        v = randn(b, s, kh, hd).permute(0, 2, 1, 3)
        do = randn(b, h, s, hd)
        o = flash_kernel(q, k, v)
        got = bwd_kernel(q, k, v, o, do)
        want = ref.mha_backward_reference(q, k, v, do)
        label = f"{model} float32 B={b} S={s} H={h} K={kh} hd={hd}"
        if not all(torch.equal(a, g) for a, g in zip(
                bwd_kernel(q, k, v, o, do), got)):
            raise AssertionError(f"flash_attention_bwd {label}: a second "
                                 "call gave other bits")
        err, scale, each = 0.0, 0.0, []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            top = w.abs().max().item()
            e = (g - w).abs().max().item()
            if not torch.allclose(g, w, rtol=tol, atol=tol * top):
                raise AssertionError(f"flash_attention_bwd {label} {name}: "
                                     f"max |err| {e} beyond rtol {tol}, atol "
                                     f"{tol} x max |{name}| {top}")
            err, scale = max(err, e), max(scale, top)
            each.append(f"{name} {e:.3g} of {top:.3g}")
        ms = time_ms(torch, lambda: bwd_kernel(q, k, v, o, do))
        plain_ms = time_ms(torch, lambda: ref.mha_backward_reference(
            q, k, v, do), reps=5 if s >= 2048 else 30)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                             enable_gqa=True)
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True),
            reps=5 if s >= 2048 else 30)
        del out
        # least work: five causal products (Q K^T, dP, dV, dK, dQ) of 2 hd
        # flops a visible pair; bytes: q, k, v, o, do read, dq, dk, dv
        # written, once each
        pairs = b * h * s * (s + 1) // 2
        nbytes = 4 * (4 * b * h * s * hd + 4 * b * kh * s * hd)
        bound_ms, by = bound(nbytes, 5 * 2 * hd * pairs, "float32")
        records.append(dict(shape=label, dtype="float32", max_abs_err=err,
                            max_abs_grad=scale, tolerance=tol, ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=by))
        print(f"[kernels] flash_attention_bwd {label}: err {err:.3g} at max "
              f"|grad| {scale:.3g} ({', '.join(each)}; rtol {tol}, atol "
              f"{tol} x the largest |grad| of each) | kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({by}); a second call gives the same "
              "bits", flush=True)
        pl = tile_plan.bwd_plan(b, h, kh, s, hd)
        print(f"[kernels] flash_attention_bwd {label} plan (tile_plan, as "
              "launched): " + ", ".join(
                  f"{x['name']} grid {x['grid']} x {x['threads']} threads, "
                  f"{x['smem_bytes']} B shared" for x in pl["launches"])
              + f"; scratch {pl['scratch_bytes']} B; the plan's dK/dV walk "
              f"longest {pl['dkv_longest']} / mean {pl['dkv_mean']:.1f} of "
              f"{pl['n_tiles']} tiles", flush=True)
    return records


def train_phase(torch, kernels):
    """Training on the card, then SpecReason on the pair it trained.
    (1) one BASE and one SMALL step's loss and every gradient against the
    CPU's from the same parameters and batch; (2) twenty BASE steps twice from one
    seed: identical losses; (3) ``train_testbed_model`` trains BASE and
    SMALL (``TRAIN_STEPS``) into a temporary directory: the attention
    backward must launch n_layers x the backward passes, and each final
    loss be at most half its step-0 loss; (4) ``load_testbed_engines``
    loads the pair; (5) the base alone and SpecReason serve
    ``TRAIN_TASKS`` tasks greedy through the fused loops, timed after one
    untimed pass over the same tasks (the fresh engines' captures).
    Returns the
    launches of the pair's training (3)."""
    import tempfile

    from repro_torch.configs import testbed
    from repro_torch.data import pipeline, tasks
    from repro_torch.data.evaluate import is_correct
    from repro_torch.launch import serve
    from repro_torch.launch.train import train_testbed_model
    from repro_torch.models.model import Model, flatten, unflatten
    from repro_torch.serving import loader
    from repro_torch.training import loss as tloss
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig, train

    # (1) card against CPU, at launch/train.py's batches
    for cfg, seq, kind, mix, frac in (
            (testbed.BASE, 112, "mixed", (0.85, 0.1), 0.3),
            (testbed.SMALL, 96, "cot", (0.0, 0.0), 0.35)):
        m = Model(cfg)
        params = m.init(0, device="cpu")
        inp, tgt, wgt = next(pipeline.batch_iterator(
            pipeline.BatchSpec(16, seq), 0, kind, mix, frac))
        res = {}
        for dev in ("cuda", "cpu"):
            p = {k: t.to(dev, copy=True).requires_grad_()
                 for k, t in flatten(params).items()}
            loss, _ = tloss.loss_fn(m, unflatten(p), {
                "tokens": torch.from_numpy(inp).to(dev),
                "targets": torch.from_numpy(tgt).to(dev),
                "weights": torch.from_numpy(wgt).to(dev)})
            grads = torch.autograd.grad(loss, list(p.values()))
            res[dev] = (loss.detach().cpu(),
                        {k: g.cpu() for k, g in zip(p, grads)})
        pairs = [("loss", res["cuda"][0], res["cpu"][0])] + [
            (k, res["cuda"][1][k], g) for k, g in res["cpu"][1].items()]
        worst, where = 0.0, ""
        for name, card, cpu in pairs:
            top = cpu.abs().max().item()
            rel = (card - cpu).abs().max().item() / top
            if not torch.allclose(card, cpu, rtol=TRAIN_GRAD_TOL,
                                  atol=TRAIN_GRAD_TOL * top):
                raise AssertionError(f"[train] {cfg.name} {name}: card vs "
                                     f"CPU |diff| / max {rel} (> "
                                     f"{TRAIN_GRAD_TOL})")
            if rel >= worst:
                worst, where = rel, name
        print(f"[train] one {cfg.name} step (16 x {seq}, remat), card vs "
              f"CPU: loss {res['cuda'][0].item():.6f} / "
              f"{res['cpu'][0].item():.6f}, loss and all "
              f"{len(res['cpu'][1])} gradients within rtol {TRAIN_GRAD_TOL}"
              f" and atol {TRAIN_GRAD_TOL} x each one's largest magnitude "
              f"(worst |diff| / max {worst:.3g}, {where})", flush=True)

    # (2) the same steps twice
    tcfg = TrainConfig(steps=TRAIN_REPEAT_STEPS, batch_size=16, seq_len=112,
                       kind="mixed", style_mix=(0.85, 0.1), score_frac=0.3,
                       log_every=1, opt=AdamWConfig(lr=1.5e-3,
                                                    warmup_steps=40))
    runs = [[h["loss"] for h in train(testbed.BASE, tcfg,
                                       log=lambda s: None)["history"]]
            for _ in range(2)]
    if runs[0] != runs[1]:
        raise AssertionError(f"[train] two runs from one seed differ: "
                             f"{runs[0]} / {runs[1]}")
    print(f"[train] {TRAIN_REPEAT_STEPS} BASE steps twice from seed 0: "
          f"identical losses, {runs[0][0]:.6f} -> {runs[0][-1]:.6f}",
          flush=True)

    # (3) the pair
    bwd = kernels["flash_attention_bwd"]
    with tempfile.TemporaryDirectory() as ckpt:
        for k in kernels.values():
            k.launches = 0
        for which, steps, seq in TRAIN_STEPS:
            before = bwd.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = train_testbed_model(which, steps, ckpt,
                                      log=lambda s: print(s, flush=True))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            cfg, hist = out["model"].cfg, out["history"]
            first, last = hist[0]["loss"], hist[-1]["loss"]
            n_bwd = bwd.launches - before
            if n_bwd != cfg.n_layers * steps:
                raise AssertionError(f"[train] {cfg.name}: {n_bwd} backward "
                                     f"launches != {cfg.n_layers} x {steps}")
            if not last <= first / 2:
                raise AssertionError(f"[train] {cfg.name}: loss {first} -> "
                                     f"{last}, not halved")
            print(f"[train] {cfg.name}: {steps} steps in {dt:.2f} s, "
                  f"{steps / dt:.2f} steps/s, {steps * 16 * seq / dt:.0f} "
                  f"training tokens/s (16 x {seq} a step); loss {first:.4f}"
                  f" -> {last:.4f}; flash_attention_bwd launches {n_bwd} == "
                  f"{cfg.n_layers} layers x {steps} backward passes",
                  flush=True)
        launches = {name: k.launches for name, k in kernels.items()}
        if not launches["flash_attention"] or any(
                launches[n] for n in launches
                if n not in ("flash_attention", "flash_attention_bwd")):
            raise AssertionError(f"[train] launches {launches}: want #2 and "
                                 "2b only")
        print(f"[train] the pair's training launched flash_attention "
              f"{launches['flash_attention']} (forward and remat), "
              f"flash_attention_bwd {launches['flash_attention_bwd']}, no "
              "other kernel", flush=True)

        # (4), (5) SpecReason on the trained pair
        base, small = loader.load_testbed_engines(ckpt, "cuda")
    cli = serve.parse_args([])
    rng = random.Random(cli.seed)
    reqs = [tasks.sample_task(rng) for _ in range(TRAIN_TASKS)]
    print(f"[train] serving {TRAIN_TASKS} tasks (seed {cli.seed}) greedy, "
          f"budget {cli.budget}, threshold {cli.threshold}, decode loops "
          f"{loader.decode_loops(base, small)}; timed after one untimed "
          "pass", flush=True)
    def run(scheme, i, task):
        gen = torch.Generator(device="cuda").manual_seed(1000 * cli.seed + i)
        return serve.run_scheme(scheme, base, small, task, gen, cli.budget,
                                cli.threshold, 0.0)

    for scheme in ("base", "specreason"):
        for i, task in enumerate(reqs):     # untimed: the captures
            run(scheme, i, task)
        lat, ok, n_out, utils = [], 0, 0, []
        accepted = by_small = by_base = 0
        for i, task in enumerate(reqs):
            r = run(scheme, i, task)
            lat.append(r.wall_time)
            ok += is_correct(task, r.answer_ids)
            n_out += r.n_thinking_tokens + len(r.answer_ids)
            for st in r.steps:
                if st.source == "small":
                    utils.append(st.utility)
                    accepted += st.accepted
                    by_small += len(st.tokens) if st.accepted else 0
                else:
                    by_base += len(st.tokens)
        lat_s = sorted(lat)
        line = (f"[train] serve {scheme} on the trained pair: accuracy "
                f"{ok}/{TRAIN_TASKS} = {ok / TRAIN_TASKS:.3f}, latency mean "
                f"{sum(lat) / len(lat) * 1e3:.1f} ms, p50 "
                f"{lat_s[len(lat_s) // 2] * 1e3:.1f} ms, {n_out} output "
                f"tokens, {n_out / sum(lat):.1f} tok/s")
        if scheme == "specreason":
            line += (f"; small-model steps accepted {accepted}/{len(utils)} "
                     f"= {accepted / max(len(utils), 1):.3f} (utilities "
                     f"{min(utils, default=0):.2f}-{max(utils, default=0):.2f}"
                     f", mean {sum(utils) / max(len(utils), 1):.2f}); "
                     f"thinking tokens from accepted small steps {by_small},"
                     f" from base steps {by_base}")
        print(line, flush=True)
    del base, small
    return launches


def device_ms(torch, fn, reps=10):
    """Device ms of one call of fn: torch.profiler's device time of its
    kernels, summed over a run of ``reps`` calls, over reps.  A trace
    that holds no device record lost them (it happened once in PR 28's
    runs) and is taken again, at most TRACE_TRIES traces."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.self_device_time_total > 0)
        if total > 0:
            return total / 1e3 / reps
    raise AssertionError(f"{TRACE_TRIES} traces held no device time")


def ssd_plan_note(plan, label):
    """One line of a scan's plan; the C entry's grids, threads and shared
    memory must equal the Python mirror's."""
    for got, want in zip(plan["launches"], plan["mirror"]["launches"]):
        for key in ("blocks", "threads", "smem_bytes"):
            if got[key] != want[key]:
                raise AssertionError(f"ssd_scan {label}: {got['name']} "
                                     f"{key} {got[key]}, mirror {want[key]}")
    return (f"route {plan['route']} ({plan['chunks']} chunks, "
            f"{plan['copies']} copies): ") + "; ".join(
        f"{x['name']} {x['blocks']} blocks x {x['threads']}, "
        f"{x['registers']} registers, {x['smem_bytes']} bytes of shared "
        f"memory, {x['blocks_per_sm']} an SM, {x['spill_bytes']} spilled"
        for x in plan["launches"] if x["blocks"]) + \
        f"; scratch {plan['scratch_bytes']} bytes"


def ssd_kernel_phase(torch, ref, mamba2, ssd_scan, mamba, hybrid):
    """The SSD scan kernel against its plain version (``ssd_chunked``) and
    the sequential oracle (``ssd_reference``) at mamba2-1.3b's heads, at
    hymba-1.5b's mixer heads (50 x 64, state 16: a partial pass of state
    rows) and the reduced G > 1 shapes; at L = 37 and 2048 also a scan's
    device time and its plan.  Returns its records for the JSON line."""
    from repro_torch.kernels import ssd_scan as ssd_mod
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    h, p, n = mamba.ssm_n_heads, mamba.ssm_head_dim, mamba.ssm_state
    g = mamba.ssm_n_groups
    hh, hp, hn = hybrid.ssm_n_heads, hybrid.ssm_head_dim, hybrid.ssm_state
    hg = hybrid.ssm_n_groups
    # (label, B, L, H, P, G, N, chunk, real positions before the pad)
    cases = [("mamba2", 1, 7, h, p, g, n, 7, 7),
             ("mamba2", 1, 37, h, p, g, n, 37, 37),
             ("mamba2", 1, 128, h, p, g, n, 128, 128),
             ("mamba2", 1, 384, h, p, g, n, 128, 300),
             ("mamba2", 1, 2048, h, p, g, n, 128, 2048),
             ("hymba", 1, 37, hh, hp, hg, hn, 37, 37),
             ("hymba", 1, 2048, hh, hp, hg, hn, hybrid.ssm_chunk, 2048),
             ("sweep", 1, 128, 2, 16, 1, 16, 32, 128),
             ("sweep", 2, 256, 4, 16, 2, 32, 64, 256),
             ("sweep", 1, 256, 4, 32, 1, 64, 128, 256)]
    records = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def close(name, got, want, tol, label):
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            raise AssertionError(f"ssd_scan {label}: {name} max |err| {err} "
                                 f"beyond atol = rtol = {tol}")
        return err

    for dt_ in (torch.float32, torch.bfloat16):
        dname = str(dt_).split(".")[1]
        esize = torch.tensor([], dtype=dt_).element_size()
        for kind, b, l, hh, pp, gg, nn, chunk, real in cases:
            x = randn(b, l, hh, pp)
            dt = torch.nn.functional.softplus(randn(b, l, hh))
            a = -torch.exp(randn(hh) * 0.5)
            bb, cc = randn(b, l, gg, nn) * 0.3, randn(b, l, gg, nn) * 0.3
            init = randn(b, hh, pp, nn) * 0.5
            for t in (x, dt, bb, cc):       # the caller's pads: dt = 0
                t[:, real:] = 0
            x, bb, cc = x.to(dt_), bb.to(dt_), cc.to(dt_)
            label = (f"{kind} {dname} B={b} L={l} H={hh} P={pp} G={gg} "
                     f"N={nn} chunk={chunk}"
                     + (f" ({real} real)" if real < l else ""))
            y, fin = ssd_scan(x, dt, a, bb, cc, chunk, init)
            ye, fe = ref.ssd_reference(x, dt, a, bb, cc, init)
            yp, fp = mamba2.ssd_chunked(x, dt, a, bb, cc, chunk, init)
            tol = SSD_TOL[dname]
            err = max(close("y vs oracle", y[:, :real], ye[:, :real], tol,
                            label),
                      close("y vs plain", y[:, :real], yp[:, :real], tol,
                            label))
            # the plain version returns its final state in x's dtype
            state_err = max(close("state vs oracle", fin, fe, SSD_STATE_TOL,
                                  label),
                            close("state vs plain", fin, fp, tol, label))
            ms = time_ms(torch, lambda: ssd_scan(x, dt, a, bb, cc, chunk,
                                                 init))
            plain_ms = time_ms(torch, lambda: mamba2.ssd_chunked(
                x, dt, a, bb, cc, chunk, init), reps=10)
            # least work: real positions only, the causal half of each
            # chunk's Q x Q terms; C.B^T once per (batch, group, chunk), as
            # every head of a group shares it, the rest per head
            qs = [min(chunk, real - s0) for s0 in range(0, real, chunk)]
            macs = b * sum(gg * q * (q + 1) // 2 * nn
                           + hh * (q * (q + 1) // 2 * pp + 2 * q * pp * nn)
                           for q in qs)
            nbytes = (2 * b * real * hh * pp + 2 * b * real * gg * nn) \
                * esize + 4 * (b * real * hh + hh + 2 * b * hh * pp * nn)
            bound_ms, by = bound(nbytes, 2 * macs, dname)
            rec = dict(shape=label, dtype=dname, max_abs_err=err,
                       state_err=state_err, ms=ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=bound_ms, bound_by=by)
            note = ""
            if kind in ("mamba2", "hymba") and l in (37, 2048):
                rec["device_ms"] = device_ms(
                    torch, lambda: ssd_scan(x, dt, a, bb, cc, chunk, init))
                rec["plan"] = ssd_mod.plan(x, dt, a, bb, cc, chunk, init)
                note = (f" | device {rec['device_ms']:.4f} ms a scan "
                        f"(profiler, its launches summed) | "
                        + ssd_plan_note(rec["plan"], label))
            records.append(rec)
            print(f"[kernels] ssd_scan {label}: y err {err:.3g}, state err "
                  f"{state_err:.3g} | kernel {ms:.4f} ms, plain {plain_ms:.4f}"
                  f" ms, library none, bound {bound_ms:.5f} ms ({by})" + note,
                  flush=True)
        # state resume: two calls carrying the state equal one call
        l, half = 256, 128
        x, bb, cc = randn(1, l, h, p), randn(1, l, g, n) * 0.3, \
            randn(1, l, g, n) * 0.3
        x, bb, cc = x.to(dt_), bb.to(dt_), cc.to(dt_)
        dt = torch.nn.functional.softplus(randn(1, l, h))
        a = -torch.exp(randn(h) * 0.5)
        y, fin = ssd_scan(x, dt, a, bb, cc, 128)
        y1, f1 = ssd_scan(x[:, :half], dt[:, :half], a, bb[:, :half],
                          cc[:, :half], 128)
        y2, f2 = ssd_scan(x[:, half:], dt[:, half:], a, bb[:, half:],
                          cc[:, half:], 128, f1)
        label = f"mamba2 {dname} resume 128 + 128"
        err = close("y", torch.cat([y1, y2], 1), y, SSD_TOL[dname], label)
        err_s = close("state", f2, fin, SSD_STATE_TOL, label)
        print(f"[kernels] ssd_scan {label}: two calls with the state "
              f"carried equal one call (y err {err:.3g}, state err "
              f"{err_s:.3g})", flush=True)
    return {"ssd_scan": records}


def paged_kernel_phase(torch, F, ref, paged_decode, paged_append,
                       minitron):
    """The paged kernels against their plain versions at the continuous
    path's shapes and minitron-4b's.  Returns per-kernel records."""
    from repro_torch.kernels import paged_decode_attention as paged_mod
    from repro_torch.kernels import tile_plan
    from repro_torch.kernels.decode_attention import DTYPES
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    heads = {"base": (8, 4, 28), "small": (4, 2, 32),
             "minitron": (minitron.n_heads, minitron.n_kv_heads,
                          minitron.resolved_head_dim),
             "minitron-g16": (16 * minitron.n_kv_heads, minitron.n_kv_heads,
                              minitron.resolved_head_dim)}
    bs = 16
    records = {"paged_decode_attention": [], "paged_append_attention": []}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def pool_and_tables(lens, kh, hd, dtype):
        """Pages of a 2-layer store (layer 1 is passed, as the model
        does), each row on shuffled pages, rows 0 and 1 sharing their
        first page."""
        nb = max(1, max(-(-n // bs) for n in lens))
        n_pages = len(lens) * nb + 7
        kp = randn(2, n_pages, kh, bs, hd, dtype=dtype)[1]
        vp = randn(2, n_pages, kh, bs, hd, dtype=dtype)[1]
        perm = torch.randperm(n_pages, generator=gen, device=dev)
        tables = perm[:len(lens) * nb].reshape(len(lens), nb).to(torch.int32)
        if len(lens) > 1:
            tables[1, 0] = tables[0, 0]
        return kp, vp, tables.contiguous()

    def gathered(pages, tables):
        """(B, K, nb*bs, hd) dense K/V: the yardstick's input."""
        b, nb = tables.shape
        _, kh, _, hd = pages.shape
        return pages[tables.long()].transpose(1, 2).reshape(b, kh, nb * bs,
                                                            hd)

    def check(name, out, exp, dtype, label):
        err = (out.float() - exp.float()).abs().max().item() \
            if out.numel() else 0.0
        if not torch.allclose(out.float(), exp.float(), atol=TOL[dtype],
                              rtol=TOL[dtype]):
            raise AssertionError(f"{name} {label}: max |err| {err} beyond "
                                 f"atol = rtol = {TOL[dtype]}")
        return err

    decode_cases = [("base", [0, 1, 77, 640]), ("base", [130]),
                    ("small", [1, 300, 777, 1024]),
                    ("minitron", [4096] * 8), ("minitron-g16", [4096] * 8)]
    append_cases = [("base", 5, [0, 1, 90, 300], [5, 3, 5, 4]),
                    ("base", 16, [1, 100], [16, 11]),
                    ("base", 64, [0, 200, 37], [64, 40, 64]),
                    ("base", 256, [0, 500], [256, 199]),
                    ("small", 5, [0, 1, 700], [5, 2, 5]),
                    ("small", 16, [17, 1000], [16, 9]),
                    ("small", 64, [64, 3], [50, 64]),
                    ("small", 256, [0, 300], [256, 100]),
                    ("minitron", 5, [4096] * 8, [5] * 8),
                    ("minitron", 64, [4096] * 8, [64] * 8)]
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        esize = torch.tensor([], dtype=dt).element_size()
        for model, lens in decode_cases:
            h, kh, hd = heads[model]
            b = len(lens)
            kp, vp, tables = pool_and_tables(lens, kh, hd, dt)
            q = randn(b, h, hd, dtype=dt)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            label = f"{model} {dname} B={b} lengths={lens[:4]}" + (
                "..." if b > 4 else "")
            live = lengths > 0     # the plain version averages an empty row
            out = paged_decode(q, kp, vp, tables, lengths)
            err = check("paged_decode_attention", out[live],
                        ref.paged_decode_reference(q, kp, vp, tables,
                                                   lengths)[live],
                        dname, label)
            if not torch.all(out[~live] == 0):
                raise AssertionError(f"paged_decode_attention {label}: an "
                                     "empty row is not 0")
            kd, vd = gathered(kp, tables), gathered(vp, tables)
            mask = (torch.arange(kd.shape[2], device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            ms = time_ms(torch, lambda: paged_decode(q, kp, vp, tables,
                                                     lengths))
            plain_ms = time_ms(torch, lambda: ref.paged_decode_reference(
                q, kp, vp, tables, lengths))
            q4 = q[:, :, None, :]
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kd, vd, attn_mask=mask, enable_gqa=True))
            keys = sum(lens)
            nbytes = (2 * q.numel() + 2 * keys * kh * hd) * esize \
                + 4 * (b + sum(-(-n // bs) for n in lens))
            bound_ms, by = bound(nbytes, 4 * hd * h * keys, dname)
            plan = paged_mod.plan(q, kp, vp, tables)
            records["paged_decode_attention"].append(dict(
                shape=label, dtype=dname, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=by, split=[plan["n_split"], plan["split_keys"]],
                vector_bytes=plan["vector_bytes"]))
            print(f"[kernels] paged_decode_attention {label}: err {err:.3g} "
                  f"| kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                  f"over gathered K/V (gather excluded) {lib_ms:.4f} ms, "
                  f"bound {bound_ms:.5f} ms ({by}) | "
                  + decode_plan_note(plan, label), flush=True)

        for model, t, ctx, span in append_cases:
            h, kh, hd = heads[model]
            b = len(ctx)
            kp, vp, tables = pool_and_tables([c + t for c in ctx], kh, hd, dt)
            q = randn(b, t, h, hd, dtype=dt)
            kn = randn(b, t, kh, hd, dtype=dt)
            vn = randn(b, t, kh, hd, dtype=dt)
            cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
            sl = torch.tensor(span, dtype=torch.int32, device=dev)
            args = (q, kn, vn, kp, vp, tables, cl, sl)
            label = (f"{model} {dname} T={t} B={b} ctx={ctx[:4]} "
                     f"span={span[:4]}" + ("..." if b > 4 else ""))
            out = paged_append(*args)
            exp = ref.paged_append_reference(*args)
            err = max(check("paged_append_attention", out[i, :n], exp[i, :n],
                            dname, label)        # rows past span_len: unset
                      for i, n in enumerate(span))
            # the yardstick: SDPA over the pre-gathered context with the
            # span appended, under the same mask (gather excluded)
            kd = torch.cat([gathered(kp, tables), kn.transpose(1, 2)], 2)
            vd = torch.cat([gathered(vp, tables), vn.transpose(1, 2)], 2)
            s_ctx = kd.shape[2] - t
            kj = torch.arange(s_ctx + t, device=dev)[None, None, :]
            qi = torch.arange(t, device=dev)[None, :, None]
            mask = ((kj < cl[:, None, None]) & (kj < s_ctx)) | (
                (kj >= s_ctx) & (kj - s_ctx <= qi)
                & (kj - s_ctx < sl[:, None, None]))
            qh = q.transpose(1, 2)
            ms = time_ms(torch, lambda: paged_append(*args))
            plain_ms = time_ms(torch, lambda: ref.paged_append_reference(
                *args), reps=5 if model == "minitron" else 30)
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kd, vd, attn_mask=mask[:, None], enable_gqa=True))
            slots, _ = tile_plan.card_occupancy(
                "paged_append_attention", DTYPES[dt], hd,
                min(tile_plan.ROWS, t * (h // kh)),
                torch.cuda.current_device())
            split = tile_plan.split_plan(b, t, h, kh, tables.shape[1] * bs,
                                         slots)
            pairs = sum(n * c + n * (n + 1) // 2 for c, n in zip(ctx, span))
            real = sum(span)
            nbytes = (2 * real * h * hd + 2 * real * kh * hd
                      + 2 * sum(ctx) * kh * hd) * esize \
                + 4 * (2 * b + sum(-(-(c + n) // bs)
                                   for c, n in zip(ctx, span)))
            bound_ms, by = bound(nbytes, 4 * hd * h * pairs, dname)
            records["paged_append_attention"].append(dict(
                shape=label, dtype=dname, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=by, split=list(split), slots=slots))
            print(f"[kernels] paged_append_attention {label}: err {err:.3g} "
                  f"| kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                  f"over gathered K/V (gather excluded) {lib_ms:.4f} ms, "
                  f"bound {bound_ms:.5f} ms ({by}) | split {split[0]} x "
                  f"{split[1]} keys, {slots} blocks at once", flush=True)
    return records


def main_path_phase(torch, serve, decode_kernel, flash_kernel, ckpt):
    """Serve 3 specreason requests on the card, greedy and sampled, by the
    CLI's default fused decode loop; the kernels' launch counts must equal
    n_layers x the metered decode steps and prefill calls."""
    launches = {"decode_attention": 0, "flash_attention": 0}
    greedy = None
    for label, temp in (("greedy", "0"), ("sampled", "0.6")):
        decode_kernel.launches = 0
        flash_kernel.launches = 0
        report = serve.main(["--scheme", "specreason", "-n", "3",
                             "--budget", "128", "--temperature", temp,
                             "--threshold", str(THRESHOLD),
                             "--ckpt-dir", ckpt, "--device", "cuda",
                             "--meters"])
        got = (decode_kernel.launches, flash_kernel.launches)
        layers = {"base": report.base.model.cfg.n_layers,
                  "small": report.small.model.cfg.n_layers}
        want = [0, 0]
        for _, i, _, res in report.runs:
            if not res.steps or not res.thinking_ids:
                raise AssertionError(f"{label} req{i}: empty step trace")
            for name, m in res.meters.items():
                # a fused call is one call of many one-token steps
                want[0] += layers[name] * m["decode_steps"]
                want[1] += layers[name] * m["prefill_calls"]
            toks = res.thinking_ids + res.answer_ids
            print(f"[main] {label} req{i}: {res.wall_time * 1e3:.1f} ms, "
                  f"{len(toks)} tokens, {len(toks) / res.wall_time:.1f} "
                  f"tok/s, {len(res.steps)} steps "
                  f"({sum(s.accepted for s in res.steps if s.source == 'small')}"
                  f" accepted / {sum(s.source == 'small' for s in res.steps)}"
                  " drafted)", flush=True)
        drafted = [s for *_, res in report.runs for s in res.steps
                   if s.source == "small"]
        if label == "greedy" and len({s.accepted for s in drafted}) < 2:
            raise AssertionError("greedy run saw only one verifier "
                                 "decision; both paths must run")
        if list(got) != want or min(got) == 0:
            raise AssertionError(f"{label}: launches (decode, prefill) "
                                 f"{got} != n_layers x meter calls {want}")
        print(f"[main] {label} (decode loop {report.decode_loop}): launches "
              f"decode {got[0]}, prefill {got[1]} == n_layers x metered "
              "decode steps and prefill calls", flush=True)
        launches["decode_attention"] += got[0]
        launches["flash_attention"] += got[1]
        if greedy is None:
            greedy = report
    return launches, greedy


def check_phase(torch, Model, load_checkpoint, testbed, serve, tasks,
                loader, greedy, ckpt):
    """Card logits against the CPU on the same checkpoint; then, for
    information, the greedy agreement of request 0 between them."""
    prompt = tasks.question_tokens(greedy.runs[0][2])
    for cfg in (testbed.BASE, testbed.SMALL):
        m = Model(cfg)
        logits = {}
        for dev in ("cuda", "cpu"):
            params = load_checkpoint(loader.checkpoint_path(ckpt, cfg), dev)
            st = m.init_state(1, CACHE, device=dev)
            toks = torch.tensor([prompt], device=dev)
            out, st = m.prefill(params, toks, st)
            outs = [out[0]]
            for t in (5, 17, 33):
                out, st = m.decode_step(params, st,
                                        torch.tensor([[t]], device=dev))
                outs.append(out)
            logits[dev] = torch.cat(outs).float().cpu()
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        if not torch.allclose(logits["cuda"], logits["cpu"], atol=LOGIT_TOL,
                              rtol=LOGIT_TOL):
            raise AssertionError(f"{cfg.name}: card vs CPU logits differ by "
                                 f"{err} (> {LOGIT_TOL})")
        print(f"[check] {cfg.name}: card vs CPU logits max |diff| {err:.3g}"
              f" (tolerance {LOGIT_TOL})", flush=True)
    base, small = loader.load_testbed_engines(ckpt, "cpu")
    _, _, task, card = greedy.runs[0]
    cpu = serve.run_scheme("specreason", base, small, task,
                           torch.Generator().manual_seed(0), 128, THRESHOLD,
                           0.0)
    a, b = card.thinking_ids, cpu.thinking_ids
    n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    print(f"[check] greedy req0, card vs CPU (information): {n} leading "
          f"thinking tokens agree of {len(a)} / {len(b)}", flush=True)


def rows_check_phase(torch, Model, BatchEngine, testbed, load_checkpoint,
                     loader, ckpt):
    """The batched paged path's logits, card against CPU: one
    ``prefill_rows`` and one ``decode_rows`` step on 3 ragged rows."""
    prompts = [list(range(10, 15)), list(range(20, 39)),
               list(range(5, 38))]
    for cfg in (testbed.BASE, testbed.SMALL):
        m = Model(cfg)
        logits = {}
        for dev in ("cuda", "cpu"):
            params = load_checkpoint(loader.checkpoint_path(ckpt, cfg), dev)
            be = BatchEngine(m, params, batch=4, capacity=CACHE)
            rows = [be.alloc_row() for _ in prompts]
            ext = be.extend_rows(rows, prompts, want_logits=True)
            be.feed_rows(rows, [7, 8, 9])
            logits[dev] = torch.cat(ext + [be.last_logits[rows]]).cpu()
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        if not torch.allclose(logits["cuda"], logits["cpu"], atol=LOGIT_TOL,
                              rtol=LOGIT_TOL):
            raise AssertionError(f"{cfg.name} batched rows: card vs CPU "
                                 f"logits differ by {err} (> {LOGIT_TOL})")
        print(f"[check] {cfg.name} batched rows (prefill_rows + decode_rows,"
              f" 3 ragged rows): card vs CPU logits max |diff| {err:.3g} "
              f"(tolerance {LOGIT_TOL})", flush=True)


def dense_rows_check_phase(torch, Model, BatchEngine, loader, kernels,
                           published):
    """The batched paged path at minitron-4b's published widths (depth cut
    to DENSE_DEPTH layers, random init from a seed, vocabulary cut to the
    toy tokenizer's 64), card against CPU: 3 rows commit about 2K tokens
    in extends of up to 256, then a 5-token and a 64-token span (buckets 8
    and 64: a verification and a chunk) with logits, then one
    ``feed_rows``.  Paged-append launches must equal n_layers x the
    extends, paged-decode launches n_layers x the decode steps."""
    import dataclasses
    cfg = dataclasses.replace(loader.arch_config(DENSE_ARCH),
                              n_layers=DENSE_DEPTH)
    m = Model(cfg)
    t0 = time.perf_counter()
    cpu_params = m.init(3, device="cpu")
    rng = random.Random(3)
    ctx = [2048, 1931, 2000]
    prompts = [[rng.randrange(cfg.vocab_size) for _ in range(n)] for n in ctx]
    spans = [[[rng.randrange(cfg.vocab_size) for _ in range(n)]
              for n in lens] for lens in ([5, 3, 5], [64, 64, 40])]
    logits, extends = {}, 0
    for dev in ("cuda", "cpu"):
        params = cpu_params if dev == "cpu" else \
            tree_map(lambda t: t.to(dev), cpu_params)
        be = BatchEngine(m, params, batch=len(ctx), capacity=2304)
        rows = [be.alloc_row() for _ in ctx]
        for k in kernels.values():
            k.launches = 0
        for s0 in range(0, max(ctx), 256):
            live = [i for i, n in enumerate(ctx) if s0 < n]
            be.extend_rows([rows[i] for i in live],
                           [prompts[i][s0:s0 + 256] for i in live])
        out = []
        for toks in spans:
            out += be.extend_rows(rows, toks, want_logits=True)
        be.feed_rows(rows, [7, 8, 9])
        logits[dev] = torch.cat(out + [be.last_logits[rows]]).float().cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
            n = cfg.n_layers
            extends = be.meter.prefill_calls
            got = (kernels["paged_append_attention"].launches,
                   kernels["paged_decode_attention"].launches)
            if got != (n * extends, n * be.meter.decode_steps) \
                    or not extends or any(
                        k.launches for name, k in kernels.items()
                        if not name.startswith("paged")):
                raise AssertionError(
                    f"{DENSE_ARCH} rows: launches (paged append, paged "
                    f"decode) {got} != {n} x ({extends} extends, "
                    f"{be.meter.decode_steps} decode steps), dense 0")
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    scale = logits["cpu"].abs().max().item()
    if not torch.allclose(logits["cuda"], logits["cpu"], atol=LOGIT_TOL,
                          rtol=LOGIT_TOL):
        raise AssertionError(f"{DENSE_ARCH} batched rows: card vs CPU "
                             f"logits differ by {err} (> {LOGIT_TOL})")
    print(f"[check] {DENSE_ARCH} batched rows (published widths: d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, hd "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}; cut: {DENSE_DEPTH} of "
          f"{published.n_layers} layers, vocabulary {published.vocab_size} -> "
          f"{cfg.vocab_size}; random init, "
          f"seed 3): 3 rows over {ctx} committed tokens, 5- and 64-token "
          f"spans and one feed_rows; card vs CPU logits max |diff| "
          f"{err:.3g} at max |logit| {scale:.3g} (tolerance {LOGIT_TOL}); "
          f"paged-append launches {n * extends} == {n} x {extends} extends;"
          f" {time.perf_counter() - t0:.1f} s", flush=True)


def continuous_phase(torch, serve, kernels, ckpt):
    """Serve the continuous path on the card through the CLI's default
    decode loop (the batched rows' fused loop, CUDA graphs with #3
    inside); check the launch counters (a graph's paged-decode launches
    count on each replay, and the engines' decode steps count masked and
    warm-up steps), that a pressured greedy run gives the unpressured
    greedy tokens, and that a greedy run with the prefix cache on (the
    CLI's default), each request sampled twice so that the second
    sample's prompt is a cache hit, gives each request the cache-off
    greedy tokens.  Returns (paged launches per kernel, greedy
    report)."""
    argv = ["--scheduler", "continuous", "-n", "8",
            "--batch", "4", "--budget", "128", "--threshold", str(THRESHOLD),
            "--ckpt-dir", ckpt, "--device", "cuda"]
    off = ["--no-prefix-cache"]
    runs = [("greedy", off + ["--temperature", "0"]),
            ("sampled", off + ["--temperature", "0.6"]),
            ("spec greedy", off + ["--temperature", "0", "--spec-decode",
                                   "--gamma", "4"]),
            ("spec sampled", off + ["--temperature", "0.6", "--spec-decode",
                                    "--gamma", "4"]),
            ("pressured greedy", off + ["--temperature", "0",
                                        "--kv-budget-mb", str(PRESSURE_MB)]),
            ("cache greedy", ["--temperature", "0", "--num-samples", "2"])]
    launches = {"paged_decode_attention": 0, "paged_append_attention": 0}
    reports = {}
    for label, extra in runs:
        for k in kernels.values():
            k.launches = 0
        report = serve.main(argv + extra)
        got = {n: k.launches for n, k in kernels.items()}
        sched, st = report.sched, report.stats
        want_decode = want_append = 0
        for be in (sched.base_be, sched.small_be):
            n = be.model.cfg.n_layers
            want_decode += n * be.meter.decode_steps
            want_append += n * be.meter.prefill_calls
        if (got["paged_decode_attention"], got["paged_append_attention"]) \
                != (want_decode, want_append) or not want_decode \
                or got["decode_attention"] or got["flash_attention"] \
                or got["ssd_scan"]:
            raise AssertionError(
                f"continuous {label}: launches {got} != paged decode "
                f"{want_decode}, paged append {want_append}, dense and "
                "SSD 0")
        for i, h in enumerate(report.handles):
            res = h.result
            n_out = res.n_thinking_tokens + len(res.answer_ids)
            tpot = h.tpot(n_out)
            acc = [s.accepted for s in res.steps if s.source == "small"]
            print(f"[main] continuous {label} req{i}: latency "
                  f"{h.e2e_latency * 1e3:.1f} ms, TTFT {h.ttft * 1e3:.1f} ms,"
                  f" TPOT {tpot * 1e3:.2f} ms, {n_out} tokens, "
                  f"{sum(acc)} / {len(acc)} drafted steps accepted"
                  + (f", spec {res.spec_stats.accepted}/"
                     f"{res.spec_stats.proposed} over "
                     f"{res.spec_stats.rounds} rounds"
                     if res.spec_stats.rounds else ""), flush=True)
        steps = [s for *_, res in report.runs for s in res.steps
                 if s.source == "small"]
        print(f"[main] continuous {label}: {st['tok_s']} tok/s, "
              f"{st['req_s']} req/s, wall {st['wall_s']} s, ticks "
              f"{st['ticks']}, preemptions {st['preemptions']}, accepted "
              f"steps {sum(s.accepted for s in steps)} / {len(steps)}, "
              f"TTFT p50 {st.get('p50_ttft_s')} s p95 {st.get('p95_ttft_s')}"
              f" s, TPOT p50 {st.get('p50_tpot_s')} s p95 "
              f"{st.get('p95_tpot_s')} s"
              + (f", spec mean accepted length "
                 f"{st['spec_mean_accepted_len']} (acceptance "
                 f"{st['spec_acceptance_rate']})" if 'spec_requests' in st
                 else "") + f"; decode loop {st['decode_loop']}; launches "
              f"paged decode {got['paged_decode_attention']}, paged append "
              f"{got['paged_append_attention']} == n_layers x metered "
              f"steps/extends; dense 0; KV store bytes "
              f"{st['kv_store_bytes']} (accounted "
              f"{st['kv_accounted_bytes']}; each store's bytes include its "
              f"scratch page, where masked rows write: "
              + ", ".join(str(be.store.scratch_bytes) for be in
                          (sched.base_be, sched.small_be))
              + " bytes)", flush=True)
        launches["paged_decode_attention"] += got["paged_decode_attention"]
        launches["paged_append_attention"] += got["paged_append_attention"]
        reports[label] = report

    def tokens(report):
        return [r.thinking_ids + r.answer_ids for *_, r in report.runs]
    press = reports["pressured greedy"]
    if press.sched.preemptions < 1:
        raise AssertionError(f"--kv-budget-mb {PRESSURE_MB} preempted no "
                             "request")
    if tokens(press) != tokens(reports["greedy"]):
        raise AssertionError("pressured greedy tokens differ from the "
                             "unpressured run's")
    print(f"[main] continuous: the pressured run ({press.sched.preemptions} "
          "preemptions) gives the unpressured greedy tokens", flush=True)
    cached = reports["cache greedy"]
    stats = cached.sched.cache_stats()
    if stats["base"]["hit_tokens"] <= 0:
        raise AssertionError(f"cache greedy: no cache hit ({stats})")
    # request i's two samples (2i, 2i + 1) against the cache-off request i
    if tokens(cached) != [t for t in tokens(reports["greedy"])
                          for _ in range(2)]:
        raise AssertionError("cache-on greedy tokens differ from the "
                             "cache-off run's")
    print(f"[main] continuous: with the prefix cache on (the CLI's default;"
          f" base {stats['base']}) both samples of each request give its "
          "cache-off greedy tokens", flush=True)
    spec, plain = tokens(reports["spec greedy"]), tokens(reports["greedy"])
    same = sum(a == b for a, b in zip(spec, plain))
    print(f"[main] continuous (information): spec-decode greedy tokens equal"
          f" plain greedy for {same} of {len(spec)} requests", flush=True)
    for name, n in resilience_cli_check(serve, kernels, argv).items():
        launches[name] += n
    return launches, reports["greedy"]


def resilience_cli_check(serve, kernels, argv):
    """The serve CLI with the overload and fault flags on the testbed
    pair (spec decode, the prefix cache on): ``--inject-faults 7:3
    --audit --deadline 30 --slo-tpot 0.5 --shed-policy priority
    --degrade --trace --metrics-out`` must run through, print a
    ``[resilience]`` line with ``audit_violations=0``, leave every
    request terminal, launch #3 and #4 n_layers x the metered calls and
    write a trace and metrics that parse.  Returns its paged launches."""
    import contextlib
    import io
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prom = os.path.join(tmp, "metrics.prom")
        for k in kernels.values():
            k.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            report = serve.main(argv + [
                "--temperature", "0", "--spec-decode", "--gamma", "4",
                "--inject-faults", "7:3", "--audit", "--deadline", "30",
                "--slo-tpot", "0.5", "--shed-policy", "priority",
                "--degrade", "--trace", trace, "--metrics-out", prom])
        text = out.getvalue()
        got = {n: k.launches for n, k in kernels.items()}
        sched = report.sched
        want = (sum(be.model.cfg.n_layers * be.meter.decode_steps
                    for be in (sched.base_be, sched.small_be)),
                sum(be.model.cfg.n_layers * be.meter.prefill_calls
                    for be in (sched.base_be, sched.small_be)))
        line = next((ln for ln in text.splitlines()
                     if ln.startswith("[resilience]")), "")
        doc = json.load(open(trace))
        samples = parse_prometheus(open(prom).read())
        if "audit_violations=0" not in line \
                or not all(h.terminal for h in report.handles) \
                or (got["paged_decode_attention"],
                    got["paged_append_attention"]) != want \
                or "scheduler" not in trace_tracks(doc) \
                or "specreason_ticks_total" not in samples:
            raise AssertionError(f"continuous resilience CLI: {line!r}, "
                                 f"launches {got} against {want}\n{text}")
    print(f"[main] continuous resilience CLI (--inject-faults 7:3 --audit "
          f"--deadline 30 --slo-tpot 0.5 --shed-policy priority --degrade "
          f"--trace --metrics-out): {line}; statuses "
          f"{dict(collections.Counter(h.status for h in report.handles))}; "
          f"trace {len(doc['traceEvents'])} events, metrics "
          f"{len(samples)} samples; launches paged decode "
          f"{got['paged_decode_attention']}, paged append "
          f"{got['paged_append_attention']} == n_layers x metered "
          "steps/extends", flush=True)
    return {n: got[n] for n in ("paged_decode_attention",
                                "paged_append_attention")}


def batch_invariance_phase(torch, serve, tasks, Model, load_checkpoint,
                           testbed, loader, ckpt, greedy):
    """Information, not a check: continuous greedy tokens against the
    sequential path's on the card, with the first differing token and
    the logit gap there."""
    seq = serve.main(["--scheme", "specreason", "-n", "8", "--budget", "128",
                      "--temperature", "0", "--threshold", str(THRESHOLD),
                      "--ckpt-dir", ckpt, "--device", "cuda"])
    models = {}
    for cfg in (testbed.BASE, testbed.SMALL):
        models[cfg.name] = (Model(cfg), load_checkpoint(
            loader.checkpoint_path(ckpt, cfg), "cuda"))
    same = 0
    for (_, i, task, a), (_, _, _, b) in zip(greedy.runs, seq.runs):
        ta, tb = a.thinking_ids + a.answer_ids, b.thinking_ids + b.answer_ids
        if ta == tb:
            same += 1
            continue
        k = next((j for j, (x, y) in enumerate(zip(ta, tb)) if x != y),
                 min(len(ta), len(tb)))
        prefix = tasks.question_tokens(task) + ta[:k]
        gaps = []
        if k < min(len(ta), len(tb)):
            for name, (m, p) in models.items():
                with torch.no_grad():
                    lg = m.forward(p, torch.tensor([prefix], device="cuda"))
                gap = lg[0, -1, ta[k]] - lg[0, -1, tb[k]]
                gaps.append(f"{name} {gap:.3g}")
        print(f"[main] batch invariance req{i}: first difference at output "
              f"token {k} (continuous {ta[k] if k < len(ta) else None}, "
              f"sequential {tb[k] if k < len(tb) else None}); logit gap "
              f"there (continuous - sequential token): {', '.join(gaps)}",
              flush=True)
    print(f"[main] batch invariance (information): {same} of "
          f"{len(greedy.runs)} requests' continuous greedy tokens equal the "
          "sequential path's on the card", flush=True)


# fused turns, then one per-token turn of req0 each way
SEQ_RUNS = (("greedy", "specreason", 0.0, 3, None),
            ("sampled", "specreason", 0.6, 3, None),
            ("greedy eager", "specreason", 0.0, 1, False),
            ("sampled eager", "specreason", 0.6, 1, False))


def tokens_of(res):
    return res.thinking_ids + res.answer_ids


def sequential_turns(torch, serve, base, small, reqs, kernels, tag, want,
                     formula, threshold, budget=128, runs=SEQ_RUNS):
    """Sequential SpecReason (``serve.run_scheme``) with ``base`` and
    ``small`` on the card: each run (label, scheme, temperature,
    requests, fused) serves its first requests of ``reqs``, every count
    set to 0 just before it and read just after.  ``want(mb, ms,
    encodes)`` gives the launches a request must make from the base's
    and SMALL's meters and the sources the base encoded; a run's counts
    must equal their sum, every kernel of it must have launched and no
    other, and after every request each engine has captured once per
    loop key.  ``formula`` says in the run's line what the counts
    equal.  The eager runs' req0 tokens must equal the fused runs'.
    Returns ({label: [results]}, launches of the kernels)."""
    launches = dict.fromkeys(kernels, 0)
    results = {}
    for label, scheme, temp, n_req, fused in runs:
        for k in kernels.values():
            k.launches = 0
        expect = {}
        results[label] = []
        for i in range(n_req):
            gen = torch.Generator(device="cuda").manual_seed(i)
            encodes = base.encodes
            res = serve.run_scheme(scheme, base, small, reqs[i], gen, budget,
                                   threshold, temp, fused=fused)
            mb, ms_ = res.meters["base"], res.meters["small"]
            for k, n in want(mb, ms_, base.encodes - encodes).items():
                expect[k] = expect.get(k, 0) + n
            for eng in (base, small):
                if eng.captures != len(eng._loops):
                    raise AssertionError(
                        f"{tag} {label} req{i}: {eng.name} captured "
                        f"{eng.captures} graphs for {len(eng._loops)} keys")
            results[label].append(res)
            toks = tokens_of(res)
            steps = [s for s in res.steps if s.source == "small"]
            print(f"[main] {tag} {label} req{i}: {res.wall_time * 1e3:.1f} "
                  f"ms, {len(toks)} tokens, {len(toks) / res.wall_time:.1f} "
                  f"tok/s, {len(res.steps)} steps "
                  f"({sum(s.accepted for s in steps)} accepted / "
                  f"{len(steps)} drafted; utilities "
                  f"{[round(s.utility, 4) for s in steps]}), base "
                  f"{mb['prefill_calls']} extends / {mb['decode_calls']} "
                  f"decode calls of {mb['decode_tokens']} tokens in "
                  f"{mb['decode_steps']} steps; captures base "
                  f"{base.captures}, small {small.captures}" + (
                      f"; spec {res.spec_stats.accepted}/"
                      f"{res.spec_stats.proposed} over "
                      f"{res.spec_stats.rounds} rounds"
                      if res.spec_stats.rounds else ""), flush=True)
        got = {k: kernels[k].launches for k in expect}
        if got != expect or not all(expect.values()) or any(
                kernels[k].launches for k in kernels if k not in expect):
            now = {k: v.launches for k, v in kernels.items()}
            raise AssertionError(f"{tag} {label}: launches {now} != "
                                 f"{expect} (others 0)")
        loop = "eager" if fused is False else "fused"
        print(f"[main] {tag} {label} (decode loops {loop}): launches "
              f"{', '.join(f'{k} {n}' for k, n in got.items())}; {formula};"
              " no other kernel", flush=True)
        for k in expect:
            launches[k] += got[k]
    for label in ("greedy", "sampled"):
        if tokens_of(results[f"{label} eager"][0]) != \
                tokens_of(results[label][0]):
            raise AssertionError(f"{tag} {label} req0: the eager turn's "
                                 "tokens differ from the fused turn's")
    print(f"[main] {tag}: the eager turn's tokens equal the fused turn's "
          f"(greedy req0 and sampled req0); base {base.captures} captures "
          f"for {len(base._loops)} keys, small {small.captures} for "
          f"{len(small._loops)}", flush=True)
    return results, launches


def ssm_main_phase(torch, serve, tasks, loader, kernels):
    """SpecReason with the mamba2-1.3b base on the card, both engines on
    their default decode loop (the fused one): 3 requests greedy and
    sampled, one greedy request in hierarchical mode; then one eager turn
    of the first greedy and the first sampled request, whose tokens must
    equal the fused turn's.  The SSD scan must launch 48 x the base's
    metered extends and the dense kernels SMALL's layers x its metered
    decode steps (masked and warm-up steps included) and prefill calls.
    Returns (launches, base engine)."""
    t0 = time.perf_counter()
    base = loader.random_engine(SSM_ARCH, "cuda", seed=0)
    small = loader.random_engine("testbed-small", "cuda", seed=1)
    torch.cuda.synchronize()
    cfg = base.model.cfg
    print(f"[main] ssm: {SSM_ARCH} base, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.ssm_n_heads} SSD heads of {cfg.ssm_head_dim}"
          f", state {cfg.ssm_state}, vocab {cfg.vocab_size} (cut from 50280)"
          f", {sum(t.numel() for t in leaves(base.params))} "
          f"parameters, random init in {time.perf_counter() - t0:.1f} s; "
          f"testbed SMALL drafter; threshold {SSM_THRESHOLD}; decode loops "
          f"{loader.decode_loops(base, small)}", flush=True)
    rng = random.Random(0)
    reqs = [tasks.sample_task(rng) for _ in range(3)]
    nb, ns = cfg.n_layers, small.model.cfg.n_layers
    runs = SEQ_RUNS[:2] + (("hierarchical greedy", "specreason+decode", 0.0,
                            1, None),) + SEQ_RUNS[2:]
    results, launches = sequential_turns(
        torch, serve, base, small, reqs, kernels, "ssm",
        lambda mb, ms_, _: {
            "ssd_scan": nb * mb["prefill_calls"],
            "decode_attention": ns * ms_["decode_steps"],
            "flash_attention": ns * ms_["prefill_calls"]},
        f"ssd_scan == {nb} x base extends; decode and flash == {ns} x "
        "SMALL's decode steps and prefill calls", SSM_THRESHOLD, runs=runs)
    drafted = [s for res in results["greedy"] for s in res.steps
               if s.source == "small"]
    if len({s.accepted for s in drafted}) < 2:
        raise AssertionError("ssm greedy run saw only one verifier "
                             "decision; both paths must run")
    same = tokens_of(results["hierarchical greedy"][0]) == \
        tokens_of(results["greedy"][0])
    print(f"[main] ssm (information): hierarchical greedy req0 tokens "
          f"{'equal' if same else 'differ from'} plain greedy req0's",
          flush=True)
    ssm_profile(torch, serve, base, small, reqs[2], kernels,
                results["greedy"][2].wall_time)
    return launches, base


def profile_request(torch, run, counter=None, plain=None, reset=None):
    """Information: ``run()`` (one request or call, returning its result)
    in a window of a trace bounded by pads on the device's clock
    (``repro_torch.launch.trace_window.trace``, whose dict it returns).
    The caller has run the same call unprofiled in its turns: ``plain``
    is the last such turn's wall in s, or None where no turn ran it.
    A trace that holds fewer than all PAD pads after the window lost its
    end (the pads follow the run's last record and a synchronize, so
    only the profiler can have dropped them): the call is traced again,
    after ``reset()`` where given, up to TRACE_TRIES traces, and raises
    if every trace lost its end.  Adds ``counted``, with a kernel
    wrapper ``counter`` its launch count's increase over the kept
    trace's run; ``top``, a note of the zero-length records, the pads,
    the traces taken, the trace's stop and read seconds and the largest
    rows; and ``window``, a note of the device's busy time, the window's
    wall and idle share, and the wall the trace added to the unprofiled
    call."""
    from repro_torch.launch.trace_window import PAD, trace
    for tries in range(1, TRACE_TRIES + 1):
        if tries > 1 and reset is not None:
            reset()
        before = counter.launches if counter is not None else 0
        p = trace(run)
        if p["pads"][1] == PAD:
            break
        print(f"[profile] trace {tries} of at most {TRACE_TRIES} lost its "
              f"end: pads {p['pads'][0]}+{p['pads'][1]}/{2 * PAD}, "
              f"{p['records']} device records", flush=True)
    else:
        raise AssertionError(f"[profile] all {TRACE_TRIES} traces lost "
                             "their end")
    p["counted"] = counter.launches - before if counter is not None \
        else None
    p["top"] = (f"{p['zero']} of {p['records']} device records of zero "
                f"length; pads {p['pads'][0]}+{p['pads'][1]}/{2 * PAD}"
                f" (trace {tries}); "
                f"trace stopped in {p['stop_s']:.1f} s and read in "
                f"{p['read_s']:.1f} s; top device time: "
                + "; ".join(f"{k[:48]} {t / 1e3:.1f} ms x{n}"
                            for k, t, n in p["rows"][:8]))
    p["window"] = (
        f"device busy {p['busy']:.4f} s in a profiled window of "
        f"{p['wall']:.4f} s, idle share {p['idle']:.4f} of it; "
        + ("not run alone unprofiled" if plain is None else
           f"unprofiled {plain:.4f} s (its last turn): the trace added "
           f"{p['wall'] - plain:+.4f} s"))
    return p


def gate(p, seen, tag, kernel):
    """The profiler gate: the trace's count of ``kernel`` (``traced``)
    equals the wrapper's counter over the profiled run, and is not 0."""
    if seen != p["counted"] or not seen:
        raise AssertionError(
            f"[profile] {tag}: the profiler saw {seen} {kernel} launches, "
            f"the wrapper counted {p['counted']}; {p['top'][:160]}")


def traced(rows, kernel):
    """(launches, device ms) of the ``__global__`` function ``kernel`` in
    a profile's rows (its template instances summed)."""
    pat = re.compile(r"(?<![\w])" + kernel + r"[<(]")
    hits = [(t, n) for k, t, n in rows if pat.search(k)]
    return sum(n for _, n in hits), sum(t for t, _ in hits) / 1e3


def ssm_profile(torch, serve, base, small, task, kernels, plain):
    """One greedy ssm request profiled each way (``profile_request``):
    idle share and device time by kernel; the profiler's count of the
    drafter's flash-decode launches must equal the wrapper's.  ``plain``:
    the request's unprofiled wall in the fused greedy turn (the eager
    turns run req0 only)."""
    for loop in ("fused", "eager"):
        def run():
            gen = torch.Generator(device="cuda").manual_seed(2)
            return serve.run_scheme("specreason", base, small, task, gen,
                                    128, SSM_THRESHOLD, 0.0,
                                    fused=loop == "fused")
        mine = plain if loop == "fused" else None
        p = profile_request(torch, run, kernels["decode_attention"], mine)
        n_out = len(p["res"].thinking_ids + p["res"].answer_ids)
        seen, dev_ms = traced(p["rows"], "decode_kernel")
        gate(p, seen, f"ssm greedy req2 {loop}", "decode_kernel")
        rate = "" if mine is None else \
            f", {n_out / mine:.1f} tok/s unprofiled"
        print(f"[profile] ssm greedy req2 ({loop}, {n_out} tokens{rate}): "
              f"{p['window']}; decode_kernel {seen} launches traced == "
              f"{p['counted']} counted, {dev_ms:.1f} ms; {p['top']}",
              flush=True)


def mib(n):
    return f"{n / 2 ** 20:.1f} MiB"


def loop_bytes(eng):
    """(device bytes, pinned host bytes) of the tensors of an engine's
    fused-loop buffers, sequential or batched (the KV caches, the graphs'
    own pools and a batched engine's shared tables and logits
    excluded)."""
    import dataclasses
    dev = host = 0
    for loop in eng._loops.values():
        for f in dataclasses.fields(loop):
            t = getattr(loop, f.name)
            if hasattr(t, "is_cuda"):
                n = t.numel() * t.element_size()
                dev, host = (dev + n, host) if t.is_cuda else (dev, host + n)
    return dev, host


def graph_pool_bytes(torch):
    """Bytes the caching allocator holds in private pools (the CUDA
    graphs' own), from its snapshot; None where the snapshot does not
    name pools."""
    segs = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in sg for sg in segs):
        return None
    return sum(sg["total_size"] for sg in segs
               if tuple(sg["segment_pool_id"]) != (0, 0))


def memory_mark(torch):
    """(reserved bytes, graph pool bytes) now, for ``memory_line``.  An
    engine whose ``generate_fused`` ``fused_phase`` wrapped is a cycle:
    collect it first, so that its graphs' pools do not leave later."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(), graph_pool_bytes(torch)


def memory_line(torch, engines, mark):
    reserved0, pools0 = mark
    gc.collect()
    pools = graph_pool_bytes(torch)
    parts = []
    for n, e in engines.items():
        dev, host = loop_bytes(e)
        if hasattr(e, "store"):
            kv = f"KV pages {mib(e.store.nbytes)}"
        elif e.model.cfg.has_ssm:
            kv = "static conv/ssm state " + mib(sum(
                t.numel() * t.element_size() for st in
                e._ssm_static.values() for t in (st.conv, st.ssm)))
        else:
            kv = "pooled KV pairs " + mib(sum(
                st.k.numel() * st.k.element_size() * 2
                for pairs in e._kv_pool.values() for st, _ in pairs))
        parts.append(f"{n} loop buffers {mib(dev)} on the card and "
                     f"{mib(host)} pinned on the host over {len(e._loops)} "
                     f"keys, {kv}")
    return ("; ".join(parts) + "; graph pools "
            f"{'not measured' if pools is None else mib(pools - pools0)} "
            "and reserved "
            f"{mib(torch.cuda.memory_reserved() - reserved0)} more than "
            "before the first turn")


def record_rows_calls(engines, calls):
    """Wrap each batched engine's ``generate_rows_fused`` to record every
    fused call as (engine, largest clamped budget, k, the longest row's
    tokens, wasted steps, host waits); a capture's warm-up step is not
    wasted."""
    from repro_torch.serving.graph_loop import chunk_steps
    for name, be in engines.items():
        def fused(rows, max_tokens, *args, _be=be, _name=name,
                  _inner=be.generate_rows_fused, **kw):
            budgets = [max_tokens] * len(rows) \
                if isinstance(max_tokens, int) else list(max_tokens)
            top = max((min(m, _be.capacity - int(_be.pos[r]))
                       for r, m in zip(rows, budgets)), default=0)
            m = _be.meter
            before = (m.decode_steps, m.decode_syncs, _be.captures)
            out = _inner(rows, max_tokens, *args, **kw)
            ids = out[0] if isinstance(out, tuple) else out
            if top > 0:
                k = chunk_steps(top)
                longest = max(map(len, ids))
                wasted = (m.decode_steps - before[0]
                          - (_be.captures - before[2]) - longest)
                calls.append((_name, top, k, longest, wasted,
                              m.decode_syncs - before[1]))
            return out
        be.generate_rows_fused = fused


def check_rows_calls(tag, calls):
    """Every fused call waits at most ceil(budget / k) + 1 times and
    wastes at most 2k - 1 steps; returns a summary for a line."""
    bad = [c for c in calls if c[5] > -(-c[1] // c[2]) + 1
           or c[4] > 2 * c[2] - 1]
    if bad or not calls:
        raise AssertionError(f"[fused rows] {tag}: calls beyond ceil(budget"
                             f"/k) + 1 waits or 2k - 1 wasted steps: {bad}")
    n = len(calls)
    return (f"{n} fused calls: waits a call mean "
            f"{sum(c[5] for c in calls) / n:.3f} max "
            f"{max(c[5] for c in calls)}, wasted steps a call mean "
            f"{sum(c[4] for c in calls) / n:.3f} max "
            f"{max(c[4] for c in calls)}, longest row a call mean "
            f"{sum(c[3] for c in calls) / n:.2f} tokens, k "
            f"{sorted(set(c[2] for c in calls))}")


def rows_phase(torch, serve, tasks, paged_kernel, base, small, tag, runs,
               kv_mb, profile=False):
    """The batched engines' fused decode loop against their per-token
    loop on the continuous path, on the card: ``serve``'s continuous
    scheduler over ``base`` and ``small``, ROWS_REQUESTS requests over 4
    rows at ROWS_BUDGET, for each of ``runs`` (label, temperature, spec
    decode) on one scheduler (one pair of batch engines), in turns fused,
    eager, fused.  Tokens must be identical in every turn;
    paged-decode launches == n_layers x the batch engines' decode steps
    (replayed, masked and warm-up steps included); no capture in the
    second fused turn; every fused call within ceil(budget / k) + 1 waits
    and 2k - 1 wasted steps.  Prints tok/s, TPOT p50, decode tok/s inside
    calls, waits and wasted steps a call, captures and capture seconds,
    and the memory the loops hold; with ``profile``, the first run's
    requests profiled each way (idle share, device time by kernel; the
    profiler's count of #3's kernel must equal the wrapper's)."""
    from repro_torch.serving.workload import run_workload, summarize
    rng = random.Random(0)
    reqs = [tasks.sample_task(rng) for _ in range(ROWS_REQUESTS)]
    for label, temp, spec in runs:
        args = serve.parse_args(
            ["--scheduler", "continuous", "--no-prefix-cache", "-n",
             str(ROWS_REQUESTS), "--batch", "4", "--budget",
             str(ROWS_BUDGET), "--temperature", str(temp), "--threshold",
             str(THRESHOLD), "--kv-budget-mb", str(kv_mb), "--device",
             "cuda"] + (["--spec-decode", "--gamma", "4"] if spec else []))
        sched = serve.continuous_scheduler(args, base, small)
        engines = {"base": sched.base_be, "small": sched.small_be}
        calls = []
        record_rows_calls(engines, calls)

        def run(loop):
            for be in engines.values():
                be.fused = loop == "fused"
            gens = [torch.Generator(device="cuda").manual_seed(i)
                    for i in range(ROWS_REQUESTS)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            handles = run_workload(sched, list(zip(reqs, gens)),
                                   [0.0] * ROWS_REQUESTS)
            torch.cuda.synchronize()
            return handles, time.perf_counter() - t0

        mark = memory_mark(torch)
        first, last = None, {}
        for turn, loop in enumerate(TURNS):
            paged_kernel.launches = 0
            before = {n: (be.meter.decode_steps, be.meter.decode_tokens,
                          be.meter.decode_time, be.captures,
                          be.capture_time) for n, be in engines.items()}
            n_calls = len(calls)
            handles, wall = run(loop)
            last[loop] = wall
            st = summarize(handles, wall)
            toks = [h.result.thinking_ids + h.result.answer_ids
                    for h in handles]
            if any(h.status != "ok" for h in handles):
                raise AssertionError(f"[fused rows] {tag} {label} {loop}: "
                                     "a request did not finish")
            want = sum(be.model.cfg.n_layers
                       * (be.meter.decode_steps - before[n][0])
                       for n, be in engines.items())
            if paged_kernel.launches != want or not want:
                raise AssertionError(
                    f"[fused rows] {tag} {label} {loop}: paged decode "
                    f"launches {paged_kernel.launches} != n_layers x decode"
                    f" steps {want}")
            if first is None:
                first = toks
            elif toks != first:
                raise AssertionError(f"[fused rows] {tag} {label}: {loop} "
                                     f"turn {turn} tokens differ from the "
                                     "first turn's")
            caps = {n: be.captures - before[n][3]
                    for n, be in engines.items()}
            if turn == len(TURNS) - 1 and any(caps.values()):
                raise AssertionError(f"[fused rows] {tag} {label}: the "
                                     f"second fused turn captured: {caps}")
            made = {n: (be.meter.decode_tokens - before[n][1],
                        be.meter.decode_time - before[n][2])
                    for n, be in engines.items()}
            inside = "; ".join(
                f"{n} decode {t / max(s, 1e-9):.1f} tok/s inside calls "
                f"({t} tokens)" for n, (t, s) in made.items())
            note = check_rows_calls(f"{tag} {label}", calls[n_calls:]) \
                if loop == "fused" else "per-token loop"
            print(f"[fused rows] {tag} {label} turn {turn} ({loop}): "
                  f"{st['tok_s']} tok/s, TPOT p50 {st.get('p50_tpot_s')} s "
                  f"p95 {st.get('p95_tpot_s')} s, TTFT p50 "
                  f"{st.get('p50_ttft_s')} s, wall {wall:.4f} s, "
                  f"{sum(map(len, toks))} tokens; {inside}; {note}; "
                  f"captures {caps} in "
                  + ", ".join(f"{be.capture_time - before[n][4]:.3f}"
                              for n, be in engines.items())
                  + f" s; paged decode launches {want} == n_layers x decode"
                  " steps", flush=True)
        print(f"[fused rows] {tag} {label}: tokens identical in all "
              f"{len(TURNS)} turns ({len(first)} requests); "
              + "; ".join(f"{n} {be.captures} captures over "
                          f"{len(be._loops)} keys" for n, be in
                          engines.items())
              + f"; memory: {memory_line(torch, engines, mark)}", flush=True)
        if profile:
            profile = False
            for loop in ("fused", "eager"):
                p = profile_request(torch, lambda: run(loop), paged_kernel,
                                    last[loop])
                handles, _ = p["res"]
                n_out = sum(len(h.result.thinking_ids + h.result.answer_ids)
                            for h in handles)
                seen, dev_ms = traced(p["rows"], "paged_decode_kernel")
                gate(p, seen, f"{tag} continuous {loop}",
                     "paged_decode_kernel")
                print(f"[profile] {tag} continuous {label} ({loop}, "
                      f"{ROWS_REQUESTS} requests over 4 rows, {n_out} "
                      f"tokens, {n_out / last[loop]:.1f} tok/s unprofiled):"
                      f" {p['window']}; paged_decode_kernel {seen} launches "
                      f"traced == {p['counted']} counted, {dev_ms:.1f} ms; "
                      f"{p['top']}", flush=True)


def count_queries(be, q):
    """Wrap ``be``'s extends to add the real query tokens each runs
    through #4: ``q[0]`` those of prompt prefills, ``q[1]`` all."""
    inner_extend, inner_prefill = be.extend_rows, be.prefill_rows

    def extend(rows, token_lists, *args, **kw):
        q[1] += sum(map(len, token_lists))
        return inner_extend(rows, token_lists, *args, **kw)

    def prefill(rows, chunks, *args, **kw):
        q[0] += sum(map(len, chunks))
        return inner_prefill(rows, chunks, *args, **kw)
    be.extend_rows, be.prefill_rows = extend, prefill


def first_difference(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def prefix_phase(torch, serve, kernels, base, small):
    """[main] prefix: the radix prefix cache on the continuous path at
    minitron-4b's widths (the base and drafter ``fused_dense_phase``
    loaded): a template family of PREFIX_TASKS tasks expanded best-of-N
    PREFIX_N over 4 rows at ROWS_BUDGET, through ``serve``'s continuous
    scheduler, one scheduler a run: cache on greedy, cache off greedy,
    cache on at 0.6 with the majority vote, and cache on greedy under a
    KV budget that evicts and preempts.  Each run serves the workload
    twice from the same seeds: an untimed pass that captures the rows'
    graphs, then, with the cache cleared and the counters zeroed, the
    pass that is timed and checked.  Every run: #4's launches ==
    n_layers x the metered extends, #3's == n_layers x the decode steps,
    no dense or SSD launch.  Cache-on runs: hit tokens > 0, the base's
    lookups == requests + preemptions, the pools empty after
    ``clear_prefix_cache()``; #4's query tokens on <= off - the hit
    tokens, an engine at a time (all of them when the greedy tokens
    agree, else those of prompt prefills).  Then a hit's suffix prefill
    over adopted pages against a cold prefill of the same prompt: last
    logits within LOGIT_TOL.  Prints, on against off, the hit rate,
    prefill tokens saved, TTFT p50 and p95, tok/s and evictions, and as
    information whether the greedy tokens agree.  Returns the paged
    launches."""
    from repro_torch.data import tasks
    from repro_torch.serving.batch_engine import BatchEngine
    from repro_torch.serving.paged_kv import PagedSeq
    from repro_torch.serving.prefix_cache import CacheStats, RadixCache
    from repro_torch.serving.workload import (expand_best_of_n,
                                              majority_vote, run_workload,
                                              summarize,
                                              template_task_family)
    fam = template_task_family(random.Random(0), PREFIX_TASKS, shared_ops=4,
                               extra_min=4, extra_max=6)
    n_req = PREFIX_TASKS * PREFIX_N
    runs = (("on greedy", 0.0, True, DENSE_KV_MB),
            ("off greedy", 0.0, False, DENSE_KV_MB),
            ("on vote", 0.6, True, DENSE_KV_MB),
            ("on pressured", 0.0, True, PREFIX_PRESSURE_MB))
    launches = {"paged_decode_attention": 0, "paged_append_attention": 0}
    out = {}
    for label, temp, cache, mb in runs:
        args = serve.parse_args(
            ["--scheduler", "continuous", "-n", str(PREFIX_TASKS),
             "--num-samples", str(PREFIX_N), "--batch", "4", "--budget",
             str(ROWS_BUDGET), "--temperature", str(temp), "--threshold",
             str(THRESHOLD), "--kv-budget-mb", str(mb), "--device", "cuda"]
            + ([] if cache else ["--no-prefix-cache"])
            + (["--vote"] if temp else []))
        sched = serve.continuous_scheduler(args, base, small)
        engines = {"base": sched.base_be, "small": sched.small_be}

        def pairs():
            return expand_best_of_n(
                [(t, torch.Generator(device="cuda").manual_seed(i))
                 for i, t in enumerate(fam)], PREFIX_N)
        run_workload(sched, pairs(), [0.0] * n_req)
        sched.clear_prefix_cache()
        for be in engines.values():
            be.meter.reset()
        for c in (sched.caches or {}).values():
            c.stats = CacheStats()
        ticks, preempted = sched.ticks, sched.preemptions
        captures = {n: be.captures for n, be in engines.items()}
        q = {n: [0, 0] for n in engines}
        for n, be in engines.items():
            count_queries(be, q[n])
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = run_workload(sched, pairs(), [0.0] * n_req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ticks, preempted = sched.ticks - ticks, sched.preemptions - preempted
        captures = {n: be.captures - captures[n] for n, be in engines.items()}
        got = {n: k.launches for n, k in kernels.items()}
        want_decode = sum(be.model.cfg.n_layers * be.meter.decode_steps
                          for be in engines.values())
        want_append = sum(be.model.cfg.n_layers * be.meter.prefill_calls
                          for be in engines.values())
        if (got["paged_decode_attention"], got["paged_append_attention"]) \
                != (want_decode, want_append) or not want_decode \
                or got["decode_attention"] or got["flash_attention"] \
                or got["ssd_scan"]:
            raise AssertionError(
                f"prefix {label}: launches {got} != paged decode "
                f"{want_decode}, paged append {want_append}, dense and "
                "SSD 0")
        if any(h.status != "ok" for h in handles):
            raise AssertionError(f"prefix {label}: a request did not finish")
        st = summarize(handles, wall)
        stats = sched.cache_stats()
        if cache:
            if any(s["hit_tokens"] <= 0 for s in stats.values()):
                raise AssertionError(f"prefix {label}: no hit ({stats})")
            if stats["base"]["lookups"] != n_req + preempted:
                raise AssertionError(
                    f"prefix {label}: base lookups {stats['base']['lookups']}"
                    f" != {n_req} requests + {preempted} preemptions")
            freed = sched.clear_prefix_cache()
        else:
            freed = 0
        if any(sched.pool_utilization().values()):
            raise AssertionError(f"prefix {label}: pools not empty after "
                                 f"clearing: {sched.pool_utilization()}")
        evictions = sum(s["evicted_blocks"] for s in stats.values())
        out[label] = dict(
            tokens=[h.result.thinking_ids + h.result.answer_ids
                    for h in handles], st=st, stats=stats, q=q,
            preemptions=preempted, evictions=evictions,
            hits={n: s["hit_tokens"] for n, s in stats.items()})
        print(f"[main] prefix {label}: {n_req} requests ({PREFIX_TASKS} "
              f"tasks x {PREFIX_N}), {st['tok_s']} tok/s, wall "
              f"{wall:.4f} s, TTFT p50 {st.get('p50_ttft_s')} s p95 "
              f"{st.get('p95_ttft_s')} s, TPOT p50 {st.get('p50_tpot_s')} "
              f"s, ticks {ticks}, preemptions {preempted}, captures "
              f"{captures} (the untimed pass captured); "
              f"cache {stats.get('base', 'off')}, evictions {evictions}, "
              f"{freed} blocks freed by clearing, pools then empty; #4 "
              "query tokens (prompt prefill / all) "
              + ", ".join(f"{n} {a} / {b}" for n, (a, b) in q.items())
              + f"; launches paged decode {got['paged_decode_attention']}, "
              f"paged append {got['paged_append_attention']} == n_layers x "
              "metered steps/extends; dense 0, SSD 0", flush=True)
        if temp:
            for i, v in enumerate(majority_vote(handles, PREFIX_N)):
                print(f"[main] prefix {label} task{i}: agreement "
                      f"{v.agreement:.2f} over {v.survivors} answers, "
                      f"{len(v.counts)} distinct", flush=True)
        launches["paged_decode_attention"] += got["paged_decode_attention"]
        launches["paged_append_attention"] += got["paged_append_attention"]
        del sched, engines
        gc.collect()
        torch.cuda.empty_cache()

    on, off = out["on greedy"], out["off greedy"]
    same = on["tokens"] == off["tokens"]
    for n in on["q"]:
        part = 1 if same else 0
        if on["q"][n][part] > off["q"][n][part] - on["hits"][n]:
            raise AssertionError(
                f"prefix: {n} #4 query tokens cache on {on['q'][n]} > off "
                f"{off['q'][n]} - hits {on['hits'][n]}")
    press = out["on pressured"]
    if press["preemptions"] < 1 or press["evictions"] < 1:
        raise AssertionError(
            f"prefix: --kv-budget-mb {PREFIX_PRESSURE_MB} gave "
            f"{press['preemptions']} preemptions and {press['evictions']} "
            "evictions; both must be >= 1")
    for label in ("on greedy", "on vote", "on pressured"):
        r = out[label]
        print(f"[main] prefix {label} against off greedy: hit rate "
              f"{r['st']['cache_hit_rate']} (base "
              f"{r['stats']['base']['hit_rate']}), prefill tokens saved "
              + ", ".join(f"{n} {off['q'][n][0] - r['q'][n][0]}"
                          for n in r["q"])
              + f", TTFT p50 {r['st'].get('p50_ttft_s')} against "
              f"{off['st'].get('p50_ttft_s')} s, p95 "
              f"{r['st'].get('p95_ttft_s')} against "
              f"{off['st'].get('p95_ttft_s')} s, {r['st']['tok_s']} against "
              f"{off['st']['tok_s']} tok/s, evictions {r['evictions']} "
              f"against 0", flush=True)
    for label in ("on greedy", "on pressured"):
        diffs = [(i, first_difference(a, b)) for i, (a, b) in
                 enumerate(zip(out[label]["tokens"], off["tokens"]))
                 if a != b]
        print(f"[main] prefix (information): {label} tokens equal off "
              f"greedy's for {n_req - len(diffs)} of {n_req} requests"
              + "".join(f"; req{i} first differs at output token {k}"
                        for i, k in diffs), flush=True)

    # a hit's suffix prefill over adopted pages against a cold prefill.
    # The cold prompt is prefilled beside a sibling in one 2-row call, as
    # the scheduler batches admissions, and the hit's suffix as a 1-row
    # call: the cached K/V were projected at another row count than the
    # hit's own tokens
    be = BatchEngine(base.model, base.params, batch=3, capacity=256,
                     name="prefix-check")
    cache = RadixCache(be.pool, 8)
    prompt = tasks.question_tokens(fam[0])
    sibling = tasks.question_tokens(fam[1])
    cold, sib = PagedSeq(be.pool), PagedSeq(be.pool)
    r0, r2 = be.alloc_row(cold), be.alloc_row(sib)
    be.append_seq(cold, len(prompt))
    be.append_seq(sib, len(sibling))
    be.prefill_rows([r0, r2], [prompt, sibling], [0, 0])
    cache.insert(prompt, cold.blocks)
    blocks, hit = cache.match(prompt)
    seq = PagedSeq(be.pool)
    seq.adopt(blocks, hit)
    r1 = be.adopt_row(seq)
    be.append_seq(seq, len(prompt) - hit)
    be.prefill_rows([r1], [prompt[hit:]], [hit])
    a, b = be.last_logits[r1], be.last_logits[r0]
    err = (a - b).abs().max().item()
    if not hit or not torch.allclose(a, b, rtol=LOGIT_TOL, atol=LOGIT_TOL):
        raise AssertionError(f"prefix: hit logits ({hit} cached tokens) "
                             f"differ from cold by {err:.3g}")
    print(f"[main] prefix: a {len(prompt)}-token prompt's last logits after"
          f" a hit ({hit} tokens on adopted pages, a {len(prompt) - hit}-"
          f"token 1-row suffix prefill) against a cold prefill (2 rows, "
          f"beside a {len(sibling)}-token sibling): max |diff| "
          f"{err:.3g} (tolerance {LOGIT_TOL}, |logit| max "
          f"{b.abs().max().item():.3g}); the hit's table holds the cold "
          f"row's pages {seq.blocks[:len(blocks)] == cold.blocks[:len(blocks)]}",
          flush=True)
    del be
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def parse_prometheus(text):
    """{sample name with labels: value} of a Prometheus text exposition;
    raises on a line that is neither a comment nor ``name value``."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        out[name] = float(value)
    return out


def trace_tracks(doc):
    """The track names of a Chrome trace (its thread_name metadata)."""
    return {e["args"]["name"] for e in doc["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "thread_name"}


def overload_phase(torch, tasks, kernels, base, small):
    """[main] overload: the overload and fault plane on the continuous
    path at minitron-4b's widths (the pair ``fused_dense_phase``
    loaded): OVERLOAD_TASKS tasks, greedy, budget ROWS_BUDGET, 4 rows,
    spec decode at gamma 4, the prefix cache on, one fresh scheduler a
    run.  (a) unloaded: all arrivals at 0, no resilience, no tracer; its
    tokens and its req/s R.  (b) overloaded: Poisson arrivals at 2R from
    OVERLOAD_SEED, shifted so that the first comes at 0 (tick 1 then
    has work, as (a)'s has), deadlines of OVERLOAD_DEADLINE_X x (a)'s
    median latency, an unmeetable TPOT SLO (the ladder must step down),
    priority shedding (priorities from the seed) over a queue of
    OVERLOAD_MAX_QUEUE, the ladder, ``FaultPlan.random(seed=
    OVERLOAD_SEED)`` over ticks 1 to min((a)'s ticks, FAULT_MAX_TICK)
    with stalls of OVERLOAD_STALL_S, plus a NaN written into request
    0's base row at tick 1 (whether the seeded row faults find their
    targets in flight depends on the wall clock; this one always does),
    the audit, an annotating tracer and the metrics.  It must hold:
    every request terminal, each non-ok one with an error code of
    ERROR_CODES; no audit violation; a NaN or raise fault injected, a
    quarantine and a retry, the stall fired, and a retried request ok;
    each ok request's tokens (a)'s; the ladder left L0;
    the captures on keys (a)'s engines did not capture (the captures
    past the warm-up that (a) is) at most the rungs visited; #3 and #4
    launches == n_layers x the metered decode steps and extends; the
    Chrome trace loads as JSON with the ``scheduler`` track, each
    engine's and each request's; the metrics text parses and its TTFT
    count is the ok requests'.  (c) traced: (a) with the tracer and
    metrics on; tokens, Meter counts and captures (a)'s; its wall
    against (a)'s for information.  The phase's lap must stay within
    OVERLOAD_LAP_S.  Returns the paged launches of the three runs."""
    from repro_torch.core.controller import SpecReason, SpecReasonConfig
    from repro_torch.core.policies import StaticThreshold
    from repro_torch.launch.serve import FAULT_MAX_TICK
    from repro_torch.serving.faults import Fault, FaultInjector, FaultPlan
    from repro_torch.serving.kv_manager import KVBudget, KVManager
    from repro_torch.serving.resilience import (TERMINAL_STATUSES,
                                                ResilienceConfig)
    from repro_torch.sampling.sample import SamplingParams
    from repro_torch.serving.scheduler import ContinuousScheduler
    from repro_torch.serving.telemetry import ServingMetrics, Tracer
    from repro_torch.serving.workload import (percentile, poisson_arrivals,
                                              run_workload, summarize)
    t_phase = time.perf_counter()
    rng = random.Random(OVERLOAD_SEED)
    reqs = [tasks.sample_task(rng) for _ in range(OVERLOAD_TASKS)]
    n_req = len(reqs)

    def make(**plane):
        cfg = SpecReasonConfig(policy=StaticThreshold(THRESHOLD),
                               token_budget=ROWS_BUDGET,
                               sampling=SamplingParams(0.0),
                               use_spec_decode=True, spec_gamma=4,
                               fused_decode=True)
        kv = KVManager(base.model.cfg, small.model.cfg,
                       KVBudget(total_bytes=DENSE_KV_MB << 20))
        return ContinuousScheduler(
            SpecReason(base, small, cfg), kv, max_batch=4,
            context_capacity=min(base.max_len, ROWS_BUDGET + 64), **plane)

    def gens():
        return [torch.Generator(device="cuda").manual_seed(i)
                for i in range(n_req)]

    def run(label, sched, arrivals, opts=None):
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = run_workload(sched, list(zip(reqs, gens())), arrivals,
                               opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {n: k.launches for n, k in kernels.items()}
        engines = (sched.base_be, sched.small_be)
        want_decode = sum(be.model.cfg.n_layers * be.meter.decode_steps
                          for be in engines)
        want_append = sum(be.model.cfg.n_layers * be.meter.prefill_calls
                          for be in engines)
        if (got["paged_decode_attention"], got["paged_append_attention"]) \
                != (want_decode, want_append) or not want_decode \
                or got["decode_attention"] or got["flash_attention"] \
                or got["ssd_scan"]:
            raise AssertionError(
                f"overload {label}: launches {got} != paged decode "
                f"{want_decode}, paged append {want_append}, dense and "
                "SSD 0")
        return handles, wall, got

    def tokens(h):
        return h.result.thinking_ids + h.result.answer_ids

    def meters(sched):
        keep = ("prefill_tokens", "prefill_calls", "decode_tokens",
                "decode_calls", "decode_steps", "spec_rounds",
                "spec_proposed", "spec_accepted")
        return [{k: be.meter.as_dict()[k] for k in keep}
                for be in (sched.base_be, sched.small_be)]

    def keys(sched):
        return [set(be._loops) for be in (sched.base_be, sched.small_be)]

    launches = {"paged_decode_attention": 0, "paged_append_attention": 0}

    def count(got):
        for name in launches:
            launches[name] += got[name]

    # (a) unloaded
    sa = make()
    ha, wall_a, got = run("unloaded", sa, [0.0] * n_req)
    count(got)
    if any(h.status != "ok" for h in ha):
        raise AssertionError("overload unloaded: a request did not finish")
    st_a = summarize(ha, wall_a)
    rate = n_req / wall_a
    median = percentile(sorted(h.e2e_latency for h in ha), 0.5)
    print(f"[main] overload (a) unloaded: {n_req} requests, wall "
          f"{wall_a:.4f} s, {rate:.3f} req/s, {st_a['tok_s']} tok/s, "
          f"latency p50 {median:.4f} s p95 {st_a['p95_latency_s']} s, "
          f"ticks {sa.ticks}, captures "
          f"{[be.captures for be in (sa.base_be, sa.small_be)]}; launches "
          f"paged decode {got['paged_decode_attention']}, paged append "
          f"{got['paged_append_attention']} == n_layers x metered "
          "steps/extends", flush=True)

    # (b) overloaded
    prng = random.Random(OVERLOAD_SEED)
    arrivals = poisson_arrivals(n_req, 2 * rate, prng)
    arrivals = [t - arrivals[0] for t in arrivals]
    deadline = OVERLOAD_DEADLINE_X * median
    opts = [{"deadline_s": deadline, "priority": prng.randrange(3)}
            for _ in range(n_req)]
    plan = FaultPlan.random(seed=OVERLOAD_SEED, n_faults=OVERLOAD_FAULTS,
                            n_requests=n_req,
                            max_tick=min(sa.ticks, FAULT_MAX_TICK))
    plan = FaultPlan([Fault(tick=1, kind="nan_logits", target=0,
                            which="base")]
                     + [dataclasses.replace(f, stall_s=OVERLOAD_STALL_S)
                        if f.kind == "stall" else f for f in plan.faults])
    injector = FaultInjector(plan)
    tracer, metrics = Tracer(annotate=True), ServingMetrics()
    # two retries: the seeded plan may hit request 0 again after tick 1
    sb = make(resilience=ResilienceConfig(
        slo_tpot_s=OVERLOAD_SLO_TPOT_S, shed_policy="priority",
        max_queue=OVERLOAD_MAX_QUEUE, degrade=True, max_retries=2),
        faults=injector, audit=True, tracer=tracer, metrics=metrics)
    hb, wall_b, got = run("overloaded", sb, arrivals, opts)
    count(got)
    kinds = collections.Counter(h.status for h in hb)
    bad = [(i, h.status, h.error) for i, h in enumerate(hb)
           if h.status not in TERMINAL_STATUSES
           or (h.status != "ok" and (h.error is None
                                     or h.error.code not in ERROR_CODES))]
    if bad:
        raise AssertionError(f"overload (b): requests not terminal or "
                             f"without a known error code: {bad}")
    rs = sb.resilience_stats()
    if rs["audit_violations"]:
        raise AssertionError(f"overload (b): audit violations {rs}")
    fired = rs["faults"]["injected"]
    retried_ok = [i for i, h in enumerate(hb)
                  if h.retries and h.status == "ok"]
    if fired["nan_logits"] + fired["raise"] < 1 or not fired["stall"] \
            or rs["stalled_ticks"] < 1 or rs["quarantines"] < 1 \
            or rs["retries"] < 1 or not retried_ok:
        raise AssertionError(
            f"overload (b): want a NaN or raise fault injected, a "
            f"quarantine, a retry, the stall and a retried request ok; "
            f"faults {rs['faults']}, quarantines {rs['quarantines']}, "
            f"retries {rs['retries']}, stalled ticks "
            f"{rs['stalled_ticks']}, retried and ok {retried_ok}")
    wrong = [i for i, (x, y) in enumerate(zip(hb, ha))
             if x.status == "ok" and tokens(x) != tokens(y)]
    if wrong:
        raise AssertionError(f"overload (b): ok requests {wrong} differ "
                             "from the unloaded run's tokens")
    trans = sb.res.transitions
    if not trans:
        raise AssertionError("overload (b): the ladder never left L0")
    doc = json.loads(json.dumps(tracer.chrome_trace()))
    tracks = trace_tracks(doc)
    want_tracks = {"scheduler"} | {f"engine:{be.name}" for be in
                                   (sb.base_be, sb.small_be)} \
        | {f"req:{h.request_id}" for h in hb}
    if not want_tracks <= tracks:
        raise AssertionError(f"overload (b): trace lacks tracks "
                             f"{sorted(want_tracks - tracks)}")
    rungs = collections.Counter(
        e["args"]["level"] for e in doc["traceEvents"]
        if e.get("ph") == "X" and e["name"] == "tick"
        and e.get("args", {}).get("tick") is not None)
    new_keys = sum(len(kb - ka) for kb, ka in zip(keys(sb), keys(sa)))
    caps_b = [be.captures for be in (sb.base_be, sb.small_be)]
    if new_keys > len(rungs):
        raise AssertionError(
            f"overload (b): {new_keys} captures on keys the unloaded run "
            f"did not capture, more than the {len(rungs)} rungs visited")
    samples = parse_prometheus(metrics.render())
    n_ok = kinds.get("ok", 0)
    if samples["specreason_ttft_seconds_count"] != n_ok:
        raise AssertionError(
            f"overload (b): TTFT count "
            f"{samples['specreason_ttft_seconds_count']} != {n_ok} ok")
    st_b = summarize(hb, wall_b, slo_tpot_s=OVERLOAD_SLO_TPOT_S)
    st_dl = summarize(hb, wall_b)
    print(f"[main] overload (b) overloaded: {n_req} Poisson arrivals at "
          f"{2 * rate:.3f} req/s (seed {OVERLOAD_SEED}), deadline "
          f"{deadline:.4f} s, TPOT SLO {OVERLOAD_SLO_TPOT_S:g} s, "
          f"priorities {[o['priority'] for o in opts]}, max_queue "
          f"{OVERLOAD_MAX_QUEUE}; plan "
          + ", ".join(f"{f.kind}@{f.tick}"
                      + (f"->req{f.target}" if f.target is not None
                         else f"x{f.duration}")
                      for f in plan.faults)
          + f"; statuses {dict(kinds)}, codes "
          f"{dict(collections.Counter(h.error.code for h in hb if h.error))}"
          f"; goodput {st_b['goodput_req_s']} req/s against the SLO "
          f"(slo_met {st_b['slo_met']}), {st_dl['goodput_req_s']} req/s "
          f"against the deadlines alone; retries {rs['retries']}, "
          f"quarantines {rs['quarantines']}, retried and ok "
          f"{['req%d' % i for i in retried_ok]}, stalled ticks "
          f"{rs['stalled_ticks']}, preemptions {rs['preemptions']}, "
          f"audit violations {rs['audit_violations']}; faults "
          f"{rs['faults']['injected']} ({rs['faults']['skipped']} "
          f"skipped); wall {wall_b:.4f} s, ticks {sb.ticks}", flush=True)
    print(f"[main] overload (b) ladder: rungs visited (level: ticks) "
          f"{dict(sorted(rungs.items()))}; " + "; ".join(trans)
          + f"; captures {caps_b}, {new_keys} on keys the unloaded run "
          f"did not capture (<= {len(rungs)} rungs); ok tokens equal the "
          f"unloaded run's ({n_ok} requests); trace {len(doc['traceEvents'])}"
          f" events over {len(tracks)} tracks ({tracer.dropped} dropped), "
          f"metrics {len(samples)} samples, TTFT count {n_ok}; launches "
          f"paged decode {got['paged_decode_attention']}, paged append "
          f"{got['paged_append_attention']} == n_layers x metered "
          "steps/extends", flush=True)

    # (c) traced
    sc = make(tracer=Tracer(), metrics=ServingMetrics())
    hc, wall_c, got = run("traced", sc, [0.0] * n_req)
    count(got)
    if [tokens(h) for h in hc] != [tokens(h) for h in ha] \
            or meters(sc) != meters(sa) or keys(sc) != keys(sa) \
            or [be.captures for be in (sc.base_be, sc.small_be)] != \
            [be.captures for be in (sa.base_be, sa.small_be)]:
        raise AssertionError("overload (c): the traced run's tokens, Meter "
                             "counts or captures differ from the "
                             "unloaded run's")
    lap_s = time.perf_counter() - t_phase
    print(f"[main] overload (c) traced: tokens, Meter counts and captures "
          f"equal (a)'s; wall {wall_c:.4f} s against (a)'s {wall_a:.4f} s "
          f"(information; {nvidia_smi()}); trace "
          f"{len(sc.tracer.entries())} entries; lap {lap_s:.1f} s "
          f"(budget {OVERLOAD_LAP_S:g} s)", flush=True)
    if lap_s > OVERLOAD_LAP_S:
        raise AssertionError(f"overload: lap {lap_s:.1f} s over its budget "
                             f"of {OVERLOAD_LAP_S:g} s")
    del sa, sb, sc
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def decode_rows_phase(torch, BatchEngine, SamplingParams, paged_kernel,
                      model, params, tag):
    """A decode-only call of the batched engine at ``model``'s vocabulary:
    4 rows at the ragged lengths DECODE_ROWS decode DECODE_TOKENS tokens
    each, greedy and at 0.6 with probabilities collected, in turns fused,
    eager, fused from the same committed context (each turn
    restores the rows and truncates their tables): identical tokens,
    probabilities within 2e-5, launches == n_layers x decode steps, no
    capture in the second fused turn; then one greedy call profiled each
    way (the profiler's count of #3's kernel against the wrapper's)."""
    cfg = model.cfg
    be = BatchEngine(model, params, batch=len(DECODE_ROWS),
                     capacity=max(DECODE_ROWS) + DECODE_TOKENS)
    gen = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in DECODE_ROWS]
    rows = [be.alloc_row() for _ in prompts]
    t0 = time.perf_counter()
    for s0 in range(0, max(DECODE_ROWS), 256):
        live = [i for i, n in enumerate(DECODE_ROWS) if s0 < n]
        be.extend_rows([rows[i] for i in live],
                       [prompts[i][s0:s0 + 256] for i in live])
    snaps = [be.snapshot_row(r) for r in rows]
    print(f"[fused rows] {tag} vocab {cfg.vocab_size} decode-only: rows at "
          f"{list(DECODE_ROWS)} tokens committed in "
          f"{time.perf_counter() - t0:.1f} s, {DECODE_TOKENS} tokens a row "
          f"a call", flush=True)
    calls = []
    record_rows_calls({"base": be}, calls)

    def call(loop, temp, probs):
        for r, snap in zip(rows, snaps):
            be.restore_row(r, snap)
            be.truncate_seq(be.seqs[r], snap.pos)
        gens = [torch.Generator(device="cuda").manual_seed(5 + i)
                for i in range(len(rows))]
        generate = be.generate_rows_fused if loop == "fused" \
            else be.generate_rows_eager
        out = generate(rows, DECODE_TOKENS, [],
                       SamplingParams(temperature=temp), gens,
                       collect_probs=probs)
        return out if probs else (out, None)

    mark = memory_mark(torch)
    last = {}
    for label, temp, probs in (("greedy", 0.0, False),
                               ("sampled", 0.6, True)):
        first = None
        for turn, loop in enumerate(TURNS):
            launches, steps = paged_kernel.launches, be.meter.decode_steps
            caps, syncs = be.captures, be.meter.decode_syncs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, ps = call(loop, temp, probs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            last[label, loop] = wall
            want = cfg.n_layers * (be.meter.decode_steps - steps)
            if paged_kernel.launches - launches != want or \
                    [len(i) for i in ids] != [DECODE_TOKENS] * len(rows):
                raise AssertionError(
                    f"[fused rows] {tag} decode-only {label} {loop}: "
                    f"{[len(i) for i in ids]} tokens, paged decode launches "
                    f"{paged_kernel.launches - launches} != {want}")
            if turn == len(TURNS) - 1 and be.captures != caps:
                raise AssertionError(f"[fused rows] {tag} decode-only "
                                     f"{label}: the second fused turn "
                                     "captured again")
            if first is None:
                first = (ids, ps)
            else:
                err = max((float((a - b).abs().max()) for a, b in
                           zip(ps, first[1])), default=0.0) if probs else 0.0
                if ids != first[0] or err > 2e-5:
                    raise AssertionError(
                        f"[fused rows] {tag} decode-only {label}: turn "
                        f"{turn} ({loop}) tokens or probabilities differ "
                        f"from the first turn's (probs max |diff| {err})")
            n = len(rows) * DECODE_TOKENS
            print(f"[fused rows] {tag} vocab {cfg.vocab_size} decode-only "
                  f"{label} turn {turn} ({loop}): {n} tokens over "
                  f"{len(rows)} rows in {wall:.4f} s, {n / wall:.1f} tok/s, "
                  f"TPOT {wall / DECODE_TOKENS * 1e3:.3f} ms"
                  + (", probabilities collected" if probs else "")
                  + f"; captures {be.captures - caps}, waits "
                  f"{be.meter.decode_syncs - syncs}, paged decode launches "
                  f"{want} == n_layers x decode steps", flush=True)
        print(f"[fused rows] {tag} vocab {cfg.vocab_size} decode-only "
              f"{label}: tokens identical in all {len(TURNS)} turns",
              flush=True)
    print(f"[fused rows] {tag} vocab {cfg.vocab_size} decode-only: "
          f"{check_rows_calls(tag, calls)}; memory: "
          f"{memory_line(torch, {'base': be}, mark)}", flush=True)
    for loop in ("fused", "eager"):
        plain = last["greedy", loop]
        p = profile_request(torch, lambda: call(loop, 0.0, False),
                            paged_kernel, plain)
        seen, dev_ms = traced(p["rows"], "paged_decode_kernel")
        gate(p, seen, f"{tag} decode-only {loop}", "paged_decode_kernel")
        n = len(rows) * DECODE_TOKENS
        print(f"[profile] {tag} vocab {cfg.vocab_size} decode-only greedy, "
              f"{len(rows)} rows x {DECODE_TOKENS} tokens ({loop}, "
              f"{n / plain:.1f} tok/s unprofiled): {p['window']}; "
              f"paged_decode_kernel {seen} launches traced == "
              f"{p['counted']} counted, {dev_ms:.1f} ms; {p['top']}",
              flush=True)


def fused_phase(torch, serve, tasks, decode_kernel, base, small, tag,
                threshold):
    """The dense pair's fused decode loop against its per-token loop on
    the card, on one pair of engines: the main path's 3 specreason
    requests, greedy and at temperature 0.6, in turns fused, eager,
    fused.  Tokens must be identical in every turn; decode launches
    must equal n_layers x the metered decode steps (masked and warm-up
    steps included); each engine's graphs must all run over one KV pair
    (one capture per key, none in the second fused turn); every fused
    call must wait on the card at most ceil(budget / k) + 1 times and
    waste at most 2k steps.  Prints tok/s a request and wall each turn,
    captures and capture time, syncs and wasted steps a call, the memory
    the loops hold, and one greedy request profiled each way (idle share,
    device time by kernel), where the profiler's count of flash-decode
    launches must equal the wrapper's."""
    from repro_torch.serving import graph_loop
    engines = {"base": base, "small": small}
    layers = {n: e.model.cfg.n_layers for n, e in engines.items()}
    rng = random.Random(0)
    reqs = [tasks.sample_task(rng) for _ in range(3)]
    calls = []      # per fused call: engine, budget, k, tokens, steps, syncs

    def recorded(name, eng):
        inner = eng.generate_fused

        def generate_fused(session, max_tokens, *args, **kw):
            m, caps = eng.meter, eng.captures
            before = (m.decode_tokens, m.decode_steps, m.decode_syncs)
            budget = min(max_tokens, session.state.capacity - session.pos)
            out = inner(session, max_tokens, *args, **kw)
            if budget > 0:
                k = graph_loop.chunk_steps(budget)
                n = m.decode_tokens - before[0]
                wasted = m.decode_steps - before[1] - n \
                    - (eng.captures - caps)     # a capture's warm-up step
                calls.append((name, budget, k, n, wasted,
                              m.decode_syncs - before[2]))
            return out
        eng.generate_fused = generate_fused
    for name, eng in engines.items():
        recorded(name, eng)

    def run(temp, loop, i):
        gen = torch.Generator(device="cuda").manual_seed(i)
        return serve.run_scheme("specreason", base, small, reqs[i], gen, 128,
                                threshold, temp, fused=loop == "fused")

    mark = memory_mark(torch)
    last = {}           # greedy req2's wall in its loop's last turn
    for label, temp in (("greedy", 0.0), ("sampled", 0.6)):
        first = None
        for turn, loop in enumerate(TURNS):
            decode_kernel.launches = 0
            caps = {n: e.captures for n, e in engines.items()}
            want, toks, rates, wall = 0, [], [], 0.0
            walls = []
            meter = {n: dict.fromkeys(("decode_tokens", "decode_time",
                                       "prefill_time"), 0)
                     for n in engines}
            for i in range(len(reqs)):
                res = run(temp, loop, i)
                out = res.thinking_ids + res.answer_ids
                toks.append(out)
                rates.append(len(out) / res.wall_time)
                walls.append(res.wall_time)
                wall += res.wall_time
                want += sum(layers[n] * m["decode_steps"]
                            for n, m in res.meters.items())
                for n, m in res.meters.items():
                    for key in meter[n]:
                        meter[n][key] += m[key]
            torch.cuda.synchronize()
            if decode_kernel.launches != want or not want:
                raise AssertionError(f"[fused] {tag} {label} {loop}: decode "
                                     f"launches {decode_kernel.launches} != "
                                     f"n_layers x decode steps {want}")
            if label == "greedy":
                last[loop] = walls[2]
            if first is None:
                first = toks
            elif toks != first:
                raise AssertionError(f"[fused] {tag} {label}: {loop} turn "
                                     f"{turn} tokens differ from the first "
                                     "turn's")
            new = {n: e.captures - caps[n] for n, e in engines.items()}
            if turn == len(TURNS) - 1 and any(new.values()):
                raise AssertionError(f"[fused] {tag} {label}: the second "
                                     f"fused turn captured again: {new}")
            print(f"[fused] {tag} {label} turn {turn} ({loop}): "
                  f"{', '.join(f'{r:.1f}' for r in rates)} tok/s a request, "
                  f"wall {wall:.4f} s, {sum(map(len, toks))} tokens; "
                  + "; ".join(
                      f"{n} decode {m['decode_tokens'] / m['decode_time']:.1f}"
                      f" tok/s ({m['decode_tokens']} tokens in "
                      f"{m['decode_time']:.4f} s), prefill "
                      f"{m['prefill_time']:.4f} s" for n, m in meter.items())
                  + f"; decode launches {want} == n_layers x decode steps; "
                  f"captures {new}", flush=True)
        print(f"[fused] {tag} {label}: tokens identical in all "
              f"{len(TURNS)} turns ({len(first)} requests)", flush=True)
    for name, eng in engines.items():
        pairs = {key[:2] for key in eng._loops}
        if eng.captures != len(eng._loops) or len(pairs) != 1:
            raise AssertionError(f"[fused] {tag} {name}: {eng.captures} "
                                 f"captures, {len(eng._loops)} keys over "
                                 f"{len(pairs)} KV pairs")
        mine = [c for c in calls if c[0] == name]
        bad = [c for c in mine if c[5] > -(-c[1] // c[2]) + 1
               or c[4] > 2 * c[2]]
        if bad:
            raise AssertionError(f"[fused] {tag} {name}: calls beyond "
                                 "ceil(budget/k) + 1 syncs or 2k wasted "
                                 f"steps: {bad}")
        print(f"[fused] {tag} {name}: {eng.captures} captures in "
              f"{eng.capture_time:.3f} s, one per key (keys "
              f"{sorted((k[3].temperature, k[4], k[5], k[7]) for k in eng._loops)}"
              f" as (temperature, probs, buffer, k)), all over one KV pair; "
              f"{len(mine)} fused calls: syncs a call mean "
              f"{sum(c[5] for c in mine) / len(mine):.3f} max "
              f"{max(c[5] for c in mine)}, wasted steps a call mean "
              f"{sum(c[4] for c in mine) / len(mine):.3f} max "
              f"{max(c[4] for c in mine)}, tokens a call mean "
              f"{sum(c[3] for c in mine) / len(mine):.2f}, budgets "
              f"{sorted(set(c[1] for c in mine))}, k "
              f"{sorted(set(c[2] for c in mine))}; syncs <= ceil(budget / k)"
              " + 1 and wasted <= 2k in every call", flush=True)
    print(f"[fused] {tag} memory: {memory_line(torch, engines, mark)}",
          flush=True)
    for loop in ("fused", "eager"):
        p = profile_request(torch, lambda: run(0.0, loop, 2), decode_kernel,
                            last[loop])
        n_out = len(p["res"].thinking_ids + p["res"].answer_ids)
        seen, dev_ms = traced(p["rows"], "decode_kernel")
        gate(p, seen, f"{tag} {loop}", "decode_kernel")
        print(f"[profile] {tag} dense greedy req2 ({loop}, {n_out} tokens, "
              f"{n_out / last[loop]:.1f} tok/s unprofiled): {p['window']}; "
              f"decode_kernel {seen} launches traced == {p['counted']} "
              f"counted, {dev_ms:.1f} ms; {p['top']}", flush=True)


def published_vocab(torch, Model, registry, arch, layers_of):
    """(model, params) of ``arch`` at its published vocabulary: the
    layers and norms of the params ``layers_of`` (cut to the toy
    vocabulary), the embeddings drawn on the card from seed 3, scaled as
    the port's init draws them."""
    full = Model(registry.get(arch))
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = dict(layers_of)
    for key, spec in full.spec().items():
        if key in ("tok_embed", "unembed"):
            std = spec.scale / (spec.shape[spec.fan_in_axis] ** 0.5
                                if spec.init == "scaled" else 1.0)
            params[key] = torch.randn(spec.shape, generator=gen,
                                      device="cuda") * std
        elif "/" not in key and params[key].shape != spec.shape:
            raise AssertionError(f"{key}: {params[key].shape} does not "
                                 f"match the spec's {spec.shape}")
    return full, params


def fused_dense_phase(torch, serve, tasks, loader, registry,
                      Model, Engine, BatchEngine, SamplingParams,
                      kernels, lap):
    """The fused loop at a published dense width: minitron-4b (all 32
    layers, random init from a seed, vocabulary cut to the toy
    tokenizer's 64 as the ssm phase's base) with the testbed SMALL
    drafter through ``fused_phase``; then the base alone at its published
    vocabulary (256000; the same layers, embeddings drawn on the card
    from a seed): from a 64-token prompt, ``decode_turns`` in turns
    TURNS, with flash-decode launches == n_layers x decode steps and one
    greedy call profiled each way (the profiler's flash-decode launches
    against the wrapper's).  ``prefix_phase`` and then
    ``overload_phase`` run on the same pair after the ``[fused rows]``
    turns; returns their paged launches."""
    decode_kernel = kernels["decode_attention"]
    paged_kernel = kernels["paged_decode_attention"]
    t0 = time.perf_counter()
    base = loader.random_engine(DENSE_ARCH, "cuda", seed=0)
    small = loader.random_engine("testbed-small", "cuda", seed=1)
    torch.cuda.synchronize()
    cfg = base.model.cfg
    n_params = sum(t.numel() for t in leaves(base.params))
    print(f"[fused] {DENSE_ARCH}: base {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} kv "
          f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} (cut from 256000), {n_params} parameters "
          f"(fp32), random init in {time.perf_counter() - t0:.1f} s; testbed "
          f"SMALL drafter; threshold {THRESHOLD}; loops {loader.decode_loops(base, small)}",
          flush=True)
    fused_phase(torch, serve, tasks, decode_kernel, base, small,
                DENSE_ARCH, THRESHOLD)
    lap(f"fused, {DENSE_ARCH}")
    rows_phase(torch, serve, tasks, paged_kernel, base, small, DENSE_ARCH,
               (("greedy", 0.0, False), ("sampled", 0.6, False)),
               DENSE_KV_MB, profile=True)
    lap(f"fused rows, {DENSE_ARCH}")
    prefix_launches = prefix_phase(torch, serve, kernels, base, small)
    lap(f"prefix, {DENSE_ARCH}")
    for name, n in overload_phase(torch, tasks, kernels, base,
                                  small).items():
        prefix_launches[name] += n
    lap(f"overload, {DENSE_ARCH}")

    full, params = published_vocab(torch, Model, registry, DENSE_ARCH,
                                   base.params)
    eng = Engine(full, params, name=DENSE_ARCH)
    decode_rows_phase(torch, BatchEngine, SamplingParams, paged_kernel, full,
                      params, DENSE_ARCH)
    lap(f"fused rows, {DENSE_ARCH} decode-only")
    prompt = torch.randint(0, full.cfg.vocab_size, (64,),
                           generator=torch.Generator().manual_seed(4)).tolist()
    decode_turns(torch, eng, SamplingParams, "[fused]",
                 f"{DENSE_ARCH} vocab {full.cfg.vocab_size}",
                 lambda: eng.extend(eng.new_session(), prompt), TURNS,
                 profile=True, counter=decode_kernel, kernel="decode_kernel")
    lap(f"fused, {DENSE_ARCH} decode-only")
    return prefix_launches


def decode_turns(torch, eng, SamplingParams, phase, name, start, turns,
                 profile=False, counter=None, kernel=""):
    """One engine's fused decode loop against its per-token loop on the
    card, decode-only: each call decodes from ``start()`` (made before
    the clock starts) DECODE_TOKENS tokens, greedy and at 0.6 with
    probabilities collected, in ``turns``.  Tokens identical,
    probabilities within 2e-5, DECODE_TOKENS tokens a call, no capture
    in the last (fused) turn, at most ceil(DECODE_TOKENS / k) + 1 waits
    and 2k - 1 wasted steps a fused call; with a kernel wrapper
    ``counter``, its launches == the attention layers (self and cross)
    x decode steps.  Prints decode
    tok/s, TPOT, waits, wasted steps, captures and capture s each turn,
    then the loop's memory; with ``profile``, one greedy call profiled
    each way (``profile_request``: idle share, device time by kernel,
    the profiler's count of ``kernel`` against ``counter``'s)."""
    from repro_torch.serving.graph_loop import chunk_steps
    k = chunk_steps(DECODE_TOKENS)
    # the layers that launch flash-decode a step: every attention layer
    # (an encdec layer twice: its self- and its cross-attention)
    layers = eng.model.cfg.n_self_layers + eng.model.cfg.n_cross_layers
    tag = f"{phase} {name}"

    def call(session, loop, temp, probs):
        gen = torch.Generator(device="cuda").manual_seed(5)
        ids, _, ps = eng.generate(
            session, DECODE_TOKENS, [], SamplingParams(temperature=temp),
            gen, collect_probs=probs, fused=loop == "fused")
        return ids, ps
    mark = memory_mark(torch)
    last = {}
    for label, temp, probs in (("greedy", 0.0, False),
                               ("sampled", 0.6, True)):
        first = None
        for turn, loop in enumerate(turns):
            session = start()
            m = eng.meter
            caps, cap_s = eng.captures, eng.capture_time
            syncs, steps = m.decode_syncs, m.decode_steps
            launches = counter.launches if counter is not None else 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, ps = call(session, loop, temp, probs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            del session         # a dense session's KV pair goes back
            last[label, loop] = wall
            new = eng.captures - caps
            waits = m.decode_syncs - syncs
            wasted = m.decode_steps - steps - len(ids) - new
            want = layers * (m.decode_steps - steps)
            if len(ids) != DECODE_TOKENS:
                raise AssertionError(f"{tag} {label} {loop}: {len(ids)} "
                                     f"tokens, not {DECODE_TOKENS}")
            if counter is not None and counter.launches - launches != want:
                raise AssertionError(f"{tag} {label} {loop}: {kernel} "
                                     f"launches {counter.launches - launches}"
                                     f" != {layers} attention layers x "
                                     f"decode steps {want}")
            if turn == len(turns) - 1 and new:
                raise AssertionError(f"{tag} {label}: the second fused "
                                     "turn captured again")
            if loop == "fused" and (waits > -(-DECODE_TOKENS // k) + 1
                                    or wasted > 2 * k - 1):
                raise AssertionError(f"{tag} {label}: {waits} waits, "
                                     f"{wasted} wasted steps (k {k})")
            if first is None:
                first = (ids, ps)
            else:
                err = max((abs(a - b).max() for a, b in zip(ps, first[1])),
                          default=0.0)
                if ids != first[0] or len(ps) != len(first[1]) or \
                        err > 2e-5:
                    raise AssertionError(
                        f"{tag} {label}: turn {turn} ({loop}) tokens or "
                        "probabilities differ from the first turn's "
                        f"(probs max |diff| {err})")
            note = (f"waits {waits}, wasted steps {wasted}"
                    if loop == "fused" else "per-token loop")
            print(f"{tag} {label} turn {turn} ({loop}): {len(ids)} tokens "
                  f"in {wall:.4f} s, {len(ids) / wall:.1f} tok/s, TPOT "
                  f"{wall / len(ids) * 1e3:.3f} ms"
                  + (", probabilities collected" if probs else "")
                  + f"; {note}; captures {new} in "
                  f"{eng.capture_time - cap_s:.3f} s"
                  + (f"; {kernel} launches {want} == {layers} attention "
                     "layers x decode steps" if counter is not None else ""),
                  flush=True)
        print(f"{tag} {label}: tokens identical in all {len(turns)} turns"
              + (" (probabilities within 2e-5)" if probs else ""),
              flush=True)
    print(f"{tag}: {eng.captures} captures in {eng.capture_time:.3f} s "
          f"over {len(eng._loops)} keys; memory: "
          f"{memory_line(torch, {'base': eng}, mark)}", flush=True)
    if not profile:
        return
    for loop in ("fused", "eager"):
        plain, box = last["greedy", loop], [start()]

        def fresh():
            box.clear()         # the spent session's KV pair goes back
            box.append(start())

        p = profile_request(torch, lambda: call(box[0], loop, 0.0, False),
                            counter, plain, fresh)
        del box
        gated = ""
        if counter is not None:
            seen, dev_ms = traced(p["rows"], kernel)
            gate(p, seen, f"{name} {loop}", kernel)
            gated = (f"; {kernel} {seen} launches traced == "
                     f"{p['counted']} counted, {dev_ms:.1f} ms")
        print(f"[profile] {name} decode-only greedy, {DECODE_TOKENS} tokens "
              f"({loop}, {DECODE_TOKENS / plain:.1f} tok/s unprofiled): "
              f"{p['window']}{gated}; {p['top']}", flush=True)


def fused_ssm_phase(torch, Model, registry, Engine, SamplingParams, base,
                    lap):
    """The ssm base's fused decode loop (CUDA graphs over the engine's
    static conv/ssm pair) against its per-token loop on the card
    (``decode_turns``, turns TURNS): the mamba2-1.3b base alone, 48
    layers at published widths (the main phase's engine), first at the
    toy vocabulary of 64 and then at its published vocabulary of 50280
    (the same layers, the embedding drawn on the card), decode-only from
    one committed 64-token prompt; at 50280 one greedy call profiled
    each way."""
    full, params = published_vocab(torch, Model, registry, SSM_ARCH,
                                   base.params)
    for eng in (base, Engine(full, params, name=SSM_ARCH)):
        vocab = eng.model.cfg.vocab_size
        prompt = torch.randint(0, vocab, (64,), generator=torch.Generator()
                               .manual_seed(4)).tolist()
        # an ssm session's tensors are never written again: every turn
        # decodes from this one
        committed = eng.extend(eng.new_session(), prompt)
        decode_turns(torch, eng, SamplingParams, "[fused ssm]",
                     f"{SSM_ARCH} vocab {vocab}", lambda: committed,
                     TURNS, profile=eng is not base)
        lap(f"fused ssm, vocab {vocab}")


def ssm_check_phase(torch, base):
    """The mamba2-1.3b base's logits on the card against the same weights
    on the CPU: a 300-token prompt (chunks of 128, 128 and 44 padded to
    128), a resumed 40-token extend (one chunk), 3 decode steps."""
    m = base.model
    cpu_params = tree_map(lambda t: t.cpu(), base.params)
    toks = torch.randint(0, m.cfg.vocab_size, (1, 343),
                         generator=torch.Generator().manual_seed(5))
    logits = {}
    for dev, params in (("cuda", base.params), ("cpu", cpu_params)):
        t0 = time.perf_counter()
        with torch.no_grad():
            st = m.init_state(1, 0, device=dev)
            a, st = m.prefill(params, toks[:, :300].to(dev), st)
            b, st = m.prefill(params, toks[:, 300:340].to(dev), st)
            outs = [a[0], b[0]]
            for t in range(340, 343):
                c, st = m.decode_step(params, st, toks[:, t:t + 1].to(dev))
                outs.append(c)
        logits[dev] = torch.cat(outs).float().cpu()
        print(f"[check] ssm {dev}: {time.perf_counter() - t0:.1f} s", flush=True)
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    scale = logits["cpu"].abs().max().item()
    if not torch.allclose(logits["cuda"], logits["cpu"], atol=LOGIT_TOL,
                          rtol=LOGIT_TOL):
        raise AssertionError(f"{SSM_ARCH}: card vs CPU logits differ by "
                             f"{err} (> {LOGIT_TOL})")
    print(f"[check] ssm {SSM_ARCH} ({m.cfg.n_layers} layers, published "
          f"widths): card vs CPU"
          f" logits over a 300-token prompt, a 40-token extend and 3 decode "
          f"steps, max |diff| {err:.3g} at max |logit| {scale:.3g} "
          f"(tolerance {LOGIT_TOL}: fp32 on both sides, TF32 off, sums in "
          "other orders)", flush=True)


def window_kernel_phase(torch, F, ref, decode_kernel, hybrid, windowed):
    """Flash-decode (#1) with a sliding window against its plain version
    (``ref.decode_reference`` with the window), fp32 (atol 1e-5, rtol
    2e-5) and bf16 (2e-2): hymba-1.5b's heads (25 over 5, hd 64), B=8
    over 4096 with its window 2048; starcoder2-7b's (36 over 4, hd 128),
    B=8 over 8192 with its window 4096; and a ragged batch at hymba's
    heads whose lengths fall below, at and above the window.  Beside the
    windowed time (CUDA events, host cost included, and the profiler's
    device time): the unwindowed kernel's at the same capacity and
    lengths, the plain version, SDPA with the same boolean mask, and the
    byte bound of the window's keys alone.  Returns the records."""
    from repro_torch.kernels import decode_attention as decode_mod
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    tol = {"float32": (1e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}

    def heads(c):
        return c.n_heads, c.n_kv_heads, c.resolved_head_dim

    h_win, s_win = hybrid.sliding_window, windowed.sliding_window
    cases = [("hymba", heads(hybrid), 4096, h_win, [4096] * 8),
             ("starcoder2", heads(windowed), 8192, s_win, [8192] * 8),
             ("hymba", heads(hybrid), 4096, h_win,
              [1, 700, h_win, h_win + 1, 3000, 4096])]
    records = []
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        esize = torch.tensor([], dtype=dt).element_size()
        for model, (h, kh, hd), cap, window, lens in cases:
            b = len(lens)
            kc = torch.randn(b, cap, kh, hd, generator=gen, device=dev).to(
                dt).permute(0, 2, 1, 3)
            vc = torch.randn(b, cap, kh, hd, generator=gen, device=dev).to(
                dt).permute(0, 2, 1, 3)
            q = torch.randn(b, h, hd, generator=gen, device=dev).to(dt)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            label = (f"{model} {dname} B={b} cache={cap} window={window} "
                     f"lengths={lens if len(set(lens)) > 1 else lens[0]}")
            out = decode_kernel(q, kc, vc, lengths, window)
            exp = ref.decode_reference(q, kc, vc, lengths, window)
            err = (out.float() - exp.float()).abs().max().item()
            atol, rtol = tol[dname]
            if not torch.allclose(out.float(), exp.float(), atol=atol,
                                  rtol=rtol):
                raise AssertionError(f"decode_attention {label}: max |err| "
                                     f"{err} beyond atol {atol}, rtol "
                                     f"{rtol}")
            j = torch.arange(cap, device=dev)[None, :]
            mask = ((j < lengths[:, None]) &
                    (j >= lengths[:, None] - window))[:, None, None, :]
            q4 = q[:, :, None, :]
            ms = time_ms(torch, lambda: decode_kernel(q, kc, vc, lengths,
                                                      window))
            full_ms = time_ms(torch, lambda: decode_kernel(q, kc, vc,
                                                           lengths))
            # the wrapper's host cost (~0.04 ms) hides the kernels at
            # hymba's heads: the device times compare the two launches
            dev_ms = device_ms(torch, lambda: decode_kernel(q, kc, vc,
                                                            lengths, window))
            full_dev_ms = device_ms(torch, lambda: decode_kernel(
                q, kc, vc, lengths))
            plain_ms = time_ms(torch, lambda: ref.decode_reference(
                q, kc, vc, lengths, window), reps=5)
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kc, vc, attn_mask=mask, enable_gqa=True))
            keys = sum(min(n, window) for n in lens)
            nbytes = (2 * q.numel() + 2 * keys * kh * hd) * esize + 4 * b
            bound_ms, by = bound(nbytes, 4 * hd * h * keys, dname)
            plan = decode_mod.plan(q, kc, vc, window)
            full = decode_mod.plan(q, kc, vc)
            records.append(dict(
                shape=label, dtype=dname, max_abs_err=err, ms=ms,
                unwindowed_ms=full_ms, device_ms=dev_ms,
                unwindowed_device_ms=full_dev_ms, plain_ms=plain_ms,
                library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by,
                split=[plan["n_split"], plan["split_keys"]],
                vector_bytes=plan["vector_bytes"]))
            print(f"[kernels] decode_attention window {label}: err "
                  f"{err:.3g} | kernel {ms:.4f} ms windowed, {full_ms:.4f} "
                  f"ms unwindowed (x{ms / full_ms:.3f}); device "
                  f"{dev_ms:.4f} ms windowed, {full_dev_ms:.4f} ms "
                  f"unwindowed (x{dev_ms / full_dev_ms:.3f}); plain "
                  f"{plain_ms:.4f} ms, sdpa (same mask) {lib_ms:.4f} ms, "
                  f"bound {bound_ms:.5f} ms ({by}; the window's {keys} "
                  f"keys) | " + decode_plan_note(plan, label)
                  + f" (unwindowed: split {full['n_split']} x "
                  f"{full['split_keys']} keys)", flush=True)
    return records


def hybrid_main_phase(torch, serve, tasks, loader, kernels):
    """SpecReason with the hymba-1.5b base at its published widths and
    depth (32 layers, d_model 1600, 25 heads over 5 of 64 with window
    2048 beside 50 SSD heads of 64 with state 16, d_ff 5504; random init
    from a seed, vocabulary cut to 64) and the testbed SMALL drafter,
    both on their default decode loop (the fused one): 3 requests greedy
    and at 0.6, then greedy req0 and sampled req0 on the per-token loop,
    whose tokens must equal the fused turn's.  Per run, #2 must launch 32
    x the base's metered extends + SMALL's layers x its prefill calls, #5
    32 x the base's extends, #1 32 x the base's metered decode steps +
    SMALL's layers x its steps (masked and warm-up steps included), the
    paged kernels 0 times; after every request each engine has captured
    once per loop key, and the base's keys share one pooled K/V pair and
    the static conv/ssm pair.  Then each greedy request profiled (fused):
    its idle share, and the profiler's flash-decode count == the
    counter.  Returns (launches, base engine)."""
    t0 = time.perf_counter()
    base = loader.random_engine(HYBRID_ARCH, "cuda", seed=0)
    small = loader.random_engine("testbed-small", "cuda", seed=1)
    torch.cuda.synchronize()
    cfg = base.model.cfg
    print(f"[main] hybrid: {HYBRID_ARCH} base, {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} of {cfg.resolved_head_dim} (window "
          f"{cfg.sliding_window}) beside {cfg.ssm_n_heads} SSD heads of "
          f"{cfg.ssm_head_dim} (state {cfg.ssm_state}), d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size} (cut from 32001), "
          f"{sum(t.numel() for t in leaves(base.params))} parameters, "
          f"random init in {time.perf_counter() - t0:.1f} s; testbed SMALL "
          f"drafter; threshold {HYBRID_THRESHOLD}; decode loops "
          f"{loader.decode_loops(base, small)}", flush=True)
    rng = random.Random(0)
    reqs = [tasks.sample_task(rng) for _ in range(3)]
    nb, ns = cfg.n_layers, small.model.cfg.n_layers
    results, launches = sequential_turns(
        torch, serve, base, small, reqs, kernels, "hybrid",
        lambda mb, ms_, _: {
            "ssd_scan": nb * mb["prefill_calls"],
            "flash_attention": nb * mb["prefill_calls"]
            + ns * ms_["prefill_calls"],
            "decode_attention": nb * mb["decode_steps"]
            + ns * ms_["decode_steps"]},
        f"ssd_scan == {nb} x base extends; flash == {nb} x base extends + "
        f"{ns} x SMALL's prefill calls; decode == {nb} x base decode steps "
        f"+ {ns} x SMALL's", HYBRID_THRESHOLD)
    walls = [res.wall_time for res in results["greedy"]]
    keys = list(base._loops)
    static = base._ssm_static[1]
    if len({k[:2] for k in keys}) != 1 or {k[-2:] for k in keys} != {
            (static.conv.data_ptr(), static.ssm.data_ptr())}:
        raise AssertionError("hybrid: the base's loop keys do not share one "
                             "pooled K/V pair and the static conv/ssm pair")
    print(f"[main] hybrid: the base's {len(keys)} loop keys share one "
          "pooled K/V pair and the static conv/ssm pair", flush=True)
    for i, task in enumerate(reqs):
        def run(task=task, i=i):
            gen = torch.Generator(device="cuda").manual_seed(i)
            return serve.run_scheme("specreason", base, small, task, gen,
                                    128, HYBRID_THRESHOLD, 0.0)
        p = profile_request(torch, run, kernels["decode_attention"],
                            walls[i])
        n_out = len(p["res"].thinking_ids + p["res"].answer_ids)
        seen, dev_ms = traced(p["rows"], "decode_kernel")
        gate(p, seen, f"hybrid greedy req{i}", "decode_kernel")
        print(f"[profile] hybrid greedy req{i} (fused, {n_out} tokens, "
              f"{walls[i] * 1e3:.1f} ms and "
              f"{n_out / walls[i]:.1f} tok/s unprofiled): "
              f"{p['window']}; decode_kernel {seen} launches traced == "
              f"{p['counted']} counted, {dev_ms:.1f} ms; {p['top']}",
              flush=True)
    return launches, base


def card_and_cpu_logits(torch, Engine, model, params, prompt, tokens,
                        max_len, at, src=None):
    """The last prefill position's logits of ``prompt`` and the logits
    after feeding ``tokens`` one by one (``decode_one``), at the decode
    steps listed in ``at`` (1-based), on the card and on the CPU from
    the same parameters (a cross-attention model's sessions over the
    source ``src``): {"cuda": (rows, V), "cpu": (rows, V)} and the
    CPU's seconds."""
    out, cpu_s = {}, 0.0
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        p = params if dev == "cuda" else tree_map(lambda t: t.cpu(), params)
        eng = Engine(model, p, max_len=max_len)
        with torch.no_grad():
            s = eng.extend(eng.new_session(cross_src=src), prompt)
            rows = [s.last_logits[0]]
            for n, tok in enumerate(tokens, 1):
                s = eng.decode_one(s, tok)
                if n in at:
                    rows.append(s.last_logits[0])
        out[dev] = torch.stack(rows).float().cpu()
        cpu_s = time.perf_counter() - t0
    return out, cpu_s


def logits_close(torch, tag, logits):
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    scale = logits["cpu"].abs().max().item()
    if not torch.allclose(logits["cuda"], logits["cpu"], atol=LOGIT_TOL,
                          rtol=LOGIT_TOL):
        raise AssertionError(f"{tag}: card vs CPU logits differ by {err} "
                             f"(> {LOGIT_TOL})")
    return f"max |diff| {err:.3g} at max |logit| {scale:.3g}"


def window_main_phase(torch, loader, Model, Engine, SamplingParams,
                      kernels):
    """hymba-1.5b at WINDOW_DEPTH layers of its published widths (random
    init, vocabulary 64) with max_len WINDOW_CACHE, so that its window
    of 2048 masks keys: prefill WINDOW_PREFILL tokens, then WINDOW_DECODE
    tokens greedy fused and the same eager from the same prefill (equal
    tokens; #1, #2 and #5 launches == layers x the metered steps and
    extends); then the card's logits at the last prefill position and
    after decodes 1 and WINDOW_DECODE against the same model's on the
    CPU (atol = rtol = LOGIT_TOL).  Returns the launches."""
    import dataclasses
    t0 = time.perf_counter()
    cfg = dataclasses.replace(loader.arch_config(HYBRID_ARCH),
                              n_layers=WINDOW_DEPTH)
    model = Model(cfg)
    params = model.init(2, device="cuda")
    eng = Engine(model, params, max_len=WINDOW_CACHE, name=HYBRID_ARCH)
    prompt = torch.randint(0, cfg.vocab_size, (WINDOW_PREFILL,),
                           generator=torch.Generator().manual_seed(6)
                           ).tolist()
    for k in kernels.values():
        k.launches = 0
    eng.meter.reset()
    s0 = eng.extend(eng.new_session(), prompt)
    out = {}
    for loop in ("fused", "eager"):
        ids, _, _ = eng.generate(s0, WINDOW_DECODE, [], SamplingParams(),
                                 torch.Generator(device="cuda"),
                                 fused=loop == "fused")
        out[loop] = ids
    torch.cuda.synchronize()
    m, n = eng.meter, cfg.n_layers
    want = {"flash_attention": n * m.prefill_calls,
            "ssd_scan": n * m.prefill_calls,
            "decode_attention": n * m.decode_steps}
    got = {k: kernels[k].launches for k in want}
    if got != want or any(kernels[k].launches for k in kernels
                          if k not in want):
        raise AssertionError(f"window: launches "
                             f"{ {k: v.launches for k, v in kernels.items()} }"
                             f" != {want} (others 0)")
    if out["fused"] != out["eager"] or len(out["fused"]) != WINDOW_DECODE:
        raise AssertionError("window: the fused turn's tokens differ from "
                             "the eager turn's")
    logits, cpu_s = card_and_cpu_logits(
        torch, Engine, model, params, prompt, out["fused"], WINDOW_CACHE,
        (1, WINDOW_DECODE))
    note = logits_close(torch, f"{HYBRID_ARCH} window", logits)
    last = WINDOW_PREFILL + WINDOW_DECODE - 1
    print(f"[main] window: {HYBRID_ARCH} at {n} of 32 layers (published "
          f"widths, window {cfg.sliding_window}, max_len {WINDOW_CACHE}): "
          f"prefill {WINDOW_PREFILL} tokens, {WINDOW_DECODE} tokens fused "
          f"== eager ({m.decode_steps} decode steps); the last query "
          f"(position {last}) masks the {last + 1 - cfg.sliding_window} "
          f"oldest keys; launches {got} == {n} x the metered calls; card "
          f"vs CPU logits at the last prefill position and after decodes 1 "
          f"and {WINDOW_DECODE}: {note} (tolerance {LOGIT_TOL}); CPU "
          f"{cpu_s:.1f} s, {time.perf_counter() - t0:.1f} s in all",
          flush=True)
    return got


def arch_check_phase(torch, loader, Model, Engine, SamplingParams, arch,
                     kernels):
    """``arch`` (dense) at ARCH_DEPTH layers of its published widths
    (random init, vocabulary 64) on the sequential path: prefill
    ARCH_PREFILL tokens and decode ARCH_DECODE greedy through the fused
    loop (#2 and #1 launches == layers x the metered calls); then the
    card's logits at the last prefill position and after every decode
    against the CPU's (atol = rtol = LOGIT_TOL), and the card's greedy
    picks over them equal to the fused loop's tokens."""
    import dataclasses
    t0 = time.perf_counter()
    published = loader.arch_config(arch).n_layers
    cfg = dataclasses.replace(loader.arch_config(arch), n_layers=ARCH_DEPTH)
    model = Model(cfg)
    params = model.init(4, device="cuda")
    eng = Engine(model, params, name=arch)
    prompt = torch.randint(0, cfg.vocab_size, (ARCH_PREFILL,),
                           generator=torch.Generator().manual_seed(7)
                           ).tolist()
    for k in kernels.values():
        k.launches = 0
    eng.meter.reset()
    s = eng.extend(eng.new_session(), prompt)
    ids, _, _ = eng.generate(s, ARCH_DECODE, [], SamplingParams(),
                             torch.Generator(device="cuda"))
    torch.cuda.synchronize()
    m, n = eng.meter, cfg.n_layers
    want = {"flash_attention": n * m.prefill_calls,
            "decode_attention": n * m.decode_steps}
    got = {k: kernels[k].launches for k in want}
    if got != want or len(ids) != ARCH_DECODE or any(
            kernels[k].launches for k in kernels if k not in want):
        raise AssertionError(f"{arch}: launches "
                             f"{ {k: v.launches for k, v in kernels.items()} }"
                             f" != {want} (others 0), or {len(ids)} tokens")
    logits, cpu_s = card_and_cpu_logits(
        torch, Engine, model, params, prompt, ids, eng.max_len,
        range(1, ARCH_DECODE + 1))
    note = logits_close(torch, arch, logits)
    picks = logits["cuda"][:-1].argmax(-1).tolist()
    if picks != ids:
        raise AssertionError(f"{arch}: the card's greedy picks {picks} "
                             f"differ from the fused loop's tokens {ids}")
    print(f"[check] {arch} at {n} of {published} layers "
          f"(published widths: d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"over {cfg.n_kv_heads} of {cfg.resolved_head_dim}, d_ff "
          f"{cfg.d_ff}, {cfg.act}, window {cfg.sliding_window}; vocabulary "
          f"64): prefill {ARCH_PREFILL}, {ARCH_DECODE} tokens fused == the "
          f"card's greedy picks; launches {got} == {n} x the metered calls; "
          f"card vs CPU logits over the prefill's last position and "
          f"{ARCH_DECODE} decodes: {note} (tolerance {LOGIT_TOL}); CPU "
          f"{cpu_s:.1f} s, {time.perf_counter() - t0:.1f} s in all",
          flush=True)


def paged_tp_kernel_phase(torch, F, ref, minitron):
    """``kernels/paged_tp.py`` at one rank's share of minitron-4b's heads
    at tp=2 (12 query heads over 4 kv heads of 128): #3 over B=8 rows of
    4096 tokens and #4 with T = 64 and 5 over the same context, fp32 and
    bf16, each against the plain version, with its bound and SDPA over
    the pre-gathered K/V.  The wrappers need no group for one rank's
    launch.  Returns per-wrapper records."""
    from repro_torch.kernels import paged_tp
    from repro_torch.serving.tp import TPContext
    dev = torch.device("cuda")
    tp = TPContext(rank=0, tp_size=TP_SIZE, device=dev)
    heads = (minitron.n_heads, minitron.n_kv_heads)
    h, kh = heads[0] // TP_SIZE, heads[1] // TP_SIZE
    hd, bs, b, n = minitron.resolved_head_dim, 16, 8, 4096
    gen = torch.Generator(device=dev).manual_seed(5)
    records = {"tp_paged_decode_attention": [],
               "tp_paged_append_attention": []}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        esize = torch.tensor([], dtype=dt).element_size()

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dt)
        nb = n // bs
        kp, vp = randn(b * nb + 3, kh, bs, hd), randn(b * nb + 3, kh, bs, hd)
        tables = torch.randperm(b * nb + 3, generator=gen, device=dev)[
            :b * nb].reshape(b, nb).to(torch.int32).contiguous()
        kd = kp[tables.long()].transpose(1, 2).reshape(b, kh, n, hd)
        vd = vp[tables.long()].transpose(1, 2).reshape(b, kh, n, hd)
        lengths = torch.full((b,), n, dtype=torch.int32, device=dev)
        q = randn(b, h, hd)
        args = (tp, q, kp, vp, tables, lengths)
        out = paged_tp.tp_paged_decode_attention(*args, heads=heads)
        exp = ref.paged_decode_reference(*args[1:])
        err = (out.float() - exp.float()).abs().max().item()
        if not torch.allclose(out.float(), exp.float(), atol=TOL[dname],
                              rtol=TOL[dname]):
            raise AssertionError(f"tp_paged_decode_attention {dname}: max "
                                 f"|err| {err}")
        label = f"minitron-tp{TP_SIZE} {dname} B={b} over {n}, {h} over {kh}"
        ms = time_ms(torch, lambda: paged_tp.tp_paged_decode_attention(
            *args, heads=heads))
        plain_ms = time_ms(torch, lambda: ref.paged_decode_reference(
            *args[1:]), reps=5)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kd, vd, enable_gqa=True))
        nbytes = (2 * q.numel() + 2 * b * n * kh * hd) * esize \
            + 4 * (b + b * nb)
        bound_ms, by = bound(nbytes, 4 * hd * h * b * n, dname)
        records["tp_paged_decode_attention"].append(dict(
            shape=label, dtype=dname, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=by))
        print(f"[kernels] tp_paged_decode_attention {label}: err {err:.3g} "
              f"| kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa over "
              f"gathered K/V {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({by})",
              flush=True)
        for t in (64, 5):
            ctx = n - t
            cl = torch.full((b,), ctx, dtype=torch.int32, device=dev)
            sl = torch.full((b,), t, dtype=torch.int32, device=dev)
            qa, kn, vn = randn(b, t, h, hd), randn(b, t, kh, hd), \
                randn(b, t, kh, hd)
            args = (tp, qa, kn, vn, kp, vp, tables, cl, sl)
            out = paged_tp.tp_paged_append_attention(*args, heads=heads)
            exp = ref.paged_append_reference(*args[1:])
            err = (out.float() - exp.float()).abs().max().item()
            if not torch.allclose(out.float(), exp.float(), atol=TOL[dname],
                                  rtol=TOL[dname]):
                raise AssertionError(f"tp_paged_append_attention {dname} "
                                     f"T={t}: max |err| {err}")
            kc = torch.cat([kd[:, :, :ctx], kn.transpose(1, 2)], 2)
            vc = torch.cat([vd[:, :, :ctx], vn.transpose(1, 2)], 2)
            mask = torch.ones(t, ctx + t, dtype=torch.bool,
                              device=dev).tril(ctx)
            qh = qa.transpose(1, 2)
            label = (f"minitron-tp{TP_SIZE} {dname} T={t} B={b} ctx={ctx}, "
                     f"{h} over {kh}")
            ms = time_ms(torch, lambda: paged_tp.tp_paged_append_attention(
                *args, heads=heads))
            plain_ms = time_ms(torch, lambda: ref.paged_append_reference(
                *args[1:]), reps=5)
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kc, vc, attn_mask=mask, enable_gqa=True))
            pairs = b * (t * ctx + t * (t + 1) // 2)
            nbytes = (2 * b * t * h * hd + 2 * b * t * kh * hd
                      + 2 * b * ctx * kh * hd) * esize \
                + 4 * (2 * b + b * nb)
            bound_ms, by = bound(nbytes, 4 * hd * h * pairs, dname)
            records["tp_paged_append_attention"].append(dict(
                shape=label, dtype=dname, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=by))
            print(f"[kernels] tp_paged_append_attention {label}: err "
                  f"{err:.3g} | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa over gathered K/V {lib_ms:.4f} ms, bound "
                  f"{bound_ms:.5f} ms ({by})", flush=True)
    return records


def draw_params(torch, model, seed, tp):
    """``model``'s parameters drawn on the card from ``seed`` with the
    port's init rules and scales, a stacked tensor (``layers/``,
    ``cross_layers/``, ``encoder/layers/``) one layer (a vlm model's:
    one group) a draw,
    keeping rank ``tp.rank``'s slice of each tensor that
    ``models/sharding.py`` slices (``tp`` None: everything whole).  So
    every rank and tp=1 draw the same numbers, and a rank holds no more
    than one layer of a sliced tensor beyond its slice."""
    from repro_torch.models.model import unflatten
    from repro_torch.models.sharding import sliced_dim
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def part(t, key):
        dim = None if tp is None else sliced_dim(key)
        if dim is None:
            return t
        n = t.shape[dim] // tp.tp_size
        return t.narrow(dim, tp.rank * n, n).contiguous()
    flat = {}
    for key, s in sorted(model.spec().items()):
        if s.init in ("ones", "zeros"):
            full = (torch.ones if s.init == "ones" else torch.zeros)(
                s.shape, device="cuda")
            flat[key] = part(full, key)
            continue
        std = s.scale / math.sqrt(max(s.shape[s.fan_in_axis], 1)) \
            if s.init == "scaled" else s.scale
        if key.startswith(("layers/", "cross_layers/", "encoder/layers/")):
            for i in range(s.shape[0]):
                layer = part(torch.randn(s.shape[1:], generator=gen,
                                         device="cuda") * std, key)
                if i == 0:
                    flat[key] = torch.empty((s.shape[0],) + layer.shape,
                                            device="cuda")
                flat[key][i] = layer
        else:
            flat[key] = part(torch.randn(s.shape, generator=gen,
                                         device="cuda") * std, key)
    return unflatten(flat)


def tp_rank(tp):
    """One side of ``[main] tp``: rank ``tp.rank`` of the group, or tp=1
    in this process (``tp`` None).  Module level, so that the processes
    ``serving.tp.run_ranks`` spawns find it by name.  Draws minitron-4b
    at TP_DEPTH layers (``draw_params``, seed 0) and the SMALL drafter
    (seed 1), serves TP_REQUESTS greedy requests through ``serve``'s
    continuous scheduler on the per-token rows loop with the launch
    counts zeroed just before, then extends a TP_PROMPT-token prompt on
    a fresh engine.  Returns plain data."""
    import dataclasses
    import torch
    from repro_torch.data import tasks
    from repro_torch.kernels import paged_tp
    from repro_torch.kernels.paged_append_attention import \
        paged_append_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.serving import loader
    from repro_torch.serving.batch_engine import BatchEngine
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.workload import run_workload
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda") if tp is None else tp.device
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = Model(dataclasses.replace(loader.arch_config(DENSE_ARCH),
                                      n_layers=TP_DEPTH))
    base = Engine(model, draw_params(torch, model, 0, tp), name=DENSE_ARCH)
    small = loader.random_engine("testbed-small", dev, seed=1)
    args = serve.parse_args(
        ["--scheduler", "continuous", "-n", str(TP_REQUESTS), "--batch", "4",
         "--budget", str(ROWS_BUDGET), "--temperature", "0", "--threshold",
         str(THRESHOLD), "--kv-budget-mb", str(DENSE_KV_MB), "--device",
         "cuda", "--decode-loop", "eager"])
    sched = serve.continuous_scheduler(args, base, small, tp)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    rng = random.Random(0)
    pairs = [(tasks.sample_task(rng),
              torch.Generator(device=dev).manual_seed(i))
             for i in range(TP_REQUESTS)]
    wrappers = {"decode": paged_decode_attention,
                "append": paged_append_attention,
                "tp_decode": paged_tp.tp_paged_decode_attention,
                "tp_append": paged_tp.tp_paged_append_attention}
    for w in wrappers.values():
        w.launches = 0
    if tp is not None:
        tp.gathers, tp.gather_s, tp.broadcasts = 0, 0.0, 0
    t0 = time.perf_counter()
    handles = run_workload(sched, pairs, [0.0] * TP_REQUESTS)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    out = dict(
        launches={k: w.launches for k, w in wrappers.items()},
        meters={w: dict(layers=be.model.cfg.n_layers,
                        decode_steps=be.meter.decode_steps,
                        prefill_calls=be.meter.prefill_calls,
                        heads=(be.params["layers"]["attn"]["wq"].shape[2],
                               be.store.k.shape[2]),
                        fused=be.fused)
                for w, be in sched.engines.items()},
        tokens=[h.result.thinking_ids + h.result.answer_ids
                for h in handles],
        statuses=[h.status for h in handles], wall=wall, init_s=init_s,
        ticks=sched.ticks,
        tok=sum(len(h.result.thinking_ids) + len(h.result.answer_ids)
                for h in handles))
    if tp is not None:
        out.update(gathers=tp.gathers, gather_s=tp.gather_s,
                   broadcasts=tp.broadcasts, backend=tp.backend,
                   devices=list(tp.devices))
    be = BatchEngine(model, base.params, batch=1, capacity=CACHE,
                     fused=False, tp=tp)
    prompt = torch.randint(0, model.cfg.vocab_size, (TP_PROMPT,),
                           generator=torch.Generator().manual_seed(4))
    row = be.alloc_row()
    last = be.extend_rows([row], [prompt.tolist()], want_logits=True)[0][-1]
    out["logits"] = last.float().cpu().numpy()
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    out["param_bytes"] = sum(t.numel() * t.element_size()
                             for t in leaves(sched.base_be.params))
    out["whole_bytes"] = sum(4 * math.prod(s.shape)
                             for s in model.spec().values())
    return out


def tp_cli_check(serve, ckpt):
    """``serve --scheduler continuous --tp TP_SIZE`` on the card, the
    CLI's own rank processes over the testbed checkpoint: 3 greedy
    requests, whose think and answer tokens must be ``--tp 1``'s (the
    per-token rows loop both ways)."""
    argv = ["--scheduler", "continuous", "-n", "3", "--batch", "2",
            "--budget", "48", "--temperature", "0", "--threshold",
            str(THRESHOLD), "--ckpt-dir", ckpt, "--device", "cuda",
            "--decode-loop", "eager"]
    runs = [[(r[3].thinking_ids, r[3].answer_ids) for r in
             serve.main(argv + ["--tp", str(n)]).runs]
            for n in (1, TP_SIZE)]
    if runs[0] != runs[1]:
        raise AssertionError(f"serve --tp {TP_SIZE}: tokens differ from "
                             "--tp 1's")
    print(f"[main] tp cli: serve --tp {TP_SIZE} on the testbed pair gave "
          f"--tp 1's think and answer tokens for {len(runs[0])} greedy "
          "requests", flush=True)


def tp_phase(torch, lap):
    """[main] tp: exact tensor parallelism on the continuous path at
    minitron-4b's widths (``tp_rank``), TP_SIZE rank processes sharing
    the card over gloo, against tp=1 in this process.  Checks per rank:
    #3's launches == n_layers x the metered decode steps and #4's ==
    n_layers x the extends (both engines), all of them through
    ``paged_tp`` (its counts equal #3's and #4's), the base's over its
    12 query and 4 kv heads; the ranks' tokens identical; tp=TP_SIZE's
    greedy tokens equal tp=1's for every request; one extend's last
    logits within LOGIT_TOL of tp=1's; each rank's peak memory below the
    whole model's bytes (a rank holding the model beside its shard would
    pass them).  Prints the backend, the gathers' time a forward, the
    memory and the lap.  Returns the ranks' summed paged_tp launches."""
    from repro_torch.serving.tp import run_ranks
    t0 = time.perf_counter()
    one = tp_rank(None)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = run_ranks(TP_SIZE, "cuda", tp_rank, timeout_s=TP_TIMEOUT_S)
    t2 = time.perf_counter()
    base = one["meters"]["base"]
    print(f"[main] tp: {DENSE_ARCH} base at {base['layers']} of 32 layers "
          f"(published widths; vocabulary 64), SMALL drafter, "
          f"{TP_REQUESTS} greedy requests over 4 rows at budget "
          f"{ROWS_BUDGET}, per-token rows loop; tp=1 here in "
          f"{t1 - t0:.1f} s (serving {one['wall']:.2f} s, {one['tok']} "
          f"tokens, peak {one['peak'] / 2 ** 30:.2f} GiB); {TP_SIZE} ranks "
          f"on {ranks[0]['devices']} over {ranks[0]['backend']} in "
          f"{t2 - t1:.1f} s", flush=True)
    for r, out in enumerate(ranks):
        m, got = out["meters"], out["launches"]
        want = {k: sum(e["layers"] * e[f] for e in m.values())
                for k, f in (("decode", "decode_steps"),
                             ("append", "prefill_calls"))}
        if (got["decode"], got["append"]) != (want["decode"],
                                              want["append"]) \
                or (got["tp_decode"], got["tp_append"]) != \
                (got["decode"], got["append"]) or not got["decode"] \
                or not got["append"]:
            raise AssertionError(f"tp rank {r}: launches {got} != {want} "
                                 "(all through paged_tp)")
        want_heads = (24 // TP_SIZE, 8 // TP_SIZE)
        if m["base"]["heads"] != want_heads or m["base"]["fused"]:
            raise AssertionError(f"tp rank {r}: base heads {m['base']} != "
                                 f"{want_heads} on the per-token loop")
        if any(st != "ok" for st in out["statuses"]):
            raise AssertionError(f"tp rank {r}: {out['statuses']}")
        if out["broadcasts"] > out["ticks"] + 1:
            raise AssertionError(
                f"tp rank {r}: {out['broadcasts']} broadcasts over "
                f"{out['ticks']} ticks; want the arrivals' alone (one a "
                "workload turn, ticks + 1)")
        if out["peak"] >= out["whole_bytes"]:
            raise AssertionError(f"tp rank {r}: peak {out['peak']} bytes "
                                 f">= the whole model's {out['whole_bytes']}")
        forwards = sum(e["decode_steps"] + e["prefill_calls"]
                       for e in m.values())
        print(f"[main] tp rank {r}: {out['tok']} tokens in "
              f"{out['wall']:.2f} s; #3 {got['decode']} = "
              + " + ".join(f"{e['layers']} x {e['decode_steps']}"
                           for e in m.values())
              + f" decode steps, #4 {got['append']} = "
              + " + ".join(f"{e['layers']} x {e['prefill_calls']}"
                           for e in m.values())
              + f" extends, all through paged_tp; base launches over "
              f"{m['base']['heads'][0]} query and {m['base']['heads'][1]} kv "
              f"heads, SMALL over {m['small']['heads'][0]} and "
              f"{m['small']['heads'][1]}; {out['gathers']} gathers in "
              f"{out['gather_s']:.3f} s ({out['gather_s'] / forwards * 1e3:.3f}"
              f" ms of exchange a forward, {forwards} forwards, "
              f"{2 * base['layers']} gathers a base forward); "
              f"{out['broadcasts']} broadcasts over {out['ticks']} ticks "
              "(the arrivals', one a workload turn: no deadline and no SLO, "
              "so no sweep broadcast); peak "
              f"{out['peak'] / 2 ** 30:.2f} GiB (its shard "
              f"{out['param_bytes'] / 2 ** 30:.2f} GiB, the whole model "
              f"{out['whole_bytes'] / 2 ** 30:.2f} GiB); init "
              f"{out['init_s']:.1f} s", flush=True)
    if any(out["tokens"] != ranks[0]["tokens"] for out in ranks):
        raise AssertionError("tp: the ranks' tokens differ")
    same = [a == b for a, b in zip(ranks[0]["tokens"], one["tokens"])]
    if not all(same):
        raise AssertionError(f"tp: tp={TP_SIZE} greedy tokens differ from "
                             f"tp=1's ({same})")
    gap = max(abs(float(x)) for x in (ranks[0]["logits"] - one["logits"]))
    if gap > LOGIT_TOL:
        raise AssertionError(f"tp: extend logits gap {gap} > {LOGIT_TOL}")
    print(f"[main] tp: the ranks' tokens are identical; tp={TP_SIZE} greedy "
          f"tokens equal tp=1's for all {TP_REQUESTS} requests; a "
          f"{TP_PROMPT}-token extend's last logits max |tp={TP_SIZE} - tp=1| "
          f"{gap:.3g} (<= {LOGIT_TOL})", flush=True)
    lap("main path, tp")
    return {"tp_paged_decode_attention": sum(
        o["launches"]["tp_decode"] for o in ranks),
        "tp_paged_append_attention": sum(
        o["launches"]["tp_append"] for o in ranks)}


def paged_window_kernel_phase(torch, F, ref, paged_decode, paged_append,
                              windowed, moe):
    """Paged flash-decode (#3) and paged span attention (#4) with a
    sliding window against their plain versions (``ref`` with the
    window), fp32 and bf16 at the tolerances of tests/test_kernels.py:
    starcoder2-7b's heads (36 over 4, hd 128) with its window 4096, #3 B=8
    over 8192 keys and #4 T=64 and T=5 over 8192 committed keys each
    (every span position live), the unwindowed launch of the same inputs
    timed beside; granite-moe-1b's heads (16 over 8, hd 64), #3 B=8 over
    4096 and #4 T=64 / T=5 over 4096, no window.  Each: its time (CUDA
    events, host cost included), the plain version's, SDPA's over the
    pre-gathered K/V with the same boolean mask, and its bound (a window
    counts its keys only).  Returns per-kernel records."""
    from repro_torch.kernels import paged_decode_attention as paged_mod
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    bs = 16
    heads = {"starcoder2": (windowed.n_heads, windowed.n_kv_heads,
                            windowed.resolved_head_dim,
                            windowed.sliding_window),
             "granite": (moe.n_heads, moe.n_kv_heads,
                         moe.resolved_head_dim, moe.sliding_window)}
    records = {"paged_decode_attention": [], "paged_append_attention": []}

    def pages(lens, kh, hd, dtype):
        nb = -(-max(lens) // bs)
        n_pages = len(lens) * nb + 3
        kp = torch.randn(n_pages, kh, bs, hd, generator=gen,
                         device=dev).to(dtype)
        vp = torch.randn(n_pages, kh, bs, hd, generator=gen,
                         device=dev).to(dtype)
        perm = torch.randperm(n_pages, generator=gen, device=dev)
        return kp, vp, perm[:len(lens) * nb].reshape(len(lens), nb).to(
            torch.int32).contiguous()

    def gathered(p, tables):
        b, nb = tables.shape
        return p[tables.long()].transpose(1, 2).reshape(b, p.shape[1],
                                                        nb * bs, p.shape[3])

    def check(name, label, out, exp, dname):
        err = (out.float() - exp.float()).abs().max().item()
        if not torch.allclose(out.float(), exp.float(), atol=TOL[dname],
                              rtol=TOL[dname]):
            raise AssertionError(f"{name} {label}: max |err| {err} beyond "
                                 f"atol = rtol = {TOL[dname]}")
        return err

    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        esize = torch.tensor([], dtype=dt).element_size()
        for model, n_keys in (("starcoder2", 8192), ("granite", 4096)):
            h, kh, hd, window = heads[model]
            b = 8
            lens = [n_keys] * b
            kp, vp, tables = pages(lens, kh, hd, dt)
            q = torch.randn(b, h, hd, generator=gen, device=dev).to(dt)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            label = (f"{model} {dname} B={b} over {n_keys} window={window}")
            out = paged_decode(q, kp, vp, tables, lengths, window)
            err = check("paged_decode_attention", label, out,
                        ref.paged_decode_reference(q, kp, vp, tables,
                                                   lengths, window), dname)
            kd, vd = gathered(kp, tables), gathered(vp, tables)
            j = torch.arange(kd.shape[2], device=dev)[None, :]
            seen = j < lengths[:, None]
            if window:
                seen = seen & (j >= lengths[:, None] - window)
            q4 = q[:, :, None, :]
            ms = time_ms(torch, lambda: paged_decode(q, kp, vp, tables,
                                                     lengths, window))
            full_ms = time_ms(torch, lambda: paged_decode(q, kp, vp, tables,
                                                          lengths))
            plain_ms = time_ms(torch, lambda: ref.paged_decode_reference(
                q, kp, vp, tables, lengths, window), reps=5)
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kd, vd, attn_mask=seen[:, None, None, :],
                enable_gqa=True))
            keys = sum(min(n, window) if window else n for n in lens)
            nbytes = (2 * q.numel() + 2 * keys * kh * hd) * esize \
                + 4 * (b + sum(-(-(min(n, window) if window else n) // bs)
                               + 1 for n in lens))
            bound_ms, by = bound(nbytes, 4 * hd * h * keys, dname)
            plan = paged_mod.plan(q, kp, vp, tables, window)
            records["paged_decode_attention"].append(dict(
                shape=label, dtype=dname, max_abs_err=err, ms=ms,
                unwindowed_ms=full_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by,
                split=[plan["n_split"], plan["split_keys"]],
                vector_bytes=plan["vector_bytes"]))
            print(f"[kernels] paged_decode_attention window {label}: err "
                  f"{err:.3g} | kernel {ms:.4f} ms"
                  + (f" windowed, {full_ms:.4f} ms unwindowed" if window
                     else "") + f"; plain {plain_ms:.4f} ms, sdpa over "
                  f"gathered K/V (same mask, gather excluded) {lib_ms:.4f} "
                  f"ms, bound {bound_ms:.5f} ms ({by}; {keys} keys) | "
                  + decode_plan_note(plan, label), flush=True)

            for t in (64, 5):
                ctx = [n_keys] * b
                kp, vp, tables = pages([c + t for c in ctx], kh, hd, dt)
                q = torch.randn(b, t, h, hd, generator=gen, device=dev).to(dt)
                kn = torch.randn(b, t, kh, hd, generator=gen,
                                 device=dev).to(dt)
                vn = torch.randn(b, t, kh, hd, generator=gen,
                                 device=dev).to(dt)
                cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
                sl = torch.full((b,), t, dtype=torch.int32, device=dev)
                args = (q, kn, vn, kp, vp, tables, cl, sl)
                label = (f"{model} {dname} T={t} B={b} ctx={n_keys} "
                         f"window={window}")
                out = paged_append(*args, window)
                err = check("paged_append_attention", label, out,
                            ref.paged_append_reference(*args, window), dname)
                kd = torch.cat([gathered(kp, tables), kn.transpose(1, 2)], 2)
                vd = torch.cat([gathered(vp, tables), vn.transpose(1, 2)], 2)
                s_ctx = kd.shape[2] - t
                kj = torch.arange(s_ctx + t, device=dev)[None, None, :]
                qi = torch.arange(t, device=dev)[None, :, None]
                c3 = cl[:, None, None]
                mask = ((kj < c3) & (kj < s_ctx)) | (
                    (kj >= s_ctx) & (kj - s_ctx <= qi))
                if window:
                    kpos = torch.where(kj < s_ctx, kj, c3 + kj - s_ctx)
                    mask = mask & (kpos > c3 + qi - window)
                qh = q.transpose(1, 2)
                ms = time_ms(torch, lambda: paged_append(*args, window))
                full_ms = time_ms(torch, lambda: paged_append(*args))
                plain_ms = time_ms(torch, lambda: ref.paged_append_reference(
                    *args, window), reps=3)
                lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qh, kd, vd, attn_mask=mask[:, None], enable_gqa=True))
                # (query, key) pairs each query sees; the committed keys
                # some query of the row sees
                seen_q = [min(c + i + 1, window) if window else c + i + 1
                          for c in ctx for i in range(t)]
                read = sum(min(c, window - 1) if window else c for c in ctx)
                nbytes = (2 * b * t * h * hd + 2 * b * t * kh * hd
                          + 2 * read * kh * hd) * esize + 4 * (
                              2 * b + sum(-(-(min(c, window) if window
                                              else c) // bs) + 1
                                          for c in ctx))
                bound_ms, by = bound(nbytes, 4 * hd * h * sum(seen_q),
                                     dname)
                records["paged_append_attention"].append(dict(
                    shape=label, dtype=dname, max_abs_err=err, ms=ms,
                    unwindowed_ms=full_ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=bound_ms, bound_by=by))
                print(f"[kernels] paged_append_attention window {label}: "
                      f"err {err:.3g} | kernel {ms:.4f} ms"
                      + (f" windowed, {full_ms:.4f} ms unwindowed"
                         if window else "") + f"; plain {plain_ms:.4f} ms, "
                      f"sdpa over gathered K/V (same mask, gather "
                      f"excluded) {lib_ms:.4f} ms, bound {bound_ms:.5f} ms "
                      f"({by}; {sum(seen_q)} query-key pairs, {read} "
                      "committed keys read)", flush=True)
    return records


class DropMeter:
    """Counts, on the card and without a host read (so inside captured
    graphs too), the routings of the port's moe layers and the sum of
    their ``dropped_frac``: ``models.moe.route`` wrapped while
    installed."""

    def __init__(self, torch, moe):
        self.moe, self.real = moe, moe.route
        self.acc = torch.zeros(2, device="cuda")

        def route(logits, cfg, capacity):
            out = self.real(logits, cfg, capacity)
            self.acc[0].add_(out[-1]["dropped_frac"])
            self.acc[1].add_(1.0)
            return out
        moe.route = route

    def read(self):
        """(routings, mean dropped fraction) since the last read."""
        n, s = self.acc[1].item(), self.acc[0].item()
        self.acc.zero_()
        return int(n), s / max(n, 1.0)

    def remove(self):
        self.moe.route = self.real


def moe_routing(torch, moe, run):
    """Run ``run()`` with ``models.moe.route`` recording, per routing,
    the experts (G, S, k), the keep mask and the top-k margin (the k-th
    probability less the (k+1)-th) of every token.  Returns (run's
    result, the records)."""
    real, recs = moe.route, []

    def route(logits, cfg, capacity):
        out = real(logits, cfg, capacity)
        probs = torch.sort(torch.softmax(logits.float(), -1), dim=-1,
                           descending=True, stable=True)[0]
        k = cfg.top_k
        recs.append((out[0].cpu(), out[2].cpu(),
                     (probs[..., k - 1] - probs[..., k]).cpu()))
        return out
    moe.route = route
    try:
        return run(), recs
    finally:
        moe.route = real


def moe_main_phase(torch, serve, tasks, loader, kernels, Model,
                   BatchEngine, lap):
    """granite-moe-1b-a400m at its published widths and depth (24 layers,
    d_model 1024, 16 heads over 8 of 64, 32 experts of d_ff 512, top-8;
    random init from a seed, vocabulary cut to 64) with the testbed SMALL
    drafter, both on their fused loops.  Sequential SpecReason
    (``serve.run_scheme``): 3 requests greedy and at 0.6, then greedy
    req0 and sampled req0 on the per-token loop, whose tokens must equal
    the fused turn's; #2 == 24 x the base's extends + SMALL's layers x
    its prefill calls, #1 == 24 x the base's decode steps + SMALL's, no
    paged launch; one capture per loop key.  Continuous
    (``serve.serve_continuous``: the batched rows' fused loop, the prefix
    cache on): 8 requests over 4 rows greedy, then with spec decode
    (gamma 4); #3 and #4 == n_layers x the batched engines' metered
    steps and extends, no dense launch; per request latency, TTFT, TPOT;
    tok/s a run.  As information: how many of the first 3 continuous
    greedy requests give the sequential greedy tokens, and the mean
    dropped fraction of the runs' routings.  Greedy req0 once more under
    the profiler (its idle share; its count of #1 against the
    counter).  Then, at 2 of the
    layers: one 4-row extend card against CPU (the smallest top-k margin,
    the routing choices that differ, and the logits within LOGIT_TOL at
    every token whose row agreed in routing up to it), and one training
    step's loss and gradients card against CPU, each within 1e-5 of its
    tensor's largest.  Returns (launches, base engine)."""
    import dataclasses

    from repro_torch.data import pipeline
    from repro_torch.models import moe
    from repro_torch.models.model import flatten, unflatten
    from repro_torch.training import loss as tloss
    t0 = time.perf_counter()
    base = loader.random_engine(MOE_ARCH, "cuda", seed=0)
    small = loader.random_engine("testbed-small", "cuda", seed=1)
    torch.cuda.synchronize()
    cfg = base.model.cfg
    print(f"[main] moe: {MOE_ARCH} base, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} of "
          f"{cfg.resolved_head_dim}, {cfg.n_experts} experts of d_ff "
          f"{cfg.d_ff}, top-{cfg.top_k}, capacity factor "
          f"{cfg.capacity_factor}, tied embeddings, vocab {cfg.vocab_size} "
          f"(cut from 49155), "
          f"{sum(t.numel() for t in leaves(base.params))} parameters, "
          f"random init in {time.perf_counter() - t0:.1f} s; testbed SMALL "
          f"drafter; threshold {MOE_THRESHOLD}; decode loops "
          f"{loader.decode_loops(base, small)}", flush=True)
    drops = DropMeter(torch, moe)
    rng = random.Random(0)
    reqs = [tasks.sample_task(rng) for _ in range(MOE_REQUESTS)]
    nb, ns = cfg.n_layers, small.model.cfg.n_layers
    results, launches = sequential_turns(
        torch, serve, base, small, reqs, kernels, "moe",
        lambda mb, ms_, _: {
            "flash_attention": nb * mb["prefill_calls"]
            + ns * ms_["prefill_calls"],
            "decode_attention": nb * mb["decode_steps"]
            + ns * ms_["decode_steps"]},
        f"flash == {nb} x base extends + {ns} x SMALL's prefill calls; "
        f"decode == {nb} x base decode steps + {ns} x SMALL's",
        MOE_THRESHOLD, MOE_BUDGET)
    outputs = [tokens_of(res) for res in results["greedy"]]
    n, frac = drops.read()
    print(f"[main] moe sequential: {n} routings over the four runs, mean "
          f"dropped fraction {frac:.4g}", flush=True)
    lap("main path, moe sequential")

    # the serve CLI's continuous path over this pair
    argv = ["--scheduler", "continuous", "--batch", "4", "--budget",
            str(MOE_BUDGET), "--threshold", str(MOE_THRESHOLD),
            "--temperature", "0", "--device", "cuda", "-n",
            str(MOE_REQUESTS)]
    reports = {}
    for label, extra in (("greedy", []),
                         ("spec greedy", ["--spec-decode", "--gamma", "4"])):
        args = serve.parse_args(argv + extra)
        for k in kernels.values():
            k.launches = 0
        report = serve.serve_continuous(args, base, small, reqs,
                                        torch.device("cuda"))
        sched, st = report.sched, report.stats
        want = {"paged_decode_attention": 0, "paged_append_attention": 0}
        for be in (sched.base_be, sched.small_be):
            n = be.model.cfg.n_layers
            want["paged_decode_attention"] += n * be.meter.decode_steps
            want["paged_append_attention"] += n * be.meter.prefill_calls
        got = {k: kernels[k].launches for k in want}
        if got != want or not all(want.values()) or any(
                kernels[k].launches for k in kernels if k not in want):
            now = {k: v.launches for k, v in kernels.items()}
            raise AssertionError(f"moe continuous {label}: launches {now} "
                                 f"!= {want} (dense 0)")
        if not sched.base_be.coupled:
            raise AssertionError("moe continuous: the base's batched "
                                 "engine does not carry every slot")
        for i, h in enumerate(report.handles):
            res = h.result
            n_out = res.n_thinking_tokens + len(res.answer_ids)
            print(f"[main] moe continuous {label} req{i}: latency "
                  f"{h.e2e_latency * 1e3:.1f} ms, TTFT {h.ttft * 1e3:.1f} ms,"
                  f" TPOT {h.tpot(n_out) * 1e3:.2f} ms, {n_out} tokens"
                  + (f", spec {res.spec_stats.accepted}/"
                     f"{res.spec_stats.proposed}" if res.spec_stats.rounds
                     else ""), flush=True)
        n, frac = drops.read()
        print(f"[main] moe continuous {label}: {st['tok_s']} tok/s, "
              f"{st['req_s']} req/s, wall {st['wall_s']} s, ticks "
              f"{st['ticks']}, TTFT p50 {st.get('p50_ttft_s')} s, TPOT p50 "
              f"{st.get('p50_tpot_s')} s; cache {sched.cache_stats()['base']}"
              f"; launches paged decode {got['paged_decode_attention']}, "
              f"paged append {got['paged_append_attention']} == n_layers x "
              f"metered steps/extends, dense 0; {n} routings, mean dropped "
              f"fraction {frac:.4g}; KV store bytes {st['kv_store_bytes']} "
              f"(the base's includes {sched.base_be.batch} shadow pages)",
              flush=True)
        for k in want:
            launches[k] += got[k]
        reports[label] = report
    drops.remove()

    def req0():
        return serve.run_scheme("specreason", base, small, reqs[0],
                                torch.Generator(device="cuda").manual_seed(0),
                                MOE_BUDGET, MOE_THRESHOLD, 0.0)
    p = profile_request(torch, req0, kernels["decode_attention"])
    seen, dev_ms = traced(p["rows"], "decode_kernel")
    gate(p, seen, "moe greedy req0", "decode_kernel")
    n_out = len(p["res"].thinking_ids + p["res"].answer_ids)
    print(f"[profile] moe greedy req0 (fused, {n_out} tokens): "
          f"{p['window']}; decode_kernel {seen} launches traced == "
          f"{p['counted']} counted, {dev_ms:.1f} ms; {p['top']}",
          flush=True)
    cont = [r.thinking_ids + r.answer_ids for *_, r in
            reports["greedy"].runs][:3]
    same = sum(a == b for a, b in zip(cont, outputs))
    print(f"[main] moe (information): continuous greedy tokens equal the "
          f"sequential greedy tokens for {same} of 3 requests (a call's "
          "rows share expert capacity, so a drop may differ between the "
          "two paths)", flush=True)
    lap("main path, moe continuous")

    # 2 of the layers: one 4-row extend and one training step, card vs CPU
    two = dataclasses.replace(cfg, n_layers=2)
    m2 = Model(two)
    p2 = tree_map(lambda t: t.contiguous(), {
        k: (tree_map(lambda t: t[:2], v) if k == "layers" else v)
        for k, v in base.params.items()})
    lens, bucket = [40, 23, 64, 7], 64
    g = torch.Generator().manual_seed(9)
    prompts = [torch.randint(0, two.vocab_size, (n,), generator=g).tolist()
               for n in lens]
    out = {}
    for dev in ("cuda", "cpu"):
        params = p2 if dev == "cuda" else tree_map(lambda t: t.cpu(), p2)
        be = BatchEngine(m2, params, batch=4, capacity=256, fused=False)
        rows = [be.alloc_row() for _ in lens]
        with torch.no_grad():
            logits, recs = moe_routing(torch, moe, lambda: be.extend_rows(
                rows, prompts, want_logits=True))
        out[dev] = ([lg.float().cpu() for lg in logits], recs)
    (lc, rc), (lp, rp) = out["cuda"], out["cpu"]
    margin = min(r[2].min().item() for r in rc)
    bad = torch.zeros(4, bucket, dtype=torch.int32)
    flips = 0
    for (ec, kc, _), (ep, kp, _) in zip(rc, rp):
        # (G, S, k) over the call's 4 x bucket tokens, batch-major
        diff = (ec != ep) | (kc != kp)
        flips += int(diff.sum())
        bad |= diff.any(-1).reshape(4, bucket).int()
    # a token whose row differs in routing at or before it may differ
    agree = bad.cummax(dim=1)[0] == 0
    worst = 0.0
    held = 0
    for i, n in enumerate(lens):
        ok = agree[i, :n]
        if ok.any():
            a, b_ = lc[i][ok], lp[i][ok]
            worst = max(worst, (a - b_).abs().max().item())
            held += int(ok.sum())
            if not torch.allclose(a, b_, atol=LOGIT_TOL, rtol=LOGIT_TOL):
                raise AssertionError(
                    f"moe extend row {i}: card vs CPU logits differ by "
                    f"{(a - b_).abs().max().item()} where routing agrees")
    print(f"[main] moe extend (2 of {cfg.n_layers} layers, 4 rows of "
          f"{lens} in one {bucket}-token bucket, every slot): smallest top-"
          f"{two.top_k} margin on the card {margin:.3g}; {flips} routing "
          f"choices differ card vs CPU; logits at the {held} of {sum(lens)} "
          f"tokens whose rows agree in routing up to them within "
          f"{LOGIT_TOL}: max |diff| {worst:.3g}", flush=True)

    inp, tgt, wgt = next(pipeline.batch_iterator(
        pipeline.BatchSpec(2, 64), 0, "mixed"))
    res = {}
    for dev in ("cuda", "cpu"):
        pv = {k: t.to(dev, copy=True).requires_grad_()
              for k, t in flatten(p2).items()}
        loss, met = tloss.loss_fn(m2, unflatten(pv), {
            "tokens": torch.from_numpy(inp).to(dev),
            "targets": torch.from_numpy(tgt).to(dev),
            "weights": torch.from_numpy(wgt).to(dev)})
        grads = torch.autograd.grad(loss, list(pv.values()))
        res[dev] = (loss.detach().cpu(), {k: v.detach().cpu() for k, v in
                                          met.items()},
                    {k: gr.cpu() for k, gr in zip(pv, grads)})
    worst, where = 0.0, ""
    for name, cpu in [("loss", res["cpu"][0])] + list(res["cpu"][2].items()):
        card = res["cuda"][0] if name == "loss" else res["cuda"][2][name]
        top = max(cpu.abs().max().item(), 1e-30)
        rel = (card - cpu).abs().max().item() / top
        if rel > MOE_GRAD_TOL:
            raise AssertionError(f"moe train {name}: card vs CPU |diff| / "
                                 f"max {rel} (> {MOE_GRAD_TOL})")
        if rel >= worst:
            worst, where = rel, name
    print(f"[main] moe train (2 of {cfg.n_layers} layers, 2 x 64 tokens, "
          f"remat): loss {res['cuda'][0].item():.6f} card / "
          f"{res['cpu'][0].item():.6f} CPU, aux "
          f"{ {k: round(v.item(), 6) for k, v in res['cuda'][1].items() if k.startswith('aux')} }"
          f"; the loss and all {len(res['cpu'][2])} gradients within "
          f"{MOE_GRAD_TOL} of each one's largest magnitude (worst "
          f"{worst:.3g}, {where})", flush=True)
    return launches, base


def fused_moe_phase(torch, Model, registry, Engine, SamplingParams, base,
                    decode_kernel):
    """The granite base alone at its published vocabulary (49155; the
    same 24 layers, tied embeddings drawn on the card from a seed),
    decode-only (``decode_turns``: a 64-token prompt, DECODE_TOKENS
    tokens greedy and at 0.6, two fused turns, the second without a
    capture; flash-decode launches == n_layers x decode steps; ``[main]
    moe`` holds the fused loop to the per-token one); then its tok/s and
    ms a token against two byte bounds: every expert's weights, which the reference's
    formulation reads for one token (32 experts x 8 capacity slots), and
    a top-8 read of 8 experts a layer, as information."""
    from repro_torch.models.model import flatten
    full, params = published_vocab(torch, Model, registry, MOE_ARCH,
                                   base.params)
    eng = Engine(full, params, name=MOE_ARCH)
    cfg = full.cfg
    prompt = torch.randint(0, cfg.vocab_size, (64,),
                           generator=torch.Generator().manual_seed(4)).tolist()
    tag = f"{MOE_ARCH} vocab {cfg.vocab_size}"
    decode_turns(torch, eng, SamplingParams, "[fused moe]", tag,
                 lambda: eng.extend(eng.new_session(), prompt),
                 ("fused", "fused"), counter=decode_kernel,
                 kernel="decode_kernel")
    s = eng.extend(eng.new_session(), prompt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, _, _ = eng.generate(s, DECODE_TOKENS, [], SamplingParams(),
                             torch.Generator(device="cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d, ff, e, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    per_layer = {n: t[0].numel()
                 for n, t in flatten(params["layers"]).items()}
    expert = 3 * d * ff
    dense = sum(per_layer.values()) - e * expert
    embed = params["tok_embed"].numel()
    cache = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.resolved_head_dim * (
        len(prompt) + DECODE_TOKENS // 2)
    every = 4 * (cfg.n_layers * (dense + e * expert) + embed + cache)
    top = 4 * (cfg.n_layers * (dense + k * expert) + embed + cache)
    ms_tok = wall / len(ids) * 1e3
    every_ms = every / HBM_BYTES_PER_S * 1e3
    top_ms = top / HBM_BYTES_PER_S * 1e3
    print(f"[fused moe] {tag}: {len(ids)} greedy tokens fused in "
          f"{wall:.4f} s, {len(ids) / wall:.1f} tok/s, {ms_tok:.3f} ms a "
          f"token; byte bound of the formulation's read (every expert's "
          f"weights, {every / 1e9:.3f} GB a token) {every_ms:.3f} ms "
          f"({every_ms / ms_tok:.1%} of it reached); of a top-{k} read "
          f"(information: {top / 1e9:.3f} GB) {top_ms:.3f} ms", flush=True)


def paged_window_main_phase(torch, loader, Model, Engine, BatchEngine,
                            SamplingParams, kernels):
    """starcoder2-7b at WINDOW_DEPTH layers of its published widths
    (random init, vocabulary 64) on the continuous path's engine with
    capacity PAGED_WINDOW_CACHE: 2 rows commit prompts of
    PAGED_WINDOW_PROMPTS tokens by chunked prefill (``prefill_rows``,
    256-token chunks through #4), then PAGED_WINDOW_DECODE greedy tokens
    through #3 on the fused rows loop, so the window of 4096 masks keys
    in both kernels; #3 and #4 == n_layers x the metered steps and
    extends, no dense launch.  The sequential ``Engine`` (#2 and #1 with
    the window) gives the same tokens from the same chunks.  Then row 0
    again on a fresh engine, its last logits after the prefill and after
    feeding decode tokens 1 and PAGED_WINDOW_DECODE (``feed_rows``:
    #3), against the same engine's on the CPU (LOGIT_TOL).  Returns the
    launches."""
    import dataclasses
    t0 = time.perf_counter()
    arch = "starcoder2-7b"
    cfg = dataclasses.replace(loader.arch_config(arch),
                              n_layers=WINDOW_DEPTH)
    model = Model(cfg)
    params = model.init(4, device="cuda")
    g = torch.Generator().manual_seed(8)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in PAGED_WINDOW_PROMPTS]
    chunk = 256

    def rows_run(dev_params):
        be = BatchEngine(model, dev_params, batch=len(prompts),
                         capacity=PAGED_WINDOW_CACHE)
        rows = [be.alloc_row() for _ in prompts]
        for lo in range(0, max(PAGED_WINDOW_PROMPTS), chunk):
            part = [(r, p[lo:lo + chunk]) for r, p in zip(rows, prompts)
                    if lo < len(p)]
            be.prefill_rows([r for r, _ in part], [c for _, c in part],
                            [lo] * len(part))
        return be, rows

    for k in kernels.values():
        k.launches = 0
    be, rows = rows_run(params)
    with torch.no_grad():
        outs = be.generate_rows(rows, PAGED_WINDOW_DECODE, [],
                                SamplingParams(),
                                [torch.Generator(device="cuda")
                                 for _ in rows])
    torch.cuda.synchronize()
    n = cfg.n_layers
    want = {"paged_append_attention": n * be.meter.prefill_calls,
            "paged_decode_attention": n * be.meter.decode_steps}
    got = {k: kernels[k].launches for k in want}
    if got != want or any(kernels[k].launches for k in kernels
                          if k not in want):
        raise AssertionError(f"paged window: launches "
                             f"{ {k: v.launches for k, v in kernels.items()} }"
                             f" != {want} (others 0)")
    launches = dict(got)
    del be
    eng = Engine(model, params, max_len=PAGED_WINDOW_CACHE, name=arch)
    seq = []
    for k in kernels.values():
        k.launches = 0
    for p in prompts:
        s = eng.new_session()
        for lo in range(0, len(p), chunk):
            s = eng.extend(s, p[lo:lo + chunk])
        ids, _, _ = eng.generate(s, PAGED_WINDOW_DECODE, [],
                                 SamplingParams(),
                                 torch.Generator(device="cuda"))
        seq.append(ids)
        del s
    torch.cuda.synchronize()
    dense = {k: kernels[k].launches for k in ("flash_attention",
                                              "decode_attention")}
    if seq != outs:
        same = [a == b for a, b in zip(seq, outs)]
        raise AssertionError(f"paged window: continuous tokens differ from "
                             f"the sequential Engine's (rows equal: {same})")
    for name, v in dense.items():
        launches[name] = v
    del eng

    # row 0 card vs CPU: logits after the prefill and decodes 1 and N
    toks = outs[0]
    out, cpu_s = {}, 0.0
    for dev in ("cuda", "cpu"):
        t1 = time.perf_counter()
        p = params if dev == "cuda" else tree_map(lambda t: t.cpu(), params)
        be = BatchEngine(model, p, batch=1, capacity=PAGED_WINDOW_CACHE,
                         fused=False)
        r = be.alloc_row()
        with torch.no_grad():
            for lo in range(0, len(prompts[0]), chunk):
                be.prefill_rows([r], [prompts[0][lo:lo + chunk]], [lo])
            got_rows = [be.last_logits[r].clone()]
            for i, tok in enumerate(toks, 1):
                be.feed_rows([r], [tok])
                if i in (1, len(toks)):
                    got_rows.append(be.last_logits[r].clone())
        out[dev] = torch.stack(got_rows).float().cpu()
        cpu_s = time.perf_counter() - t1
    note = logits_close(torch, f"{arch} paged window", out)
    last = len(prompts[0]) + len(toks) - 1
    print(f"[main] paged window: {arch} at {n} of 32 layers (published "
          f"widths, window {cfg.sliding_window}, capacity "
          f"{PAGED_WINDOW_CACHE}): 2 rows prefill {PAGED_WINDOW_PROMPTS} "
          f"tokens in {chunk}-token chunks through #4, then "
          f"{PAGED_WINDOW_DECODE} greedy tokens through #3 on the fused rows "
          f"loop; row 0's last query (position {last}) masks the "
          f"{last + 1 - cfg.sliding_window} oldest keys; launches "
          f"{got} == {n} x the metered calls; the sequential Engine (#2, "
          f"#1 with the window: {dense}) gives the same tokens for both "
          f"rows; row 0 card vs CPU logits after the prefill and decodes 1 "
          f"and {len(toks)}: {note} (tolerance {LOGIT_TOL}); CPU "
          f"{cpu_s:.1f} s, {time.perf_counter() - t0:.1f} s in all",
          flush=True)
    return launches


def cross_main_phase(torch, serve, tasks, loader, Model, Engine, registry,
                     SamplingParams, kernels, arch):
    """``[main] encdec`` (whisper-base) or ``[main] vlm``
    (llama-3.2-vision-11b): SpecReason with ``arch``'s base at its
    published widths and depth, drawn on the card from a seed one layer
    a draw (``draw_params``; 37.7 GiB of fp32 weights for the vlm), the
    vocabulary cut to 64, and the testbed SMALL drafter.  The vlm gates
    start at zero in the port's init (tanh(0) = 0 hides every cross
    layer), so they are drawn here in [0.4, 1.2) from a seed.  Every base
    session attends to the stub source (``loader.stub_source``: 1500
    frame embeddings, which it encodes, or 1601
    patch embeddings).  3 requests greedy and at 0.6, then greedy req0
    and sampled req0 on the per-token loop, whose tokens must equal the
    fused turn's.  Per run, #2 must launch n_encoder_layers x the base's
    encodes + (self + cross layers) x its metered extends + SMALL's
    layers x its prefill calls, #1 (self + cross layers) x the base's
    metered decode steps + SMALL's layers x its steps (masked and
    warm-up steps included), no other kernel; after every request each
    engine has captured once per loop key, and the base's keys share one
    pooled K/V pair and one pooled cross pair.  Greedy req0 profiled
    (the profiler's flash-decode count == the counter).  Then card
    logits against the CPU's (LOGIT_TOL) over a CROSS_PREFILL-token
    prompt and CROSS_DECODE greedy decodes: whisper-base at its full
    depth, the vlm at one group (4 self layers and its cross layer) of
    the same parameters.  Then the base alone at its published
    vocabulary, decode-only (``decode_turns``, two fused turns), and its
    ms a token against the byte bound of its decoder's weights, the
    K/V it reads and the cross K/V.  Prints the phase's peak memory.
    Returns the launches."""
    import dataclasses
    from repro_torch.models.model import flatten
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = loader.arch_config(arch)
    family, published = cfg.family, registry.get(arch).vocab_size
    model = Model(cfg)
    params = draw_params(torch, model, 0, None)
    if family == "vlm":
        gen = torch.Generator(device="cuda").manual_seed(8)
        for name in ("gate_attn", "gate_mlp"):
            params["cross_layers"][name] = torch.rand(
                params["cross_layers"][name].shape, generator=gen,
                device="cuda") * 0.8 + 0.4
    src = loader.stub_source(cfg).cuda()
    base = loader.attach_cross_source(Engine(model, params, name=arch),
                                      src=src)
    small = loader.random_engine("testbed-small", "cuda", seed=1)
    torch.cuda.synchronize()
    n_self, n_cross, n_enc = (cfg.n_self_layers, cfg.n_cross_layers,
                              cfg.n_encoder_layers)
    n_attn = n_self + n_cross
    shape = (f"{cfg.n_layers} decoder layers and {n_enc} encoder layers"
             if family == "encdec" else
             f"{cfg.n_layers} layers ({n_cross} groups of {n_self // n_cross}"
             f" self layers and a gated cross layer; gates drawn in "
             f"[0.4, 1.2))")
    print(f"[main] {family}: {arch} base, {shape}, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, {cfg.act}, "
          f"{cfg.norm_type}, vocab {cfg.vocab_size} (cut from {published}), "
          f"{sum(t.numel() for t in leaves(params))} parameters (fp32), "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s; stub "
          f"source {src.shape[1]} x {cfg.d_model}; testbed SMALL drafter; "
          f"threshold {CROSS_THRESHOLD}; decode loops "
          f"{loader.decode_loops(base, small)}", flush=True)
    rng = random.Random(0)
    reqs = [tasks.sample_task(rng) for _ in range(3)]
    ns = small.model.cfg.n_layers
    enc = f"{n_enc} x encodes + " if n_enc else ""
    results, launches = sequential_turns(
        torch, serve, base, small, reqs, kernels, family,
        lambda mb, ms_, encodes: {
            "flash_attention": n_enc * encodes + n_attn * mb["prefill_calls"]
            + ns * ms_["prefill_calls"],
            "decode_attention": n_attn * mb["decode_steps"]
            + ns * ms_["decode_steps"]},
        f"flash == {enc}({n_self} self + {n_cross} cross) x base extends + "
        f"{ns} x SMALL's prefill calls; decode == ({n_self} self + "
        f"{n_cross} cross) x base decode steps + {ns} x SMALL's",
        CROSS_THRESHOLD)
    wall = results["greedy"][0].wall_time
    keys = list(base._loops)
    pool = base._kv_pool[(1, base.max_len, src.shape[1])]
    st = pool[0][0]
    if len(pool) != 1 or {k[:2] for k in keys} != {
            (st.k.data_ptr(), st.v.data_ptr())} or {k[-3:] for k in keys} \
            != {(st.cross_k.data_ptr(), st.cross_v.data_ptr(),
                 st.cross_len.data_ptr())}:
        raise AssertionError(f"{family}: the base's loop keys do not share "
                             "one pooled K/V pair and cross pair")
    print(f"[main] {family}: the base's {len(keys)} loop keys share one "
          f"pooled K/V pair and one pooled cross pair "
          f"({mib(2 * st.cross_k.numel() * 4)})", flush=True)

    def run():
        gen = torch.Generator(device="cuda").manual_seed(0)
        return serve.run_scheme("specreason", base, small, reqs[0], gen,
                                128, CROSS_THRESHOLD, 0.0)
    p = profile_request(torch, run, kernels["decode_attention"], wall)
    n_out = len(p["res"].thinking_ids + p["res"].answer_ids)
    seen, dev_ms = traced(p["rows"], "decode_kernel")
    gate(p, seen, f"{family} greedy req0", "decode_kernel")
    fl_seen, fl_ms = traced(p["rows"], "flash_kernel")
    print(f"[profile] {family} greedy req0 (fused, {n_out} tokens, "
          f"{wall * 1e3:.1f} ms and {n_out / wall:.1f} tok/s "
          f"unprofiled): "
          f"{p['window']}; decode_kernel {seen} launches traced == "
          f"{p['counted']} counted, {dev_ms:.1f} ms; flash_kernel "
          f"{fl_seen} launches, {fl_ms:.1f} ms; {p['top']}", flush=True)
    del p

    # card against CPU: whisper at full depth, the vlm at one group
    t1 = time.perf_counter()
    if family == "vlm":
        ccfg = dataclasses.replace(cfg, n_layers=cfg.cross_attn_every)
        cparams = dict(params)
        for sub in ("layers", "cross_layers"):
            cparams[sub] = tree_map(lambda t: t[:1], params[sub])
        depth = f"one group ({ccfg.n_self_layers} self layers and its " \
            "cross layer)"
    else:
        ccfg, cparams, depth = cfg, params, "full depth"
    cmodel = Model(ccfg)
    ceng = Engine(cmodel, cparams, name=arch)
    prompt = torch.randint(0, cfg.vocab_size, (CROSS_PREFILL,),
                           generator=torch.Generator().manual_seed(7)
                           ).tolist()
    s = ceng.extend(ceng.new_session(cross_src=src), prompt)
    ids, _, _ = ceng.generate(s, CROSS_DECODE, [], SamplingParams(),
                              torch.Generator(device="cuda"))
    del s, ceng
    logits, cpu_s = card_and_cpu_logits(
        torch, Engine, cmodel, cparams, prompt, ids, CACHE,
        range(1, CROSS_DECODE + 1), src=src)
    note = logits_close(torch, f"{arch} {depth}", logits)
    picks = logits["cuda"][:-1].argmax(-1).tolist()
    if picks != ids:
        raise AssertionError(f"{arch}: the card's greedy picks {picks} "
                             f"differ from the fused loop's tokens {ids}")
    print(f"[main] {family} check at {depth}: prefill {CROSS_PREFILL}, "
          f"{CROSS_DECODE} tokens fused == the card's greedy picks; card vs "
          f"CPU logits over the prefill's last position and "
          f"{CROSS_DECODE} decodes: {note} (tolerance {LOGIT_TOL}); CPU "
          f"{cpu_s:.1f} s, {time.perf_counter() - t1:.1f} s in all",
          flush=True)
    del logits, cparams

    # the base alone at its published vocabulary, decode-only
    full, fparams = published_vocab(torch, Model, registry, arch, params)
    fcfg = full.cfg
    eng = loader.attach_cross_source(Engine(full, fparams, name=arch),
                                     src=src)
    prompt = torch.randint(0, fcfg.vocab_size, (64,),
                           generator=torch.Generator().manual_seed(4)).tolist()
    tag = f"{arch} vocab {fcfg.vocab_size}"
    decode_turns(torch, eng, SamplingParams, f"[fused {family}]", tag,
                 lambda: eng.extend(eng.new_session(), prompt),
                 ("fused", "fused"), counter=kernels["decode_attention"],
                 kernel="decode_kernel")
    s = eng.extend(eng.new_session(), prompt)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ids, _, _ = eng.generate(s, DECODE_TOKENS, [], SamplingParams(),
                             torch.Generator(device="cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t2
    del s
    # a token reads every decoder weight but the embedding table (one
    # row of it), its self K/V and the cross K/V
    weights = sum(t.numel() for k, t in flatten(fparams).items()
                  if k != "tok_embed" and not k.startswith("encoder/")) \
        + fcfg.d_model
    kv = 2 * n_self * fcfg.n_kv_heads * fcfg.resolved_head_dim * (
        len(prompt) + DECODE_TOKENS // 2)
    cross = 2 * n_cross * src.shape[1] * fcfg.n_kv_heads * \
        fcfg.resolved_head_dim
    nbytes = 4 * (weights + kv + cross)
    ms_tok = wall / len(ids) * 1e3
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[fused {family}] {tag}: {len(ids)} greedy tokens fused in "
          f"{wall:.4f} s, {len(ids) / wall:.1f} tok/s, {ms_tok:.3f} ms a "
          f"token; byte bound {bound_ms:.3f} ms ({nbytes / 1e9:.3f} GB a "
          f"token: weights {4 * weights / 1e9:.3f} GB, self K/V "
          f"{4 * kv / 1e6:.1f} MB, cross K/V {4 * cross / 1e6:.1f} MB; "
          f"{bound_ms / ms_tok:.1%} of it reached); peak memory "
          f"{mib(torch.cuda.max_memory_allocated())}; "
          f"{time.perf_counter() - t0:.1f} s in all", flush=True)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.nn.functional as F

    from repro_torch.checkpoint.checkpoint import load_checkpoint
    from repro_torch.configs import granite_moe_1b, hymba_1_5b, \
        llama_3_2_vision_11b, mamba2_1_3b, minitron_4b, registry, \
        starcoder2_7b, testbed, whisper_base
    from repro_torch.data import tasks
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
    from repro_torch.kernels.paged_append_attention import \
        paged_append_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import serve
    from repro_torch.models import mamba2
    from repro_torch.models.model import Model
    from repro_torch.sampling.sample import SamplingParams
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import loader
    from repro_torch.serving.batch_engine import BatchEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    marks = [t_start]

    def lap(phase):
        """A [smoke] line with the phase's seconds and the total so far."""
        now = time.perf_counter()
        print(f"[smoke] {phase}: {now - marks[0]:.1f} s, "
              f"{now - t_start:.1f} s in all", flush=True)
        marks[0] = now
    card = nvidia_smi()
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)",
          flush=True)

    t0 = time.perf_counter()
    reports = build.build()
    for name, text in reports.items():
        print(f"[build] {name}: " + "; ".join(
            f"{v} {regs} registers, {smem} bytes static shared memory, "
            f"{spill} bytes spilled" for v, regs, smem, spill
            in ptxas_variants(text)), flush=True)
    print(f"[build] {len(reports)} sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    lap("build")

    records = kernel_phase(torch, F, ref, decode_attention, flash_attention,
                           minitron_4b.CONFIG, whisper_base.CONFIG,
                           llama_3_2_vision_11b.CONFIG)
    records["decode_attention"] += window_kernel_phase(
        torch, F, ref, decode_attention, hymba_1_5b.CONFIG,
        starcoder2_7b.CONFIG)
    records["flash_attention_bwd"] = bwd_kernel_phase(
        torch, F, ref, flash_attention, flash_attention_bwd,
        minitron_4b.CONFIG)
    records.update(paged_kernel_phase(torch, F, ref, paged_decode_attention,
                                      paged_append_attention,
                                      minitron_4b.CONFIG))
    for name, recs in paged_window_kernel_phase(
            torch, F, ref, paged_decode_attention, paged_append_attention,
            starcoder2_7b.CONFIG, granite_moe_1b.CONFIG).items():
        records[name] += recs
    records.update(paged_tp_kernel_phase(torch, F, ref, minitron_4b.CONFIG))
    records.update(ssd_kernel_phase(torch, ref, mamba2, ssd_scan,
                                    mamba2_1_3b.CONFIG, hymba_1_5b.CONFIG))
    lap("kernels")

    ckpt = os.path.join(ROOT, "build", "smoke_ckpt")
    loader.save_random_testbed(ckpt, seed=0)
    paged_decode_attention.launches = paged_append_attention.launches = 0
    ssd_scan.launches = 0
    launches, greedy = main_path_phase(torch, serve, decode_attention,
                                       flash_attention, ckpt)
    if paged_decode_attention.launches or paged_append_attention.launches \
            or ssd_scan.launches:
        raise AssertionError("the sequential path launched a paged kernel "
                             "or the SSD scan")
    lap("main path, sequential")
    base, small = loader.load_testbed_engines(ckpt, "cuda")
    fused_phase(torch, serve, tasks, decode_attention, base,
                small, "testbed", THRESHOLD)
    del base, small
    lap("fused, testbed")
    kernels = {"decode_attention": decode_attention,
               "flash_attention": flash_attention,
               "flash_attention_bwd": flash_attention_bwd,
               "paged_decode_attention": paged_decode_attention,
               "paged_append_attention": paged_append_attention,
               "ssd_scan": ssd_scan}
    prefix = fused_dense_phase(torch, serve, tasks, loader, registry,
                               Model, engine_mod.Engine, BatchEngine,
                               SamplingParams, kernels, lap)
    torch.cuda.empty_cache()
    launches.update(tp_phase(torch, lap))
    tp_cli_check(serve, ckpt)
    lap("main path, tp cli")
    check_phase(torch, Model, load_checkpoint, testbed, serve, tasks, loader,
                greedy, ckpt)
    rows_check_phase(torch, Model, BatchEngine, testbed, load_checkpoint,
                     loader, ckpt)
    lap("check")
    dense_rows_check_phase(torch, Model, BatchEngine, loader, kernels,
                           minitron_4b.CONFIG)
    lap(f"check, {DENSE_ARCH} rows")
    paged, cont_greedy = continuous_phase(torch, serve, kernels, ckpt)
    launches.update(paged)
    for name, n in prefix.items():
        launches[name] += n
    batch_invariance_phase(torch, serve, tasks, Model, load_checkpoint,
                           testbed, loader, ckpt, cont_greedy)
    lap("main path, continuous")
    base, small = loader.load_testbed_engines(ckpt, "cuda")
    rows_phase(torch, serve, tasks, paged_decode_attention, base, small,
               "testbed", (("greedy", 0.0, False), ("sampled", 0.6, False),
                           ("spec sampled", 0.6, True)), 64)
    del base, small
    lap("fused rows, testbed")
    ssm_launches, ssm_base = ssm_main_phase(torch, serve, tasks, loader,
                                            kernels)
    launches["ssd_scan"] = ssm_launches["ssd_scan"]
    lap("main path, ssm")
    fused_ssm_phase(torch, Model, registry, engine_mod.Engine,
                    SamplingParams, ssm_base, lap)
    ssm_check_phase(torch, ssm_base)
    lap("check, ssm")
    del ssm_base
    torch.cuda.empty_cache()
    hybrid_launches, hybrid_base = hybrid_main_phase(torch, serve, tasks,
                                                     loader, kernels)
    del hybrid_base
    torch.cuda.empty_cache()
    lap("main path, hybrid")
    window_launches = window_main_phase(torch, loader, Model,
                                        engine_mod.Engine, SamplingParams,
                                        kernels)
    for launched in (hybrid_launches, window_launches):
        for name, n in launched.items():
            launches[name] = launches.get(name, 0) + n
    lap("main path, window")
    for name, n in paged_window_main_phase(
            torch, loader, Model, engine_mod.Engine, BatchEngine,
            SamplingParams, kernels).items():
        launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    lap("main path, paged window")
    moe_launches, moe_base = moe_main_phase(torch, serve, tasks, loader,
                                            kernels, Model, BatchEngine, lap)
    for name, n in moe_launches.items():
        launches[name] = launches.get(name, 0) + n
    lap("check, moe")
    fused_moe_phase(torch, Model, registry, engine_mod.Engine,
                    SamplingParams, moe_base, decode_attention)
    del moe_base
    torch.cuda.empty_cache()
    lap("fused moe")
    for arch in ARCH_CHECKS:
        arch_check_phase(torch, loader, Model, engine_mod.Engine,
                         SamplingParams, arch, kernels)
        torch.cuda.empty_cache()
        lap(f"check, {arch}")
    for arch in CROSS_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        for name, n in cross_main_phase(
                torch, serve, tasks, loader, Model, engine_mod.Engine,
                registry, SamplingParams, kernels, arch).items():
            launches[name] = launches.get(name, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
        lap(f"main path, {registry.get(arch).family}")
    launches["flash_attention_bwd"] = train_phase(
        torch, kernels)["flash_attention_bwd"]
    lap("train")

    # one record per kernel at a representative serving-path shape (BASE
    # heads, fp32): decode at 128 cached tokens, a 16-token extend at 100;
    # a paged decode step of 4 ragged rows, a 16-token paged extend; a
    # 37-token mamba2-1.3b extend (one chunk); the attention backward at
    # BASE's training shape; paged_tp at a rank's share of minitron-4b's
    # heads (the [main] tp launches summed over the ranks)
    rep = {"decode_attention": "base float32 B=1 cache=1024 lengths=[128]",
           "flash_attention": "base float32 S=16 q_offset=100 kv=1024 "
                              "causal=True window=0",
           "paged_decode_attention": "base float32 B=4 "
                                     "lengths=[0, 1, 77, 640]",
           "paged_append_attention": "base float32 T=16 B=2 ctx=[1, 100] "
                                     "span=[16, 11]",
           "ssd_scan": "mamba2 float32 B=1 L=37 H=64 P=64 G=1 N=128 "
                       "chunk=37",
           "flash_attention_bwd": "base float32 B=16 S=112 H=8 K=4 hd=28",
           "tp_paged_decode_attention":
               f"minitron-tp{TP_SIZE} float32 B=8 over 4096, 12 over 4",
           "tp_paged_append_attention":
               f"minitron-tp{TP_SIZE} float32 T=64 B=8 ctx=4032, 12 over 4"}
    sources = {"decode_attention": "src/repro/kernels/decode_attention.py:83",
               "flash_attention": "src/repro/kernels/flash_attention.py:90",
               "paged_decode_attention":
                   "src/repro/kernels/paged_decode_attention.py:89",
               "paged_append_attention":
                   "src/repro/kernels/paged_append_attention.py:118",
               "ssd_scan": "src/repro/kernels/ssd_scan.py:88",
               # no TPU kernel: JAX differentiates XLA attention
               "flash_attention_bwd":
                   "src/repro/kernels/flash_attention.py:90 (its gradient)",
               # shard_map over #3 and #4: a rank's launch of either
               "tp_paged_decode_attention": "src/repro/kernels/paged_tp.py:49",
               "tp_paged_append_attention":
                   "src/repro/kernels/paged_tp.py:79"}
    kernels_json = []
    for name, recs in records.items():
        r = next(x for x in recs if x["shape"] == rep[name])
        kernels_json.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/paged_tp.py" if name.startswith(
                "tp_") else f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=sources[name], launches=launches[name],
            max_abs_err=max(x["max_abs_err"] for x in recs
                            if x["dtype"] == "float32"),
            max_abs_err_bf16=max((x["max_abs_err"] for x in recs
                                  if x["dtype"] == "bfloat16"),
                                 default=None),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"], shapes=recs))
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels_json}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
