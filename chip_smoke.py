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
   * the SSD scan (the ssm path) at mamba2-1.3b's heads (H 64, P 64,
     N 128, one group) over one ragged chunk (L 7 and 37), one full chunk,
     300 tokens padded to 384 and 2048 tokens, against its plain version
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
4. main path, sequential: random-init BASE/SMALL checkpoints written by
   the port, served by ``repro_torch.launch.serve --scheme specreason``
   on the card through its default fused decode loop (CUDA graphs with
   flash-decode inside), 3 requests, greedy and at temperature 0.6;
   launches of the dense kernels must equal n_layers x the engines'
   metered decode steps (a graph replay counts the launches it ran) and
   prefill calls, and the greedy run must see the verifier both accept
   and reject a drafted step;
   fused: the same 3 requests on one engine pair, greedy and at 0.6, in
   turns fused, eager, eager, fused: identical tokens in every turn,
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
   the profiler's count of the paged-decode kernel == the counter;
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
   preempts; per request latency, TTFT and TPOT, and tokens/s, ticks,
   preemptions and acceptance per run.  Paged-decode launches must equal
   n_layers x the batched engines' decode steps (replayed, masked and
   warm-up steps included), paged-append launches
   n_layers x their extend calls, the dense kernels must not launch, and
   the pressured greedy run must give the unpressured greedy tokens.
   For information, how many requests' continuous greedy tokens equal
   the sequential path's on the card (batch-size-dependent GEMMs may
   move a logit by an ulp).  Then ``[fused rows]`` on the testbed pair:
   the same 8 requests greedy, at 0.6, and at 0.6 with spec decode (gamma
   4), each in turns fused, eager, eager, fused on one scheduler;
7. main path, ssm (per-token decode loop for both models): SpecReason
   with a mamba2-1.3b base at its published
   widths (48 layers, d_model 2048, 64 SSD heads of 64, state 128; random
   init from a seed, vocabulary cut to the toy tokenizer's 64) and the
   testbed SMALL drafter, through ``serve.run_scheme``: 3 requests greedy
   and at temperature 0.6, then one greedy request with hierarchical
   spec decode (gamma 4, the base rolls back by snapshot and replay).
   SSD scan launches must equal 48 x the base's metered extends, the
   dense kernels' SMALL's layers x its metered calls, and the greedy run
   must see the verifier both accept and reject;
8. check, ssm: the base's logits on the card against the same weights on
   the CPU over a 300-token prompt (three chunks, the last padded), a
   resumed 40-token extend and 3 decode steps;
then the card again, one JSON line of per-kernel numbers, and
``{"ok": true, "device": {...}}`` as the last line.  Any failure exits
non-zero before that line; without CUDA, or outside a checkout, it exits
non-zero at once.
"""

import gc
import json
import os
import random
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM, data sheet
# the least time for fp32-accurate products: 3xTF32 on the tensor cores at
# 495 / 3 TFLOP/s (dense TF32, data sheet), above the CUDA cores' 67
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}        # atol = rtol, as the tests
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


def kernel_phase(torch, F, ref, decode_kernel, flash_kernel, minitron):
    """Every kernel against its plain version at the path's shapes.
    Returns per-kernel records for the JSON line."""
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
                              minitron.resolved_head_dim)}
    records = {"decode_attention": [], "flash_attention": []}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def check(name, out, exp, dtype, label):
        err = (out.float() - exp.float()).abs().max().item()
        if not torch.allclose(out.float(), exp.float(), atol=TOL[dtype],
                              rtol=TOL[dtype]):
            raise AssertionError(f"{name} {label}: max |err| {err} beyond "
                                 f"atol = rtol = {TOL[dtype]}")
        return err

    decode_cases = [("base", 1, [128]), ("base", 4, [1, 77, 640, 1024]),
                    ("small", 1, [128]), ("small", 4, [1, 300, 777, 1024]),
                    ("minitron", 8, [4096] * 8),
                    ("minitron-g16", 8, [4096] * 8)]
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
            err = check("decode_attention",
                        decode_kernel(q, kc, vc, lengths),
                        ref.decode_reference(q, kc, vc, lengths), dname,
                        label)
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
                          ("minitron", 256, 1792, 2048, True, 0)]  # a chunk
        for model, s, off, cap, causal, window in prefill_cases:
            h, kh, hd = heads[model]
            q = randn(1, s, h, hd, dtype=dt).permute(0, 2, 1, 3)
            kc = randn(1, cap, kh, hd, dtype=dt).permute(0, 2, 1, 3)
            vc = randn(1, cap, kh, hd, dtype=dt).permute(0, 2, 1, 3)
            label = (f"{model} {dname} S={s} q_offset={off} kv={cap} "
                     f"causal={causal} window={window}")
            args = (causal, off, cap, window)
            err = check("flash_attention", flash_kernel(q, kc, vc, *args),
                        ref.mha_reference(q, kc, vc, *args), dname, label)
            mask = ref.attention_mask(s, cap, causal, off, cap, window,
                                      device=dev)
            ms = time_ms(torch, lambda: flash_kernel(q, kc, vc, *args))
            plain_ms = time_ms(torch, lambda: ref.mha_reference(
                q, kc, vc, *args), reps=5 if s >= 2048 else 30)
            # the yardstick takes its fastest form of the same function
            whole = cap == s and off == 0 and window == 0
            sdpa_mask = None if whole else mask
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


def ssd_device_ms(torch, fn, reps=10):
    """Device ms of one call of fn: torch.profiler's device time of its
    kernels, summed over a run of ``reps`` calls, over reps."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.self_device_time_total > 0) / 1e3 / reps


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


def ssd_kernel_phase(torch, ref, mamba2, ssd_scan, mamba):
    """The SSD scan kernel against its plain version (``ssd_chunked``) and
    the sequential oracle (``ssd_reference``) at mamba2-1.3b's heads and
    the reduced G > 1 shapes; at L = 37 and 2048 also a scan's device time
    and its plan.  Returns its records for the JSON line."""
    from repro_torch.kernels import ssd_scan as ssd_mod
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    h, p, n = mamba.ssm_n_heads, mamba.ssm_head_dim, mamba.ssm_state
    g = mamba.ssm_n_groups
    # (label, B, L, H, P, G, N, chunk, real positions before the pad)
    cases = [("mamba2", 1, 7, h, p, g, n, 7, 7),
             ("mamba2", 1, 37, h, p, g, n, 37, 37),
             ("mamba2", 1, 128, h, p, g, n, 128, 128),
             ("mamba2", 1, 384, h, p, g, n, 128, 300),
             ("mamba2", 1, 2048, h, p, g, n, 128, 2048),
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
            if kind == "mamba2" and l in (37, 2048):
                rec["device_ms"] = ssd_device_ms(
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
    warm-up steps), and that a pressured greedy run gives the unpressured
    greedy tokens.  Returns (paged launches per kernel, greedy
    report)."""
    argv = ["--scheduler", "continuous", "--no-prefix-cache", "-n", "8",
            "--batch", "4", "--budget", "128", "--threshold", str(THRESHOLD),
            "--ckpt-dir", ckpt, "--device", "cuda"]
    runs = [("greedy", ["--temperature", "0"]),
            ("sampled", ["--temperature", "0.6"]),
            ("spec greedy", ["--temperature", "0", "--spec-decode",
                             "--gamma", "4"]),
            ("spec sampled", ["--temperature", "0.6", "--spec-decode",
                              "--gamma", "4"]),
            ("pressured greedy", ["--temperature", "0", "--kv-budget-mb",
                                  str(PRESSURE_MB)])]
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
    spec, plain = tokens(reports["spec greedy"]), tokens(reports["greedy"])
    same = sum(a == b for a, b in zip(spec, plain))
    print(f"[main] continuous (information): spec-decode greedy tokens equal"
          f" plain greedy for {same} of {len(spec)} requests", flush=True)
    return launches, reports["greedy"]


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


def ssm_main_phase(torch, serve, tasks, loader, kernels):
    """SpecReason with the mamba2-1.3b base on the card: 3 requests greedy
    and sampled, one greedy request in hierarchical mode.  The SSD scan
    must launch 48 x the base's metered extends and the dense kernels
    SMALL's layers x its metered calls.  Returns (launches, base
    engine)."""
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
          f"testbed SMALL drafter; threshold {SSM_THRESHOLD}; decode loop "
          "eager for both (the ssm base has no fused loop; the drafter's "
          "stays eager so that the readings compare with earlier runs)",
          flush=True)
    rng = random.Random(0)
    reqs = [tasks.sample_task(rng) for _ in range(3)]
    layers = {"base": cfg.n_layers, "small": small.model.cfg.n_layers}
    launches = dict.fromkeys(kernels, 0)
    outputs = {}
    runs = (("greedy", "specreason", 0.0, 3),
            ("sampled", "specreason", 0.6, 3),
            ("hierarchical greedy", "specreason+decode", 0.0, 1))
    for label, scheme, temp, n_req in runs:
        for k in kernels.values():
            k.launches = 0
        want = {"ssd_scan": 0, "decode_attention": 0, "flash_attention": 0}
        drafted, outputs[label] = [], []
        for i in range(n_req):
            gen = torch.Generator(device="cuda").manual_seed(i)
            res = serve.run_scheme(scheme, base, small, reqs[i], gen, 128,
                                   SSM_THRESHOLD, temp, fused=False)
            mb, ms_ = res.meters["base"], res.meters["small"]
            want["ssd_scan"] += layers["base"] * mb["prefill_calls"]
            want["decode_attention"] += layers["small"] * ms_["decode_steps"]
            want["flash_attention"] += layers["small"] * ms_["prefill_calls"]
            toks = res.thinking_ids + res.answer_ids
            outputs[label].append(toks)
            steps = [s for s in res.steps if s.source == "small"]
            drafted += steps
            n_acc = sum(s.accepted for s in steps)
            utils = [round(s.utility, 4) for s in steps]
            print(f"[main] ssm {label} req{i}: {res.wall_time * 1e3:.1f} ms, "
                  f"{len(toks)} tokens, {len(toks) / res.wall_time:.1f} "
                  f"tok/s, {len(res.steps)} steps ({n_acc} accepted / "
                  f"{len(steps)} drafted; utilities {utils}), base "
                  f"{mb['prefill_calls']} extends / {mb['decode_calls']} "
                  f"decodes" + (f", spec {res.spec_stats.accepted}/"
                                f"{res.spec_stats.proposed} over "
                                f"{res.spec_stats.rounds} rounds"
                                if res.spec_stats.rounds else ""),
                  flush=True)
        got = {k: kernels[k].launches for k in want}
        if got != want or not want["ssd_scan"] or any(
                kernels[k].launches for k in kernels if k not in want):
            now = {k: v.launches for k, v in kernels.items()}
            raise AssertionError(f"ssm {label}: launches {now} != {want} "
                                 "(paged kernels 0)")
        if label == "greedy" and len({s.accepted for s in drafted}) < 2:
            raise AssertionError("ssm greedy run saw only one verifier "
                                 "decision; both paths must run")
        print(f"[main] ssm {label} (decode loop eager): launches ssd_scan "
              f"{got['ssd_scan']} == {layers['base']} x base extends; decode "
              f"{got['decode_attention']}, prefill {got['flash_attention']} =="
              f" {layers['small']} x SMALL's decode steps and prefill calls; "
              "paged 0", flush=True)
        for k in want:
            launches[k] += got[k]
    same = outputs["hierarchical greedy"][0] == outputs["greedy"][0]
    print(f"[main] ssm (information): hierarchical greedy req0 tokens "
          f"{'equal' if same else 'differ from'} plain greedy req0's",
          flush=True)
    ssm_profile(torch, serve, base, small, reqs[2])
    return launches, base


def profile_request(torch, run, counter=None):
    """Information: ``run()`` (one request or call, returning its result)
    run unprofiled and then under torch.profiler, inside one
    ``record_function`` window that ends after a device synchronize.
    Returns a dict: ``res`` the result, ``plain_wall`` the unprofiled
    wall s, ``wall`` the profiled window's wall s (on the trace's clock),
    ``busy`` the union of the device's intervals (kernels, copies, sets)
    inside that window in s, ``idle`` = 1 - busy / wall, ``rows``
    (kernel, device us, count) summed by name (a record of zero length
    counted, its interval not) and ``top`` a note of the zero-length
    records and the largest rows; with a kernel wrapper ``counter``,
    ``counted`` is its launch count's increase over the profiled run."""
    from torch.profiler import ProfilerActivity, profile, record_function
    window = "chip_smoke profiled window"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    before = counter.launches if counter is not None else 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(window):
            res = run()
            torch.cuda.synchronize()
    counted = counter.launches - before if counter is not None else None
    # the raw trace's events: the profiler's own averaging
    # (``key_averages``) of a trace with 10^5 host operator events takes
    # minutes; the window's own range on the device's row is no work
    agg, spans, win, zero = {}, [], None, 0
    for e in prof.profiler.kineto_results.events():
        device = str(e.device_type())
        span = (e.start_ns(), e.start_ns() + e.duration_ns())
        if e.name() == window:
            if device.endswith("CPU"):
                win = span
        elif device.endswith("CUDA"):
            # a record without timestamps (zero length) still counts as
            # a launch of its kernel
            t, n = agg.get(e.name(), (0.0, 0))
            agg[e.name()] = (t + e.duration_ns() / 1e3, n + 1)
            if e.duration_ns() > 0:
                spans.append(span)
            else:
                zero += 1
    if win is None:
        raise AssertionError("[profile] the trace holds no window event")
    lo, hi = win
    busy_ns, cur = 0, lo
    for a, b in sorted(spans):
        a, b = max(a, cur), min(b, hi)
        if b > a:
            busy_ns += b - a
            cur = b
    wall = (hi - lo) / 1e9
    rows = sorted(((k, t, n) for k, (t, n) in agg.items()),
                  key=lambda r: -r[1])
    top = (f"{zero} of {sum(n for *_, n in rows)} device events of zero "
           "length; top device time: "
           + "; ".join(f"{k[:48]} {t / 1e3:.1f} ms x{n}"
                       for k, t, n in rows[:8]))
    return dict(res=res, plain_wall=plain_wall, wall=wall,
                busy=busy_ns / 1e9, idle=1 - busy_ns / 1e9 / wall,
                rows=rows, top=top, counted=counted)


def traced(rows, kernel):
    """(launches, device ms) of the ``__global__`` function ``kernel`` in
    a profile's rows (its template instances summed)."""
    pat = re.compile(r"(?<![\w])" + kernel + r"[<(]")
    hits = [(t, n) for k, t, n in rows if pat.search(k)]
    return sum(n for _, n in hits), sum(t for t, _ in hits) / 1e3


def ssm_profile(torch, serve, base, small, task):
    """Information: one greedy ssm request, device time by kernel and the
    device's idle share (``profile_request``)."""
    def run():
        gen = torch.Generator(device="cuda").manual_seed(2)
        return serve.run_scheme("specreason", base, small, task, gen, 128,
                                SSM_THRESHOLD, 0.0, fused=False)
    p = profile_request(torch, run)
    n_out = len(p["res"].thinking_ids + p["res"].answer_ids)
    print(f"[profile] ssm greedy req2 ({n_out} tokens): wall "
          f"{p['plain_wall']:.4f} s unprofiled ({p['wall']:.4f} s profiled), "
          f"device busy {p['busy']:.4f} s, idle share {p['idle']:.4f} of the "
          f"profiled window; {p['top']}", flush=True)


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
    eager, eager, fused.  Tokens must be identical in all four turns;
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
        first = None
        for turn, loop in enumerate(("fused", "eager", "eager", "fused")):
            paged_kernel.launches = 0
            before = {n: (be.meter.decode_steps, be.meter.decode_tokens,
                          be.meter.decode_time, be.captures,
                          be.capture_time) for n, be in engines.items()}
            n_calls = len(calls)
            handles, wall = run(loop)
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
            if turn == 3 and any(caps.values()):
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
        print(f"[fused rows] {tag} {label}: tokens identical in all four "
              f"turns ({len(first)} requests); "
              + "; ".join(f"{n} {be.captures} captures over "
                          f"{len(be._loops)} keys" for n, be in
                          engines.items())
              + f"; memory: {memory_line(torch, engines, mark)}", flush=True)
        if profile:
            profile = False
            for loop in ("fused", "eager"):
                p = profile_request(torch, lambda: run(loop), paged_kernel)
                handles, _ = p["res"]
                n_out = sum(len(h.result.thinking_ids + h.result.answer_ids)
                            for h in handles)
                seen, dev_ms = traced(p["rows"], "paged_decode_kernel")
                if seen != p["counted"] or not seen:
                    raise AssertionError(
                        f"[profile] {tag} continuous {loop}: the profiler "
                        f"saw {seen} paged_decode_kernel launches, the "
                        f"wrapper counted {p['counted']}; "
                        f"{p['top'][:60]}")
                print(f"[profile] {tag} continuous {label} ({loop}, "
                      f"{ROWS_REQUESTS} requests over 4 rows, {n_out} "
                      f"tokens): wall {p['plain_wall']:.4f} s unprofiled "
                      f"({p['wall']:.4f} s profiled), "
                      f"{n_out / p['plain_wall']:.1f} tok/s, device busy "
                      f"{p['busy']:.4f} s, idle share {p['idle']:.4f} of the "
                      f"profiled window; paged_decode_kernel {seen} "
                      f"launches traced == "
                      f"{p['counted']} counted, {dev_ms:.1f} ms; "
                      f"{p['top']}", flush=True)


def decode_rows_phase(torch, BatchEngine, SamplingParams, paged_kernel,
                      model, params, tag):
    """A decode-only call of the batched engine at ``model``'s vocabulary:
    4 rows at the ragged lengths DECODE_ROWS decode DECODE_TOKENS tokens
    each, greedy and at 0.6 with probabilities collected, in turns fused,
    eager, eager, fused from the same committed context (each turn
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
    for label, temp, probs in (("greedy", 0.0, False),
                               ("sampled", 0.6, True)):
        first = None
        for turn, loop in enumerate(("fused", "eager", "eager", "fused")):
            launches, steps = paged_kernel.launches, be.meter.decode_steps
            caps, syncs = be.captures, be.meter.decode_syncs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, ps = call(loop, temp, probs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            want = cfg.n_layers * (be.meter.decode_steps - steps)
            if paged_kernel.launches - launches != want or \
                    [len(i) for i in ids] != [DECODE_TOKENS] * len(rows):
                raise AssertionError(
                    f"[fused rows] {tag} decode-only {label} {loop}: "
                    f"{[len(i) for i in ids]} tokens, paged decode launches "
                    f"{paged_kernel.launches - launches} != {want}")
            if turn == 3 and be.captures != caps:
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
              f"{label}: tokens identical in all four turns", flush=True)
    print(f"[fused rows] {tag} vocab {cfg.vocab_size} decode-only: "
          f"{check_rows_calls(tag, calls)}; memory: "
          f"{memory_line(torch, {'base': be}, mark)}", flush=True)
    for loop in ("fused", "eager"):
        p = profile_request(torch, lambda: call(loop, 0.0, False),
                            paged_kernel)
        seen, dev_ms = traced(p["rows"], "paged_decode_kernel")
        if seen != p["counted"] or not seen:
            raise AssertionError(f"[profile] {tag} decode-only {loop}: the "
                                 f"profiler saw {seen} paged_decode_kernel "
                                 f"launches, the wrapper counted "
                                 f"{p['counted']}; {p['top'][:60]}")
        n = len(rows) * DECODE_TOKENS
        print(f"[profile] {tag} vocab {cfg.vocab_size} decode-only greedy, "
              f"{len(rows)} rows x {DECODE_TOKENS} tokens ({loop}): wall "
              f"{p['plain_wall']:.4f} s unprofiled ({p['wall']:.4f} s "
              f"profiled), {n / p['plain_wall']:.1f} tok/s, device busy "
              f"{p['busy']:.4f} s, idle share {p['idle']:.4f} of the "
              f"profiled window; paged_decode_kernel {seen} launches traced "
              f"== "
              f"{p['counted']} counted, {dev_ms:.1f} ms; {p['top']}",
              flush=True)


def fused_phase(torch, serve, tasks, decode_kernel, base, small, tag,
                threshold):
    """The dense pair's fused decode loop against its per-token loop on
    the card, on one pair of engines: the main path's 3 specreason
    requests, greedy and at temperature 0.6, in turns fused, eager,
    eager, fused.  Tokens must be identical in every turn; decode launches
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
    for label, temp in (("greedy", 0.0), ("sampled", 0.6)):
        first = None
        for turn, loop in enumerate(("fused", "eager", "eager", "fused")):
            decode_kernel.launches = 0
            caps = {n: e.captures for n, e in engines.items()}
            want, toks, rates, wall = 0, [], [], 0.0
            meter = {n: dict.fromkeys(("decode_tokens", "decode_time",
                                       "prefill_time"), 0)
                     for n in engines}
            for i in range(len(reqs)):
                res = run(temp, loop, i)
                out = res.thinking_ids + res.answer_ids
                toks.append(out)
                rates.append(len(out) / res.wall_time)
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
            if first is None:
                first = toks
            elif toks != first:
                raise AssertionError(f"[fused] {tag} {label}: {loop} turn "
                                     f"{turn} tokens differ from the first "
                                     "turn's")
            new = {n: e.captures - caps[n] for n, e in engines.items()}
            if turn == 3 and any(new.values()):
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
        print(f"[fused] {tag} {label}: tokens identical in all four turns "
              f"({len(first)} requests)", flush=True)
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
        p = profile_request(torch, lambda: run(0.0, loop, 2), decode_kernel)
        n_out = len(p["res"].thinking_ids + p["res"].answer_ids)
        seen, dev_ms = traced(p["rows"], "decode_kernel")
        if seen != p["counted"] or not seen:
            raise AssertionError(f"[profile] {tag} {loop}: the profiler saw "
                                 f"{seen} decode_kernel launches, the "
                                 f"wrapper counted {p['counted']}; "
                                 f"{p['top'][:60]}")
        print(f"[profile] {tag} dense greedy req2 ({loop}, {n_out} tokens): "
              f"wall {p['plain_wall']:.4f} s unprofiled ({p['wall']:.4f} s "
              f"profiled), {n_out / p['plain_wall']:.1f} tok/s, device busy "
              f"{p['busy']:.4f} s, idle share {p['idle']:.4f} of the "
              f"profiled window; decode_kernel {seen} launches traced == "
              f"{p['counted']} counted, {dev_ms:.1f} ms; {p['top']}",
              flush=True)


def fused_dense_phase(torch, serve, tasks, loader, registry,
                      Model, Engine, BatchEngine, SamplingParams,
                      decode_kernel, paged_kernel, lap):
    """The fused loop at a published dense width: minitron-4b (all 32
    layers, random init from a seed, vocabulary cut to the toy
    tokenizer's 64 as the ssm phase's base) with the testbed SMALL
    drafter through ``fused_phase``; then the base alone at its published
    vocabulary (256000; the same layers, embeddings drawn on the card
    from a seed): a 64-token prompt, 128 tokens greedy and 128 sampled at
    0.6 with probabilities collected, in turns fused, eager, eager,
    fused, with identical tokens, probabilities within 2e-5, launches
    == n_layers x decode steps, and the memory the loop holds; then one
    greedy call profiled each way (idle share, device time by kernel,
    the profiler's flash-decode launches against the wrapper's)."""
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

    full = Model(registry.get(DENSE_ARCH))
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = dict(base.params)
    for key, spec in full.spec().items():
        if key in ("tok_embed", "unembed"):     # as the port's init draws
            std = spec.scale / (spec.shape[spec.fan_in_axis] ** 0.5
                                if spec.init == "scaled" else 1.0)
            params[key] = torch.randn(spec.shape, generator=gen,
                                      device="cuda") * std
        elif "/" not in key and params[key].shape != spec.shape:
            raise AssertionError(f"{key}: {params[key].shape} does not "
                                 f"match the spec's {spec.shape}")
    eng = Engine(full, params, name=DENSE_ARCH)
    decode_rows_phase(torch, BatchEngine, SamplingParams, paged_kernel, full,
                      params, DENSE_ARCH)
    lap(f"fused rows, {DENSE_ARCH} decode-only")
    full = full.cfg
    prompt = torch.randint(0, full.vocab_size, (64,),
                           generator=torch.Generator().manual_seed(4)).tolist()
    mark = memory_mark(torch)
    for label, temp, probs in (("greedy", 0.0, False),
                               ("sampled", 0.6, True)):
        first = None
        for turn, loop in enumerate(("fused", "eager", "eager", "fused")):
            session = eng.extend(eng.new_session(), prompt)
            gen = torch.Generator(device="cuda").manual_seed(5)
            launches, steps = decode_kernel.launches, eng.meter.decode_steps
            caps, syncs = eng.captures, eng.meter.decode_syncs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, session, ps = eng.generate(
                session, 128, [], SamplingParams(temperature=temp), gen,
                collect_probs=probs, fused=loop == "fused")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            want = cfg.n_layers * (eng.meter.decode_steps - steps)
            if decode_kernel.launches - launches != want or len(ids) != 128:
                raise AssertionError(
                    f"[fused] {DENSE_ARCH} vocab {full.vocab_size} {label} "
                    f"{loop}: {len(ids)} tokens, decode launches "
                    f"{decode_kernel.launches - launches} != {want}")
            del session         # its KV pair goes back to the pool
            if turn == 3 and eng.captures != caps:
                raise AssertionError(f"[fused] {DENSE_ARCH} vocab "
                                     f"{full.vocab_size} {label}: the second"
                                     " fused turn captured again")
            if first is None:
                first = (ids, ps)
            else:
                err = max((abs(a - b).max() for a, b in zip(ps, first[1])),
                          default=0.0)
                if ids != first[0] or len(ps) != len(first[1]) or err > 2e-5:
                    raise AssertionError(
                        f"[fused] {DENSE_ARCH} vocab {full.vocab_size} "
                        f"{label}: turn {turn} ({loop}) tokens or "
                        f"probabilities differ from the first turn's "
                        f"(probs max |diff| {err})")
            print(f"[fused] {DENSE_ARCH} vocab {full.vocab_size} {label} "
                  f"turn {turn} ({loop}): {len(ids)} tokens in {wall:.4f} s,"
                  f" {len(ids) / wall:.1f} tok/s"
                  + (f", probabilities collected" if probs else "")
                  + f"; captures {eng.captures - caps}, syncs "
                  f"{eng.meter.decode_syncs - syncs}, decode launches {want}"
                  " == n_layers x decode steps", flush=True)
        print(f"[fused] {DENSE_ARCH} vocab {full.vocab_size} {label}: tokens "
              "identical in all four turns", flush=True)
    print(f"[fused] {DENSE_ARCH} vocab {full.vocab_size} memory: "
          f"{memory_line(torch, {'base': eng}, mark)}", flush=True)

    def call(loop):
        gen = torch.Generator(device="cuda").manual_seed(5)
        ids, _, _ = eng.generate(eng.extend(eng.new_session(), prompt), 128,
                                 [], SamplingParams(temperature=0.0), gen,
                                 fused=loop == "fused")
        return ids
    for loop in ("fused", "eager"):
        p = profile_request(torch, lambda: call(loop), decode_kernel)
        seen, dev_ms = traced(p["rows"], "decode_kernel")
        if seen != p["counted"] or not seen:
            raise AssertionError(f"[profile] {DENSE_ARCH} vocab "
                                 f"{full.vocab_size} {loop}: the profiler "
                                 f"saw {seen} decode_kernel launches, the "
                                 f"wrapper counted {p['counted']}; "
                                 f"{p['top'][:60]}")
        print(f"[profile] {DENSE_ARCH} vocab {full.vocab_size} greedy, a "
              f"64-token extend and 128 tokens ({loop}): wall "
              f"{p['plain_wall']:.4f} s unprofiled ({p['wall']:.4f} s "
              f"profiled), device busy {p['busy']:.4f} s, idle share "
              f"{p['idle']:.4f} of the profiled window; decode_kernel {seen} "
              f"launches traced == {p['counted']} counted, {dev_ms:.1f} ms; "
              f"{p['top']}", flush=True)
    lap(f"fused, {DENSE_ARCH} decode-only")


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.nn.functional as F

    from repro_torch.checkpoint.checkpoint import load_checkpoint
    from repro_torch.configs import mamba2_1_3b, minitron_4b, registry, \
        testbed
    from repro_torch.data import tasks
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
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
                           minitron_4b.CONFIG)
    records.update(paged_kernel_phase(torch, F, ref, paged_decode_attention,
                                      paged_append_attention,
                                      minitron_4b.CONFIG))
    records.update(ssd_kernel_phase(torch, ref, mamba2, ssd_scan,
                                    mamba2_1_3b.CONFIG))
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
    fused_dense_phase(torch, serve, tasks, loader, registry,
                      Model, engine_mod.Engine, BatchEngine, SamplingParams,
                      decode_attention, paged_decode_attention, lap)
    torch.cuda.empty_cache()
    check_phase(torch, Model, load_checkpoint, testbed, serve, tasks, loader,
                greedy, ckpt)
    rows_check_phase(torch, Model, BatchEngine, testbed, load_checkpoint,
                     loader, ckpt)
    lap("check")
    kernels = {"decode_attention": decode_attention,
               "flash_attention": flash_attention,
               "paged_decode_attention": paged_decode_attention,
               "paged_append_attention": paged_append_attention,
               "ssd_scan": ssd_scan}
    dense_rows_check_phase(torch, Model, BatchEngine, loader, kernels,
                           minitron_4b.CONFIG)
    lap(f"check, {DENSE_ARCH} rows")
    paged, cont_greedy = continuous_phase(torch, serve, kernels, ckpt)
    launches.update(paged)
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
    ssm_check_phase(torch, ssm_base)
    lap("check, ssm")

    # one record per kernel at a representative serving-path shape (BASE
    # heads, fp32): decode at 128 cached tokens, a 16-token extend at 100;
    # a paged decode step of 4 ragged rows, a 16-token paged extend; a
    # 37-token mamba2-1.3b extend (one chunk)
    rep = {"decode_attention": "base float32 B=1 cache=1024 lengths=[128]",
           "flash_attention": "base float32 S=16 q_offset=100 kv=1024 "
                              "causal=True window=0",
           "paged_decode_attention": "base float32 B=4 "
                                     "lengths=[0, 1, 77, 640]",
           "paged_append_attention": "base float32 T=16 B=2 ctx=[1, 100] "
                                     "span=[16, 11]",
           "ssd_scan": "mamba2 float32 B=1 L=37 H=64 P=64 G=1 N=128 "
                       "chunk=37"}
    sources = {"decode_attention": "src/repro/kernels/decode_attention.py:83",
               "flash_attention": "src/repro/kernels/flash_attention.py:90",
               "paged_decode_attention":
                   "src/repro/kernels/paged_decode_attention.py:89",
               "paged_append_attention":
                   "src/repro/kernels/paged_append_attention.py:118",
               "ssd_scan": "src/repro/kernels/ssd_scan.py:88"}
    kernels_json = []
    for name, recs in records.items():
        r = next(x for x in recs if x["shape"] == rep[name])
        kernels_json.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=sources[name], launches=launches[name],
            max_abs_err=max(x["max_abs_err"] for x in recs
                            if x["dtype"] == "float32"),
            max_abs_err_bf16=max(x["max_abs_err"] for x in recs
                                 if x["dtype"] == "bfloat16"),
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
