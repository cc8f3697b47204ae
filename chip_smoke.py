#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout.  Phases, each printing its lines:

1. device: the card's name and power limit (nvidia-smi);
2. build: ``nvcc`` for every kernel source, in parallel;
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, in fp32 and bf16, at the serving path's shapes (BASE and SMALL
   heads, prefill buckets 4..256 at offsets in a 1024-slot cache, decode
   at ragged lengths up to 1024) and at minitron-4b's attention shape
   (24 query heads over 8 kv heads, hd 128: prefill S=2048, decode B=8
   over 4096), with the kernel's, the plain version's and SDPA's times
   and the card's bound;
4. main path: random-init BASE/SMALL checkpoints written by the port,
   served by ``repro_torch.launch.serve --scheme specreason`` on the card,
   3 requests, greedy and at temperature 0.6, each run between a reset
   and a read of the kernels' launch counters, which must equal
   n_layers x the engines' metered decode and prefill calls; the greedy
   run must see the verifier both accept and reject a drafted step;
5. check: BASE and SMALL logits on the card against the same checkpoint
   on the CPU, over a prefill and decode steps;
then the card again, one JSON line of per-kernel numbers, and
``{"ok": true, "device": {...}}`` as the last line.  Any failure exits
non-zero before that line; without CUDA, or outside a checkout, it exits
non-zero at once.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM, data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}        # atol = rtol, as the tests
LOGIT_TOL = 1e-4       # card vs CPU model logits (fp32 GEMMs, TF32 off)
CACHE = 1024           # the serving engines' max_len
# the random-init pair's step utilities spread over about 2..5.5, so this
# threshold makes the verifier both accept and reject drafted steps
THRESHOLD = 4.5
BUCKETS = (4, 8, 16, 32, 64, 128, 256)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, F, ref, decode_kernel, flash_kernel, minitron):
    """Every kernel against its plain version at the path's shapes.
    Returns per-kernel records for the JSON line."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    heads = {"base": (8, 4, 28), "small": (4, 2, 32),
             "minitron": (minitron.n_heads, minitron.n_kv_heads,
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
                    ("minitron", 8, [4096] * 8)]
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
            records["decode_attention"].append(dict(
                shape=label, dtype=dname, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=by))
            print(f"[kernels] decode_attention {label}: err {err:.3g} | "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({by})",
                  flush=True)

        prefill_cases = [(m, s, off, CACHE, True, 0)
                         for m in ("base", "small")
                         for s, off in zip(BUCKETS, (0, 100, 100, 500, 200,
                                                     640, 768))]
        prefill_cases += [("small", 64, 300, CACHE, True, 128),  # window
                          ("base", 128, 0, 128, False, 0),       # Pallas,
                          ("base", 128, 0, 128, True, 0),        # contract
                          ("minitron", 2048, 0, 2048, True, 0)]
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
            records["flash_attention"].append(dict(
                shape=label, dtype=dname, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=by))
            print(f"[kernels] flash_attention {label}: err {err:.3g} | "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({by})",
                  flush=True)
    return records


def main_path_phase(torch, serve, decode_kernel, flash_kernel, ckpt):
    """Serve 3 specreason requests on the card, greedy and sampled; the
    kernels' launch counts must equal n_layers x the metered calls."""
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
                want[0] += layers[name] * m["decode_calls"]
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
        print(f"[main] {label}: launches decode {got[0]}, prefill {got[1]} "
              "== n_layers x metered calls", flush=True)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.nn.functional as F

    from repro_torch.checkpoint.checkpoint import load_checkpoint
    from repro_torch.configs import minitron_4b, testbed
    from repro_torch.data import tasks
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.serving import loader

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = nvidia_smi()
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)",
          flush=True)

    t0 = time.perf_counter()
    reports = build.build()
    for name, text in reports.items():
        regs = sorted({ln.split("Used ")[1].split(",")[0]
                       for ln in text.splitlines() if "Used " in ln})
        spills = sum(" 0 bytes spill" not in ln for ln in text.splitlines()
                     if "spill stores" in ln)
        print(f"[build] {name}: {regs} per variant, {spills} variants "
              "spill", flush=True)
    print(f"[build] {len(reports)} sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    records = kernel_phase(torch, F, ref, decode_attention, flash_attention,
                           minitron_4b.CONFIG)

    ckpt = os.path.join(ROOT, "build", "smoke_ckpt")
    loader.save_random_testbed(ckpt, seed=0)
    launches, greedy = main_path_phase(torch, serve, decode_attention,
                                       flash_attention, ckpt)
    check_phase(torch, Model, load_checkpoint, testbed, serve, tasks, loader,
                greedy, ckpt)

    # one record per kernel at a representative serving-path shape (BASE
    # heads, fp32): decode at 128 cached tokens, a 16-token extend at 100
    rep = {"decode_attention": "base float32 B=1 cache=1024 lengths=[128]",
           "flash_attention": "base float32 S=16 q_offset=100 kv=1024 "
                              "causal=True window=0"}
    sources = {"decode_attention": "src/repro/kernels/decode_attention.py:83",
               "flash_attention": "src/repro/kernels/flash_attention.py:90"}
    kernels = []
    for name, recs in records.items():
        r = next(x for x in recs if x["shape"] == rep[name])
        kernels.append(dict(
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
