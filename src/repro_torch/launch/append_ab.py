"""Time one kernel of two checkouts on one card.

    python -m repro_torch.launch.append_ab --a <parent checkout> --b .
    python -m repro_torch.launch.append_ab --kernel flash_attention \
        --a <parent checkout> --b .
    python -m repro_torch.launch.append_ab --kernel decode_attention \
        --a <parent checkout> --b .
    python -m repro_torch.launch.append_ab --kernel ssd_scan \
        --a <parent checkout> --b .
    python -m repro_torch.launch.append_ab --kernel flash_attention_bwd \
        --a <parent checkout> --b .

Runs each checkout's own ``repro_torch`` in a fresh process, in turns
A, B, B, A, on the same inputs (made on the card from a seed), in fp32
and bf16 (the attention backward: fp32 only):

* ``paged_append_attention`` (#4, the default): B=8 rows of minitron-4b's
  attention shape (24 query heads over 8 kv heads, hd 128) over 4096
  committed tokens on shuffled 16-token pages, with a verification span
  (T=5) and a 64-query chunk; and the BASE serving shape of
  ``chip_smoke.py``'s representative record (8 heads over 4, hd 28,
  T=16, contexts 1 and 100, spans 16 and 11);
* ``flash_attention`` (#2): minitron-4b's heads over a 2048-token prompt
  (causal, S=2048) and a 256-query chunk at offset 1792 over 2048 keys;
  and BASE's 16-query bucket at offsets 100 and 700 of a 1024-slot
  cache (the second splits its keys over blocks);
* ``decode_attention`` (#1): minitron-4b's heads, B=8 rows over 4096
  cached keys each, and the BASE record of ``chip_smoke.py`` (one row,
  128 of 1024 slots);
* ``paged_decode_attention`` (#3): minitron-4b's heads, B=8 rows over
  4096 keys on shuffled 16-token pages, and the BASE record of
  ``chip_smoke.py`` (4 rows of 0, 1, 77 and 640 keys);
* ``ssd_scan`` (#5): mamba2-1.3b's heads (64 of P 64, N 128, one group)
  over a 37-token extend (one chunk) and a 2048-token prompt (16 chunks
  of 128), with an initial state and B and C sliced from one conv output
  as ``apply_mamba`` passes them; the device time is also given per
  kernel name.  No single PyTorch call computes the scan;
* ``flash_attention_bwd`` (2b): the backward cases of the
  ``chip_smoke.py`` beside this file (``BWD_CASES``, for both checkouts):
  the training shapes of BASE (16 x 112, 8 over 4 heads, hd 28) and SMALL
  (16 x 96, 4 over 2, hd 32) and minitron-4b's heads at S = 256 to 4096,
  in the training forward's layout, o from the checkout's own #2; the
  device time also per kernel name; the yardstick is the autograd
  backward of fp32 SDPA (its forward outside the timed calls).

For each it prints the time per call from CUDA events over back-to-back
calls (the median of five windows of 30, the wrapper's host cost
included, as ``chip_smoke.py`` times it) with each window's time and
the SM clock after them, the device time per call of the kernel and its
merge (#5: its launches) from ``torch.profiler``, and SDPA on the same
inputs, the yardstick (#4: minitron only; #3 and #4 over the
pre-gathered K/V, gather excluded; #5 none).
Prints the card's name and power limit first and one JSON line per run.
Needs CUDA; builds the kernel of each checkout into that checkout's
``build/kernels``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (label, H, K, hd, T, ctx, span)
APPEND_CASES = [("minitron", 24, 8, 128, 5, [4096] * 8, [5] * 8),
                ("minitron", 24, 8, 128, 64, [4096] * 8, [64] * 8),
                ("base", 8, 4, 28, 16, [1, 100], [16, 11])]
# (label, H, K, hd, S, cache slots, q_offset); causal, kv_len = the slots
FLASH_CASES = [("minitron", 24, 8, 128, 2048, 2048, 0),
               ("minitron", 24, 8, 128, 256, 2048, 1792),
               ("base", 8, 4, 28, 16, 1024, 100),
               ("base", 8, 4, 28, 16, 1024, 700)]
# (label, H, K, hd, cache slots, lengths): #1 and #3
DECODE_CASES = [("minitron", 24, 8, 128, 4096, [4096] * 8),
                ("base", 8, 4, 28, 1024, [128])]
PAGED_DECODE_CASES = [("minitron", 24, 8, 128, 4096, [4096] * 8),
                      ("base", 8, 4, 28, 640, [0, 1, 77, 640])]
# (label, L, chunk): #5 at mamba2-1.3b's heads
SSD_CASES = [("mamba2", 37, 37), ("mamba2", 2048, 128)]
SSD_HEADS = (64, 64, 1, 128)    # H, P, G, N
KERNELS = ("paged_append_attention", "flash_attention", "decode_attention",
           "paged_decode_attention", "ssd_scan", "flash_attention_bwd")
BLOCK = 16
REPS = 30
WINDOWS = 5


def _append_cases(torch, F, ref, kernel, dt, gen, dev):
    """(row, call, SDPA call or None) for each of #4's cases."""
    for label, h, kh, hd, t, ctx, span in APPEND_CASES:
        b = len(ctx)
        nb = -(-(max(ctx) + t) // BLOCK)
        n_pages = b * nb + 7
        kp = torch.randn(n_pages, kh, BLOCK, hd, generator=gen,
                         device=dev).to(dt)
        vp = torch.randn(n_pages, kh, BLOCK, hd, generator=gen,
                         device=dev).to(dt)
        perm = torch.randperm(n_pages, generator=gen, device=dev)
        tables = perm[:b * nb].reshape(b, nb).to(torch.int32).contiguous()
        q = torch.randn(b, t, h, hd, generator=gen, device=dev).to(dt)
        kn = torch.randn(b, t, kh, hd, generator=gen, device=dev).to(dt)
        vn = torch.randn(b, t, kh, hd, generator=gen, device=dev).to(dt)
        cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
        sl = torch.tensor(span, dtype=torch.int32, device=dev)
        args = (q, kn, vn, kp, vp, tables, cl, sl)
        out = kernel(*args)
        exp = ref.paged_append_reference(*args)
        err = max((out[i, :n].float() - exp[i, :n].float()).abs().max()
                  .item() for i, n in enumerate(span))
        sdpa = None
        if label == "minitron":
            kd = kp[tables.long()].transpose(1, 2).reshape(b, kh, -1, hd)
            vd = vp[tables.long()].transpose(1, 2).reshape(b, kh, -1, hd)
            kd = torch.cat([kd, kn.transpose(1, 2)], 2)
            vd = torch.cat([vd, vn.transpose(1, 2)], 2)
            s_ctx = kd.shape[2] - t
            kj = torch.arange(s_ctx + t, device=dev)[None, None, :]
            qi = torch.arange(t, device=dev)[None, :, None]
            mask = ((kj < cl[:, None, None]) & (kj < s_ctx)) | (
                (kj >= s_ctx) & (kj - s_ctx <= qi)
                & (kj - s_ctx < sl[:, None, None]))
            qh = q.transpose(1, 2)

            def sdpa(qh=qh, kd=kd, vd=vd, mask=mask):
                return F.scaled_dot_product_attention(
                    qh, kd, vd, attn_mask=mask[:, None], enable_gqa=True)
        yield (dict(shape=f"{label} T={t} B={b}", max_abs_err=err),
               lambda args=args: kernel(*args), sdpa)


def _flash_cases(torch, F, ref, kernel, dt, gen, dev):
    """(row, call, SDPA call) for each of #2's cases."""
    for label, h, kh, hd, s, cap, off in FLASH_CASES:
        q = torch.randn(1, s, h, hd, generator=gen,
                        device=dev).to(dt).permute(0, 2, 1, 3)
        kc = torch.randn(1, cap, kh, hd, generator=gen,
                         device=dev).to(dt).permute(0, 2, 1, 3)
        vc = torch.randn(1, cap, kh, hd, generator=gen,
                         device=dev).to(dt).permute(0, 2, 1, 3)
        args = (q, kc, vc, True, off, cap, 0)
        err = (kernel(*args).float() - ref.mha_reference(*args).float()
               ).abs().max().item()
        # SDPA in its fastest form of the same function: is_causal over a
        # whole prompt, else the mask
        whole = off == 0 and cap == s
        mask = None if whole else ref.attention_mask(s, cap, True, off, cap,
                                                     device=dev)
        yield (dict(shape=f"{label} S={s} q_offset={off} kv={cap}",
                    max_abs_err=err),
               lambda args=args: kernel(*args),
               lambda q=q, kc=kc, vc=vc, mask=mask, whole=whole:
               F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask,
                                              is_causal=whole,
                                              enable_gqa=True))


def _decode_cases(torch, F, ref, kernel, dt, gen, dev):
    """(row, call, SDPA call) for each of #1's cases."""
    for label, h, kh, hd, cap, lens in DECODE_CASES:
        b = len(lens)
        kc = torch.randn(b, cap, kh, hd, generator=gen,
                         device=dev).to(dt).permute(0, 2, 1, 3)
        vc = torch.randn(b, cap, kh, hd, generator=gen,
                         device=dev).to(dt).permute(0, 2, 1, 3)
        q = torch.randn(b, h, hd, generator=gen, device=dev).to(dt)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q, kc, vc, lengths)
        err = (kernel(*args).float() - ref.decode_reference(*args).float()
               ).abs().max().item()
        mask = (torch.arange(cap, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        yield (dict(shape=f"{label} B={b} cache={cap} lengths={lens[:4]}",
                    max_abs_err=err),
               lambda args=args: kernel(*args),
               lambda q4=q[:, :, None], kc=kc, vc=vc, mask=mask:
               F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask,
                                              enable_gqa=True))


def _paged_decode_cases(torch, F, ref, kernel, dt, gen, dev):
    """(row, call, SDPA call over the gathered K/V) for each of #3's."""
    for label, h, kh, hd, cap, lens in PAGED_DECODE_CASES:
        b = len(lens)
        nb = -(-cap // BLOCK)
        n_pages = b * nb + 7
        kp = torch.randn(n_pages, kh, BLOCK, hd, generator=gen,
                         device=dev).to(dt)
        vp = torch.randn(n_pages, kh, BLOCK, hd, generator=gen,
                         device=dev).to(dt)
        perm = torch.randperm(n_pages, generator=gen, device=dev)
        tables = perm[:b * nb].reshape(b, nb).to(torch.int32).contiguous()
        q = torch.randn(b, h, hd, generator=gen, device=dev).to(dt)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q, kp, vp, tables, lengths)
        live = lengths > 0      # the plain version averages an empty row
        err = (kernel(*args)[live].float()
               - ref.paged_decode_reference(*args)[live].float()
               ).abs().max().item()
        kd = kp[tables.long()].transpose(1, 2).reshape(b, kh, -1, hd)
        vd = vp[tables.long()].transpose(1, 2).reshape(b, kh, -1, hd)
        mask = (torch.arange(kd.shape[2], device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        yield (dict(shape=f"{label} B={b} lengths={lens[:4]}",
                    max_abs_err=err),
               lambda args=args: kernel(*args),
               lambda q4=q[:, :, None], kd=kd, vd=vd, mask=mask:
               F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask,
                                              enable_gqa=True))


def _ssd_cases(torch, F, ref, kernel, dt, gen, dev):
    """(row, call, None) for each of #5's cases."""
    h, p, g, n = SSD_HEADS
    for label, l, chunk in SSD_CASES:
        di, gn = h * p, g * n
        xbc = torch.randn(1, l, di + 2 * gn, generator=gen, device=dev)
        xbc[..., di:] *= 0.3
        xbc = xbc.to(dt)
        x = xbc[..., :di].reshape(1, l, h, p)
        bb = xbc[..., di:di + gn].reshape(1, l, g, n)
        cc = xbc[..., di + gn:].reshape(1, l, g, n)
        dtv = torch.nn.functional.softplus(
            torch.randn(1, l, h, generator=gen, device=dev))
        a = -torch.exp(torch.randn(h, generator=gen, device=dev) * 0.5)
        init = torch.randn(1, h, p, n, generator=gen, device=dev) * 0.5
        args = (x, dtv, a, bb, cc, chunk, init)
        y, _ = kernel(*args)
        ye, _ = ref.ssd_reference(x, dtv, a, bb, cc, init)
        err = (y.float() - ye.float()).abs().max().item()
        yield (dict(shape=f"{label} L={l} chunk={chunk}", max_abs_err=err),
               lambda args=args: kernel(*args), None)


def _bwd_cases(torch, F, ref, kernel, dt, gen, dev):
    """(row, call, SDPA backward call) for each of 2b's cases."""
    import importlib.util

    from repro_torch.configs import minitron_4b
    from repro_torch.kernels.flash_attention import flash_attention
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..", "..",
        "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for label, b, s, _ in smoke.BWD_CASES:
        h, kh, hd = smoke.bwd_heads(label, minitron_4b.CONFIG)
        q, k, v = (torch.randn(b, s, n, hd, generator=gen, device=dev)
                   .to(dt).permute(0, 2, 1, 3) for n in (h, kh, kh))
        do = torch.randn(b, h, s, hd, generator=gen, device=dev).to(dt)
        o = flash_attention(q, k, v)
        args = (q, k, v, o, do)
        err = max((g - w).abs().max().item() for g, w in zip(
            kernel(*args), ref.mha_backward_reference(q, k, v, do)))
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
        yield (dict(shape=f"{label} B={b} S={s} H={h} K={kh} hd={hd}",
                    max_abs_err=err),
               lambda args=args: kernel(*args),
               lambda out=out, leaves=leaves, do=do: torch.autograd.grad(
                   out, leaves, do, retain_graph=True))


CASES = {"paged_append_attention": _append_cases,
         "flash_attention": _flash_cases,
         "decode_attention": _decode_cases,
         "paged_decode_attention": _paged_decode_cases,
         "ssd_scan": _ssd_cases,
         "flash_attention_bwd": _bwd_cases}


def _child(root: str, name: str) -> None:
    sys.path.insert(0, os.path.join(root, "src"))
    import importlib

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build, ref

    # 2b's inputs come from the checkout's own forward (#2)
    build.build([name] + (["flash_attention"]
                          if name == "flash_attention_bwd" else []))
    kernel = getattr(importlib.import_module(f"repro_torch.kernels.{name}"),
                     name)
    cases = CASES[name]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    dtypes = (torch.float32,) if name == "flash_attention_bwd" else (
        torch.float32, torch.bfloat16)
    for dt in dtypes:
        gen = torch.Generator(device=dev).manual_seed(0)
        for row, call, sdpa in cases(torch, F, ref, kernel, dt, gen, dev):
            ms, windows = _events(torch, call)
            row.update(dtype=str(dt)[6:], ms=ms, ms_windows=windows,
                       sm_clock=_sm_clock())
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    call()
                torch.cuda.synchronize()
            dev_rows = [(e.key, e.self_device_time_total / 1e3 / REPS)
                        for e in prof.key_averages()
                        if e.self_device_time_total > 0]
            row["device_ms"] = sum(t for _, t in dev_rows)
            if name in ("ssd_scan", "flash_attention_bwd"):
                row["device_ms_by_kernel"] = {k[:40]: t for k, t in dev_rows}
            if sdpa is not None:
                row["sdpa_ms"] = _events(torch, sdpa)[0]
            rows.append(row)
    print(json.dumps({"root": root, "kernel": name, "rows": rows}),
          flush=True)


def _sm_clock() -> str:
    """The card's SM clock (MHz) and active clock-throttle reasons now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks_throttle_reasons.active",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _events(torch, fn):
    """(ms a call, host cost included: the median over WINDOWS
    CUDA-event windows of REPS calls each; every window's ms)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    return sorted(times)[WINDOWS // 2], times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--a", required=True, help="checkout A (e.g. parent)")
    ap.add_argument("--b", required=True, help="checkout B (e.g. change)")
    ap.add_argument("--kernel", choices=KERNELS, default=KERNELS[0],
                    help="the kernel to time (default: %(default)s)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(args.child, args.kernel)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"[append_ab] {card}", flush=True)
    for root in (args.a, args.b, args.b, args.a):
        root = os.path.abspath(root)
        # this file runs as a script, so the child imports the kernel of
        # ``root`` and no other checkout's
        subprocess.run([sys.executable, os.path.abspath(__file__), "--a",
                        args.a, "--b", args.b, "--kernel", args.kernel,
                        "--child", root],
                       check=True, cwd=root, timeout=900,
                       env={**os.environ, "PYTHONPATH": ""})
    return 0


if __name__ == "__main__":
    sys.exit(main())
