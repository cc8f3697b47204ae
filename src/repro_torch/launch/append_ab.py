"""Time paged span attention (kernel #4) of two checkouts on one card.

    python -m repro_torch.launch.append_ab --a <parent checkout> --b .

Runs each checkout's own ``repro_torch`` in a fresh process, in turns
A, B, B, A, on the same inputs (made on the card from a seed): B=8 rows
of minitron-4b's attention shape (24 query heads over 8 kv heads, hd
128) over 4096 committed tokens on shuffled 16-token pages, with a
verification span (T=5) and a 64-query chunk, in fp32 and bf16; and
the BASE serving shape of ``chip_smoke.py``'s representative record
(8 heads over 4, hd 28, T=16, contexts 1 and 100, spans 16 and 11).
For each it prints the time per call from CUDA events over back-to-back
calls (the wrapper's host cost included, as ``chip_smoke.py`` times
it) and the device time per call of the kernel and its merge from
``torch.profiler``; for minitron also SDPA over the pre-gathered K/V
(gather excluded), the yardstick.  Prints the card's name and power
limit first and one JSON line per run.  Needs CUDA; builds the kernel
of each checkout into that checkout's ``build/kernels``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (label, H, K, hd, T, ctx, span)
CASES = [("minitron", 24, 8, 128, 5, [4096] * 8, [5] * 8),
         ("minitron", 24, 8, 128, 64, [4096] * 8, [64] * 8),
         ("base", 8, 4, 28, 16, [1, 100], [16, 11])]
BLOCK = 16
REPS = 30


def _child(root: str) -> None:
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build, ref
    from repro_torch.kernels.paged_append_attention import \
        paged_append_attention as kernel

    build.build(["paged_append_attention"])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(0)
        for label, h, kh, hd, t, ctx, span in CASES:
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
            row = dict(shape=f"{label} T={t} B={b}", dtype=str(dt)[6:],
                       max_abs_err=err, ms=_events(torch, lambda: kernel(
                           *args)))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    kernel(*args)
                torch.cuda.synchronize()
            row["device_ms"] = sum(
                e.self_device_time_total for e in prof.key_averages()
                if e.self_device_time_total > 0) / 1e3 / REPS
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
                row["sdpa_ms"] = _events(
                    torch, lambda: F.scaled_dot_product_attention(
                        qh, kd, vd, attn_mask=mask[:, None],
                        enable_gqa=True))
            rows.append(row)
    print(json.dumps({"root": root, "rows": rows}), flush=True)


def _events(torch, fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--a", required=True, help="checkout A (e.g. parent)")
    ap.add_argument("--b", required=True, help="checkout B (e.g. change)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(args.child)
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
                        args.a, "--b", args.b, "--child", root],
                       check=True, cwd=root, timeout=900,
                       env={**os.environ, "PYTHONPATH": ""})
    return 0


if __name__ == "__main__":
    sys.exit(main())
