"""Break the SSD scan's device time down by what its kernels do.

    python -m repro_torch.launch.ssd_breakdown

Builds this checkout's ``csrc/ssd_scan.cu`` four times into
``build/probe/ssd_breakdown`` with ``kernels/build.py``'s nvcc and flags:

* ``full``: as it is;
* ``no products``: ``mma_tf32`` defined to nothing after ``tf32_mma.cuh``,
  so that no tensor-core product is issued;
* ``no copies``: ``cp_async16z`` defined to nothing, so that no 16-byte
  ``cp.async`` copy is issued (the tiles keep what shared memory held);
* ``neither``: both out.  What remains is the conversion into the tiles
  (decay, dt, the 3xTF32 splits), the cumulative sums, the barriers, the
  pass over the chunks and the stores.

The variants without products or copies compute garbage: only their
times are read.  At mamba2-1.3b's heads (64 of P 64, N 128, one group)
with B and C sliced from one conv output as ``apply_mamba`` passes them
and an initial state (``append_ab.py``'s ``ssd_scan`` cases: L=37 in one
chunk, L=2048 in 16 chunks of 128), in fp32 and bf16, it prints for each
variant the device time of a scan by launch (chunk, pass, scan) from
``torch.profiler`` over 20 calls, as one JSON line a case, after the
card's name and power limit.  Needs CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

VARIANTS = {"full": (),
            "no products": ("mma_tf32",),
            "no copies": ("cp_async16z",),
            "neither": ("mma_tf32", "cp_async16z")}
INCLUDE = '#include "tf32_mma.cuh"\n'
REPS = 20
LAUNCHES = ("ssd_chunk_kernel", "ssd_pass_kernel", "ssd_scan_kernel")


def _build(build, out: Path) -> dict:
    """Variant name -> library path; one nvcc each, all started together."""
    src = (build.CSRC / "ssd_scan.cu").read_text()
    if INCLUDE not in src:
        raise RuntimeError("csrc/ssd_scan.cu no longer includes "
                           "tf32_mma.cuh where the variants expect it")
    out.mkdir(parents=True, exist_ok=True)
    procs, libs = [], {}
    for k, (name, gone) in enumerate(VARIANTS.items()):
        cu, lib = out / f"ssd_scan_{k}.cu", out / f"libssd_scan_{k}.so"
        cu.write_text(src.replace(INCLUDE, INCLUDE + "".join(
            f"#define {fn}(...) ((void)0)\n" for fn in gone)))
        procs.append(subprocess.Popen(
            [build._nvcc(), *build.FLAGS, "-I", str(build.CSRC), "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        libs[name] = str(lib)
    for p in procs:
        out_text, _ = p.communicate(timeout=900)
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{out_text}")
    return libs


def main() -> int:
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build, ref
    from repro_torch.launch.append_ab import _ssd_cases
    from repro_torch.launch.ssm_ab import bind_scan

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"[ssd_breakdown] {card}", flush=True)
    root = str(Path(build.CSRC).parents[3])
    libs = _build(build, build.BUILD_DIR.parent / "probe" / "ssd_breakdown")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for k, (name, lib) in enumerate(libs.items()):
        scan = bind_scan(lib, root, f"breakdown{k}")
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(0)
            for row, call, _ in _ssd_cases(torch, F, ref, scan, dt, gen,
                                           dev):
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(REPS):
                        call()
                    torch.cuda.synchronize()
                by = dict.fromkeys(LAUNCHES, 0.0)
                for e in prof.key_averages():
                    for launch in LAUNCHES:
                        if launch in e.key:
                            by[launch] += e.self_device_time_total / 1e3 / REPS
                print(json.dumps(dict(
                    variant=name, shape=row["shape"], dtype=str(dt)[6:],
                    max_abs_err=row["max_abs_err"],
                    device_ms=sum(by.values()), device_ms_by_launch=by)),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
