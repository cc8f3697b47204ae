"""Measure the rate of m16n8k8 TF32 ``mma.sync`` on one card.

    python -m repro_torch.launch.mma_rate

The ceiling of the kernels that multiply with ``mma.sync`` (#2, #4 and
#5): compiles a small CUDA probe with ``kernels/build.py``'s
nvcc and flags into ``build/probe`` and times, with CUDA events, the median
of five launches of

* ``raw``: every warp issues m16n8k8 TF32 products on operands held in
  registers, into ``acc`` independent accumulators (1 to 8); 8 warps a
  block, ``blocks`` an SM;
* ``fed``: the SSD scan's inner step (``csrc/ssd_scan.cu``'s
  ``warp_mma``): per k step a warp loads its A fragments (fp32, padded
  rows) from shared memory and splits them as 3xTF32, loads four n-tiles
  of pre-split B quads (one 16-byte load each), and issues the three
  products of each (lo.hi + hi.hi + hi.lo), for one or two 16-row
  fragments, the tile counts fixed at compile time; 8 warps a block, 2
  blocks an SM.

Prints the card's name and power limit, then one JSON line per case:
TF32 TFLOP/s (2 x 16 x 8 x 8 a product), products a clock per SM at the
SM clock read after the case, and the SM clock.  Needs CUDA.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

SOURCE = r'''
#include <cuda_runtime.h>
#include <cstdint>
#include "tf32_mma.cuh"
using namespace repro;

template <int kAcc>
__global__ void __launch_bounds__(256) raw_kernel(float* out, int iters) {
  const int lane = threadIdx.x % 32;
  uint32_t a[4], b[kAcc][2];
  for (int e = 0; e < 4; ++e) a[e] = to_tf32(1.0f + 0.001f * (lane + e));
  for (int u = 0; u < kAcc; ++u)
    b[u][0] = to_tf32(0.5f + u), b[u][1] = to_tf32(0.25f * lane);
  float acc[kAcc][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < kAcc; ++u) mma_tf32(acc[u], a, b[u][0], b[u][1]);
  }
  float s = 0.f;
  for (int u = 0; u < kAcc; ++u)
    s += acc[u][0] + acc[u][1] + acc[u][2] + acc[u][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// kF fragments of 16 rows x 4 n-tiles a warp; A fp32 [128][36], B quads
// (hi_k, hi_k+4, lo_k, lo_k+4) [16][66], as csrc/ssd_scan.cu lays them out
template <int kF>
__global__ void __launch_bounds__(256, 2) fed_kernel(float* out, int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);
  uint4* bs = reinterpret_cast<uint4*>(smem + 128 * 36 * 4);
  for (int i = threadIdx.x; i < 128 * 36; i += 256) as[i] = 1.0f + 1e-3f * i;
  for (int i = threadIdx.x; i < 16 * 66; i += 256) {
    uint4 q;
    split_tf32(0.5f + 1e-3f * i, q.x, q.z);
    split_tf32(0.25f + 1e-3f * i, q.y, q.w);
    bs[i] = q;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int rf0 = warp % 4, rf1 = 7 - warp % 4, nt0 = warp / 4 * 4;
  float acc[2][4][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = 8 * s;
      uint32_t bhi[4][2], blo[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint4 q = bs[(4 * s + tig) * 66 + 8 * (nt0 + u) + gid];
        bhi[u][0] = q.x, bhi[u][1] = q.y, blo[u][0] = q.z, blo[u][1] = q.w;
      }
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        const float* ap = as + (16 * (f ? rf1 : rf0) + gid) * 36 + k + tig;
        const float av[4] = {ap[0], ap[8 * 36], ap[4], ap[8 * 36 + 4]};
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(av[e], ahi[e], alo[e]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          mma_tf32(acc[f][u], alo, bhi[u][0], bhi[u][1]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          mma_tf32(acc[f][u], ahi, bhi[u][0], bhi[u][1]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          mma_tf32(acc[f][u], ahi, blo[u][0], blo[u][1]);
      }
    }
  }
  float s = 0.f;
  for (int f = 0; f < kF; ++f)
    for (int u = 0; u < 4; ++u)
      s += acc[f][u][0] + acc[f][u][1] + acc[f][u][2] + acc[f][u][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

constexpr int kFedSmem = 128 * 36 * 4 + 16 * 66 * 16;

// kind 0: raw with acc accumulators; 1: fed with acc fragments
extern "C" int probe_launch(int kind, int acc, int blocks, int iters,
                            float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0) {
    switch (acc) {
      case 1: raw_kernel<1><<<blocks, 256, 0, s>>>(out, iters); break;
      case 2: raw_kernel<2><<<blocks, 256, 0, s>>>(out, iters); break;
      case 4: raw_kernel<4><<<blocks, 256, 0, s>>>(out, iters); break;
      case 8: raw_kernel<8><<<blocks, 256, 0, s>>>(out, iters); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    cudaError_t e = allow_smem<fed_kernel<1>>(kFedSmem);
    if (e == cudaSuccess) e = allow_smem<fed_kernel<2>>(kFedSmem);
    if (e != cudaSuccess) return (int)e;
    if (acc == 1) fed_kernel<1><<<blocks, 256, kFedSmem, s>>>(out, iters);
    else fed_kernel<2><<<blocks, 256, kFedSmem, s>>>(out, iters);
  }
  return (int)cudaGetLastError();
}
'''

# (kind, accumulators or fragments, blocks an SM)
CASES = [("raw", 1, 2), ("raw", 2, 2), ("raw", 4, 2), ("raw", 8, 2),
         ("raw", 4, 1), ("raw", 8, 1), ("fed", 1, 2), ("fed", 2, 2)]
ITERS = {"raw": 4096, "fed": 256}


def _library() -> ctypes.CDLL:
    from repro_torch.kernels import build
    out = build.BUILD_DIR.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "mma_rate.cu"
    src.write_text(SOURCE)
    lib = out / "libmma_rate.so"
    subprocess.run([build._nvcc(), *build.FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib), str(src)], check=True, timeout=600,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def _sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def main() -> int:
    import torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"[mma_rate] {card}", flush=True)
    lib = _library()
    fn = lib.probe_launch
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for kind, acc, per_sm in CASES:
        blocks, iters = sms * per_sm, ITERS[kind]
        out = torch.empty(blocks * 256, device="cuda")
        # products a launch: warps x iterations x products an iteration
        per_iter = acc if kind == "raw" else 4 * 12 * acc
        products = blocks * 8 * iters * per_iter
        times = []
        for rep in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(0 if kind == "raw" else 1, acc, blocks, iters,
                    out.data_ptr(), stream)
            end.record()
            end.synchronize()
            if rc != 0:
                raise RuntimeError(f"probe launch failed: CUDA error {rc}")
            if rep:                      # the first launch warms up
                times.append(start.elapsed_time(end))
        ms = sorted(times)[len(times) // 2]
        mhz = _sm_clock_mhz()
        print(json.dumps(dict(
            kind=kind, fragments_or_accumulators=acc, blocks_per_sm=per_sm,
            ms=ms, tf32_tflops=products * 2048 / ms / 1e9,
            products_per_clock_per_sm=products / sms / (ms * 1e-3 * mhz
                                                         * 1e6),
            sm_clock_mhz=mhz)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
