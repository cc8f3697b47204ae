// Backward of causal GQA attention for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(Q K^T / sqrt(hd)) V, the gradient of kernel #2
// (flash_attention.cu) on the training forward.
//
// Replaces: no TPU kernel.  The JAX package trains through XLA attention
// (src/repro/models/attention.py) and JAX differentiates it; the port's
// training forward runs kernel #2, whose output has no autograd history,
// so its gradient is this kernel, called from a torch.autograd.Function
// (kernels/ops.py).  Contract: the training forward's case, causal from
// position 0 over S keys (query i sees keys j <= i), no window, float32,
// query head h reading kv head h / G, head_dim up to 128.
//
// What bounds it on this card: the least work is five causal products
// (Q K^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K), 2 * hd flops
// each per visible (query, key) pair, fp32-accurate, so at minitron-4b's
// heads (24 over 8, hd 128) at S = 2048 it is bound by operations (64.5
// GFLOP, 0.39 ms at 3xTF32's 165 TFLOP/s); at the testbed's training
// shapes (B 16, S 96-112, hd 28-32) each launch is a few MFLOP and bound
// by latency.
//
// What the design does: it is the simple first version, fp32 on the CUDA
// cores, three launches and no atomics, so two runs give the same bits.
//  1. lse_kernel, a block per (query tile, head, row): each row's
//     logsumexp of the scaled scores (recomputed, since kernel #2 keeps no
//     statistics) and D = rowsum(dO * O).
//  2. dkv_kernel, a block per (key tile, kv head, row): dK and dV of its
//     32 keys, summed over the G query heads of the kv head and over the
//     query tiles at or after the key tile, in registers.
//  3. dq_kernel, a block per (query tile, head, row): dQ of its 32 rows
//     over the key tiles at or before them.
// Tiles are 32 rows x head_dim padded to 32, 64 or 128 with zeros, in
// shared memory with a row stride of HD + 1 floats (no bank conflicts when
// each lane reads its own row).  A warp computes the scores of 4 query
// rows against the tile's 32 keys, lane j holding key j, so a row's
// softmax statistics are warp reductions; for the products each thread
// owns one output row and HD / 8 of its columns.  Tensor cores (the 3xTF32
// plan of tf32_mma.cuh) are later work.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;                // query rows and keys a tile
constexpr int kRowsPerWarp = kT / kWarps;
constexpr float kNegInf = -INFINITY;

// element strides over (B, heads, S) of a (B, heads, S, hd) tensor with a
// unit stride over hd
struct Strides {
  long long b, h, s;
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  float* lse;   // (B, H, S) scratch
  float* dsum;  // (B, H, S) scratch
  int S, H, KH, hd;
  float scale;  // 1 / sqrt(hd)
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
};

__device__ __forceinline__ const float* row_ptr(const float* p,
                                                const Strides& st, int b,
                                                int h) {
  return p + b * st.b + h * st.h;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// rows [row0, row0 + kT) of a (S, hd) slice with row stride rs into a
// (kT, HD + 1) shared tile, zeros past S and hd
template <int HD>
__device__ void load_tile(float* dst, const float* src, long long rs,
                          int row0, int S, int hd) {
  for (int idx = threadIdx.x; idx < kT * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, row = row0 + r;
    dst[r * (HD + 1) + d] =
        row < S && d < hd ? src[(long long)row * rs + d] : 0.f;
  }
}

// The scores of this warp's kRowsPerWarp query rows (tile rows warp + 8 rr)
// against key `lane` of the key tile, and (kDp) dP = dO . V of the same
// pairs.
template <int HD, bool kDp>
__device__ __forceinline__ void pair_dots(const float* qs, const float* ks,
                                          const float* dos, const float* vs,
                                          float (&s)[kRowsPerWarp],
                                          float (&dp)[kRowsPerWarp]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = dp[rr] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    const float kd = ks[lane * (HD + 1) + d];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
      s[rr] = fmaf(qs[(warp + kWarps * rr) * (HD + 1) + d], kd, s[rr]);
    if (kDp) {
      const float vd = vs[lane * (HD + 1) + d];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        dp[rr] = fmaf(dos[(warp + kWarps * rr) * (HD + 1) + d], vd, dp[rr]);
    }
  }
}

// 1. logsumexp of each row's scaled scores over keys j <= i, and
//    D = rowsum(dO * O)
template <int HD>
__global__ void __launch_bounds__(kThreads) lse_kernel(Args a) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kT * (HD + 1);
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  load_tile<HD>(qs, row_ptr(a.q, a.sq, b, h), a.sq.s, q0, a.S, a.hd);

  const float* o = row_ptr(a.o, a.so, b, h);
  const float* dout = row_ptr(a.dout, a.sdo, b, h);
  const long long stat = ((long long)b * a.H + h) * a.S;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = q0 + warp + kWarps * rr;
    if (i >= a.S) continue;
    float acc = 0.f;
    for (int d = lane; d < a.hd; d += 32)
      acc = fmaf(dout[(long long)i * a.sdo.s + d], o[(long long)i * a.so.s + d],
                 acc);
    acc = warp_sum(acc);
    if (lane == 0) a.dsum[stat + i] = acc;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], s[kRowsPerWarp],
      unused[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) m[rr] = kNegInf, l[rr] = 0.f;
  const float* k = row_ptr(a.k, a.sk, b, kh);
  for (int k0 = 0; k0 <= q0 && k0 < a.S; k0 += kT) {
    __syncthreads();
    load_tile<HD>(ks, k, a.sk.s, k0, a.S, a.hd);
    __syncthreads();
    pair_dots<HD, false>(qs, ks, nullptr, nullptr, s, unused);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int i = q0 + warp + kWarps * rr, j = k0 + lane;
      const float x = j <= i && i < a.S ? s[rr] * a.scale : kNegInf;
      const float mt = warp_max(x);
      const float mn = fmaxf(m[rr], mt);
      if (mn == kNegInf) continue;  // nothing seen yet
      const float sum = warp_sum(x == kNegInf ? 0.f : expf(x - mn));
      l[rr] = l[rr] * expf(m[rr] - mn) + sum;
      m[rr] = mn;
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = q0 + warp + kWarps * rr;
    if (lane == 0 && i < a.S) a.lse[stat + i] = m[rr] + logf(l[rr]);
  }
}

// P and dS = P * (dP - D) of this warp's rows against key `lane`, into the
// (kT, kT + 1) shared tiles ps and dss (ps may be null)
template <int HD>
__device__ __forceinline__ void p_and_ds(const Args& a, const float* qs,
                                         const float* ks, const float* dos,
                                         const float* vs, const float* lse,
                                         const float* dsum, int q0, int k0,
                                         float* ps, float* dss) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s[kRowsPerWarp], dp[kRowsPerWarp];
  pair_dots<HD, true>(qs, ks, dos, vs, s, dp);
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + kWarps * rr, i = q0 + r, j = k0 + lane;
    const bool seen = j <= i && i < a.S;
    const float p = seen ? expf(s[rr] * a.scale - lse[r]) : 0.f;
    if (ps) ps[r * (kT + 1) + lane] = p;
    dss[r * (kT + 1) + lane] = p * (dp[rr] - dsum[r]);
  }
}

// a row's lse and D for tile rows [q0, q0 + kT) into shared memory
__device__ __forceinline__ void load_stats(const Args& a, float* lse,
                                           float* dsum, int b, int h,
                                           int q0) {
  const long long stat = ((long long)b * a.H + h) * a.S;
  if (threadIdx.x < kT) {
    const int i = q0 + threadIdx.x;
    lse[threadIdx.x] = i < a.S ? a.lse[stat + i] : 0.f;
    dsum[threadIdx.x] = i < a.S ? a.dsum[stat + i] : 0.f;
  }
}

// 2. dK and dV of one key tile, over the G heads of its kv head and the
//    query tiles at or after it
template <int HD>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Args a) {
  extern __shared__ float smem[];
  constexpr int kTile = kT * (HD + 1);
  float* ks = smem;
  float* vs = ks + kTile;
  float* qs = vs + kTile;
  float* dos = qs + kTile;
  float* ps = dos + kTile;
  float* dss = ps + kT * (kT + 1);
  float* lse = dss + kT * (kT + 1);
  float* dsum = lse + kT;
  const int k0 = blockIdx.x * kT, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KH;
  // this thread's output: key row jo, columns c0 + 8 c
  const int jo = threadIdx.x / 8, c0 = threadIdx.x % 8;
  float dk[HD / 8], dv[HD / 8];
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) dk[c] = dv[c] = 0.f;

  load_tile<HD>(ks, row_ptr(a.k, a.sk, b, kh), a.sk.s, k0, a.S, a.hd);
  load_tile<HD>(vs, row_ptr(a.v, a.sv, b, kh), a.sv.s, k0, a.S, a.hd);
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float* q = row_ptr(a.q, a.sq, b, h);
    const float* dout = row_ptr(a.dout, a.sdo, b, h);
    for (int q0 = k0; q0 < a.S; q0 += kT) {
      __syncthreads();
      load_tile<HD>(qs, q, a.sq.s, q0, a.S, a.hd);
      load_tile<HD>(dos, dout, a.sdo.s, q0, a.S, a.hd);
      load_stats(a, lse, dsum, b, h, q0);
      __syncthreads();
      p_and_ds<HD>(a, qs, ks, dos, vs, lse, dsum, q0, k0, ps, dss);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kT; ++r) {
        const float p = ps[r * (kT + 1) + jo], ds = dss[r * (kT + 1) + jo];
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          dv[c] = fmaf(p, dos[r * (HD + 1) + c0 + 8 * c], dv[c]);
          dk[c] = fmaf(ds, qs[r * (HD + 1) + c0 + 8 * c], dk[c]);
        }
      }
    }
  }
  const int j = k0 + jo;
  if (j >= a.S) return;
  float* dkr = a.dk + b * a.sdk.b + kh * a.sdk.h + (long long)j * a.sdk.s;
  float* dvr = a.dv + b * a.sdv.b + kh * a.sdv.h + (long long)j * a.sdv.s;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const int d = c0 + 8 * c;
    if (d < a.hd) {
      dkr[d] = dk[c] * a.scale;
      dvr[d] = dv[c];
    }
  }
}

// 3. dQ of one query tile over the key tiles at or before it
template <int HD>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  extern __shared__ float smem[];
  constexpr int kTile = kT * (HD + 1);
  float* qs = smem;
  float* dos = qs + kTile;
  float* ks = dos + kTile;
  float* vs = ks + kTile;
  float* dss = vs + kTile;
  float* lse = dss + kT * (kT + 1);
  float* dsum = lse + kT;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int io = threadIdx.x / 8, c0 = threadIdx.x % 8;
  float dq[HD / 8];
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) dq[c] = 0.f;

  load_tile<HD>(qs, row_ptr(a.q, a.sq, b, h), a.sq.s, q0, a.S, a.hd);
  load_tile<HD>(dos, row_ptr(a.dout, a.sdo, b, h), a.sdo.s, q0, a.S, a.hd);
  load_stats(a, lse, dsum, b, h, q0);
  const float* k = row_ptr(a.k, a.sk, b, kh);
  const float* v = row_ptr(a.v, a.sv, b, kh);
  for (int k0 = 0; k0 <= q0 && k0 < a.S; k0 += kT) {
    __syncthreads();
    load_tile<HD>(ks, k, a.sk.s, k0, a.S, a.hd);
    load_tile<HD>(vs, v, a.sv.s, k0, a.S, a.hd);
    __syncthreads();
    p_and_ds<HD>(a, qs, ks, dos, vs, lse, dsum, q0, k0, nullptr, dss);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      const float ds = dss[io * (kT + 1) + j];
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        dq[c] = fmaf(ds, ks[j * (HD + 1) + c0 + 8 * c], dq[c]);
    }
  }
  const int i = q0 + io;
  if (i >= a.S) return;
  float* dqr = a.dq + b * a.sdq.b + h * a.sdq.h + (long long)i * a.sdq.s;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const int d = c0 + 8 * c;
    if (d < a.hd) dqr[d] = dq[c] * a.scale;
  }
}

template <typename K>
cudaError_t launch_one(K kernel, dim3 grid, size_t bytes, const Args& a,
                       cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t tile = sizeof(float) * kT * (HD + 1);
  constexpr size_t sq = sizeof(float) * kT * (kT + 1);
  constexpr size_t stats = sizeof(float) * 2 * kT;
  const int n_t = (a.S + kT - 1) / kT;
  cudaError_t e = launch_one(lse_kernel<HD>, dim3(n_t, a.H, B), 2 * tile, a,
                             stream);
  if (e == cudaSuccess)
    e = launch_one(dkv_kernel<HD>, dim3(n_t, a.KH, B),
                   4 * tile + 2 * sq + stats, a, stream);
  if (e == cudaSuccess)
    e = launch_one(dq_kernel<HD>, dim3(n_t, a.H, B), 4 * tile + sq + stats,
                   a, stream);
  return (int)e;
}

}  // namespace

// q, o, dout, dq: (B, H, S, hd); k, v, dk, dv: (B, KH, S, hd); float32, a
// unit stride over hd.  strides: the 24 element strides over (B, heads, S)
// of q, k, v, o, dout, dq, dk, dv in that order.  lse, dsum: float32
// scratch of B * H * S each.  Writes dq, dk and dv.
extern "C" int flash_attention_bwd_launch(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, float* dq, float* dk, float* dv, float* lse,
    float* dsum, int B, int H, int KH, int S, int hd,
    const long long* strides, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || S <= 0 || hd <= 0 || hd > 128 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  Args a{q, k, v, o, dout, dq, dk, dv, lse, dsum, S, H, KH, hd,
         1.f / sqrtf((float)hd),
         {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
         {s[9], s[10], s[11]}, {s[12], s[13], s[14]}, {s[15], s[16], s[17]},
         {s[18], s[19], s[20]}, {s[21], s[22], s[23]}};
  cudaStream_t st = (cudaStream_t)stream;
  if (hd <= 32) return launch<32>(a, B, st);
  if (hd <= 64) return launch<64>(a, B, st);
  return launch<128>(a, B, st);
}
