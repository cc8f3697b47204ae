// Backward of causal GQA attention for Hopper (sm_90a) on the tensor cores:
// dQ, dK and dV of O = softmax(Q K^T / sqrt(hd)) V, the gradient of kernel
// #2 (flash_attention.cu) on the training forward.
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
// What the design does about it:
//  * Every product on the tensor cores: mma.sync.m16n8k8 TF32 with fp32
//    accumulators, fp32 operands as 3xTF32 (lo.hi' + hi.lo' + hi.hi'), the
//    plan of #2, #4 and #5, with one change: the split truncates
//    (split_fast: one integer and one float operation where split_tf32
//    takes five; 6% of the call at S = 2048).  The products' loop counts
//    are fixed at compile time and no mma.sync is predicated: a warp skips
//    a whole tile none of its rows sees and masks the rest in P.
//  * dQ, dK and dV summed a tile at a time (dot_tile): the tensor cores'
//    fp32 accumulation truncates, so one accumulator fed every mma.sync of
//    a walk lost an ulp of itself per step, and its error grew with S
//    (H100: 2.8e-5 at S = 256 to 4.6e-4 at 4096, minitron-4b's heads; a
//    round-toward-zero model of it gives the same growth,
//    tests/test_torch_kernels.py).  Each 32-row tile's products now go
//    into fresh fragments, added to the sums in fp32: 1.7e-5 to 3.0e-5
//    from S = 256 to 4096, 16x or more inside the tolerance of 1e-4 x
//    each gradient's largest magnitude (nearest: dK at S = 2048), for 4%
//    of the time at S = 2048 (PERF.md, section 6).
//  * Three launches on the caller's stream and no atomics, so two calls
//    give the same bits:
//    1. dq_kernel, a block per (64 query rows, head), 16 rows a warp:
//       D = rowsum(dO * O), then one walk over the key tiles at or before
//       its rows: S = Q K^T and dP = dO V^T in one k loop (eight
//       accumulators a warp), #2's online softmax of S (#2 keeps no
//       statistics), and dQ's accumulator += exp2(S - m) (dP - D) K,
//       rescaled as m grows the way #2 rescales O, so dQ = it / l at the
//       end.  Each row's base-2 logsumexp m + log2(l) and D go to scratch
//       for the dK/dV launch: the kernels make seven products, Q K^T and dP
//       twice each, dQ, dK and dV once.
//    2. dkv_kernel, a block per (64 keys, query head), 16 keys a warp: K
//       and V stay in shared memory while the query tiles at or after the
//       keys stream past.  S^T = K Q^T and dP^T = V dO^T with keys as
//       rows, so P^T and dS^T feed dV += P^T dO and dK += dS^T Q straight
//       from the accumulators: the k order of an 8-query step is permuted
//       (k = tig is query 2 tig, k = tig + 4 query 2 tig + 1) and dO's and
//       Q's rows are read in that order, as #2 feeds P . V.  With G = 1 it
//       writes dK and dV; with G > 1 each query head's block writes its
//       partial to scratch.
//    3. sum_kernel (G > 1 only): dK and dV of each kv head, the G partials
//       summed in head order.
//  * Balance: a dK/dV block walks the query tiles of one head, so the
//    longest walk is S / 32 tile steps (64 at S = 2048), where the block a
//    (key tile, kv head) before it walked G heads (192 at G = 3).  Both
//    grids are (H, B, tiles) with the tile axis slowest, heaviest tiles
//    first, so the last wave holds the short blocks.
//  * Operands: the rows a warp owns (Q and dO in dq, K and V in dkv) stay
//    in shared memory for the whole walk; the streamed tiles of 32 rows
//    come by 16-byte cp.async (element copies where a row or a stride is
//    not a multiple of 16 bytes) into one stage: at hd 128 a block takes
//    107 KB, so two blocks an SM overlap one's copies with the other's
//    products.  In the products over head_dim the k order of each
//    8-column step is permuted (k = tig is column 2 tig, k = tig + 4
//    column 2 tig + 1), so a lane's A and B elements of a step are one
//    8-byte load.  Row strides: HD + 8 floats for tiles read only along
//    head_dim (conflict-free 8-byte loads), HD + 4 for tiles also read
//    down their rows (K in dq, Q and dO in dkv: conflict-free column
//    reads, two-way conflicts on the 8-byte loads).  #5's pre-split
//    16-byte B quads would take each streamed tile twice over in each of
//    two layouts, which at hd 128 does not fit beside the resident tiles
//    at two blocks an SM.  Blocks of 8 warps (128 rows) with the streamed
//    tiles in two stages, one block an SM, measured 3% slower at S = 2048
//    and 30% at S = 256 (PERF.md, section 6).  head_dim is padded to 32,
//    64 or 128 with zeros.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

#include "tf32_mma.cuh"

namespace {

using namespace repro;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows of a dq block, keys of a dkv
constexpr int kStep = 32;           // rows of a streamed tile
constexpr int kSumThreads = 256;
constexpr float kNeg = -1e30f;

// row strides in floats: tiles read only along head_dim, and tiles also
// read down their rows
template <int HD>
__host__ __device__ constexpr int lda() {
  return HD + 8;
}
template <int HD>
__host__ __device__ constexpr int ldb() {
  return HD + 4;
}

// dynamic shared memory of a dq block: Q, dO (kRows x lda), K (kStep x
// ldb), V (kStep x lda), D of its rows
template <int HD>
__host__ __device__ constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kRows * lda<HD>() + kStep * ldb<HD>() +
                          kStep * lda<HD>() + kRows);
}
// of a dkv block: K, V (kRows x lda), Q, dO (kStep x ldb), lse and D of
// the tile's queries
template <int HD>
__host__ __device__ constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * kRows * lda<HD>() + 2 * kStep * ldb<HD>() +
                          2 * kStep);
}

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
  float* lse;   // (B, H, S) scratch: base-2 logsumexp of the scaled scores
  float* dsum;  // (B, H, S) scratch: D = rowsum(dO * O)
  float* part;  // (2, G, B, KH, S, hd) scratch, G > 1: dK, then dV partials
  int B, S, H, KH, hd;
  float scale;       // 1 / sqrt(hd)
  float scale_log2;  // log2(e) / sqrt(hd)
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// x = hi + lo exactly, hi being x with its low 13 bits cleared (TF32 by
// truncation) and lo the rest, passed with all its bits: mma.sync reads a
// TF32 operand's top 19 bits, so lo is truncated there (|error| < 2^-20
// |x|).  One integer and one float operation where tf32_mma.cuh's
// split_tf32 (round to nearest, both parts) takes four and one.
__device__ __forceinline__ void split_fast(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [row0, row0 + n) of an (S, hd) slice with row stride rs into dst
// (row stride ld, HD columns), zeros past S and past hd.  kVec: 16-byte
// cp.async copies, which the caller commits and waits for; else element
// copies.
template <int HD, bool kVec>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long rs, int row0, int n, int S,
                                      int hd) {
  constexpr int kChunks = HD / 4;
  for (int i = threadIdx.x; i < n * kChunks; i += blockDim.x) {
    const int r = i / kChunks, d = i % kChunks * 4, row = row0 + r;
    float* dp = dst + r * ld + d;
    if constexpr (kVec) {
      const bool in = row < S && d < hd;
      cp_async16z(dp, in ? src + (long long)row * rs + d : src, in ? 16 : 0);
    } else {
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (row < S) {
        const float* sp = src + (long long)row * rs;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < hd) x[e] = sp[d + e];
      }
      *reinterpret_cast<float4*>(dp) = make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

// c0 += A0 . B0^T and c1 += A1 . B1^T over HD columns: A the warp's 16
// rows at a (row stride la), B NT x 8 rows at b (row stride lb).
// The k order of each 8-column step is permuted (k = tig is column 2 tig,
// k = tig + 4 column 2 tig + 1) in A and B alike, so each lane reads a
// fragment's two k values with one 8-byte load.  fp32 operands as 3xTF32;
// the three products of a step run over every accumulator before the
// next, so that no mma waits on the one before it.
template <int HD, int NT>
__device__ __forceinline__ void dots(float (&c0)[NT][4], const float* a0,
                                     int la0, const float* b0, int lb0,
                                     float (&c1)[NT][4], const float* a1,
                                     int la1, const float* b1, int lb1) {
  constexpr int kP = 2;
  const int lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
  const float* ap[2] = {a0 + gid * la0 + 2 * tig, a1 + gid * la1 + 2 * tig};
  const float* bp[2] = {b0 + gid * lb0 + 2 * tig, b1 + gid * lb1 + 2 * tig};
  const int la[2] = {la0, la1}, lb[2] = {lb0, lb1};
#pragma unroll
  for (int kk = 0; kk < HD; kk += 8) {
    uint32_t ah[kP][4], al[kP][4], bh[kP][NT][2], bl[kP][NT][2];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const float2 r0 = ld2(ap[p] + kk), r1 = ld2(ap[p] + 8 * la[p] + kk);
      const float av[4] = {r0.x, r1.x, r0.y, r1.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_fast(av[e], ah[p][e], al[p][e]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 r = ld2(bp[p] + 8 * nt * lb[p] + kk);
        split_fast(r.x, bh[p][nt][0], bl[p][nt][0]);
        split_fast(r.y, bh[p][nt][1], bl[p][nt][1]);
      }
    }
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32(p ? c1[nt] : c0[nt], al[p], bh[p][nt][0], bh[p][nt][1]);
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32(p ? c1[nt] : c0[nt], ah[p], bl[p][nt][0], bl[p][nt][1]);
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32(p ? c1[nt] : c0[nt], ah[p], bh[p][nt][0], bh[p][nt][1]);
  }
}

// acc = alpha acc + C . X over one streamed tile: C the accumulator
// fragments c[kt] of the warp's 16 x kStep product (rows gid, gid + 8;
// columns kt * 8 + 2 tig, + 1), X kStep rows at x (row stride lx) and HD
// columns; each 8-row step's k order is the fragment's (k = tig is row
// 2 tig, k = tig + 4 row 2 tig + 1).  The tile's products go into fresh
// fragments, kND column slices at a time, each product over all kND before
// the next, and each fragment joins acc by one fp32 add (an FMA with
// kScale).  The tensor cores' accumulation truncates: a running
// accumulator fed every mma.sync loses up to an ulp of itself at each of
// a walk's 3 S / 8 of them, which grows with S; here a tile's twelve land
// in a fragment of the tile's size and acc is rounded once a tile.
template <int HD, bool kScale>
__device__ __forceinline__ void dot_tile(float (&acc)[HD / 8][4],
                                         const float (&c)[kStep / 8][4],
                                         const float* x, int lx,
                                         const float (&alpha)[2]) {
  constexpr int kND = HD / 8 < 4 ? HD / 8 : 4;
  const int lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
  const float* xr = x + 2 * tig * lx + gid;
#pragma unroll
  for (int n0 = 0; n0 < HD / 8; n0 += kND) {
    float t[kND][4];
#pragma unroll
    for (int u = 0; u < kND; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[u][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < kStep / 8; ++kt) {
      const float av[4] = {c[kt][0], c[kt][2], c[kt][1], c[kt][3]};
      uint32_t ah[4], al[4], bh[kND][2], bl[kND][2];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_fast(av[e], ah[e], al[e]);
#pragma unroll
      for (int u = 0; u < kND; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          split_fast(xr[(kt * 8 + e) * lx + (n0 + u) * 8], bh[u][e],
                     bl[u][e]);
#pragma unroll
      for (int u = 0; u < kND; ++u) mma_tf32(t[u], al, bh[u][0], bh[u][1]);
#pragma unroll
      for (int u = 0; u < kND; ++u) mma_tf32(t[u], ah, bl[u][0], bl[u][1]);
#pragma unroll
      for (int u = 0; u < kND; ++u) mma_tf32(t[u], ah, bh[u][0], bh[u][1]);
    }
#pragma unroll
    for (int u = 0; u < kND; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n0 + u][e] = kScale ? fmaf(acc[n0 + u][e], alpha[e >> 1], t[u][e])
                                : acc[n0 + u][e] + t[u][e];
  }
}

// 1. grid (H, B, query tiles), blockIdx.z = last tile first: dQ of 64
//    query rows, and their D and logsumexp into scratch
template <int HD, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) dq_kernel(const Args a) {
  constexpr int LA = lda<HD>(), LB = ldb<HD>();
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [kRows][LA]
  float* dos = qs + kRows * LA;    // [kRows][LA]
  float* ks = dos + kRows * LA;    // [kStep][LB]
  float* vs = ks + kStep * LB;     // [kStep][LA]
  float* dsum = vs + kStep * LA;   // [kRows]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (int)(gridDim.z - 1 - blockIdx.z) * kRows;
  const int kh = h / (a.H / a.KH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const float* q = a.q + b * a.sq.b + h * a.sq.h;
  const float* dout = a.dout + b * a.sdo.b + h * a.sdo.h;
  const float* o = a.o + b * a.so.b + h * a.so.h;
  const float* k = a.k + b * a.sk.b + kh * a.sk.h;
  const float* v = a.v + b * a.sv.b + kh * a.sv.h;
  const long long stat = ((long long)b * a.H + h) * a.S;

  stage<HD, kVec>(qs, LA, q, a.sq.s, q0, kRows, a.S, a.hd);
  stage<HD, kVec>(dos, LA, dout, a.sdo.s, q0, kRows, a.S, a.hd);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's rows: [wr0, wr0 + 16); this lane's: gid and gid + 8
  const int wr0 = q0 + 16 * warp;
  const bool live = wr0 < a.S;
  const int rows[2] = {wr0 + gid, wr0 + gid + 8};
  for (int r = 0; r < 16; ++r) {
    const int i = wr0 + r;
    float x = 0.f;
    if (i < a.S) {
      const float* orow = o + (long long)i * a.so.s;
      for (int d = lane; d < a.hd; d += 32)
        x = fmaf(dos[(16 * warp + r) * LA + d], orow[d], x);
      x = warp_sum(x);
      if (lane == 0) a.dsum[stat + i] = x;
    }
    if (lane == 0) dsum[16 * warp + r] = x;
  }
  __syncwarp();
  const float dd[2] = {dsum[16 * warp + gid], dsum[16 * warp + gid + 8]};

  const int key_end = min(a.S, q0 + kRows);
  const float* qw = qs + 16 * warp * LA;
  const float* dow = dos + 16 * warp * LA;

  // one walk over the key tiles at or before the rows: the online softmax
  // of #2 (m and l of each row's scaled scores, base 2) with dQ's
  // accumulator rescaled as m grows, as #2 rescales O: acc = sum over keys
  // of exp2(s - m) (dP - D) K, so dQ = acc / l
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  for (int k0 = 0; k0 < key_end; k0 += kStep) {
    __syncthreads();
    stage<HD, kVec>(ks, LB, k, a.sk.s, k0, kStep, a.S, a.hd);
    stage<HD, kVec>(vs, LA, v, a.sv.s, k0, kStep, a.S, a.hd);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (!live || k0 > wr0 + 15) continue;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    dots<HD, 4>(s, qw, LA, ks, LB, dp, dow, LA, vs, LA);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * tig + (e & 1), i = rows[e >> 1];
        const bool ok = key <= i && i < a.S;
        s[nt][e] = ok ? s[nt][e] * a.scale_log2 : kNeg;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      l[r] *= alpha[r];
      m[r] = m_new;
    }
    // s becomes exp2(s - m) (dP - D), dS before the division by l
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = s[nt][e] > 0.5f * kNeg ? exp2f(s[nt][e] - m[r]) : 0.f;
        l[r] += p;
        s[nt][e] = p * (dp[nt][e] - dd[r]);
      }
    dot_tile<HD, true>(acc, s, ks, LB, alpha);
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = a.scale / (l[r] == 0.f ? 1.f : l[r]);
    if (live && tig == 0 && rows[r] < a.S)
      a.lse[stat + rows[r]] = m[r] + log2f(l[r]);
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= a.S) continue;
    float* dqr = a.dq + b * a.sdq.b + h * a.sdq.h +
                 (long long)rows[r] * a.sdq.s;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = nd * 8 + 2 * tig + e;
        if (d < a.hd) dqr[d] = acc[nd][2 * r + e] * inv[r];
      }
  }
}

// 2. grid (H, B, key tiles), blockIdx.z = first tile first: dK and dV of
//    64 keys from the query tiles of head blockIdx.x at or after them
template <int HD, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) dkv_kernel(const Args a) {
  constexpr int LA = lda<HD>(), LB = ldb<HD>();
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                // [kRows][LA]
  float* vs = ks + kRows * LA;     // [kRows][LA]
  float* qs = vs + kRows * LA;     // [kStep][LB]
  float* dos = qs + kStep * LB;    // [kStep][LB]
  float* lse = dos + kStep * LB;   // [kStep]
  float* dsum = lse + kStep;       // [kStep]

  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kRows;
  const int G = a.H / a.KH, kh = h / G, g = h % G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const float* q = a.q + b * a.sq.b + h * a.sq.h;
  const float* dout = a.dout + b * a.sdo.b + h * a.sdo.h;
  const long long stat = ((long long)b * a.H + h) * a.S;

  stage<HD, kVec>(ks, LA, a.k + b * a.sk.b + kh * a.sk.h, a.sk.s, k0, kRows,
                  a.S, a.hd);
  stage<HD, kVec>(vs, LA, a.v + b * a.sv.b + kh * a.sv.h, a.sv.s, k0, kRows,
                  a.S, a.hd);

  // this warp's keys: [wk0, wk0 + 16); this lane's: gid and gid + 8
  const int wk0 = k0 + 16 * warp;
  const bool live = wk0 < a.S;
  const int keys[2] = {wk0 + gid, wk0 + gid + 8};
  const float* kw = ks + 16 * warp * LA;
  const float* vw = vs + 16 * warp * LA;
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

  for (int q0 = k0; q0 < a.S; q0 += kStep) {
    __syncthreads();
    stage<HD, kVec>(qs, LB, q, a.sq.s, q0, kStep, a.S, a.hd);
    stage<HD, kVec>(dos, LB, dout, a.sdo.s, q0, kStep, a.S, a.hd);
    if (tid < kStep) {
      const int i = q0 + tid;
      lse[tid] = i < a.S ? a.lse[stat + i] : 0.f;
      dsum[tid] = i < a.S ? a.dsum[stat + i] : 0.f;
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (!live || q0 + kStep - 1 < wk0) continue;
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
    dots<HD, 4>(st, kw, LA, qs, LB, dpt, vw, LA, dos, LB);
    // st becomes P^T, dpt dS^T = P^T (dP^T - D)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * tig + (e & 1), i = q0 + c;
        const bool ok = keys[e >> 1] <= i && i < a.S;
        const float p =
            ok ? exp2f(st[nt][e] * a.scale_log2 - lse[c]) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - dsum[c]);
      }
    const float one[2] = {1.f, 1.f};
    dot_tile<HD, false>(dv, st, dos, LB, one);
    dot_tile<HD, false>(dk, dpt, qs, LB, one);
  }

  if (!live) return;
  const long long n = (long long)a.B * a.KH * a.S * a.hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = keys[r];
    if (j >= a.S) continue;
    float *dkr, *dvr;
    if (G == 1) {
      dkr = a.dk + b * a.sdk.b + kh * a.sdk.h + (long long)j * a.sdk.s;
      dvr = a.dv + b * a.sdv.b + kh * a.sdv.h + (long long)j * a.sdv.s;
    } else {
      const long long e = (((long long)b * a.KH + kh) * a.S + j) * a.hd;
      dkr = a.part + g * n + e;
      dvr = a.part + (G + g) * n + e;
    }
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = nd * 8 + 2 * tig + e;
        if (d < a.hd) {
          dkr[d] = dk[nd][2 * r + e] * a.scale;
          dvr[d] = dv[nd][2 * r + e];
        }
      }
  }
}

// 3. G > 1: dK and dV, each element the sum of its G partials in head
//    order
__global__ void __launch_bounds__(kSumThreads) sum_kernel(const Args a) {
  const int G = a.H / a.KH;
  const long long n = (long long)a.B * a.KH * a.S * a.hd;
  for (long long e = (long long)blockIdx.x * kSumThreads + threadIdx.x;
       e < n; e += (long long)gridDim.x * kSumThreads) {
    float sk = 0.f, sv = 0.f;
    for (int g = 0; g < G; ++g) {
      sk += a.part[g * n + e];
      sv += a.part[(G + g) * n + e];
    }
    const int d = (int)(e % a.hd);
    const long long row = e / a.hd;
    const int j = (int)(row % a.S);
    const long long bk = row / a.S;
    const int kh = (int)(bk % a.KH), b = (int)(bk / a.KH);
    a.dk[b * a.sdk.b + kh * a.sdk.h + (long long)j * a.sdk.s + d] = sk;
    a.dv[b * a.sdv.b + kh * a.sdv.h + (long long)j * a.sdv.s + d] = sv;
  }
}

// the launch plan the caller passes (tile_plan.bwd_launch): tiles of kRows
// rows (the z extent of both grids), threads of a dq and a dkv block,
// their dynamic shared memory bytes, blocks and threads of sum_kernel
struct Plan {
  int tiles, threads, dq_smem, dkv_smem, sum_blocks, sum_threads;
};

// whether the plan is one these kernels run: the block shape they are
// compiled for, their shared memory layout, tiles that cover S once
template <int HD>
bool runs(const Plan& p, const Args& a) {
  return p.threads == kThreads && p.sum_threads == kSumThreads &&
         p.dq_smem == (int)dq_smem<HD>() && p.dkv_smem == (int)dkv_smem<HD>() &&
         (long long)p.tiles * kRows >= a.S &&
         (long long)(p.tiles - 1) * kRows < a.S && p.tiles <= 65535 &&
         (a.H == a.KH || p.sum_blocks > 0);
}

template <int HD, bool kVec>
int launch(const Args& a, const Plan& p, cudaStream_t stream) {
  cudaError_t e = allow_smem<dq_kernel<HD, kVec>>(p.dq_smem);
  if (e == cudaSuccess) e = allow_smem<dkv_kernel<HD, kVec>>(p.dkv_smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.H, a.B, p.tiles);
  dq_kernel<HD, kVec><<<grid, p.threads, p.dq_smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkv_kernel<HD, kVec><<<grid, p.threads, p.dkv_smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.H == a.KH) return (int)e;
  sum_kernel<<<p.sum_blocks, p.sum_threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch_vec(const Args& a, const Plan& p, cudaStream_t stream) {
  if (!runs<HD>(p, a)) return (int)cudaErrorInvalidValue;
  bool vec = a.hd % 4 == 0;
  for (const void* q : {(const void*)a.q, (const void*)a.k,
                        (const void*)a.v, (const void*)a.dout})
    vec = vec && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  for (const Strides& s : {a.sq, a.sk, a.sv, a.sdo})
    vec = vec && s.b % 4 == 0 && s.h % 4 == 0 && s.s % 4 == 0;
  return vec ? launch<HD, true>(a, p, stream)
             : launch<HD, false>(a, p, stream);
}

}  // namespace

// q, o, dout, dq: (B, H, S, hd); k, v, dk, dv: (B, KH, S, hd); float32, a
// unit stride over hd.  strides: the 24 element strides over (B, heads, S)
// of q, k, v, o, dout, dq, dk, dv in that order.  lse, dsum: float32
// scratch of B * H * S each; part: float32 scratch of 2 * B * H * S * hd
// when H > KH (else unused).  plan: the six ints of Plan, from
// tile_plan.bwd_launch; a plan these kernels do not run is refused.
// Writes dq, dk and dv.
extern "C" int flash_attention_bwd_launch(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, float* dq, float* dk, float* dv, float* lse,
    float* dsum, float* part, int B, int H, int KH, int S, int hd,
    const long long* strides, const int* plan, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || S <= 0 || hd <= 0 || hd > 128 ||
      B > 65535 || (H > KH && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const float scale = 1.f / sqrtf((float)hd);
  const Args a{q, k, v, o, dout, dq, dk, dv, lse, dsum, part, B, S, H, KH,
               hd, scale, 1.4426950408889634f * scale,
               {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
               {s[9], s[10], s[11]}, {s[12], s[13], s[14]},
               {s[15], s[16], s[17]}, {s[18], s[19], s[20]},
               {s[21], s[22], s[23]}};
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  cudaStream_t st = (cudaStream_t)stream;
  if (hd <= 32) return dispatch_vec<32>(a, p, st);
  if (hd <= 64) return dispatch_vec<64>(a, p, st);
  return dispatch_vec<128>(a, p, st);
}
