// Mamba2 chunked SSD scan for Hopper (sm_90a) on the tensor cores: every
// extend of an ssm model (prompts, SpecReason verification passes,
// accepted steps).
//
// Replaces: src/repro/kernels/ssd_scan.py :: ssd_scan (the Pallas TPU kernel
// _ssd_kernel).  Same function: for each (batch, head) and each chunk of Q
// positions,
//   y_i    = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//            + exp(cum_i) C_i . state
//   state' = exp(cum_{Q-1}) state + sum_j exp(cum_{Q-1} - cum_j) dt_j x_j B_j^T
// with cum the inclusive cumulative sum of a * dt over the chunk, B and C
// of group h / (H / G), the state carried from chunk to chunk and emitted
// at the end.  x, B, C are float32 or bfloat16; dt, a, the initial and the
// final state float32; y is written in x's dtype.  The chunk length Q is a
// runtime argument from 1 to 128 and L must be a multiple of it (the
// caller pads with dt = 0, as the JAX package's apply_mamba does).
//
// What bounds it on this card: at mamba2-1.3b's widths (H = 64 heads of
// P = 64, N = 128, one group) a 2048-token prompt needs 2.7 G multiply-adds
// (5.4 GFLOP: the causal half of each chunk's Q x Q terms, C . B^T once for
// the group's 64 heads) against 68 MB of inputs and outputs, so it is bound
// by operations: 0.0328 ms for fp32-accurate products at 3xTF32's 495 / 3
// TFLOP/s.  The serving path's calls are mostly one chunk of 5 to 60
// positions, where a call is bound by latency and the host.
//
// What the design does about it: the TPU kernel walks the chunks in order
// with the state in VMEM.  Here the scan follows ssd_chunked's four steps
// (models/mamba2.py), in up to three launches on the caller's stream, so
// that the chunk axis spreads over blocks:
//  1. ssd_chunk_kernel, grid (B*H*P tiles + B*G*row tiles) x chunks.  A
//     state block owns (batch, head, 64 P columns, chunk): the chunk's
//     cumulative sum as a block-wide scan (kept in scratch `cum`, which the
//     other two launches read), and the chunk's own state contribution
//     dS^T = B^T . (dt x exp(cum_last - cum)), written to scratch `st`
//     (B, H, nc, P x N rounded up to 4).  A C.B^T block owns 16 rows of
//     one (batch, group, chunk)'s causal C . B^T and writes them to scratch
//     `cb` (B, G, nc, Q, Q rounded up to 4): the product is made once per
//     group, not per head.
//  2. ssd_pass_kernel (only with more than one chunk): per (batch, head),
//     one thread per four state elements walks the chunks, S <-
//     exp(cum_last) S + dS, writing each chunk's entering state over its
//     dS and the final state.  It is elementwise and moves the scratch
//     state twice (67 MB at L = 2048, part of it in the 50 MB L2).
//  3. ssd_scan_kernel, grid (B*H*P tiles) x chunks: y = diag(exp(cum)) C .
//     S_in^T + (C.B^T o exp(segsum)) . (dt x) for 128 rows x 64 columns,
//     the first product scaled after it is made, so that bf16 C stays
//     exact.  The segsum decay is selected to 0 above the diagonal (never
//     multiplied by a mask: exp there can overflow); the rows before a
//     slice's first column and a warp's slices past its rows' diagonal are
//     skipped.  y leaves through shared memory in 16-byte stores where P
//     allows.
//  With one chunk (most serving calls) the chunk launch writes the final
//  state itself and the pass is skipped: two launches.
//  * Operands reach shared memory in k slices of 32 through a two-stage
//    ring of raw tiles: 16-byte cp.async copies (zero-filled past the
//    edges) where every base and stride allows, element copies otherwise
//    (kVec).  The next slice's copies are in flight while a slice is
//    converted (decay, dt, the 3xTF32 split) into the tiles the warps
//    multiply from; B^T and C feed the products from their raw stage, in
//    padded rows.  Loads into registers instead stalled each warp on every
//    load (three times slower at L = 2048); warps specialised to copy or
//    to multiply, one block an SM, were slower than two blocks an SM that
//    do both.
//  * Products: mma.sync.m16n8k8 TF32 with fp32 accumulators (tf32_mma.cuh).
//    fp32 operands are split as 3xTF32 (lo.hi' + hi.hi' + hi.lo'); a bf16
//    operand is exact in TF32 and drops its lo product (B^T in step 1, C and
//    B in C.B^T).  The operand that every warp of a block reads (dt x and
//    S_in) is split once when it is converted and kept as quads (hi_k,
//    hi_{k+4}, lo_k, lo_{k+4}): one 16-byte load a B fragment, already in
//    the register order mma.sync takes.  A warp that holds the full eight
//    n-tiles (the mamba2 shapes' P tile of 64) runs a product loop with
//    that count fixed at compile time: a predicated mma.sync costs a
//    warp-synchronise of its own.
//  * 90 KB (chunk) and 106 KB (scan) of dynamic shared memory a block, two
//    blocks an SM (128 registers a thread); the wrapper allocates the
//    scratch, the kernels allocate nothing.
//  * Where the time goes (H100, L = 2048): PERF.md, from the device time of
//    each launch with the products, the copies or both compiled out
//    (launch/ssd_breakdown.py) against the card's mma.sync rate
//    (launch/mma_rate.py).
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

using namespace repro;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxQ = 128;  // longest chunk
constexpr int kMaxN = 256;
constexpr int kPT = 64;     // P columns a block owns
constexpr int kKS = 32;     // k slice staged in shared memory
constexpr int kNR = 128;    // state rows (N) a state block makes per pass
constexpr int kNT = 8;      // 8-column n-tiles a warp holds at most
// row strides, against bank conflicts of the fragment loads: fp32 rows read
// as (row gid, k tig) = 4 mod 32, as (k tig, row gid) = 8 mod 32 (bf16: 4
// and 8 words mod 32 as well); quads (16 bytes) read 8 lanes at a time as
// (k tig, column gid) = 2 mod 8, as (column gid, k tig) = 4 mod 8; y's
// staging rows = 4 mod 16 pairs
constexpr int kLdRow = kKS + 4;       // fp32 [row][k]
constexpr int kLdNR = kNR + 8;        // [k][row], the state block's raw B^T
constexpr int kLdXQ = kPT + 2;        // quads [k][column], dt x
constexpr int kLdSQ = kKS / 2 + 4;    // quads [column][k], S_in
constexpr int kLdY = kPT + 8;         // fp32 [row][column], y on its way out
// [row][k], the scan block's raw C: 16-byte rows
template <typename T>
__host__ __device__ constexpr int ld_c() {
  return sizeof(T) == 4 ? kKS + 4 : kKS + 8;
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Dynamic shared memory a block, in bytes: a ring of two raw stages (A:
// C, B^T or C.B^T rows, or a C.B^T block's C rows; B: x or S_in rows, or a
// C.B^T block's B rows; up to 4-byte elements), the converted tiles, then
// the per-position arrays.
constexpr int kRawA =
    4 * cmax(cmax(kMaxQ * ld_c<float>(), kKS * kLdNR), kMaxQ * kKS);
constexpr int kRawB = 4 * cmax(kKS * kPT, kMaxQ * kKS);
constexpr int kRing = 2 * (kRawA + kRawB);
constexpr int kChunkTiles =
    cmax(kKS / 2 * kLdXQ * 16,                       // state block
         16 * kLdRow * 4 + kMaxQ * kLdRow * 4);      // C.B^T block
constexpr int kScanTiles =
    cmax(kMaxQ * kLdRow * 4 + cmax(kKS / 2 * kLdXQ, kPT * kLdSQ) * 16,
         kMaxQ * kLdY * 4);
constexpr int kVecBytes = 3 * kMaxQ * 4 + kWarps * 4;
constexpr int kChunkSmem = kRing + kChunkTiles + kVecBytes;
constexpr int kScanSmem = kRing + kScanTiles + kVecBytes;

// Raw element bits: fp32 as uint32_t, bf16 as uint16_t.
template <typename T>
using Raw = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;
template <typename T>
__device__ __forceinline__ float to_f32(uint32_t v) {
  return __uint_as_float(sizeof(T) == 4 ? v : v << 16);
}
// an operand element as fp32: from a converted tile, or raw bits
__device__ __forceinline__ float val(float v) { return v; }
__device__ __forceinline__ float val(uint32_t v) { return __uint_as_float(v); }
__device__ __forceinline__ float val(uint16_t v) {
  return __uint_as_float((uint32_t)v << 16);
}
// four consecutive fp32 raw elements (16 bytes, aligned)
__device__ __forceinline__ float4 val4(const uint32_t* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  return make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                     __uint_as_float(u.z), __uint_as_float(u.w));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// the 3xTF32 quad of one B fragment element pair: (hi_k, hi_{k+4}, lo_k,
// lo_{k+4}), the two k of a thread in an m16n8k8 step, in one 16-byte load
__device__ __forceinline__ uint4 quad(float k0, float k4) {
  uint4 q;
  split_tf32(k0, q.x, q.z);
  split_tf32(k4, q.y, q.w);
  return q;
}

struct Args {
  const void *x, *b, *c;
  const float *dt, *a, *init;  // init may be null: a zero state
  void* y;
  float *fin, *cum, *cb, *st;  // st: null with one chunk
  int B, L, H, P, G, N, Q, nc, npt, nrf, ldq, vec_y;
  long long sp;  // a state's pitch in st: P * N rounded up to 4
  long long x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, b_sg, c_sb,
      c_sl, c_sg;
};

// Copies rows x kCols raw elements, row r from src + r * stride, to dst
// (row pitch kLd); rows >= nrows and columns >= ncols arrive as zero.
// kVec: 16-byte cp.async, every row start 16-byte aligned; else element
// loads and stores.
template <int kCols, int kLd, bool kVec, typename E>
__device__ __forceinline__ void copy_tile(E* dst, const E* src,
                                          long long stride, int rows,
                                          int nrows, int ncols) {
  if constexpr (kVec) {
    constexpr int kV = 16 / sizeof(E), kPer = kCols / kV;
    static_assert(kLd % kV == 0, "16-byte rows");
    for (int i = threadIdx.x; i < rows * kPer; i += kThreads) {
      const int r = i / kPer, c = i % kPer * kV;
      const int n = r < nrows ? max(0, min(kV, ncols - c)) : 0;
      cp_async16z(dst + r * kLd + c, n ? src + r * stride + c : src,
                  n * (int)sizeof(E));
    }
  } else {
    for (int i = threadIdx.x; i < rows * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      dst[r * kLd + c] = r < nrows && c < ncols ? src[r * stride + c] : E(0);
    }
  }
}

// Runs ns k slices: fetch(s) starts slice s's copies into raw stage s & 1,
// put(s) converts what needs converting into the tiles, mma(s) multiplies
// from the tiles and the raw stage.  Slice s + 1's copies are in flight
// while slice s is converted and multiplied.
template <typename Fetch, typename Put, typename Mma>
__device__ __forceinline__ void slices(int ns, Fetch fetch, Put put, Mma mma) {
  fetch(0);
  cp_async_commit();
  for (int s = 0; s < ns; ++s) {
    cp_async_wait_all();
    __syncthreads();  // raw s landed; every warp is done with slice s - 1
    if (s + 1 < ns) {
      fetch(s + 1);
      cp_async_commit();
    }
    put(s);
    __syncthreads();
    mma(s);
  }
  __syncthreads();  // the caller may reuse the tiles
}

// What one warp computes of a block's output: 16 rows (fragment rf) and
// nnt 8-column n-tiles from nt0 (nnt = 0: idle).  Warps go along rows
// first, as many as the nrf fragments need (a power of two), and the rest
// share the ntt n-tiles out along columns.
struct WarpTile {
  int rf, nt0, nnt;
};
__device__ __forceinline__ WarpTile warp_tile(int nrf, int ntt) {
  const int warp = threadIdx.x / 32;
  int wr = 1;
  while (wr < nrf) wr *= 2;
  const int wc = kWarps / wr, per = (ntt + wc - 1) / wc;
  WarpTile t;
  t.rf = warp % wr;
  t.nt0 = warp / wr * per;
  t.nnt = t.rf < nrf ? max(0, min(per, ntt - t.nt0)) : 0;
  return t;
}

// acc[u] += A . B over k_steps steps of 8, for the warp's 16 rows and its
// n-tiles u < nnt (kN > 0: nnt is kN, known here, so that no product is
// predicated).  A: fp32 or raw bits (TA), element (row r, k) at a[r * lda +
// k] (kAK false) or a[k * lda + r] (kAK true), a at the warp's row 0 and k
// 0.  B: float (split here), element (k, column n) at b[k * ldb + n] (kBK
// true) or b[n * ldb + k]; or uint4 quads (split once by the block), the
// quad of step s, lane tig and column n at b[(4 s + tig) * ldb + n] (kBK
// true) or b[n * ldb + 4 s + tig]; b at the warp's first column.  kSplitA
// / kSplitB: the operand is fp32 and takes its lo product.  The n-tiles go
// four at a time, each product over the four before the next, so that no
// mma waits on the one before it.
template <int kN, bool kAK, bool kBK, bool kSplitA, bool kSplitB,
          typename TA, typename TB>
__device__ __forceinline__ void warp_mma(float (&acc)[kNT][4], const TA* a,
                                         int lda, const TB* b, int ldb,
                                         int k_steps, int n_tiles) {
  constexpr int kHalf = 4;
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const int nnt = kN ? kN : n_tiles;
#pragma unroll
  for (int s = 0; s < kKS / 8; ++s) {
    if (s >= k_steps) break;
    const int k = 8 * s;
    float av[4];
    if constexpr (kAK) {
      const TA* ap = a + (k + tig) * lda + gid;
      av[0] = val(ap[0]);
      av[1] = val(ap[8]);
      av[2] = val(ap[4 * lda]);
      av[3] = val(ap[4 * lda + 8]);
    } else {
      const TA* ap = a + gid * lda + k + tig;
      av[0] = val(ap[0]);
      av[1] = val(ap[8 * lda]);
      av[2] = val(ap[4]);
      av[3] = val(ap[8 * lda + 4]);
    }
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kSplitA)
        split_tf32(av[e], ahi[e], alo[e]);
      else
        ahi[e] = __float_as_uint(av[e]);
    }
#pragma unroll
    for (int u0 = 0; u0 < kNT; u0 += kHalf) {
      if (u0 >= nnt) break;
      uint32_t bhi[kHalf][2], blo[kHalf][2];
#pragma unroll
      for (int u = 0; u < kHalf; ++u) {
        if (u0 + u >= nnt) break;
        const int n = 8 * (u0 + u) + gid;
        if constexpr (sizeof(TB) == 16) {
          const uint4 q = kBK ? b[(4 * s + tig) * ldb + n]
                              : b[n * ldb + 4 * s + tig];
          bhi[u][0] = q.x, bhi[u][1] = q.y, blo[u][0] = q.z, blo[u][1] = q.w;
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kk = k + tig + 4 * e;
            const TB v = kBK ? b[kk * ldb + n] : b[n * ldb + kk];
            if constexpr (kSplitB)
              split_tf32(v, bhi[u][e], blo[u][e]);
            else
              bhi[u][e] = __float_as_uint(v);
          }
        }
      }
      if constexpr (kSplitA) {
#pragma unroll
        for (int u = 0; u < kHalf; ++u)
          if (u0 + u < nnt) mma_tf32(acc[u0 + u], alo, bhi[u][0], bhi[u][1]);
      }
#pragma unroll
      for (int u = 0; u < kHalf; ++u)
        if (u0 + u < nnt) mma_tf32(acc[u0 + u], ahi, bhi[u][0], bhi[u][1]);
      if constexpr (kSplitB) {
#pragma unroll
        for (int u = 0; u < kHalf; ++u)
          if (u0 + u < nnt) mma_tf32(acc[u0 + u], ahi, blo[u][0], blo[u][1]);
      }
    }
  }
}

// warp_mma over the warp's n-tiles, with the tile count known at compile
// time where the warp holds the full kNT (the mamba2 shapes' P tile of 64)
template <bool kAK, bool kBK, bool kSplitA, bool kSplitB, typename TA,
          typename TB>
__device__ __forceinline__ void warp_mma_tiles(float (&acc)[kNT][4],
                                               const TA* a, int lda,
                                               const TB* b, int ldb,
                                               int k_steps, int nnt) {
  if (nnt == kNT)
    warp_mma<kNT, kAK, kBK, kSplitA, kSplitB>(acc, a, lda, b, ldb, k_steps,
                                              nnt);
  else
    warp_mma<0, kAK, kBK, kSplitA, kSplitB>(acc, a, lda, b, ldb, k_steps,
                                            nnt);
}

// cum[i] = sum_{j<=i} a_h dt_j and dts[i] = dt_j over the chunk at t0, i <
// Q: one warp scan per 32 positions, then each adds the warps before it.
__device__ __forceinline__ void chunk_cumsum(const Args& a, int bi, int h,
                                             int t0, float* cum, float* dts,
                                             float* wsum) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float d = tid < a.Q ? a.dt[bi * a.dt_sb + (long long)(t0 + tid) *
                                   a.dt_sl + h * a.dt_sh]
                            : 0.f;
  float v = a.a[h] * d;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const float up = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += up;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (tid < a.Q) {
    for (int w = 0; w < warp; ++w) v += wsum[w];
    cum[tid] = v;
    dts[tid] = d;
  }
  __syncthreads();
}

// The quads of dt x (times w) for a kKS x kPT raw x slice from row k0:
// rows k and k + 4 of each 8 (k = 8 s + t), column p, at q[(4 s + t) *
// kLdXQ + p]
template <typename R>
__device__ __forceinline__ void put_xq(uint4* q, const R* rx, const float* w,
                                       int k0, int Q) {
  for (int i = threadIdx.x; i < kKS / 2 * kPT; i += kThreads) {
    const int row = i / kPT, p = i % kPT, k = row / 4 * 8 + row % 4;
    const float w0 = k0 + k < Q ? w[k0 + k] : 0.f;
    const float w4 = k0 + k + 4 < Q ? w[k0 + k + 4] : 0.f;
    q[row * kLdXQ + p] =
        quad(val(rx[k * kPT + p]) * w0, val(rx[(k + 4) * kPT + p]) * w4);
  }
}

// Step 1, a state block: (batch row bi, head h, P tile pt, chunk ci).  Its
// slices walk the chunk's positions in steps of kKS for each pass of kNR
// state rows; B^T feeds the products from its raw stage.
template <typename T, bool kVec>
__device__ __forceinline__ void chunk_state(const Args& a, int bh, int pt,
                                            int ci, unsigned char* smem) {
  constexpr bool kF32 = sizeof(T) == 4;
  using R = Raw<T>;
  uint4* bs = reinterpret_cast<uint4*>(smem + kRing);  // dt x quads
  float* cum = reinterpret_cast<float*>(smem + kRing + kChunkTiles);
  float* dts = cum + kMaxQ;
  float* wdec = dts + kMaxQ;
  float* wsum = wdec + kMaxQ;
  const int tid = threadIdx.x, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int bi = bh / a.H, h = bh % a.H, g = h / (a.H / a.G);
  const int t0 = ci * a.Q, p0 = pt * kPT, np = min(kPT, a.P - p0);
  const int Q = a.Q, N = a.N;

  chunk_cumsum(a, bi, h, t0, cum, dts, wsum);
  const float last = cum[Q - 1];
  if (tid < Q) {
    if (pt == 0) a.cum[((long long)bh * a.nc + ci) * Q + tid] = cum[tid];
    wdec[tid] = dts[tid] * expf(last - cum[tid]);  // <= dt: cum falls
  }
  __syncthreads();

  const R* xb = static_cast<const R*>(a.x) + bi * a.x_sb + h * a.x_sh +
                (long long)t0 * a.x_sl + p0;
  const R* bb = static_cast<const R*>(a.b) + bi * a.b_sb + g * a.b_sg +
                (long long)t0 * a.b_sl;
  // with one chunk this block's output is the final state itself
  const long long pn = (long long)a.P * N;
  float* dst = a.nc == 1 ? a.fin + (long long)bh * pn + (long long)p0 * N
                         : a.st + ((long long)bh * a.nc + ci) * a.sp +
                               (long long)p0 * N;
  const float* base = a.nc == 1 && a.init
                          ? a.init + (long long)bh * pn + (long long)p0 * N
                          : nullptr;
  const float chunk_decay = expf(last);
  const int ntt = (np + 7) / 8, nks = (Q + kKS - 1) / kKS;
  const int npass = (N + kNR - 1) / kNR;
  auto raw_b = [&](int s) {  // raw B^T (kKS x kNR, pitch kLdNR)
    return reinterpret_cast<R*>(smem + (s & 1) * (kRawA + kRawB));
  };
  auto raw_x = [&](int s) {  // raw x (kKS x kPT)
    return reinterpret_cast<R*>(smem + (s & 1) * (kRawA + kRawB) + kRawA);
  };
  float acc[kNT][4];

  slices(
      npass * nks,
      [&](int s) {
        const int n0 = s / nks * kNR, k0 = s % nks * kKS;
        copy_tile<kNR, kLdNR, kVec>(raw_b(s),
                                    bb + (long long)k0 * a.b_sl + n0, a.b_sl,
                                    kKS, Q - k0, N - n0);
        copy_tile<kPT, kPT, kVec>(raw_x(s), xb + (long long)k0 * a.x_sl,
                                  a.x_sl, kKS, Q - k0, np);
      },
      [&](int s) { put_xq(bs, raw_x(s), wdec, s % nks * kKS, Q); },
      [&](int s) {
        const int n0 = s / nks * kNR, k0 = s % nks * kKS;
        const int nr = min(kNR, N - n0);
        const WarpTile wt = warp_tile((nr + 15) / 16, ntt);
        if (k0 == 0) {
#pragma unroll
          for (int u = 0; u < kNT; ++u)
            acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
        }
        if (wt.nnt > 0)
          warp_mma_tiles<true, true, kF32, true>(
              acc, raw_b(s) + 16 * wt.rf, kLdNR, bs + 8 * wt.nt0, kLdXQ,
              (min(kKS, Q - k0) + 7) / 8, wt.nnt);
        if (k0 + kKS < Q) return;
        // the pass's last slice: acc[u][e] is state row n, P column p.  Every
        // load of the initial state comes before the first store, so that
        // the loads are in flight together
        auto offset = [&](int u, int e) {
          const int n = n0 + 16 * wt.rf + gid + 8 * (e / 2);
          const int p = 8 * (wt.nt0 + u) + 2 * tig + e % 2;
          return n < N && p < np ? (long long)p * N + n : -1LL;
        };
        if (base) {
#pragma unroll
          for (int u = 0; u < kNT; ++u) {
            if (u >= wt.nnt) break;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const long long o = offset(u, e);
              if (o >= 0) acc[u][e] += chunk_decay * base[o];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kNT; ++u) {
          if (u >= wt.nnt) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const long long o = offset(u, e);
            if (o >= 0) dst[o] = acc[u][e];
          }
        }
      });
}

// Step 1, a C.B^T block: rows [16 f, 16 f + 16) of (batch, group, chunk)'s
// C . B^T, columns up to the diagonal, over N in slices of kKS.
template <typename T, bool kVec>
__device__ __forceinline__ void chunk_cb(const Args& a, int z, int ci,
                                         unsigned char* smem) {
  constexpr bool kF32 = sizeof(T) == 4;
  using R = Raw<T>;
  float* cs = reinterpret_cast<float*>(smem + kRing);  // C rows [16][k]
  float* bs = cs + 16 * kLdRow;                        // B rows [j][k]
  const int tid = threadIdx.x, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int bg = z / a.nrf, f = z % a.nrf, bi = bg / a.G, g = bg % a.G;
  const int Q = a.Q, N = a.N, t0 = ci * Q, r0 = 16 * f;
  const int ncols = min(r0 + 16, Q), ntt = (ncols + 7) / 8;
  const WarpTile wt = warp_tile(1, ntt);
  const R* cb0 = static_cast<const R*>(a.c) + bi * a.c_sb + g * a.c_sg +
                 (long long)(t0 + r0) * a.c_sl;
  const R* bb0 = static_cast<const R*>(a.b) + bi * a.b_sb + g * a.b_sg +
                 (long long)t0 * a.b_sl;
  auto raw_c = [&](int s) {  // raw C rows (16 x kKS), then B rows (kKS wide)
    return reinterpret_cast<R*>(smem + (s & 1) * (kRawA + kRawB));
  };
  auto raw_b = [&](int s) {
    return reinterpret_cast<R*>(smem + (s & 1) * (kRawA + kRawB) + kRawA);
  };
  float acc[kNT][4] = {};
  slices(
      (N + kKS - 1) / kKS,
      [&](int s) {
        const int n0 = s * kKS;
        copy_tile<kKS, kKS, kVec>(raw_c(s), cb0 + n0, a.c_sl, 16, Q - r0,
                                  N - n0);
        copy_tile<kKS, kKS, kVec>(raw_b(s), bb0 + n0, a.b_sl, 8 * ntt, ncols,
                                  N - n0);
      },
      [&](int s) {
        const R* rc = raw_c(s);
        for (int i = tid; i < 16 * kKS; i += kThreads)
          cs[i / kKS * kLdRow + i % kKS] = to_f32<T>(rc[i]);
        const R* rb = raw_b(s);
        for (int i = tid; i < 8 * ntt * kKS; i += kThreads)
          bs[i / kKS * kLdRow + i % kKS] = to_f32<T>(rb[i]);
      },
      [&](int s) {
        if (wt.nnt > 0)
          warp_mma<0, false, false, kF32, kF32>(
              acc, cs, kLdRow, bs + 8 * wt.nt0 * kLdRow, kLdRow,
              (min(kKS, N - s * kKS) + 7) / 8, wt.nnt);
      });
  float* out = a.cb + ((long long)bg * a.nc + ci) * Q * a.ldq;
#pragma unroll
  for (int u = 0; u < kNT; ++u) {
    if (u >= wt.nnt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + gid + 8 * (e / 2);
      const int j = 8 * (wt.nt0 + u) + 2 * tig + e % 2;
      if (i < Q && j < ncols) out[(long long)i * a.ldq + j] = acc[u][e];
    }
  }
}

// Step 1.  Block x of chunk x / per: per = B*H*npt state blocks, then
// B*G*nrf C.B^T blocks.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_state = a.B * a.H * a.npt, per = n_state + a.B * a.G * a.nrf;
  const int ci = blockIdx.x / per, x = blockIdx.x % per;
  if (x < n_state)
    chunk_state<T, kVec>(a, x / a.npt, x % a.npt, ci, smem);
  else
    chunk_cb<T, kVec>(a, x - n_state, ci, smem);
}

// Step 2.  Block x: (batch, head) x / per.  A thread walks four
// consecutive elements of its P x N state over the chunks: float4s of the
// scratch (pitch sp, a multiple of 4), the initial and the final state
// element by element (P x N need not split into float4s there).
__global__ void __launch_bounds__(kThreads, 2) ssd_pass_kernel(const Args a) {
  const long long pn = (long long)a.P * a.N, pv = a.sp / 4;
  const int per = (int)((pv + kThreads - 1) / kThreads);
  const int bh = blockIdx.x / per;
  const long long e = (long long)(blockIdx.x % per) * kThreads + threadIdx.x;
  if (e >= pv) return;
  const long long e0 = (long long)bh * pn + 4 * e;  // in init and fin
  const int ne = (int)min(4LL, pn - 4 * e);         // the rest is pitch
  float s[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (a.init && i < ne) s[i] = a.init[e0 + i];
  float4* st = reinterpret_cast<float4*>(a.st) + (long long)bh * a.nc * pv + e;
  const float* last = a.cum + (long long)bh * a.nc * a.Q + a.Q - 1;
  // kGroup chunks' loads in flight together, then their stores
  constexpr int kGroup = 16;
  for (int c0 = 0; c0 < a.nc; c0 += kGroup) {
    float4 d[kGroup];
    float decay[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (c0 + u < a.nc) {
        d[u] = st[(c0 + u) * pv];
        decay[u] = last[(long long)(c0 + u) * a.Q];
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (c0 + u < a.nc) {
        st[(c0 + u) * pv] = make_float4(s[0], s[1], s[2], s[3]);
        const float w = expf(decay[u]);
        s[0] = w * s[0] + d[u].x;
        s[1] = w * s[1] + d[u].y;
        s[2] = w * s[2] + d[u].z;
        s[3] = w * s[3] + d[u].w;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < ne) a.fin[e0 + i] = s[i];
}

// Step 3.  Block x of chunk x / per, per = B*H*npt: (batch, head, P tile).
// Its slices: with an entering state, N in steps of kKS (y = C . S_in^T,
// C fed from its raw stage), then, after y's rows are scaled by
// exp(cum), the chunk's positions in steps of kKS (y += scores . dt x).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) ssd_scan_kernel(const Args a) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kLdC = ld_c<T>();
  using R = Raw<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem + kRing);  // scores [row][k]
  // dt x or S_in quads
  uint4* bs = reinterpret_cast<uint4*>(smem + kRing + kMaxQ * kLdRow * 4);
  float* ys = as;  // y tile, after the products
  float* cum = reinterpret_cast<float*>(smem + kRing + kScanTiles);
  float* dts = cum + kMaxQ;
  float* ecum = dts + kMaxQ;
  const int tid = threadIdx.x, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int per = a.B * a.H * a.npt;
  const int ci = blockIdx.x / per, x = blockIdx.x % per;
  const int bh = x / a.npt, pt = x % a.npt;
  const int bi = bh / a.H, h = bh % a.H, g = h / (a.H / a.G);
  const int Q = a.Q, N = a.N, t0 = ci * Q, p0 = pt * kPT;
  const int np = min(kPT, a.P - p0);

  if (tid < Q) {
    const float c = a.cum[((long long)bh * a.nc + ci) * Q + tid];
    cum[tid] = c;
    ecum[tid] = expf(c);
    dts[tid] = a.dt[bi * a.dt_sb + (long long)(t0 + tid) * a.dt_sl +
                    h * a.dt_sh];
  }
  __syncthreads();

  const int nrf = (Q + 15) / 16, rows = 16 * nrf, ntt = (np + 7) / 8;
  const WarpTile wt = warp_tile(nrf, ntt);
  const float* cbb =
      a.cb + ((long long)(bi * a.G + g) * a.nc + ci) * Q * a.ldq;
  const R* xb = static_cast<const R*>(a.x) + bi * a.x_sb + h * a.x_sh +
                (long long)t0 * a.x_sl + p0;
  const R* cb0 = static_cast<const R*>(a.c) + bi * a.c_sb + g * a.c_sg +
                 (long long)t0 * a.c_sl;
  // S_in: the pass's entering state, or with one chunk the initial state
  // (none: zero, nothing to add)
  const float* s_in =
      a.nc == 1 ? (a.init ? a.init + (long long)bh * a.P * N : nullptr)
                : a.st + ((long long)bh * a.nc + ci) * a.sp;
  if (s_in) s_in += (long long)p0 * N;
  const int nn = s_in ? (N + kKS - 1) / kKS : 0, nq = (Q + kKS - 1) / kKS;
  auto raw_a = [&](int s) {  // C rows (pitch kLdC) or C.B^T rows (kKS)
    return smem + (s & 1) * (kRawA + kRawB);
  };
  auto raw_b = [&](int s) {  // S_in rows (kPT x kKS) or x rows (kKS x kPT)
    return smem + (s & 1) * (kRawA + kRawB) + kRawA;
  };
  float acc[kNT][4] = {};

  slices(
      nn + nq,
      [&](int s) {
        if (s < nn) {
          const int n0 = s * kKS;
          copy_tile<kKS, kLdC, kVec>(reinterpret_cast<R*>(raw_a(s)),
                                     cb0 + n0, a.c_sl, rows, Q, N - n0);
          copy_tile<kKS, kKS, kVec>(
              reinterpret_cast<uint32_t*>(raw_b(s)),
              reinterpret_cast<const uint32_t*>(s_in) + n0, N, kPT, np,
              N - n0);
        } else {
          // rows r < k0 see none of the slice's columns (j > r): not copied
          const int k0 = (s - nn) * kKS;
          copy_tile<kKS, kKS, true>(
              reinterpret_cast<uint32_t*>(raw_a(s)) + k0 * kKS,
              reinterpret_cast<const uint32_t*>(cbb) + k0 * a.ldq + k0, a.ldq,
              rows - k0, Q - k0, Q - k0);
          copy_tile<kPT, kPT, kVec>(reinterpret_cast<R*>(raw_b(s)),
                                    xb + (long long)k0 * a.x_sl, a.x_sl, kKS,
                                    Q - k0, np);
        }
      },
      [&](int s) {
        if (s < nn) {  // S_in's quads: column p, k = 8 s + t and k + 4
          const float* rb = reinterpret_cast<const float*>(raw_b(s));
          for (int i = tid; i < kPT * kKS / 2; i += kThreads) {
            const int p = i / (kKS / 2), st = i % (kKS / 2);
            const int k = st / 4 * 8 + st % 4;
            bs[p * kLdSQ + st] = quad(rb[p * kKS + k], rb[p * kKS + k + 4]);
          }
          return;
        }
        // scores: C.B^T exp(cum_i - cum_j), selected to 0 above the
        // diagonal (exp there can overflow); then dt x
        const int k0 = (s - nn) * kKS;
        const uint32_t* ra = reinterpret_cast<const uint32_t*>(raw_a(s));
        for (int i = tid + k0 * kKS / 4; i < rows * kKS / 4; i += kThreads) {
          const int r = 4 * i / kKS, j = k0 + 4 * i % kKS;
          const float4 v = val4(ra + 4 * i);
          const float vs[4] = {v.x, v.y, v.z, v.w};
          float o[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            o[u] = r < Q && j + u <= r ? vs[u] * expf(cum[r] - cum[j + u])
                                       : 0.f;
          *reinterpret_cast<float4*>(as + r * kLdRow + j - k0) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
        put_xq(bs, reinterpret_cast<const R*>(raw_b(s)), dts, k0, Q);
      },
      [&](int s) {
        if (wt.nnt == 0) return;
        if (s < nn) {
          const int n0 = s * kKS;
          warp_mma_tiles<false, false, kF32, true>(
              acc, reinterpret_cast<const R*>(raw_a(s)) + 16 * wt.rf * kLdC,
              kLdC, bs + 8 * wt.nt0 * kLdSQ, kLdSQ,
              (min(kKS, N - n0) + 7) / 8, wt.nnt);
          return;
        }
        const int k0 = (s - nn) * kKS;
        if (s == nn && nn > 0) {  // C . S_in^T rows times exp(cum)
          const int r = 16 * wt.rf + gid;
          const float e0 = r < Q ? ecum[r] : 0.f;
          const float e1 = r + 8 < Q ? ecum[r + 8] : 0.f;
#pragma unroll
          for (int u = 0; u < kNT; ++u) {
            acc[u][0] *= e0, acc[u][1] *= e0;
            acc[u][2] *= e1, acc[u][3] *= e1;
          }
        }
        // rows of fragment rf see j <= 16 rf + 15: the warp stops there
        const int steps = min((min(kKS, Q - k0) + 7) / 8,
                              (16 * wt.rf + 16 - k0 + 7) / 8);
        if (steps > 0)
          warp_mma_tiles<false, true, true, true>(
              acc, as + 16 * wt.rf * kLdRow, kLdRow, bs + 8 * wt.nt0, kLdXQ,
              steps, wt.nnt);
      });

  // y out through shared memory (the slices are done with it): whole
  // 16-byte vectors of a row where P allows (vec_y), else element by element
#pragma unroll
  for (int u = 0; u < kNT; ++u) {
    if (u >= wt.nnt) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 16 * wt.rf + gid + 8 * e;
      const int p = 8 * (wt.nt0 + u) + 2 * tig;
      *reinterpret_cast<float2*>(ys + r * kLdY + p) =
          make_float2(acc[u][2 * e], acc[u][2 * e + 1]);
    }
  }
  __syncthreads();
  T* yb = static_cast<T*>(a.y) + (((long long)bi * a.L + t0) * a.H + h) * a.P +
          p0;
  const long long y_sl = (long long)a.H * a.P;
  if (a.vec_y) {
    constexpr int kV = 16 / sizeof(T);
    const int nv = np / kV;
    for (int i = tid; i < Q * nv; i += kThreads) {
      const int r = i / nv, p = i % nv * kV;
      const float* src = ys + r * kLdY + p;
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(yb + r * y_sl + p) =
            *reinterpret_cast<const float4*>(src);
      } else {
        const float4 lo = *reinterpret_cast<const float4*>(src);
        const float4 hi = *reinterpret_cast<const float4*>(src + 4);
        *reinterpret_cast<uint4*>(yb + r * y_sl + p) =
            make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                       pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
      }
    }
  } else {
    for (int i = tid; i < Q * np; i += kThreads) {
      const int r = i / np, p = i % np;
      store(yb + r * y_sl + p, ys[r * kLdY + p]);
    }
  }
}

// Launches of one scan: grid blocks, in launch order (chunk, pass, scan);
// the pass has none with one chunk.
void grids(const Args& a, long long (&blocks)[3]) {
  blocks[0] = ((long long)a.B * a.H * a.npt + (long long)a.B * a.G * a.nrf) *
              a.nc;
  blocks[1] = a.nc > 1 ? (long long)a.B * a.H *
                             ((a.sp / 4 + kThreads - 1) / kThreads)
                       : 0;
  blocks[2] = (long long)a.B * a.H * a.npt * a.nc;
}

template <typename T, bool kVec>
int launch(const Args& a, cudaStream_t stream) {
  long long blocks[3];
  grids(a, blocks);
  for (long long n : blocks)
    if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem<ssd_chunk_kernel<T, kVec>>(kChunkSmem);
  if (e == cudaSuccess) e = allow_smem<ssd_scan_kernel<T, kVec>>(kScanSmem);
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_kernel<T, kVec>
      <<<(unsigned)blocks[0], kThreads, kChunkSmem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (blocks[1]) {
    ssd_pass_kernel<<<(unsigned)blocks[1], kThreads, 0, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ssd_scan_kernel<T, kVec>
      <<<(unsigned)blocks[2], kThreads, kScanSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

// out[6 k .. 6 k + 5] for launch k (chunk, pass, scan): grid blocks,
// threads a block, registers a thread, dynamic shared memory bytes, blocks
// an SM runs at once, local (spill) bytes a thread; out[18]: 1 where the
// copies take 16 bytes at a time (kVec).
template <typename T, bool kVec>
int plan(const Args& a, long long* out) {
  long long blocks[3];
  grids(a, blocks);
  const void* fns[3] = {(const void*)ssd_chunk_kernel<T, kVec>,
                        (const void*)ssd_pass_kernel,
                        (const void*)ssd_scan_kernel<T, kVec>};
  const int smem[3] = {kChunkSmem, 0, kScanSmem};
  cudaError_t e = allow_smem<ssd_chunk_kernel<T, kVec>>(kChunkSmem);
  if (e == cudaSuccess) e = allow_smem<ssd_scan_kernel<T, kVec>>(kScanSmem);
  for (int k = 0; k < 3 && e == cudaSuccess; ++k) {
    cudaFuncAttributes at;
    e = cudaFuncGetAttributes(&at, fns[k]);
    int per_sm = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fns[k],
                                                        kThreads, smem[k]);
    long long* o = out + 6 * k;
    o[0] = blocks[k];
    o[1] = kThreads;
    o[2] = at.numRegs;
    o[3] = smem[k];
    o[4] = per_sm;
    o[5] = (long long)at.localSizeBytes;
  }
  out[18] = kVec;
  return (int)e;
}

bool make_args(Args& a, int B, int L, int H, int P, int G, int N, int Q) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 ||
      N <= 0 || N > kMaxN || Q <= 0 || Q > kMaxQ || L % Q != 0)
    return false;
  a.B = B, a.L = L, a.H = H, a.P = P, a.G = G, a.N = N, a.Q = Q;
  a.nc = L / Q;
  a.npt = (P + kPT - 1) / kPT;
  a.nrf = (Q + 15) / 16;
  a.ldq = (Q + 3) / 4 * 4;
  a.sp = ((long long)P * N + 3) / 4 * 4;
  return true;
}

// A tensor's copies take 16 bytes at a time when its base and every stride
// between rows are whole 16-byte steps.
bool vec16(const void* p, std::initializer_list<long long> strides,
           int esize) {
  bool ok = reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (long long s : strides) ok = ok && s * esize % 16 == 0;
  return ok;
}

// Launches the scan, or with out non-null writes its plan (see plan) and
// launches nothing.
template <typename T>
int dispatch(const Args& a, cudaStream_t s, long long* out) {
  constexpr int es = sizeof(T);
  // the state rows (init with one chunk, else the scratch) are N floats
  const bool vec = vec16(a.x, {a.x_sb, a.x_sl, a.x_sh}, es) &&
                   vec16(a.b, {a.b_sb, a.b_sl, a.b_sg}, es) &&
                   vec16(a.c, {a.c_sb, a.c_sl, a.c_sg}, es) &&
                   vec16(a.nc == 1 ? a.init : a.st, {a.N}, 4);
  if (out) return vec ? plan<T, true>(a, out) : plan<T, false>(a, out);
  return vec ? launch<T, true>(a, s) : launch<T, false>(a, s);
}

}  // namespace

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16.  x: (B, L, H, P)
// with strides (x_sb, x_sl, x_sh, 1); dt: (B, L, H) float32 with strides
// (dt_sb, dt_sl, dt_sh); a: (H,) float32; b, c: (B, L, G, N) with strides
// (*_sb, *_sl, *_sg, 1); init (or null: zeros) and fin: (B, H, P, N)
// float32, contiguous; y: (B, L, H, P) contiguous.  1 <= Q <= 128, L % Q ==
// 0, H % G == 0, 1 <= N <= 256.  Float32 scratch, 16-byte aligned, nc = L
// / Q: cum B*H*nc*Q, cb B*G*nc*Q*ldq (ldq = Q rounded up to 4) and, when
// nc > 1, st B*H*nc*sp (sp = P*N rounded up to 4; else null).  With plan
// null the scan is launched on stream; else nothing is launched and plan
// receives 19 numbers: for each launch k (chunk, pass, scan) of this call,
// in plan[6 k ..], grid blocks (0: the pass with one chunk), threads,
// registers, dynamic shared memory bytes, blocks an SM runs at once and
// spill bytes; plan[18] 1 where the copies take 16 bytes at a time.
// Returns a CUDA error code.
extern "C" int ssd_scan_launch(
    int dtype, const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* init, void* y, void* fin, void* cum, void* cb,
    void* st, int B, int L, int H, int P, int G, int N, int Q, long long x_sb,
    long long x_sl, long long x_sh, long long dt_sb, long long dt_sl,
    long long dt_sh, long long b_sb, long long b_sl, long long b_sg,
    long long c_sb, long long c_sl, long long c_sg, void* stream,
    long long* plan) {
  Args r{};
  if (!make_args(r, B, L, H, P, G, N, Q) || (r.nc > 1 && !st))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {(const void*)cb, (const void*)st})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  r.x = x, r.b = b, r.c = c, r.y = y;
  r.dt = (const float*)dt, r.a = (const float*)a, r.init = (const float*)init;
  r.fin = (float*)fin, r.cum = (float*)cum, r.cb = (float*)cb;
  r.st = (float*)st;
  r.x_sb = x_sb, r.x_sl = x_sl, r.x_sh = x_sh;
  r.dt_sb = dt_sb, r.dt_sl = dt_sl, r.dt_sh = dt_sh;
  r.b_sb = b_sb, r.b_sl = b_sl, r.b_sg = b_sg;
  r.c_sb = c_sb, r.c_sl = c_sl, r.c_sg = c_sg;
  const int esize = dtype == 1 ? 2 : 4;
  r.vec_y = P % (16 / esize) == 0 &&
            reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(r, s, plan);
  if (dtype == 1) return dispatch<__nv_bfloat16>(r, s, plan);
  return (int)cudaErrorInvalidValue;
}
