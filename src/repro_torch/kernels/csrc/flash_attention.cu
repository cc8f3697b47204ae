// Causal GQA flash attention for Hopper (sm_90a): prompt prefill, step
// extends and verification passes.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention (the
// Pallas TPU kernel _flash_kernel).  Query head h reads kv head h / G.  The
// TPU kernel attends S queries from position 0 over S keys, S a multiple of
// its 128-row block.  The port's prefill writes S new keys at offset `start`
// of a cache of capacity C and attends each query start + i over the cache,
// so this kernel also takes `q_offset` (absolute position of query 0),
// `kv_len` (keys j >= kv_len are invisible) and a sliding `window`, and
// masks ragged edges itself: S is an engine bucket from 4 to 256.  Query i
// sees key j iff j < kv_len and, when causal, j <= q_offset + i and
// (window > 0) j > q_offset + i - window.  With q_offset = 0 and
// kv_len = S it is the TPU kernel's function.
//
// What bounds it on this card: at the port's shapes (S <= 256 queries over a
// few hundred keys, head_dim 28 or 32) each launch moves a few hundred KB
// and does a few MFLOP, so it is bound by latency; at long prompts it is
// bound by operations, and this first version runs them on CUDA cores in
// fp32, with every multiply-add reading two shared-memory words.
//
// What the design does about it:
//  * One block per (16-query tile, query head, row).  The TPU grid's
//    sequential kv axis becomes a loop inside the block over 32-key tiles
//    staged in shared memory; tiles wholly above the causal diagonal, below
//    the window or past kv_len are never loaded, so a short extend at a
//    large offset reads only the keys it can see.
//  * Eight threads share a query row: each scores four keys of the tile
//    and owns hd / 8 output dims, and the row's max and sum are combined
//    with three warp shuffles (online softmax, fp32).
//  * head_dim up to 128 is padded to 32, 64 or 128 with bounds checks
//    (BASE's 28 is not a power of two); loads are scalar per element because
//    bf16 rows of 56 bytes are not 16-byte aligned; shared rows are padded
//    by one word against bank conflicts.
//  * q, k, v and out are read and written through element strides with a
//    unit stride over hd, so the caller passes permuted views of its
//    (B, S, H, hd) activations and (B, C, K, hd) caches without copies.
//  * Tensor cores (wgmma over bf16 tiles) are later work.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kRows = 16;               // query rows per block
constexpr int kTpr = 8;                 // threads per query row
constexpr int kThreads = kRows * kTpr;  // 128
constexpr int kTile = 32;               // keys per shared-memory tile
constexpr int kKpt = kTile / kTpr;      // keys scored per thread
constexpr float kNeg = -1e30f;          // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// max / sum over the kTpr consecutive lanes that share a query row
__device__ __forceinline__ float row_max(float x) {
  for (int o = kTpr / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = kTpr / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffff, x, o);
  return x;
}

// grid (ceil(S / kRows), H, B)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int KH,
             int S, int hd, int q_offset, int kv_len, int window, int causal,
             long long q_sb, long long q_sh, long long q_ss, long long k_sb,
             long long k_sh, long long k_ss, long long v_sb, long long v_sh,
             long long v_ss, long long o_sb, long long o_sh, long long o_ss,
             float scale) {
  constexpr int kDpt = HD / kTpr;  // output dims per thread
  __shared__ float qs[kRows][HD + 1];
  __shared__ float ks[kTile][HD + 1];
  __shared__ float vs[kTile][HD + 1];
  __shared__ float ps[kRows][kTile + 1];

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, r = tid / kTpr, sub = tid % kTpr;
  const int row = q0 + r;
  const bool active = row < S;
  const int pos = q_offset + row;  // absolute position of this query

  for (int i = tid; i < kRows * hd; i += kThreads) {
    const int rr = i / hd, d = i % hd;
    qs[rr][d] = q0 + rr < S
                    ? to_f32(q[b * q_sb + h * q_sh + (long long)(q0 + rr) * q_ss + d]) * scale
                    : 0.f;
  }

  // keys this tile of queries can see
  const int last = min(q0 + kRows, S) - 1;
  int hi = kv_len;
  int lo = 0;
  if (causal) {
    hi = min(hi, q_offset + last + 1);
    if (window > 0) lo = max(0, q_offset + q0 - window + 1);
  }
  lo = lo / kTile * kTile;

  float m = kNeg, l = 0.f;
  float acc[kDpt];
#pragma unroll
  for (int u = 0; u < kDpt; ++u) acc[u] = 0.f;
  __syncthreads();

  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;
  for (int k0 = lo; k0 < hi; k0 += kTile) {
    const int n = min(kTile, hi - k0);
    for (int i = tid; i < n * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      ks[j][d] = to_f32(kb[(long long)(k0 + j) * k_ss + d]);
      vs[j][d] = to_f32(vb[(long long)(k0 + j) * v_ss + d]);
    }
    __syncthreads();

    float s[kKpt];
    bool ok[kKpt];
    float mx = kNeg;
#pragma unroll
    for (int t = 0; t < kKpt; ++t) {
      const int j = sub + kTpr * t, key = k0 + j;
      ok[t] = active && j < n && (!causal || key <= pos) &&
              (!causal || window <= 0 || key > pos - window);
      s[t] = 0.f;
      if (ok[t]) {
        for (int d = 0; d < hd; ++d) s[t] += qs[r][d] * ks[j][d];
        mx = fmaxf(mx, s[t]);
      }
    }
    // every lane runs both shuffles: rows of one warp may differ in whether
    // they see any key of this tile (mx == kNeg when they see none)
    mx = row_max(mx);
    const float m_new = mx == kNeg ? m : fmaxf(m, mx);
    const float alpha = mx == kNeg ? 1.f : expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kKpt; ++t) {
      s[t] = ok[t] ? expf(s[t] - m_new) : 0.f;
      sum += s[t];
    }
    l = l * alpha + row_sum(sum);
    m = m_new;
#pragma unroll
    for (int t = 0; t < kKpt; ++t) ps[r][sub + kTpr * t] = s[t];
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kDpt; ++u) {
      const int d = sub + kTpr * u;
      if (d < hd) {
        float o = acc[u] * alpha;
        for (int j = 0; j < n; ++j) o += ps[r][j] * vs[j][d];
        acc[u] = o;
      }
    }
    __syncthreads();
  }

  if (active) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    T* ob = out + b * o_sb + h * o_sh + (long long)row * o_ss;
#pragma unroll
    for (int u = 0; u < kDpt; ++u) {
      const int d = sub + kTpr * u;
      if (d < hd) store(ob + d, acc[u] * inv);
    }
  }
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* out, int B,
                int H, int KH, int S, int hd, int q_offset, int kv_len,
                int window, int causal, long long q_sb, long long q_sh,
                long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                long long v_sb, long long v_sh, long long v_ss, long long o_sb,
                long long o_sh, long long o_ss, cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  const float scale = 1.f / sqrtf((float)hd);
#define REPRO_FLASH_LAUNCH(HD_)                                              \
  flash_kernel<T, HD_><<<grid, kThreads, 0, stream>>>(                       \
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, KH, S, hd, q_offset, \
      kv_len, window, causal, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, \
      v_ss, o_sb, o_sh, o_ss, scale)
  if (hd <= 32)
    REPRO_FLASH_LAUNCH(32);
  else if (hd <= 64)
    REPRO_FLASH_LAUNCH(64);
  else if (hd <= 128)
    REPRO_FLASH_LAUNCH(128);
  else
    return (int)cudaErrorInvalidValue;
#undef REPRO_FLASH_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q: (B, H, S, hd) and out: (B, H, S, hd)
// with strides (*_sb, *_sh, *_ss, 1); k, v: (B, KH, Skv, hd) with strides
// (*_sb, *_sh, *_ss, 1) and kv_len <= Skv.
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out, int B,
    int H, int KH, int S, int hd, int q_offset, int kv_len, int window,
    int causal, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    void* stream) {
  if (KH <= 0 || H % KH != 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, out, B, H, KH, S, hd, q_offset, kv_len,
                              window, causal, q_sb, q_sh, q_ss, k_sb, k_sh,
                              k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, out, B, H, KH, S, hd, q_offset,
                                      kv_len, window, causal, q_sb, q_sh, q_ss,
                                      k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,
                                      o_sh, o_ss, st);
  return (int)cudaErrorInvalidValue;
}
