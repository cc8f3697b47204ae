// Flash-decode for Hopper (sm_90a): one query token per row attends over a
// dense KV cache, all G = H/K query heads of a kv head together.
//
// Replaces: src/repro/kernels/decode_attention.py :: decode_attention
// (the Pallas TPU kernel _decode_kernel).  Same function: out[b, h] =
// softmax(q[b, h] . k[b, h/G, j] / sqrt(hd)) over j < lengths[b], times v;
// a row with no valid key gives 0 (the l == 0 -> 1 guard).
//
// What bounds it on this card: bytes.  Each token of each row reads the
// row's whole valid cache once (2 * len * K * hd elements) and does
// 4 * G * hd flops per cached key, far below the ~20 flops per byte at which
// the H100's fp32 CUDA cores (67 TFLOP/s) would outrun its 3.35 TB/s.
//
// What the design does about it:
//  * The G query heads of a kv head share one block, so each K/V element is
//    read from device memory once per token, not G times.  The TPU kernel
//    fed the G heads as one (G, hd) tile to the MXU; G is 1 or 2 on the
//    testbed, far below any MMA's 16 or 64 rows, so the products run on
//    CUDA cores in fp32 instead.
//  * The cache is read where it lies: the port keeps (L, B, C, K, hd)
//    caches, the kernel takes element strides for (b, kv head, slot) and
//    needs only a unit stride over hd, so the caller passes a permuted view
//    and nothing is copied per token.
//  * The TPU grid's sequential kv axis becomes a loop inside the block over
//    32-key chunks staged in shared memory (coalesced row loads, one
//    online-softmax update per chunk, one warp per query head).  Rows of
//    bf16 with hd = 28 are 56 bytes and not 16-byte aligned, so loads are
//    scalar per element; hd up to 128 is padded to 32, 64 or 128 with
//    bounds checks, and shared rows are padded by one word so the 32 keys
//    of a chunk fall in 32 different banks.
//  * Long caches are split over several blocks (split-K, `split_keys` keys
//    each) so a small batch still fills the card; a second kernel merges
//    the partial (max, sum, acc) triples.  Splits past a row's length exit
//    at once, so the cache's capacity costs no reads.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;      // keys per shared-memory chunk (= warp size)
constexpr int kMaxGroup = 8;    // query heads per kv head
constexpr float kNeg = -1e30f;  // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffff, x, o);
  return x;
}

// grid (n_split, K, B); one block per (split, kv head, row).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ out, float* __restrict__ part, int H, int KH,
              int S, int hd, int split_keys, long long q_sb, long long q_sh,
              long long k_sb, long long k_sh, long long k_ss, long long v_sb,
              long long v_sh, long long v_ss, long long o_sb, long long o_sh,
              float scale) {
  constexpr int kPer = kMaxGroup * HD / kThreads;  // (g, d) slots per thread
  __shared__ float qs[kMaxGroup][HD];
  __shared__ float ks[kChunk][HD + 1];
  __shared__ float vs[kChunk][HD + 1];
  __shared__ float ps[kMaxGroup][kChunk];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], a_s[kMaxGroup];

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int G = H / KH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int len = min(max(lengths[b], 0), S);
  const int lo = split * split_keys;
  const int hi = min(lo + split_keys, len);

  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    qs[g][d] = to_f32(q[b * q_sb + (long long)(kh * G + g) * q_sh + d]) * scale;
  }
  if (tid < G) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc[r] = 0.f;
  __syncthreads();

  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;
  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int n = min(kChunk, hi - c0);
    for (int i = tid; i < n * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      ks[j][d] = to_f32(kb[(long long)(c0 + j) * k_ss + d]);
      vs[j][d] = to_f32(vb[(long long)(c0 + j) * v_ss + d]);
    }
    __syncthreads();
    for (int i = tid; i < G * kChunk; i += kThreads) {
      const int g = i / kChunk, j = i % kChunk;
      float s = kNeg;
      if (j < n) {
        s = 0.f;
        for (int d = 0; d < hd; ++d) s += qs[g][d] * ks[j][d];
      }
      ps[g][j] = s;
    }
    __syncthreads();
    // online softmax: one warp per query head, one lane per key
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s = ps[g][lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(lane < n ? s : kNeg));
      const float p = lane < n ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      ps[g][lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = tid + r * kThreads;
      if (i < G * hd) {
        const int g = i / hd, d = i % hd;
        float o = acc[r] * a_s[g];
        for (int j = 0; j < n; ++j) o += ps[g][j] * vs[j][d];
        acc[r] = o;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = tid + r * kThreads;
    if (i < G * hd) {
      const int g = i / hd, d = i % hd, h = kh * G + g;
      if (n_split == 1) {
        const float l = l_s[g] == 0.f ? 1.f : l_s[g];
        store(out + b * o_sb + h * o_sh + d, acc[r] / l);
      } else {
        // partial triple of this split: (acc[0:hd], m, l)
        float* pb = part + (((long long)b * H + h) * n_split + split) * (hd + 2);
        pb[d] = acc[r];
        if (d == 0) {
          pb[hd] = m_s[g];
          pb[hd + 1] = l_s[g];
        }
      }
    }
  }
}

// grid (B * H); merges the n_split partial triples of one (row, head).
template <typename T>
__global__ void combine_kernel(const float* __restrict__ part,
                               T* __restrict__ out, int H, int n_split,
                               int hd, long long o_sb, long long o_sh) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const float* pb = part + (long long)bh * n_split * (hd + 2);
  float m = kNeg;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, pb[s * (hd + 2) + hd]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float l = 0.f, o = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* ps = pb + s * (hd + 2);
      const float w = expf(ps[hd] - m);
      l += ps[hd + 1] * w;
      o += ps[d] * w;
    }
    store(out + b * o_sb + h * o_sh + d, o / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const int* lengths,
            void* out, float* part, int B, int H, int KH, int S, int hd,
            int split_keys, long long q_sb, long long q_sh, long long k_sb,
            long long k_sh, long long k_ss, long long v_sb, long long v_sh,
            long long v_ss, long long o_sb, long long o_sh,
            cudaStream_t stream) {
  const int n_split = (S + split_keys - 1) / split_keys;
  const float scale = 1.f / sqrtf((float)hd);
  decode_kernel<T, HD><<<dim3(n_split, KH, B), kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, (T*)out, part, H, KH, S,
      hd, split_keys, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,
      o_sh, scale);
  if (n_split > 1)
    combine_kernel<T><<<B * H, 128, 0, stream>>>(part, (T*)out, H, n_split,
                                                 hd, o_sb, o_sh);
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v,
                const int* lengths, void* out, float* part, int B, int H,
                int KH, int S, int hd, int split_keys, long long q_sb,
                long long q_sh, long long k_sb, long long k_sh, long long k_ss,
                long long v_sb, long long v_sh, long long v_ss,
                long long o_sb, long long o_sh, cudaStream_t stream) {
#define REPRO_DECODE_LAUNCH(HD_)                                             \
  launch<T, HD_>(q, k, v, lengths, out, part, B, H, KH, S, hd, split_keys,   \
                 q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, \
                 stream)
  if (hd <= 32)
    REPRO_DECODE_LAUNCH(32);
  else if (hd <= 64)
    REPRO_DECODE_LAUNCH(64);
  else if (hd <= 128)
    REPRO_DECODE_LAUNCH(128);
  else
    return (int)cudaErrorInvalidValue;
#undef REPRO_DECODE_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q: (B, H, hd) with strides (q_sb, q_sh,
// 1); k, v: (B, KH, S, hd) with strides (*_sb, *_sh, *_ss, 1); lengths: (B,)
// int32; out: (B, H, hd) with strides (o_sb, o_sh, 1); part: fp32 scratch of
// B * H * ceil(S / split_keys) * (hd + 2) floats when S > split_keys.
extern "C" int decode_attention_launch(
    int dtype, const void* q, const void* k, const void* v,
    const void* lengths, void* out, void* part, int B, int H, int KH, int S,
    int hd, int split_keys, long long q_sb, long long q_sh, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > kMaxGroup || split_keys <= 0 ||
      split_keys % kChunk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, (const int*)lengths, out, (float*)part,
                              B, H, KH, S, hd, split_keys, q_sb, q_sh, k_sb,
                              k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, (const int*)lengths, out,
                                      (float*)part, B, H, KH, S, hd,
                                      split_keys, q_sb, q_sh, k_sb, k_sh, k_ss,
                                      v_sb, v_sh, v_ss, o_sb, o_sh, st);
  return (int)cudaErrorInvalidValue;
}
