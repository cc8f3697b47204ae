// Shared inner loop of the flash-decode kernels (decode_attention.cu over a
// dense cache, paged_decode_attention.cu over a page pool) and the merge of
// split-K partial triples (both of those plus paged_append_attention.cu).
//
// A decode block handles one (split, kv head, row): the G query heads of the
// kv head attend over the keys [lo, hi) of the row, read through a `Keys`
// policy that maps a key index to the address of its K and V rows (unit
// stride over hd).  The policy is all that differs between the dense and the
// paged kernel: the dense one adds `j * stride`, the paged one looks up the
// row's block table.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace repro {

constexpr int kDecodeThreads = 128;
constexpr int kChunk = 32;      // keys per shared-memory chunk (= warp size)
constexpr int kMaxGroup = 8;    // query heads per kv head
constexpr float kNeg = -1e30f;  // the TPU kernels' NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffff, x, o);
  return x;
}

// One flash-decode block: queries q[b, kh*G + g] (g < G), keys [lo, hi).
// Writes out[b, h] (n_split == 1) or the partial triple of this split
// (acc[0:hd], m, l) into part[((b * H + h) * n_split + split) * (hd + 2)].
template <typename T, int HD, typename Keys>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ q, long long q_sb, long long q_sh, const Keys& keys,
    int lo, int hi, T* __restrict__ out, long long o_sb, long long o_sh,
    float* __restrict__ part, int b, int kh, int H, int G, int hd, int split,
    int n_split, float scale) {
  constexpr int kPer = kMaxGroup * HD / kDecodeThreads;  // slots per thread
  __shared__ float qs[kMaxGroup][HD];
  __shared__ float ks[kChunk][HD + 1];
  __shared__ float vs[kChunk][HD + 1];
  __shared__ float ps[kMaxGroup][kChunk];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], a_s[kMaxGroup];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < G * hd; i += kDecodeThreads) {
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

  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int n = min(kChunk, hi - c0);
    for (int i = tid; i < n * hd; i += kDecodeThreads) {
      const int j = i / hd, d = i % hd;
      ks[j][d] = to_f32(keys.k(c0 + j)[d]);
      vs[j][d] = to_f32(keys.v(c0 + j)[d]);
    }
    __syncthreads();
    for (int i = tid; i < G * kChunk; i += kDecodeThreads) {
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
    for (int g = warp; g < G; g += kDecodeThreads / 32) {
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
      const int i = tid + r * kDecodeThreads;
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
    const int i = tid + r * kDecodeThreads;
    if (i < G * hd) {
      const int g = i / hd, d = i % hd, h = kh * G + g;
      if (n_split == 1) {
        const float l = l_s[g] == 0.f ? 1.f : l_s[g];
        store(out + b * o_sb + h * o_sh + d, acc[r] / l);
      } else {
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

// grid (B * T * H); merges the n_split partial triples of one (row, query
// position, head), laid out as part[(((b * T + t) * H + h) * n_split + s) *
// (hd + 2)], into out[b * o_sb + t * o_st + h * o_sh].  Decode has T = 1.
// A (row, position, head) that saw no key gives 0 (the l == 0 -> 1 guard).
template <typename T>
__global__ void combine_kernel(const float* __restrict__ part,
                               T* __restrict__ out, int Tq, int H,
                               int n_split, int hd, long long o_sb,
                               long long o_st, long long o_sh) {
  const int bth = blockIdx.x;
  const int h = bth % H, t = (bth / H) % Tq, b = bth / (H * Tq);
  const float* pb = part + (long long)bth * n_split * (hd + 2);
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
    store(out + b * o_sb + t * o_st + h * o_sh + d, o / (l == 0.f ? 1.f : l));
  }
}

}  // namespace repro
