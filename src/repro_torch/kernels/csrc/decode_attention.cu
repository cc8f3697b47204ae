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
// The block body and the merge kernel live in decode_core.cuh, shared with
// the paged flash-decode kernel (paged_decode_attention.cu).
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include "decode_core.cuh"

namespace {

using namespace repro;

// keys of one (row, kv head) of a dense (B, KH, S, hd) cache
template <typename T>
struct DenseKeys {
  const T* kb;
  const T* vb;
  long long k_ss, v_ss;
  __device__ __forceinline__ const T* k(int j) const { return kb + j * k_ss; }
  __device__ __forceinline__ const T* v(int j) const { return vb + j * v_ss; }
};

// grid (n_split, K, B); one block per (split, kv head, row).
template <typename T, int HD>
__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ out, float* __restrict__ part, int H, int KH,
              int S, int hd, int split_keys, long long q_sb, long long q_sh,
              long long k_sb, long long k_sh, long long k_ss, long long v_sb,
              long long v_sh, long long v_ss, long long o_sb, long long o_sh,
              float scale) {
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lengths[b], 0), S);
  const int lo = split * split_keys;
  const int hi = min(lo + split_keys, len);
  const DenseKeys<T> keys{k + b * k_sb + kh * k_sh, v + b * v_sb + kh * v_sh,
                          k_ss, v_ss};
  decode_block<T, HD>(q, q_sb, q_sh, keys, lo, hi, out, o_sb, o_sh, part, b,
                      kh, H, H / KH, hd, split, gridDim.x, scale);
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
  decode_kernel<T, HD><<<dim3(n_split, KH, B), kDecodeThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, (T*)out, part, H, KH, S,
      hd, split_keys, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,
      o_sh, scale);
  if (n_split > 1)
    combine_kernel<T><<<B * H, 128, 0, stream>>>(part, (T*)out, 1, H, n_split,
                                                 hd, o_sb, 0, o_sh);
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
  if (KH <= 0 || H % KH != 0 || H / KH > repro::kMaxGroup || split_keys <= 0 ||
      split_keys % repro::kChunk != 0)
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
