// Paged flash-decode for Hopper (sm_90a): one query token per row attends
// over the row's pages of a global page pool, read through its block table;
// all G = H/K query heads of a kv head together.
//
// Replaces: src/repro/kernels/paged_decode_attention.py ::
// paged_decode_attention (the Pallas TPU kernel _paged_decode_kernel).  Same
// function: out[b, h] = softmax(q[b, h] . k[j] / sqrt(hd)) v[j] over the
// row's keys j < lengths[b], key j lying in page tables[b, j / bs] at slot
// j % bs; pages past a row's length are never read, the tail page is masked
// per slot, rows may alias pages (the kernel only reads), and a row with no
// key gives 0 (the l == 0 -> 1 guard).
//
// What bounds it on this card: bytes, as for the dense flash-decode: each
// token reads the row's whole valid context once (2 * len * K * hd
// elements) for 4 * G * hd flops per key.
//
// What the design does about it:
//  * The block body is the dense flash-decode's (decode_core.cuh): the G
//    query heads of a kv head share one block, so each K/V element is read
//    once per token; 32-key chunks are staged in shared memory.  Only the
//    key addressing differs.
//  * The TPU kernel's scalar prefetch of the table and lengths has no
//    counterpart on Hopper: each block reads its row's length and table
//    entries from device memory itself (one table entry per key, cached in
//    L1 across the bs keys of a page), and computes each page's address
//    from the pool's (P, K, bs, hd) element strides.  The pool is read in
//    place: the caller passes layer l of the (L, P, K, bs, hd) store.
//  * A table entry at or past ceil(len / bs) is never read, so padded
//    tables (pad_block_tables pads with page 0) cost nothing.
//  * Long rows split over several blocks (split-K over the table width,
//    `split_keys` keys each) and a merge kernel combines the partial
//    (max, sum, acc) triples, so one long row still fills more than a few
//    SMs; splits past a row's length exit at once.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include "decode_core.cuh"

namespace {

using namespace repro;

// keys of one (row, kv head) of a (P, K, bs, hd) page pool
template <typename T>
struct PagedKeys {
  const T* kp;  // k_pages + kv_head * p_sk
  const T* vp;
  const int* table;  // the row's block table
  int bs;
  long long k_sp, k_ss, v_sp, v_ss;  // page and slot strides
  __device__ __forceinline__ const T* k(int j) const {
    return kp + table[j / bs] * k_sp + (j % bs) * k_ss;
  }
  __device__ __forceinline__ const T* v(int j) const {
    return vp + table[j / bs] * v_sp + (j % bs) * v_ss;
  }
};

// grid (n_split, K, B); one block per (split, kv head, row).
template <typename T, int HD>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ part, int H, int KH, int nb, int bs,
                    int hd, int split_keys, long long q_sb, long long q_sh,
                    long long k_sp, long long k_sh, long long k_ss,
                    long long v_sp, long long v_sh, long long v_ss,
                    long long t_sb, long long o_sb, long long o_sh,
                    float scale) {
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lengths[b], 0), nb * bs);
  const int lo = split * split_keys;
  const int hi = min(lo + split_keys, len);
  const PagedKeys<T> keys{kp + kh * k_sh, vp + kh * v_sh, tables + b * t_sb,
                          bs, k_sp, k_ss, v_sp, v_ss};
  decode_block<T, HD>(q, q_sb, q_sh, keys, lo, hi, out, o_sb, o_sh, part, b,
                      kh, H, H / KH, hd, split, gridDim.x, scale);
}

template <typename T, int HD>
void launch(const void* q, const void* kp, const void* vp, const int* tables,
            const int* lengths, void* out, float* part, int B, int H, int KH,
            int nb, int bs, int hd, int split_keys, long long q_sb,
            long long q_sh, long long k_sp, long long k_sh, long long k_ss,
            long long v_sp, long long v_sh, long long v_ss, long long t_sb,
            long long o_sb, long long o_sh, cudaStream_t stream) {
  const int n_split = (nb * bs + split_keys - 1) / split_keys;
  const float scale = 1.f / sqrtf((float)hd);
  paged_decode_kernel<T, HD>
      <<<dim3(n_split, KH, B), kDecodeThreads, 0, stream>>>(
          (const T*)q, (const T*)kp, (const T*)vp, tables, lengths, (T*)out,
          part, H, KH, nb, bs, hd, split_keys, q_sb, q_sh, k_sp, k_sh, k_ss,
          v_sp, v_sh, v_ss, t_sb, o_sb, o_sh, scale);
  if (n_split > 1)
    combine_kernel<T><<<B * H, 128, 0, stream>>>(part, (T*)out, 1, H, n_split,
                                                 hd, o_sb, 0, o_sh);
}

template <typename T>
int dispatch_hd(const void* q, const void* kp, const void* vp,
                const int* tables, const int* lengths, void* out, float* part,
                int B, int H, int KH, int nb, int bs, int hd, int split_keys,
                long long q_sb, long long q_sh, long long k_sp, long long k_sh,
                long long k_ss, long long v_sp, long long v_sh, long long v_ss,
                long long t_sb, long long o_sb, long long o_sh,
                cudaStream_t stream) {
#define REPRO_PAGED_DECODE_LAUNCH(HD_)                                       \
  launch<T, HD_>(q, kp, vp, tables, lengths, out, part, B, H, KH, nb, bs, hd, \
                 split_keys, q_sb, q_sh, k_sp, k_sh, k_ss, v_sp, v_sh, v_ss, \
                 t_sb, o_sb, o_sh, stream)
  if (hd <= 32)
    REPRO_PAGED_DECODE_LAUNCH(32);
  else if (hd <= 64)
    REPRO_PAGED_DECODE_LAUNCH(64);
  else if (hd <= 128)
    REPRO_PAGED_DECODE_LAUNCH(128);
  else
    return (int)cudaErrorInvalidValue;
#undef REPRO_PAGED_DECODE_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q: (B, H, hd) with strides (q_sb, q_sh,
// 1); k_pages, v_pages: (P, KH, bs, hd) with strides (*_sp, *_sh, *_ss, 1);
// tables: (B, nb) int32 with row stride t_sb; lengths: (B,) int32; out:
// (B, H, hd) with strides (o_sb, o_sh, 1); part: fp32 scratch of B * H *
// ceil(nb * bs / split_keys) * (hd + 2) floats when nb * bs > split_keys.
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, void* part, int B,
    int H, int KH, int nb, int bs, int hd, int split_keys, long long q_sb,
    long long q_sh, long long k_sp, long long k_sh, long long k_ss,
    long long v_sp, long long v_sh, long long v_ss, long long t_sb,
    long long o_sb, long long o_sh, void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > repro::kMaxGroup || nb <= 0 ||
      bs <= 0 || split_keys <= 0 || split_keys % repro::kChunk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(q, k_pages, v_pages, (const int*)tables,
                              (const int*)lengths, out, (float*)part, B, H,
                              KH, nb, bs, hd, split_keys, q_sb, q_sh, k_sp,
                              k_sh, k_ss, v_sp, v_sh, v_ss, t_sb, o_sb, o_sh,
                              st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(
        q, k_pages, v_pages, (const int*)tables, (const int*)lengths, out,
        (float*)part, B, H, KH, nb, bs, hd, split_keys, q_sb, q_sh, k_sp,
        k_sh, k_ss, v_sp, v_sh, v_ss, t_sb, o_sb, o_sh, st);
  return (int)cudaErrorInvalidValue;
}
