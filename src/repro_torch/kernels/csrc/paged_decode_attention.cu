// Paged flash-decode for Hopper (sm_90a): one query token per row attends
// over the row's pages of a global page pool, read through its block table;
// the query heads of a kv head together.
//
// Replaces: src/repro/kernels/paged_decode_attention.py ::
// paged_decode_attention (the Pallas TPU kernel _paged_decode_kernel).  Same
// function: out[b, h] = softmax(q[b, h] . k[j] / sqrt(hd)) v[j] over the
// row's keys j < lengths[b], key j lying in page tables[b, j / bs] at slot
// j % bs; pages past a row's length are never read, the tail page is masked
// per slot, rows may alias pages (the kernel only reads), a row with no key
// gives 0 (the l == 0 -> 1 guard), and any G = H / K.  One addition: a
// sliding `window` (the JAX package masks a windowed decode in XLA; its
// Pallas kernel has none): row b then sees the keys lengths[b] - window <=
// j < lengths[b] only.
//
// What bounds it on this card: bytes, as for the dense flash-decode: each
// token reads the row's whole valid context once (2 * len * K * hd
// elements) for 4 * G * hd flops per key.
//
// What the design does about it:
//  * The block body is the dense flash-decode's (decode_core.cuh): the query
//    heads of a kv head share one block, so each K/V element is read once
//    per token; K/V rows stream through a ring of cp.async stages.  Only
//    the key addressing differs.
//  * The TPU kernel's scalar prefetch of the table and lengths has no
//    counterpart on Hopper: each block reads its row's length and table
//    entries from device memory itself.  A copying thread resolves a table
//    entry once per page run (PagedKeys::Cursor steps through the slots of a
//    page and reads the next entry only where the run crosses into it), and
//    computes each page's address from the pool's (P, K, bs, hd) element
//    strides.  The pool is read in place: the caller passes layer l of the
//    (L, P, K, bs, hd) store.
//  * A table entry at or past ceil(len / bs) is never read, so padded
//    tables (pad_block_tables pads with page 0) cost nothing.
//  * Long rows split over several blocks (split-K over the table width)
//    against the blocks the card runs at once
//    (paged_decode_attention_slots; planned on the host from nb * bs), and
//    a merge kernel combines the partial (max, sum, acc) triples; splits
//    past a row's length exit at once.
//  * A window starts a row's splits at its first key in the window,
//    lengths[b] - window, so the first table entry read is (lengths[b] -
//    window) / bs: pages wholly below the window stay in the table and are
//    never read.  The split is planned over min(nb * bs, window) keys, from
//    host constants only (never the lengths), so the launch stays safe to
//    record into the fused rows loop's graph.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include "decode_core.cuh"

namespace {

using namespace repro;

// keys of one (row, kv head) of a (P, K, bs, hd) page pool
template <typename T>
struct PagedKeys {
  const T* kp;  // k_pages + kv_head * k_sh
  const T* vp;
  const int* table;  // the row's block table
  int bs;
  long long k_sp, k_ss, v_sp, v_ss;  // page and slot strides
  // page `page` of the table, slot `slot`; the page's rows once read
  struct Cursor {
    int page, slot, read;
    const T* kpage;
    const T* vpage;
  };
  __device__ __forceinline__ Cursor at(int j) const {
    return {j / bs, j % bs, -1, nullptr, nullptr};
  }
  __device__ __forceinline__ void step(Cursor& c, int n) const {
    c.slot += n;
    if (c.slot >= bs) {
      c.page += c.slot / bs;
      c.slot %= bs;
    }
  }
  __device__ __forceinline__ void rows(Cursor& c, const T*& k,
                                       const T*& v) const {
    if (c.read != c.page) {
      const long long p = table[c.page];
      c.kpage = kp + p * k_sp;
      c.vpage = vp + p * v_sp;
      c.read = c.page;
    }
    k = c.kpage + c.slot * k_ss;
    v = c.vpage + c.slot * v_ss;
  }
};

struct Args {
  const void *q, *kp, *vp;
  const int *tables, *lengths;
  void* out;
  float* part;
  int H, KH, nb, bs, hd, n_hg, n_split, split_keys;
  int window;  // 0: every key below the length; else the last `window`
  long long q_sb, q_sh, k_sp, k_sh, k_ss, v_sp, v_sh, v_ss, t_sb, o_sb, o_sh;
  float scale_log2;  // log2(e) / sqrt(hd): scores in base 2
};

// grid (n_split, KH * n_hg, B): one block per (split, kv head and head
// group, row).
template <typename T, int HD, int GB, int VB>
__global__ void __launch_bounds__(DecodeShape<T, HD, GB>::kThreads)
paged_decode_kernel(const Args a) {
  const int split = blockIdx.x, b = blockIdx.z;
  const int kh = blockIdx.y / a.n_hg, hg = blockIdx.y % a.n_hg;
  const int len = min(max(a.lengths[b], 0), a.nb * a.bs);
  const int lo = (a.window > 0 ? max(len - a.window, 0) : 0) +
                 split * a.split_keys;
  const int hi = min(lo + a.split_keys, len);
  const int G = a.H / a.KH;
  const PagedKeys<T> keys{static_cast<const T*>(a.kp) + kh * a.k_sh,
                          static_cast<const T*>(a.vp) + kh * a.v_sh,
                          a.tables + b * a.t_sb,
                          a.bs,
                          a.k_sp,
                          a.k_ss,
                          a.v_sp,
                          a.v_ss};
  decode_block<T, HD, GB, VB>(keys, lo, hi, static_cast<const T*>(a.q),
                              a.q_sb, a.q_sh, static_cast<T*>(a.out), a.o_sb,
                              a.o_sh, a.part, b, kh * G + hg * GB,
                              min(GB, G - hg * GB), a.H, a.hd, split,
                              a.n_split, a.scale_log2);
}

struct Paged {
  template <typename V>
  static constexpr auto kernel =
      paged_decode_kernel<typename V::type, V::hd, V::gb, V::vb>;
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q: (B, H, hd), H % KH == 0; k_pages,
// v_pages: (P, KH, bs, hd); tables: (B, nb) int32, unit stride over nb;
// lengths: (B,) int32; out: (B, H, hd); strides: the 11 element strides
// q_sb, q_sh, k_sp, k_sh, k_ss, v_sp, v_sh, v_ss, t_sb, o_sb, o_sh (unit
// stride over hd everywhere).  window: 0, or a sliding window: row b
// attends over the keys [w, lengths[b]), w = max(0, lengths[b] - window).
// Split i covers the keys [w + i * split_keys, w + (i + 1) * split_keys)
// (w = 0 without a window), n_split * split_keys >= nb * bs, or >=
// min(nb * bs, window) with one; part is fp32 scratch of B * H * n_split *
// (hd + 2) floats when n_split > 1.
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, void* part, int B,
    int H, int KH, int nb, int bs, int hd, int n_split, int split_keys,
    int window, const long long* strides, void* stream) {
  const int n_hg = head_groups(H, KH);
  const long long keys = (long long)nb * bs;
  if (n_hg == 0 || B <= 0 || B > 65535 || nb <= 0 || bs <= 0 || hd <= 0 ||
      hd > 128 || n_split <= 0 || split_keys <= 0 || window < 0 ||
      (long long)n_split * split_keys <
          (window > 0 && window < keys ? window : keys))
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const Args a{q, k_pages, v_pages, (const int*)tables, (const int*)lengths,
               out, (float*)part, H, KH, nb, bs, hd, n_hg, n_split,
               split_keys, window, s[0], s[1], s[2], s[3], s[4], s[5],
               s[6], s[7], s[8], s[9], s[10],
               1.4426950408889634f / sqrtf((float)hd)};
  return decode_run<Paged>(dtype, a, B, k_pages, v_pages, strides,
                           (cudaStream_t)stream);
}

// The copy width in bytes (16, 4, or 2 for bf16 element copies) the launch
// takes for these page pools and the same 11 strides.
extern "C" int paged_decode_attention_vector_bytes(int dtype, int hd,
                                                   const void* k_pages,
                                                   const void* v_pages,
                                                   const long long* strides) {
  return vector_bytes(dtype, hd, k_pages, v_pages, strides);
}

// Blocks of the kernel the card runs at once for this dtype, head_dim and
// G = H / K query heads a kv head (rows), and one block's dynamic shared
// memory (decode_slots).  Writes *out and *smem; returns a CUDA error code.
extern "C" int paged_decode_attention_slots(int dtype, int hd, int rows,
                                            int* out, int* smem) {
  return decode_slots<Paged>(dtype, hd, rows, out, smem);
}
