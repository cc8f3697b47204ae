// Flash-decode for Hopper (sm_90a): one query token per row attends over a
// dense KV cache, the query heads of a kv head together.
//
// Replaces: src/repro/kernels/decode_attention.py :: decode_attention
// (the Pallas TPU kernel _decode_kernel).  Same function: out[b, h] =
// softmax(q[b, h] . k[b, h/G, j] / sqrt(hd)) over j < lengths[b], times v;
// a row with no valid key gives 0 (the l == 0 -> 1 guard); any G = H / K.
//
// What bounds it on this card: bytes.  Each token of each row reads the
// row's whole valid cache once (2 * len * K * hd elements) for 4 * G * hd
// flops per cached key (decode_core.cuh).
//
// What the design does about it:
//  * The query heads of a kv head share one block, so each K/V element is
//    read from device memory once per token, not G times.  The TPU kernel
//    fed them as one (G, hd) tile to the MXU; here they sit in registers
//    and the products run as exact fp32 FMAs on the CUDA cores.
//  * The cache is read where it lies: the port keeps (L, B, C, K, hd)
//    caches, the kernel takes element strides for (b, kv head, slot) and
//    needs only a unit stride over hd, so the caller passes a permuted view
//    and nothing is copied per token.
//  * The TPU grid's sequential kv axis becomes a ring of cp.async stages
//    inside the block (decode_core.cuh: vector copies, per-warp online
//    softmax, one barrier a stage).
//  * Long caches are split over several blocks (split-K) against the blocks
//    the card runs at once (decode_attention_slots; the wrapper plans with
//    kernels/tile_plan.py from the cache's capacity, so no device value is
//    read on the host); combine_kernel merges the partial (max, sum, acc)
//    triples.  Splits past a row's length exit at once, so the cache's
//    capacity costs no reads.
//  * A window starts a row's splits at its first key in the window,
//    lengths[b] - window, and the split is planned over min(capacity,
//    window) keys: a windowed row reads its window's keys only, in as
//    many blocks as a cache of that size would take.  The plan still
//    comes from host constants (capacity and window), never from the
//    lengths, so the launch stays safe to record into a graph.
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
  struct Cursor {
    int j;
  };
  __device__ __forceinline__ Cursor at(int j) const { return {j}; }
  __device__ __forceinline__ void step(Cursor& c, int n) const { c.j += n; }
  __device__ __forceinline__ void rows(Cursor& c, const T*& k,
                                       const T*& v) const {
    k = kb + c.j * k_ss;
    v = vb + c.j * v_ss;
  }
};

struct Args {
  const void *q, *k, *v;
  const int* lengths;
  void* out;
  float* part;
  int H, KH, S, hd, n_hg, n_split, split_keys;
  int window;  // 0: every key below the length; else the last `window`
  long long q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh;
  float scale_log2;  // log2(e) / sqrt(hd): scores in base 2
};

// grid (n_split, KH * n_hg, B): one block per (split, kv head and head
// group, row).
template <typename T, int HD, int GB, int VB>
__global__ void __launch_bounds__(DecodeShape<T, HD, GB>::kThreads)
decode_kernel(const Args a) {
  const int split = blockIdx.x, b = blockIdx.z;
  const int kh = blockIdx.y / a.n_hg, hg = blockIdx.y % a.n_hg;
  const int len = min(max(a.lengths[b], 0), a.S);
  const int lo = (a.window > 0 ? max(len - a.window, 0) : 0) +
                 split * a.split_keys;
  const int hi = min(lo + a.split_keys, len);
  const int G = a.H / a.KH;
  const DenseKeys<T> keys{
      static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sh,
      static_cast<const T*>(a.v) + b * a.v_sb + kh * a.v_sh, a.k_ss, a.v_ss};
  decode_block<T, HD, GB, VB>(keys, lo, hi, static_cast<const T*>(a.q),
                              a.q_sb, a.q_sh, static_cast<T*>(a.out), a.o_sb,
                              a.o_sh, a.part, b, kh * G + hg * GB,
                              min(GB, G - hg * GB), a.H, a.hd, split,
                              a.n_split, a.scale_log2);
}

struct Dense {
  template <typename V>
  static constexpr auto kernel =
      decode_kernel<typename V::type, V::hd, V::gb, V::vb>;
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q: (B, H, hd), H % KH == 0; k, v:
// (B, KH, S, hd); out: (B, H, hd); strides: the 10 element strides q_sb,
// q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh (unit stride over hd
// everywhere); lengths: (B,) int32; window: 0, or a sliding window: row b
// attends over the keys [w, lengths[b]), w = max(0, lengths[b] - window).
// Split i covers the keys [w + i * split_keys, w + (i + 1) * split_keys)
// (w = 0 without a window), n_split * split_keys >= S, or >= min(S,
// window) with one; part is fp32 scratch of B * H * n_split * (hd + 2)
// floats when n_split > 1.
extern "C" int decode_attention_launch(int dtype, const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* part, int B, int H,
                                       int KH, int S, int hd, int n_split,
                                       int split_keys, int window,
                                       const long long* strides,
                                       void* stream) {
  const int n_hg = head_groups(H, KH);
  if (n_hg == 0 || B <= 0 || B > 65535 || S <= 0 || hd <= 0 || hd > 128 ||
      n_split <= 0 || split_keys <= 0 || window < 0 ||
      (long long)n_split * split_keys < (window > 0 ? min(S, window) : S))
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const Args a{q, k, v, (const int*)lengths, out, (float*)part, H, KH, S, hd,
               n_hg, n_split, split_keys, window, s[0], s[1], s[2], s[3],
               s[4], s[5], s[6], s[7], s[8], s[9],
               1.4426950408889634f / sqrtf((float)hd)};
  return decode_run<Dense>(dtype, a, B, k, v, strides, (cudaStream_t)stream);
}

// The copy width in bytes (16, 4, or 2 for bf16 element copies) the launch
// takes for these K/V base pointers and the same 10 strides.
extern "C" int decode_attention_vector_bytes(int dtype, int hd, const void* k,
                                             const void* v,
                                             const long long* strides) {
  return vector_bytes(dtype, hd, k, v, strides);
}

// Blocks of the kernel the card runs at once for this dtype, head_dim and
// G = H / K query heads a kv head (rows), and one block's dynamic shared
// memory (decode_slots).  Writes *out and *smem; returns a CUDA error code.
extern "C" int decode_attention_slots(int dtype, int hd, int rows, int* out,
                                      int* smem) {
  return decode_slots<Dense>(dtype, hd, rows, out, smem);
}
