// Paged span attention for Hopper (sm_90a): every batched extend of the
// continuous-batching path (prompt chunks, step scoring, delimiters,
// spec-decode verification) attends its T new queries per row over the
// row's committed pages plus the span's own fresh K/V.
//
// Replaces: src/repro/kernels/paged_append_attention.py ::
// paged_append_attention (the Pallas TPU kernel _paged_append_kernel).  Same
// function: query i of row b (absolute position ctx_lens[b] + i) sees the
// committed keys j < ctx_lens[b], key j lying in page tables[b, j / bs] at
// slot j % bs, plus the span keys k_new[b, j] with j <= i and
// j < span_lens[b]; causal within the span, no window.  Outputs of query
// positions at or past span_lens[b] are unspecified (the caller slices them
// off); a query that sees no key gives 0 (the l == 0 -> 1 guard).
//
// What bounds it on this card: for a few queries per row (a spec-decode
// verification, T = gamma + 1) bytes, like decode; for 64 or more queries
// over a long context, operations (4 * hd flops per query and key against
// 2 * hd elements per key, shared by all the block's queries).
//
// What the design does about it:
//  * One block per (16-query tile x G heads, kv head, row): the 16 * G
//    query rows of a tile share every K/V tile staged in shared memory, so
//    a K/V element is read once per 16 span positions and G heads.  The
//    TPU kernel fed all T * G rows as one MXU tile; G is 1 to 3 on the
//    testbed and minitron-4b, far below the 64 rows of a wgmma, so the
//    products run on CUDA cores in fp32 (tensor cores are later work).
//  * The TPU grid's sequential page axis becomes a loop inside the block
//    over 32-key tiles, first over the committed pages up to ctx_len (page
//    addresses from the block table, read by the block itself: Hopper has
//    no scalar prefetch), then over the side buffer up to the tile's last
//    visible span key, one online softmax (fp32) across both.  Table
//    entries at or past ceil(ctx_len / bs) are never read.
//  * T runs up to the largest extend bucket (256): one kernel carries every
//    batched extend.  When rows x kv heads x tiles would leave the 132 SMs
//    idle (a verification of 5 queries over 4096 keys is 1 tile), the
//    committed context is split over several blocks (split-K) and a merge
//    kernel (decode_core.cuh) combines the partial (max, sum, acc) triples.
//  * head_dim up to 128 is padded to 32, 64 or 128 in shared memory with
//    bounds checks (BASE's 28); loads are scalar per element (bf16 rows of
//    56 bytes are not 16-byte aligned); shared rows are padded by one word
//    against bank conflicts.  Shared memory is dynamic (up to 117 KB for
//    G = 8, hd = 128).
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include "decode_core.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 16;  // span positions per block
constexpr int kKT = 32;  // keys per shared-memory tile (= warp size)

struct Smem {
  long long* koff;  // [kKT] element offsets of the tile's K rows
  long long* voff;  // [kKT]
  float* qs;        // [R][HD + 1]
  float* ks;        // [kKT][HD + 1]
  float* vs;        // [kKT][HD + 1]
  float* ps;        // [R][kKT + 1]
  float* m_s;       // [R]
  float* l_s;       // [R]
  float* a_s;       // [R]
};

__host__ __device__ inline size_t smem_bytes(int R, int HD) {
  return 2 * kKT * sizeof(long long) +
         sizeof(float) * ((size_t)R * (HD + 1) + 2 * kKT * (HD + 1) +
                          (size_t)R * (kKT + 1) + 3 * R);
}

// One 32-key tile: keys k0 .. k0 + n - 1 whose K/V rows start at kbase +
// koff[j] and vbase + voff[j] (filled by the caller).  In the span part the
// causal mask key <= position applies; in the context part every key is
// visible.  Updates the online softmax state and the accumulator.
template <typename T, int HD, int kPer>
__device__ __forceinline__ void attend_tile(const Smem& sm, const T* kbase,
                                            const T* vbase, int n, int k0,
                                            bool span, int q0, int R, int G,
                                            int hd, float (&acc)[kPer]) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int ld = HD + 1;
  for (int i = tid; i < n * hd; i += kThreads) {
    const int j = i / hd, d = i % hd;
    sm.ks[j * ld + d] = to_f32(kbase[sm.koff[j] + d]);
    sm.vs[j * ld + d] = to_f32(vbase[sm.voff[j] + d]);
  }
  __syncthreads();
  for (int i = tid; i < R * kKT; i += kThreads) {
    const int r = i / kKT, j = i % kKT;
    float s = kNeg;
    if (j < n && (!span || k0 + j <= q0 + r / G)) {
      s = 0.f;
      const float* qr = sm.qs + r * ld;
      const float* kr = sm.ks + j * ld;
      for (int d = 0; d < hd; ++d) s += qr[d] * kr[d];
    }
    sm.ps[r * (kKT + 1) + j] = s;
  }
  __syncthreads();
  // online softmax: one warp per query row, one lane per key
  for (int r = warp; r < R; r += kWarps) {
    float* pr = sm.ps + r * (kKT + 1);
    const float s = pr[lane];
    const bool ok = s > 0.5f * kNeg;
    const float m_old = sm.m_s[r];
    const float m_new = fmaxf(m_old, warp_max(ok ? s : kNeg));
    const float p = ok ? expf(s - m_new) : 0.f;
    const float sum = warp_sum(p);
    pr[lane] = p;
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      sm.a_s[r] = alpha;
      sm.l_s[r] = sm.l_s[r] * alpha + sum;
      sm.m_s[r] = m_new;
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * kThreads;
    if (i < R * hd) {
      const int r = i / hd, d = i % hd;
      const float* pr = sm.ps + r * (kKT + 1);
      float o = acc[u] * sm.a_s[r];
      for (int j = 0; j < n; ++j) o += pr[j] * sm.vs[j * ld + d];
      acc[u] = o;
    }
  }
  __syncthreads();
}

// grid (n_qt * n_split, KH, B): blockIdx.x = tile + n_qt * split.
template <typename T, int HD, int GB>
__global__ void __launch_bounds__(kThreads)
paged_append_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                    const T* __restrict__ vn, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ ctx_lens,
                    const int* __restrict__ span_lens, T* __restrict__ out,
                    float* __restrict__ part, int Tq, int H, int KH, int nb,
                    int bs, int hd, int n_qt, int n_split, int split_keys,
                    long long q_sb, long long q_st, long long q_sh,
                    long long kn_sb, long long kn_st, long long kn_sh,
                    long long vn_sb, long long vn_st, long long vn_sh,
                    long long k_sp, long long k_sh, long long k_ss,
                    long long v_sp, long long v_sh, long long v_ss,
                    long long t_sb, long long o_sb, long long o_st,
                    long long o_sh, float scale) {
  constexpr int kPer = kQT * GB * HD / kThreads;  // (row, d) slots a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = blockIdx.x % n_qt, split = blockIdx.x / n_qt;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH, R = kQT * G, q0 = tile * kQT;
  const int tid = threadIdx.x;
  constexpr int ld = HD + 1;

  Smem sm;
  sm.koff = reinterpret_cast<long long*>(smem_raw);
  sm.voff = sm.koff + kKT;
  sm.qs = reinterpret_cast<float*>(sm.voff + kKT);
  sm.ks = sm.qs + R * ld;
  sm.vs = sm.ks + kKT * ld;
  sm.ps = sm.vs + kKT * ld;
  sm.m_s = sm.ps + R * (kKT + 1);
  sm.l_s = sm.m_s + R;
  sm.a_s = sm.l_s + R;

  const int ctx = min(max(ctx_lens[b], 0), nb * bs);
  const int span = min(max(span_lens[b], 0), Tq);

  // query rows r = i * G + g: span position q0 + i, head kh * G + g
  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd, pos = q0 + r / G;
    const int h = kh * G + r % G;
    sm.qs[r * ld + d] =
        pos < Tq ? to_f32(q[b * q_sb + pos * q_st + h * q_sh + d]) * scale
                 : 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    sm.m_s[r] = kNeg;
    sm.l_s[r] = 0.f;
  }
  float acc[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) acc[u] = 0.f;
  __syncthreads();

  // the committed pages of this split
  const int* table = tables + b * t_sb;
  const int lo = split * split_keys, hi = min(lo + split_keys, ctx);
  for (int k0 = lo; k0 < hi; k0 += kKT) {
    const int n = min(kKT, hi - k0);
    if (tid < n) {
      const int key = k0 + tid, page = table[key / bs], slot = key % bs;
      sm.koff[tid] = page * k_sp + kh * k_sh + slot * k_ss;
      sm.voff[tid] = page * v_sp + kh * v_sh + slot * v_ss;
    }
    __syncthreads();
    attend_tile<T, HD, kPer>(sm, kp, vp, n, k0, false, q0, R, G, hd, acc);
  }
  // the span's own keys, causal (split 0 only)
  if (split == 0) {
    const int span_hi = min(span, q0 + kQT);
    for (int k0 = 0; k0 < span_hi; k0 += kKT) {
      const int n = min(kKT, span_hi - k0);
      if (tid < n) {
        sm.koff[tid] = b * kn_sb + (k0 + tid) * kn_st + kh * kn_sh;
        sm.voff[tid] = b * vn_sb + (k0 + tid) * vn_st + kh * vn_sh;
      }
      __syncthreads();
      attend_tile<T, HD, kPer>(sm, kn, vn, n, k0, true, q0, R, G, hd, acc);
    }
  }

#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * kThreads;
    if (i < R * hd) {
      const int r = i / hd, d = i % hd, pos = q0 + r / G;
      const int h = kh * G + r % G;
      if (pos < Tq) {
        if (n_split == 1) {
          const float l = sm.l_s[r] == 0.f ? 1.f : sm.l_s[r];
          store(out + b * o_sb + pos * o_st + h * o_sh + d, acc[u] / l);
        } else {
          float* pb = part + ((((long long)b * Tq + pos) * H + h) * n_split +
                              split) * (hd + 2);
          pb[d] = acc[u];
          if (d == 0) {
            pb[hd] = sm.m_s[r];
            pb[hd + 1] = sm.l_s[r];
          }
        }
      }
    }
  }
}

template <typename T, int HD, int GB>
int launch(const void* q, const void* kn, const void* vn, const void* kp,
           const void* vp, const int* tables, const int* ctx_lens,
           const int* span_lens, void* out, float* part, int B, int Tq, int H,
           int KH, int nb, int bs, int hd, int n_split, int split_keys,
           const long long* st, cudaStream_t stream) {
  auto kernel = paged_append_kernel<T, HD, GB>;
  const int G = H / KH, n_qt = (Tq + kQT - 1) / kQT;
  const size_t bytes = smem_bytes(kQT * G, HD);
  static size_t configured = 48 * 1024;
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = bytes;
  }
  const float scale = 1.f / sqrtf((float)hd);
  kernel<<<dim3(n_qt * n_split, KH, B), kThreads, bytes, stream>>>(
      (const T*)q, (const T*)kn, (const T*)vn, (const T*)kp, (const T*)vp,
      tables, ctx_lens, span_lens, (T*)out, part, Tq, H, KH, nb, bs, hd, n_qt,
      n_split, split_keys, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15],
      st[16], st[17], st[18], scale);
  if (n_split > 1)
    combine_kernel<T><<<B * Tq * H, 128, 0, stream>>>(
        part, (T*)out, Tq, H, n_split, hd, st[16], st[17], st[18]);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_group(int G, const void* q, const void* kn, const void* vn,
                   const void* kp, const void* vp, const int* tables,
                   const int* ctx_lens, const int* span_lens, void* out,
                   float* part, int B, int Tq, int H, int KH, int nb, int bs,
                   int hd, int n_split, int split_keys, const long long* st,
                   cudaStream_t stream) {
#define REPRO_APPEND_LAUNCH(GB_)                                             \
  return launch<T, HD, GB_>(q, kn, vn, kp, vp, tables, ctx_lens, span_lens, \
                            out, part, B, Tq, H, KH, nb, bs, hd, n_split,   \
                            split_keys, st, stream)
  if (G <= 2) REPRO_APPEND_LAUNCH(2);
  if (G <= 4) REPRO_APPEND_LAUNCH(4);
  if (G <= 8) REPRO_APPEND_LAUNCH(8);
#undef REPRO_APPEND_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_hd(int G, const void* q, const void* kn, const void* vn,
                const void* kp, const void* vp, const int* tables,
                const int* ctx_lens, const int* span_lens, void* out,
                float* part, int B, int Tq, int H, int KH, int nb, int bs,
                int hd, int n_split, int split_keys, const long long* st,
                cudaStream_t stream) {
#define REPRO_APPEND_HD(HD_)                                             \
  return dispatch_group<T, HD_>(G, q, kn, vn, kp, vp, tables, ctx_lens, \
                                span_lens, out, part, B, Tq, H, KH, nb,  \
                                bs, hd, n_split, split_keys, st, stream)
  if (hd <= 32) REPRO_APPEND_HD(32);
  if (hd <= 64) REPRO_APPEND_HD(64);
  if (hd <= 128) REPRO_APPEND_HD(128);
#undef REPRO_APPEND_HD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q: (B, T, H, hd) and out: (B, T, H, hd)
// with strides (*_sb, *_st, *_sh, 1); k_new, v_new: (B, T, KH, hd) with
// strides (*_sb, *_st, *_sh, 1); k_pages, v_pages: (P, KH, bs, hd) with
// strides (*_sp, *_sh, *_ss, 1); tables: (B, nb) int32 with row stride t_sb;
// ctx_lens, span_lens: (B,) int32.  strides: the 19 element strides q_sb,
// q_st, q_sh, kn_sb, kn_st, kn_sh, vn_sb, vn_st, vn_sh, k_sp, k_sh, k_ss,
// v_sp, v_sh, v_ss, t_sb, o_sb, o_st, o_sh.  part: fp32 scratch of B * T * H
// * n_split * (hd + 2) floats when n_split > 1; split i covers the committed
// keys [i * split_keys, (i + 1) * split_keys).
extern "C" int paged_append_attention_launch(
    int dtype, const void* q, const void* k_new, const void* v_new,
    const void* k_pages, const void* v_pages, const void* tables,
    const void* ctx_lens, const void* span_lens, void* out, void* part, int B,
    int Tq, int H, int KH, int nb, int bs, int hd, int n_split,
    int split_keys, const long long* strides, void* stream) {
  if (KH <= 0 || H % KH != 0 || Tq <= 0 || nb <= 0 || bs <= 0 ||
      n_split <= 0 || split_keys <= 0 ||
      (long long)n_split * split_keys < (long long)nb * bs)
    return (int)cudaErrorInvalidValue;
  const int G = H / KH;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(G, q, k_new, v_new, k_pages, v_pages,
                              (const int*)tables, (const int*)ctx_lens,
                              (const int*)span_lens, out, (float*)part, B, Tq,
                              H, KH, nb, bs, hd, n_split, split_keys, strides,
                              st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(
        G, q, k_new, v_new, k_pages, v_pages, (const int*)tables,
        (const int*)ctx_lens, (const int*)span_lens, out, (float*)part, B, Tq,
        H, KH, nb, bs, hd, n_split, split_keys, strides, st);
  return (int)cudaErrorInvalidValue;
}
