// Causal GQA flash attention for Hopper (sm_90a) on the tensor cores: prompt
// prefill, step extends and verification passes of the sequential path.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention (the
// Pallas TPU kernel _flash_kernel).  Query head h reads kv head h / G.  The
// TPU kernel attends S queries from position 0 over S keys, S a multiple of
// its 128-row block.  The port's prefill writes S new keys at offset `start`
// of a cache of capacity C and attends each query start + i over the cache,
// so this kernel also takes `q_offset` (absolute position of query 0),
// `kv_len` (keys j >= kv_len are invisible) and a sliding `window`, and
// masks ragged edges itself: S is an engine bucket from 4 to 256, or a whole
// prompt.  Query i sees key j iff j < kv_len and, when causal,
// j <= q_offset + i and (window > 0) j > q_offset + i - window.  With
// q_offset = 0 and kv_len = S it is the TPU kernel's function.  A query
// that sees no key gives 0 (the l == 0 -> 1 guard).
//
// What bounds it on this card: at the serving buckets (S <= 256 over a
// 1024-slot cache, head_dim 28 or 32) each launch moves a few hundred KB
// and does a few MFLOP, so it is bound by latency.  At long prompts it is
// bound by operations: 4 * hd flops per visible (query, key) pair,
// fp32-accurate, so 3xTF32 on the tensor cores at 495 / 3 TFLOP/s
// (minitron-4b, S=2048 causal: 25.8 GFLOP, 0.156 ms).
//
// What the design does about it (paged_append_attention.cu's design, over
// a dense strided cache):
//  * Rows packed as (position, head): row r = i * G + g of a (row b, kv
//    head kh) is query position i of head kh * G + g, for any G.  A block
//    holds 64 consecutive rows, 16 per warp: one m16n8k8 fragment each.  A
//    K/V tile is read once for the G heads of its kv head (the per-head
//    kernel before it read it G times).  The causal and window bounds are
//    per row; a block loads only the key tiles between its first row's
//    lower bound and its last row's upper bound, and a warp skips the
//    products of a tile none of its rows sees, and the 8-key slices past
//    its last row's diagonal.
//  * Both products on the tensor cores with mma.sync.m16n8k8 TF32 and fp32
//    accumulators (tf32_mma.cuh): fp32 operands as 3xTF32 (hi.hi' +
//    hi.lo' + lo.hi'), bf16 operands exact in TF32 (Q.K^T one product with
//    the softmax scale applied to S, P.V two); two accumulators for S so
//    that no mma waits on the one before it.
//  * Online softmax in registers, base 2.  P feeds P.V straight from the S
//    accumulators: the k order of an 8-key step is permuted (k = tig holds
//    key 2 * tig, k = tig + 4 key 2 * tig + 1) and V's rows are read in the
//    same order.  The masks use each accumulator's true key, k0 + nt * 8 +
//    2 * tig + (e & 1): the permutation lives only in P.V's operands.
//  * K/V tiles of 32 keys staged by cp.async (16-byte copies, two stages)
//    straight from the strided cache; a scalar copy path stays where a key
//    row or a stride is not a multiple of 16 bytes (bf16 at hd 28: 56-byte
//    rows).  head_dim is padded to 32, 64 or 128 with zeros.
//  * Causal balance: at S = 2048 from position 0 the last row block reads
//    64 key tiles and the first one, so blocks run heaviest first: the
//    grid is (KH, B, row blocks x splits) and its last axis walks the row
//    blocks from the last position down, so the tail wave holds the short
//    blocks.
//  * A short extend at a large offset (an engine bucket of 16 over a
//    1024-slot cache) fills a handful of SMs, so the keys the launch sees
//    are split over blocks, planned against the blocks the card runs at
//    once (flash_attention_slots asks the occupancy calculator), and
//    combine_kernel (decode_core.cuh) merges the partial (max, sum, acc)
//    triples.
//  * Shared memory a block: Q as fp32, R x (HD + 4) floats with R =
//    min(64, S * G rounded up to 16), plus 2 stages x (K, V) x 32 keys x
//    (HD + 16 bytes); the same as paged_append_attention.cu at the same R.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cstdint>
#include <initializer_list>

#include "decode_core.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace repro;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // (position, head) rows of a block
constexpr int kKT = 32;             // keys per shared-memory tile

// Q rows a block stages: its 64, or all S * G rows rounded up to a fragment.
__host__ __device__ inline int block_rows(int rows) {
  return rows < kRows ? (rows + 15) / 16 * 16 : kRows;
}

template <typename T, int HD>
__host__ __device__ constexpr int kv_ld() {
  return HD + 16 / (int)sizeof(T);
}

template <typename T, int HD>
__host__ __device__ inline size_t smem_bytes(int qr) {
  return (size_t)qr * (HD + 4) * sizeof(float) +
         (size_t)4 * kKT * kv_ld<T, HD>() * sizeof(T);
}

struct Args {
  const void *q, *k, *v;
  void* out;
  float* part;
  int S, H, KH, hd, q_offset, kv_len, window, causal;
  int n_rt, n_split, split_keys, key_lo;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale_log2;  // log2(e) / sqrt(hd): scores in base 2
};

// grid (KH, B, n_rt * n_split): blockIdx.z = n_rt - 1 - row block + n_rt *
// split.  kVec: every K/V row start is 16-byte aligned and hd * sizeof(T)
// is a multiple of 16, so tiles are copied by cp.async 16 bytes at a time.
template <typename T, int HD, bool kVec>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Args a) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int ldq = HD + 4;          // floats; = 4 mod 32: no bank conflict
  constexpr int ld = kv_ld<T, HD>();   // elements; rows 16 bytes apart mod 128
  constexpr int kVecE = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int rt = a.n_rt - 1 - (int)(blockIdx.z % a.n_rt);
  const int split = blockIdx.z / a.n_rt;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = a.H / a.KH, hd = a.hd, rows = a.S * G, r0 = rt * kRows;
  const int qr = block_rows(rows);
  const int live_rows = min(kRows, rows - r0);

  float* qs = reinterpret_cast<float*>(smem_raw);
  T* ks = reinterpret_cast<T*>(qs + qr * ldq);  // [2][kKT][ld]
  T* vs = ks + 2 * kKT * ld;                    // [2][kKT][ld]

  // keys [lo, hi) that some row of this block (and split) sees
  int lo = 0, hi = a.kv_len;
  if (a.causal) {
    hi = min(hi, a.q_offset + (r0 + live_rows - 1) / G + 1);
    if (a.window > 0) lo = max(0, a.q_offset + r0 / G - a.window + 1);
  }
  if (a.n_split > 1) {
    const int s_lo = a.key_lo + split * a.split_keys;  // a multiple of kKT
    lo = max(lo, s_lo);
    hi = min(hi, s_lo + a.split_keys);
  }
  lo = lo / kKT * kKT;
  const int n_tiles = hi > lo ? (hi - lo + kKT - 1) / kKT : 0;

  // zero K/V (pad columns and never-copied keys must hold finite values:
  // a masked key's p = 0 still multiplies its V row), then stage Q as fp32
  {
    float4* z = reinterpret_cast<float4*>(ks);
    const int n4 = 4 * kKT * ld * (int)sizeof(T) / 16;
    for (int i = tid; i < n4; i += kThreads) z[i] = make_float4(0, 0, 0, 0);
  }
  const T* q = static_cast<const T*>(a.q);
  for (int i = tid; i < qr * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, fr = r0 + r;
    float x = 0.f;
    if (d < hd && fr < rows)
      x = to_f32(q[b * a.q_sb + (long long)(fr / G) * a.q_ss +
                   (long long)(kh * G + fr % G) * a.q_sh + d]);
    qs[r * ldq + d] = x;
  }
  __syncthreads();

  const T* kb0 = static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const T* vb0 = static_cast<const T*>(a.v) + b * a.v_sb + kh * a.v_sh;

  // four threads a key: each copies every fourth 16-byte chunk (every
  // fourth element on the scalar path) of its key's K and V rows
  static_assert(kThreads == 4 * kKT, "four copying threads a key");
  auto load_tile = [&](int i, int stage) {
    const int k0 = lo + i * kKT, n = min(kKT, hi - k0);
    const int j = tid / 4, sub = tid % 4;
    if (j >= n) return;
    const T* kb = kb0 + (long long)(k0 + j) * a.k_ss;
    const T* vb = vb0 + (long long)(k0 + j) * a.v_ss;
    T* kd = ks + (stage * kKT + j) * ld;
    T* vd = vs + (stage * kKT + j) * ld;
    if constexpr (kVec) {
#pragma unroll
      for (int u = 0; u < HD / kVecE / 4; ++u) {
        const int d = (sub + 4 * u) * kVecE;
        if (d < hd) {
          cp_async16(kd + d, kb + d);
          cp_async16(vd + d, vb + d);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < HD / 4; ++u) {
        const int d = sub + 4 * u;
        if (d < hd) {
          kd[d] = kb[d];
          vd[d] = vb[d];
        }
      }
    }
  };

  // this warp's rows and the keys [w_lo, w_hi) they see; this lane's two
  // rows of the fragment: gid and gid + 8, at absolute positions pos[]
  const int wr0 = r0 + 16 * warp;
  const bool warp_live = 16 * warp < live_rows;
  const int wr1 = min(wr0 + 15, rows - 1);
  int w_lo = lo, w_hi = hi;
  if (a.causal) {
    w_hi = min(hi, a.q_offset + wr1 / G + 1);
    if (a.window > 0) w_lo = max(lo, a.q_offset + wr0 / G - a.window + 1);
  }
  const int fr0 = wr0 + gid;
  const int pos[2] = {a.q_offset + fr0 / G, a.q_offset + (fr0 + 8) / G};
  const float* qa = qs + (16 * warp + gid) * ldq + tig;
  float o[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_tile(i + 1, (i + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int k0 = lo + i * kKT;
    // keys of this tile the warp may see: [k0, k0 + n)
    const int n = min(kKT, w_hi - k0);
    if (warp_live && n > 0 && k0 + kKT > w_lo) {
      const T* kt = ks + (i & 1) * kKT * ld;
      const T* vt = vs + (i & 1) * kKT * ld;

      // S = Q . K^T: 16 rows x 32 keys, in two accumulators (fp32: the
      // hi.hi' products and the two correction products; bf16: even and
      // odd k steps) so that no mma waits on the one before it
      float s[kKT / 8][4], s2[kKT / 8][4];
#pragma unroll
      for (int nt = 0; nt < kKT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = s2[nt][e] = 0.f;
      const int n_nt = (n + 7) / 8;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 8) {
        const float qv[4] = {qa[kk], qa[8 * ldq + kk], qa[kk + 4],
                             qa[8 * ldq + kk + 4]};
        uint32_t ahi[4], alo[4], bhi[kKT / 8][2], blo[kKT / 8][2];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kF32)
            split_tf32(qv[e], ahi[e], alo[e]);
          else
            ahi[e] = __float_as_uint(qv[e]);
        }
#pragma unroll
        for (int nt = 0; nt < kKT / 8; ++nt) {
          const T* kr = kt + (nt * 8 + gid) * ld + kk + tig;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = to_f32(kr[4 * e]);
            if constexpr (kF32)
              split_tf32(x, bhi[nt][e], blo[nt][e]);
            else
              bhi[nt][e] = __float_as_uint(x);
          }
        }
        if constexpr (kF32) {
#pragma unroll
          for (int nt = 0; nt < kKT / 8; ++nt)
            if (nt < n_nt) mma_tf32(s2[nt], alo, bhi[nt][0], bhi[nt][1]);
#pragma unroll
          for (int nt = 0; nt < kKT / 8; ++nt)
            if (nt < n_nt) mma_tf32(s[nt], ahi, bhi[nt][0], bhi[nt][1]);
#pragma unroll
          for (int nt = 0; nt < kKT / 8; ++nt)
            if (nt < n_nt) mma_tf32(s2[nt], ahi, blo[nt][0], blo[nt][1]);
        } else {
#pragma unroll
          for (int nt = 0; nt < kKT / 8; ++nt)
            if (nt < n_nt)
              mma_tf32(kk % 16 ? s2[nt] : s[nt], ahi, bhi[nt][0], bhi[nt][1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kKT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += s2[nt][e];

      // masks and the online softmax; s[nt][e]: row gid + 8 * (e >> 1),
      // key k0 + nt * 8 + 2 * tig + (e & 1)
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int nt = 0; nt < kKT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = nt * 8 + 2 * tig + (e & 1), key = k0 + j;
          const int p = pos[e >> 1];
          const bool ok = j < n && (!a.causal || (key <= p && (
                              a.window <= 0 || key > p - a.window)));
          s[nt][e] = ok ? s[nt][e] * a.scale_log2 : kNeg;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int nt = 0; nt < kKT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[nt][e] > 0.5f * kNeg
                              ? exp2f(s[nt][e] - m[e >> 1]) : 0.f;
          s[nt][e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
        o[nd][0] *= alpha[0];
        o[nd][1] *= alpha[0];
        o[nd][2] *= alpha[1];
        o[nd][3] *= alpha[1];
      }

      // O += P . V, 8 keys a step; A's k = tig is key 2 * tig, k = tig + 4
      // is key 2 * tig + 1, and V's rows are read in the same order.  The
      // products of a step go over 8 output column slices at a time, each
      // product over all 8 before the next, so no mma waits on the one
      // before it
      constexpr int kND = HD / 8 < 8 ? HD / 8 : 8;
#pragma unroll
      for (int kt8 = 0; kt8 < kKT / 8; ++kt8) {
        if (kt8 * 8 >= n) break;
        const float pv[4] = {s[kt8][0], s[kt8][2], s[kt8][1], s[kt8][3]};
        uint32_t phi[4], plo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(pv[e], phi[e], plo[e]);
        const T* vr = vt + (kt8 * 8 + 2 * tig) * ld + gid;
#pragma unroll
        for (int n0 = 0; n0 < HD / 8; n0 += kND) {
          uint32_t bhi[kND][2], blo[kND][2];
#pragma unroll
          for (int u = 0; u < kND; ++u)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = to_f32(vr[e * ld + (n0 + u) * 8]);
              if constexpr (kF32)
                split_tf32(x, bhi[u][e], blo[u][e]);
              else
                bhi[u][e] = __float_as_uint(x);
            }
#pragma unroll
          for (int u = 0; u < kND; ++u)
            mma_tf32(o[n0 + u], plo, bhi[u][0], bhi[u][1]);
          if constexpr (kF32) {
#pragma unroll
            for (int u = 0; u < kND; ++u)
              mma_tf32(o[n0 + u], phi, blo[u][0], blo[u][1]);
          }
#pragma unroll
          for (int u = 0; u < kND; ++u)
            mma_tf32(o[n0 + u], phi, bhi[u][0], bhi[u][1]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffff, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffff, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int fr = fr0 + 8 * r;
    if (fr >= rows) continue;
    const int p = fr / G, h = kh * G + fr % G;
    if (a.n_split == 1) {
      const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      T* orow = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh +
                (long long)p * a.o_ss;
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = nd * 8 + 2 * tig + e;
          if (d < hd) store(orow + d, o[nd][2 * r + e] * inv);
        }
    } else {
      float* pb = a.part + ((((long long)b * a.S + p) * a.H + h) *
                                a.n_split + split) * (hd + 2);
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = nd * 8 + 2 * tig + e;
          if (d < hd) pb[d] = o[nd][2 * r + e];
        }
      if (tig == 0) {
        pb[hd] = m[r] * 0.6931471805599453f;  // base e
        pb[hd + 1] = l[r];
      }
    }
  }
}

template <typename T, int HD, bool kVec>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, HD>(block_rows(a.S * (a.H / a.KH)));
  const cudaError_t e = allow_smem<flash_kernel<T, HD, kVec>>(bytes);
  if (e != cudaSuccess) return (int)e;
  flash_kernel<T, HD, kVec>
      <<<dim3(a.KH, B, a.n_rt * a.n_split), kThreads, bytes, stream>>>(a);
  if (a.n_split > 1)
    combine_kernel<T><<<B * a.S * a.H, 128, 0, stream>>>(
        a.part, static_cast<T*>(a.out), a.S, a.H, a.n_split, a.hd, a.o_sb,
        a.o_ss, a.o_sh);
  return (int)cudaGetLastError();
}

// Blocks of the kernel the current card runs at once for S * G = rows, and
// the dynamic shared memory of one.
template <typename T, int HD>
int slots(int rows, int* out, int* smem) {
  const size_t bytes = smem_bytes<T, HD>(block_rows(rows));
  cudaError_t e = allow_smem<flash_kernel<T, HD, true>>(bytes);
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flash_kernel<T, HD, true>, kThreads, bytes);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = per_sm * sms;
  *smem = (int)bytes;
  return (int)e;
}

template <typename T, int HD>
int dispatch_vec(const Args& a, int B, cudaStream_t stream) {
  constexpr int e = 16 / (int)sizeof(T);
  bool vec = a.hd % e == 0;
  for (const void* p : {a.k, a.v})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (long long s : {a.k_sb, a.k_sh, a.k_ss, a.v_sb, a.v_sh, a.v_ss})
    vec = vec && s % e == 0;
  return vec ? launch<T, HD, true>(a, B, stream)
             : launch<T, HD, false>(a, B, stream);
}

template <typename T>
int dispatch_hd(const Args& a, int B, cudaStream_t stream) {
  if (a.hd <= 32) return dispatch_vec<T, 32>(a, B, stream);
  if (a.hd <= 64) return dispatch_vec<T, 64>(a, B, stream);
  if (a.hd <= 128) return dispatch_vec<T, 128>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int slots_hd(int hd, int rows, int* out, int* smem) {
  if (hd <= 32) return slots<T, 32>(rows, out, smem);
  if (hd <= 64) return slots<T, 64>(rows, out, smem);
  if (hd <= 128) return slots<T, 128>(rows, out, smem);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q: (B, H, S, hd) and out: (B, H, S, hd)
// with strides (*_sb, *_sh, *_ss, 1); k, v: (B, KH, Skv, hd) with strides
// (*_sb, *_sh, *_ss, 1) and kv_len <= Skv.  strides: the 12 element strides
// q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss.
// n_split > 1 splits the keys [key_lo, key_lo + n_split * split_keys), which
// must hold every key a query sees, key_lo and split_keys multiples of 32;
// part is then fp32 scratch of B * S * H * n_split * (hd + 2) floats.
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out,
    void* part, int B, int H, int KH, int S, int hd, int q_offset,
    int kv_len, int window, int causal, int n_split, int split_keys,
    int key_lo, const long long* strides, void* stream) {
  const int rows = S * (KH > 0 ? H / KH : 0);
  const int n_rt = (rows + kRows - 1) / kRows;
  // keys [lo, hi) that some query sees
  const long long hi = causal && (long long)q_offset + S < kv_len
                           ? (long long)q_offset + S : kv_len;
  const long long lo = causal && window > 0 && q_offset >= window
                           ? (long long)q_offset - window + 1 : 0;
  if (KH <= 0 || H % KH != 0 || S <= 0 || B <= 0 || hd <= 0 ||
      kv_len < 0 || q_offset < 0 || window < 0 || n_split <= 0 ||
      (long long)n_rt * n_split > 65535 || B > 65535 || KH > 65535 ||
      (n_split > 1 &&
       (split_keys <= 0 || split_keys % kKT || key_lo < 0 || key_lo % kKT ||
        key_lo > lo || key_lo + (long long)n_split * split_keys < hi)))
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const Args a{q, k, v, out, (float*)part, S, H, KH, hd, q_offset, kv_len,
               window, causal, n_rt, n_split, split_keys, key_lo, s[0], s[1],
               s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
               1.4426950408889634f / sqrtf((float)hd)};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_hd<float>(a, B, st);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

// How many blocks of the kernel the current card runs at once for this
// dtype, head_dim and S * G (rows), and the dynamic shared memory of one
// block: the split over keys is planned against it.  Writes *out and
// *smem; returns a CUDA error code.
extern "C" int flash_attention_slots(int dtype, int hd, int rows, int* out,
                                     int* smem) {
  *out = *smem = 0;
  if (hd <= 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return slots_hd<float>(hd, rows, out, smem);
  if (dtype == 1) return slots_hd<__nv_bfloat16>(hd, rows, out, smem);
  return (int)cudaErrorInvalidValue;
}
