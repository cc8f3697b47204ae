// Paged span attention for Hopper (sm_90a) on the tensor cores: every
// batched extend of the continuous-batching path (prompt chunks, step
// scoring, delimiters, spec-decode verification) attends its T new queries
// per row over the row's committed pages plus the span's own fresh K/V.
//
// Replaces: src/repro/kernels/paged_append_attention.py ::
// paged_append_attention (the Pallas TPU kernel _paged_append_kernel).  Same
// function: query i of row b (absolute position ctx_lens[b] + i) sees the
// committed keys j < ctx_lens[b], key j lying in page tables[b, j / bs] at
// slot j % bs, plus the span keys k_new[b, j] with j <= i and
// j < span_lens[b]; causal within the span.  One addition: a sliding
// `window` (the JAX package masks a windowed extend in XLA; its Pallas
// kernel has none): query i then sees only the keys whose absolute position
// lies in (ctx_lens[b] + i - window, ctx_lens[b] + i], committed and span
// keys alike.  A query that sees no key gives 0 (the l == 0 -> 1 guard).  Outputs at or past span_lens[b] are
// unspecified by the contract (the caller slices them off); this kernel
// writes 0 there, as the plain version does.
//
// What bounds it on this card: for a few queries per row (a spec-decode
// verification, T = gamma + 1 = 5) bytes: every committed K/V row is read
// once (minitron-4b, B=8 over 4096 keys: 268 MB, 0.080 ms at 3.35 TB/s).
// For 64 or more queries over a long context, operations: 4 * hd flops per
// (query, key) pair, fp32-accurate, so 3xTF32 on the tensor cores at 495 / 3
// TFLOP/s (minitron, T=64: 25.8 GFLOP of products, 0.156 ms).
//
// What the design does about it:
//  * Rows packed as (position, head): row r = i * G + g of a (row b, kv
//    head kh) is span position i of head kh * G + g, for any G.  A block
//    holds 64 consecutive rows, 16 per warp: one m16n8k8 fragment each.
//    A warp whose fragment holds no position below span_len does no
//    arithmetic, so a verification of 5 positions x G = 3 is one fragment
//    of 15 live rows (the old kernel ran a 16-position tile, 48 rows).
//  * Both products on the tensor cores with mma.sync.m16n8k8 TF32, fp32
//    accumulators in registers.  fp32 operands are split as hi =
//    cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi) and multiplied as
//    lo.hi' + hi.lo' + hi.hi' (3xTF32: one TF32 product misses the fp32
//    tolerance 2e-5 at hd 128 over 4096 keys, the split stays far inside
//    it; tests/test_torch_kernels.py emulates both).  bf16 operands are
//    exact in TF32: Q.K^T takes one product with the softmax scale applied
//    to S (1/sqrt(hd) is not exact), P.V two (P split, V exact).
//  * Online softmax in registers: a lane holds 2 columns of rows gid and
//    gid + 8 of each 8-key slice of S; the row max comes from two shuffles
//    among the 4 lanes of a row, the row sum is kept per lane and reduced
//    once at the end.  P feeds the next product straight from the S
//    accumulators: the k order of an 8-key step is permuted (k = tig holds
//    key 2 * tig, k = tig + 4 key 2 * tig + 1) and V's rows are read in
//    the same order, so no shuffle or shared-memory round trip is needed.
//  * K/V tiles of 32 keys staged by cp.async (16-byte copies, two stages:
//    the next tile's copy runs under the current tile's products), page
//    addresses from the block table, read by the block itself (Hopper has
//    no scalar prefetch).  Where a key row or a stride is not a multiple of
//    16 bytes (bf16 at hd 28: 56-byte rows) a scalar copy path stays.
//    Shared rows are padded by 16 bytes, so fragment reads hit 32 banks.
//  * The loop runs first over this split's committed keys, then (split 0)
//    over the span keys up to the block's last live position, one online
//    softmax across both.  When rows x kv heads x row blocks would leave
//    the 132 SMs idle (a verification over 4096 keys), the committed
//    context is split over blocks (split-K) and combine_kernel
//    (decode_core.cuh) merges the partial (max, sum, acc) triples.
//  * Shared memory a block: Q as fp32, R x (HD + 4) floats with R =
//    min(64, T * G rounded up to 16), plus 2 stages x (K, V) x 32 keys x
//    (HD + 16 bytes).  At hd 128, fp32: 101,376 bytes at 64 rows (2 blocks
//    an SM), 76,032 at 16 rows (T=5, G=3: 3 blocks); bf16: 68,608 bytes
//    at 64 rows (3 blocks).  The split over the committed context is
//    planned against the blocks the card runs at once, which
//    paged_append_attention_slots asks of the occupancy calculator.
//  * A window skips what no query of a block can see: the committed splits
//    of a row start at its first query's window start, ctx - window + 1
//    (planned over min(nb * bs, window) keys, host constants only), a
//    block's committed loop starts at its own first live query's window
//    start, and its span loop at that query's window start within the
//    span.  Where a tile crosses a query's window start the mask is applied
//    per element, inside the span too (a bucket longer than the window
//    drops a span's early keys from its late queries).  Pages wholly below
//    every window stay in the table and are never read.
//  * Registers (ptxas -v, sm_90a; cp.async / scalar copy variants): fp32
//    hd 128 153 / 157, hd 64 141 / 142, hd 32 116; bf16 hd 128 162, hd 64
//    124, hd 32 80 with 8 bytes spilled; no other variant spills.
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

// Q rows a block stages: its 64, or all T * G rows rounded up to a fragment.
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
  const void *q, *kn, *vn, *kp, *vp;
  const int *tables, *ctx_lens, *span_lens;
  void* out;
  float* part;
  int Tq, H, KH, nb, bs, hd, n_rt, n_split, split_keys;
  int window;  // 0: no window; else query i sees keys > ctx + i - window
  long long q_sb, q_st, q_sh, kn_sb, kn_st, kn_sh, vn_sb, vn_st, vn_sh;
  long long k_sp, k_sh, k_ss, v_sp, v_sh, v_ss, t_sb, o_sb, o_st, o_sh;
  float scale_log2;  // log2(e) / sqrt(hd): scores in base 2
};

// grid (n_rt * n_split, KH, B): blockIdx.x = row block + n_rt * split.
// kVec: every K/V row start is 16-byte aligned and hd * sizeof(T) is a
// multiple of 16, so tiles are copied by cp.async 16 bytes at a time.
template <typename T, int HD, bool kVec>
__global__ void __launch_bounds__(kThreads)
paged_append_kernel(const Args a) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int ldq = HD + 4;          // floats; = 4 mod 32: no bank conflict
  constexpr int ld = kv_ld<T, HD>();   // elements; rows 16 bytes apart mod 128
  constexpr int kVecE = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int rt = blockIdx.x % a.n_rt, split = blockIdx.x / a.n_rt;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = a.H / a.KH, hd = a.hd, rows = a.Tq * G, r0 = rt * kRows;
  const int qr = block_rows(rows);

  float* qs = reinterpret_cast<float*>(smem_raw);
  T* ks = reinterpret_cast<T*>(qs + qr * ldq);  // [2][kKT][ld]
  T* vs = ks + 2 * kKT * ld;                    // [2][kKT][ld]

  const int ctx = min(max(a.ctx_lens[b], 0), a.nb * a.bs);
  const int span = min(max(a.span_lens[b], 0), a.Tq);
  // rows r0 + i of this block with a position below span_len
  const int live_rows = min(kRows, max(0, span * G - r0));
  const bool warp_live = 16 * warp < live_rows;
  const int span_hi =
      live_rows > 0 ? min(span, (r0 + live_rows - 1) / G + 1) : 0;
  // with a window: the row's first query's window start (the splits'
  // origin), and this block's first query's, absolute and in the span
  const int win = a.window;
  const int p_lo = r0 / G;
  const int ws = win > 0 ? max(ctx - win + 1, 0) : 0;
  const int lo0 = ws + split * a.split_keys;
  const int lo = win > 0 ? max(lo0, ctx + p_lo - win + 1) : lo0;
  const int hi = live_rows > 0 ? min(lo0 + a.split_keys, ctx) : lo;
  const int n_ctx = hi > lo ? (hi - lo + kKT - 1) / kKT : 0;
  const int sp_lo = win > 0 ? max(p_lo - win + 1, 0) : 0;
  const int n_tiles =
      n_ctx + (split == 0 ? (max(span_hi - sp_lo, 0) + kKT - 1) / kKT : 0);

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
      x = to_f32(q[b * a.q_sb + (long long)(fr / G) * a.q_st +
                   (long long)(kh * G + fr % G) * a.q_sh + d]);
    qs[r * ldq + d] = x;
  }
  __syncthreads();

  const int* table = a.tables + b * a.t_sb;
  const T* kp = static_cast<const T*>(a.kp);
  const T* vp = static_cast<const T*>(a.vp);
  const T* kn = static_cast<const T*>(a.kn);
  const T* vn = static_cast<const T*>(a.vn);

  // tile i: committed keys of this split first, then the span's own keys
  auto tile_keys = [&](int i, int& k0, int& n) {
    if (i < n_ctx) {
      k0 = lo + i * kKT;
      n = min(kKT, hi - k0);
    } else {
      k0 = sp_lo + (i - n_ctx) * kKT;
      n = min(kKT, span_hi - k0);
    }
  };
  // four threads a key: each finds its key's K/V rows once (one table
  // read) and copies every fourth 16-byte chunk (every fourth element on
  // the scalar path) of them
  static_assert(kThreads == 4 * kKT, "four copying threads a key");
  auto load_tile = [&](int i, int stage) {
    int k0, n;
    tile_keys(i, k0, n);
    const int j = tid / 4, sub = tid % 4;
    if (j >= n) return;
    const int key = k0 + j;
    const T *kb, *vb;
    if (i < n_ctx) {
      const long long page = table[key / a.bs], slot = key % a.bs;
      kb = kp + page * a.k_sp + kh * a.k_sh + slot * a.k_ss;
      vb = vp + page * a.v_sp + kh * a.v_sh + slot * a.v_ss;
    } else {
      kb = kn + b * a.kn_sb + (long long)key * a.kn_st + kh * a.kn_sh;
      vb = vn + b * a.vn_sb + (long long)key * a.vn_st + kh * a.vn_sh;
    }
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

  // this lane's two rows of the warp's fragment: rows gid and gid + 8
  const int fr0 = r0 + 16 * warp + gid;
  const int pos[2] = {fr0 / G, (fr0 + 8) / G};
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
    if (warp_live) {
      int k0, n;
      tile_keys(i, k0, n);
      const bool in_span = i >= n_ctx;
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
          const int j = nt * 8 + 2 * tig + (e & 1);
          const int p = pos[e >> 1];
          // the key's absolute position against the query's, ctx + p
          const int kabs = (in_span ? ctx : 0) + k0 + j;
          const bool ok = j < n && (!in_span || k0 + j <= p) &&
                          (win <= 0 || kabs > ctx + p - win);
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
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int fr = fr0 + 8 * r;
    if (fr >= rows) continue;
    const int p = pos[r], h = kh * G + fr % G;
    const bool dead = p >= span;  // past span_len: written as 0
    if (a.n_split == 1) {
      const float inv = dead ? 0.f : 1.f / (l[r] == 0.f ? 1.f : l[r]);
      T* orow = out + b * a.o_sb + (long long)p * a.o_st + h * a.o_sh;
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = nd * 8 + 2 * tig + e;
          if (d < hd) store(orow + d, o[nd][2 * r + e] * inv);
        }
    } else {
      float* pb = a.part + ((((long long)b * a.Tq + p) * a.H + h) *
                                a.n_split + split) * (hd + 2);
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = nd * 8 + 2 * tig + e;
          if (d < hd) pb[d] = dead ? 0.f : o[nd][2 * r + e];
        }
      if (tig == 0) {
        pb[hd] = dead ? kNeg : m[r] * 0.6931471805599453f;  // base e
        pb[hd + 1] = dead ? 0.f : l[r];
      }
    }
  }
}

template <typename T, int HD, bool kVec>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, HD>(block_rows(a.Tq * (a.H / a.KH)));
  const cudaError_t e = allow_smem<paged_append_kernel<T, HD, kVec>>(bytes);
  if (e != cudaSuccess) return (int)e;
  paged_append_kernel<T, HD, kVec>
      <<<dim3(a.n_rt * a.n_split, a.KH, B), kThreads, bytes, stream>>>(a);
  if (a.n_split > 1)
    combine_kernel<T><<<B * a.Tq * a.H, 128, 0, stream>>>(
        a.part, static_cast<T*>(a.out), a.Tq, a.H, a.n_split, a.hd, a.o_sb,
        a.o_st, a.o_sh);
  return (int)cudaGetLastError();
}

// Blocks of the kernel the current card runs at once for T * G = rows, and
// the dynamic shared memory of one.
template <typename T, int HD>
int slots(int rows, int* out, int* smem) {
  const size_t bytes = smem_bytes<T, HD>(block_rows(rows));
  cudaError_t e = allow_smem<paged_append_kernel<T, HD, true>>(bytes);
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, paged_append_kernel<T, HD, true>, kThreads, bytes);
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
  for (const void* p : {a.kn, a.vn, a.kp, a.vp})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (long long s : {a.kn_sb, a.kn_st, a.kn_sh, a.vn_sb, a.vn_st, a.vn_sh,
                      a.k_sp, a.k_sh, a.k_ss, a.v_sp, a.v_sh, a.v_ss})
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

// dtype: 0 = float32, 1 = bfloat16.  q: (B, T, H, hd) and out: (B, T, H, hd)
// with strides (*_sb, *_st, *_sh, 1); k_new, v_new: (B, T, KH, hd) with
// strides (*_sb, *_st, *_sh, 1); k_pages, v_pages: (P, KH, bs, hd) with
// strides (*_sp, *_sh, *_ss, 1); tables: (B, nb) int32 with row stride t_sb;
// ctx_lens, span_lens: (B,) int32.  strides: the 19 element strides q_sb,
// q_st, q_sh, kn_sb, kn_st, kn_sh, vn_sb, vn_st, vn_sh, k_sp, k_sh, k_ss,
// v_sp, v_sh, v_ss, t_sb, o_sb, o_st, o_sh.  part: fp32 scratch of B * T * H
// * n_split * (hd + 2) floats when n_split > 1.  window: 0, or a sliding
// window (query i of row b sees keys at absolute positions above
// ctx_lens[b] + i - window); split i covers the committed keys [w + i *
// split_keys, w + (i + 1) * split_keys), w = max(0, ctx_lens[b] - window +
// 1) (w = 0 without a window), n_split * split_keys >= nb * bs, or >=
// min(nb * bs, window) with a window.
extern "C" int paged_append_attention_launch(
    int dtype, const void* q, const void* k_new, const void* v_new,
    const void* k_pages, const void* v_pages, const void* tables,
    const void* ctx_lens, const void* span_lens, void* out, void* part, int B,
    int Tq, int H, int KH, int nb, int bs, int hd, int n_split,
    int split_keys, int window, const long long* strides, void* stream) {
  const long long keys = (long long)nb * bs;
  if (KH <= 0 || H % KH != 0 || Tq <= 0 || nb <= 0 || bs <= 0 || hd <= 0 ||
      n_split <= 0 || split_keys <= 0 || window < 0 ||
      (long long)n_split * split_keys <
          (window > 0 && window < keys ? window : keys))
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const int rows = Tq * (H / KH);
  const Args a{q, k_new, v_new, k_pages, v_pages, (const int*)tables,
               (const int*)ctx_lens, (const int*)span_lens, out, (float*)part,
               Tq, H, KH, nb, bs, hd, (rows + kRows - 1) / kRows, n_split,
               split_keys, window, s[0], s[1], s[2], s[3], s[4], s[5],
               s[6], s[7], s[8], s[9], s[10], s[11], s[12], s[13], s[14],
               s[15], s[16], s[17], s[18], 1.4426950408889634f / sqrtf((float)hd)};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_hd<float>(a, B, st);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

// How many blocks of the kernel the current card runs at once for this
// dtype, head_dim and T * G (rows), and the dynamic shared memory of one
// block: the split over the committed context is planned against it.
// Writes *out and *smem; returns a CUDA error code.
extern "C" int paged_append_attention_slots(int dtype, int hd, int rows,
                                            int* out, int* smem) {
  *out = *smem = 0;
  if (hd <= 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return slots_hd<float>(hd, rows, out, smem);
  if (dtype == 1) return slots_hd<__nv_bfloat16>(hd, rows, out, smem);
  return (int)cudaErrorInvalidValue;
}
