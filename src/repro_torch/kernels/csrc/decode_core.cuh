// Shared body of the flash-decode kernels (decode_attention.cu over a dense
// cache, paged_decode_attention.cu over a page pool) and the merge of
// split-K partial triples (both of those plus paged_append_attention.cu and
// flash_attention.cu).
//
// A decode block handles one (split, kv head, head group, row): up to kGroup
// query heads of one kv head attend over the keys [lo, hi) of the row, read
// through a `Keys` policy that locates a key's K and V rows (unit stride
// over hd).  The policy is all that differs between the dense and the paged
// kernel: the dense one steps by the slot stride, the paged one reads the
// row's block table once per page run.
//
// What bounds a decode block on this card: bytes.  Each K/V element is read
// once for 2 x G multiply-adds, so the work is G / 2 flops a byte in fp32,
// far below the ~20 at which the CUDA cores' 67 TFLOP/s would outrun the
// 3.35 TB/s of device memory; the products stay exact fp32 FMAs.
//
// What the body does about it:
//  * K/V stream through a ring of kStages shared-memory stages of
//    kStageBytes (the K and V rows of 32 keys in fp32 at hd 128; bf16 stays
//    bf16 in shared memory, so a stage holds twice the keys, widened on
//    read).  Rows are copied with cp.async in VB-byte vectors: 16 where
//    every row start and the row length allow it (the host entry picks VB
//    from the base pointers and element strides, `vector_bytes`), else 4
//    (bf16 rows of hd 28 are 56 bytes), and element by element for bf16
//    rows at 2-byte alignment.  While one stage is read, the next
//    kStages - 1 are in flight; the only block-wide barrier is the stage
//    hand-off.
//  * Each warp (4 a block; 8 in bf16, whose stage holds twice the keys) reads
//    its own keys of a stage, in teams of HD / 4 lanes a key (4 elements a
//    lane), each team with its own online-softmax state.  The block's query
//    heads, padded to a bucket GB of 4, 8 or 16, sit in registers, scaled to
//    base 2; a score costs one vector shared-memory load a key and 4 x GB
//    FMAs, and the partial dots of a step's 32 (key, head) pairs are summed
//    across the team by a reduce-scatter (31 shuffles for 32 sums at hd 128).
//    P.V reads each V row once as a vector and the step's probabilities as
//    float4 broadcasts: at most one shared-memory load per four FMAs.
//  * The teams' states are merged once, at the end of the block.  G above
//    kGroup takes more blocks (head groups), so any G = H / K is taken.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tf32_mma.cuh"  // cp_async_commit, allow_smem

namespace repro {

constexpr float kNeg = -1e30f;  // the TPU kernels' NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

constexpr int kStages = 3;                // depth of the K/V ring
constexpr int kStageBytes = 32 * 1024;    // K and V rows of one stage
constexpr int kGroup = 16;                // query heads a block holds at most

// Compile-time layout of a decode block for element type T, head_dim padded
// to HD (32, 64 or 128) and GB query heads.
template <typename T, int HD, int GB>
struct DecodeShape {
  // bf16 reads half the bytes a key, so twice the warps share a stage
  static constexpr int kWarps = sizeof(T) == 2 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTeam = HD / 4;         // lanes reading one key
  static constexpr int kTeams = 32 / kTeam;    // keys a warp reads at once
  static constexpr int kKeys = kStageBytes / (2 * HD * (int)sizeof(T));
  static constexpr int kWarpKeys = kKeys / kWarps;  // a warp's, a stage
  static constexpr int kStepKeys = 32 / GB;    // a team's keys a step
  static constexpr int kSteps = kWarpKeys / (kTeams * kStepKeys);
  static constexpr int kScratch = 32 + GB;     // floats a team: p, alpha
  static constexpr int kAll = kWarps * kTeams;      // teams a block
  static_assert(kSteps >= 1 && kSteps * kTeams * kStepKeys == kWarpKeys,
                "a stage splits into whole steps");
  static_assert((kAll * GB * (HD + 2) + 2 * GB) * 4 <= kStages * kStageBytes,
                "the merge fits in the ring");
  static constexpr size_t smem_bytes() {
    return (size_t)kStages * kStageBytes + (size_t)kAll * kScratch * 4;
  }
};

// one VB-byte copy global -> shared (VB = 4 or 16)
template <int VB>
__device__ __forceinline__ void cp_async_vec(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(VB));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
template <int VB>
__device__ __forceinline__ void zero_vec(void* dst) {
  if constexpr (VB == 16)
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  else if constexpr (VB == 4)
    *reinterpret_cast<uint32_t*>(dst) = 0u;
  else
    *reinterpret_cast<uint16_t*>(dst) = 0;
}

// 4 elements of shared memory, widened to fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Sums v[0..N) across the TEAM lanes of an aligned lane group, scattered:
// afterwards v[j] (j < N / TEAM) holds the team-wide sum of entry
// (lane % TEAM) * (N / TEAM) + j.  N - N / TEAM shuffles.
template <int TEAM, int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[32], int lane) {
  if constexpr (TEAM > 1) {
    constexpr int kOff = TEAM / 2;
    const bool up = lane & kOff;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = up ? v[i] : v[i + N / 2];
      const float keep = up ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
    }
    reduce_scatter<TEAM / 2, N / 2>(v, lane);
  }
}

// One flash-decode block: query heads h0 .. h0 + n_heads - 1 of row b
// (n_heads <= GB) over the keys [lo, hi).  Writes out[b, h] (n_split == 1)
// or the partial triple of this split (acc[0:hd], m, l; m in base e) into
// part[((b * H + h) * n_split + split) * (hd + 2)].  VB is the copy width,
// which the host checked against the row starts and length; sizeof(T) means
// element by element.  Needs DecodeShape<T, HD, GB>::smem_bytes() of
// dynamic shared memory and DecodeShape<T, HD, GB>::kThreads threads.
template <typename T, int HD, int GB, int VB, typename Keys>
__device__ __forceinline__ void decode_block(
    const Keys& keys, int lo, int hi, const T* __restrict__ q,
    long long q_sb, long long q_sh, T* __restrict__ out, long long o_sb,
    long long o_sh, float* __restrict__ part, int b, int h0, int n_heads,
    int H, int hd, int split, int n_split, float scale_log2) {
  using S = DecodeShape<T, HD, GB>;
  constexpr int kE = 4;                             // elements a lane reads
  constexpr int kVE = VB / (int)sizeof(T);          // elements a copy
  constexpr int kCpr = HD / kVE;                    // copies a padded row
  constexpr int kRowsPass = S::kThreads / kCpr;     // rows copied at once
  constexpr int kPasses = S::kKeys / kRowsPass;     // rows a thread copies
  static_assert(kCpr <= S::kThreads && kPasses * kRowsPass == S::kKeys,
                "copies tile the stage");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* scratch = reinterpret_cast<float*>(smem_raw + kStages * kStageBytes);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int team = lane / S::kTeam, li = lane % S::kTeam;

  if (hi <= lo) {  // a split past the row's length: nothing is read
    for (int i = tid; i < n_heads * hd; i += S::kThreads) {
      const int g = i / hd, d = i - g * hd, h = h0 + g;
      if (n_split == 1) {
        store(out + b * o_sb + h * o_sh + d, 0.f);
      } else {
        float* pb =
            part + (((long long)b * H + h) * n_split + split) * (hd + 2);
        pb[d] = 0.f;
        if (d == 0) {
          pb[hd] = kNeg;
          pb[hd + 1] = 0.f;
        }
      }
    }
    return;
  }

  // the pad columns hd..HD of every ring row stay 0 (no copy writes them)
  if (hd < HD) {
    const int pad = HD - hd;
    for (int i = tid; i < kStages * 2 * S::kKeys * pad; i += S::kThreads)
      store(ring + (i / pad) * HD + hd + i % pad, 0.f);
  }

  // copies: thread tid moves chunk cc of the kPasses consecutive rows from
  // r0, so that its keys share a page run
  const int cc = tid % kCpr, r0 = tid / kCpr * kPasses;
  const bool copies = cc * kVE < hd;
  const int n_stages = (hi - lo + S::kKeys - 1) / S::kKeys;
  auto load_stage = [&](int i) {
    if (!copies) return;
    T* ks = ring + (i % kStages) * 2 * S::kKeys * HD;
    T* vs = ks + S::kKeys * HD;
    const int c0 = lo + i * S::kKeys;
    auto cur = keys.at(c0 + r0);
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int r = r0 + u;
      T* kd = ks + r * HD + cc * kVE;
      T* vd = vs + r * HD + cc * kVE;
      if (c0 + r < hi) {
        const T *kr, *vr;
        keys.rows(cur, kr, vr);
        if constexpr (VB >= 4) {
          cp_async_vec<VB>(kd, kr + cc * kVE);
          cp_async_vec<VB>(vd, vr + cc * kVE);
        } else {
          *kd = kr[cc];
          *vd = vr[cc];
        }
      } else {  // past hi: zeros, so that p = 0 meets a finite V row
        zero_vec<VB>(kd);
        zero_vec<VB>(vd);
      }
      keys.step(cur, 1);
    }
  };

  // the block's query heads in registers, scaled to base-2 scores
  float qr[GB][kE], acc[GB][kE];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int d = kE * li + e;
      qr[g][e] = g < n_heads && d < hd
                     ? to_f32(q[b * q_sb + (long long)(h0 + g) * q_sh + d]) *
                           scale_log2
                     : 0.f;
      acc[g][e] = 0.f;
    }
  // the online-softmax state of head (li * kM + j) % GB, j < kM
  constexpr int kM = 32 / S::kTeam;
  float m_r[kM], l_r[kM];
#pragma unroll
  for (int j = 0; j < kM; ++j) {
    m_r[j] = kNeg;
    l_r[j] = 0.f;
  }
  float* sw = scratch + (warp * S::kTeams + team) * S::kScratch;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load_stage(s);
    cp_async_commit();
  }
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; every warp is done with stage i - 1
    if (i + kStages - 1 < n_stages) load_stage(i + kStages - 1);
    cp_async_commit();
    const T* ks = ring + (i % kStages) * 2 * S::kKeys * HD;
    const T* vs = ks + S::kKeys * HD;
    const int c0 = lo + i * S::kKeys;
#pragma unroll 1
    for (int st = 0; st < S::kSteps; ++st) {
      // this team's keys of the step: rows rb + k * kTeams of the stage
      const int rb =
          warp * S::kWarpKeys + st * S::kStepKeys * S::kTeams + team;
      float v[32];
#pragma unroll
      for (int k = 0; k < S::kStepKeys; ++k) {
        const float4 kv = load4(ks + (rb + k * S::kTeams) * HD + kE * li);
#pragma unroll
        for (int g = 0; g < GB; ++g)
          v[k * GB + g] = fmaf(qr[g][0], kv.x,
                               fmaf(qr[g][1], kv.y,
                                    fmaf(qr[g][2], kv.z, qr[g][3] * kv.w)));
      }
      reduce_scatter<S::kTeam, 32>(v, lane);
      // online softmax on the scattered sums: entry idx = k * GB + g, and
      // the lanes li ^ o (o = GB / kM .. kTeam / 2) hold head g's other
      // keys, so each lane keeps the state of its entries' heads
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        const int idx = li * kM + j;
        const bool ok = c0 + rb + idx / GB * S::kTeams < hi;
        float mx = ok ? v[j] : kNeg;
#pragma unroll
        for (int o = GB / kM; o < S::kTeam; o *= 2)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        mx = fmaxf(mx, m_r[j]);
        const float alpha = exp2f(m_r[j] - mx);
        const float p = ok ? exp2f(v[j] - mx) : 0.f;
        float sum = p;
#pragma unroll
        for (int o = GB / kM; o < S::kTeam; o *= 2)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        m_r[j] = mx;
        l_r[j] = fmaf(l_r[j], alpha, sum);
        sw[idx] = p;
        if (idx < GB) sw[32 + idx] = alpha;
      }
      __syncwarp();
#pragma unroll
      for (int g4 = 0; g4 < GB; g4 += 4) {
        const float4 a = *reinterpret_cast<const float4*>(sw + 32 + g4);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          acc[g4][e] *= a.x;
          acc[g4 + 1][e] *= a.y;
          acc[g4 + 2][e] *= a.z;
          acc[g4 + 3][e] *= a.w;
        }
      }
#pragma unroll
      for (int k = 0; k < S::kStepKeys; ++k) {
        const float4 vv = load4(vs + (rb + k * S::kTeams) * HD + kE * li);
        const float x[kE] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int g4 = 0; g4 < GB; g4 += 4) {
          const float4 p = *reinterpret_cast<const float4*>(sw + k * GB + g4);
#pragma unroll
          for (int e = 0; e < kE; ++e) {
            acc[g4][e] = fmaf(p.x, x[e], acc[g4][e]);
            acc[g4 + 1][e] = fmaf(p.y, x[e], acc[g4 + 1][e]);
            acc[g4 + 2][e] = fmaf(p.z, x[e], acc[g4 + 2][e]);
            acc[g4 + 3][e] = fmaf(p.w, x[e], acc[g4 + 3][e]);
          }
        }
      }
      __syncwarp();
    }
  }

  // merge the kAll teams' states once; the ring is free now
  cp_async_wait<0>();
  __syncthreads();
  float* macc = reinterpret_cast<float*>(smem_raw);  // [kAll][GB][HD]
  float* mw = macc + S::kAll * GB * HD;  // [kAll][GB]: max, then weight
  float* ml = mw + S::kAll * GB;         // [kAll][GB]: sum
  float* tot = ml + S::kAll * GB;        // [2][GB]: max, sum
  const int tg = warp * S::kTeams + team;
#pragma unroll
  for (int g = 0; g < GB; ++g)
    *reinterpret_cast<float4*>(macc + (tg * GB + g) * HD + kE * li) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
#pragma unroll
  for (int j = 0; j < kM; ++j) {
    const int g = li * kM + j;  // the lanes of key 0 of each head
    if (g < GB) {
      mw[tg * GB + g] = m_r[j];
      ml[tg * GB + g] = l_r[j];
    }
  }
  __syncthreads();
  if (tid < GB) {
    float mx = kNeg;
    for (int t = 0; t < S::kAll; ++t) mx = fmaxf(mx, mw[t * GB + tid]);
    float l = 0.f;
    for (int t = 0; t < S::kAll; ++t) {
      const float w = exp2f(mw[t * GB + tid] - mx);
      mw[t * GB + tid] = w;
      l = fmaf(ml[t * GB + tid], w, l);
    }
    tot[tid] = mx;
    tot[GB + tid] = l;
  }
  __syncthreads();
  for (int i = tid; i < n_heads * hd; i += S::kThreads) {
    const int g = i / hd, d = i - g * hd, h = h0 + g;
    float o = 0.f;
#pragma unroll
    for (int t = 0; t < S::kAll; ++t)
      o = fmaf(macc[(t * GB + g) * HD + d], mw[t * GB + g], o);
    if (n_split == 1) {
      const float l = tot[GB + g];
      store(out + b * o_sb + h * o_sh + d, o / (l == 0.f ? 1.f : l));
    } else {
      float* pb = part + (((long long)b * H + h) * n_split + split) * (hd + 2);
      pb[d] = o;
      if (d == 0) {
        pb[hd] = tot[g] * 0.6931471805599453f;  // base e
        pb[hd + 1] = tot[GB + g];
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

// ---- host side of the two decode kernels ----
//
// Each kernel's source defines its Args (holding at least the H, KH, hd,
// n_hg, n_split, part, out, o_sb and o_sh that decode_run reads), its
// __global__ kernel template over (T, HD, GB, VB) with grid
// (n_split, KH * n_hg, B), and a Family struct naming it:
//   template <typename V> static constexpr auto kernel = its_kernel<...>;
// Its extern "C" entries then call decode_run, decode_slots and
// vector_bytes.

// the query-head bucket of a block for G = H / K query heads a kv head
inline int group_bucket(int G) { return G <= 4 ? 4 : G <= 8 ? 8 : kGroup; }

// head groups a kv head: blocks of group_bucket(G) query heads for G =
// H / KH; 0 where the shape has no launch (H % KH != 0, grid too high)
inline int head_groups(int H, int KH) {
  if (KH <= 0 || H <= 0 || H % KH != 0) return 0;
  const int gb = group_bucket(H / KH);
  const int n_hg = (H / KH + gb - 1) / gb;
  return (long long)KH * n_hg > 65535 ? 0 : n_hg;
}

// The widest copy (16 or 4 bytes) that the row length and every K/V row
// start allow: the base pointers k, v and the element strides between rows
// (strides[2..8), K's and V's in both kernels); else the element size
// (element by element).  tile_plan.vector_bytes mirrors it.
inline int vector_bytes(int dtype, int hd, const void* k, const void* v,
                        const long long* strides) {
  const int esize = dtype == 1 ? 2 : 4;
  for (int vb : {16, 4}) {
    bool ok = (long long)hd * esize % vb == 0 &&
              reinterpret_cast<uintptr_t>(k) % vb == 0 &&
              reinterpret_cast<uintptr_t>(v) % vb == 0;
    for (int i = 2; i < 8; ++i) ok = ok && strides[i] * esize % vb == 0;
    if (ok) return vb;
  }
  return esize;
}

template <typename T, int HD, int GB, int VB>
struct Variant {
  using type = T;
  static constexpr int hd = HD, gb = GB, vb = VB;
};

// Calls f(Variant<T, HD, GB, VB>{}) for dtype (0 fp32, 1 bf16), hd <= HD,
// bucket gb and copy width vb; an error code where there is no variant.
template <typename T, int HD, int GB, typename F>
int dispatch_vb(int vb, F& f) {
  if (vb == 16) return f(Variant<T, HD, GB, 16>{});
  if (vb == 4) return f(Variant<T, HD, GB, 4>{});
  if constexpr (sizeof(T) == 2)
    if (vb == 2) return f(Variant<T, HD, GB, 2>{});
  return (int)cudaErrorInvalidValue;
}
template <typename T, int HD, typename F>
int dispatch_gb(int gb, int vb, F& f) {
  if (gb == 4) return dispatch_vb<T, HD, 4>(vb, f);
  if (gb == 8) return dispatch_vb<T, HD, 8>(vb, f);
  if (gb == kGroup) return dispatch_vb<T, HD, kGroup>(vb, f);
  return (int)cudaErrorInvalidValue;
}
template <typename T, typename F>
int dispatch_hd(int hd, int gb, int vb, F& f) {
  if (hd <= 0) return (int)cudaErrorInvalidValue;
  if (hd <= 32) return dispatch_gb<T, 32>(gb, vb, f);
  if (hd <= 64) return dispatch_gb<T, 64>(gb, vb, f);
  if (hd <= 128) return dispatch_gb<T, 128>(gb, vb, f);
  return (int)cudaErrorInvalidValue;
}
template <typename F>
int decode_dispatch(int dtype, int hd, int gb, int vb, F&& f) {
  if (dtype == 0) return dispatch_hd<float>(hd, gb, vb, f);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, gb, vb, f);
  return (int)cudaErrorInvalidValue;
}

// Launches Family's kernel on a (B rows) with the copy width that k, v and
// the strides allow and, when a.n_split > 1, the merge of the partial
// triples into a.out; returns cudaGetLastError().
template <typename Family, typename Args>
int decode_run(int dtype, const Args& a, int B, const void* k,
               const void* v, const long long* strides,
               cudaStream_t stream) {
  const int vb = vector_bytes(dtype, a.hd, k, v, strides);
  return decode_dispatch(
      dtype, a.hd, group_bucket(a.H / a.KH), vb, [&](auto var) {
        using V = decltype(var);
        using T = typename V::type;
        using S = DecodeShape<T, V::hd, V::gb>;
        constexpr auto kernel = Family::template kernel<V>;
        constexpr size_t bytes = S::smem_bytes();
        const cudaError_t e = allow_smem<kernel>(bytes);
        if (e != cudaSuccess) return (int)e;
        kernel<<<dim3(a.n_split, a.KH * a.n_hg, B), S::kThreads, bytes,
                 stream>>>(a);
        if (a.n_split > 1)
          combine_kernel<T><<<B * a.H, 128, 0, stream>>>(
              a.part, static_cast<T*>(a.out), 1, a.H, a.n_split, a.hd,
              a.o_sb, 0, a.o_sh);
        return (int)cudaGetLastError();
      });
}

// Blocks of Family's kernel the current card runs at once for this dtype,
// head_dim and G = H / K query heads a kv head (rows), into *out, and the
// dynamic shared memory of one block, into *smem: the split over keys is
// planned against it.  Returns a CUDA error code.
template <typename Family>
int decode_slots(int dtype, int hd, int rows, int* out, int* smem) {
  *out = *smem = 0;
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  return decode_dispatch(dtype, hd, group_bucket(rows), 16, [&](auto var) {
    using V = decltype(var);
    using S = DecodeShape<typename V::type, V::hd, V::gb>;
    constexpr auto kernel = Family::template kernel<V>;
    constexpr size_t bytes = S::smem_bytes();
    cudaError_t e = allow_smem<kernel>(bytes);
    int per_sm = 0, dev = 0, sms = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        S::kThreads, bytes);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    *out = per_sm * sms;
    *smem = (int)bytes;
    return (int)e;
  });
}

}  // namespace repro
