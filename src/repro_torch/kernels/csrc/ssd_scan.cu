// Mamba2 chunked SSD scan for Hopper (sm_90a): every extend of an ssm
// model (prompts, SpecReason verification passes, accepted steps).
//
// Replaces: src/repro/kernels/ssd_scan.py :: ssd_scan (the Pallas TPU kernel
// _ssd_kernel).  Same function: for each (batch, head) and each chunk of Q
// positions,
//   y_i    = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//            + exp(cum_i) C_i . state
//   state' = exp(cum_{Q-1}) state + sum_j exp(cum_{Q-1} - cum_j) dt_j x_j B_j^T
// with cum the inclusive cumulative sum of a * dt over the chunk, B and C
// of group h / (H / G), the state carried from chunk to chunk and emitted
// at the end.  x, B, C are float32 or bfloat16; dt, a, the initial and the
// final state float32; y is written in x's dtype.  The chunk length Q is a
// runtime argument from 1 to 128 and L must be a multiple of it (the
// caller pads with dt = 0, as the JAX package's apply_mamba does).
//
// What bounds it on this card: at mamba2-1.3b's widths (H = 64 heads of
// P = 64, N = 128, one group) a 2048-token prompt needs about 5.4 GFLOP
// (the causal half of each chunk's Q x Q terms, C . B^T once for the
// group's 64 heads; 7.5 with C . B^T per head, as this kernel does it)
// against 74 MB of traffic, so it is bound by operations (0.081 ms at
// 67 TFLOP/s fp32).  The serving path's calls are mostly one chunk of
// 5 to 60 positions, where a launch is bound by latency.
//
// What the design does about it:
//  * The TPU grid's sequential chunk axis, with the state in VMEM scratch,
//    becomes a loop over chunks inside one block; blocks carry nothing
//    between them.  Row p of the state and y[..., p] depend only on column
//    p of x, so a block owns one (16-column P tile, head, batch row): 256
//    blocks at B = 1 for mamba2-1.3b, two resident on each SM (the launch
//    bounds hold a thread to 128 registers; ptxas spills 12-20 bytes).
//  * Per chunk, C . B^T (Q x Q) is accumulated in registers, a thread
//    owning rows ty + 16 r and columns tx + 16 q of it, only where q <= r
//    (the rest lies above the causal diagonal) and only for rows inside
//    the chunk, over 32-wide slices of N staged in shared memory; the
//    same pass adds C . state^T (the entering state's contribution) and,
//    after it, updates that slice of the state.  Then the decayed, causal
//    scores go to shared memory (over the slices' space) and are applied
//    to dt * x.  The fp32 state tile (16 x N) stays in shared memory for
//    the whole sequence.
//  * Everything runs on CUDA cores in fp32, so fp32 results agree with the
//    plain version to 1e-4.  Each block recomputes C . B^T, which is the
//    same for the four P tiles of a head and, with one group, for every
//    head: sharing it, then tensor cores, are the first speed-ups.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kTy = 16, kTx = 16;
constexpr int kThreads = kTy * kTx;  // 256
constexpr int kMaxQ = 128;           // longest chunk
constexpr int kRpt = kMaxQ / kTy;    // score rows (and columns) a thread owns
constexpr int kPT = kTx;             // P columns a block owns
constexpr int kNT = 32;              // state columns staged per slice
constexpr int kMaxN = 256;
constexpr int kSlice = kNT + 1;      // padded row of a staged B / C slice

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// shared floats for chunk Q and state width N
__host__ __device__ inline int region_a(int Q) {
  return Q * (Q + 1) > 2 * Q * kSlice ? Q * (Q + 1) : 2 * Q * kSlice;
}
inline size_t smem_bytes(int Q, int N) {
  return sizeof(float) *
         ((size_t)region_a(Q) + 2 * Q * kPT + kPT * (N + 1) + 2 * Q);
}

// grid (ceil(P / kPT), H, B)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ b,
           const T* __restrict__ c, const float* __restrict__ init,
           T* __restrict__ y, float* __restrict__ fin, int L, int H, int P,
           int G, int N, int Q, long long x_sb, long long x_sl, long long x_sh,
           long long dt_sb, long long dt_sl, long long dt_sh, long long b_sb,
           long long b_sl, long long b_sg, long long c_sb, long long c_sl,
           long long c_sg) {
  extern __shared__ float smem[];
  const int p0 = blockIdx.x * kPT, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (H / G);
  const int np = min(kPT, P - p0);  // real columns of this P tile
  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int sp = Q + 1;             // padded score row
  const int stp = N + 1;            // padded state row

  float* ss = smem;                     // scores (Q, Q+1), after the slices
  float* cs = smem;                     // C slice (Q, kSlice)
  float* bs = smem + Q * kSlice;        // B slice (Q, kSlice)
  float* xd = smem + region_a(Q);       // dt * x (Q, kPT)
  float* xdw = xd + Q * kPT;            // dt * x * exp(cum_last - cum)
  float* st = xdw + Q * kPT;            // state tile (kPT, N+1)
  float* cum = st + kPT * stp;          // (Q,)
  float* dts = cum + Q;                 // (Q,)

  const float av = a[h];
  const long long bh = (long long)bi * H + h;
  const float* ini = init + (bh * P + p0) * N;
  for (int i = tid; i < kPT * N; i += kThreads) {
    const int pp = i / N, n = i % N;
    st[pp * stp + n] = pp < np ? ini[(long long)pp * N + n] : 0.f;
  }
  const T* xb = x + bi * x_sb + h * x_sh + p0;
  const float* dtb = dt + bi * dt_sb + h * dt_sh;
  const T* bb = b + bi * b_sb + g * b_sg;
  const T* cb = c + bi * c_sb + g * c_sg;

  for (int t0 = 0; t0 < L; t0 += Q) {
    __syncthreads();  // the previous chunk is done with cum, xd and ss
    // inclusive cumulative sum of a * dt over the chunk, on warp 0: each
    // lane sums up to four consecutive positions, then one warp scan
    if (tid < 32) {
      const int per = (Q + 31) / 32;
      float loc[kMaxQ / 32];
      float run = 0.f;
      for (int u = 0; u < per; ++u) {
        const int i = tid * per + u;
        const float d = i < Q ? dtb[(long long)(t0 + i) * dt_sl] : 0.f;
        if (i < Q) dts[i] = d;
        run += av * d;
        loc[u] = run;
      }
      float incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffff, incl, o);
        if (tid >= o) incl += up;
      }
      const float before = incl - run;
      for (int u = 0; u < per; ++u) {
        const int i = tid * per + u;
        if (i < Q) cum[i] = before + loc[u];
      }
    }
    __syncthreads();
    const float last = cum[Q - 1];
    for (int i = tid; i < Q * kPT; i += kThreads) {
      const int j = i / kPT, pp = i % kPT;
      const float v =
          pp < np ? to_f32(xb[(long long)(t0 + j) * x_sl + pp]) * dts[j] : 0.f;
      xd[i] = v;
      xdw[i] = v * expf(last - cum[j]);
    }

    // rows ty + kTy * r of the chunk this thread owns: r < rows
    const int rows = (Q - ty + kTy - 1) / kTy;
    float acc[kRpt][kRpt], yoff[kRpt];
#pragma unroll
    for (int r = 0; r < kRpt; ++r) {
      yoff[r] = 0.f;
#pragma unroll
      for (int q = 0; q <= r; ++q) acc[r][q] = 0.f;
    }
    const float chunk_decay = expf(last);
    for (int n0 = 0; n0 < N; n0 += kNT) {
      const int nn = min(kNT, N - n0);
      __syncthreads();  // the previous slice's state update is done
      for (int i = tid; i < Q * kNT; i += kThreads) {
        const int j = i / kNT, k = i % kNT;
        const bool ok = k < nn;
        cs[j * kSlice + k] =
            ok ? to_f32(cb[(long long)(t0 + j) * c_sl + n0 + k]) : 0.f;
        bs[j * kSlice + k] =
            ok ? to_f32(bb[(long long)(t0 + j) * b_sl + n0 + k]) : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < nn; ++k) {
        float cr[kRpt], br[kRpt];
#pragma unroll
        for (int r = 0; r < kRpt; ++r) {
          const int i = ty + kTy * r;
          cr[r] = i < Q ? cs[i * kSlice + k] : 0.f;
          const int j = tx + kTx * r;
          br[r] = j < Q ? bs[j * kSlice + k] : 0.f;
        }
        const float s = st[tx * stp + n0 + k];
#pragma unroll
        for (int r = 0; r < kRpt; ++r) {
          if (r < rows) {
            yoff[r] += cr[r] * s;
            // column tile q > r lies above the diagonal: never needed
#pragma unroll
            for (int q = 0; q <= r; ++q) acc[r][q] += cr[r] * br[q];
          }
        }
      }
      __syncthreads();  // every read of this slice of the old state is done
      for (int e = tid; e < kPT * kNT; e += kThreads) {
        const int pp = e / kNT, k = e % kNT;
        if (k < nn) {
          float s = st[pp * stp + n0 + k] * chunk_decay;
          for (int j = 0; j < Q; ++j) s += xdw[j * kPT + pp] * bs[j * kSlice + k];
          st[pp * stp + n0 + k] = s;
        }
      }
    }
    __syncthreads();  // the slices are dead: the scores take their space
#pragma unroll
    for (int r = 0; r < kRpt; ++r) {
      const int i = ty + kTy * r;
#pragma unroll
      for (int q = 0; q < kRpt; ++q) {
        const int j = tx + kTx * q;
        if (i < Q && j < Q)
          ss[i * sp + j] =
              q <= r && j <= i ? acc[r][q] * expf(cum[i] - cum[j]) : 0.f;
      }
    }
    __syncthreads();
    if (tx < np) {
#pragma unroll
      for (int r = 0; r < kRpt; ++r) {
        const int i = ty + kTy * r;
        if (i < Q) {
          float v = expf(cum[i]) * yoff[r];
          for (int j = 0; j <= i; ++j) v += ss[i * sp + j] * xd[j * kPT + tx];
          store(y + (((long long)bi * L + t0 + i) * H + h) * P + p0 + tx, v);
        }
      }
    }
  }
  __syncthreads();
  float* fo = fin + (bh * P + p0) * N;
  for (int i = tid; i < kPT * N; i += kThreads) {
    const int pp = i / N, n = i % N;
    if (pp < np) fo[(long long)pp * N + n] = st[pp * stp + n];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* b,
           const void* c, const float* init, void* y, float* fin, int B,
           int L, int H, int P, int G, int N, int Q, long long x_sb,
           long long x_sl, long long x_sh, long long dt_sb, long long dt_sl,
           long long dt_sh, long long b_sb, long long b_sl, long long b_sg,
           long long c_sb, long long c_sl, long long c_sg,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(Q, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + kPT - 1) / kPT, H, B);
  ssd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      (const T*)x, dt, a, (const T*)b, (const T*)c, init, (T*)y, fin, L, H, P,
      G, N, Q, x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, b_sg, c_sb,
      c_sl, c_sg);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16.  x: (B, L, H, P)
// with strides (x_sb, x_sl, x_sh, 1); dt: (B, L, H) float32 with strides
// (dt_sb, dt_sl, dt_sh); a: (H,) float32; b, c: (B, L, G, N) with strides
// (*_sb, *_sl, *_sg, 1); init and fin: (B, H, P, N) float32, contiguous;
// y: (B, L, H, P) contiguous.  1 <= Q <= 128, L % Q == 0, H % G == 0,
// 1 <= N <= 256.
extern "C" int ssd_scan_launch(
    int dtype, const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* init, void* y, void* fin, int B, int L, int H,
    int P, int G, int N, int Q, long long x_sb, long long x_sl, long long x_sh,
    long long dt_sb, long long dt_sl, long long dt_sh, long long b_sb,
    long long b_sl, long long b_sg, long long c_sb, long long c_sl,
    long long c_sg, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 ||
      N <= 0 || N > kMaxN || Q <= 0 || Q > kMaxQ || L % Q != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, (const float*)dt, (const float*)a, b, c,
                         (const float*)init, y, (float*)fin, B, L, H, P, G, N,
                         Q, x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl,
                         b_sg, c_sb, c_sl, c_sg, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, (const float*)dt, (const float*)a, b, c,
                                 (const float*)init, y, (float*)fin, B, L, H,
                                 P, G, N, Q, x_sb, x_sl, x_sh, dt_sb, dt_sl,
                                 dt_sh, b_sb, b_sl, b_sg, c_sb, c_sl, c_sg,
                                 st);
  return (int)cudaErrorInvalidValue;
}
