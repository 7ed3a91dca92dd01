// Batched dense solves A x = b by Gauss-Jordan elimination with virtual
// partial pivoting, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels of hpfx/ops/batched_solve.py:
//   gj_kernel          <- _gj_kernel          (dims < 64; the sweep's dim-26
//                                              Woodbury capacitance solve)
//   gj_kernel_carried  <- _gj_kernel_carried  (dims 64..192; the dim-96
//                                              exact-linear seed solve)
//   gj_kernel_unrolled <- _gj_kernel_unrolled (the same dims, chosen with
//                                              HPFX_GJ_UNROLLED=1)
// Both compute, per system, exactly what the TPU kernels compute:
//   for k in 0..n-1:
//     p    = the unused row with the largest |A[r,k]| (lowest index on ties;
//            NaN ranks highest, as argmax does)
//     w[r] = A[r,k] / piv off the pivot row, 1 - 1/piv on it (piv = A[p,k],
//            1/piv taken once and multiplied, as on the TPU)
//     [A | b] -= w (outer) [A | b][p]      (eliminates column k and
//                                           normalizes the pivot row at once)
//     mark p used
//   x[i, q] = sum_r A[r,i] * b[r,q]        (A has become a permutation)
// No guard on a zero pivot: inf/NaN propagates and the caller treats a
// non-finite lane as diverged.  No atomics: results are deterministic.
//
// What bounds it on this card.  Operands are lane-major, (n, n, B) with the
// batch last, so one system's n*n entries are strided by B in device memory
// and each is read once (604 MB at n=96, B=16384: ~0.2 ms at 3.35 TB/s).
// The elimination does n*n*(n+R) multiply-adds per system, every one of
// which reads the thread's own row element and the staged pivot element from
// shared memory and writes the row element back: shared-memory bandwidth
// (~32 words per clock per SM), not device memory and not the FP32 units,
// is the bound, together with the barriers of the n sequential steps.
//
// What the design does about it.  One thread owns one row of [A | b] in
// dynamic shared memory, at an odd leading dimension so the 32 rows of a
// warp fall in 32 different banks; the pivot row is staged once per step and
// read as a broadcast.  The next step's pivot column is carried in a
// register, taken from the row the thread has just updated (the TPU kernel
// _gj_kernel_carried's idea), so the argmax reads no shared memory.
//   gj_kernel: one warp per system, four systems per block; the argmax is
//     five shuffles and a step needs no block barrier, only __syncwarp.
//   gj_kernel_carried: one block per system (n rounded up to warps); the
//     argmax goes through shuffles and one word per warp, two barriers per
//     step.  Above 48 KB of shared memory (n > 109 at R=1) the launch raises
//     the block's dynamic shared-memory limit.
//   gj_kernel_unrolled: gj_kernel_carried with the column loop of the
//     update unrolled at compile time, instantiated for padded dims NP =
//     64, 96, 128, 160, 192 (pad rows and columns are zero, pad rows start
//     used).  Every column index is static, so a thread keeps its row of A
//     in registers: the update reads only the staged pivot row from shared
//     memory (as float4 broadcasts) and writes nothing there, the next
//     working column is selected from the registers during the update, and
//     the pivot thread stages its row.  The right-hand sides stay in shared
//     memory (R is a run-time value).  The step loop runs at run time:
//     unrolling it too (NP^2 straight-line multiply-adds per instance, as
//     the TPU kernel unrolls its step loop at trace time) did not build
//     within 600 s on the card's host.
// The strided loads are accepted as they are: neighbouring blocks read
// neighbouring addresses and meet in L2.  A tensor-core or TMA design is for
// later work.

#include "gj_common.cuh"

namespace {

using hpfx::allow_smem;
using hpfx::max_dynamic_smem;
using hpfx::pivot_score;
using hpfx::Strides;
using hpfx::take_max;
using hpfx::warp_argmax;

constexpr int kWarpsPerBlock = 4;   // gj_kernel: systems per block
constexpr int kRowsPerLane = 2;     // gj_kernel: n < 64 rows over 32 lanes

// load one system's [A | b] (n rows of w = n + R) into S at leading dim ld
__device__ __forceinline__ void load_system(float* S, const float* A,
                                            const float* b, int n, int w,
                                            int ld, Strides sa, Strides sb,
                                            long long sys, int t0, int dt) {
  const float* As = A + sys * sa.s;
  const float* bs = b + sys * sb.s;
  for (int e = t0; e < n * w; e += dt) {
    const int r = e / w;
    const int c = e - r * w;
    S[r * ld + c] = c < n ? As[r * sa.r + c * sa.c]
                          : bs[r * sb.r + (c - n) * sb.c];
  }
}

// x[i, q] = sum_r S[r, i] * S[r, n + q]
__device__ __forceinline__ void store_solution(float* x, const float* S,
                                               int n, int R, int ld,
                                               Strides sx, long long sys,
                                               int t0, int dt) {
  for (int e = t0; e < n * R; e += dt) {
    const int i = e / R;
    const int q = e - i * R;
    float acc = 0.0f;
    for (int r = 0; r < n; ++r) acc += S[r * ld + i] * S[r * ld + n + q];
    x[sys * sx.s + i * sx.r + q * sx.c] = acc;
  }
}

__global__ void gj_kernel(const float* __restrict__ A,
                          const float* __restrict__ b, float* __restrict__ x,
                          int n, int R, long long B, Strides sa, Strides sb,
                          Strides sx) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long sys = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (sys >= B) return;   // no block barrier below: a warp may leave
  const int w = n + R;
  const int ld = w | 1;
  float* S = smem + (size_t)warp * (n + 1) * ld;   // n rows of [A | b]
  float* prow = S + (size_t)n * ld;                // the staged pivot row

  load_system(S, A, b, n, w, ld, sa, sb, sys, lane, 32);
  __syncwarp();

  float col[kRowsPerLane];
  bool used[kRowsPerLane];
#pragma unroll
  for (int t = 0; t < kRowsPerLane; ++t) {
    const int r = lane + 32 * t;
    used[t] = false;
    col[t] = r < n ? S[r * ld] : 0.0f;
  }
  for (int k = 0; k < n; ++k) {
    float v = -2.0f;
    int p = INT_MAX;
#pragma unroll
    for (int t = 0; t < kRowsPerLane; ++t) {
      const int r = lane + 32 * t;
      if (r < n) take_max(v, p, pivot_score(col[t], used[t]), r);
    }
    warp_argmax(v, p);
    for (int c = lane; c < w; c += 32) prow[c] = S[p * ld + c];
    __syncwarp();
    const float inv_piv = 1.0f / prow[k];
#pragma unroll
    for (int t = 0; t < kRowsPerLane; ++t) {
      const int r = lane + 32 * t;
      if (r < n) {
        const float wr = r == p ? 1.0f - inv_piv : col[t] * inv_piv;
        float* row = S + r * ld;
        for (int c = 0; c < w; ++c) row[c] -= wr * prow[c];
        col[t] = k + 1 < n ? row[k + 1] : 0.0f;
        used[t] = used[t] || r == p;
      }
    }
    __syncwarp();
  }
  store_solution(x, S, n, R, ld, sx, sys, lane, 32);
}

__global__ void gj_kernel_carried(const float* __restrict__ A,
                                  const float* __restrict__ b,
                                  float* __restrict__ x, int n, int R,
                                  Strides sa, Strides sb, Strides sx) {
  extern __shared__ float smem[];
  __shared__ float warp_v[32];
  __shared__ int warp_p[32];
  const long long sys = blockIdx.x;
  const int r = threadIdx.x;   // the row this thread owns
  const int lane = r & 31;
  const int warp = r >> 5;
  const int nwarps = blockDim.x >> 5;
  const int w = n + R;
  const int ld = w | 1;
  float* S = smem;
  float* prow = S + (size_t)n * ld;

  load_system(S, A, b, n, w, ld, sa, sb, sys, threadIdx.x, blockDim.x);
  __syncthreads();

  float col = r < n ? S[r * ld] : 0.0f;
  bool used = false;
  for (int k = 0; k < n; ++k) {
    float v = r < n ? pivot_score(col, used) : -2.0f;
    int p = r < n ? r : INT_MAX;
    warp_argmax(v, p);
    if (lane == 0) {
      warp_v[warp] = v;
      warp_p[warp] = p;
    }
    __syncthreads();   // warp results written; every row of step k-1 done
    v = warp_v[0];
    p = warp_p[0];
    for (int j = 1; j < nwarps; ++j) take_max(v, p, warp_v[j], warp_p[j]);
    for (int c = threadIdx.x; c < w; c += blockDim.x) prow[c] = S[p * ld + c];
    __syncthreads();   // pivot row staged; warp_v/warp_p reads done
    if (r < n) {
      const float inv_piv = 1.0f / prow[k];
      const float wr = r == p ? 1.0f - inv_piv : col * inv_piv;
      float* row = S + r * ld;
      for (int c = 0; c < w; ++c) row[c] -= wr * prow[c];
      col = k + 1 < n ? row[k + 1] : 0.0f;
      used = used || r == p;
    }
  }
  __syncthreads();
  store_solution(x, S, n, R, ld, sx, sys, threadIdx.x, blockDim.x);
}

template <int NP>
__global__ void __launch_bounds__(NP)
    gj_kernel_unrolled(const float* __restrict__ A,
                       const float* __restrict__ b, float* __restrict__ x,
                       int n, int R, Strides sa, Strides sb, Strides sx) {
  constexpr int kWarps = NP / 32;
  extern __shared__ float4 smem4[];
  __shared__ float warp_v[kWarps];
  __shared__ int warp_p[kWarps];
  float* prow = reinterpret_cast<float*>(smem4);   // the staged [A | b] row
  const int ldb = R | 1, lda = NP | 1;
  float* Sb = prow + ((NP + R + 3) & ~3);          // b, NP rows at ldb
  float* Sa = Sb + NP * ldb;                       // A at the end, at lda
  const long long sys = blockIdx.x;
  const int r = threadIdx.x;   // the row this thread owns
  const int lane = r & 31, warp = r >> 5;
  const float* As = A + sys * sa.s;
  const float* bs = b + sys * sb.s;

  float row[NP];
#pragma unroll
  for (int c = 0; c < NP; ++c)
    row[c] = (r < n && c < n) ? As[r * sa.r + c * sa.c] : 0.0f;
  for (int q = 0; q < R; ++q)
    Sb[r * ldb + q] = r < n ? bs[r * sb.r + q * sb.c] : 0.0f;
  bool used = r >= n;   // pad rows are never pivots
  float col = row[0];   // this row's entry in the working column

#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    float v = pivot_score(col, used);
    int p = r;
    warp_argmax(v, p);
    if (lane == 0) {
      warp_v[warp] = v;
      warp_p[warp] = p;
    }
    __syncthreads();   // warp results written; step k-1's prow reads done
    v = warp_v[0];
    p = warp_p[0];
#pragma unroll
    for (int j = 1; j < kWarps; ++j) take_max(v, p, warp_v[j], warp_p[j]);
    if (r == p) {
#pragma unroll
      for (int c = 0; c < NP; c += 4)
        *reinterpret_cast<float4*>(prow + c) =
            make_float4(row[c], row[c + 1], row[c + 2], row[c + 3]);
      for (int q = 0; q < R; ++q) prow[NP + q] = Sb[r * ldb + q];
    }
    __syncthreads();   // pivot row staged; warp_v/warp_p reads done
    const float inv_piv = 1.0f / prow[k];
    const float wr = r == p ? 1.0f - inv_piv : col * inv_piv;
    // the column loop, unrolled: static indices keep the row in registers,
    // and the next working column is selected on the way
#pragma unroll
    for (int c = 0; c < NP; c += 4) {
      const float4 pv = *reinterpret_cast<const float4*>(prow + c);
      row[c] -= wr * pv.x;
      row[c + 1] -= wr * pv.y;
      row[c + 2] -= wr * pv.z;
      row[c + 3] -= wr * pv.w;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j == k + 1) col = row[c + j];
    }
    for (int q = 0; q < R; ++q) Sb[r * ldb + q] -= wr * prow[NP + q];
    used = used || r == p;
  }
#pragma unroll
  for (int c = 0; c < NP; ++c) Sa[r * lda + c] = row[c];
  __syncthreads();
  // x[i, q] = sum_r A[r, i] * b[r, q]
  for (int e = r; e < n * R; e += NP) {
    const int i = e / R;
    const int q = e - i * R;
    float acc = 0.0f;
    for (int rr = 0; rr < n; ++rr) acc += Sa[rr * lda + i] * Sb[rr * ldb + q];
    x[sys * sx.s + i * sx.r + q * sx.c] = acc;
  }
}

int unrolled_smem_bytes(int NP, int R) {
  return (((NP + R + 3) & ~3) + NP * (R | 1) + NP * (NP | 1)) *
         (int)sizeof(float);
}

template <int NP>
int launch_unrolled(const float* A, const float* b, float* x, int n, int R,
                    long long B, Strides sa, Strides sb, Strides sx,
                    cudaStream_t stream) {
  const int smem = unrolled_smem_bytes(NP, R);
  int limit = 0;
  cudaError_t e = max_dynamic_smem(gj_kernel_unrolled<NP>, &limit);
  if (e != cudaSuccess) return (int)e;
  if (smem > limit) return (int)cudaErrorInvalidValue;
  e = allow_smem(gj_kernel_unrolled<NP>, smem);
  if (e != cudaSuccess) return (int)e;
  gj_kernel_unrolled<NP><<<(unsigned)B, NP, smem, stream>>>(A, b, x, n, R, sa,
                                                           sb, sx);
  return (int)cudaGetLastError();
}

int smem_bytes(int n, int R, int systems_per_block) {
  const int ld = (n + R) | 1;
  return systems_per_block * (n + 1) * ld * (int)sizeof(float);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, does not synchronize, and returns
// cudaGetLastError() after the launch (0 = launched).  Where it takes `smem`,
// that is the dynamic shared memory the caller computed; it is checked
// against the kernel's need.  The unrolled kernel sizes its own.

int hpfx_gj_kernel(const float* A, const float* b, float* x, int n, int R,
                   long long B, long long sa_r, long long sa_c,
                   long long sa_s, long long sb_r, long long sb_c,
                   long long sb_s, long long sx_r, long long sx_c,
                   long long sx_s, int smem, void* stream) {
  if (n < 1 || n >= 64 || R < 1 || B < 1 ||
      smem < smem_bytes(n, R, kWarpsPerBlock))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(gj_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gj_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, smem,
              (cudaStream_t)stream>>>(A, b, x, n, R, B,
                                      Strides{sa_r, sa_c, sa_s},
                                      Strides{sb_r, sb_c, sb_s},
                                      Strides{sx_r, sx_c, sx_s});
  return (int)cudaGetLastError();
}

int hpfx_gj_kernel_carried(const float* A, const float* b, float* x, int n,
                           int R, long long B, long long sa_r,
                           long long sa_c, long long sa_s, long long sb_r,
                           long long sb_c, long long sb_s, long long sx_r,
                           long long sx_c, long long sx_s, int smem,
                           void* stream) {
  if (n < 1 || n > 1024 || R < 1 || B < 1 || B > INT_MAX ||
      smem < smem_bytes(n, R, 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(gj_kernel_carried, smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = (n + 31) / 32 * 32;
  gj_kernel_carried<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      A, b, x, n, R, Strides{sa_r, sa_c, sa_s}, Strides{sb_r, sb_c, sb_s},
      Strides{sx_r, sx_c, sx_s});
  return (int)cudaGetLastError();
}

int hpfx_gj_kernel_unrolled(const float* A, const float* b, float* x, int n,
                            int R, long long B, long long sa_r,
                            long long sa_c, long long sa_s, long long sb_r,
                            long long sb_c, long long sb_s, long long sx_r,
                            long long sx_c, long long sx_s, void* stream) {
  if (n < 1 || n > 192 || R < 1 || B < 1 || B > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const Strides sa{sa_r, sa_c, sa_s}, sb{sb_r, sb_c, sb_s},
      sx{sx_r, sx_c, sx_s};
  cudaStream_t st = (cudaStream_t)stream;
  // padded up to the next instance
  if (n <= 64) return launch_unrolled<64>(A, b, x, n, R, B, sa, sb, sx, st);
  if (n <= 96) return launch_unrolled<96>(A, b, x, n, R, B, sa, sb, sx, st);
  if (n <= 128) return launch_unrolled<128>(A, b, x, n, R, B, sa, sb, sx, st);
  if (n <= 160) return launch_unrolled<160>(A, b, x, n, R, B, sa, sb, sx, st);
  return launch_unrolled<192>(A, b, x, n, R, B, sa, sb, sx, st);
}

const char* hpfx_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
