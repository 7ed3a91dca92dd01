// One panel of the blocked Gauss-Jordan solve with full partial pivoting,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernel _gj_panel_kernel of
// hpfx/ops/batched_solve.py, which panel_gj_solve_lanes calls once per
// panel of columns (the net1 Woodbury capacitance systems: dim 182, 364, 700
// at H<=25/51/99, padded to 192/384/704; 780 -> 800 on the 128-bus feeder).
// Per system, on the panel's Pw columns of the (N, N) padded matrix and the
// 0/1 `used` mask carried across panels, it computes what the TPU kernel
// computes, restricted to the live columns:
//   for k in 0..Pw-1:
//     p    = the unused row with the largest |A[r,k]| over ALL N rows (lowest
//            index on ties; NaN ranks highest, as argmax does)
//     w[r] = A[r,k] / piv off the pivot row, 1 - 1/piv on it
//     A[:, c] -= w A[p, c]   for c > k    (the columns still to eliminate)
//     Z[:, c] -= w Z[p, c]   for c < k    (Z = T.E - E, T the panel's
//     Z[:, k]  = -w                         composite row transform, E the
//                                           one-hot pivot columns)
//     mark p used
// and writes Z (N, Pw), the Pw pivot rows and the updated mask.  A's
// columns up to k are eliminated already (the TPU kernel keeps updating
// them: cancellation noise of an ulp) and T.E's columns beyond k are zero,
// so one slot per column holds A[r,c] before step c and Z[r,c] from step c
// on: Pw multiply-adds per row and step, half of the TPU kernel's.  E, T.E
// and the converged panel (a permutation) follow from the pivots; the caller
// gathers the pivot rows of the trailing columns and of the right-hand sides
// and applies T = I + Z E^T with one matrix product.  No guard on a zero
// pivot: inf/NaN propagates and the caller treats a non-finite lane as
// diverged.  No atomics.
//
// What bounds it on this card.  The function reads the panel and the mask
// and writes Z, the mask and Pw indices: 4 B (2 N Pw + 2 N + Pw) bytes per
// system, ~0.03 ms at N=192, Pw=32, B=2048.  Its Pw^2 N multiply-adds per
// system take a third of that at the float32 peak.  What bounds the kernel
// is latency: Pw dependent steps, each an argmax over all N rows, a block
// barrier and a broadcast of the pivot row.
//
// What the design does about it.  One block per system.  A thread keeps 32
// register slots: ROWS = 32 / Pw consecutive rows of the panel, Pw and ROWS
// template constants, instantiated for (1, 32), (2, 16) and (4, 8), so a
// block of at most 1024 threads takes 1024, 2048 or 4096 padded rows
// (PANEL_LIMITS in ops/batched_solve.py: past 1024 rows the blocked solve
// narrows its panel, as the reference narrows its own to fit VMEM).  The
// column loops are unrolled, so the slots live in registers: ~30 more a
// thread, within the 64 a block of 1024 threads may have (__launch_bounds__
// holds ptxas to that).  The step loop runs at run time (unrolling it does
// not build), so the slots rotate: at step k slot j holds column (k + j)
// mod Pw, the update writes each result one slot down, and the working
// column is always slot 0.  No index depends on k, so a step has no
// selects.  Each step:
//   - the warp's argmax: each thread takes the best of its rows (the lowest
//     on ties), then one warp-wide max of the pivot keys (their scores'
//     bits, so the order is the scores') and a ballot for the lowest lane
//     holding it: rows ascend with threads, so that is the warp's lowest
//     row with the largest key, and the pivots are those of the direct
//     elimination.  That row writes its key, its index and its Pw slots to
//     the warp's words in shared memory, the only shared-memory writes;
//   - one block barrier; every warp takes the same max and ballot over the
//     warp words and reads the winning warp's staged row as float4
//     broadcasts;
//   - ROWS (Pw - 1) multiply-adds, the rotation included.
// The warp words and staged rows are double-buffered: step k+1 writes the
// other buffer, and step k+2 writes this one only after every thread has
// passed step k+1's barrier, so one barrier a step suffices.  Operands take
// element strides, so a column slice of the caller's buffer is read in
// place, lane-major or batch-major.

#include "gj_common.cuh"

namespace {

using hpfx::pivot_key;
using hpfx::Strides;
using hpfx::warp_best;

constexpr int kMaxThreads = 1024;   // one block per system
constexpr int kSlots = 32;          // register slots a thread: ROWS x PW

struct Strides2 {
  long long a, s;   // element strides of (row or column, system)
};

template <int ROWS, int PW>
__global__ void __launch_bounds__(kMaxThreads)
    gj_panel_kernel(const float* __restrict__ panel,
                    const float* __restrict__ used_in, float* __restrict__ z,
                    int* __restrict__ piv, float* __restrict__ used_out,
                    int N, Strides sp, Strides sz, Strides2 sv, Strides2 su,
                    Strides2 suo) {
  static_assert(PW % 4 == 0, "the staged row is read as float4");
  static_assert(ROWS * PW == kSlots, "a thread holds kSlots slots");
  __shared__ __align__(16) float stage[2][32][PW];   // each warp's best row
  __shared__ unsigned warp_k[2][32];                 // its key
  __shared__ int warp_p[2][32];                      // its index
  const long long sys = blockIdx.x;
  const int t = threadIdx.x;   // this thread owns rows ROWS t .. ROWS t + ROWS-1
  const int lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;

  // slot j of a row holds column (k + j) mod PW at step k: A[r, c] for c >= k,
  // Z[r, c] for c < k.  The update shifts the slots down by one as it writes
  // them, so the working column is always slot 0 and every index is static
  float s[ROWS][PW];
  bool used[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int r = ROWS * t + j;
    used[j] = true;   // a row past the last is never a pivot
    if (r < N) {
      const float* src = panel + sys * sp.s + r * sp.r;
#pragma unroll
      for (int c = 0; c < PW; ++c) s[j][c] = src[c * sp.c];
      used[j] = used_in[sys * su.s + r * su.a] != 0.0f;
    } else {
#pragma unroll
      for (int c = 0; c < PW; ++c) s[j][c] = 0.0f;
    }
  }
  int my_piv = 0;   // thread k keeps the pivot of column k

#pragma unroll 1
  for (int k = 0; k < PW; ++k) {
    const int buf = k & 1;
    // the best of this thread's rows (the lowest on ties), then of the warp's
    // threads (the lowest lane): rows ascend with threads, so the warp's best
    // is its lowest row with the largest key
    unsigned key = pivot_key(s[0][0], used[0]);
    int jb = 0;
#pragma unroll
    for (int j = 1; j < ROWS; ++j) {
      const unsigned kj = pivot_key(s[j][0], used[j]);
      if (kj > key) {
        key = kj;
        jb = j;
      }
    }
    unsigned best;
    if (lane == warp_best(key, best)) {
      float* dst = stage[buf][warp];
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        if (j == jb)
#pragma unroll
          for (int c = 0; c < PW; c += 4)
            *reinterpret_cast<float4*>(dst + c) =
                make_float4(s[j][c], s[j][c + 1], s[j][c + 2], s[j][c + 3]);
      warp_k[buf][warp] = best;
      warp_p[buf][warp] = ROWS * t + jb;
    }
    __syncthreads();   // warp words written; step k-1's reads of them done
    // the lowest warp with the largest key holds the pivot (lanes past the
    // last warp take key 0, and lose a tie to the warps below them)
    const int w = warp_best(lane < nwarps ? warp_k[buf][lane] : 0u, best);
    const int p = warp_p[buf][w];
    const float* prow = stage[buf][w];   // row p, in slot order
    float4 q = *reinterpret_cast<const float4*>(prow);
    const float inv_piv = __frcp_rn(q.x);   // 1/piv, rounded as 1.0f / piv
    float wr[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      wr[j] = ROWS * t + j == p ? 1.0f - inv_piv : s[j][0] * inv_piv;
    if (t == k) my_piv = p;
    // slot c takes column k+1+c; the last slot takes Z's column k
#pragma unroll
    for (int c = 0; c < PW; c += 4) {
      if (c > 0) q = *reinterpret_cast<const float4*>(prow + c);
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        if (c > 0) s[j][c - 1] = s[j][c] - wr[j] * q.x;
        s[j][c] = s[j][c + 1] - wr[j] * q.y;
        s[j][c + 1] = s[j][c + 2] - wr[j] * q.z;
        s[j][c + 2] = s[j][c + 3] - wr[j] * q.w;
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      s[j][PW - 1] = -wr[j];
      used[j] = used[j] || ROWS * t + j == p;
    }
  }
  // PW shifts: slot c holds Z's column c again

#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int r = ROWS * t + j;
    if (r >= N) continue;
    const long long o = sys * sz.s + r * sz.r;
    if (sz.c == 1 && (o & 3) == 0 &&
        (reinterpret_cast<unsigned long long>(z) & 15) == 0) {
#pragma unroll
      for (int c = 0; c < PW; c += 4)
        *reinterpret_cast<float4*>(z + o + c) =
            make_float4(s[j][c], s[j][c + 1], s[j][c + 2], s[j][c + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < PW; ++c) z[o + c * sz.c] = s[j][c];
    }
    used_out[sys * suo.s + r * suo.a] = used[j] ? 1.0f : 0.0f;
  }
  if (t < PW) piv[sys * sv.s + t * sv.a] = my_piv;
}

template <int ROWS, int PW>
int launch(const float* panel, const float* used, float* z, int* piv,
           float* used_out, int N, long long B, Strides sp, Strides sz,
           Strides2 sv, Strides2 su, Strides2 suo, cudaStream_t stream) {
  const int threads = ((N + ROWS - 1) / ROWS + 31) / 32 * 32;
  gj_panel_kernel<ROWS, PW><<<(unsigned)B, threads, 0, stream>>>(
      panel, used, z, piv, used_out, N, sp, sz, sv, su, suo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronize, and returns cudaGetLastError()
// after the launch (0 = launched).  panel and z (N, Pw, B) take (row,
// column, system) element strides; piv (Pw, B) int32 takes (column, system)
// strides; used and used_out (N, B) take (row, system) strides.  Pw is 32,
// 16 or 8, a thread then holding 1, 2 or 4 rows: N at most 1024, 2048 or
// 4096 (PANEL_LIMITS in ops/batched_solve.py).
int hpfx_gj_panel_kernel(const float* panel, const float* used, float* z,
                         int* piv, float* used_out, int N, int Pw,
                         long long B, long long sp_r, long long sp_c,
                         long long sp_s, long long sz_r, long long sz_c,
                         long long sz_s, long long sv_c, long long sv_s,
                         long long su_r, long long su_s, long long suo_r,
                         long long suo_s, void* stream) {
  if ((Pw != 32 && Pw != 16 && Pw != 8) || N < Pw ||
      N > kMaxThreads * (kSlots / Pw) || B < 1 || B > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const Strides sp{sp_r, sp_c, sp_s}, sz{sz_r, sz_c, sz_s};
  const Strides2 sv{sv_c, sv_s}, su{su_r, su_s}, suo{suo_r, suo_s};
  cudaStream_t st = (cudaStream_t)stream;
  if (Pw == 32)
    return launch<1, 32>(panel, used, z, piv, used_out, N, B, sp, sz, sv, su,
                         suo, st);
  if (Pw == 16)
    return launch<2, 16>(panel, used, z, piv, used_out, N, B, sp, sz, sv, su,
                         suo, st);
  return launch<4, 8>(panel, used, z, piv, used_out, N, B, sp, sz, sv, su, suo,
                      st);
}

}  // extern "C"
