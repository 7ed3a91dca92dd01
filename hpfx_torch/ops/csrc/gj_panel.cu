// One panel of the blocked Gauss-Jordan solve with full partial pivoting,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernel _gj_panel_kernel of
// hpfx/ops/batched_solve.py, which panel_gj_solve_lanes calls once per
// panel of columns (the net1 Woodbury capacitance systems: dim 182, 364, 700
// at H<=25/51/99, padded to 192/384/704; 780 -> 800 on the 128-bus feeder).
// Per system, on the panel's Pw columns of the (N, N) padded matrix and the
// 0/1 `used` mask carried across panels:
//   TE = 0
//   for k in 0..Pw-1:
//     p    = the unused row with the largest |A[r,k]| over ALL N rows (lowest
//            index on ties; NaN ranks highest, as argmax does)
//     E[:,k] = TE[:,k] = e_p
//     w[r] = A[r,k] / piv off the pivot row, 1 - 1/piv on it
//     A  -= w (outer) A[p,:]       (eliminates column k, normalizes row p)
//     TE -= w (outer) TE[p,:]      (carries T = prod_k (I - w_k e_p^T) on E)
//     mark p used
// and writes the converged panel Ap, TE = T.E, E and the updated mask.  The
// caller applies T = I + (TE - E) E^T to the trailing columns and the RHS
// with matrix products.  No guard on a zero pivot: inf/NaN propagates and
// the caller treats a non-finite lane as diverged.  No atomics.
//
// What bounds it on this card.  Each step is two N x Pw rank-1 updates, so a
// panel is 2 * Pw * N * Pw multiply-adds per system: ~0.8 G per panel at
// N=192, B=2048, in 32 steps that each wait on the previous step's pivot.
// Every multiply-add reads and writes one shared-memory word, so the
// shared-memory bandwidth (~32 words per clock per SM) and the two block
// barriers of each step bound it; device memory is touched once per element
// (the panel in, Ap, TE and E out).
//
// What the design does about it.  One block per system and one thread per
// row.  The A and TE slabs live in dynamic shared memory column-major, at an
// odd leading dimension, so the 32 rows of a warp hit 32 banks in the update
// and in the argmax, and the staged pivot row's columns hit distinct banks
// too; the staged pivot rows are read as broadcasts.  E is one-hot, so it
// never enters shared memory: it is written at the end from the Pw pivot
// indices.  The argmax over N rows goes through shuffles and one word per
// warp (two barriers per step, as gj_kernel_carried).  Slabs up to N=800 at
// Pw=32 take 205 KB, above the default 48 KB: the launch raises the block's
// dynamic shared-memory limit.  The caller picks the panel width from that
// budget; the pivot sequence does not depend on it.  Operands take element
// strides, so a column slice of the lane-major padded matrix is read in place.

#include "gj_common.cuh"

namespace {

using hpfx::allow_smem;
using hpfx::pivot_score;
using hpfx::Strides;
using hpfx::take_max;
using hpfx::warp_argmax;

struct Strides2 {
  long long r, s;   // element strides of (row, system)
};

__global__ void gj_panel_kernel(const float* __restrict__ panel,
                                const float* __restrict__ used_in,
                                float* __restrict__ ap, float* __restrict__ te,
                                float* __restrict__ e,
                                float* __restrict__ used_out, int N, int Pw,
                                Strides sp, Strides so, Strides2 su,
                                Strides2 suo) {
  extern __shared__ float smem[];
  __shared__ float warp_v[32];
  __shared__ int warp_p[32];
  const long long sys = blockIdx.x;
  const int r = threadIdx.x;   // the row this thread owns
  const int lane = r & 31;
  const int warp = r >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool own = r < N;
  const int ld = N | 1;
  float* SA = smem;                          // A[r, c] at SA[c * ld + r]
  float* ST = SA + (size_t)Pw * ld;          // TE, the same layout
  float* prow_a = ST + (size_t)Pw * ld;      // staged pivot row of A
  float* prow_t = prow_a + Pw;               // staged pivot row of TE
  int* piv = reinterpret_cast<int*>(prow_t + Pw);

  bool used = true;
  if (own) {
    used = used_in[sys * su.s + r * su.r] != 0.0f;
    const float* src = panel + sys * sp.s + r * sp.r;
    for (int c = 0; c < Pw; ++c) {
      SA[c * ld + r] = src[c * sp.c];
      ST[c * ld + r] = 0.0f;
    }
  }
  // no barrier here: until the first staging (after a barrier) each thread
  // touches only its own row

  for (int k = 0; k < Pw; ++k) {
    float v = own ? pivot_score(SA[k * ld + r], used) : -2.0f;
    int p = own ? r : INT_MAX;
    warp_argmax(v, p);
    if (lane == 0) {
      warp_v[warp] = v;
      warp_p[warp] = p;
    }
    __syncthreads();   // warp results written; every row of step k-1 done
    v = warp_v[0];
    p = warp_p[0];
    for (int j = 1; j < nwarps; ++j) take_max(v, p, warp_v[j], warp_p[j]);
    if (r < Pw) {
      // TE[p, k] is set to 1 (column k of TE becomes e_p) before the update
      prow_a[r] = SA[r * ld + p];
      prow_t[r] = r == k ? 1.0f : ST[r * ld + p];
    }
    if (r == 0) piv[k] = p;
    __syncthreads();   // pivot rows staged; warp_v/warp_p reads done
    if (own) {
      const float inv_piv = 1.0f / prow_a[k];
      const float wr = r == p ? 1.0f - inv_piv : SA[k * ld + r] * inv_piv;
      for (int c = 0; c < Pw; ++c) SA[c * ld + r] -= wr * prow_a[c];
      for (int c = 0; c < Pw; ++c) {
        const float t = c == k ? (r == p ? 1.0f : 0.0f) : ST[c * ld + r];
        ST[c * ld + r] = t - wr * prow_t[c];
      }
      used = used || r == p;
    }
  }
  // piv[] is complete: its last entry was written before the last barrier
  if (own) {
    const long long o = sys * so.s + r * so.r;
    for (int c = 0; c < Pw; ++c) {
      ap[o + c * so.c] = SA[c * ld + r];
      te[o + c * so.c] = ST[c * ld + r];
      e[o + c * so.c] = piv[c] == r ? 1.0f : 0.0f;
    }
    used_out[sys * suo.s + r * suo.r] = used ? 1.0f : 0.0f;
  }
}

int panel_smem_bytes(int N, int Pw) {
  return (2 * Pw * (N | 1) + 3 * Pw) * (int)sizeof(float);
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronize, and returns cudaGetLastError()
// after the launch (0 = launched).  panel (N, Pw, B) and the outputs ap, te,
// e (N, Pw, B) take (row, column, system) element strides (the outputs share
// theirs); used and used_out (N, B) take (row, system) strides.  `smem` is
// the dynamic shared memory the caller computed; it is checked here.
int hpfx_gj_panel_kernel(const float* panel, const float* used, float* ap,
                         float* te, float* e, float* used_out, int N, int Pw,
                         long long B, long long sp_r, long long sp_c,
                         long long sp_s, long long so_r, long long so_c,
                         long long so_s, long long su_r, long long su_s,
                         long long suo_r, long long suo_s, int smem,
                         void* stream) {
  if (N < 1 || N > 1024 || Pw < 1 || Pw > N || B < 1 || B > INT_MAX ||
      smem < panel_smem_bytes(N, Pw))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(gj_panel_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (N + 31) / 32 * 32;
  gj_panel_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      panel, used, ap, te, e, used_out, N, Pw, Strides{sp_r, sp_c, sp_s},
      Strides{so_r, so_c, so_s}, Strides2{su_r, su_s},
      Strides2{suo_r, suo_s});
  return (int)cudaGetLastError();
}

}  // extern "C"
