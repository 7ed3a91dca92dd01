// Helpers of the Gauss-Jordan kernels (gj_solve.cu, gj_panel.cu,
// fused_trip.cu): the pivot keys, their warp-wide max and the warp's pivot,
// the equilibration's scale, element strides and the dynamic shared-memory
// limits.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace hpfx {

constexpr unsigned kFullMask = 0xffffffffu;

// A row's pivot key: 0 for a used row (and for a thread past the last row),
// else the bits of |A[r,k]| plus one, NaN ranking as +inf.  The unsigned
// order of the keys is the order of the scores, so one warp-wide max
// instruction finds the best key and a ballot its lowest row: the argmax
// with the lowest index on ties (NaN highest), as torch.argmax gives it.
__device__ __forceinline__ unsigned pivot_key(float a, bool used) {
  return used ? 0u : __float_as_uint(isnan(a) ? INFINITY : fabsf(a)) + 1u;
}

// the lowest lane whose key is the warp's largest, and that key
__device__ __forceinline__ int warp_best(unsigned key, unsigned& best) {
  best = __reduce_max_sync(kFullMask, key);
  return __ffs(__ballot_sync(kFullMask, key == best)) - 1;
}

// the warp's pivot: the lowest unused row with the largest key in slot 0,
// over a lane's ROWS rows (rows 0..31 before rows 32..63)
template <int ROWS, int WP>
__device__ __forceinline__ int warp_pivot(const float (&s)[ROWS][WP],
                                          const bool (&used)[ROWS]) {
  unsigned key[ROWS];
  unsigned best = 0u;
#pragma unroll
  for (int t = 0; t < ROWS; ++t) {
    key[t] = pivot_key(s[t][0], used[t]);
    if (key[t] > best) best = key[t];
  }
  best = __reduce_max_sync(kFullMask, best);
  const unsigned lo = __ballot_sync(kFullMask, key[0] == best);
  return lo ? __ffs(lo) - 1
            : 32 + __ffs(__ballot_sync(kFullMask, key[ROWS - 1] == best)) - 1;
}

// the bits of |a|: their unsigned order is the order of |a|, with NaN above
// +inf, so a max over them propagates NaN as torch's amax does
__device__ __forceinline__ unsigned abs_bits(float a) {
  return __float_as_uint(a) & 0x7fffffffu;
}

// the equilibration's scale from a max-abs norm given as abs_bits:
// 1 / max(norm, 1e-30) with IEEE division, NaN staying NaN (torch's
// clamp_min), as equilibrated_lanes computes it
__device__ __forceinline__ float inv_scale(unsigned norm_bits) {
  const float m = __uint_as_float(norm_bits);
  return 1.0f / (m < 1e-30f ? 1e-30f : m);
}

struct Strides {
  long long r, c, s;   // element strides of (row, column, system)
};

// raise a kernel's dynamic shared-memory limit where it needs more than the
// 48 KB every kernel may use without asking
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// the most dynamic shared memory one block of `kernel` may ask for on the
// current device: its opt-in limit less the kernel's static shared words
template <typename Kernel>
cudaError_t max_dynamic_smem(Kernel kernel, int* bytes) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess) *bytes = optin - (int)fa.sharedSizeBytes;
  return e;
}

}  // namespace hpfx
