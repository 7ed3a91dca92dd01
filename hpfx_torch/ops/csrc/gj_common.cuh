// Helpers of the Gauss-Jordan kernels (gj_solve.cu, gj_panel.cu,
// fused_trip.cu): the pivot score, its total order, the warp-wide argmax,
// the pivot keys and their warp-wide max, the equilibration's scale, element
// strides and the dynamic shared-memory limits.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace hpfx {

constexpr unsigned kFullMask = 0xffffffffu;

// a used row scores below every unused one; NaN ranks highest, as argmax does
__device__ __forceinline__ float pivot_score(float a, bool used) {
  if (used) return -1.0f;
  return isnan(a) ? INFINITY : fabsf(a);
}

// keep the larger score, the lower row index on ties (a total order, so
// every lane of a butterfly ends with the same pivot)
__device__ __forceinline__ void take_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, v, off);
    const int oi = __shfl_xor_sync(kFullMask, i, off);
    take_max(v, i, ov, oi);
  }
}

// A row's pivot key: 0 for a used row (and for a thread past the last row),
// else the bits of |A[r,k]| plus one, NaN ranking as +inf.  The unsigned
// order of the keys is the order of the scores, so one warp-wide max
// instruction finds the best key and a ballot its lowest row: the argmax
// with the lowest index on ties, as pivot_score and take_max give it.
__device__ __forceinline__ unsigned pivot_key(float a, bool used) {
  return used ? 0u : __float_as_uint(isnan(a) ? INFINITY : fabsf(a)) + 1u;
}

// the lowest lane whose key is the warp's largest, and that key
__device__ __forceinline__ int warp_best(unsigned key, unsigned& best) {
  best = __reduce_max_sync(kFullMask, key);
  return __ffs(__ballot_sync(kFullMask, key == best)) - 1;
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
