// Helpers of the Gauss-Jordan kernels (gj_solve.cu, gj_panel.cu,
// fused_trip.cu): the pivot score, its total order, the warp-wide argmax,
// element strides and the dynamic shared-memory limits.
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
