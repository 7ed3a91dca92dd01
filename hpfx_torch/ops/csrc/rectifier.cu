// Time loop of the single-phase diode-bridge rectifier simulation
// (hpfx_torch/simulate.py), one simulation a thread, for sm_90a.
//
// Replaces: the lax.scan of hpfx/simulate.py:245-266 (simulate_rectifier,
// vmapped over the measurement sweep by characterize_rectifier,
// :300-314).  It is not a Pallas kernel: the JAX package left the scan to
// XLA.  Eager PyTorch would take ~40 launches a substep, ~10^7 for one
// sweep, so the whole loop is one launch.
//
// What bounds it on this card: latency.  A sweep is ~100 simulations,
// each a dependent chain of steps x substeps (640,000 at the reference
// protocol's 80,000 steps of 8 substeps), every substep a few dozen
// float64 operations, two source evaluations (two sines each) and one
// exp.  The bytes it must move are only its outputs, 2 x S x (n + 1)
// doubles.  So one thread carries one simulation, its state (i_l, v_e,
// v_dc) in registers for the whole loop, and the only traffic is the two
// samples a step it writes.  Making it faster (splitting a simulation's
// time axis, precomputing the source) is later work.
//
// The substep is hpfx/simulate.py:177-242 (_rectifier_step) operation for
// operation, in the same order, in float64.  The supply is
// a1·sin(w1·t + p1) + a2·sin(2π·f2·t + p2) per simulation, in float32 as
// the JAX package's sweep computes it (hpfx_torch/simulate.py:SineSource):
// glibc's sinf bit for bit (sinf_ref), and every float32 operation
// rounded as XLA's CPU compiler rounds it, with no contraction of our own
// (the __f*_rn / __d*_rn intrinsics).  The times t0 = i·dt, tk = t0 + k·h
// and tk + h are formed as the JAX package forms them.
// The plain PyTorch twin is hpfx_torch/simulate.py:_simulate_ref.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Circuit {
  double v_drop, R_on, C_emi, C_dc, R1, tau, el, e_dc, h, dt;
};

// glibc's sinf (sysdeps/ieee754/flt-32/s_sinf.c); the constants and the
// steps are hpfx_torch/simulate.py:_sinf's
__constant__ uint32_t kInvPio4[24] = {
    0xa2,       0xa2f9,     0xa2f983,   0xa2f9836e, 0xf9836e4e, 0x836e4e44,
    0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
    0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62,
    0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041};

__device__ __forceinline__ float sinf_ref(float y) {
  const uint32_t bits = __float_as_uint(y);
  const uint32_t top = (bits >> 20) & 0x7ff;
  if (top < 0x398) return y;                       // |y| < 2^-12
  double x = (double)y;
  int n = 0, q = 0;
  if (top >= 0x3f4 && top < 0x42f) {               // pi/4 <= |y| < 120
    n = (__double2int_rz(__dmul_rn(x, 0x1.45f306dc9c883p+23)) + 0x800000)
        >> 24;
    // glibc's fused x - n·pi/2, exactly: n·hi and n·lo are exact
    x = __dsub_rn(__dsub_rn(x, __dmul_rn((double)n, 0x1.921fb54p+0)),
                  __dmul_rn((double)n, 0x1.10b46p-30));
    q = n;
  } else if (top >= 0x42f) {                       // |y| >= 120
    const uint32_t* arr = &kInvPio4[(bits >> 26) & 15];
    const uint64_t m =
        (uint64_t)(((bits & 0xffffff) | 0x800000) << ((bits >> 23) & 7));
    uint64_t r0 = (uint64_t)(uint32_t)(m * arr[0]);
    r0 = ((m * arr[8]) >> 32) | (r0 << 32);
    r0 += m * arr[4];
    const uint64_t nl = (r0 + (1ULL << 61)) >> 62;
    r0 -= nl << 62;
    x = __dmul_rn((double)(int64_t)r0, 0x1.921fb54442d18p-62);
    n = (int)nl;
    q = n + (int)(bits >> 31);
  }
  // glibc's sign table {1, -1, -1, 1}, and its second table's cos
  // coefficients negated in quadrants 2 and 3
  const double xs = ((q + 1) & 2) ? -x : x;
  const double flip = (q & 2) ? -1.0 : 1.0;
  const double x2 = __dmul_rn(x, x);
  double r;
  if ((n & 1) == 0) {
    const double x3 = __dmul_rn(xs, x2);
    r = __dadd_rn(__dadd_rn(xs, __dmul_rn(x3, -0x1.555545995a603p-3)),
                  __dmul_rn(__dmul_rn(x3, x2),
                            __dadd_rn(0x1.1107605230bc4p-7,
                                      __dmul_rn(x2, -0x1.994eb3774cf24p-13))));
  } else {
    const double x4 = __dmul_rn(x2, x2);
    r = __dadd_rn(
        __dadd_rn(__dadd_rn(flip, __dmul_rn(x2, flip * -0x1.ffffffd0c621cp-2)),
                  __dmul_rn(x4, flip * 0x1.55553e1068f19p-5)),
        __dmul_rn(__dmul_rn(x4, x2),
                  __dadd_rn(flip * -0x1.6c087e89a359dp-10,
                            __dmul_rn(x2, flip * 0x1.99343027bf8c3p-16))));
  }
  return __double2float_rn(r);
}

// the float32 fused multiply-add, through float64 (the product is exact)
__device__ __forceinline__ float fmaf_ref(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// v(t) of simulation s: src rows a1, w1, p1, a2, f2, p2 (float64, all but
// w1 float32 values); the harmonic's argument is f2·(2π·t) + p2, with 2π
// and 2π·t rounded to float32
__device__ __forceinline__ float source(const double* src, int s, int S,
                                        double t) {
  const float arg1 = __fadd_rn(__double2float_rn(__dmul_rn(src[S + s], t)),
                               (float)src[2 * S + s]);
  const float arg2 =
      fmaf_ref((float)src[4 * S + s],
               __fmul_rn(0x1.921fb6p+2f, __double2float_rn(t)),
               (float)src[5 * S + s]);
  return fmaf_ref((float)src[s], sinf_ref(arg1),
                  __fmul_rn((float)src[3 * S + s], sinf_ref(arg2)));
}

__device__ __forceinline__ double sign3(double x, double hi, double lo) {
  // jnp.where(x >= hi, 1, jnp.where(x <= lo, -1, 0)) with >=/<= or >/<
  return x >= hi ? 1.0 : (x <= lo ? -1.0 : 0.0);
}

__global__ void rectifier_kernel(const double* __restrict__ src,
                                 double* __restrict__ i_out,
                                 double* __restrict__ v_out, int S,
                                 long long n1, int substeps, Circuit p) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  double i_l = 0.0, v_e = 0.0, v_dc = 0.0;
  double* i_row = i_out + (long long)s * n1;
  double* v_row = v_out + (long long)s * n1;
  for (long long i = 0; i < n1; ++i) {
    const double t0 = __dmul_rn((double)i, p.dt);
    // the bridge current of the state at the step's start
    const double over = fabs(v_e) - v_dc - p.v_drop;
    const double sgn = v_e > 0.0 ? 1.0 : (v_e < 0.0 ? -1.0 : 0.0);
    i_row[i] = sgn * fmax(0.0, over) / p.R_on;
    v_row[i] = (double)source(src, s, S, t0);
    if (i + 1 == n1) break;              // the last step's state is unused
    for (int k = 0; k < substeps; ++k) {
      const double tk = __dadd_rn(t0, __dmul_rn((double)k, p.h));
      const float v_s0 = source(src, s, S, tk);
      const float v_s1 = source(src, s, S, __dadd_rn(tk, p.h));
      const double thr = v_dc + p.v_drop;
      // EMI node: blocking drift (sign-free; v_e may cross zero)
      const double v_drift = v_e + p.h * i_l / p.C_emi;
      // conduction polarity at substep start, else after a drift crossing
      const double s0 = sign3(v_e, thr, -thr);
      const double s_x = v_drift > thr ? 1.0 : (v_drift < -thr ? -1.0 : 0.0);
      const bool started = s0 != 0.0;
      const double s_eff = started ? s0 : s_x;
      const bool conducting = s_eff != 0.0;
      const double sg = conducting ? s_eff : 1.0;
      // turn-on event: fraction of the substep spent blocking
      const double db = v_drift - v_e;
      const double db_safe = fabs(db) > 1e-30 ? db : 1e-30;
      const double theta =
          started ? 0.0 : fmin(fmax((sg * thr - v_e) / db_safe, 0.0), 1.0);
      const double h_c = conducting ? (1.0 - theta) * p.h : 0.0;
      // exact clamp exponential in u = s·v_e coordinates
      const double u0 = started ? sg * v_e : thr;
      const double u_star = thr + p.R_on * sg * i_l;
      const double u_end = u_star + (u0 - u_star) * exp(-h_c / p.tau);
      const double v_e_new = conducting ? sg * u_end : v_drift;
      // conducted charge, exactly, from C_emi flux balance over [theta, 1]
      double q_c = conducting ? sg * i_l * h_c - p.C_emi * (u_end - u0) : 0.0;
      q_c = fmax(q_c, 0.0);              // O(dt) turn-off inside the substep
      // DC link: exact leak + impulse charge
      const double v_dc_new = v_dc * p.e_dc + q_c / p.C_dc;
      // series branch: exact R1/L1 exponential toward the average drive
      // (the supply's average in float32, as the JAX package forms it)
      const double drive =
          ((double)__fmul_rn(0.5f, __fadd_rn(v_s0, v_s1))
           - 0.5 * (v_e + v_e_new)) / p.R1;
      const double i_l_new = i_l * p.el + (1.0 - p.el) * drive;
      i_l = i_l_new;
      v_e = v_e_new;
      v_dc = v_dc_new;
    }
  }
}

}  // namespace

extern "C" {

// src (6, S) float64 rows a1, w1, p1, a2, f2, p2; i_out, v_out (S, n1)
// float64, row-major; the circuit's constants as RectifierParams and the
// host derive them.  Returns the launch's cudaError_t.
int hpfx_rectifier(const void* src, void* i_out, void* v_out, int S,
                   long long n1, int substeps, double v_drop, double R_on,
                   double C_emi, double C_dc, double R1, double tau,
                   double el, double e_dc, double h, double dt,
                   void* stream) {
  if (S <= 0 || n1 <= 0) return 0;
  Circuit p{v_drop, R_on, C_emi, C_dc, R1, tau, el, e_dc, h, dt};
  const int threads = 32;
  const int blocks = (S + threads - 1) / threads;
  rectifier_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const double*)src, (double*)i_out, (double*)v_out, S, n1, substeps,
      p);
  return (int)cudaGetLastError();
}

}  // extern "C"
