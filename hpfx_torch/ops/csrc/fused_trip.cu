// The fused Newton trip of the harmonic power flow for NVIDIA Hopper
// (sm_90a): one whole arrow Newton iteration per scenario in one launch.
//
// Replaces the TPU (Pallas) kernel _trip_kernel of validation/fused_trip.py
// (launched by fused_trip there).  Per scenario, with the state lane-major
// (batch last) and the mismatch f in the grouped (harmonic-block) order of
// hpfx_torch.arrow:
//   1. assemble the H arrow blocks [D_h | f_h | U_h] (2n x (2n + R),
//      R = 1 + 2 n_nl): block 0 holds the fundamental power rows and the
//      nonlinear buses' current rows, cropped to d0 = 2n - 1 - c and
//      identity-padded; block h >= 1 the current rows of harmonic h.  The
//      Norton self-coupling is folded into the diagonals, and the U columns
//      are unit vectors at the coupling coordinates;
//   2. solve every block by row- and column-equilibrated Gauss-Jordan with
//      virtual partial pivoting: the unused row with the largest |A[r,k]|
//      (lowest index on ties, NaN highest), one fused rank-1 update with
//      w = A[r,k]/piv off the pivot row and 1 - 1/piv on it, as in
//      gj_solve.cu;
//   3. coupled devices: the Woodbury capacitance system S y = C.z with
//      S = I + C.G (dim r = 2 H n_nl), the same elimination; dx = z - X.y;
//   4. update (V_m, V_a), then the new mismatch (dense Y.V, or the
//      cancellation-free line-flow form) and err = max |f|;
//   5. scenarios with act = 0 skip 1-4 and keep their state bit for bit.
//
// What bounds it on this card.  Per scenario ~1.7 KB of state moves in and
// out at net2 H<=25 (V_m, V_a (13, 4) each way, f (102) each way, S, the
// scalars): 28 MB at B=16384, ~8 us at 3.35 TB/s.  The least arithmetic a
// trip needs, counting each solve as LU, is ~4e4 flops per scenario (the
// 13 block solves ~9e3, the dim-26 capacitance solve ~1.3e4, the assembly
// ~7e3, the mismatch and the rest), ~0.5 GFLOP at 12288 active scenarios,
// ~8 us at the 67 TFLOP/s float32 peak.  Neither is what bounds it in
// practice: each warp runs 8 + 26 dependent pivot steps, each a shuffle
// argmax and a __syncwarp, so latency and issue slots do.
//
// What the design does about it.  One warp per scenario and up to 8
// scenarios per block (fewer where the scratch would not fit shared
// memory).  The block copies the constants (Y, Y_N, I_N, the line data)
// into shared memory once, and moves the scenarios' state with neighbouring
// threads on neighbouring scenarios, so the lane-major loads and stores use
// whole 32-byte sectors.  Within the warp:
//   - the lanes assemble the blocks over (harmonic, bus) pairs;
//   - lane h eliminates block h in registers: n and n_nl are template
//     constants, so every index is static, and the data-dependent pivot row
//     is read through a select chain;
//   - the lanes own rows of the capacitance system in shared memory (odd
//     leading dimension) as gj_kernel's warp does;
//   - the update and the mismatch run with the lanes over (harmonic, bus)
//     and (harmonic, line) pairs; flows are summed into the buses in line
//     order, without atomics, so the results are deterministic.

#include "gj_common.cuh"

namespace {

using hpfx::allow_smem;
using hpfx::kFullMask;
using hpfx::max_dynamic_smem;
using hpfx::pivot_score;
using hpfx::take_max;
using hpfx::warp_argmax;

constexpr int kMaxWarps = 8;        // scenarios per block
constexpr int kCapRowsPerLane = 2;  // capacitance dims up to 64
constexpr int kMaxH = 32;           // one lane per harmonic block
constexpr int kMaxL = 128;          // lines: one scenario fits at kMaxH

struct Dims {
  int H, n, m, c, L, coupled, nnl, dim, d0, r, nconst;
  long long B;
};

struct C2 {
  float re, im;
};

__device__ __forceinline__ C2 cmul(C2 a, C2 b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// NaN-propagating max, as amax
__device__ __forceinline__ float nanmax(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// words of the region that holds the blocks, then the capacitance system,
// then the line flows
__host__ __device__ inline int trip_big(int H, int n, int nnl, int L) {
  const int K2 = 2 * n, R = 1 + 2 * nnl, ldb = (K2 + R) | 1;
  const int r = 2 * H * nnl, lds = (r + 1) | 1;
  int big = H * K2 * ldb;
  big = big > r * lds + lds ? big : r * lds + lds;
  return big > 4 * H * L ? big : 4 * H * L;
}

// words of one scenario's scratch
__host__ __device__ inline int trip_warp_floats(int H, int n, int nnl, int L,
                                                int dim) {
  const int HN = H * n, K2 = 2 * n, R = 1 + 2 * nnl, r = 2 * H * nnl;
  return 12 * HN + 2 * dim + 2 * n + 4 + trip_big(H, n, nnl, L) +
         H * K2 * R + H * K2 + 2 * r + 2 * nnl * H + 1;
}

// one scenario's scratch in shared memory
struct Scratch {
  float *Vm, *Va, *f, *Sr, *Si, *scal;  // the state in; scal: err, act, inj
  float *cs, *sn, *vcr, *vci;           // cos, sin and V at the old state
  float* big;                           // blocks, then S, then line flows
  float *sol, *dx, *y, *ccol;           // block solutions, step, Woodbury
  float *Vm2, *Va2, *v2r, *v2i, *yvr, *yvi, *ir, *ii, *f2, *err2;
};

__device__ Scratch trip_layout(float* p, const Dims& d) {
  const int HN = d.H * d.n, K2 = 2 * d.n, R = 1 + 2 * d.nnl;
  Scratch s;
  float** fields[] = {&s.Vm, &s.Va, &s.f, &s.Sr, &s.Si, &s.scal, &s.cs,
                      &s.sn, &s.vcr, &s.vci, &s.big, &s.sol, &s.dx, &s.y,
                      &s.ccol, &s.Vm2, &s.Va2, &s.v2r, &s.v2i, &s.yvr,
                      &s.yvi, &s.ir, &s.ii, &s.f2, &s.err2};
  const int sizes[] = {HN, HN, d.dim, d.n, d.n, 4, HN, HN, HN, HN,
                       trip_big(d.H, d.n, d.nnl, d.L), d.H * K2 * R,
                       d.H * K2, d.r, d.r, HN, HN, HN, HN, HN, HN,
                       d.nnl * d.H, d.nnl * d.H, d.dim, 1};
  for (int i = 0; i < 25; ++i) {
    *fields[i] = p;
    p += sizes[i];
  }
  return s;
}

// the constants in shared memory, in the order of TripConsts.packed
struct Consts {
  const float *Yr, *Yi, *YNr, *YNi, *INr, *INi, *Ysr, *Ysi, *dr, *di, *lp;
  const int *lf, *lt;
};

__device__ Consts consts_view(const float* k, const int* lines,
                              const Dims& d) {
  const int HNN = d.H * d.n * d.n;
  const int yn = d.coupled ? d.nnl * d.H * d.H : d.nnl * d.H;
  Consts c;
  c.Yr = k;
  c.Yi = c.Yr + HNN;
  c.YNr = c.Yi + HNN;
  c.YNi = c.YNr + yn;
  c.INr = c.YNi + yn;
  c.INi = c.INr + d.nnl * d.H;
  c.Ysr = c.INi + d.nnl * d.H;
  c.Ysi = c.Ysr + d.H * d.L;
  c.dr = c.Ysi + d.H * d.L;
  c.di = c.dr + d.H * d.n;
  c.lp = c.di + d.H * d.n;
  c.lf = lines;
  c.lt = lines + d.L;
  return c;
}

// row of block h that unit column q of U marks: the coupling coordinate q
// (angles then magnitudes of the nonlinear buses); the same index numbers
// the unknown, since each block orders rows and columns alike
template <int N, int NNL>
__device__ __forceinline__ int unit_row(int h, int q, int m, int c) {
  if (h == 0)
    return q < NNL ? (m - 1) + q : (N - 1) + (m - c) + (q - NNL);
  return q < NNL ? m + q : N + m + (q - NNL);
}

// the rows of bus i in block h: Jacobian entries, right-hand side, U columns
template <int N, int NNL>
__device__ void assemble_bus(const Scratch& s, const Consts& k, const Dims& d,
                             int h, int i, float inj) {
  constexpr int K2 = 2 * N, RB = 2 * NNL, LDB = (K2 + 1 + RB) | 1;
  const int H = d.H, m = d.m, c = d.c, d0 = d.d0, hn = h * N;
  float* blk = s.big + h * K2 * LDB;

  // the Norton self-coupling K(h, h) at a nonlinear bus
  C2 kv = {0.f, 0.f}, ka = {0.f, 0.f};
  if (i >= m) {
    const int e = d.coupled ? ((i - m) * H + h) * H + h : (i - m) * H + h;
    const C2 y = {k.YNr[e], k.YNi[e]};
    const C2 t1 = cmul(y, {s.cs[hn + i], s.sn[hn + i]});
    const C2 t2 = cmul(y, {s.vcr[hn + i], s.vci[hn + i]});
    kv = {-t1.re * inj, -t1.im * inj};   // -Y_N Vn s
    ka = {t2.im * inj, -t2.re * inj};    // -j Y_N V s
  }
  const bool power = h == 0 && i < m;
  C2 I = {0.f, 0.f};                     // (Y V)_i at the fundamental
  if (power)
    for (int j = 0; j < N; ++j) {
      const C2 t = cmul({k.Yr[i * N + j], k.Yi[i * N + j]},
                        {s.vcr[j], s.vci[j]});
      I.re += t.re;
      I.im += t.im;
    }

  // entry of the real (part 0) or imaginary (1) row of bus i against the
  // angle (mag 0) or magnitude (1) of bus j
  auto entry = [&](int part, int mag, int j) -> float {
    const C2 y = {k.Yr[(hn + i) * N + j], k.Yi[(hn + i) * N + j]};
    C2 out;
    if (power) {
      const C2 v = {s.vcr[i], s.vci[i]};
      if (!mag) {   // dS/dA = j V_i conj(delta_ij I_i - Y_ij V_j)
        C2 t = cmul(y, {s.vcr[j], s.vci[j]});
        t = {(i == j ? I.re : 0.f) - t.re, (i == j ? I.im : 0.f) - t.im};
        const C2 a = {v.re * t.re + v.im * t.im, v.im * t.re - v.re * t.im};
        out = {-a.im, a.re};
      } else {      // dS/dV = delta_ij Vn_i conj(I_i) + V_i conj(Y_ij Vn_j)
        const C2 t = cmul(y, {s.cs[j], s.sn[j]});
        out = {v.re * t.re + v.im * t.im, v.im * t.re - v.re * t.im};
        if (i == j) {
          out.re += s.cs[i] * I.re + s.sn[i] * I.im;
          out.im += s.sn[i] * I.re - s.cs[i] * I.im;
        }
      }
    } else if (!mag) {   // dI/dA = j Y_ij V_j (+ K_A)
      const C2 t = cmul(y, {s.vcr[hn + j], s.vci[hn + j]});
      out = {-t.im, t.re};
      if (i == j && i >= m) out = {out.re + ka.re, out.im + ka.im};
    } else {             // dI/dV = Y_ij Vn_j (+ K_V)
      out = cmul(y, {s.cs[hn + j], s.sn[hn + j]});
      if (i == j && i >= m) out = {out.re + kv.re, out.im + kv.im};
    }
    return part ? out.im : out.re;
  };

  auto write_row = [&](int row, int part) {
    float* out = blk + row * LDB;
    for (int col = 0; col < K2; ++col) {
      int mag, j;
      if (h == 0) {   // cropped: no slack angle, no PV magnitudes
        if (col < N - 1) {
          mag = 0;
          j = col + 1;
        } else if (col < d0) {
          mag = 1;
          j = col - (N - 1) + c;
        } else {
          out[col] = 0.f;
          continue;
        }
      } else {
        mag = col >= N;
        j = mag ? col - N : col;
      }
      out[col] = entry(part, mag, j);
    }
    out[K2] = h == 0 ? s.f[row] : s.f[d0 + (h - 1) * K2 + row];
    for (int q = 0; q < RB; ++q)
      out[K2 + 1 + q] = row == unit_row<N, NNL>(h, q, m, c) ? 1.f : 0.f;
  };

  if (h == 0) {
    if (i >= 1) write_row(i - 1, 0);             // P or Re I row
    if (i >= c) write_row((N - 1) + (i - c), 1); // Q or Im I row
    if (i == 0)                                  // the identity padding
      for (int row = d0; row < K2; ++row)
        for (int col = 0; col < K2 + 1 + RB; ++col)
          blk[row * LDB + col] = col == row ? 1.f : 0.f;
  } else {
    write_row(i, 0);
    write_row(N + i, 1);
  }
}

// lane h: block h [D | f | U] in registers, equilibrated, eliminated;
// writes its solution [z | X] (2n x R) to s.sol
template <int N, int NNL>
__device__ void solve_block(const Scratch& s, int h) {
  constexpr int K2 = 2 * N, R = 1 + 2 * NNL, W = K2 + R, LDB = W | 1;
  const float* blk = s.big + h * K2 * LDB;
  float M[K2][W];
#pragma unroll
  for (int i = 0; i < K2; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) M[i][j] = blk[i * LDB + j];

  // D_r A D_c x' = D_r b, x = D_c x'
#pragma unroll
  for (int i = 0; i < K2; ++i) {
    float mx = 0.f;
#pragma unroll
    for (int j = 0; j < K2; ++j) mx = fmaxf(mx, fabsf(M[i][j]));
    const float ri = 1.f / fmaxf(mx, 1e-30f);
#pragma unroll
    for (int j = 0; j < W; ++j) M[i][j] *= ri;
  }
  float cj[K2];
#pragma unroll
  for (int j = 0; j < K2; ++j) {
    float mx = 0.f;
#pragma unroll
    for (int i = 0; i < K2; ++i) mx = fmaxf(mx, fabsf(M[i][j]));
    cj[j] = 1.f / fmaxf(mx, 1e-30f);
#pragma unroll
    for (int i = 0; i < K2; ++i) M[i][j] *= cj[j];
  }

  unsigned used = 0u;
#pragma unroll
  for (int k = 0; k < K2; ++k) {
    float v = -2.f;
    int p = 0;
#pragma unroll
    for (int r = 0; r < K2; ++r) {
      const float sc = pivot_score(M[r][k], (used >> r) & 1u);
      if (sc > v) {   // ascending scan: the lowest index wins ties
        v = sc;
        p = r;
      }
    }
    float prow[W];
#pragma unroll
    for (int j = 0; j < W; ++j) prow[j] = M[0][j];
#pragma unroll
    for (int r = 1; r < K2; ++r)
#pragma unroll
      for (int j = 0; j < W; ++j) prow[j] = p == r ? M[r][j] : prow[j];
    const float inv_piv = 1.f / prow[k];
#pragma unroll
    for (int r = 0; r < K2; ++r) {
      const float wr = r == p ? 1.f - inv_piv : M[r][k] * inv_piv;
#pragma unroll
      for (int j = 0; j < W; ++j) M[r][j] -= wr * prow[j];
    }
    used |= 1u << p;
  }

  // M's first K2 columns are a permutation: x[i, q] = sum_r M[r,i] b'[r,q]
  float* out = s.sol + h * K2 * R;
#pragma unroll
  for (int i = 0; i < K2; ++i)
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < K2; ++r) acc += M[r][i] * M[r][K2 + q];
      out[i * R + q] = acc * cj[i];
    }
}

// the Woodbury correction: builds S = I + C.G and C.z, eliminates, and
// writes dx = z - X.y
template <int N, int NNL>
__device__ void woodbury(const Scratch& s, const Consts& k, const Dims& d,
                         int lane, float inj) {
  constexpr int K2 = 2 * N, RB = 2 * NNL, R = 1 + RB;
  const int H = d.H, m = d.m, c = d.c, r = d.r, lds = (r + 1) | 1;
  float* S = s.big;
  float* prow = S + r * lds;

  // row (h, t, d) of S: columns (p, v) = sum over s2 of
  // K(t, s2)[h, p, d] G[p][(s2, d), v] for p != h; K(., 0) = K_A, K(., 1) =
  // K_V, and t picks their real or imaginary part
#pragma unroll
  for (int t = 0; t < kCapRowsPerLane; ++t) {
    const int rho = lane + 32 * t;
    if (rho >= r) continue;
    const int h = rho / RB, rem = rho - h * RB, tt = rem / NNL;
    const int dd = rem - tt * NNL;
    float* row = S + rho * lds;
    float rhs = 0.f;
    for (int p = 0; p < H; ++p) {
      float* dst = row + p * RB;
      if (p == h) {
        for (int v = 0; v < RB; ++v) dst[v] = 0.f;
        continue;
      }
      const int e = (dd * H + h) * H + p, b = p * N + m + dd;
      const C2 y = {k.YNr[e], k.YNi[e]};
      const C2 t1 = cmul(y, {s.cs[b], s.sn[b]});
      const C2 t2 = cmul(y, {s.vcr[b], s.vci[b]});
      const float k0 = tt ? -t2.re * inj : t2.im * inj;
      const float k1 = tt ? -t1.im * inj : -t1.re * inj;
      const float* g0 = s.sol + (p * K2 + unit_row<N, NNL>(p, dd, m, c)) * R;
      const float* g1 =
          s.sol + (p * K2 + unit_row<N, NNL>(p, NNL + dd, m, c)) * R;
      for (int v = 0; v < RB; ++v) dst[v] = k0 * g0[1 + v] + k1 * g1[1 + v];
      rhs += k0 * g0[0] + k1 * g1[0];
    }
    row[rho] += 1.f;
    row[r] = rhs;
  }
  __syncwarp();

  // row then column max-abs equilibration
#pragma unroll
  for (int t = 0; t < kCapRowsPerLane; ++t) {
    const int rho = lane + 32 * t;
    if (rho >= r) continue;
    float* row = S + rho * lds;
    float mx = 0.f;
    for (int j = 0; j < r; ++j) mx = fmaxf(mx, fabsf(row[j]));
    const float ri = 1.f / fmaxf(mx, 1e-30f);
    for (int j = 0; j <= r; ++j) row[j] *= ri;
  }
  __syncwarp();
  for (int j = lane; j < r; j += 32) {
    float mx = 0.f;
    for (int i = 0; i < r; ++i) mx = fmaxf(mx, fabsf(S[i * lds + j]));
    const float cc = 1.f / fmaxf(mx, 1e-30f);
    s.ccol[j] = cc;
    for (int i = 0; i < r; ++i) S[i * lds + j] *= cc;
  }
  __syncwarp();

  // Gauss-Jordan with virtual pivoting, the next pivot column carried
  float col[kCapRowsPerLane];
  bool used[kCapRowsPerLane];
#pragma unroll
  for (int t = 0; t < kCapRowsPerLane; ++t) {
    const int rho = lane + 32 * t;
    used[t] = false;
    col[t] = rho < r ? S[rho * lds] : 0.f;
  }
  for (int kk = 0; kk < r; ++kk) {
    float v = -2.f;
    int p = INT_MAX;
#pragma unroll
    for (int t = 0; t < kCapRowsPerLane; ++t) {
      const int rho = lane + 32 * t;
      if (rho < r) take_max(v, p, pivot_score(col[t], used[t]), rho);
    }
    warp_argmax(v, p);
    for (int j = lane; j <= r; j += 32) prow[j] = S[p * lds + j];
    __syncwarp();
    const float inv_piv = 1.f / prow[kk];
#pragma unroll
    for (int t = 0; t < kCapRowsPerLane; ++t) {
      const int rho = lane + 32 * t;
      if (rho < r) {
        const float wr = rho == p ? 1.f - inv_piv : col[t] * inv_piv;
        float* row = S + rho * lds;
        for (int j = 0; j <= r; ++j) row[j] -= wr * prow[j];
        col[t] = kk + 1 < r ? row[kk + 1] : 0.f;
        used[t] = used[t] || rho == p;
      }
    }
    __syncwarp();
  }
  for (int i = lane; i < r; i += 32) {
    float acc = 0.f;
    for (int j = 0; j < r; ++j) acc += S[j * lds + i] * S[j * lds + r];
    s.y[i] = acc * s.ccol[i];
  }
  __syncwarp();
  for (int e = lane; e < H * K2; e += 32) {
    const int h = e / K2;
    float acc = s.sol[e * R];
    for (int v = 0; v < RB; ++v) acc -= s.sol[e * R + 1 + v] * s.y[h * RB + v];
    s.dx[e] = acc;
  }
}

__device__ __forceinline__ C2 polar_diff(float mu_a, float th_a, float mu_b,
                                         float th_b) {
  // mu_a e^{j th_a} - mu_b e^{j th_b} without cancellation
  const float delta = th_b - th_a;
  const float sh = sinf(0.5f * delta);
  const float re = (mu_a - mu_b) + 2.f * mu_b * sh * sh;
  const float im = -mu_b * sinf(delta);
  float sa, ca;
  sincosf(th_a, &sa, &ca);
  return {ca * re - sa * im, ca * im + sa * re};
}

// one trip of one scenario, by its warp
template <int N, int NNL>
__device__ void trip_warp(const Scratch& s, const Consts& k, const Dims& d,
                          int lane) {
  constexpr int K2 = 2 * N, R = 1 + 2 * NNL;
  const int H = d.H, m = d.m, c = d.c, HN = H * N;
  const float inj = s.scal[2];

  for (int e = lane; e < HN; e += 32) {
    float sv, cv;
    sincosf(s.Va[e], &sv, &cv);
    s.cs[e] = cv;
    s.sn[e] = sv;
    s.vcr[e] = s.Vm[e] * cv;
    s.vci[e] = s.Vm[e] * sv;
  }
  __syncwarp();
  for (int e = lane; e < HN; e += 32)
    assemble_bus<N, NNL>(s, k, d, e / N, e % N, inj);
  __syncwarp();
  if (lane < H) solve_block<N, NNL>(s, lane);
  __syncwarp();
  if (d.coupled && d.r > 0) {
    woodbury<N, NNL>(s, k, d, lane, inj);
  } else {
    for (int e = lane; e < H * K2; e += 32) s.dx[e] = s.sol[e * R];
  }
  __syncwarp();

  // the update: block 0 holds no slack angle and no PV magnitudes
  for (int e = lane; e < HN; e += 32) {
    const int h = e / N, i = e - h * N;
    float va = s.Va[e], vm = s.Vm[e];
    if (h == 0) {
      if (i >= 1) va -= s.dx[i - 1];
      if (i >= c) vm -= s.dx[(N - 1) + (i - c)];
    } else {
      va -= s.dx[h * K2 + i];
      vm -= s.dx[h * K2 + N + i];
    }
    s.Va2[e] = va;
    s.Vm2[e] = vm;
    float sv, cv;
    sincosf(va, &sv, &cv);
    s.v2r[e] = vm * cv;
    s.v2i[e] = vm * sv;
  }
  __syncwarp();

  // Y.V at the new state
  if (d.L) {
    float* fl = s.big;   // per (h, l): from-end flow, to-end flow
    for (int e = lane; e < H * d.L; e += 32) {
      const int h = e / d.L, l = e - h * d.L;
      const int fb = h * N + k.lf[l], tb = h * N + k.lt[l];
      const float a_ff = k.lp[l], inv_tau = k.lp[d.L + l];
      const float shift = k.lp[2 * d.L + l];
      const C2 ys = {k.Ysr[e], k.Ysi[e]};
      const C2 ff = cmul(ys, polar_diff(s.Vm2[fb] * a_ff, s.Va2[fb],
                                        s.Vm2[tb] * inv_tau,
                                        s.Va2[tb] + shift));
      const C2 ft = cmul(ys, polar_diff(s.Vm2[tb], s.Va2[tb],
                                        s.Vm2[fb] * inv_tau,
                                        s.Va2[fb] - shift));
      fl[4 * e] = ff.re;
      fl[4 * e + 1] = ff.im;
      fl[4 * e + 2] = ft.re;
      fl[4 * e + 3] = ft.im;
    }
    __syncwarp();
    for (int e = lane; e < HN; e += 32) {
      const int h = e / N, i = e - h * N;
      C2 acc = cmul({k.dr[e], k.di[e]}, {s.v2r[e], s.v2i[e]});
      for (int l = 0; l < d.L; ++l)
        if (k.lf[l] == i) {
          acc.re += fl[4 * (h * d.L + l)];
          acc.im += fl[4 * (h * d.L + l) + 1];
        }
      for (int l = 0; l < d.L; ++l)
        if (k.lt[l] == i) {
          acc.re += fl[4 * (h * d.L + l) + 2];
          acc.im += fl[4 * (h * d.L + l) + 3];
        }
      s.yvr[e] = acc.re;
      s.yvi[e] = acc.im;
    }
  } else {
    for (int e = lane; e < HN; e += 32) {
      const int h = e / N;
      C2 acc = {0.f, 0.f};
      for (int j = 0; j < N; ++j) {
        const C2 t = cmul({k.Yr[e * N + j], k.Yi[e * N + j]},
                          {s.v2r[h * N + j], s.v2i[h * N + j]});
        acc.re += t.re;
        acc.im += t.im;
      }
      s.yvr[e] = acc.re;
      s.yvi[e] = acc.im;
    }
  }
  // scaled Norton injections (I_N - Y_N V) s, (n_nl, H)
  for (int e = lane; e < NNL * H; e += 32) {
    const int dd = e / H, h = e - dd * H;
    C2 acc = {0.f, 0.f};
    if (d.coupled) {
      for (int p = 0; p < H; ++p) {
        const int y = e * H + p, b = p * N + m + dd;
        const C2 t = cmul({k.YNr[y], k.YNi[y]}, {s.v2r[b], s.v2i[b]});
        acc.re += t.re;
        acc.im += t.im;
      }
    } else {
      const int b = h * N + m + dd;
      acc = cmul({k.YNr[e], k.YNi[e]}, {s.v2r[b], s.v2i[b]});
    }
    s.ir[e] = (k.INr[e] - acc.re) * inj;
    s.ii[e] = (k.INi[e] - acc.im) * inj;
  }
  __syncwarp();

  // the grouped mismatch: block 0 = [P; Re I(0); Q; Im I(0)], then
  // [Re I(h); Im I(h)] for h >= 1
  float mx = 0.f;
  for (int g = lane; g < d.dim; g += 32) {
    float val;
    if (g < d.d0) {
      const bool imag = g >= N - 1;
      const int i = imag ? c + (g - (N - 1)) : g + 1;
      if (i < m) {   // S + V conj(Y V) at the fundamental
        const float vr = s.v2r[i], vi = s.v2i[i];
        const float yr = s.yvr[i], yi = s.yvi[i];
        val = imag ? s.Si[i] + (vi * yr - vr * yi)
                   : s.Sr[i] + (vr * yr + vi * yi);
      } else {
        const int e = (i - m) * H;
        val = imag ? s.yvi[i] + s.ii[e] : s.yvr[i] + s.ir[e];
      }
    } else {
      const int q = (g - d.d0) % K2, h = 1 + (g - d.d0) / K2;
      const bool imag = q >= N;
      const int i = imag ? q - N : q, e = h * N + i;
      val = imag ? s.yvi[e] : s.yvr[e];
      if (i >= m) val += imag ? s.ii[(i - m) * H + h] : s.ir[(i - m) * H + h];
    }
    s.f2[g] = val;
    mx = nanmax(mx, fabsf(val));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = nanmax(mx, __shfl_xor_sync(kFullMask, mx, off));
  if (lane == 0) s.err2[0] = mx;
}

// rows e of a (E, B) lane-major tensor into the scratch of the block's
// scenarios, neighbouring threads on neighbouring scenarios
__device__ void load_rows(float* base, int wf, int off, const float* g,
                          int E, long long b0, long long B, int warps) {
  for (int t = threadIdx.x; t < E * warps; t += blockDim.x) {
    const int e = t / warps, w = t - e * warps;
    if (b0 + w < B) base[w * wf + off + e] = g[(long long)e * B + b0 + w];
  }
}

// the scenario's new rows where act = 1, its old ones where act = 0
__device__ void store_rows(const float* base, int wf, int off_new,
                           int off_old, int off_act, float* g, int E,
                           long long b0, long long B, int warps) {
  for (int t = threadIdx.x; t < E * warps; t += blockDim.x) {
    const int e = t / warps, w = t - e * warps;
    if (b0 + w >= B) continue;
    const float* sw = base + w * wf;
    g[(long long)e * B + b0 + w] =
        sw[off_act] > 0.5f ? sw[off_new + e] : sw[off_old + e];
  }
}

template <int N, int NNL>
__global__ void fused_trip_kernel(
    const float* __restrict__ Vm, const float* __restrict__ Va,
    const float* __restrict__ f, const float* __restrict__ err,
    const float* __restrict__ act, const float* __restrict__ Sr,
    const float* __restrict__ Si, const float* __restrict__ inj,
    const float* __restrict__ consts, const int* __restrict__ lines,
    float* __restrict__ Vm_o, float* __restrict__ Va_o,
    float* __restrict__ f_o, float* __restrict__ err_o, Dims d) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b0 = (long long)blockIdx.x * warps;
  float* kc = smem;
  int* kl = reinterpret_cast<int*>(smem + d.nconst);
  float* base = smem + d.nconst + 2 * d.L;
  const int wf = trip_warp_floats(d.H, N, NNL, d.L, d.dim);
  const Scratch s0 = trip_layout(base, d);
  const int oVm = s0.Vm - base, oVa = s0.Va - base, of = s0.f - base;
  const int oSr = s0.Sr - base, oSi = s0.Si - base, osc = s0.scal - base;

  for (int i = threadIdx.x; i < d.nconst; i += blockDim.x) kc[i] = consts[i];
  for (int i = threadIdx.x; i < 2 * d.L; i += blockDim.x) kl[i] = lines[i];
  const int HN = d.H * N;
  load_rows(base, wf, oVm, Vm, HN, b0, d.B, warps);
  load_rows(base, wf, oVa, Va, HN, b0, d.B, warps);
  load_rows(base, wf, of, f, d.dim, b0, d.B, warps);
  load_rows(base, wf, oSr, Sr, N, b0, d.B, warps);
  load_rows(base, wf, oSi, Si, N, b0, d.B, warps);
  load_rows(base, wf, osc, err, 1, b0, d.B, warps);
  load_rows(base, wf, osc + 1, act, 1, b0, d.B, warps);
  load_rows(base, wf, osc + 2, inj, 1, b0, d.B, warps);
  __syncthreads();

  const Scratch s = trip_layout(base + warp * wf, d);
  if (b0 + warp < d.B && s.scal[1] > 0.5f)
    trip_warp<N, NNL>(s, consts_view(kc, kl, d), d, lane);
  __syncthreads();

  const int oAct = osc + 1;
  store_rows(base, wf, s0.Vm2 - base, oVm, oAct, Vm_o, HN, b0, d.B, warps);
  store_rows(base, wf, s0.Va2 - base, oVa, oAct, Va_o, HN, b0, d.B, warps);
  store_rows(base, wf, s0.f2 - base, of, oAct, f_o, d.dim, b0, d.B, warps);
  store_rows(base, wf, s0.err2 - base, osc, oAct, err_o, 1, b0, d.B, warps);
}

// launches with the most scenarios per block (8, 4, 2 or 1) whose scratch
// fits the block's shared memory
template <int N, int NNL>
int launch_trip(const float* Vm, const float* Va, const float* f,
                const float* err, const float* act, const float* Sr,
                const float* Si, const float* inj, const float* consts,
                const int* lines, float* Vm_o, float* Va_o, float* f_o,
                float* err_o, const Dims& d, cudaStream_t stream) {
  int limit = 0;
  cudaError_t e = max_dynamic_smem(fused_trip_kernel<N, NNL>, &limit);
  if (e != cudaSuccess) return (int)e;
  const long long fixed = d.nconst + 2 * d.L;
  const long long per_warp = trip_warp_floats(d.H, N, NNL, d.L, d.dim);
  int warps = kMaxWarps;
  while (warps > 1 && 4 * (fixed + warps * per_warp) > limit) warps /= 2;
  const long long smem = 4 * (fixed + warps * per_warp);
  if (smem > limit || (d.B + warps - 1) / warps > INT_MAX)
    return (int)cudaErrorInvalidValue;
  e = allow_smem(fused_trip_kernel<N, NNL>, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (d.B + warps - 1) / warps;
  fused_trip_kernel<N, NNL>
      <<<(unsigned)blocks, 32 * warps, (int)smem, stream>>>(
          Vm, Va, f, err, act, Sr, Si, inj, consts, lines, Vm_o, Va_o, f_o,
          err_o, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronize, returns cudaGetLastError()
// after the launch (0 = launched).  Every tensor is contiguous: the state
// lane-major, `consts` TripConsts.packed, `lines` the (2, L) endpoints.
int hpfx_fused_trip(const float* Vm, const float* Va, const float* f,
                    const float* err, const float* act, const float* Sr,
                    const float* Si, const float* inj, const float* consts,
                    const int* lines, float* Vm_o, float* Va_o, float* f_o,
                    float* err_o, int H, int n, int m, int c, int L,
                    int coupled, int nconst, long long B, void* stream) {
  const int nnl = n - m;
  if (H < 1 || H > kMaxH || m < 1 || nnl < 1 || c < 1 || c > m || L < 0 ||
      L > kMaxL || nconst < 0 || B < 1 || 2 * H * nnl > 32 * kCapRowsPerLane)
    return (int)cudaErrorInvalidValue;
  const Dims d{H,  n, m, c, L, coupled != 0, nnl, 2 * H * n - 1 - c,
               2 * n - 1 - c, 2 * H * nnl, nconst, B};
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 4 && nnl == 1)
    return launch_trip<4, 1>(Vm, Va, f, err, act, Sr, Si, inj, consts, lines,
                             Vm_o, Va_o, f_o, err_o, d, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
