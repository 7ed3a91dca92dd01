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
// practice: each warp runs 8 + r dependent pivot steps, so latency does,
// and how many scenarios an SM keeps in flight to hide it.
//
// What the design does about it.  One warp per scenario and up to 8
// scenarios per block.  The block copies the constants (Y, Y_N, I_N, the
// line data) into shared memory once, and moves the scenarios' state with
// neighbouring threads on neighbouring scenarios, so the lane-major loads
// and stores use whole 32-byte sectors.  The first design kept each lane's
// whole block in registers (160 registers a thread: one block of 8 warps
// per SM) and the capacitance system in shared memory, whose elimination
// took ~60% of the trip (measured with each stage compiled out).  This
// one keeps little state per lane, so that more scenarios are resident:
//   - the block solves take one lane per row: 2n = 8 lanes a block, 4 blocks
//     a pass of the warp.  A lane assembles its row of [D | f | U] straight
//     into 2n + R registers; the equilibration's column maxima and each
//     step's pivot are maxima over the block's 8 lanes (xor shuffles of
//     order-preserving keys, then a ballot for the lowest row), and the
//     pivot row reaches the other rows by shuffles.  The 8 steps are
//     unrolled (n is a template constant), so only the live columns are
//     updated, with static indices; x is read off at the pivot rows;
//   - the capacitance system takes gj_kernel's design (gj_solve.cu): each
//     lane owns one row of S in registers (two where r > 32, a template
//     constant), with C.z beside it; rotating slots keep every index static,
//     only the live columns are updated, the pivot is a warp-wide max of
//     keys plus a ballot, the pivot row is broadcast by shuffles from the
//     lane that owns it, the equilibration runs in registers, and y is
//     gathered at the pivot rows.  Nothing goes through shared memory per
//     step;
//   - the state is updated in place (an inactive scenario's stays as it was
//     loaded), dx = z - X.y is formed where the update needs it, and regions
//     whose lifetimes do not overlap share memory: 3.2 KB of scratch a
//     scenario at net2 H<=25, against 9.9 KB before;
//   - the update and the mismatch run with the lanes over (harmonic, bus)
//     and (harmonic, line) pairs; flows are summed into the buses in line
//     order, without atomics, so the results are deterministic.

#include "gj_common.cuh"

namespace {

using hpfx::abs_bits;
using hpfx::allow_smem;
using hpfx::inv_scale;
using hpfx::kFullMask;
using hpfx::max_dynamic_smem;
using hpfx::pivot_key;
using hpfx::warp_pivot;

constexpr int kMaxWarps = 8;     // scenarios per block
constexpr int kMaxCapRows = 2;   // capacitance rows a lane: dims up to 64
constexpr int kMaxH = 32;        // harmonic orders
constexpr int kMaxL = 128;       // lines: one scenario fits at kMaxH
// Blocks of 8 scenarios an SM that ptxas must leave registers for at one
// capacitance row a lane (__launch_bounds__): 3 holds it to 80 registers a
// thread; with room for 1, ptxas took 96 (2 blocks an SM, slower), and 4
// (64 registers) spilled
constexpr int kMinBlocks = 3;

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

// words of the region that holds the block solutions, then the line flows
__host__ __device__ inline int trip_sol(int H, int n, int nnl, int L) {
  const int sol = H * 2 * n * (1 + 2 * nnl);
  return sol > 4 * H * L ? sol : 4 * H * L;
}

// words of one scenario's scratch
__host__ __device__ inline int trip_warp_floats(int H, int n, int nnl, int L,
                                                int dim) {
  return 6 * H * n + dim + 2 * n + 4 + trip_sol(H, n, nnl, L) + 2 * H * nnl +
         2 * nnl * H;
}

// one scenario's scratch in shared memory
struct Scratch {
  float *Vm, *Va, *f, *Sr, *Si, *scal;  // the state, updated in place;
                                        // scal: err, act, inj
  float *cs, *sn, *vcr, *vci;  // cos, sin and V at the old state; after the
                               // update Re, Im of the new V (cs, sn) and of
                               // Y.V (vcr, vci)
  float* sol;                  // block solutions [z | X], then line flows
  float *y, *ir, *ii;          // the Woodbury correction; the injections
};

__device__ Scratch trip_layout(float* p, const Dims& d) {
  const int HN = d.H * d.n;
  Scratch s;
  float** fields[] = {&s.Vm,  &s.Va, &s.f,  &s.Sr,  &s.Si,  &s.scal, &s.cs,
                      &s.sn,  &s.vcr, &s.vci, &s.sol, &s.y, &s.ir,   &s.ii};
  const int sizes[] = {HN, HN, d.dim, d.n, d.n, 4, HN, HN, HN, HN,
                       trip_sol(d.H, d.n, d.nnl, d.L), d.r, d.nnl * d.H,
                       d.nnl * d.H};
  for (int i = 0; i < 14; ++i) {
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

// row `row` of block h, [D | f | U], into registers: block 0's rows are the
// P rows of buses 1..N-1, then the Q rows of buses c..N-1 (power rows of the
// linear buses, current rows of the nonlinear ones), identity from d0; block
// h >= 1's the real, then the imaginary current rows
template <int N, int NNL>
__device__ __forceinline__ void assemble_row(float (&out)[2 * N + 1 + 2 * NNL],
                                             const Scratch& s, const Consts& k,
                                             const Dims& d, int h, int row,
                                             float inj) {
  constexpr int K2 = 2 * N, RB = 2 * NNL, W = K2 + 1 + RB;
  const int H = d.H, m = d.m, c = d.c, d0 = d.d0, hn = h * N;
  if (h == 0 && row >= d0) {
#pragma unroll
    for (int col = 0; col < W; ++col) out[col] = col == row ? 1.f : 0.f;
    return;
  }
  int i, part;   // the row's bus, and its real (0) or imaginary (1) part
  if (h == 0) {
    part = row >= N - 1;
    i = part ? row - (N - 1) + c : row + 1;
  } else {
    part = row >= N;
    i = part ? row - N : row;
  }

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

  // entry of the row against the angle (mag 0) or magnitude (1) of bus j
  auto entry = [&](int mag, int j) -> float {
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

#pragma unroll
  for (int col = 0; col < K2; ++col) {
    if (h == 0) {   // cropped: no slack angle, no PV magnitudes
      if (col < N - 1)
        out[col] = entry(0, col + 1);
      else if (col < d0)
        out[col] = entry(1, col - (N - 1) + c);
      else
        out[col] = 0.f;
    } else {
      out[col] = col < N ? entry(0, col) : entry(1, col - N);
    }
  }
  out[K2] = h == 0 ? s.f[row] : s.f[d0 + (h - 1) * K2 + row];
#pragma unroll
  for (int q = 0; q < RB; ++q)
    out[K2 + 1 + q] = row == unit_row<N, NNL>(h, q, m, c) ? 1.f : 0.f;
}

// the largest v over the lanes of this lane's group of G (a power of two)
template <int G>
__device__ __forceinline__ unsigned group_max(unsigned v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const unsigned o = __shfl_xor_sync(kFullMask, v, off);
    if (o > v) v = o;
  }
  return v;
}

// the H block solves, one lane per row: lanes 2N g .. 2N g + 2N-1 hold block
// h0 + g of a pass.  Each block is equilibrated and eliminated as
// equilibrated_lanes(gj_solve_lanes_ref) does it; its solution [z | X] goes
// to s.sol, row k of block h holding unknown k
template <int N, int NNL>
__device__ void solve_blocks(const Scratch& s, const Consts& k, const Dims& d,
                             int lane, float inj) {
  constexpr int K2 = 2 * N, R = 1 + 2 * NNL, W = K2 + R;
  constexpr int BP = 32 / K2;   // blocks a pass
  static_assert(32 % K2 == 0 && K2 < 32, "the blocks tile the warp");
  const int li = lane % K2;           // the row this lane holds
  const int seg = lane - li;          // the block's first lane
  const unsigned own = ((1u << K2) - 1u) << seg;

  for (int h0 = 0; h0 < d.H; h0 += BP) {
    const int h = h0 + lane / K2;
    const bool on = h < d.H;   // the same for the block's lanes
    float a[W];
    if (on) {
      assemble_row<N, NNL>(a, s, k, d, h, li, inj);
    } else {   // no block: the identity keeps the arithmetic finite
#pragma unroll
      for (int col = 0; col < W; ++col) a[col] = col == li ? 1.f : 0.f;
    }

    // D_r A D_c x' = D_r b, x = D_c x'
    unsigned mr = 0u;
#pragma unroll
    for (int col = 0; col < K2; ++col) {
      const unsigned v = abs_bits(a[col]);
      if (v > mr) mr = v;
    }
    const float rs = inv_scale(mr);
#pragma unroll
    for (int col = 0; col < W; ++col) a[col] *= rs;
    float cj[K2];
#pragma unroll
    for (int col = 0; col < K2; ++col) {
      cj[col] = inv_scale(group_max<K2>(abs_bits(a[col])));
      a[col] *= cj[col];
    }

    int step = li;     // the step at which this row was pivot
    float xs = 1.f;    // that step's column scale
    bool used = false;
#pragma unroll
    for (int kk = 0; kk < K2; ++kk) {
      const unsigned key = pivot_key(a[kk], used);
      const unsigned best = group_max<K2>(key);
      const unsigned lo =
          (__ballot_sync(kFullMask, key == best) & own) >> seg;
      const int pl = __ffs(lo) - 1;   // the block's lowest row holding it
      const int src = seg + pl;
      const float inv_piv = __frcp_rn(__shfl_sync(kFullMask, a[kk], src));
      const bool me = li == pl;
      const float w = me ? 1.f - inv_piv : a[kk] * inv_piv;
      if (me) {
        step = kk;
        xs = cj[kk];
        used = true;
      }
#pragma unroll
      for (int col = kk + 1; col < W; ++col)
        a[col] -= w * __shfl_sync(kFullMask, a[col], src);
    }
    if (on) {
      float* out = s.sol + (h * K2 + step) * R;
#pragma unroll
      for (int q = 0; q < R; ++q) out[q] = a[K2 + q] * xs;
    }
  }
}

// the Woodbury correction y: lane l owns row l, and l + 32 where CR = 2, of
// [S | C.z], S = I + C.G built from the block solutions, equilibrated and
// eliminated in registers as gj_kernel does it (rotating slots: at step k
// slot j holds column k + j); y[k] is read off the row that was pivot at
// step k
template <int N, int NNL, int CR>
__device__ void woodbury(const Scratch& s, const Consts& k, const Dims& d,
                         int lane, float inj) {
  constexpr int K2 = 2 * N, RB = 2 * NNL, R = 1 + RB, WP = 32 * CR;
  static_assert(WP % RB == 0 && WP % 4 == 0, "whole column groups");
  const int H = d.H, m = d.m, c = d.c, r = d.r;
  float a[CR][WP], bb[CR];
  bool used[CR];

  // row (h, t, dd) of S: columns (p, v) = sum over s2 of
  // K(t, s2)[h, p, dd] G[p][(s2, dd), v] for p != h; K(., 0) = K_A,
  // K(., 1) = K_V, and t picks their real or imaginary part
#pragma unroll
  for (int t = 0; t < CR; ++t) {
    const int rho = lane + 32 * t;
    const bool own = rho < r;
    const int h = rho / RB, rem = rho - h * RB, tt = rem / NNL;
    const int dd = rem - tt * NNL;
    used[t] = !own;   // pad rows are never pivots
    bb[t] = 0.f;
#pragma unroll
    for (int col = 0; col < WP; ++col) a[t][col] = 0.f;
    if (!own) continue;
#pragma unroll
    for (int col = 0; col < WP; col += RB) {
      const int p = col / RB;
      if (p >= H || p == h) continue;
      const int e = (dd * H + h) * H + p, b = p * N + m + dd;
      const C2 y = {k.YNr[e], k.YNi[e]};
      const C2 t1 = cmul(y, {s.cs[b], s.sn[b]});
      const C2 t2 = cmul(y, {s.vcr[b], s.vci[b]});
      const float k0 = tt ? -t2.re * inj : t2.im * inj;
      const float k1 = tt ? -t1.im * inj : -t1.re * inj;
      const float* g0 = s.sol + (p * K2 + unit_row<N, NNL>(p, dd, m, c)) * R;
      const float* g1 =
          s.sol + (p * K2 + unit_row<N, NNL>(p, NNL + dd, m, c)) * R;
#pragma unroll
      for (int v = 0; v < RB; ++v)
        a[t][col + v] = k0 * g0[1 + v] + k1 * g1[1 + v];
      bb[t] += k0 * g0[0] + k1 * g1[0];
    }
#pragma unroll
    for (int col = 0; col < WP; ++col)
      if (col == rho) a[t][col] += 1.f;
  }

  // row then column max-abs equilibration, as equilibrated_lanes
  float ccs[CR];   // the scales of columns lane and lane + 32
#pragma unroll
  for (int t = 0; t < CR; ++t) {
    unsigned mr = 0u;
#pragma unroll
    for (int col = 0; col < WP; ++col) {
      const unsigned v = abs_bits(a[t][col]);
      if (col < r && v > mr) mr = v;
    }
    const float rs = inv_scale(mr);
#pragma unroll
    for (int col = 0; col < WP; ++col) a[t][col] *= rs;
    bb[t] *= rs;
    ccs[t] = 1.f;
  }
#pragma unroll
  for (int col = 0; col < WP; ++col) {
    if (col < r) {   // the same for every lane
      unsigned mc = abs_bits(a[0][col]);
#pragma unroll
      for (int t = 1; t < CR; ++t) {
        const unsigned v = abs_bits(a[t][col]);
        if (v > mc) mc = v;
      }
      const float cc = inv_scale(__reduce_max_sync(kFullMask, mc));
#pragma unroll
      for (int t = 0; t < CR; ++t) a[t][col] *= cc;
      if ((col & 31) == lane) ccs[col >> 5] = cc;
    }
  }

  int step[CR] = {};   // the step at which the row was pivot
  int live = r;        // r - k at step k
  int p = warp_pivot(a, used);
#pragma unroll 1
  for (int kk = 0; kk < r; ++kk, --live) {
    const int src = p & 31;
    const bool hi = p >= 32;   // the pivot row is its lane's second
    const float inv_piv =
        __frcp_rn(__shfl_sync(kFullMask, hi ? a[CR - 1][0] : a[0][0], src));
    const float pb = __shfl_sync(kFullMask, hi ? bb[CR - 1] : bb[0], src);
    float w[CR];
#pragma unroll
    for (int t = 0; t < CR; ++t) {
      const int rho = lane + 32 * t;
      w[t] = rho == p ? 1.f - inv_piv : a[t][0] * inv_piv;
      if (rho == p) {
        step[t] = kk;
        used[t] = true;
      }
      bb[t] -= w[t] * pb;
    }
    // s[j-1] = s[j] - w prow[j] over the live slots, prow[j] from the
    // pivot's lane; a group of four dead slots is skipped by every lane.
    // (Starting the next pivot's max and ballot after the first group, as
    // gj_kernel does, took 16 more registers here and gained nothing at the
    // same blocks per SM)
#pragma unroll
    for (int col = 0; col < WP; col += 4) {
      if (col < live) {
        float q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          q[j] = __shfl_sync(kFullMask,
                             hi ? a[CR - 1][col + j] : a[0][col + j], src);
#pragma unroll
        for (int t = 0; t < CR; ++t) {
          if (col > 0) a[t][col - 1] = a[t][col] - w[t] * q[0];
          a[t][col] = a[t][col + 1] - w[t] * q[1];
          a[t][col + 1] = a[t][col + 2] - w[t] * q[2];
          a[t][col + 2] = a[t][col + 3] - w[t] * q[3];
        }
      }
    }
    p = warp_pivot(a, used);
  }
  // y[k] = (C.z)' of the row that was pivot at step k, times column k's scale
#pragma unroll
  for (int t = 0; t < CR; ++t) {
    const bool own = lane + 32 * t < r;
    const int st = own ? step[t] : 0;
    float cs = __shfl_sync(kFullMask, ccs[0], st & 31);
    if (CR > 1) {
      const float c1 = __shfl_sync(kFullMask, ccs[CR - 1], st & 31);
      if (st >= 32) cs = c1;
    }
    if (own) s.y[st] = bb[t] * cs;
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
template <int N, int NNL, int CR>
__device__ void trip_warp(const Scratch& s, const Consts& k, const Dims& d,
                          int lane) {
  constexpr int K2 = 2 * N, R = 1 + 2 * NNL, RB = 2 * NNL;
  const int H = d.H, m = d.m, c = d.c, HN = H * N;
  const float inj = s.scal[2];
  const bool wood = d.coupled && d.r > 0;

  for (int e = lane; e < HN; e += 32) {
    float sv, cv;
    sincosf(s.Va[e], &sv, &cv);
    s.cs[e] = cv;
    s.sn[e] = sv;
    s.vcr[e] = s.Vm[e] * cv;
    s.vci[e] = s.Vm[e] * sv;
  }
  __syncwarp();
  solve_blocks<N, NNL>(s, k, d, lane, inj);
  __syncwarp();
  if (wood) woodbury<N, NNL, CR>(s, k, d, lane, inj);
  __syncwarp();

  // the update, with dx = z - X.y at the rows it takes (block 0 holds no
  // slack angle and no PV magnitudes); V at the new state goes to (cs, sn)
  auto dx = [&](int h, int row) -> float {
    const float* e = s.sol + (h * K2 + row) * R;
    float acc = e[0];
    if (wood)
      for (int v = 0; v < RB; ++v) acc -= e[1 + v] * s.y[h * RB + v];
    return acc;
  };
  for (int e = lane; e < HN; e += 32) {
    const int h = e / N, i = e - h * N;
    float va = s.Va[e], vm = s.Vm[e];
    if (h == 0) {
      if (i >= 1) va -= dx(0, i - 1);
      if (i >= c) vm -= dx(0, (N - 1) + (i - c));
    } else {
      va -= dx(h, i);
      vm -= dx(h, N + i);
    }
    s.Va[e] = va;
    s.Vm[e] = vm;
    float sv, cv;
    sincosf(va, &sv, &cv);
    s.cs[e] = vm * cv;
    s.sn[e] = vm * sv;
  }
  __syncwarp();   // the block solutions read: the flows take their words
  const float *v2r = s.cs, *v2i = s.sn;
  float *yvr = s.vcr, *yvi = s.vci;

  // Y.V at the new state
  if (d.L) {
    float* fl = s.sol;   // per (h, l): from-end flow, to-end flow
    for (int e = lane; e < H * d.L; e += 32) {
      const int h = e / d.L, l = e - h * d.L;
      const int fb = h * N + k.lf[l], tb = h * N + k.lt[l];
      const float a_ff = k.lp[l], inv_tau = k.lp[d.L + l];
      const float shift = k.lp[2 * d.L + l];
      const C2 ys = {k.Ysr[e], k.Ysi[e]};
      const C2 ff = cmul(ys, polar_diff(s.Vm[fb] * a_ff, s.Va[fb],
                                        s.Vm[tb] * inv_tau,
                                        s.Va[tb] + shift));
      const C2 ft = cmul(ys, polar_diff(s.Vm[tb], s.Va[tb],
                                        s.Vm[fb] * inv_tau,
                                        s.Va[fb] - shift));
      fl[4 * e] = ff.re;
      fl[4 * e + 1] = ff.im;
      fl[4 * e + 2] = ft.re;
      fl[4 * e + 3] = ft.im;
    }
    __syncwarp();
    for (int e = lane; e < HN; e += 32) {
      const int h = e / N, i = e - h * N;
      C2 acc = cmul({k.dr[e], k.di[e]}, {v2r[e], v2i[e]});
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
      yvr[e] = acc.re;
      yvi[e] = acc.im;
    }
  } else {
    for (int e = lane; e < HN; e += 32) {
      const int h = e / N;
      C2 acc = {0.f, 0.f};
      for (int j = 0; j < N; ++j) {
        const C2 t = cmul({k.Yr[e * N + j], k.Yi[e * N + j]},
                          {v2r[h * N + j], v2i[h * N + j]});
        acc.re += t.re;
        acc.im += t.im;
      }
      yvr[e] = acc.re;
      yvi[e] = acc.im;
    }
  }
  // scaled Norton injections (I_N - Y_N V) s, (n_nl, H)
  for (int e = lane; e < NNL * H; e += 32) {
    const int dd = e / H, h = e - dd * H;
    C2 acc = {0.f, 0.f};
    if (d.coupled) {
      for (int p = 0; p < H; ++p) {
        const int y = e * H + p, b = p * N + m + dd;
        const C2 t = cmul({k.YNr[y], k.YNi[y]}, {v2r[b], v2i[b]});
        acc.re += t.re;
        acc.im += t.im;
      }
    } else {
      const int b = h * N + m + dd;
      acc = cmul({k.YNr[e], k.YNi[e]}, {v2r[b], v2i[b]});
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
        const float vr = v2r[i], vi = v2i[i];
        const float yr = yvr[i], yi = yvi[i];
        val = imag ? s.Si[i] + (vi * yr - vr * yi)
                   : s.Sr[i] + (vr * yr + vi * yi);
      } else {
        const int e = (i - m) * H;
        val = imag ? yvi[i] + s.ii[e] : yvr[i] + s.ir[e];
      }
    } else {
      const int q = (g - d.d0) % K2, h = 1 + (g - d.d0) / K2;
      const bool imag = q >= N;
      const int i = imag ? q - N : q, e = h * N + i;
      val = imag ? yvi[e] : yvr[e];
      if (i >= m) val += imag ? s.ii[(i - m) * H + h] : s.ir[(i - m) * H + h];
    }
    s.f[g] = val;
    mx = nanmax(mx, fabsf(val));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = nanmax(mx, __shfl_xor_sync(kFullMask, mx, off));
  if (lane == 0) s.scal[0] = mx;
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

// the scenarios' rows back: new where act = 1, as loaded where act = 0
__device__ void store_rows(const float* base, int wf, int off, float* g,
                           int E, long long b0, long long B, int warps) {
  for (int t = threadIdx.x; t < E * warps; t += blockDim.x) {
    const int e = t / warps, w = t - e * warps;
    if (b0 + w < B) g[(long long)e * B + b0 + w] = base[w * wf + off + e];
  }
}

template <int N, int NNL, int CR>
__global__ void __launch_bounds__(32 * kMaxWarps, CR == 1 ? kMinBlocks : 1)
    fused_trip_kernel(
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
    trip_warp<N, NNL, CR>(s, consts_view(kc, kl, d), d, lane);
  __syncthreads();

  store_rows(base, wf, oVm, Vm_o, HN, b0, d.B, warps);
  store_rows(base, wf, oVa, Va_o, HN, b0, d.B, warps);
  store_rows(base, wf, of, f_o, d.dim, b0, d.B, warps);
  store_rows(base, wf, osc, err_o, 1, b0, d.B, warps);
}

// the instantiation for the capacitance rows a lane owns
template <int N, int NNL>
auto trip_kernel(const Dims& d) {
  return d.r <= 32 ? fused_trip_kernel<N, NNL, 1>
                   : fused_trip_kernel<N, NNL, kMaxCapRows>;
}

// the most scenarios per block (8, 4, 2 or 1) whose scratch fits the block's
// shared memory, and that shared memory (bytes)
template <typename Kernel>
cudaError_t trip_launch_shape(Kernel kernel, const Dims& d, int* warps,
                              int* smem) {
  int limit = 0;
  const cudaError_t e = max_dynamic_smem(kernel, &limit);
  if (e != cudaSuccess) return e;
  const long long fixed = d.nconst + 2 * d.L;
  const long long per_warp = trip_warp_floats(d.H, d.n, d.nnl, d.L, d.dim);
  int w = kMaxWarps;
  while (w > 1 && 4 * (fixed + w * per_warp) > limit) w /= 2;
  const long long bytes = 4 * (fixed + w * per_warp);
  if (bytes > limit || (d.B + w - 1) / w > INT_MAX)
    return cudaErrorInvalidValue;
  *warps = w;
  *smem = (int)bytes;
  return cudaSuccess;
}

template <int N, int NNL>
int launch_trip(const float* Vm, const float* Va, const float* f,
                const float* err, const float* act, const float* Sr,
                const float* Si, const float* inj, const float* consts,
                const int* lines, float* Vm_o, float* Va_o, float* f_o,
                float* err_o, const Dims& d, cudaStream_t stream) {
  const auto kernel = trip_kernel<N, NNL>(d);
  int warps = 0, smem = 0;
  cudaError_t e = trip_launch_shape(kernel, d, &warps, &smem);
  if (e == cudaSuccess) e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (d.B + warps - 1) / warps;
  kernel<<<(unsigned)blocks, 32 * warps, smem, stream>>>(
      Vm, Va, f, err, act, Sr, Si, inj, consts, lines, Vm_o, Va_o, f_o, err_o,
      d);
  return (int)cudaGetLastError();
}

// the problem's dimensions, or false where the kernel takes no such problem
bool trip_dims(int H, int n, int m, int c, int L, int coupled, int nconst,
               long long B, Dims* d) {
  const int nnl = n - m;
  if (H < 1 || H > kMaxH || m < 1 || nnl < 1 || c < 1 || c > m || L < 0 ||
      L > kMaxL || nconst < 0 || B < 1 || 2 * H * nnl > 32 * kMaxCapRows ||
      n != 4 || nnl != 1)
    return false;
  *d = Dims{H,  n, m, c, L, coupled != 0, nnl, 2 * H * n - 1 - c,
            2 * n - 1 - c, 2 * H * nnl, nconst, B};
  return true;
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
  Dims d;
  if (!trip_dims(H, n, m, c, L, coupled, nconst, B, &d))
    return (int)cudaErrorInvalidValue;
  return launch_trip<4, 1>(Vm, Va, f, err, act, Sr, Si, inj, consts, lines,
                           Vm_o, Va_o, f_o, err_o, d, (cudaStream_t)stream);
}

// The launch of a trip of this problem: scenarios (warps) a block, dynamic
// shared memory a block (bytes) and the blocks that fit one SM (the CUDA
// occupancy calculator), into *warps, *smem, *blocks.  Returns a cudaError.
int hpfx_fused_trip_occupancy(int H, int n, int m, int c, int L, int coupled,
                              int nconst, int* warps, int* smem,
                              int* blocks) {
  Dims d;
  if (!trip_dims(H, n, m, c, L, coupled, nconst, 1, &d))
    return (int)cudaErrorInvalidValue;
  const auto kernel = trip_kernel<4, 1>(d);
  cudaError_t e = trip_launch_shape(kernel, d, warps, smem);
  if (e == cudaSuccess) e = allow_smem(kernel, *smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                      32 * *warps, *smem);
  return (int)e;
}

}  // extern "C"
