// Batched dense solves A x = b by Gauss-Jordan elimination with virtual
// partial pivoting, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels of hpfx/ops/batched_solve.py:
//   gj_kernel          <- _gj_kernel          (dims < 64: the net2 Woodbury
//                                              capacitance solve, dim 26; the
//                                              net1 arrow blocks, dim 40 with
//                                              15 right-hand sides)
//   gj_kernel_carried  <- _gj_kernel_carried  (dims 64..192: the net2
//                                              exact-linear seed, dim 96; the
//                                              64-bus feeder's blocks, dim 128
//                                              with 15 right-hand sides; the
//                                              IEEE 33-bus feeder's, dim 130
//                                              with 65)
//   gj_kernel_unrolled <- _gj_kernel_unrolled (the same dims, chosen with
//                                              HPFX_GJ_UNROLLED=1)
// Per system they compute what the TPU kernels compute:
//   for k in 0..n-1:
//     p    = the unused row with the largest |A[r,k]| (lowest index on ties;
//            NaN ranks highest, as argmax does)
//     w[r] = A[r,k] / piv off the pivot row, 1 - 1/piv on it (piv = A[p,k],
//            1/piv taken once and multiplied, as on the TPU)
//     [A | b] -= w (outer) [A | b][p]      (eliminates column k and
//                                           normalizes the pivot row at once)
//     mark p used
// No guard on a zero pivot: inf/NaN propagates and the caller treats a
// non-finite lane as diverged.  No atomics: results are deterministic.
//
// gj_kernel and gj_kernel_carried depart from the TPU kernels in two ways,
// both of which change results only by rounding:
//   - only the live columns are updated: A's columns after k, and b.  The
//     columns up to k are eliminated already (the TPU kernel keeps updating
//     them: the pivot row's unit and an ulp of cancellation noise elsewhere),
//     and no later pivot or update reads them, so the pivots are the same
//     and the live columns take the same multiply-adds;
//   - x is gathered at the pivot rows, x[k] = b[p_k], where the TPU kernel
//     sums x[k] = sum_r A[r,k] b[r] over the converged A, a permutation up to
//     that noise (panel_gj_solve_lanes gathers x the same way).
// With `equil` set they also run the row and column max-abs equilibration
// of equilibrated_lanes (hpfx_torch/ops/batched_solve.py) around the solve,
// with the same float operations in the same order:
//   r = 1/max(|row of A|_inf, 1e-30), As = A r, c = 1/max(|column of As|_inf,
//   1e-30), As c, b r, solve, x c      (IEEE division; NaN stays NaN)
// so the caller makes no scaled copy of A and no passes over it.
//
// What bounds them on this card.  Operands are lane-major, (n, n, B) with the
// batch last, so a system's n*n entries are strided by B in device memory
// and each is read once (604 MB at n=96, B=16384: 0.18 ms at 3.35 TB/s).  The
// live-column elimination does n^2 (n/2 + R) multiply-adds per system, 0.2 ms
// at the float32 peak for that batch.  What bounds them is latency: n
// dependent steps per system, each an argmax over the rows, a barrier and a
// broadcast of the pivot row, with as many systems in flight as the
// registers that hold their rows allow.  The load is the other cost: a
// thread reads its own row, so every 4 bytes touch a 32-byte sector, and the
// neighbouring systems that share the sector run in other blocks.
//
// What the design does about it (gj_panel.cu's design for one panel, applied
// to the whole system).  A row of [A | b] lives in registers, in WP slots (a
// template constant).  The step loop runs at run time, so the slots rotate:
// at step k slot j holds column k + j, the update writes each result one slot
// down, and the working column is always slot 0; no index depends on k.  The
// live slots are those below W - k (W = n + R, or n where gj_kernel keeps b
// in shared memory), and where a thread holds whole rows the update skips
// each group of four dead slots with a branch that the whole block takes
// alike.  The pivot is a warp-wide max over order-preserving keys and a
// ballot for the lowest row; the row that wins stages its live slots as
// float4 stores in a double-buffered stage, and every row reads it as float4
// broadcasts, so a step needs one barrier.  The update
// does the group holding the next working column first and then starts the
// next step's max and ballot, whose latency the other groups' multiply-adds
// cover.  After n steps slots 0..R-1 hold the row's b, which goes to x at the
// step the row was pivot.  Where n + R exceeds gj_kernel's widest
// instantiation, its slots hold A and b lies in dynamic shared memory at an
// odd leading dimension; gj_kernel_carried always keeps b in the slots.
//   gj_kernel (n < 64): one warp per system, a lane keeping rows lane and
//     lane + 32 (ROWS = 2 for n > 32); 8 / ROWS consecutive systems a block,
//     so a block's loads use 32 or 16 bytes of each sector.  The column
//     max-abs is one warp-wide max per column; a step needs only __syncwarp,
//     and every lane takes the pivot by a shuffle while the pivot lane stages
//     its row.
//   gj_kernel_carried (64 <= n <= 192): one block per system, n padded to
//     whole warps.  Each padded row count NP has a narrow instantiation, a
//     thread a row (two at NP = 160) and n + R up to NP + 16 slots, and a
//     wide one of 192-256 slots, whose row is split over T = 4 threads (2
//     at NP = 192) so that no instantiation spills: lanes i, i + 32/T, ...
//     hold its parts of WP/T slots, and a shuffle carries the columns that
//     cross from one part to the one before.  A thread of the wide ones up
//     to NP = 160 keeps RT = 2 consecutive rows, so that each float4 read of
//     the staged pivot row feeds eight multiply-adds.  Right-hand sides past
//     the wide instantiation are split into chunks.  So wide right-hand
//     sides are updated in registers by every thread of the block: the 33-bus
//     feeder's 65 at dim 130 (195 slots) in <160, 208, 4, 2>, 320 threads
//     of 104 slots, 168 registers, one block a SM: 8.8 ms at (130, 65,
//     6656) on the H100.  Their former shared-memory form, where one
//     thread a row ran b's R multiply-adds each step while the block waited
//     at the next barrier, took 25.1 ms there (1.45% of its bound), also one
//     block a SM.  Other layouts at that shape: four threads a row of one
//     row each (640 threads) 11.6 ms, eight threads a row of four or two
//     rows each 9.1 ms (spilling) and 10.4 ms.  The step is bound
//     by latency (the barrier, the warps' argmax, the update's shared
//     loads); with a row split, the update skips no dead group (a warp
//     holds every part of its rows), so the compiler issues the groups'
//     shared loads ahead of their multiply-adds (11.4 ms with the skip).  The
//     warps' column maxima meet in shared memory.  Each warp's best row also
//     writes its key, index and 1/pivot, so after the one barrier a thread
//     finds the pivot with a few shared loads and compares.  Several systems
//     a block, loaded through a shared tile so that a warp's loads cover
//     whole sectors, was slower at every path shape: one barrier a step then
//     holds all of the block's systems, and no other block hides it.
//   gj_kernel_unrolled: gj_kernel_carried with its step loop unrolled
//     kUnrollGroup steps at a time, what the TPU kernel's trace-time unroll
//     becomes here (unrolling all n steps, NP^2 straight-line multiply-adds,
//     did not build within 600 s on the card's host).  Within a group slot j
//     holds column k0 + j throughout: step g works on slot g, the live slots
//     (the same through the group) are updated in place with static indices,
//     and the group's last step writes each result kUnrollGroup slots down.
//     The same instantiations, launch plans and equilibration as
//     gj_kernel_carried.
// The launch plan of each (instantiation, threads, systems a block, dynamic
// shared memory) is computed by the caller (launch_plan in
// hpfx_torch/ops/batched_solve.py) and checked here.
// Right-hand sides past one block's shared memory or slots (the
// panel-Schur solve's leaves carry up to ~3,150 at dim 32: 400 KB of b a
// system) are split into chunks of columns, one chunk a block along the
// grid's y (chunked_plan in the same file), each repeating the elimination
// of A for its own columns.

#include "gj_common.cuh"

namespace {

using hpfx::abs_bits;
using hpfx::inv_scale;
using hpfx::kFullMask;
using hpfx::pivot_key;
using hpfx::Strides;
using hpfx::warp_best;
using hpfx::warp_pivot;

constexpr int kMaxSystemsK1 = 8;   // gj_kernel: at most 8 systems (warps) a block

// gj_kernel_unrolled: steps unrolled a group.  Groups of 4, 8 and 16 were
// measured on the H100: the kernel's time grew with the group at dims 96
// and 128 (its code, 8 or 16 steps of unrolled updates, and at 128 its
// registers grew with it), and 4 was the fastest at every path shape
constexpr int kUnrollGroup = 4;

// a row's slots from [A | b]: slot c holds column g0 + c (g0 > 0 for the
// second half of a row split over two threads), A's columns and then b's
// (unless b lies in shared memory), zeros past them and on a row past the
// last
template <int WP, bool BSMEM>
__device__ __forceinline__ void load_row(float (&s)[WP], const float* a,
                                         const float* b, int n, int R,
                                         bool own, int g0, long long ca,
                                         long long cb) {
#pragma unroll
  for (int c = 0; c < WP; ++c) {
    const int g = g0 + c;
    float v = 0.0f;
    if (own) {
      if (g < n)
        v = a[g * ca];
      else if (!BSMEM && g < n + R)
        v = b[(g - n) * cb];
    }
    s[c] = v;
  }
}

// the largest |A| among the slots (as abs_bits), those below `na`
template <int WP>
__device__ __forceinline__ unsigned row_max_bits(const float (&s)[WP],
                                                 int na) {
  unsigned m = 0u;
#pragma unroll
  for (int c = 0; c < WP; ++c) {
    const unsigned v = abs_bits(s[c]);
    if (c < na && v > m) m = v;
  }
  return m;
}

// the slots below `nw` times the row scale r (As = A r, and b r where b is
// in the slots)
template <int WP>
__device__ __forceinline__ void scale_slots(float (&s)[WP], int nw, float r) {
#pragma unroll
  for (int c = 0; c < WP; ++c)
    if (c < nw) s[c] *= r;
}

// the live slots (those below `live`) of a row, as float4 stores
template <int WP>
__device__ __forceinline__ void stage_row(float* dst, const float (&s)[WP],
                                          int live) {
#pragma unroll
  for (int c = 0; c < WP; c += 4)
    if (c < live)
      *reinterpret_cast<float4*>(dst + c) =
          make_float4(s[c], s[c + 1], s[c + 2], s[c + 3]);
}

// one step's update of the live slots of ROWS rows against the staged pivot
// row, each result written one slot down: s[c-1] = s[c] - w prow[c], so the
// next working column lands in slot 0.  A group of four slots at or past
// `live` (the same for every row of the system) is skipped.  The groups
// C0..C1-1 only: the caller updates group 0 (the next working column) first
// and starts the next argmax before the rest
template <int ROWS, int WP, int C0, int C1>
__device__ __forceinline__ void update_rows(float (&s)[ROWS][WP],
                                            const float (&w)[ROWS],
                                            const float* prow, int live) {
  static_assert(WP % 4 == 0 && C0 % 4 == 0, "the staged row is read as float4");
  const float4* p4 = reinterpret_cast<const float4*>(prow);
#pragma unroll
  for (int c = C0; c < C1; c += 4) {
    if (c < live) {
      const float4 q = p4[c / 4];
#pragma unroll
      for (int t = 0; t < ROWS; ++t) {
        if (c > 0) s[t][c - 1] = s[t][c] - w[t] * q.x;
        s[t][c] = s[t][c + 1] - w[t] * q.y;
        s[t][c + 1] = s[t][c + 2] - w[t] * q.z;
        s[t][c + 2] = s[t][c + 3] - w[t] * q.w;
      }
    }
  }
}

// x[k, q] = b[q] of the row that was the pivot of column k, times the column
// scale c[k] when equilibrating: the slots holding columns n..n+R-1 at the
// end (global slots o..o+R-1, slot c holding g0 + c), or the row's b in
// shared memory (stored by the thread with g0 = 0)
template <int WP, bool BSMEM>
__device__ __forceinline__ void store_row(float* x, const float (&s)[WP],
                                          const float* sb, int R, int g0,
                                          int o, int k, bool equil, float cs,
                                          Strides sx, long long sys) {
  float* xk = x + sys * sx.s + k * sx.r;
  if (BSMEM) {
    if (g0 == 0)
      for (int q = 0; q < R; ++q) xk[q * sx.c] = equil ? sb[q] * cs : sb[q];
  } else {
#pragma unroll
    for (int c = 0; c < WP; ++c) {
      const int q = g0 + c - o;
      if (q >= 0 && q < R) xk[q * sx.c] = equil ? s[c] * cs : s[c];
    }
  }
}

template <int ROWS, int WP, bool BSMEM>
__global__ void __launch_bounds__(32 * kMaxSystemsK1 / ROWS)
    gj_kernel(const float* __restrict__ A, const float* __restrict__ b,
              float* __restrict__ x, int n, int R, int rc, long long B,
              int equil, Strides sa, Strides sb, Strides sx) {
  constexpr int NR = 32 * ROWS;              // the system's rows, padded
  constexpr int S = kMaxSystemsK1 / ROWS;    // systems (warps) a block
  // blockIdx.y picks this block's chunk of rc of the R right-hand sides
  // (the last may be narrower).  A column of b sees the same pivots and
  // multipliers whatever chunk it lies in (they depend on A alone), so the
  // chunks compute what one block over all R columns would
  const int q0 = (int)blockIdx.y * rc;
  b += q0 * sb.c;
  x += q0 * sx.c;
  R = min(rc, R - q0);
  __shared__ __align__(16) float stage[S][2][WP];
  __shared__ float cscale[S][NR];
  // BSMEM: each warp's b rows at an odd leading dimension, then its staged
  // pivot b, two buffers of R
  extern __shared__ float dyn[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long sys = (long long)blockIdx.x * S + warp;
  const int W = BSMEM ? n : n + R;   // the slots in use
  const int ldb = R | 1;
  float* Sb = dyn + (size_t)warp * (NR * ldb + 2 * R);
  float* pb = Sb + NR * ldb;

  float s[ROWS][WP];
  if (sys >= B) return;   // no block barrier below: a warp may leave
#pragma unroll
  for (int t = 0; t < ROWS; ++t)
    load_row<WP, BSMEM>(s[t], A + sys * sa.s + (lane + 32 * t) * sa.r,
                        b + sys * sb.s + (lane + 32 * t) * sb.r, n, R,
                        lane + 32 * t < n, 0, sa.c, sb.c);
  bool used[ROWS];
  int step[ROWS];   // the step at which the row was pivot
#pragma unroll
  for (int t = 0; t < ROWS; ++t) {
    const int r = lane + 32 * t;
    const bool own = r < n;
    if (BSMEM)
      for (int q = 0; q < R; ++q)
        Sb[r * ldb + q] = own ? b[sys * sb.s + r * sb.r + q * sb.c] : 0.0f;
    used[t] = !own;   // pad rows are never pivots
    step[t] = 0;
  }

  if (equil) {
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      const float rs = inv_scale(row_max_bits(s[t], n));
      scale_slots(s[t], W, rs);
      if (BSMEM)
        for (int q = 0; q < R; ++q) Sb[(lane + 32 * t) * ldb + q] *= rs;
    }
    // the column scales: a warp-wide max over the rows, column by column
#pragma unroll
    for (int c = 0; c < WP; ++c) {
      if (c < n) {
        unsigned m = abs_bits(s[0][c]);
#pragma unroll
        for (int t = 1; t < ROWS; ++t) {
          const unsigned v = abs_bits(s[t][c]);
          if (v > m) m = v;
        }
        const float cs = inv_scale(__reduce_max_sync(kFullMask, m));
#pragma unroll
        for (int t = 0; t < ROWS; ++t) s[t][c] *= cs;
        if (lane == (c & 31)) cscale[warp][c] = cs;
      }
    }
  }

  int live = W;   // W - k at step k
  int p = warp_pivot(s, used);   // step 0's pivot
#pragma unroll 1
  for (int k = 0; k < n; ++k, --live) {
    const int buf = k & 1;
    // every lane takes the pivot from its lane (a shuffle, beside the stage)
    const float piv = __shfl_sync(
        kFullMask, p < 32 ? s[0][0] : s[ROWS - 1][0], p & 31);
    float* prow = stage[warp][buf];
    if (lane == (p & 31)) {
      if (p < 32)
        stage_row(prow, s[0], live);
      else
        stage_row(prow, s[ROWS - 1], live);
      if (BSMEM)
        for (int q = 0; q < R; ++q) pb[buf * R + q] = Sb[p * ldb + q];
    }
    const float inv_piv = __frcp_rn(piv);   // 1/piv, rounded as 1.0f / piv
    // the stage is double-buffered: step k+2 rewrites this buffer only after
    // every lane has passed step k+1's __syncwarp, after its reads of step k
    __syncwarp();
    float w[ROWS];
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      const int r = lane + 32 * t;
      w[t] = r == p ? 1.0f - inv_piv : s[t][0] * inv_piv;
      if (r == p) step[t] = k;
      used[t] = used[t] || r == p;
    }
    // the next working column first, then the next pivot's max and ballot
    // in flight while the other groups are updated
    update_rows<ROWS, WP, 0, 4>(s, w, prow, live);
    const int p_next = warp_pivot(s, used);
    update_rows<ROWS, WP, 4, WP>(s, w, prow, live);
    if (BSMEM) {
#pragma unroll
      for (int t = 0; t < ROWS; ++t) {
        float* row = Sb + (lane + 32 * t) * ldb;
        for (int q = 0; q < R; ++q) row[q] -= w[t] * pb[buf * R + q];
      }
    }
    p = p_next;
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < ROWS; ++t) {
    const int r = lane + 32 * t;
    if (r < n)
      store_row<WP, BSMEM>(x, s[t], Sb + r * ldb, R, 0, 0, step[t], equil,
                           equil ? cscale[warp][step[t]] : 1.0f, sx, sys);
  }
}

// the largest of v over the lanes of this thread's warp that hold the same
// part of their rows (all 32 lanes when a row has one thread): a row split
// over T threads keeps its parts in lanes i, i + RW, i + 2 RW, ... (RW =
// 32 / T), so the parts hold different columns
template <int T>
__device__ __forceinline__ unsigned part_max(unsigned v) {
  if constexpr (T == 1) {
    return __reduce_max_sync(kFullMask, v);
  } else {
#pragma unroll
    for (int off = 16 / T; off > 0; off >>= 1) {
      const unsigned o = __shfl_xor_sync(kFullMask, v, off);
      if (o > v) v = o;
    }
    return v;
  }
}

// one step's in-place update of the live slots C0..C1-1 (float4 groups) of
// ROWS rows against the staged pivot row: s[c] -= w prow[c]
template <int ROWS, int WP, int C0, int C1>
__device__ __forceinline__ void update_in_place(float (&s)[ROWS][WP],
                                                const float (&w)[ROWS],
                                                const float* prow, int live) {
  const float4* p4 = reinterpret_cast<const float4*>(prow);
#pragma unroll
  for (int c = C0; c < C1; c += 4) {
    if (c < live) {
      const float4 q = p4[c / 4];
#pragma unroll
      for (int t = 0; t < ROWS; ++t) {
        s[t][c] -= w[t] * q.x;
        s[t][c + 1] -= w[t] * q.y;
        s[t][c + 2] -= w[t] * q.z;
        s[t][c + 3] -= w[t] * q.w;
      }
    }
  }
}

// the same, each result written G slots down: s[c - G] = s[c] - w prow[c]
// for the slots C0..C1-1 (C0 >= G)
template <int ROWS, int WP, int G, int C0, int C1>
__device__ __forceinline__ void update_shifted(float (&s)[ROWS][WP],
                                               const float (&w)[ROWS],
                                               const float* prow, int live) {
  static_assert(C0 >= G && G % 4 == 0, "whole float4 groups, shifted down");
  const float4* p4 = reinterpret_cast<const float4*>(prow);
#pragma unroll
  for (int c = C0; c < C1; c += 4) {
    if (c < live) {
      const float4 q = p4[c / 4];
#pragma unroll
      for (int t = 0; t < ROWS; ++t) {
        s[t][c - G] = s[t][c] - w[t] * q.x;
        s[t][c + 1 - G] = s[t][c + 1] - w[t] * q.y;
        s[t][c + 2 - G] = s[t][c + 2] - w[t] * q.z;
        s[t][c + 3 - G] = s[t][c + 3] - w[t] * q.w;
      }
    }
  }
}

// the pivot key of this thread's best row (slot C of each of its RT rows;
// the lowest row on ties), and in `t_best` which of its rows that is
template <int C, int RT, int H>
__device__ __forceinline__ unsigned rows_key(const float (&s)[RT][H],
                                             const bool (&used)[RT],
                                             int& t_best) {
  unsigned key = pivot_key(s[0][C], used[0]);
  t_best = 0;
#pragma unroll
  for (int t = 1; t < RT; ++t) {
    const unsigned kt = pivot_key(s[t][C], used[t]);
    if (kt > key) {
      key = kt;
      t_best = t;
    }
  }
  return key;
}

// the index I as a type, so that a generic lambda can take it as a constant
template <int I>
struct Step {
  static constexpr int value = I;
};

// f(Step<I>()), f(Step<I + 1>()), ... up to G - 1, while f returns true
template <int I, int G, typename F>
__device__ __forceinline__ void unroll_steps(F& f) {
  if constexpr (I < G) {
    if (f(Step<I>())) unroll_steps<I + 1, G>(f);
  }
}

// gj_kernel_carried (G = 1: the step loop at run time, the slots rotating
// one a step) and gj_kernel_unrolled (G > 1: the step loop unrolled G steps
// at a time).  In a group of G steps slot j holds column k0 + j throughout
// (k0 the group's first step): step g works on slot g and updates the live
// slots in place, with every index static, and the group's last step writes
// each result G slots down, so the next group starts at slot 0 again.  The
// live slots, those below W - k0, stay the same through a group.  A last
// group of fewer than G steps shifts nothing: b's columns then start at slot
// n mod G.  A thread keeps RT consecutive rows (RT = 1 or 2), each split
// over T threads (T = 1, 2 or 4): part j of a row holds its global slots
// j H .. j H + H - 1 (H = WP / T), and the slots that leave part j + 1 at
// the bottom enter part j at the top, by a shuffle.  One float4 read of the
// staged pivot row feeds the thread's RT rows
template <int NP, int WP, int T, int RT, int G>
__device__ __forceinline__ void carried_body(const float* __restrict__ A,
                                             const float* __restrict__ b,
                                             float* __restrict__ x, int n,
                                             int R, int rc, int equil,
                                             Strides sa, Strides sb,
                                             Strides sx) {
  constexpr int NT = NP * T / RT;   // threads
  constexpr int NW = NT / 32;       // warps
  constexpr int RW = 32 / T;        // groups of RT rows a warp
  constexpr int H = WP / T;         // slots a row a thread
  static_assert(NT % 32 == 0 && NP % (RW * RT) == 0 && WP >= NP &&
                    (T == 1 || T == 2 || T == 4) && (RT == 1 || RT == 2) &&
                    WP % (4 * T) == 0,
                "whole warps; a row's slots split into float4 groups");
  static_assert(G == 1 || (G % 4 == 0 && G <= H),
                "a group shifts whole float4 groups within a thread's slots");
  // this block's chunk of the right-hand sides, as in gj_kernel
  const int q0 = (int)blockIdx.y * rc;
  b += q0 * sb.c;
  x += q0 * sx.c;
  R = min(rc, R - q0);
  __shared__ __align__(16) float stage[2][NW][WP];   // each warp's best row
  __shared__ unsigned warp_k[2][NW];                 // its key
  __shared__ int warp_p[2][NW];                      // its index
  __shared__ float warp_i[2][NW];                    // 1 / its pivot
  __shared__ float cscale[NP];                       // the column scales
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long sys = blockIdx.x;
  const int i = lane % RW;                // the row group within the warp
  const int r0 = (warp * RW + i) * RT;    // the first row it holds (a part of)
  const int g0 = (lane / RW) * H;         // the column of its slot 0
  const int W = n + R;                    // the slots in use
  // the next part's lane (for the last part, a lane whose value is unused)
  const int below = (lane + RW) & 31;

  float s[RT][H];
  bool used[RT];   // pad rows are never pivots
  int step[RT];    // the step at which the row was pivot
#pragma unroll
  for (int t = 0; t < RT; ++t) {
    const int r = r0 + t;
    load_row<H, false>(s[t], A + sys * sa.s + r * sa.r,
                       b + sys * sb.s + r * sb.r, n, R, r < n, g0, sa.c, sb.c);
    used[t] = r >= n;
    step[t] = 0;
  }

  if (equil) {
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      unsigned m = row_max_bits(s[t], n - g0);
#pragma unroll
      for (int off = RW; off < 32; off <<= 1) {   // the row's other parts
        const unsigned o = __shfl_xor_sync(kFullMask, m, off);
        if (o > m) m = o;
      }
      scale_slots(s[t], W - g0, inv_scale(m));
    }
    // the column scales: a max over the warp's rows per column, one word
    // per warp and column (in the stage, not in use yet), then a max over
    // the warps
    unsigned* cmax = reinterpret_cast<unsigned*>(&stage[0][0][0]);
#pragma unroll
    for (int c = 0; c < H; ++c) {
      const int g = g0 + c;
      unsigned v = 0u;
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const unsigned a = abs_bits(s[t][c]);
        if (g < n && a > v) v = a;
      }
      v = part_max<T>(v);
      if (g < n && i == c % RW) cmax[warp * WP + g] = v;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < n; c += NT) {
      unsigned mc = 0u;
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const unsigned v = cmax[j * WP + c];
        if (v > mc) mc = v;
      }
      cscale[c] = inv_scale(mc);
    }
    __syncthreads();   // scales written; the words read before step 0
#pragma unroll
    for (int c = 0; c < H; ++c)
      if (g0 + c < n) {
        const float cs = cscale[g0 + c];
#pragma unroll
        for (int t = 0; t < RT; ++t) s[t][c] *= cs;
      }
  }

  int live = W;   // W - k0 at a group's first step k0
  unsigned best;
  // step 0's best row of this warp (keys from the first part of each row):
  // the lane lb, and which of its rows
  int tsel;
  unsigned key = rows_key<0>(s, used, tsel);
  int lb = warp_best(g0 == 0 ? key : 0u, best);
#pragma unroll 1
  for (int k0 = 0; k0 < n; k0 += G, live -= G) {
    // step g of the group; false past the last step (a last group of fewer
    // steps)
    auto one_step = [&](auto gi) -> bool {
      constexpr int g = decltype(gi)::value;
      const int k = k0 + g;
      if (k >= n) return false;
      const int buf = k & 1;
      const int tb = RT > 1 ? __shfl_sync(kFullMask, tsel, lb) : 0;
      if (i == lb) {
        // this warp's best row (the lowest wins a tie), every part
#pragma unroll
        for (int t = 0; t < RT; ++t)
          if (t == tb) {
            stage_row(stage[buf][warp] + g0, s[t], live - g0);
            if (g0 == 0) {
              warp_k[buf][warp] = best;
              warp_p[buf][warp] = r0 + t;
              warp_i[buf][warp] = __frcp_rn(s[t][g]);   // as 1.0f / piv
            }
          }
      }
      __syncthreads();   // warp words written; step k-1's reads of them done
      // the lowest of the warps with the largest key holds the pivot
      unsigned bk = warp_k[buf][0];
      int wb = 0;
#pragma unroll
      for (int j = 1; j < NW; ++j) {
        const unsigned kj = warp_k[buf][j];
        if (kj > bk) {
          bk = kj;
          wb = j;
        }
      }
      const int p = warp_p[buf][wb];
      const float inv_piv = warp_i[buf][wb];
      const float* prow = stage[buf][wb] + g0;   // row p, in slot order
      float w[RT];
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        // the row's working column (slot g of its first part)
        const float col =
            T > 1 ? __shfl_sync(kFullMask, s[t][g], i) : s[t][g];
        w[t] = r0 + t == p ? 1.0f - inv_piv : col * inv_piv;
        if (r0 + t == p) step[t] = k;
        used[t] = used[t] || r0 + t == p;
      }
      // the slots to update: the live ones where a warp's lanes hold the
      // same columns.  With a row split over T > 1 threads a warp holds
      // every part, and a group skipped in one part is waited for in
      // another, so every slot is updated, with no branch between the
      // groups' shared loads (the dead slots take values never read)
      const int upd = T > 1 ? H : live - g0;
      // the next working column first, then the next step's warp argmax in
      // flight while the other groups are updated
      if constexpr (G == 1) {
        // the column after this thread's last slot (the next part's slot
        // 0), before the update moves it
        float next[RT];
#pragma unroll
        for (int t = 0; t < RT; ++t)
          next[t] = T > 1 ? __shfl_sync(kFullMask, s[t][0], below) : 0.0f;
        update_rows<RT, H, 0, 4>(s, w, prow, upd);
        key = rows_key<0>(s, used, tsel);
        lb = warp_best(g0 == 0 ? key : 0u, best);
        update_rows<RT, H, 4, H>(s, w, prow, upd);
        if (T > 1 && g0 + H < WP && g0 + H < live)
#pragma unroll
          for (int t = 0; t < RT; ++t)
            s[t][H - 1] = next[t] - w[t] * prow[H];
      } else if constexpr (g < G - 1) {
        constexpr int C = (g + 1) / 4 * 4;   // the group of slot g + 1
        update_in_place<RT, H, C, C + 4>(s, w, prow, upd);
        key = rows_key<g + 1>(s, used, tsel);
        lb = warp_best(g0 == 0 ? key : 0u, best);
        update_in_place<RT, H, 0, C>(s, w, prow, upd);
        update_in_place<RT, H, C + 4, H>(s, w, prow, upd);
      } else {
        // the next part's first G slots, which move to this part's last
        float next[RT][T > 1 ? G : 1];
        if (T > 1)
#pragma unroll
          for (int t = 0; t < RT; ++t)
#pragma unroll
            for (int j = 0; j < G; ++j)
              next[t][j] = __shfl_sync(kFullMask, s[t][j], below);
        update_shifted<RT, H, G, G, G + 4>(s, w, prow, upd);
        key = rows_key<0>(s, used, tsel);
        lb = warp_best(g0 == 0 ? key : 0u, best);
        update_shifted<RT, H, G, G + 4, H>(s, w, prow, upd);
        if (T > 1 && g0 + H < WP)
#pragma unroll
          for (int j = 0; j < G; ++j)
            if (g0 + H + j < live)
#pragma unroll
              for (int t = 0; t < RT; ++t)
                s[t][H - G + j] = next[t][j] - w[t] * prow[H + j];
      }
      return true;
    };
    unroll_steps<0, G>(one_step);
  }
#pragma unroll
  for (int t = 0; t < RT; ++t)
    if (r0 + t < n)
      store_row<H, false>(x, s[t], nullptr, R, g0, n % G, step[t], equil,
                          equil ? cscale[step[t]] : 1.0f, sx, sys);
}

template <int NP, int WP, int T, int RT>
__global__ void __launch_bounds__(NP * T / RT)
    gj_kernel_carried(const float* __restrict__ A,
                      const float* __restrict__ b, float* __restrict__ x,
                      int n, int R, int rc, int equil, Strides sa,
                      Strides sb, Strides sx) {
  carried_body<NP, WP, T, RT, 1>(A, b, x, n, R, rc, equil, sa, sb, sx);
}

template <int NP, int WP, int T, int RT>
__global__ void __launch_bounds__(NP * T / RT)
    gj_kernel_unrolled(const float* __restrict__ A,
                       const float* __restrict__ b, float* __restrict__ x,
                       int n, int R, int rc, int equil, Strides sa,
                       Strides sb, Strides sx) {
  carried_body<NP, WP, T, RT, kUnrollGroup>(A, b, x, n, R, rc, equil, sa, sb,
                                            sx);
}

using K1Fn = void (*)(const float*, const float*, float*, int, int, int,
                      long long, int, Strides, Strides, Strides);
using K2Fn = void (*)(const float*, const float*, float*, int, int, int, int,
                      Strides, Strides, Strides);

// gj_kernel's instantiations: (rows a lane keeps, slots a row, b in shared
// memory); launch_plan in ops/batched_solve.py holds the same table
K1Fn k1_instance(int rows, int slots, int b_smem) {
#define HPFX_K1(RO, WP, BS) \
  if (rows == RO && slots == WP && b_smem == BS) return gj_kernel<RO, WP, (BS) != 0>;
  HPFX_K1(1, 32, 0)
  HPFX_K1(1, 96, 0)
  HPFX_K1(1, 32, 1)
  HPFX_K1(2, 40, 0)
  HPFX_K1(2, 56, 0)
  HPFX_K1(2, 64, 0)
  HPFX_K1(2, 64, 1)
#undef HPFX_K1
  return nullptr;
}

// gj_kernel_carried's and gj_kernel_unrolled's instantiations: (padded rows,
// slots a row, threads a row, rows a thread); the right-hand sides always
// lie in the slots
K2Fn k2_instance(int np, int slots, int b_smem, int threads, bool unrolled) {
  if (b_smem) return nullptr;
#define HPFX_K2(NP, WP, T, RT)                                  \
  if (np == NP && slots == WP && threads == NP * T / RT)        \
    return unrolled ? gj_kernel_unrolled<NP, WP, T, RT>         \
                    : gj_kernel_carried<NP, WP, T, RT>;
  HPFX_K2(64, 80, 1, 1)
  HPFX_K2(64, 192, 4, 2)
  HPFX_K2(96, 112, 1, 1)
  HPFX_K2(96, 224, 4, 2)
  HPFX_K2(128, 144, 1, 1)
  HPFX_K2(128, 256, 4, 2)
  HPFX_K2(160, 176, 2, 1)
  HPFX_K2(160, 208, 4, 2)
  HPFX_K2(192, 208, 2, 1)
#undef HPFX_K2
  return nullptr;
}

// let `kernel` take `smem` bytes of dynamic shared memory: with its static
// shared words they may pass the 48 KB a block gets without asking
template <typename Kernel>
cudaError_t set_dynamic_smem(Kernel kernel, int smem) {
  if (smem == 0) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// blocks along y: the chunks of rc columns that cover R (0 if rc is not a
// width from 1 to R, or the chunks pass the grid's limit)
int column_chunks(int R, int rc) {
  if (rc < 1 || rc > R) return 0;
  const int chunks = (R + rc - 1) / rc;
  return chunks <= 65535 ? chunks : 0;
}

// dynamic shared memory of one block (bytes): only where b lies there
int k1_smem(int rows, int R, int b_smem, int systems) {
  return b_smem ? systems * (32 * rows * (R | 1) + 2 * R) * (int)sizeof(float)
                : 0;
}

// gj_kernel_carried or gj_kernel_unrolled with the caller's launch plan,
// checked against the kernel's need
int launch_k2(bool unrolled, const float* A, const float* b, float* x, int n,
              int R, long long B, Strides sa, Strides sb, Strides sx,
              int rows, int slots, int b_smem, int threads, int systems,
              int equil, int smem, int rc, cudaStream_t stream) {
  const K2Fn fn = k2_instance(rows, slots, b_smem, threads, unrolled);
  const int chunks = column_chunks(R, rc);
  // no dynamic shared memory: b lies in the slots
  if (fn == nullptr || n < 1 || n > rows || chunks == 0 || B < 1 ||
      B > INT_MAX || systems != 1 || n + rc > slots || smem != 0)
    return (int)cudaErrorInvalidValue;
  fn<<<dim3((unsigned)B, (unsigned)chunks), threads, 0, stream>>>(
      A, b, x, n, R, rc, equil, sa, sb, sx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, does not synchronize, and returns
// cudaGetLastError() after the launch (0 = launched).  Each takes the
// caller's launch plan (instantiation, systems a block, dynamic shared
// memory `smem`, right-hand sides a block `rc`: the grid's y covers R in
// chunks of rc), checked against the kernel's need; `equil` != 0 runs the
// equilibration inside.

int hpfx_gj_kernel(const float* A, const float* b, float* x, int n, int R,
                   long long B, long long sa_r, long long sa_c,
                   long long sa_s, long long sb_r, long long sb_c,
                   long long sb_s, long long sx_r, long long sx_c,
                   long long sx_s, int rows, int slots, int b_smem,
                   int threads, int systems, int equil, int smem, int rc,
                   void* stream) {
  const K1Fn fn = k1_instance(rows, slots, b_smem);
  const int chunks = column_chunks(R, rc);
  if (fn == nullptr || n < 1 || n > 32 * rows || chunks == 0 || B < 1 ||
      systems != kMaxSystemsK1 / rows || threads != 32 * systems ||
      (b_smem ? n > slots : n + rc > slots) ||
      smem < k1_smem(rows, rc, b_smem, systems))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (B + systems - 1) / systems;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t e = set_dynamic_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<dim3((unsigned)blocks, (unsigned)chunks), threads, smem,
       (cudaStream_t)stream>>>(
      A, b, x, n, R, rc, B, equil, Strides{sa_r, sa_c, sa_s},
      Strides{sb_r, sb_c, sb_s}, Strides{sx_r, sx_c, sx_s});
  return (int)cudaGetLastError();
}

int hpfx_gj_kernel_carried(const float* A, const float* b, float* x, int n,
                           int R, long long B, long long sa_r,
                           long long sa_c, long long sa_s, long long sb_r,
                           long long sb_c, long long sb_s, long long sx_r,
                           long long sx_c, long long sx_s, int rows,
                           int slots, int b_smem, int threads, int systems,
                           int equil, int smem, int rc, void* stream) {
  return launch_k2(false, A, b, x, n, R, B, Strides{sa_r, sa_c, sa_s},
                   Strides{sb_r, sb_c, sb_s}, Strides{sx_r, sx_c, sx_s}, rows,
                   slots, b_smem, threads, systems, equil, smem, rc,
                   (cudaStream_t)stream);
}

int hpfx_gj_kernel_unrolled(const float* A, const float* b, float* x, int n,
                            int R, long long B, long long sa_r,
                            long long sa_c, long long sa_s, long long sb_r,
                            long long sb_c, long long sb_s, long long sx_r,
                            long long sx_c, long long sx_s, int rows,
                            int slots, int b_smem, int threads, int systems,
                            int equil, int smem, int rc, void* stream) {
  return launch_k2(true, A, b, x, n, R, B, Strides{sa_r, sa_c, sa_s},
                   Strides{sb_r, sb_c, sb_s}, Strides{sx_r, sx_c, sx_s}, rows,
                   slots, b_smem, threads, systems, equil, smem, rc,
                   (cudaStream_t)stream);
}

// Blocks of one instantiation that fit one SM at `threads` a block and
// `smem` bytes of dynamic shared memory (the occupancy calculator), into
// *blocks; `kernel` picks the table: 0 gj_kernel, 1 gj_kernel_carried,
// 2 gj_kernel_unrolled.  Returns a cudaError.
int hpfx_gj_blocks_per_sm(int kernel, int rows, int slots, int b_smem,
                          int threads, int smem, int* blocks) {
  const void* fn =
      kernel ? reinterpret_cast<const void*>(
                   k2_instance(rows, slots, b_smem, threads, kernel == 2))
             : reinterpret_cast<const void*>(k1_instance(rows, slots, b_smem));
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = set_dynamic_smem(fn, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads,
                                                      smem);
  return (int)e;
}

const char* hpfx_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
