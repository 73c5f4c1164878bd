// Per-time-step Kalman maps of the auxiliary-Kalman MH step. They replace
// the Pallas kernels of aux_ssm_tpu/ops/pallas/kalman_fused.py:
//
//   elements_kernel      <- fused_make_elements    (_elements_kernel)
//   ell_kernel           <- fused_ell              (_ell_kernel)
//   backward_maps_kernel <- fused_backward_maps    (_backward_maps_kernel)
//   logdensity_kernel    <- fused_logdensity_steps (_logdensity_kernel)
//
// Each step reads a few (d, d) matrices and does O(d^3) flops on them: at the
// main path's T = 1024, d = 16 that is ~1 MB of input and ~60 MFLOP per
// launch, far below what the card moves or computes in a millisecond. What
// bounds a step is the latency of its dependent chain of small products.
//
// All four: one block (a team of NT threads) a step, at a compile-time D
// (tile.cuh), in three instances chosen by max(dx, dy): D = kElemD = 16 on
// kElemTeam = 32 threads; D = kWideD = 32 (the SV model's d = 30) on 128
// threads for make_elements and backward_maps, 64 for ell and logdensity
// (kWide*Team); and, in float32 only, D = kWide48D = 48 (SV at d = 33-48,
// where JAX's Pallas kernels run up to d = 43) on 128 threads for
// make_elements and backward_maps, 96 for ell and logdensity (kWide48*Team:
// a density half needs D lanes, 48). dx, dy <= D are padded exactly (F, Q, P, H,
// R, b, m, c, y, x zero outside d, the padded observation rows treated as
// missing, so He's rows are zero there and Re's diagonal one, S = diag(S, I),
// the Q of a transition density and of backward_maps diag(Q, I), and every
// product keeps the padding: each result equals the unpadded one in exact
// arithmetic). The step's inputs are staged into shared memory by cp.async
// before the chain, so no global load sits on it; each thread computes its
// tile of each D x D product in registers from padded rows read by vector
// loads; each output goes to global memory once, after the last barrier.
// With ~8 steps an SM (1023 steps, one wave), the SM's shared-memory reads
// set the pace: a product reads D (RPT + CPT) values a thread, so the
// tiles are as square as the team allows.
//
// make_elements and ell share their prefix (innovation_cov: the masked model,
// P_pred and S' = He P_pred He^T + Re, 4 tile products and 5 barriers).
// make_elements then solves S X = He by Gauss-Jordan by 2 x 2 pivot blocks (S
// is SPD: no exchanges), one barrier a pair; the symmetric S, C and J are each
// computed once and symmetrised through shared memory (a barrier each) rather
// than computed in both orders: 10 tile products and 16 barriers a step. C is
// P_pred - (P_pred He^T) K^T, which equals the plain version's P_pred - K S
// K^T (K S = P_pred He^T). The team is a warp: in the MH step on an H100, 32
// threads a step took 0.0269 ms for the step's two launches, 64 took 0.0284
// and 128 took 0.0366 (PERF.md).
//
// ell and logdensity end in Gaussian log densities log N(v; 0, M), each on
// half of the team through the LDL^T factor of M bordered by v (gauss_half:
// D column steps, one barrier each, no triangular solve): ell's of S and
// the innovation of m_pred (the upper half repeats it); logdensity's two at
// once, the transition's (Q, x_t - F x_{t-1} - b) on lanes 0-15 and the
// observation's (Re, the masked innovation of x_t) on lanes 16-31 (at D = 32
// on threads 0-31 and 32-63 of the 64, at D = 48 on threads 0-47 and 48-95
// of the 96), the same code on other operands.
//
// backward_maps: S = sym(F P F^T + Q) and the right-hand side F P, S X = F P
// by make_elements' Gauss-Jordan, S G^T = S X and cov = sym(P - G S G^T),
// then the Cholesky factor L of cov (jittered) on D of the team's threads
// (chol_cols: lane c owns column c, one barrier, one square root and one
// reciprocal a column; the other threads repeat it), and the three mat-vecs
// of inc on the threads of the first column: 5 tile products and 30
// barriers a step at D = 16.
//
// Chain axis: C independent chains' steps in one launch, a block a (step,
// chain) pair. Block g of n C takes step g / C of chain g % C; an operand laid
// out (n, C, ...) is read at g, one that every chain shares (laid out (n,
// ...), its bit set in `shared`: SV's and the flagship's F, Q and b) at g / C,
// so nothing shared is copied C times; the outputs are (n, C, ...). A block's
// arithmetic does not depend on g, so chain c of a C-chain launch is bit-equal
// to a one-chain launch on its inputs, and C = 1 is the one-chain launch.
//
// Missing observations follow ops/lgssm.mask_observation exactly: every
// masked quantity is selected with `isfinite(y)`, never multiplied by a 0/1
// mask, because the model's H, R, c may be NaN where y is missing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, no --use_fast_math
// (the masking needs isfinite/NaN semantics, the densities IEEE log).
#include "tile.cuh"

namespace {

using tiles::finite_or_zero;
using tiles::nan_to_num;

constexpr double kLog2Pi = 1.8378770664093453;

// ---------------------------------------------------------------------------
// The padded steps
// ---------------------------------------------------------------------------

constexpr int kElemD = 16;    // the compile-time dimension of the narrow instance (dx, dy <= 16),
constexpr int kWideD = 32;    // of the wide one (16 < max(dx, dy) <= 32)
constexpr int kWide48D = 48;  // and of the widest, float32 only (32 < max(dx, dy) <= 48)
constexpr int kElemStamps = 6;  // clock64 readings of an elements step (diagnostics)
constexpr int kMapStamps = 7;   // clock64 readings of a backward_maps step (diagnostics)

// A block's (step, chain) pair: g = step C + chain. Input `op` (its place in
// the kernel's inputs struct) is read at element at(op): g, or g / C where bit
// op of `shared` says every chain shares it.
struct StepAt {
  long g;
  int chains;
  unsigned shared;
  AUX_HD long at(int op) const { return (shared >> op & 1u) ? g / chains : g; }
};

// A step's inputs and the elements' outputs in global memory (element e at e
// dx^2, e dy dx, e dy^2, e dx, e dy: e = StepAt::at of the operand for the
// inputs, g for the outputs). ell takes the same inputs.
template <typename S>
struct ElementsIn {
  const S *F, *Q, *b, *H, *R, *c, *y, *m, *P;
};

template <typename S>
struct ElementsOut {
  S *A, *b, *C, *eta, *J;
};

// A step's working set in shared memory: D x D arrays at row stride kLd<D>
// (He and Re are H and R masked in place; T is P F^T, then P_pred He^T),
// vectors of D, and the Gauss-Jordan pivots' columns and rows (4 D each).
template <int D>
struct ElementsLay {
  static constexpr int mat = D * tiles::kLd<D>;
  static constexpr int F = 0, Q = mat, H = 2 * mat, R = 3 * mat, P = 4 * mat, T = 5 * mat,
                       Pp = 6 * mat, HF = 7 * mat, X = 8 * mat, K = 9 * mat, Tm = 10 * mat;
  static constexpr int b = 11 * mat, c = b + D, y = c + D, m = y + D, ye = m + D, ce = ye + D,
                       mp = ce + D, ydb = mp + D, ydm = ydb + D;
  static constexpr int col = ydm + D, rowm = col + 4 * D, rowz = rowm + 4 * D;
  static constexpr int size = rowz + 4 * D;
};

// A rows x cols matrix (row-major at src) for the padded D x D array at dst,
// zeros outside but `pad` on the padded diagonal; n values at src for the
// D-vector at dst, zeros past n.
template <typename S>
struct MatIn {
  S* dst;
  const S* src;
  int rows, cols;
  S pad;
};

template <typename S>
struct VecIn {
  S* dst;
  const S* src;
  int n;
};

// A step's matrices and vectors into shared memory by cp.async, on thread t
// of NT, each entry's position computed once for all of them (the caller
// waits).
template <typename S, int D, int NT, int NM, int NV>
AUX_HD void stage(int t, const MatIn<S> (&mats)[NM], const VecIn<S> (&vecs)[NV]) {
  for (int q = t; q < D * D; q += NT) {
    const int i = q / D, j = q % D, at = i * tiles::kLd<D> + j;
#pragma unroll
    for (int r = 0; r < NM; ++r) {
      const MatIn<S>& m = mats[r];
      if (i < m.rows && j < m.cols)
        tiles::copy_one(m.dst + at, m.src + i * m.cols + j);
      else
        m.dst[at] = i == j ? m.pad : (S)0;
    }
  }
  for (int i = t; i < D; i += NT)
#pragma unroll
    for (int r = 0; r < NV; ++r) {
      if (i < vecs[r].n)
        tiles::copy_one(vecs[r].dst + i, vecs[r].src + i);
      else
        vecs[r].dst[i] = (S)0;
    }
}

// Block s's inputs into the padded arrays of ElementsLay<D> (the caller waits).
template <typename S, int D, int NT>
AUX_HD void stage_step(int t, StepAt s, int dx, int dy, ElementsIn<S> in, S* sh) {
  using L = ElementsLay<D>;
  const long xx = (long)dx * dx;
  const MatIn<S> mats[] = {{sh + L::F, in.F + s.at(0) * xx, dx, dx, (S)0},
                           {sh + L::Q, in.Q + s.at(1) * xx, dx, dx, (S)0},
                           {sh + L::P, in.P + s.at(8) * xx, dx, dx, (S)0},
                           {sh + L::H, in.H + s.at(3) * dy * dx, dy, dx, (S)0},
                           {sh + L::R, in.R + s.at(4) * dy * dy, dy, dy, (S)0}};
  const VecIn<S> vecs[] = {{sh + L::b, in.b + s.at(2) * dx, dx},
                           {sh + L::m, in.m + s.at(7) * dx, dx},
                           {sh + L::c, in.c + s.at(5) * dy, dy},
                           {sh + L::y, in.y + s.at(6) * dy, dy}};
  stage<S, D, NT>(t, mats, vecs);
}

// The masked observation model (ops/lgssm.mask_observation) in place over the
// thread's tile: He's rows, and Re's rows and columns, zero where y is
// missing (padded rows count as missing), Re's diagonal one there; ye and ce,
// y and c masked, on the threads of the first column. The tile is loaded
// whole before it is masked: a load after a store to the same array would
// wait for it.
template <typename S, int D, int NT>
AUX_HD void mask_obs(const tiles::Tile<D, NT>& tl, int dy, S* He, S* Re, const S* y, const S* c,
                     S* ye, S* ce) {
  using T = tiles::Tile<D, NT>;
  auto obs = [&](int i) { return i < dy && isfinite(y[i]); };
  tiles::Regs<S, D, NT> h, r;
  tiles::tile_load<S, D, NT>(tl, He, h);
  tiles::tile_load<S, D, NT>(tl, Re, r);
  bool oj[T::CPT];
#pragma unroll
  for (int cc = 0; cc < T::CPT; ++cc) oj[cc] = obs(tl.c0 + cc);
#pragma unroll
  for (int rr = 0; rr < T::RPT; ++rr) {
    const int i = tl.r0 + rr;
    const bool oi = obs(i);
#pragma unroll
    for (int cc = 0; cc < T::CPT; ++cc) {
      h[rr][cc] = oi ? nan_to_num(h[rr][cc]) : (S)0;
      S e = (oi && oj[cc]) ? nan_to_num(r[rr][cc]) : (S)0;
      if (i == tl.c0 + cc) e += (S)1 - (oi ? (S)1 : (S)0);
      r[rr][cc] = e;
    }
    if (tl.first()) {
      ye[i] = oi ? nan_to_num(y[i]) : (S)0;
      ce[i] = oi ? nan_to_num(c[i]) : (S)0;
    }
  }
  tiles::tile_store<S, D, NT>(tl, h, He);
  tiles::tile_store<S, D, NT>(tl, r, Re);
}

// The part of a step that elements_step and ell_step share, on a team of NT
// threads (thread t; barrier 0 of the team; one thread in the host build),
// with `sh` the step's ElementsLay<D> in shared memory: stage block s's inputs,
// mask the observation model (He, Re, ye, ce), m_pred = F m + b, P_pred = F
// (P F^T) + Q, ydm = ye - He m_pred - ce (0 where y is missing), T = P_pred
// He^T, and S' = He T + Re into X, where S = sym(S'). Each entry is summed
// over k ascending, so the result does not depend on NT. Ends with a
// barrier. `st`, if not null, takes thread 0's clock64 at the start and
// after the staging (diagnostics).
template <typename S, int D, int NT>
AUX_HD void innovation_cov(int t, StepAt s, int dx, int dy, ElementsIn<S> in, S* sh,
                           long long* st) {
  using namespace tiles;
  using L = ElementsLay<D>;
  using T = Tile<D, NT>;
  constexpr int R = T::RPT, Cn = T::CPT, ld = kLd<D>;
  const T tl(t);
  S *F = sh + L::F, *Q = sh + L::Q, *He = sh + L::H, *Re = sh + L::R, *P = sh + L::P;
  S *Tp = sh + L::T, *Pp = sh + L::Pp, *X = sh + L::X, *b = sh + L::b, *m = sh + L::m;
  S *ye = sh + L::ye, *ce = sh + L::ce, *mp = sh + L::mp, *ydm = sh + L::ydm;

  stamp(st, t, 0);
  stage_step<S, D, NT>(t, s, dx, dy, in, sh);
  cp_async_wait_all();
  team_sync<NT>(0);
  stamp(st, t, 1);

  // Stage 1: the masked model (in place: each entry is its owner's), m_pred,
  // T = P F^T.
  mask_obs<S, D, NT>(tl, dy, He, Re, sh + L::y, sh + L::c, ye, ce);
  if (tl.first())
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int i = tl.r0 + rr;
      mp[i] = row_dot<S, D, false>(F, m, i) + b[i];
    }
  Regs<S, D, NT> acc;
  tile_mm<S, D, NT, false, true>(tl, P, F, acc);
  tile_store<S, D, NT>(tl, acc, Tp);
  team_sync<NT>(0);

  // Stage 2: P_pred = F T + Q, the masked innovation of m_pred.
  tile_mm<S, D, NT, false, false>(tl, F, Tp, acc);
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int cc = 0; cc < Cn; ++cc) acc[rr][cc] += Q[(tl.r0 + rr) * ld + tl.c0 + cc];
  tile_store<S, D, NT>(tl, acc, Pp);
  if (tl.first())
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int i = tl.r0 + rr;
      ydm[i] = i < dy && isfinite(sh[L::y + i]) ? ye[i] - row_dot<S, D, false>(He, mp, i) - ce[i]
                                                : (S)0;
    }
  team_sync<NT>(0);

  // Stage 3: T = P_pred He^T (T's old value is read no more).
  tile_mm<S, D, NT, false, true>(tl, Pp, He, acc);
  tile_store<S, D, NT>(tl, acc, Tp);
  team_sync<NT>(0);

  // Stage 4: S' = He T + Re into X.
  tile_mm<S, D, NT, false, false>(tl, He, Tp, acc);
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int cc = 0; cc < Cn; ++cc) acc[rr][cc] += Re[(tl.r0 + rr) * ld + tl.c0 + cc];
  tile_store<S, D, NT>(tl, acc, X);
  team_sync<NT>(0);
}

// SGF-2021 filtering element (A, b, C, eta, J) of block s on a team of NT
// threads, after innovation_cov:
//   X = S^{-1} He, K = P_pred X^T, A = F - K (He F), b = m_pred + K ydm,
//   C = sym(P_pred - (P_pred He^T) K^T), eta = (F^T X^T) ydb,
//   J = sym((F^T X^T) (He F)),
// ydb the masked innovation of b. `st`, if not null, takes thread 0's
// clock64 at the start, after the staging, after S, after the solve, after
// K and at the end (diagnostics, kernel_times.py).
template <typename S, int D, int NT>
AUX_HD void elements_step(int t, StepAt s, int dx, int dy, ElementsIn<S> in, ElementsOut<S> out,
                          S* sh, long long* st) {
  using namespace tiles;
  using L = ElementsLay<D>;
  using T = Tile<D, NT>;
  constexpr int R = T::RPT, Cn = T::CPT, ld = kLd<D>;
  const T tl(t);
  S *F = sh + L::F, *Q = sh + L::Q, *He = sh + L::H, *P = sh + L::P;
  S *Tp = sh + L::T, *Pp = sh + L::Pp, *HF = sh + L::HF, *X = sh + L::X, *K = sh + L::K;
  S *Tm = sh + L::Tm, *b = sh + L::b, *y = sh + L::y;
  S *ye = sh + L::ye, *ce = sh + L::ce, *mp = sh + L::mp, *ydb = sh + L::ydb, *ydm = sh + L::ydm;

  innovation_cov<S, D, NT>(t, s, dx, dy, in, sh, st);

  // The thread's tile of S = sym(S') in registers, the right-hand side He,
  // and the first pivot pair published.
  Regs<S, D, NT> acc, ms, z;
  sym_tile<S, D, NT>(tl, X, ms);
  tile_load<S, D, NT>(tl, He, z);
  gj_publish_first<S, D, NT>(tl, ms, z, sh + L::col, sh + L::rowm, sh + L::rowz);
  team_sync<NT>(0);
  stamp(st, t, 2);

  // Stage 5: X = S^{-1} He, into shared memory.
  gj_solve<S, D, NT>(tl, 0, ms, z, sh + L::col, sh + L::rowm, sh + L::rowz, X);
  stamp(st, t, 3);

  // Stage 6: K = P_pred X^T, Tm = F^T X^T, HF = He F, the masked innovation
  // of b.
  tile_mm<S, D, NT, false, true>(tl, Pp, X, acc);
  tile_store<S, D, NT>(tl, acc, K);
  tile_mm<S, D, NT, true, true>(tl, F, X, acc);
  tile_store<S, D, NT>(tl, acc, Tm);
  tile_mm<S, D, NT, false, false>(tl, He, F, acc);
  tile_store<S, D, NT>(tl, acc, HF);
  if (tl.first())
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int i = tl.r0 + rr;
      ydb[i] = i < dy && isfinite(y[i]) ? ye[i] - row_dot<S, D, false>(He, b, i) - ce[i] : (S)0;
    }
  team_sync<NT>(0);
  stamp(st, t, 4);

  // Stage 7: the outputs, from registers.
  const long xx = s.g * dx * dx, vx = s.g * dx;
  auto put = [&](S* o, const Regs<S, D, NT>& v) {
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int i = tl.r0 + rr;
#pragma unroll
      for (int cc = 0; cc < Cn; ++cc) {
        const int j = tl.c0 + cc;
        if (i < dx && j < dx) o[xx + i * dx + j] = v[rr][cc];
      }
    }
  };
  // C' = P_pred - T K^T into Q's array and J' = Tm HF into P's (both read
  // no more); after the barrier A, and the symmetric parts of C' and J'. No
  // global store precedes a barrier (a barrier waits for them).
  tile_mm<S, D, NT, false, true>(tl, Tp, K, acc);
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int cc = 0; cc < Cn; ++cc)
      acc[rr][cc] = Pp[(tl.r0 + rr) * ld + tl.c0 + cc] - acc[rr][cc];
  tile_store<S, D, NT>(tl, acc, Q);
  tile_mm<S, D, NT, false, false>(tl, Tm, HF, acc);
  tile_store<S, D, NT>(tl, acc, P);
  team_sync<NT>(0);
  tile_mm<S, D, NT, false, false>(tl, K, HF, acc);
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int cc = 0; cc < Cn; ++cc) acc[rr][cc] = F[(tl.r0 + rr) * ld + tl.c0 + cc] - acc[rr][cc];
  put(out.A, acc);
  sym_tile<S, D, NT>(tl, Q, acc);
  put(out.C, acc);
  sym_tile<S, D, NT>(tl, P, acc);
  put(out.J, acc);
  if (tl.first())
    for (int rr = 0; rr < R; ++rr) {
      const int i = tl.r0 + rr;
      if (i >= dx) continue;
      out.b[vx + i] = mp[i] + row_dot<S, D, false>(K, ydm, i);
      out.eta[vx + i] = row_dot<S, D, false>(Tm, ydb, i);
    }
  stamp(st, t, 5);
}

// ---------------------------------------------------------------------------
// Gaussian log densities by bordered LDL^T factors (ell, logdensity)
// ---------------------------------------------------------------------------

// log N(v; 0, M) for an SPD D x D M and a D-vector v, through the LDL^T
// factor of M bordered by v,
//   [M   v]   [L   0] [Dg 0] [L^T  u]
//   [v^T .] = [u^T 1] [0  .] [0    1],    Dg = diag(d_0, ..., d_{D-1}),
// with L unit lower triangular and u = (L Dg)^{-1} v, so that
// v^T M^{-1} v = sum_c u_c^2 d_c and log det M = sum_c log d_c, with no
// triangular solve and no square root (the Cholesky factor is L Dg^{1/2}).
// A team of NT threads takes two such densities: half h = (t / NL) % 2 of
// the team (NL = min(NT / 2, D) lanes) takes density h, its lane l = t % NL
// the columns c = l, l + NL, ... of the bordered lower triangle in
// registers (threads past 2 NL repeat the halves' work, so that every thread
// meets the barriers); a team of one thread (the host build) takes both in
// turn. The factor is
// right-looking, one column step and one barrier a column: the owner of
// column j publishes its entries and the reciprocal of its pivot d_j; every
// lane then subtracts from each of its columns c > j column j times
// (entry c of column j) / d_j. On the chain of a step sit one reciprocal (the
// SFU's and a Newton step in float), a barrier and a few dependent FMAs.
// Each entry's updates come in column order (k ascending, as a left-looking
// Cholesky sums them), and the pivots' logs are taken after the last column, one a lane, in
// parallel. A non-SPD M gives a pivot d_c <= 0 and a NaN log, as the plain
// version's Cholesky gives NaN (no jitter).
template <int NT, int D>
struct Halves {
  static constexpr int NL = NT == 1 ? 1 : NT / 2 < D ? NT / 2 : D;  // lanes a density
  static constexpr int step = NT == 1 ? 1 : 2;  // densities apart a thread's turns
  static AUX_HD int first(int t) { return t / NL % 2; }  // a thread's first density
};

// A half's scratch in shared memory: the published columns (column j in
// buffer j % 2, so that one barrier a column suffices; entry D + 1 holds
// 1 / d_j) at row stride kLd<D>, then D log d_c / 2, D u_c^2 d_c and D counts
// (1 where entry c of v counts in the density's dimension).
template <int D>
struct HalfLay {
  static_assert(tiles::kLd<D> >= D + 2, "a published column holds its pivot's reciprocal");
  static constexpr int ld = tiles::kLd<D>, logd = 2 * ld, wsq = logd + D, cnt = wsq + D,
                       size = cnt + D;
};

// v[0 .. K) summed by pairs into v[0]: v[i] += v[i + H] for i < K / 2, H =
// (K + 1) / 2 (an odd K's middle entry waits a level), then the same on
// v[0 .. H); in the same order on the card and in the host build (for a
// power of two K: v[i] += v[i + K / 2], then K / 4, ..., 1).
template <int K, typename S, int N>
AUX_HD void pair_sums(S (&v)[N]) {
  if constexpr (K > 1) {
    constexpr int H = (K + 1) / 2;
#pragma unroll
    for (int i = 0; i < K / 2; ++i) v[i] += v[i + H];
    pair_sums<H>(v);
  }
}

template <typename S, int N>
AUX_HD S tree_sum(const S* x) {
  S v[N];
  tiles::load_run<S, N>(x, v);
  pair_sums<N>(v);
  return v[0];
}

// Half h's density on lane l: its columns from m(i, c) (M's entry (i, c); only
// i >= c is read), v(c) and count(c), factored; the logs and squares go to the
// half's scratch `hs` (the caller syncs before reading them). A pivot is kept
// apart from its column (its row index is the lane's), updated as its entry
// is.
template <typename S, int D, int NT, class Mf, class Vf, class Nf>
AUX_HD void gauss_half(int l, S* hs, Mf m, Vf v, Nf count) {
  using H = HalfLay<D>;
  constexpr int NL = Halves<NT, D>::NL, U = D / NL, ld = tiles::kLd<D>;
  static_assert(U * NL == D, "the lanes of a half divide the columns");
  S a[U][D + 1], piv[U], inv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = l + NL * u;
#pragma unroll
    for (int i = 0; i < D; ++i) a[u][i] = m(i, c);
    a[u][D] = v(c);
    piv[u] = m(c, c);
    hs[H::cnt + c] = count(c) ? (S)1 : (S)0;
  }
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (j > 0) {  // the update by column j - 1 of the columns c >= j
      const S* col = hs + ((j - 1) & 1) * ld;
      S cj[D];
      tiles::load_run<S, D>(col, cj);
      const S cb = col[D], rd = col[D + 1];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = l + NL * u;
        if (c < j) continue;
        const S f = col[c] * rd;
#pragma unroll
        for (int i = j; i < D; ++i) a[u][i] -= cj[i] * f;  // rows j .. c - 1 are not read
        a[u][D] -= cb * f;
        piv[u] -= col[c] * f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (l + NL * u != j) continue;  // column j's owner: publish it and 1 / d_j
      inv[u] = tiles::pivot_rcp(piv[u]);
      if (j + 1 < D) {
        S* out = hs + (j & 1) * ld;
        tiles::store_run<S, D + 1>(out, a[u]);
        out[D + 1] = inv[u];
      }
    }
    if (j + 1 < D) tiles::team_sync<NT>(0);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = l + NL * u;
    hs[H::logd + c] = (S)0.5 * log(piv[u]);
    hs[H::wsq + c] = a[u][D] * a[u][D] * inv[u];
  }
}

// -v^T M^{-1} v / 2 - log det M / 2 - n log(2 pi) / 2 from a half's scratch,
// each sum in tree_sum's order (the plain versions sum in another, which
// moves a sum of D terms by a few ulp: far inside the tests' rtol 1e-9 in
// f64 and chip_smoke's nrel 1e-4 in f32).
template <typename S, int D>
AUX_HD S half_logpdf(const S* hs) {
  using H = HalfLay<D>;
  return (S)-0.5 * tree_sum<S, D>(hs + H::wsq) - tree_sum<S, D>(hs + H::logd) -
         (S)0.5 * tree_sum<S, D>(hs + H::cnt) * (S)kLog2Pi;
}

// ell's shared memory: the elements' working set, then the halves' scratch.
template <int D>
struct EllLay {
  static constexpr int half = ElementsLay<D>::size, size = half + 2 * HalfLay<D>::size;
};

// Predict + masked update log-likelihood increment of block s (ops/filtering
// .kalman_predict_update): log N(ydm; 0, S) over the observed entries, after
// innovation_cov. Both halves of the team factor S bordered by ydm (a warp
// runs both halves' instructions anyway); thread 0 writes half 0's.
template <typename S, int D, int NT>
AUX_HD void ell_step(int t, StepAt s, int dx, int dy, ElementsIn<S> in, S* ell, S* sh) {
  using L = ElementsLay<D>;
  using Hv = Halves<NT, D>;
  constexpr int ld = tiles::kLd<D>;
  innovation_cov<S, D, NT>(t, s, dx, dy, in, sh, nullptr);
  const S *X = sh + L::X, *ydm = sh + L::ydm, *y = sh + L::y;
  for (int h = Hv::first(t); h < 2; h += Hv::step)
    gauss_half<S, D, NT>(
        t % Hv::NL, sh + EllLay<D>::half + h * HalfLay<D>::size,
        [&](int i, int c) { return (S)0.5 * (X[i * ld + c] + X[c * ld + i]); },
        [&](int c) { return ydm[c]; }, [&](int c) { return c < dy && isfinite(y[c]); });
  tiles::team_sync<NT>(0);
  if (t == 0) ell[s.g] = half_logpdf<S, D>(sh + EllLay<D>::half);
}

// logdensity's inputs (element e at e dx^2, e dy dx, e dy^2, e dx, e dy) and
// working set: padded D x D arrays at row stride kLd<D> (He and Re are H and
// R masked in place), vectors of D, then the halves' scratch.
template <typename S>
struct DensityIn {
  const S *F, *Q, *b, *H, *R, *c, *y, *xp, *xc;
};

template <int D>
struct DensityLay {
  static constexpr int mat = D * tiles::kLd<D>;
  static constexpr int F = 0, Q = mat, H = 2 * mat, R = 3 * mat;
  static constexpr int b = 4 * mat, c = b + D, y = c + D, xp = y + D, xc = xp + D, ye = xc + D,
                       ce = ye + D;
  static constexpr int half = ce + D, size = half + 2 * HalfLay<D>::size;
};

// log N(x_{k+1}; F x_k + b, Q) + masked log N(y; H x_{k+1} + c, R) of block s, on
// a team of NT threads with `sh` its DensityLay<D>: half 0 takes the
// transition, log N(x_cur - F x_prev - b; 0, diag(Q, I)) over dx entries;
// half 1 the observation, log N(ye - He x_cur - ce; 0, Re) over the observed
// ones (the innovation 0 where y is missing). Thread 0 writes their sum.
template <typename S, int D, int NT>
AUX_HD void logdensity_step(int t, StepAt s, int dx, int dy, DensityIn<S> in, S* out, S* sh) {
  using namespace tiles;
  using L = DensityLay<D>;
  using Hv = Halves<NT, D>;
  constexpr int ld = kLd<D>;
  S *F = sh + L::F, *Q = sh + L::Q, *He = sh + L::H, *Re = sh + L::R, *b = sh + L::b;
  S *y = sh + L::y, *xp = sh + L::xp, *xc = sh + L::xc, *ye = sh + L::ye, *ce = sh + L::ce;

  const long xx = (long)dx * dx;
  const MatIn<S> mats[] = {{F, in.F + s.at(0) * xx, dx, dx, (S)0},
                           {Q, in.Q + s.at(1) * xx, dx, dx, (S)1},
                           {He, in.H + s.at(3) * dy * dx, dy, dx, (S)0},
                           {Re, in.R + s.at(4) * dy * dy, dy, dy, (S)0}};
  const VecIn<S> vecs[] = {{b, in.b + s.at(2) * dx, dx},
                           {xp, in.xp + s.at(7) * dx, dx},
                           {xc, in.xc + s.at(8) * dx, dx},
                           {sh + L::c, in.c + s.at(5) * dy, dy},
                           {y, in.y + s.at(6) * dy, dy}};
  stage<S, D, NT>(t, mats, vecs);
  cp_async_wait_all();
  team_sync<NT>(0);
  mask_obs<S, D, NT>(Tile<D, NT>(t), dy, He, Re, y, sh + L::c, ye, ce);
  team_sync<NT>(0);

  for (int h = Hv::first(t); h < 2; h += Hv::step) {
    // The half's operands: M, and v = (yv - A z - cv) where it counts.
    const S *M = h ? Re : Q, *A = h ? He : F, *z = h ? xc : xp, *yv = h ? ye : xc, *cv = h ? ce : b;
    auto count = [&](int c) { return h ? (c < dy && isfinite(y[c])) : c < dx; };
    gauss_half<S, D, NT>(
        t % Hv::NL, sh + L::half + h * HalfLay<D>::size,
        [&](int i, int c) { return M[i * ld + c]; },
        [&](int c) { return count(c) ? yv[c] - row_dot<S, D, false>(A, z, c) - cv[c] : (S)0; },
        count);
  }
  team_sync<NT>(0);
  if (t == 0)
    out[s.g] = half_logpdf<S, D>(sh + L::half) + half_logpdf<S, D>(sh + L::half + HalfLay<D>::size);
}

// ---------------------------------------------------------------------------
// Backward-sampling maps (backward_maps)
// ---------------------------------------------------------------------------

// backward_maps' inputs and outputs in global memory (element e at e dx^2, e dx).
template <typename S>
struct MapsIn {
  const S *F, *Q, *b, *m, *P, *eps;
};

template <typename S>
struct MapsOut {
  S *G, *inc;
};

// A step's working set: D x D arrays at row stride kLd<D> (T is P F^T, then S
// X; C is S' = F T + Q, then P - X^T T), vectors of D (v = F m + b), the
// Gauss-Jordan pivots' columns and rows (4 D each) and the factor's two
// published columns.
template <int D>
struct MapsLay {
  static constexpr int mat = D * tiles::kLd<D>;
  static constexpr int F = 0, Q = mat, P = 2 * mat, T = 3 * mat, Sm = 4 * mat, X = 5 * mat,
                       C = 6 * mat, L = 7 * mat;
  static constexpr int b = 8 * mat, m = b + D, eps = m + D, v = eps + D;
  static constexpr int col = v + D, rowm = col + 4 * D, rowz = rowm + 4 * D, pub = rowz + 4 * D;
  static constexpr int size = pub + 2 * tiles::kLd<D>;
};

// The lower Cholesky factor of an SPD D x D matrix M (m(i, c) its entry (i,
// c); only i >= c is read) into the padded array Lout, its entries past row
// dx zero, non-finite entries zero (ops/chol.safe_cholesky's nan_to_num). Half
// of the team takes it (NL lanes, Halves), lane l = t % NL the columns c = l,
// l + NL, ... in registers; the other threads repeat it and store nothing (a
// team of one thread, the host build, takes every column). Right-looking, one barrier a
// column: the owner of column j takes its pivot's square root d_j, scales
// the column by 1 / d_j and publishes it; every lane then subtracts from its
// columns c > j column j times entry c of column j. An entry's updates come
// in column order with the same products as the left-looking column
// Cholesky of the JAX kernel (lanelin.chol, entries times 1 / d_j), so a
// matrix that is not positive definite fails as there: the columns before
// the first pivot that is not positive stay finite, and every entry from
// that column on is NaN (or inf), then zero. (The root-free LDL^T of
// gauss_half, scaled after its last column, ran ~400 cycles a step slower
// here on an H100: the scaling and the search for the first failed pivot
// cost more than the square roots it takes off the chain.)
template <typename S, int D, int NT, class Mf>
AUX_HD void chol_cols(int t, int dx, S* pub, S* Lout, Mf m) {
  constexpr int NL = Halves<NT, D>::NL, U = D / NL, ld = tiles::kLd<D>;
  static_assert(U * NL == D, "the lanes of a half divide the columns");
  const int l = t % NL;
  S a[U][D];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = l + NL * u;
#pragma unroll
    for (int i = 0; i < D; ++i) a[u][i] = m(i, c);
  }
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (j > 0) {  // the update by column j - 1 of the columns c >= j
      const S* col = pub + ((j - 1) & 1) * ld;
      S cj[D];
      tiles::load_run<S, D>(col, cj);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = l + NL * u;
        if (c < j) continue;
        const S f = col[c];
#pragma unroll
        for (int i = j; i < D; ++i) a[u][i] -= cj[i] * f;  // rows j .. c - 1 are not read
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (l + NL * u != j) continue;  // column j's owner: scale it and publish it
      const S d = sqrt(a[u][j]), r = tiles::pivot_rcp(d);
      a[u][j] = d;
#pragma unroll
      for (int i = j + 1; i < D; ++i) a[u][i] *= r;
      if (j + 1 < D && t < NL) tiles::store_run<S, D>(pub + (j & 1) * ld, a[u]);
    }
    if (j + 1 < D) tiles::team_sync<NT>(0);
  }
  if (t < NL)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = l + NL * u;
#pragma unroll
      for (int i = 0; i < D; ++i)
        Lout[i * ld + c] = i >= c && i < dx ? finite_or_zero(a[u][i]) : (S)0;
    }
}

// Backward-sampling gain G = P F^T S^{-1} and noisy increment m - G (F m + b)
// + L eps of block s (ops/sampling.backward_map_moments with the jittered
// Cholesky of ops/chol.safe_cholesky, in the JAX kernel's order), on a team of
// NT threads with `sh` its MapsLay<D>:
//   S = sym(F (P F^T) + Q), X = S^{-1} (F P), G = X^T,
//   cov = sym(P - X^T (S X)) + (32 eps / dx) trace(cov) I, L = chol(cov).
// S is SPD (Q is), so the Gauss-Jordan needs no exchanges. The trace sums
// cov's dx diagonal entries; the padded pivots are 1, so the factor does not
// fail on them, and its padded entries come out zero. `st`, if not null,
// takes thread 0's clock64 at the start and after the staging, S, the solve,
// cov, the factor and the outputs (diagnostics).
template <typename S, int D, int NT>
AUX_HD void backward_maps_step(int t, StepAt s, int dx, MapsIn<S> in, MapsOut<S> out, S* sh,
                               long long* st) {
  using namespace tiles;
  using L = MapsLay<D>;
  using T = Tile<D, NT>;
  constexpr int R = T::RPT, Cn = T::CPT, ld = kLd<D>;
  const T tl(t);
  S *F = sh + L::F, *Q = sh + L::Q, *P = sh + L::P, *Tp = sh + L::T, *Sm = sh + L::Sm;
  S *X = sh + L::X, *C = sh + L::C, *Lm = sh + L::L, *b = sh + L::b, *m = sh + L::m;
  S *eps = sh + L::eps, *v = sh + L::v;

  stamp(st, t, 0);
  const long dd = (long)dx * dx, xx = s.g * dd, vx = s.g * dx;
  const MatIn<S> mats[] = {{F, in.F + s.at(0) * dd, dx, dx, (S)0},
                           {Q, in.Q + s.at(1) * dd, dx, dx, (S)1},
                           {P, in.P + s.at(4) * dd, dx, dx, (S)0}};
  const VecIn<S> vecs[] = {{b, in.b + s.at(2) * dx, dx},
                           {m, in.m + s.at(3) * dx, dx},
                           {eps, in.eps + s.at(5) * dx, dx}};
  stage<S, D, NT>(t, mats, vecs);
  cp_async_wait_all();
  team_sync<NT>(0);
  stamp(st, t, 1);

  // Stage 1: T = P F^T, the right-hand side F P (in registers), v = F m + b.
  Regs<S, D, NT> acc, ms, z;
  tile_mm<S, D, NT, false, true>(tl, P, F, acc);
  tile_store<S, D, NT>(tl, acc, Tp);
  tile_mm<S, D, NT, false, false>(tl, F, P, z);
  if (tl.first())
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int i = tl.r0 + rr;
      v[i] = row_dot<S, D, false>(F, m, i) + b[i];
    }
  team_sync<NT>(0);

  // Stage 2: S' = F T + Q into C.
  tile_mm<S, D, NT, false, false>(tl, F, Tp, acc);
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int cc = 0; cc < Cn; ++cc) acc[rr][cc] += Q[(tl.r0 + rr) * ld + tl.c0 + cc];
  tile_store<S, D, NT>(tl, acc, C);
  team_sync<NT>(0);

  // Stage 3: the thread's tile of S = sym(S') in registers and in Sm, the
  // first pivot pair published.
  sym_tile<S, D, NT>(tl, C, ms);
  tile_store<S, D, NT>(tl, ms, Sm);
  gj_publish_first<S, D, NT>(tl, ms, z, sh + L::col, sh + L::rowm, sh + L::rowz);
  team_sync<NT>(0);
  stamp(st, t, 2);

  // Stage 4: X = S^{-1} F P.
  gj_solve<S, D, NT>(tl, 0, ms, z, sh + L::col, sh + L::rowm, sh + L::rowz, X);
  stamp(st, t, 3);

  // Stage 5: T = S X (S G^T), then C = P - X^T T (P - G S G^T).
  tile_mm<S, D, NT, false, false>(tl, Sm, X, acc);
  tile_store<S, D, NT>(tl, acc, Tp);
  team_sync<NT>(0);
  tile_mm<S, D, NT, true, false>(tl, X, Tp, acc);
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int cc = 0; cc < Cn; ++cc)
      acc[rr][cc] = P[(tl.r0 + rr) * ld + tl.c0 + cc] - acc[rr][cc];
  tile_store<S, D, NT>(tl, acc, C);
  team_sync<NT>(0);
  stamp(st, t, 4);

  // Stage 6: L = chol(cov), cov = sym(C) + jitter on the dx diagonal, 1 on
  // the padded one.
  S trace = (S)0;
#pragma unroll
  for (int i = 0; i < D; ++i)
    if (i < dx) trace += C[i * ld + i];
  const S eps_type = sizeof(S) == 4 ? (S)1.1920928955078125e-07 : (S)2.220446049250313e-16;
  const S jitter = ((S)32 * eps_type / (S)dx) * trace;
  chol_cols<S, D, NT>(t, dx, sh + L::pub, Lm, [&](int i, int c) {
    const S e = (S)0.5 * (C[i * ld + c] + C[c * ld + i]);
    return i != c ? e : c < dx ? e + jitter : (S)1;
  });
  team_sync<NT>(0);
  stamp(st, t, 5);

  // Stage 7: the outputs, G = X^T and inc = (m - G v) + L eps.
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int i = tl.r0 + rr;
#pragma unroll
    for (int cc = 0; cc < Cn; ++cc) {
      const int j = tl.c0 + cc;
      if (i < dx && j < dx) out.G[xx + i * dx + j] = X[j * ld + i];
    }
  }
  if (tl.first())
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int i = tl.r0 + rr;
      if (i < dx)
        out.inc[vx + i] = (m[i] - row_dot<S, D, true>(X, v, i)) + row_dot<S, D, false>(Lm, eps, i);
    }
  stamp(st, t, 6);
}

}  // namespace

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// Launch section: everything above is plain C++ on pointers and also builds
// as host code (one lane, no barriers); what follows needs nvcc.
// ---------------------------------------------------------------------------
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// The instances: D and the team (threads a step, a block). At kWideD the
// teams were chosen on an H100 by device time at the SV model's T = 250,
// d = 30 (f32, PERF.md): 32 threads (a tile of 32 entries a product) took
// 1.7-2.6x as long as 64 for all four; 128 (8 entries) beat 64 (16) for the
// products of make_elements (0.0258 ms against 0.0306) and backward_maps
// (0.0205 against 0.0243, and no spills in f64), and lost for ell and
// logdensity, whose density columns take 32 of the threads either way.
// At kWide48D (float32 only) the density halves take D = 48 lanes each, so
// ell and logdensity run on 96 threads (a 4 x 6 tile a product), the other
// two on 128 (3 x 6 tiles; backward_maps' factor on 48 of them).
constexpr int kElemTeam = 32;          // every kernel at kElemD
constexpr int kWideElemTeam = 128;     // make_elements at kWideD
constexpr int kWideMapsTeam = 128;     // backward_maps at kWideD
constexpr int kWideDensityTeam = 64;   // ell and logdensity at kWideD
constexpr int kWide48ElemTeam = 128;    // make_elements at kWide48D
constexpr int kWide48MapsTeam = 128;    // backward_maps at kWide48D
constexpr int kWide48DensityTeam = 96;  // ell and logdensity at kWide48D
constexpr int kMaxShmem = 232448;  // bytes of shared memory a block may have (227 KB)
static_assert(EllLay<kWideD>::size * sizeof(double) <= kMaxShmem &&
                  ElementsLay<kWideD>::size <= EllLay<kWideD>::size &&
                  DensityLay<kWideD>::size * sizeof(double) <= kMaxShmem &&
                  MapsLay<kWideD>::size * sizeof(double) <= kMaxShmem,
              "the wide steps' shared memory fits a block");
static_assert(EllLay<kWide48D>::size * sizeof(float) <= kMaxShmem &&
                  ElementsLay<kWide48D>::size <= EllLay<kWide48D>::size &&
                  DensityLay<kWide48D>::size * sizeof(float) <= kMaxShmem &&
                  MapsLay<kWide48D>::size * sizeof(float) <= kMaxShmem,
              "the float32 D = 48 steps' shared memory fits a block");

// Block blockIdx.x's (step, chain) pair of `chains` chains, the operands
// with bits in `shared` read once for every chain (StepAt).
__device__ inline StepAt block_step(int chains, int shared) {
  return StepAt{(long)blockIdx.x, chains, (unsigned)shared};
}

// A block's filtering element; `stamps`, if not null, takes kElemStamps
// clock64 readings a block.
template <typename S, int D, int NT>
__global__ void __launch_bounds__(NT)
elements_kernel(int chains, int shared, int dx, int dy, ElementsIn<S> in, ElementsOut<S> out,
                long long* stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  elements_step<S, D, NT>(threadIdx.x, block_step(chains, shared), dx, dy, in, out,
                          reinterpret_cast<S*>(smem),
                          stamps ? stamps + (long)blockIdx.x * kElemStamps : nullptr);
}

template <typename S, int D, int NT>
__global__ void __launch_bounds__(NT)
ell_kernel(int chains, int shared, int dx, int dy, ElementsIn<S> in, S* ell) {
  extern __shared__ __align__(16) unsigned char smem[];
  ell_step<S, D, NT>(threadIdx.x, block_step(chains, shared), dx, dy, in, ell,
                     reinterpret_cast<S*>(smem));
}

template <typename S, int D, int NT>
__global__ void __launch_bounds__(NT)
logdensity_kernel(int chains, int shared, int dx, int dy, DensityIn<S> in, S* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  logdensity_step<S, D, NT>(threadIdx.x, block_step(chains, shared), dx, dy, in, out,
                            reinterpret_cast<S*>(smem));
}

// A block's gain and increment; `stamps`, if not null, takes kMapStamps
// clock64 readings a block.
template <typename S, int D, int NT>
__global__ void __launch_bounds__(NT)
backward_maps_kernel(int chains, int shared, int dx, MapsIn<S> in, MapsOut<S> out,
                     long long* stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  backward_maps_step<S, D, NT>(threadIdx.x, block_step(chains, shared), dx, in, out,
                               reinterpret_cast<S*>(smem),
                               stamps ? stamps + (long)blockIdx.x * kMapStamps : nullptr);
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(D, NT) for the instance that takes dx, dy in S: kElemD on kElemTeam
// threads up to 16, kWideD on WideNT up to 32, in float kWide48D on Wide48NT
// up to 48; cudaErrorInvalidValue for anything else (no step, no chain, more
// blocks than a grid holds, or a wider d: float64 stops at 32).
template <typename S, int WideNT, int Wide48NT, class F>
int on_instance(int n, int chains, int dx, int dy, F f) {
  constexpr bool f32 = std::is_same_v<S, float>;
  const int d = dx > dy ? dx : dy;
  if (n <= 0 || chains <= 0 || (long)n * chains > 0x7fffffffL || dx < 1 || dy < 1 ||
      d > (f32 ? kWide48D : kWideD))
    return (int)cudaErrorInvalidValue;
  if (d <= kElemD) return f(Int<kElemD>(), Int<kElemTeam>());
  if constexpr (f32)
    if (d > kWideD) return f(Int<kWide48D>(), Int<Wide48NT>());
  return f(Int<kWideD>(), Int<WideNT>());
}

// Launch `kernel` on n blocks of NT threads with `bytes` of dynamic shared
// memory (past 48 KB after raising the kernel's limit, as scan.cu does).
template <int NT, class... P, class... A>
int launch_steps(void (*kernel)(P...), int n, size_t bytes, cudaStream_t stream, A... args) {
  if (bytes > 48 * 1024)
    if (cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes))
      return (int)e;
  kernel<<<n, NT, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches n x chains blocks: `chains` chains' n steps, the inputs
// with bits in `shared` (their place in the argument list, F = bit 0) laid out
// (n, ...) for every chain, the others and the outputs (n, chains, ...).
#define AUX_DEFINE_MAPS(SUFFIX, S)                                                             \
  extern "C" int aux_make_elements_##SUFFIX(int n, int chains, int shared, int dx, int dy,     \
                                            const S* F, const S* Q, const S* b, const S* H,    \
                                            const S* R, const S* c, const S* y, const S* m,    \
                                            const S* P, S* A, S* bel, S* C, S* eta, S* J,      \
                                            long long* stamps, void* stream) {                 \
    return on_instance<S, kWideElemTeam, kWide48ElemTeam>(                                     \
        n, chains, dx, dy, [&](auto D_, auto NT_) {                                            \
      constexpr int D = decltype(D_)::value, NT = decltype(NT_)::value;                        \
      return launch_steps<NT>(elements_kernel<S, D, NT>, n * chains,                           \
                              ElementsLay<D>::size * sizeof(S), (cudaStream_t)stream, chains,  \
                              shared, dx, dy, ElementsIn<S>{F, Q, b, H, R, c, y, m, P},        \
                              ElementsOut<S>{A, bel, C, eta, J}, stamps);                      \
    });                                                                                        \
  }                                                                                            \
  extern "C" int aux_ell_##SUFFIX(int n, int chains, int shared, int dx, int dy, const S* F,   \
                                  const S* Q, const S* b, const S* H, const S* R, const S* c,  \
                                  const S* y, const S* m, const S* P, S* ell, void* stream) {  \
    return on_instance<S, kWideDensityTeam, kWide48DensityTeam>(                               \
        n, chains, dx, dy, [&](auto D_, auto NT_) {                                            \
      constexpr int D = decltype(D_)::value, NT = decltype(NT_)::value;                        \
      return launch_steps<NT>(ell_kernel<S, D, NT>, n * chains, EllLay<D>::size * sizeof(S),   \
                              (cudaStream_t)stream, chains, shared, dx, dy,                    \
                              ElementsIn<S>{F, Q, b, H, R, c, y, m, P}, ell);                  \
    });                                                                                        \
  }                                                                                            \
  extern "C" int aux_backward_maps_##SUFFIX(int n, int chains, int shared, int dx, const S* F, \
                                            const S* Q, const S* b, const S* m, const S* P,    \
                                            const S* eps, S* G, S* inc, long long* stamps,     \
                                            void* stream) {                                    \
    return on_instance<S, kWideMapsTeam, kWide48MapsTeam>(                                     \
        n, chains, dx, 1, [&](auto D_, auto NT_) {                                             \
      constexpr int D = decltype(D_)::value, NT = decltype(NT_)::value;                        \
      return launch_steps<NT>(backward_maps_kernel<S, D, NT>, n * chains,                      \
                              MapsLay<D>::size * sizeof(S), (cudaStream_t)stream, chains,      \
                              shared, dx, MapsIn<S>{F, Q, b, m, P, eps}, MapsOut<S>{G, inc},   \
                              stamps);                                                         \
    });                                                                                        \
  }                                                                                            \
  extern "C" int aux_logdensity_steps_##SUFFIX(int n, int chains, int shared, int dx, int dy,  \
                                               const S* F, const S* Q, const S* b,             \
                                               const S* H, const S* R, const S* c,             \
                                               const S* y, const S* xp, const S* xc, S* out,   \
                                               void* stream) {                                 \
    return on_instance<S, kWideDensityTeam, kWide48DensityTeam>(                               \
        n, chains, dx, dy, [&](auto D_, auto NT_) {                                            \
      constexpr int D = decltype(D_)::value, NT = decltype(NT_)::value;                        \
      return launch_steps<NT>(logdensity_kernel<S, D, NT>, n * chains,                         \
                              DensityLay<D>::size * sizeof(S), (cudaStream_t)stream, chains,   \
                              shared, dx, dy, DensityIn<S>{F, Q, b, H, R, c, y, xp, xc}, out); \
    });                                                                                        \
  }

AUX_DEFINE_MAPS(f32, float)
AUX_DEFINE_MAPS(f64, double)

extern "C" const char* aux_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
#endif  // __CUDACC__
