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
// elements_kernel: one block (a team of kElemTeam threads) a step, at a compile-time
// D = kElemD (tile.cuh; dx, dy <= D padded exactly: F, Q, P, H, R, b, m, c, y
// zero outside d, the padded observation rows treated as missing, so He's
// rows are zero there and Re's diagonal one, S = diag(S, I), and every
// product keeps the padding). The step's inputs are staged into shared
// memory by cp.async before the chain, so no global load sits on it; each
// thread computes its tile of each D x D product in registers from padded
// rows read by vector loads; S X = He is solved by Gauss-Jordan by 2 x 2
// pivot blocks (S is SPD: no exchanges), one barrier a pair; every output
// goes to global memory once, from registers, after the last barrier. With
// ~8 steps an SM (1023 steps, one wave), the SM's shared-memory reads set
// the pace: a product reads D (RPT + CPT) values a thread, so the tiles are
// as square as the team allows, and the symmetric S, C and J are each
// computed once and symmetrised through shared memory (a barrier each)
// rather than computed in both orders: 10 tile products and 16 barriers a
// step. C is P_pred - (P_pred He^T) K^T, which equals the plain version's
// P_pred - K S K^T (K S = P_pred He^T). The team is a warp: in the MH step
// on an H100, 32 threads a step took 0.0269 ms for the step's two launches,
// 64 took 0.0284 and 128 took 0.0366 (PERF.md).
//
// ell, backward_maps and logdensity: one warp per step, runtime d, the warp's
// lanes sharing each product of smallmat.cuh on operands in shared memory. A
// step with t >= n is skipped; nothing is padded.
//
// Missing observations follow ops/lgssm.mask_observation exactly: every
// masked quantity is selected with `isfinite(y)`, never multiplied by a 0/1
// mask, because the model's H, R, c may be NaN where y is missing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, no --use_fast_math
// (the masking needs isfinite/NaN semantics, the densities IEEE log/sqrt).
#include "smallmat.cuh"
#include "tile.cuh"

namespace {

using namespace smallmat;

constexpr double kLog2Pi = 1.8378770664093453;

// Shared scratch of one warp of the smallmat kernels, in elements of S: 6
// matrices and 5 vectors (ell_step's working set, the largest).
template <int MD>
constexpr int map_scratch() { return 6 * MD * MD + 5 * MD; }

// Masked projection of one step's observation model (ops/lgssm.mask_observation);
// mk[i] is 1 where y[i] is observed. Returns the number of observed entries.
template <typename S>
AUX_HD int masked_obs(int lane, int nl, int dx, int dy, const S* H, const S* R, const S* c,
                      const S* y, S* mk, S* He, S* Re, S* ce, S* ye) {
  for (int i = lane; i < dy; i += nl) {
    const bool o = isfinite(y[i]);
    mk[i] = o ? (S)1 : (S)0;
    ye[i] = o ? nan_to_num(y[i]) : (S)0;
    ce[i] = o ? nan_to_num(c[i]) : (S)0;
  }
  for (int e = lane; e < dy * dx; e += nl)
    He[e] = isfinite(y[e / dx]) ? nan_to_num(H[e]) : (S)0;
  for (int e = lane; e < dy * dy; e += nl) {
    const int i = e / dy, j = e % dy;
    const bool oi = isfinite(y[i]), oj = isfinite(y[j]);
    S r = (oi && oj) ? nan_to_num(R[e]) : (S)0;
    if (i == j) r += (S)1 - (oi ? (S)1 : (S)0);
    Re[e] = r;
  }
  AUX_SYNC();
  int n_obs = 0;
  for (int i = 0; i < dy; ++i) n_obs += mk[i] != (S)0 ? 1 : 0;
  return n_obs;
}

// m_pred = F m + b, P_pred = F (P F^T) + Q.
template <typename S>
AUX_HD void predict(int lane, int nl, int dx, const S* F, const S* Q, const S* b, const S* m,
                    const S* P, S* m_pred, S* P_pred, S* tmp) {
  mv(lane, nl, dx, dx, F, m, m_pred);
  for (int i = lane; i < dx; i += nl) m_pred[i] += b[i];
  mm_nt(lane, nl, dx, dx, dx, P, F, tmp);
  mm(lane, nl, dx, dx, dx, F, tmp, P_pred);
  for (int e = lane; e < dx * dx; e += nl) P_pred[e] += Q[e];
  AUX_SYNC();
}

// S = sym(He (P_pred He^T) + Re), (dy, dy).
template <typename S>
AUX_HD void innovation_cov(int lane, int nl, int dx, int dy, const S* He, const S* P_pred,
                           const S* Re, S* Sm, S* tmp) {
  mm_nt(lane, nl, dx, dx, dy, P_pred, He, tmp);  // (dx, dy)
  mm(lane, nl, dy, dx, dy, He, tmp, Sm);
  for (int e = lane; e < dy * dy; e += nl) Sm[e] += Re[e];
  AUX_SYNC();
  sym(lane, nl, dy, Sm);
}

// w <- (mask ? y_eff - w - c_eff : 0), the masked innovation.
template <typename S>
AUX_HD void masked_innov(int lane, int nl, int dy, const S* mk, const S* ye, const S* ce, S* w) {
  for (int i = lane; i < dy; i += nl) w[i] = mk[i] != (S)0 ? ye[i] - w[i] - ce[i] : (S)0;
  AUX_SYNC();
}

template <typename S>
AUX_HD S sum_squares(int n, const S* w) {
  S quad = (S)0;
  for (int i = 0; i < n; ++i) quad += w[i] * w[i];
  return quad;
}

// ---------------------------------------------------------------------------
// The filtering elements (elements_kernel)
// ---------------------------------------------------------------------------

constexpr int kElemD = 16;  // the elements' compile-time dimension (dx, dy <= 16)
constexpr int kElemStamps = 6;  // clock64 readings of a step (diagnostics)

// A step's inputs and the elements' outputs in global memory (step k at k
// dx^2, k dy dx, k dy^2, k dx, k dy).
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

// Step k's inputs into the padded arrays by cp.async (zeros outside dx, dy;
// the caller waits), thread t of NT.
template <typename S, int D, int NT>
AUX_HD void stage_step(int t, long k, int dx, int dy, ElementsIn<S> in, S* sh) {
  using L = ElementsLay<D>;
  constexpr int ld = tiles::kLd<D>;
  const long xx = k * dx * dx, yx = k * dy * dx, yy = k * dy * dy;
  for (int q = t; q < D * D; q += NT) {
    const int i = q / D, j = q % D, at = i * ld + j;
    const bool ix = i < dx, iy = i < dy, jx = j < dx;
    if (ix && jx) {
      tiles::copy_one(sh + L::F + at, in.F + xx + i * dx + j);
      tiles::copy_one(sh + L::Q + at, in.Q + xx + i * dx + j);
      tiles::copy_one(sh + L::P + at, in.P + xx + i * dx + j);
    } else {
      sh[L::F + at] = sh[L::Q + at] = sh[L::P + at] = (S)0;
    }
    if (iy && jx)
      tiles::copy_one(sh + L::H + at, in.H + yx + i * dx + j);
    else
      sh[L::H + at] = (S)0;
    if (iy && j < dy)
      tiles::copy_one(sh + L::R + at, in.R + yy + i * dy + j);
    else
      sh[L::R + at] = (S)0;
  }
  for (int i = t; i < D; i += NT) {
    if (i < dx) {
      tiles::copy_one(sh + L::b + i, in.b + k * dx + i);
      tiles::copy_one(sh + L::m + i, in.m + k * dx + i);
    } else {
      sh[L::b + i] = sh[L::m + i] = (S)0;
    }
    if (i < dy) {
      tiles::copy_one(sh + L::c + i, in.c + k * dy + i);
      tiles::copy_one(sh + L::y + i, in.y + k * dy + i);
    } else {
      sh[L::c + i] = sh[L::y + i] = (S)0;
    }
  }
}

// SGF-2021 filtering element (A, b, C, eta, J) of step k on a team of NT
// threads (thread t; barrier 0 of the team; one thread in the host build),
// with `sh` the step's ElementsLay<D> in shared memory:
//   mask (He, Re, ye, ce), m_pred = F m + b, P_pred = F (P F^T) + Q,
//   S = sym(He (P_pred He^T) + Re), X = S^{-1} He, K = P_pred X^T,
//   A = F - K (He F), b = m_pred + K ydm, C = sym(P_pred - (P_pred He^T) K^T),
//   eta = (F^T X^T) ydb, J = sym((F^T X^T) (He F)),
// ydb, ydm the masked innovations of b and m_pred. Each entry is summed over
// k ascending, as smallmat's products sum it, so the result does not depend
// on NT. `st`, if not null, takes thread 0's clock64 at the start, after
// the staging, after S, after the solve, after K and at the end
// (diagnostics, kernel_times.py).
template <typename S, int D, int NT>
AUX_HD void elements_step(int t, long k, int dx, int dy, ElementsIn<S> in, ElementsOut<S> out,
                          S* sh, long long* st) {
  using namespace tiles;
  using L = ElementsLay<D>;
  using T = Tile<D, NT>;
  constexpr int R = T::RPT, Cn = T::CPT, ld = kLd<D>;
  const T tl(t);
  S *F = sh + L::F, *Q = sh + L::Q, *He = sh + L::H, *Re = sh + L::R, *P = sh + L::P;
  S *Tp = sh + L::T, *Pp = sh + L::Pp, *HF = sh + L::HF, *X = sh + L::X, *K = sh + L::K;
  S *Tm = sh + L::Tm, *b = sh + L::b, *c = sh + L::c, *y = sh + L::y, *m = sh + L::m;
  S *ye = sh + L::ye, *ce = sh + L::ce, *mp = sh + L::mp, *ydb = sh + L::ydb, *ydm = sh + L::ydm;
  auto obs = [&](int i) { return i < dy && isfinite(y[i]); };

  stamp(st, t, 0);
  stage_step<S, D, NT>(t, k, dx, dy, in, sh);
  cp_async_wait_all();
  team_sync<NT>(0);
  stamp(st, t, 1);

  // Stage 1: the masked model (in place: each entry is its owner's), T = P
  // F^T, m_pred, ye, ce.
  Regs<S, D, NT> acc;
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int i = tl.r0 + rr;
    const bool oi = obs(i);
#pragma unroll
    for (int cc = 0; cc < Cn; ++cc) {
      const int j = tl.c0 + cc, at = i * ld + j;
      He[at] = oi ? smallmat::nan_to_num(He[at]) : (S)0;
      S r = (oi && obs(j)) ? smallmat::nan_to_num(Re[at]) : (S)0;
      if (i == j) r += (S)1 - (oi ? (S)1 : (S)0);
      Re[at] = r;
    }
    if (tl.first()) {
      mp[i] = row_dot<S, D, false>(F, m, i) + b[i];
      ye[i] = oi ? smallmat::nan_to_num(y[i]) : (S)0;
      ce[i] = oi ? smallmat::nan_to_num(c[i]) : (S)0;
    }
  }
  tile_mm<S, D, NT, false, true>(tl, P, F, acc);
  tile_store<S, D, NT>(tl, acc, Tp);
  team_sync<NT>(0);

  // Stage 2: P_pred = F T + Q, HF = He F, the masked innovations.
  tile_mm<S, D, NT, false, false>(tl, F, Tp, acc);
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int cc = 0; cc < Cn; ++cc) acc[rr][cc] += Q[(tl.r0 + rr) * ld + tl.c0 + cc];
  tile_store<S, D, NT>(tl, acc, Pp);
  tile_mm<S, D, NT, false, false>(tl, He, F, acc);
  tile_store<S, D, NT>(tl, acc, HF);
  if (tl.first()) {
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int i = tl.r0 + rr;
      const bool oi = obs(i);
      ydb[i] = oi ? ye[i] - row_dot<S, D, false>(He, b, i) - ce[i] : (S)0;
      ydm[i] = oi ? ye[i] - row_dot<S, D, false>(He, mp, i) - ce[i] : (S)0;
    }
  }
  team_sync<NT>(0);

  // Stage 3: T = P_pred He^T (T's old value is read no more).
  tile_mm<S, D, NT, false, true>(tl, Pp, He, acc);
  tile_store<S, D, NT>(tl, acc, Tp);
  team_sync<NT>(0);

  // Stage 4: S' = He T + Re into X (free until the solve ends), then the
  // thread's tile of S = sym(S') in registers, the right-hand side He, and
  // the first pivot pair published.
  Regs<S, D, NT> ms, z;
  tile_mm<S, D, NT, false, false>(tl, He, Tp, acc);
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int cc = 0; cc < Cn; ++cc) acc[rr][cc] += Re[(tl.r0 + rr) * ld + tl.c0 + cc];
  tile_store<S, D, NT>(tl, acc, X);
  team_sync<NT>(0);
  sym_tile<S, D, NT>(tl, X, ms);
  tile_load<S, D, NT>(tl, He, z);
  gj_publish_first<S, D, NT>(tl, ms, z, sh + L::col, sh + L::rowm, sh + L::rowz);
  team_sync<NT>(0);
  stamp(st, t, 2);

  // Stage 5: X = S^{-1} He, into shared memory.
  gj_solve<S, D, NT>(tl, 0, ms, z, sh + L::col, sh + L::rowm, sh + L::rowz, X);
  stamp(st, t, 3);

  // Stage 6: K = P_pred X^T, Tm = F^T X^T.
  tile_mm<S, D, NT, false, true>(tl, Pp, X, acc);
  tile_store<S, D, NT>(tl, acc, K);
  tile_mm<S, D, NT, true, true>(tl, F, X, acc);
  tile_store<S, D, NT>(tl, acc, Tm);
  team_sync<NT>(0);
  stamp(st, t, 4);

  // Stage 7: the outputs, from registers.
  const long xx = k * dx * dx, vx = k * dx;
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

// Predict + masked update log-likelihood increment of step t.
template <typename S, int MD>
AUX_HD void ell_step(int lane, int nl, int t, int dx, int dy, const S* F_, const S* Q_,
                     const S* b_, const S* H_, const S* R_, const S* c_, const S* y_,
                     const S* m_, const S* P_, S* ell_, S* sm) {
  S *He = sm, *Re = He + MD * MD, *P_pred = Re + MD * MD, *tmp = P_pred + MD * MD;
  S *Sm = tmp + MD * MD, *L = Sm + MD * MD;
  S *mk = L + MD * MD, *ce = mk + MD, *ye = ce + MD, *m_pred = ye + MD, *w = m_pred + MD;

  const int n_obs = masked_obs(lane, nl, dx, dy, H_ + (long)t * dy * dx,
                               R_ + (long)t * dy * dy, c_ + (long)t * dy, y_ + (long)t * dy,
                               mk, He, Re, ce, ye);
  predict(lane, nl, dx, F_ + (long)t * dx * dx, Q_ + (long)t * dx * dx, b_ + (long)t * dx,
          m_ + (long)t * dx, P_ + (long)t * dx * dx, m_pred, P_pred, tmp);
  innovation_cov(lane, nl, dx, dy, He, P_pred, Re, Sm, tmp);
  const S log_det = chol(lane, nl, dy, Sm, L);

  mv(lane, nl, dy, dx, He, m_pred, w);
  masked_innov(lane, nl, dy, mk, ye, ce, w);
  tri_solve_lower(lane, nl, dy, 1, L, w, w);
  const S quad = sum_squares(dy, w);
  if (lane == 0) ell_[t] = (S)-0.5 * quad - log_det - (S)0.5 * (S)n_obs * (S)kLog2Pi;
}

// Backward-sampling gain and noisy increment of step t (ops/sampling.backward_map_moments
// with the jittered Cholesky of ops/chol.safe_cholesky).
template <typename S, int MD>
AUX_HD void backward_maps_step(int lane, int nl, int t, int dx, const S* F_, const S* Q_,
                               const S* b_, const S* m_, const S* P_, const S* eps_, S* G_,
                               S* inc_, S* sm) {
  const S* F = F_ + (long)t * dx * dx;
  const S* P = P_ + (long)t * dx * dx;
  const S* m = m_ + (long)t * dx;
  S *Sm = sm, *FP = Sm + MD * MD, *L = FP + MD * MD, *tmp = L + MD * MD;
  S *gain = tmp + MD * MD, *v = gain + MD * MD, *w = v + MD;

  // S = sym(F (P F^T) + Q)
  mm_nt(lane, nl, dx, dx, dx, P, F, tmp);
  mm(lane, nl, dx, dx, dx, F, tmp, Sm);
  const S* Q = Q_ + (long)t * dx * dx;
  for (int e = lane; e < dx * dx; e += nl) Sm[e] += Q[e];
  AUX_SYNC();
  sym(lane, nl, dx, Sm);

  mm(lane, nl, dx, dx, dx, F, P, FP);
  spd_solve(lane, nl, dx, dx, Sm, FP, L, FP);  // FP <- S^{-1} F P

  // gain = (S^{-1} F P)^T = P F^T S^{-1}
  for (int e = lane; e < dx * dx; e += nl) gain[e] = FP[(e % dx) * dx + e / dx];
  AUX_SYNC();
  copy(lane, nl, dx * dx, gain, G_ + (long)t * dx * dx);

  // cov = sym(P - gain (S gain^T)) + (32 eps / dx) trace(cov) I
  mm_nt(lane, nl, dx, dx, dx, Sm, gain, tmp);
  mm(lane, nl, dx, dx, dx, gain, tmp, FP);
  for (int e = lane; e < dx * dx; e += nl) FP[e] = P[e] - FP[e];
  AUX_SYNC();
  sym(lane, nl, dx, FP);
  S trace = (S)0;
  for (int i = 0; i < dx; ++i) trace += FP[i * dx + i];
  const S eps_type = sizeof(S) == 4 ? (S)1.1920928955078125e-07 : (S)2.220446049250313e-16;
  const S jitter = ((S)32 * eps_type / (S)dx) * trace;
  AUX_SYNC();  // every lane has read the diagonal before it changes
  for (int i = lane; i < dx; i += nl) FP[i * dx + i] += jitter;
  AUX_SYNC();
  chol(lane, nl, dx, FP, L);
  for (int e = lane; e < dx * dx; e += nl) L[e] = finite_or_zero(L[e]);
  AUX_SYNC();

  // inc = m - gain (F m + b) + L eps
  mv(lane, nl, dx, dx, F, m, v);
  const S* b = b_ + (long)t * dx;
  for (int i = lane; i < dx; i += nl) v[i] += b[i];
  AUX_SYNC();
  mv(lane, nl, dx, dx, gain, v, w);
  mv(lane, nl, dx, dx, L, eps_ + (long)t * dx, v);
  S* inc = inc_ + (long)t * dx;
  for (int i = lane; i < dx; i += nl) inc[i] = (m[i] - w[i]) + v[i];
  AUX_SYNC();
}

// log N(x_t; F x_{t-1} + b, Q) + masked log N(y_t; H x_t + c, R) of step t.
template <typename S, int MD>
AUX_HD void logdensity_step(int lane, int nl, int t, int dx, int dy, const S* F_, const S* Q_,
                            const S* b_, const S* H_, const S* R_, const S* c_, const S* y_,
                            const S* xp_, const S* xc_, S* out_, S* sm) {
  const S* xc = xc_ + (long)t * dx;
  const S* b = b_ + (long)t * dx;
  S *He = sm, *Re = He + MD * MD, *L = Re + MD * MD;
  S *mk = L + MD * MD, *ce = mk + MD, *ye = ce + MD, *w = ye + MD;

  const S log_det_q = chol(lane, nl, dx, Q_ + (long)t * dx * dx, L);
  mv(lane, nl, dx, dx, F_ + (long)t * dx * dx, xp_ + (long)t * dx, w);
  for (int i = lane; i < dx; i += nl) w[i] = xc[i] - (w[i] + b[i]);
  AUX_SYNC();
  tri_solve_lower(lane, nl, dx, 1, L, w, w);
  const S trans = (S)-0.5 * sum_squares(dx, w) - log_det_q - (S)0.5 * (S)dx * (S)kLog2Pi;

  const int n_obs = masked_obs(lane, nl, dx, dy, H_ + (long)t * dy * dx,
                               R_ + (long)t * dy * dy, c_ + (long)t * dy, y_ + (long)t * dy,
                               mk, He, Re, ce, ye);
  const S log_det_r = chol(lane, nl, dy, Re, L);
  mv(lane, nl, dy, dx, He, xc, w);
  masked_innov(lane, nl, dy, mk, ye, ce, w);
  tri_solve_lower(lane, nl, dy, 1, L, w, w);
  const S obs = (S)-0.5 * sum_squares(dy, w) - log_det_r - (S)0.5 * (S)n_obs * (S)kLog2Pi;
  if (lane == 0) out_[t] = trans + obs;
}

}  // namespace

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// Launch section: everything above is plain C++ on pointers and also builds
// as host code (one lane, no barriers); what follows needs nvcc.
// ---------------------------------------------------------------------------
#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 16;   // largest dx, dy the kernels are built for
static_assert(kMaxD <= kElemD, "elements_kernel pads every dimension the entries accept");
constexpr int kWarps = 2;   // warps (time steps) per block
constexpr int kScratch = map_scratch<kMaxD>();

// Warp w of the block takes step t = blockIdx.x * kWarps + w, with its slice
// of the block's shared scratch.
#define AUX_STEP_PROLOGUE(S)                                        \
  __shared__ S scratch[kWarps][kScratch];                             \
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;       \
  const int t = blockIdx.x * kWarps + warp;                         \
  if (t >= n) return;

constexpr int kElemTeam = 32;  // elements_kernel's threads a step (a block)
// A larger D's working set needs cudaFuncSetAttribute (as scan.cu's set_shmem) past 48 KB.
static_assert(ElementsLay<kElemD>::size * sizeof(double) <= 48 * 1024,
              "elements_kernel's shared memory fits the default limit");

// Step blockIdx.x's filtering element on the block; `stamps`, if not null,
// takes kElemStamps clock64 readings a step.
template <typename S>
__global__ void __launch_bounds__(kElemTeam)
elements_kernel(int dx, int dy, ElementsIn<S> in, ElementsOut<S> out, long long* stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  elements_step<S, kElemD, kElemTeam>(threadIdx.x, blockIdx.x, dx, dy, in, out,
                                      reinterpret_cast<S*>(smem),
                                      stamps ? stamps + (long)blockIdx.x * kElemStamps : nullptr);
}

template <typename S>
__global__ void __launch_bounds__(kWarps * 32)
ell_kernel(int n, int dx, int dy, const S* F, const S* Q, const S* b, const S* H,
           const S* R, const S* c, const S* y, const S* m, const S* P, S* ell) {
  AUX_STEP_PROLOGUE(S)
  ell_step<S, kMaxD>(lane, 32, t, dx, dy, F, Q, b, H, R, c, y, m, P, ell, scratch[warp]);
}

template <typename S>
__global__ void __launch_bounds__(kWarps * 32)
backward_maps_kernel(int n, int dx, const S* F, const S* Q, const S* b, const S* m,
                     const S* P, const S* eps, S* G, S* inc) {
  AUX_STEP_PROLOGUE(S)
  backward_maps_step<S, kMaxD>(lane, 32, t, dx, F, Q, b, m, P, eps, G, inc, scratch[warp]);
}

template <typename S>
__global__ void __launch_bounds__(kWarps * 32)
logdensity_kernel(int n, int dx, int dy, const S* F, const S* Q, const S* b, const S* H,
                  const S* R, const S* c, const S* y, const S* xp, const S* xc, S* out) {
  AUX_STEP_PROLOGUE(S)
  logdensity_step<S, kMaxD>(lane, 32, t, dx, dy, F, Q, b, H, R, c, y, xp, xc, out,
                            scratch[warp]);
}

inline int blocks(int n) { return (n + kWarps - 1) / kWarps; }

inline int check_dims(int n, int dx, int dy) {
  if (n <= 0 || dx < 1 || dy < 1 || dx > kMaxD || dy > kMaxD) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

#define AUX_DEFINE_MAPS(SUFFIX, S)                                                            \
  extern "C" int aux_make_elements_##SUFFIX(int n, int dx, int dy, const S* F, const S* Q,    \
                                            const S* b, const S* H, const S* R, const S* c,   \
                                            const S* y, const S* m, const S* P, S* A, S* bel, \
                                            S* C, S* eta, S* J, long long* stamps,            \
                                            void* stream) {                                   \
    if (int e = check_dims(n, dx, dy)) return e;                                              \
    elements_kernel<S><<<n, kElemTeam, ElementsLay<kElemD>::size * sizeof(S),                 \
                         (cudaStream_t)stream>>>(dx, dy, ElementsIn<S>{F, Q, b, H, R, c, y, m, P}, \
                                                 ElementsOut<S>{A, bel, C, eta, J}, stamps);  \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  extern "C" int aux_ell_##SUFFIX(int n, int dx, int dy, const S* F, const S* Q, const S* b,  \
                                  const S* H, const S* R, const S* c, const S* y,             \
                                  const S* m, const S* P, S* ell, void* stream) {             \
    if (int e = check_dims(n, dx, dy)) return e;                                              \
    ell_kernel<S><<<blocks(n), kWarps * 32, 0, (cudaStream_t)stream>>>(                       \
        n, dx, dy, F, Q, b, H, R, c, y, m, P, ell);                                           \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  extern "C" int aux_backward_maps_##SUFFIX(int n, int dx, const S* F, const S* Q,            \
                                            const S* b, const S* m, const S* P,               \
                                            const S* eps, S* G, S* inc, void* stream) {       \
    if (int e = check_dims(n, dx, 1)) return e;                                               \
    backward_maps_kernel<S><<<blocks(n), kWarps * 32, 0, (cudaStream_t)stream>>>(            \
        n, dx, F, Q, b, m, P, eps, G, inc);                                                   \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  extern "C" int aux_logdensity_steps_##SUFFIX(int n, int dx, int dy, const S* F,             \
                                               const S* Q, const S* b, const S* H,            \
                                               const S* R, const S* c, const S* y,            \
                                               const S* xp, const S* xc, S* out,              \
                                               void* stream) {                                \
    if (int e = check_dims(n, dx, dy)) return e;                                              \
    logdensity_kernel<S><<<blocks(n), kWarps * 32, 0, (cudaStream_t)stream>>>(               \
        n, dx, dy, F, Q, b, H, R, c, y, xp, xc, out);                                         \
    return (int)cudaGetLastError();                                                           \
  }

AUX_DEFINE_MAPS(f32, float)
AUX_DEFINE_MAPS(f64, double)

extern "C" const char* aux_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
#endif  // __CUDACC__
