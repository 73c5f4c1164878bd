// Per-time-step Kalman maps of the auxiliary-Kalman MH step, one warp per
// step. They replace the Pallas kernels of aux_ssm_tpu/ops/pallas/kalman_fused.py:
//
//   elements_kernel      <- fused_make_elements    (_elements_kernel)
//   ell_kernel           <- fused_ell              (_ell_kernel)
//   backward_maps_kernel <- fused_backward_maps    (_backward_maps_kernel)
//   logdensity_kernel    <- fused_logdensity_steps (_logdensity_kernel)
//
// Each step reads a few (d, d) matrices and does O(d^3) flops on them: at the
// main path's T = 1024, d = 16 that is ~1 MB of input and ~60 MFLOP per
// launch, far below what the card moves or computes in a millisecond. What
// bounds a step is the latency of its dependent chain of small products, so
// the 32 lanes of a warp share each product (smallmat.cuh) on operands held
// in shared memory, and the 1023 steps give 1023 warps to spread over the
// SMs. A step with t >= n is skipped; nothing is padded.
//
// Missing observations follow ops/lgssm.mask_observation exactly: every
// masked quantity is selected with `isfinite(y)`, never multiplied by a 0/1
// mask, because the model's H, R, c may be NaN where y is missing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, no --use_fast_math
// (the masking needs isfinite/NaN semantics, the densities IEEE log/sqrt).
#include "smallmat.cuh"

namespace {

using namespace smallmat;

constexpr double kLog2Pi = 1.8378770664093453;

// Shared scratch of one warp, in elements of S: 10 matrices and 8 vectors.
template <int MD>
constexpr int map_scratch() { return 10 * MD * MD + 8 * MD; }

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

// SGF-2021 filtering element (A, b, C, eta, J) of step t.
template <typename S, int MD>
AUX_HD void elements_step(int lane, int nl, int t, int dx, int dy, const S* F_, const S* Q_,
                          const S* b_, const S* H_, const S* R_, const S* c_, const S* y_,
                          const S* m_, const S* P_, S* A_, S* bel_, S* C_, S* eta_, S* J_,
                          S* sm) {
  const S* F = F_ + (long)t * dx * dx;
  const S* b = b_ + (long)t * dx;
  S *He = sm, *Re = He + MD * MD, *P_pred = Re + MD * MD, *tmp = P_pred + MD * MD;
  S *Sm = tmp + MD * MD, *L = Sm + MD * MD, *SinvH = L + MD * MD, *K = SinvH + MD * MD;
  S *HF = K + MD * MD, *temp = HF + MD * MD;
  S *mk = temp + MD * MD, *ce = mk + MD, *ye = ce + MD, *m_pred = ye + MD;
  S *ydb = m_pred + MD, *ydm = ydb + MD, *v = ydm + MD;

  masked_obs(lane, nl, dx, dy, H_ + (long)t * dy * dx, R_ + (long)t * dy * dy,
             c_ + (long)t * dy, y_ + (long)t * dy, mk, He, Re, ce, ye);
  predict(lane, nl, dx, F, Q_ + (long)t * dx * dx, b, m_ + (long)t * dx,
          P_ + (long)t * dx * dx, m_pred, P_pred, tmp);
  innovation_cov(lane, nl, dx, dy, He, P_pred, Re, Sm, tmp);

  spd_solve(lane, nl, dy, dx, Sm, He, L, SinvH);  // (dy, dx) = S^{-1} He
  mm_nt(lane, nl, dx, dx, dy, P_pred, SinvH, K);  // (dx, dy) = P_pred SinvH^T
  mm(lane, nl, dy, dx, dx, He, F, HF);            // (dy, dx)

  S* A = A_ + (long)t * dx * dx;  // A = F - K HF
  mm(lane, nl, dx, dy, dx, K, HF, tmp);
  for (int e = lane; e < dx * dx; e += nl) A[e] = F[e] - tmp[e];
  AUX_SYNC();

  mv(lane, nl, dy, dx, He, b, ydb);
  masked_innov(lane, nl, dy, mk, ye, ce, ydb);
  mv(lane, nl, dy, dx, He, m_pred, ydm);
  masked_innov(lane, nl, dy, mk, ye, ce, ydm);

  S* bel = bel_ + (long)t * dx;  // b = m_pred + K ydm
  mv(lane, nl, dx, dy, K, ydm, v);
  for (int i = lane; i < dx; i += nl) bel[i] = m_pred[i] + v[i];
  AUX_SYNC();

  // C = sym(P_pred - K (S K^T)); L is free scratch from here on.
  mm_nt(lane, nl, dy, dy, dx, Sm, K, L);  // (dy, dx)
  mm(lane, nl, dx, dy, dx, K, L, tmp);
  for (int e = lane; e < dx * dx; e += nl) tmp[e] = P_pred[e] - tmp[e];
  AUX_SYNC();
  sym(lane, nl, dx, tmp);
  copy(lane, nl, dx * dx, tmp, C_ + (long)t * dx * dx);

  // temp = F^T SinvH^T (dx, dy); eta = temp ydb; J = sym(temp HF).
  for (int e = lane; e < dx * dy; e += nl) {
    const int i = e / dy, j = e % dy;
    S acc = (S)0;
    for (int k = 0; k < dx; ++k) acc += F[k * dx + i] * SinvH[j * dx + k];
    temp[e] = acc;
  }
  AUX_SYNC();
  mv(lane, nl, dx, dy, temp, ydb, eta_ + (long)t * dx);
  mm(lane, nl, dx, dy, dx, temp, HF, tmp);
  sym(lane, nl, dx, tmp);
  copy(lane, nl, dx * dx, tmp, J_ + (long)t * dx * dx);
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
constexpr int kWarps = 2;   // warps (time steps) per block
constexpr int kScratch = map_scratch<kMaxD>();

// Warp w of the block takes step t = blockIdx.x * kWarps + w, with its slice
// of the block's shared scratch.
#define AUX_STEP_PROLOGUE(S)                                        \
  __shared__ S scratch[kWarps][kScratch];                             \
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;       \
  const int t = blockIdx.x * kWarps + warp;                         \
  if (t >= n) return;

template <typename S>
__global__ void __launch_bounds__(kWarps * 32)
elements_kernel(int n, int dx, int dy, const S* F, const S* Q, const S* b, const S* H,
                const S* R, const S* c, const S* y, const S* m, const S* P, S* A, S* bel,
                S* C, S* eta, S* J) {
  AUX_STEP_PROLOGUE(S)
  elements_step<S, kMaxD>(lane, 32, t, dx, dy, F, Q, b, H, R, c, y, m, P, A, bel, C, eta, J,
                          scratch[warp]);
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
                                            S* C, S* eta, S* J, void* stream) {               \
    if (int e = check_dims(n, dx, dy)) return e;                                              \
    elements_kernel<S><<<blocks(n), kWarps * 32, 0, (cudaStream_t)stream>>>(                  \
        n, dx, dy, F, Q, b, H, R, c, y, m, P, A, bel, C, eta, J);                             \
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
