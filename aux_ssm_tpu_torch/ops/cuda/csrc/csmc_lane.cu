// Lane cSMC forward sweep: state-dependent proposals of scalar-state models
// with the model's step compiled into the kernel. It replaces
// aux_ssm_tpu/ops/pallas/csmc_fwd.py lane_forward_scan (_lane_fwd_kernel);
// the models are the lane functors of csmc_models.cuh (ThetaLogistic,
// RareEventGuided, RareEventBootstrap, Ar1Gauss).
//
// Semantics are those of the XLA oracle lane_scan_xla: per step, conditional
// multinomial resampling of the normalised carry (anc[j] = #{i : cw[i] <
// u[j]} clamped to N-1); lane 0 pinned to 0 or, under PGAS, redrawn from
// log(max(w, 1e-37)) + pgas_logpdf(x*_t, x_prev) at anc_u * total (strict <,
// clamped to N-1); the ancestors' states gathered and propagated with the
// step's noise; particle 0 pinned to x*_t; the model's log weight; and the
// carry exp(lw - max) / sum.
//
// What bounds it: T-1 dependent steps of O(N) cheap work (at T=256, N=256 the
// inputs and outputs are ~0.8 MB in all), so latency, not bytes or
// operations: a step is a prefix sum, N binary searches, N scalar model
// steps (one exp and a few logs each) and a softmax, every part behind a
// block barrier. One thread block runs the whole time loop, threads striding
// over the particles; the carried weights, their prefix sum and the previous
// step's particles live in shared memory (3 N values: 192 KB at N=8192 in
// f64), so an ancestor's state is one shared-memory read. A step's new
// particles go straight to the output and are read back into shared memory by
// the thread that wrote them, behind the softmax's first barrier and beside
// its exp. One kernel serves every N up to 8192: the TPU's dense/chunked
// split at N=1024, its (N, N) triangular-matmul cumsum and one-hot gather,
// its lane-broadcast (T-1, 1, N) parameter rows and its segmentation over T
// are not carried over; per-step parameters come as compact (T-1, kParams)
// rows that every thread reads. Nothing is shared between blocks: a chain
// axis would be blockIdx.x offsetting every pointer in the kernel below.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, no fast math (the
// model steps need IEEE exp and log).
#include "csmc_common.cuh"
#include "csmc_models.cuh"

namespace {

using namespace csmc;

// Shared: w[N] (the carry, then the step's log weights), cw[N] (prefix sums),
// xp[N] (the previous step's particles), a0 (the PGAS draw for lane 0).
template <typename S, bool kPgas, class Model>
AUX_HD void lane_sweep(const Block<S>& b, int n, int N, const S* eps, const S* res_u,
                       const S* anc_u, const S* x_star, const S* x0, const S* w0,
                       const Model& model, S* xs, S* log_ws, long long* anc, S* w, S* cw,
                       S* xp, int* a0) {
  for (int j = b.tid; j < N; j += b.nt) {
    w[j] = w0[j];
    xp[j] = x0[j];
  }
  AUX_BSYNC();
  for (int t = 0; t < n; ++t) {
    const long base = (long)t * N;
    const S xst = x_star[t];
    if (kPgas) {
      // Reference lane: categorical over log w + log p(x*_t | x_i).
      S m = neg_inf<S>();
      for (int i = b.tid; i < N; i += b.nt) {
        const S s = log(w[i] > (S)1e-37 ? w[i] : (S)1e-37) + model.pgas_logpdf(t, xst, xp[i]);
        cw[i] = s;
        m = fmax(m, s);
      }
      m = block_max(b, m);
      for (int i = b.tid; i < N; i += b.nt) cw[i] = exp(cw[i] - m);
      AUX_BSYNC();
      block_cumsum(b, cw, cw, N);
      if (b.tid == 0) *a0 = imin(count_less(cw, N, anc_u[t] * cw[N - 1]), N - 1);
      AUX_BSYNC();
    }
    block_cumsum(b, w, cw, N);
    // w is free from here: it takes the step's log weights.
    S m = neg_inf<S>();
    for (int j = b.tid; j < N; j += b.nt) {
      int a = imin(count_less(cw, N, res_u[base + j]), N - 1);
      if (j == 0) a = kPgas ? *a0 : 0;
      const S xr = xp[a];
      const S xt = j == 0 ? xst : model.propagate(t, eps[base + j], xr);
      const S lw = model.logw(t, xt, xr);
      xs[base + j] = xt;
      log_ws[base + j] = lw;
      anc[base + j] = a;
      w[j] = lw;
      m = fmax(m, lw);
    }
    m = block_max(b, m);  // its barriers end every read of xp and cw
    S part = 0;
    for (int j = b.tid; j < N; j += b.nt) {
      const S e = exp(w[j] - m);
      w[j] = e;
      part += e;
      xp[j] = xs[base + j];  // this thread's own store above
    }
    const S tot = block_sum(b, part);
    for (int j = b.tid; j < N; j += b.nt) w[j] = w[j] / tot;
    AUX_BSYNC();
  }
}

}  // namespace

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// Launch section: everything above is plain C++ on pointers and also builds
// as host code (one thread, no barriers); what follows needs nvcc.
// ---------------------------------------------------------------------------

namespace {

constexpr int kMaxLaneN = 8192;  // the TPU kernel's cap (_LANE_MAX_N)

// Whole warps, one particle each, at most 1024.
inline int lane_threads(int N) {
  const int t = (N + 31) / 32 * 32;
  return t < 1024 ? t : 1024;
}

template <typename S, bool kPgas, class Model>
__global__ void __launch_bounds__(1024)
lane_kernel(int n, int N, const S* eps, const S* res_u, const S* anc_u, const S* x_star,
            const S* x0, const S* w0, const S* consts, const S* params, S* xs, S* log_ws,
            long long* anc) {
  extern __shared__ unsigned char smem[];
  S* w = reinterpret_cast<S*>(smem);
  S* cw = w + N;
  S* xp = cw + N;
  S* red = xp + N;
  int* a0 = reinterpret_cast<int*>(red + 33);
  const Model model(consts, params);
  lane_sweep<S, kPgas>(Block<S>{(int)threadIdx.x, (int)blockDim.x, red}, n, N, eps, res_u,
                       anc_u, x_star, x0, w0, model, xs, log_ws, anc, w, cw, xp, a0);
}

template <typename S, class Model>
int launch_lane(int n, int N, int pgas, const S* eps, const S* res_u, const S* anc_u,
                const S* x_star, const S* x0, const S* w0, const S* consts, const S* params,
                S* xs, S* log_ws, long long* anc, void* stream) {
  if (n <= 0 || N < 1 || N > kMaxLaneN) return (int)cudaErrorInvalidValue;
  const size_t shmem = (3 * (size_t)N + 33) * sizeof(S) + sizeof(int);
  void* args[] = {&n, &N, &eps, &res_u, &anc_u, &x_star, &x0, &w0, &consts, &params, &xs,
                  &log_ws, &anc};
  auto kernel = pgas ? lane_kernel<S, true, Model> : lane_kernel<S, false, Model>;
  return launch_one_block(kernel, shmem, lane_threads(N), (cudaStream_t)stream, args);
}

}  // namespace

#define AUX_DEFINE_LANE(NAME, MODEL, SUFFIX, S)                                              \
  extern "C" int aux_csmc_lane_##NAME##_##SUFFIX(                                            \
      int n, int N, int pgas, const S* eps, const S* res_u, const S* anc_u, const S* x_star, \
      const S* x0, const S* w0, const S* consts, const S* params, S* xs, S* log_ws,          \
      long long* anc, void* stream) {                                                        \
    return launch_lane<S, MODEL<S>>(n, N, pgas, eps, res_u, anc_u, x_star, x0, w0, consts,   \
                                    params, xs, log_ws, anc, stream);                        \
  }

AUX_DEFINE_LANE(theta_logistic, ThetaLogistic, f32, float)
AUX_DEFINE_LANE(theta_logistic, ThetaLogistic, f64, double)
AUX_DEFINE_LANE(rare_event_guided, RareEventGuided, f32, float)
AUX_DEFINE_LANE(rare_event_guided, RareEventGuided, f64, double)
AUX_DEFINE_LANE(rare_event_bootstrap, RareEventBootstrap, f32, float)
AUX_DEFINE_LANE(rare_event_bootstrap, RareEventBootstrap, f64, double)
AUX_DEFINE_LANE(ar1_gauss, Ar1Gauss, f32, float)
AUX_DEFINE_LANE(ar1_gauss, Ar1Gauss, f64, double)
#endif  // __CUDACC__
