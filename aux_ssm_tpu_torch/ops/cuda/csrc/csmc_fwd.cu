// Factor-tensor cSMC sweeps of the sequential auxiliary particle Gibbs. They
// replace the Pallas kernels of aux_ssm_tpu/ops/pallas/csmc_fwd.py:
//
//   forward_factor_kernel  <- fused_forward_scan  (_fwd_kernel, and
//                             _fwd_kernel_chunked for 1024 < N <= 8192: one
//                             kernel serves every N up to 8192)
//   backward_factor_kernel <- fused_backward_scan (_bwd_kernel, _bwd_kernel_chunked)
//
// Semantics are those of the XLA oracles factor_scan_xla and
// backward_factor_scan_xla: weights carried normalised as exp(lw - max) / sum;
// anc[j] = #{i : cw[i] < u[j]} clamped to N-1; lane 0 pinned to 0 or, under
// PGAS, redrawn from log(max(w, 1e-37)) + rb + rf . cf[0]; the PGAS and
// backward thresholds taken against the unnormalised total u * cw[N-1].
//
// What bounds them: T-1 dependent steps, each a softmax, a prefix sum, N
// binary searches and N k-dot products over <= 8192 particles (at T=250,
// N=25, k=30 the inputs are ~1.5 MB in all). No step can start before the
// one before it ends, so the work is latency-bound: one thread block runs the
// whole time loop (the TPU's sequential grid becomes the in-block loop), the
// weights and their prefix sum live in shared memory (<= 8192 x 8 B each),
// and each step costs a handful of barriers. The TPU's (N, N) triangular-
// matmul cumsum, one-hot matmul gathers and 128-row chunk layout are not
// carried over: a thread finds its ancestor by binary search and reads the
// ancestor's factor row straight from global memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, no fast math.
#include "csmc_common.cuh"

namespace {

using namespace csmc;

// The forward sweep: T-1 = n steps over N particles, factors (n, N, k).
// Shared: w[N] (the carry, then the step's log weights), cw[N] (prefix sums),
// a0 (the PGAS draw for lane 0).
template <typename S, bool kPgas>
AUX_HD void forward_factor_sweep(const Block<S>& b, int n, int N, int k, const S* rf,
                                 const S* cf, const S* rb, const S* cb, const S* res_u,
                                 const S* anc_u, const S* w0, S* log_ws, long long* anc,
                                 S* w, S* cw, int* a0) {
  for (int j = b.tid; j < N; j += b.nt) w[j] = w0[j];
  AUX_BSYNC();
  for (int t = 0; t < n; ++t) {
    const long base = (long)t * N;
    const S* rf_t = rf + base * k;
    const S* cf_t = cf + base * k;
    const S* rb_t = rb + base;
    if (kPgas) {
      // Reference lane: categorical over log w + logpdf(x*_t | x_i); x*_t is
      // proposal slot 0, so its column factors are row 0 of cf.
      S m = neg_inf<S>();
      for (int i = b.tid; i < N; i += b.nt) {
        const S s = log(w[i] > (S)1e-37 ? w[i] : (S)1e-37) + rb_t[i] +
                    dot(rf_t + (long)i * k, cf_t, k);
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
      const S lw = cb[base + j] + rb_t[a] + dot(rf_t + (long)a * k, cf_t + (long)j * k, k);
      log_ws[base + j] = lw;
      anc[base + j] = a;
      w[j] = lw;
      m = fmax(m, lw);
    }
    block_softmax(b, w, N, m);
  }
}

// The backward (Whiteley) sweep, t = n-1 .. 0: score[i] = lw[t, i] + rb[t, i]
// + rf[t, i] . cf[t, b_next]; the index is the inverse CDF of exp(score - max)
// at us[t] * total. Shared: w[N], bsel (the chosen index, broadcast to the
// next (earlier) step).
template <typename S>
AUX_HD void backward_factor_sweep(const Block<S>& b, int n, int N, int k, const S* rf,
                                  const S* cf, const S* rb, const S* lw, const S* us,
                                  const long long* b_T, long long* picked, S* w, int* bsel) {
  if (b.tid == 0) *bsel = (int)*b_T;
  AUX_BSYNC();
  for (int t = n - 1; t >= 0; --t) {
    const long base = (long)t * N;
    const S* cf_sel = cf + (base + *bsel) * k;
    S m = neg_inf<S>();
    for (int i = b.tid; i < N; i += b.nt) {
      const S s = lw[base + i] + rb[base + i] + dot(rf + (base + i) * k, cf_sel, k);
      w[i] = s;
      m = fmax(m, s);
    }
    m = block_max(b, m);  // its barriers also fence every read of *bsel
    for (int i = b.tid; i < N; i += b.nt) w[i] = exp(w[i] - m);
    AUX_BSYNC();
    block_cumsum(b, w, w, N);
    if (b.tid == 0) {
      const int a = imin(count_less(w, N, us[t] * w[N - 1]), N - 1);
      *bsel = a;
      picked[t] = a;
    }
    AUX_BSYNC();
  }
}

}  // namespace

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// Launch section: everything above is plain C++ on pointers and also builds
// as host code (one thread, no barriers); what follows needs nvcc.
// ---------------------------------------------------------------------------
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 8192;  // the TPU kernels' cap (_LANE_MAX_N)

// Whole warps, one particle each, at most 1024 (host code: imin is device-only).
inline int threads_for(int N) {
  const int t = (N + 31) / 32 * 32;
  return t < 1024 ? t : 1024;
}

template <typename S, bool kPgas>
__global__ void __launch_bounds__(1024)
forward_factor_kernel(int n, int N, int k, const S* rf, const S* cf, const S* rb,
                      const S* cb, const S* res_u, const S* anc_u, const S* w0, S* log_ws,
                      long long* anc) {
  extern __shared__ unsigned char smem[];
  S* w = reinterpret_cast<S*>(smem);
  S* cw = w + N;
  S* red = cw + N;
  int* a0 = reinterpret_cast<int*>(red + 33);
  forward_factor_sweep<S, kPgas>(Block<S>{(int)threadIdx.x, (int)blockDim.x, red}, n, N, k,
                                 rf, cf, rb, cb, res_u, anc_u, w0, log_ws, anc, w, cw, a0);
}

template <typename S>
__global__ void __launch_bounds__(1024)
backward_factor_kernel(int n, int N, int k, const S* rf, const S* cf, const S* rb,
                       const S* lw, const S* us, const long long* b_T, long long* picked) {
  extern __shared__ unsigned char smem[];
  S* w = reinterpret_cast<S*>(smem);
  S* red = w + N;
  int* bsel = reinterpret_cast<int*>(red + 33);
  backward_factor_sweep<S>(Block<S>{(int)threadIdx.x, (int)blockDim.x, red}, n, N, k, rf,
                           cf, rb, lw, us, b_T, picked, w, bsel);
}

}  // namespace

#define AUX_DEFINE_CSMC_FACTOR(SUFFIX, S)                                                     \
  extern "C" int aux_csmc_forward_factor_##SUFFIX(                                            \
      int n, int N, int k, int pgas, const S* rf, const S* cf, const S* rb, const S* cb,      \
      const S* res_u, const S* anc_u, const S* w0, S* log_ws, long long* anc, void* stream) { \
    if (n <= 0 || N < 1 || N > kMaxN || k < 1) return (int)cudaErrorInvalidValue;             \
    const size_t shmem = (2 * (size_t)N + 33) * sizeof(S) + sizeof(int);                      \
    void* args[] = {&n, &N, &k, &rf, &cf, &rb, &cb, &res_u, &anc_u, &w0, &log_ws, &anc};      \
    auto kernel = pgas ? forward_factor_kernel<S, true> : forward_factor_kernel<S, false>;    \
    return launch_one_block(kernel, shmem, threads_for(N), (cudaStream_t)stream, args);       \
  }                                                                                           \
  extern "C" int aux_csmc_backward_factor_##SUFFIX(                                           \
      int n, int N, int k, const S* rf, const S* cf, const S* rb, const S* lw, const S* us,   \
      const long long* b_T, long long* picked, void* stream) {                                \
    if (n <= 0 || N < 1 || N > kMaxN || k < 1) return (int)cudaErrorInvalidValue;             \
    const size_t shmem = ((size_t)N + 33) * sizeof(S) + sizeof(int);                          \
    void* args[] = {&n, &N, &k, &rf, &cf, &rb, &lw, &us, &b_T, &picked};                      \
    return launch_one_block(backward_factor_kernel<S>, shmem, threads_for(N),                 \
                            (cudaStream_t)stream, args);                                      \
  }

AUX_DEFINE_CSMC_FACTOR(f32, float)
AUX_DEFINE_CSMC_FACTOR(f64, double)
#endif  // __CUDACC__
