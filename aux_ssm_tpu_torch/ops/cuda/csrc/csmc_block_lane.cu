// Block-lane cSMC forward sweep: state-dependent proposals of small-d models
// with the model's step compiled into the kernel. It replaces
// aux_ssm_tpu/ops/pallas/csmc_fwd.py block_lane_forward_scan
// (_block_lane_fwd_kernel). The model is a template parameter: one entry
// point for each block-lane functor of csmc_models.cuh (SvGuided, the SV
// guided proposal; SpatialGuided, the spatial Student-t guided proposal).
//
// Semantics are those of the XLA oracle block_lane_scan_xla: conditional
// multinomial resampling of the normalised carry (anc[j] = #{i : cw[i] <
// u[j]} clamped to N-1, lane 0 pinned to 0, no PGAS), the ancestors' columns
// propagated by the model with the step's noise, particle 0 pinned to x*_t,
// the model's log weight, and the carry exp(lw - max) / sum.
//
// What bounds it: T-1 dependent steps; at the published SV width (d=30,
// N=25) a step is three d x d mat-vecs per particle (~2.7k FMA) plus the
// resampling collectives. One thread block runs the time loop and one warp
// owns a particle's step (warps stride over the particles past 32): its
// lanes own the state components, so a step costs ~3d dependent FMAs a lane
// and a few warp and block barriers. (A first version with one thread per
// particle spent ~53 us a step in that thread's 3 d^2 dependent FMAs.) The
// model's constants (SV: 3 d x d matrices, 2 d-vectors; spatial: the d x d
// precision), the weights and each warp's kScratch d-vectors of scratch live
// in dynamic shared memory (SV 62 KB at d=30, N=1024 in f64; spatial 42 KB
// at d=64, N=25 in f32, where a lane owns components l and l + 32 and a step
// is one or two 64-long dots for each); the particle blocks stay in global
// memory: x_prev is the previous step's output block (written by this block, visible after its
// barrier, L2-resident at 120 KB for d=30, N=1024 f32). The TPU's one-hot
// gather matmul and lane-broadcast (T-1, L, N) parameter blocks are not
// carried over: a warp reads its ancestor's column directly and the per-step
// parameters come as compact (T-1, row) arrays (row = 6 d + 2 for SV, 2 d + 1
// for the spatial model).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, no fast math (the
// weight needs nan_to_num's NaN/inf semantics and IEEE exp/log).
#include "csmc_common.cuh"
#include "csmc_models.cuh"

namespace {

using namespace csmc;

// scratch: Model::kScratch * d entries for each warp of the block.
template <typename S, class Model>
AUX_HD void block_lane_sweep(const Block<S>& b, int n, int N, int d, const S* eps,
                             const S* res_u, const S* x_star, const S* x0, const S* w0,
                             const Model& model, S* xs, S* log_ws, long long* anc, S* w,
                             S* cw, S* scratch) {
  const int lane = b.tid % AUX_LANES, warp = b.tid / AUX_LANES, nwarps = b.nt / AUX_LANES;
  S* buf = scratch + (long)warp * Model::kScratch * d;
  for (int j = b.tid; j < N; j += b.nt) w[j] = w0[j];
  AUX_BSYNC();
  for (int t = 0; t < n; ++t) {
    const long base = (long)t * N, blk = (long)t * d * N;
    const S* x_prev = t == 0 ? x0 : xs + blk - (long)d * N;
    block_cumsum(b, w, cw, N);
    S m = neg_inf<S>();
    for (int j = warp; j < N; j += nwarps) {
      const int a = j == 0 ? 0 : imin(count_less(cw, N, res_u[base + j]), N - 1);
      const S lw = model.step(t, j, a, lane, AUX_LANES, x_prev, eps + blk,
                              x_star + (long)t * d, xs + blk, buf);
      if (lane == 0) {
        log_ws[base + j] = lw;
        anc[base + j] = a;
        w[j] = lw;
      }
      m = fmax(m, lw);
    }
    block_softmax(b, w, N, m);  // its barriers also publish xs[t] and w to every thread
  }
}

}  // namespace

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// Launch section: everything above is plain C++ on pointers and also builds
// as host code (one thread, no barriers); what follows needs nvcc.
// ---------------------------------------------------------------------------

namespace {

constexpr int kMaxBlockN = 1024;  // the TPU kernel's dense cap (_DENSE_MAX_N)
constexpr int kMaxBlockD = 64;    // a lane owns components lane, lane + 32

// Threads for N particles: a warp each, at most 32 warps.
inline int block_lane_threads(int N) { return N < 32 ? 32 * N : 1024; }

// Dynamic shared memory: the model's constants, w and cw (N each), 33
// reduction partials, the warps' scratch.
template <typename S, class Model>
size_t block_lane_shmem(int N, int d) {
  const size_t warps = block_lane_threads(N) / 32;
  const size_t consts = Model::kConstMats * (size_t)d * d + Model::kConstVecs * d +
                        Model::kConstScalars;
  return (consts + 2 * (size_t)N + 33 + warps * Model::kScratch * d) * sizeof(S);
}

template <typename S, class Model>
__global__ void __launch_bounds__(1024)
block_lane_kernel(int n, int N, int d, const S* eps, const S* res_u, const S* x_star,
                  const S* x0, const S* w0, const S* consts, const S* params, S* xs,
                  S* log_ws, long long* anc) {
  extern __shared__ unsigned char smem[];
  const int nc = Model::kConstMats * d * d + Model::kConstVecs * d + Model::kConstScalars;
  S* c = reinterpret_cast<S*>(smem);
  S* w = c + nc;
  S* cw = w + N;
  S* red = cw + N;
  S* scratch = red + 33;
  for (int i = threadIdx.x; i < nc; i += blockDim.x) c[i] = consts[i];
  __syncthreads();
  const Model model(d, N, c, params);
  block_lane_sweep<S>(Block<S>{(int)threadIdx.x, (int)blockDim.x, red}, n, N, d, eps, res_u,
                      x_star, x0, w0, model, xs, log_ws, anc, w, cw, scratch);
}

}  // namespace

#define AUX_DEFINE_BLOCK_LANE(NAME, MODEL, SUFFIX, S)                                       \
  extern "C" int aux_csmc_block_lane_##NAME##_##SUFFIX(                                     \
      int n, int N, int d, const S* eps, const S* res_u, const S* x_star, const S* x0,      \
      const S* w0, const S* consts, const S* params, S* xs, S* log_ws, long long* anc,      \
      void* stream) {                                                                       \
    if (n <= 0 || N < 1 || N > kMaxBlockN || d < 1 || d > kMaxBlockD)                       \
      return (int)cudaErrorInvalidValue;                                                    \
    void* args[] = {&n, &N, &d, &eps, &res_u, &x_star, &x0, &w0, &consts, &params, &xs,    \
                    &log_ws, &anc};                                                         \
    return launch_one_block(block_lane_kernel<S, MODEL<S>>,                                 \
                            block_lane_shmem<S, MODEL<S>>(N, d), block_lane_threads(N),     \
                            (cudaStream_t)stream, args);                                    \
  }

AUX_DEFINE_BLOCK_LANE(sv_guided, SvGuided, f32, float)
AUX_DEFINE_BLOCK_LANE(sv_guided, SvGuided, f64, double)
AUX_DEFINE_BLOCK_LANE(spatial_guided, SpatialGuided, f32, float)
AUX_DEFINE_BLOCK_LANE(spatial_guided, SpatialGuided, f64, double)
#endif  // __CUDACC__
