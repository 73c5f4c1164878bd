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
// What bounds it: T-1 dependent steps, each a few microseconds of latency
// on one SM (spatial: T = 1024, d = 64, N = 25; SV: T = 250, d = 30, N = 25).
// One thread block runs the time loop and one warp owns a particle's step
// (warps stride over the particles past 32): its lanes own the state
// components. The model's constants, the carry and each warp's scratch
// (Model::scratch(d) words) live in shared memory, which is all that bounds
// d: a shape whose unstaged buffers do not fit is refused (block_lane_plan).
// The design cuts what sits on a step's critical path:
//  - staged (where it fits in shared memory with the rest: block_lane_staged):
//    the particle blocks of alternate steps are double-buffered in shared
//    memory, so a warp reads its ancestor's column there (xs is written to
//    global memory as output only, after the step); and step t+1's
//    operands (its eps block, parameter row, res_u row and x*_t) are copied
//    into shared memory with cp.async while step t runs. Otherwise (large N)
//    the particles stay in global memory: x_prev is the previous step's
//    output block, written by this block and visible after its barriers;
//  - N <= 32: one warp takes the carry's max, normalisation and prefix sums
//    with shuffles (warp_weights), and each warp finds its ancestor with one
//    ballot, so a step has two block barriers (operands and carry
//    published; weights and particles published). N > 32 keeps the block
//    collectives and the binary search of csmc_common.cuh.
// A chain axis is blockIdx.x offsetting every pointer but the constants':
// C independent chains' sweeps in one launch, a block a chain, their
// operands chain after chain (eps (C, n, d, N), res_u (C, n, N), x_star (C,
// n, d), x0 (C, d, N), w0 (C, N), rows (C, n, row); `BlockLaneIO::chain`).
// The model's constants are every chain's: each block reads them into its
// shared memory from the one copy. C = 1 is the one-chain call, bit for bit.
// The TPU's one-hot gather matmul and lane-broadcast (T-1, L, N) parameter
// blocks are not carried over: a warp reads its ancestor's column directly
// and the per-step parameters come as compact (T-1, row) arrays (row = 6 d
// + 2 for SV, 2 d + 7 for the spatial model).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, no fast math (the
// weight needs nan_to_num's NaN/inf semantics and IEEE exp/log).
#include "csmc_common.cuh"
#include "csmc_models.cuh"

namespace {

using namespace csmc;

// The sweep's shared buffers, carved from one array (sweep_words long).
// Staged: the particle blocks (d, N) of even and odd steps at x and x + d N;
// a step's operands [eps (d N) | row | res_u (N) | x_star (d)] at ops and
// ops + op_words (addressed by arithmetic, not by an array of two pointers,
// so that they stay registers that point into shared memory).
template <typename S>
struct SweepBuffers {
  S *w, *cw, *lw, *red, *scratch, *x, *ops;
};

// Words of a staged step's operands.
AUX_HHD long op_words(int N, int d, int row) { return (long)d * N + row + N + d; }

// Words of the sweep's buffers beside the constants.
template <class Model>
AUX_HHD long sweep_words(int N, int d, int nwarps, bool staged) {
  const long base = 3L * N + 33 + (long)nwarps * Model::scratch(d);
  return staged ? base + 2L * d * N + 2 * op_words(N, d, Model::row_width(d)) : base;
}

template <typename S, class Model>
AUX_HD SweepBuffers<S> carve(S* at, int N, int d, int nwarps, bool staged) {
  SweepBuffers<S> sb;
  sb.w = at;
  sb.cw = at + N;
  sb.lw = at + 2 * N;
  sb.red = at + 3 * N;
  sb.scratch = sb.red + 33;
  S* p = sb.scratch + (long)nwarps * Model::scratch(d);
  sb.x = staged ? p : nullptr;
  sb.ops = staged ? p + 2L * d * N : nullptr;
  return sb;
}

// Whether the staged sweep's shared memory (constants and buffers, `elem`
// bytes a word) fits in `limit` bytes.
template <class Model>
AUX_HHD bool block_lane_staged(int N, int d, int nconst, int nwarps, int elem, long limit) {
  return (nconst + sweep_words<Model>(N, d, nwarps, true)) * elem <= limit;
}

template <typename S, class Model, bool kStaged, bool kWarpWeights>
AUX_HD void block_lane_sweep(const Block<S>& b, int n, int N, int d, const S* eps,
                             const S* params, const S* res_u, const S* x_star, const S* x0,
                             const S* w0, const Model& model, S* xs, S* log_ws, long long* anc,
                             const SweepBuffers<S>& sb) {
  const int lane = b.tid % AUX_LANES, warp = b.tid / AUX_LANES, nwarps = b.nt / AUX_LANES;
  const int rw = Model::row_width(d);
  const long dN = (long)d * N, ow = op_words(N, d, rw);
  S* buf = sb.scratch + (long)warp * Model::scratch(d);
  auto stage = [&](int t) {  // step t's operands into buffer t & 1
    S* o = sb.ops + (t & 1) * ow;
    copy_async(o, eps + t * dN, (int)dN, b.tid, b.nt);
    copy_async(o + dN, params + (long)t * rw, rw, b.tid, b.nt);
    copy_async(o + dN + rw, res_u + (long)t * N, N, b.tid, b.nt);
    copy_async(o + dN + rw + N, x_star + (long)t * d, d, b.tid, b.nt);
  };
  if (kStaged) {
    copy_async(sb.x + dN, x0, (int)dN, b.tid, b.nt);
    stage(0);
  }
  if (kWarpWeights) {
    if (warp == 0) warp_weights(lane, AUX_LANES, false, w0, sb.w, sb.cw, N);
  } else {
    for (int j = b.tid; j < N; j += b.nt) sb.w[j] = w0[j];
  }
  for (int t = 0; t < n; ++t) {
    if (kStaged) async_wait();
    AUX_BSYNC();  // the step's operands, the carry and the previous particles are published
    if (kStaged && t + 1 < n) stage(t + 1);  // into the buffer step t - 1 read
    if (!kWarpWeights) block_cumsum(b, sb.w, sb.cw, N);
    const S* o = kStaged ? sb.ops + (t & 1) * ow : nullptr;
    const S* eps_t = kStaged ? o : eps + t * dN;
    const S* row = kStaged ? o + dN : params + (long)t * rw;
    const S* u_t = kStaged ? o + dN + rw : res_u + (long)t * N;
    const S* star_t = kStaged ? o + dN + rw + N : x_star + (long)t * d;
    const S* x_prev = kStaged ? sb.x + ((t + 1) & 1) * dN : t == 0 ? x0 : xs + (t - 1) * dN;
    S* x_out = kStaged ? sb.x + (t & 1) * dN : xs + t * dN;
    const typename Model::Step st = model.at(row);
    S m = neg_inf<S>();
    for (int j = warp; j < N; j += nwarps) {
      const int below = kWarpWeights ? warp_count_less(sb.cw, N, u_t[j], lane)
                                     : count_less(sb.cw, N, u_t[j]);
      const int a = j == 0 ? 0 : imin(below, N - 1);
      const S lw = model.step(st, j, a, lane, AUX_LANES, x_prev, eps_t, star_t, x_out, buf);
      if (lane == 0) {
        log_ws[(long)t * N + j] = lw;
        anc[(long)t * N + j] = a;
        (kWarpWeights ? sb.lw : sb.w)[j] = lw;
      }
      m = fmax(m, lw);
    }
    if (kWarpWeights) {
      AUX_BSYNC();  // every particle's weight, and the new particles, are published
      if (warp == 0) warp_weights(lane, AUX_LANES, true, sb.lw, sb.w, sb.cw, N);
    } else {
      block_softmax(b, sb.w, N, m);  // its barriers also publish the new particles
    }
    if (kStaged)
      for (long e = b.tid; e < dN; e += b.nt) xs[t * dN + e] = x_out[e];
  }
}

// A block-lane sweep's operands; `chain(c, n, N, d, row)` is chain c's
// slice of a chain-batched call's (n steps of N particles of width d, its
// per-step rows `row` wide; the constants shared).
template <typename S>
struct BlockLaneIO {
  const S *eps, *res_u, *x_star, *x0, *w0, *consts, *params;
  S *xs, *log_ws;
  long long* anc;

  AUX_HD BlockLaneIO chain(int c, int n, int N, int d, int row) const {
    const long nN = (long)n * N, ndN = nN * d, dN = (long)d * N;
    return BlockLaneIO{eps + c * ndN,     res_u + c * nN,   x_star + (long)c * n * d,
                       x0 + c * dN,       w0 + (long)c * N, consts,
                       params + (long)c * n * row,          xs + c * ndN,
                       log_ws + c * nN,   anc + c * nN};
  }
};

}  // namespace

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// Launch section: everything above is plain C++ on pointers and also builds
// as host code (one thread, no barriers); what follows needs nvcc.
// ---------------------------------------------------------------------------

namespace {

constexpr int kMaxBlockN = 1024;  // the TPU kernel's dense cap (_DENSE_MAX_N)

// Threads for N particles: a warp each, at most 32 warps.
inline int block_lane_threads(int N) { return N < 32 ? 32 * N : 1024; }

// Dynamic shared memory: the model's nconst constants, then the buffers.
// Block c runs chain c.
template <typename S, class Model, bool kStaged, bool kWarpWeights>
__global__ void __launch_bounds__(1024)
block_lane_kernel(int n, int N, int d, int nconst, const S* eps, const S* res_u,
                  const S* x_star, const S* x0, const S* w0, const S* consts, const S* params,
                  S* xs, S* log_ws, long long* anc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const auto io = BlockLaneIO<S>{eps, res_u, x_star, x0, w0, consts, params, xs, log_ws, anc}
                      .chain((int)blockIdx.x, n, N, d, Model::row_width(d));
  S* c = reinterpret_cast<S*>(smem);
  for (int i = threadIdx.x; i < nconst; i += blockDim.x) c[i] = io.consts[i];
  const SweepBuffers<S> sb = carve<S, Model>(c + nconst, N, d, blockDim.x / 32, kStaged);
  __syncthreads();
  const Model model(d, N, c);
  block_lane_sweep<S, Model, kStaged, kWarpWeights>(
      Block<S>{(int)threadIdx.x, (int)blockDim.x, sb.red}, n, N, d, io.eps, io.params,
      io.res_u, io.x_star, io.x0, io.w0, model, io.xs, io.log_ws, io.anc, sb);
}

// The launch plan of N particles of width d with nconst constants: the
// threads, whether the sweep is staged, its dynamic shared memory.
template <typename S, class Model>
int block_lane_plan(int N, int d, int nconst, int* threads, bool* staged, size_t* shmem) {
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  *threads = block_lane_threads(N);
  const int nwarps = *threads / 32;
  *staged = block_lane_staged<Model>(N, d, nconst, nwarps, sizeof(S), limit);
  *shmem = (nconst + sweep_words<Model>(N, d, nwarps, *staged)) * sizeof(S);
  // A state too wide for a block's shared memory even unstaged: no launch.
  return *shmem > (size_t)limit ? (int)cudaErrorInvalidValue : 0;
}

template <typename S, class Model>
auto block_lane_pick(bool staged, int N) {
  return !staged   ? block_lane_kernel<S, Model, false, false>
         : N <= 32 ? block_lane_kernel<S, Model, true, true>
                   : block_lane_kernel<S, Model, true, false>;
}

template <typename S, class Model>
int run_block_lane(int n, int C, int N, int d, int nconst, const S* eps, const S* res_u,
                   const S* x_star, const S* x0, const S* w0, const S* consts, const S* params,
                   S* xs, S* log_ws, long long* anc, cudaStream_t stream) {
  if (n <= 0 || C < 1 || N < 1 || N > kMaxBlockN || d < 1 || nconst < 1)
    return (int)cudaErrorInvalidValue;
  int threads = 0;
  bool staged = false;
  size_t shmem = 0;
  const int err = block_lane_plan<S, Model>(N, d, nconst, &threads, &staged, &shmem);
  if (err) return err;
  void* args[] = {&n, &N, &d, &nconst, &eps, &res_u, &x_star, &x0, &w0, &consts, &params,
                  &xs, &log_ws, &anc};
  return launch_blocks(block_lane_pick<S, Model>(staged, N), shmem, C, threads, stream, args);
}

// How many of the sweep's blocks (chains) one SM holds at once, by the
// occupancy calculator, for N particles of width d with nconst constants.
template <typename S, class Model>
int block_lane_blocks_per_sm(int N, int d, int nconst, int* out) {
  if (N < 1 || N > kMaxBlockN || d < 1 || nconst < 1)
    return (int)cudaErrorInvalidValue;
  int threads = 0;
  bool staged = false;
  size_t shmem = 0;
  int err = block_lane_plan<S, Model>(N, d, nconst, &threads, &staged, &shmem);
  if (err) return err;
  const auto kernel = block_lane_pick<S, Model>(staged, N);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, shmem);
  if (e != cudaSuccess) return (int)e;
  int host[2] = {blocks, (int)staged};
  return (int)cudaMemcpy(out, host, sizeof(host), cudaMemcpyHostToDevice);
}

}  // namespace

#define AUX_DEFINE_BLOCK_LANE(NAME, MODEL, SUFFIX, S)                                          \
  extern "C" int aux_csmc_block_lane_##NAME##_##SUFFIX(                                        \
      int n, int chains, int N, int d, int nconst, const S* eps, const S* res_u,               \
      const S* x_star, const S* x0, const S* w0, const S* consts, const S* params, S* xs,      \
      S* log_ws, long long* anc, void* stream) {                                               \
    return run_block_lane<S, MODEL<S>>(n, chains, N, d, nconst, eps, res_u, x_star, x0, w0,    \
                                       consts, params, xs, log_ws, anc, (cudaStream_t)stream); \
  }                                                                                            \
  extern "C" int aux_csmc_block_lane_occupancy_##NAME##_##SUFFIX(int N, int d, int nconst,     \
                                                                 int* out, void*) {            \
    return block_lane_blocks_per_sm<S, MODEL<S>>(N, d, nconst, out);                           \
  }

AUX_DEFINE_BLOCK_LANE(sv_guided, SvGuided, f32, float)
AUX_DEFINE_BLOCK_LANE(sv_guided, SvGuided, f64, double)
AUX_DEFINE_BLOCK_LANE(spatial_guided, SpatialGuided, f32, float)
AUX_DEFINE_BLOCK_LANE(spatial_guided, SpatialGuided, f64, double)
#endif  // __CUDACC__
