// Factor-tensor cSMC sweeps of the sequential auxiliary particle Gibbs. They
// replace the Pallas kernels of aux_ssm_tpu/ops/pallas/csmc_fwd.py:
//
//   fused_forward_scan (_fwd_kernel, _fwd_kernel_chunked): N <= 32
//     factor_pair_scores_kernel then forward_factor_warp_kernel; N <= 8192
//     forward_factor_kernel
//   fused_backward_scan (_bwd_kernel, _bwd_kernel_chunked): N <= 32
//     factor_pair_scores_kernel then backward_factor_warp_kernel; N <= 8192
//     backward_factor_kernel
//
// Semantics are those of the XLA oracles factor_scan_xla and
// backward_factor_scan_xla: weights carried normalised as exp(lw - max) / sum;
// anc[j] = #{i : cw[i] < u[j]} clamped to N-1; lane 0 pinned to 0 or, under
// PGAS, redrawn from log(max(w, 1e-37)) + rb + rf . cf[0]; the PGAS and
// backward thresholds taken against the unnormalised total u * cw[N-1].
//
// What bounds them: T-1 dependent steps, each a softmax, a prefix sum, N
// inverse-CDF counts and N k-dot products (at T=1024, N=25, k=64 the inputs
// are ~14 MB in all). No step can start before the one before it ends, so
// the time is the length of a step's dependent chain. Two paths:
//  - N <= kWarpN (32), the models' particle counts: nothing on the chain
//    reads global memory, and no barrier is on it. The pair scores
//    rf[t, i] . cf[t, j] do not depend on the ancestors, so a first kernel
//    computes them for every step at once (a block a step, a thread a
//    pair) and packs each step's record: its scores, then its rows of the
//    other operands. The sweep then runs on one warp, a lane a particle,
//    its carry in registers and its collectives shuffles, a redux and
//    ballots. The copy engine stages the records, four steps a bulk copy,
//    three copies ahead of the step that reads them (the TPU kernel's
//    double-buffered BlockSpec((1, N, k)) operands), so the chain only
//    gathers in shared memory. A score row has kWarpN columns, so lane j
//    reads bank j: the forward sweep gathers S[a_j][j] (a row an ancestor),
//    the backward sweep S[b][i] (a row a next index: its scores are
//    computed with the factors' roles swapped).
//  - N > 32 up to 8192: one thread block runs the time loop, the weights
//    and their prefix sums in shared memory, a few barriers a step; a
//    thread finds its ancestor by binary search and reads the ancestor's
//    factor row straight from global memory.
// The TPU's (N, N) triangular-matmul cumsum, one-hot matmul gathers and
// 128-row chunk layout are not carried over.
//
// Chain axis: C independent chains' sweeps in one launch, a block a chain
// (blockIdx.x), their operands chain after chain (rf (C, n, N, k), b_T (C),
// ...), every pointer offset by its chain's extent (`*_chain` below). The
// pair-score pass carries nothing between steps, so the chains fold into
// its step axis: C n blocks, the records chain after chain. C = 1 is the
// one-chain call, bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, no fast math.
#include "csmc_common.cuh"

namespace {

using namespace csmc;

// ---------------------------------------------------------------------------
// N > 32: the block path.
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// N <= kWarpN: the pair scores, then the sweep on one warp.
// ---------------------------------------------------------------------------

constexpr int kPairChunk = 64;            // factor columns the pair-score pass stages at a time
constexpr int kChunk = 4;                 // steps one bulk copy stages
constexpr int kStages = 4;                // chunks in a one-warp sweep's ring
static_assert((kStages & (kStages - 1)) == 0, "a power of two");
#ifdef __CUDACC__
constexpr int kCellsPer = 1;  // a thread a cell: the launch gives N kWarpN threads
#else
constexpr int kCellsPer = kWarpN * kWarpN;  // the host build's one thread takes every cell
#endif

// Words of a step's record: the scores (N kWarpN), `vectors` (n, N) rows and
// one scalar, rounded up to 16 bytes (the forward sweep: rb, cb, res_u and
// anc_u; the backward sweep: lw, rb and us).
AUX_HHD long record_words(int N, int vectors, int elem) {
  const long q = 16 / elem, w = (long)N * kWarpN + (long)vectors * N + 1;
  return (w + q - 1) / q * q;
}

// Step t's record, at records + t ow (ow = record_words(N, nv)): the pair
// scores rec[r kWarpN + c] = A[t, r] . B[t, c] for r, c < N, the products
// summed over the k factor columns in the order `dot` sums them (so each
// score is the block path's), and 0 in the columns N <= c < kWarpN that pad
// a row; then the step's rows of the nv (n, N) vectors v0, v1[, v2] and its
// entry of the (n,) scalar s; 0 in the words that pad it to 16 bytes.
// Thread tid of nt owns cells tid, tid + nt, ...; the factors are staged
// kPairChunk columns at a time in `tile` (2 N (kPairChunk + 1) words, a row
// padded by one word so that a warp's rows fall in distinct banks).
template <typename S>
AUX_HD void pair_record(int tid, int nt, int t, int N, int k, int nv, const S* A, const S* B,
                        const S* v0, const S* v1, const S* v2, const S* s, S* records,
                        S* tile) {
  constexpr int ts = kPairChunk + 1;
  const S* a = A + (long)t * N * k;
  const S* b = B + (long)t * N * k;
  S acc[kCellsPer];
  for (int q = 0; q < kCellsPer; ++q) acc[q] = 0;
  for (int k0 = 0; k0 < k; k0 += kPairChunk) {
    const int kc = imin(kPairChunk, k - k0);
    AUX_BSYNC();  // every thread has read the tile's previous columns
    for (int e = tid; e < N * kc; e += nt) {
      const int r = e / kc, c = e - r * kc;
      tile[r * ts + c] = a[(long)r * k + k0 + c];
      tile[(N + r) * ts + c] = b[(long)r * k + k0 + c];
    }
    AUX_BSYNC();
    for (int q = 0; q < kCellsPer; ++q) {
      const int e = tid + q * nt, r = e / kWarpN, c = e - r * kWarpN;
      if (r < N && c < N) {
        const S* x = tile + r * ts;
        const S* y = tile + (N + c) * ts;
        for (int i = 0; i < kc; ++i) acc[q] += x[i] * y[i];
      }
    }
  }
  const int sw = N * kWarpN, ow = (int)record_words(N, nv, sizeof(S));
  S* rec = records + (long)t * ow;
  for (int q = 0; q < kCellsPer; ++q) {
    const int e = tid + q * nt;
    if (e < sw) rec[e] = acc[q];
  }
  for (int e = sw + tid; e < ow; e += nt) {
    const int x = e - sw, i = x / N, j = x - i * N;  // vector i (i == nv: the scalar), entry j
    const S* v = i == 0 ? v0 : i == 1 ? v1 : v2;
    rec[e] = i < nv ? v[(long)t * N + j] : i == nv && j == 0 ? s[t] : (S)0;
  }
}

// The ring of staged records of a one-warp sweep: kStages slots of kChunk
// records (ow words each) in shared memory, each with its barrier. The
// sweep visits the chunks of its n steps (chunk c: steps c kChunk ... c
// kChunk + kChunk - 1) in order, or in reverse; visit v reads slot v %
// kStages, which lane 0 filled with one bulk copy kStages - 1 visits
// before, once the barrier's phase v / kStages has completed.
template <typename S>
struct Ring {
  S* buf;
  unsigned long long* bars;
  int ow, n;
  bool reverse;

  AUX_HD int chunks() const { return (n + kChunk - 1) / kChunk; }
  AUX_HD S* slot(int v) const { return buf + (v & (kStages - 1)) * kChunk * ow; }
  // Lane 0 stages visit v's chunk (nothing past the last visit).
  AUX_HD void fill(int v, const S* records, int lane) const {
    if (lane == 0 && v < chunks()) {
      const int t0 = (reverse ? chunks() - 1 - v : v) * kChunk;
      copy_bulk(slot(v), records + (long)t0 * ow, imin(kChunk, n - t0) * ow,
                bars + (v & (kStages - 1)));
    }
  }
  // The barriers, then the first kStages - 1 visits' copies.
  AUX_HD void start(const S* records, int lane) const {
    if (lane == 0) bars_init(bars, kStages);
    AUX_WSYNC();
    for (int v = 0; v < kStages - 1; ++v) fill(v, records, lane);
  }
  // Step t's record. The visit's first step waits for its copy, then stages
  // the visit kStages - 1 ahead into the slot the visit before it read.
  AUX_HD const S* record(int t, const S* records, int lane) const {
    const int c = t / kChunk, v = reverse ? chunks() - 1 - c : c;
    if (reverse ? t == n - 1 || t % kChunk == kChunk - 1 : t % kChunk == 0) {
      bar_wait(bars + (v & (kStages - 1)), (v / kStages) & 1);
      AUX_WSYNC();  // every lane has read the slot of visit v - 1
      fill(v + kStages - 1, records, lane);
    }
    return slot(v) + (t - c * kChunk) * ow;
  }
};

// The forward sweep on one warp (lane `lane`), N <= kWarpN: `records` the
// pair-score pass's on (rf, cf) with the vectors (rb, cb, res_u) and the
// scalar anc_u, so row a of a step's scores holds rf[t, a] . cf[t, j] for
// every j. The carry w (normalised) and its prefix sums cw are registers:
// w = e r and cw = cumsum(e) r, with r = 1 / tot, tot the scan's last entry
// (as warp_weights, but one reciprocal: a division is slow where e is 0 or
// tiny, as it often is); cw is +inf past N.
template <typename S, bool kPgas>
AUX_HD void forward_warp_sweep(int lane, int n, int N, const S* records, const S* w0,
                               S* log_ws, long long* anc, const Ring<S>& ring) {
  const int sw = N * kWarpN;
  ring.start(records, lane);
  S w[kPer], cw[kPer];
  for (int q = 0; q < kPer; ++q) {
    const int j = lane * kPer + q;
    w[q] = cw[q] = j < N ? w0[j] : (S)0;
  }
  lane_cumsum(cw, lane);
  for (int q = 0; q < kPer; ++q)
    if (lane * kPer + q >= N) cw[q] = -neg_inf<S>();
  for (int t = 0; t < n; ++t) {
    const S* sc = ring.record(t, records, lane);
    const S *rb_t = sc + sw, *cb_t = rb_t + N, *u_t = cb_t + N;
    int a0 = 0;
    if (kPgas) {
      // Lane 0's ancestor: categorical over log w + logpdf(x*_t | x_i); x*_t
      // is proposal slot 0, so its scores are column 0.
      S c[kPer], m = neg_inf<S>();
      for (int q = 0; q < kPer; ++q) {
        const int i = lane * kPer + q;
        c[q] = i < N ? log(w[q] > (S)1e-37 ? w[q] : (S)1e-37) + rb_t[i] + sc[i * kWarpN]
                     : neg_inf<S>();
        m = fmax(m, c[q]);
      }
      m = lanes_max(m);
      for (int q = 0; q < kPer; ++q) c[q] = exp(c[q] - m);
      lane_cumsum(c, lane);
      const S v = u_t[N] * lane_value(c, N - 1);
      int below = 0;
      for (int q = 0; q < kPer; ++q) below += lane * kPer + q < N && c[q] < v;
      a0 = imin(lanes_count(below), N - 1);
    }
    S m = neg_inf<S>();
    for (int q = 0; q < kPer; ++q) {
      const int j = lane * kPer + q;
      const int below = lanes_below(cw, j < N ? u_t[j] : (S)0);
      S l = neg_inf<S>();
      if (j < N) {
        const int a = j == 0 ? a0 : imin(below, N - 1);
        l = cb_t[j] + rb_t[a] + sc[a * kWarpN + j];
        log_ws[(long)t * N + j] = l;
        anc[(long)t * N + j] = a;
      }
      w[q] = l;
      m = fmax(m, l);
    }
    m = lanes_max(m);
    for (int q = 0; q < kPer; ++q) cw[q] = w[q] = exp(w[q] - m);
    const S r = (S)1 / warp_last(lane_cumsum(cw, lane));
    for (int q = 0; q < kPer; ++q) {
      w[q] *= r;
      cw[q] = lane * kPer + q < N ? cw[q] * r : -neg_inf<S>();
    }
  }
}

// The backward sweep on one warp, N <= kWarpN, t = n-1 .. 0 (its ring
// reversed): `records` the pair-score pass's on (cf, rf) with the vectors
// (lw, rb) and the scalar us, so row b of a step's scores holds rf[t, i] .
// cf[t, b] for every i.
template <typename S>
AUX_HD void backward_warp_sweep(int lane, int n, int N, const S* records, const long long* b_T,
                                long long* picked, const Ring<S>& ring) {
  const int sw = N * kWarpN;
  ring.start(records, lane);
  int b = (int)*b_T;
  for (int t = n - 1; t >= 0; --t) {
    const S* sc = ring.record(t, records, lane);
    const S *lw_t = sc + sw, *rb_t = lw_t + N;
    S c[kPer], m = neg_inf<S>();
    for (int q = 0; q < kPer; ++q) {
      const int j = lane * kPer + q;
      c[q] = j < N ? lw_t[j] + rb_t[j] + sc[b * kWarpN + j] : neg_inf<S>();
      m = fmax(m, c[q]);
    }
    m = lanes_max(m);
    for (int q = 0; q < kPer; ++q) c[q] = exp(c[q] - m);
    lane_cumsum(c, lane);
    const S v = rb_t[N] * lane_value(c, N - 1);
    int below = 0;
    for (int q = 0; q < kPer; ++q) below += lane * kPer + q < N && c[q] < v;
    b = imin(lanes_count(below), N - 1);
    if (lane == 0) picked[t] = b;
  }
}

// Chain c of a chain-batched call: each sweep on its chain's slice of every
// operand (n steps of N particles, k factor columns, its records).
template <typename S, bool kPgas>
AUX_HD void forward_factor_chain(const Block<S>& b, int c, int n, int N, int k, const S* rf,
                                 const S* cf, const S* rb, const S* cb, const S* res_u,
                                 const S* anc_u, const S* w0, S* log_ws, long long* anc,
                                 S* w, S* cw, int* a0) {
  const long nN = (long)n * N, nNk = nN * k;
  forward_factor_sweep<S, kPgas>(b, n, N, k, rf + c * nNk, cf + c * nNk, rb + c * nN,
                                 cb + c * nN, res_u + c * nN, anc_u + (long)c * n,
                                 w0 + (long)c * N, log_ws + c * nN, anc + c * nN, w, cw, a0);
}

template <typename S>
AUX_HD void backward_factor_chain(const Block<S>& b, int c, int n, int N, int k, const S* rf,
                                  const S* cf, const S* rb, const S* lw, const S* us,
                                  const long long* b_T, long long* picked, S* w, int* bsel) {
  const long nN = (long)n * N, nNk = nN * k;
  backward_factor_sweep<S>(b, n, N, k, rf + c * nNk, cf + c * nNk, rb + c * nN, lw + c * nN,
                           us + (long)c * n, b_T + c, picked + (long)c * n, w, bsel);
}

template <typename S, bool kPgas>
AUX_HD void forward_warp_chain(int c, int lane, int n, int N, const S* records, const S* w0,
                               S* log_ws, long long* anc, const Ring<S>& ring) {
  const long nN = (long)n * N;
  const long ow = record_words(N, 3, sizeof(S));
  forward_warp_sweep<S, kPgas>(lane, n, N, records + (long)c * n * ow, w0 + (long)c * N,
                               log_ws + c * nN, anc + c * nN, ring);
}

template <typename S>
AUX_HD void backward_warp_chain(int c, int lane, int n, int N, const S* records,
                                const long long* b_T, long long* picked, const Ring<S>& ring) {
  const long ow = record_words(N, 2, sizeof(S));
  backward_warp_sweep<S>(lane, n, N, records + (long)c * n * ow, b_T + c, picked + (long)c * n,
                         ring);
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
  forward_factor_chain<S, kPgas>(Block<S>{(int)threadIdx.x, (int)blockDim.x, red},
                                 (int)blockIdx.x, n, N, k, rf, cf, rb, cb, res_u, anc_u, w0,
                                 log_ws, anc, w, cw, a0);
}

template <typename S>
__global__ void __launch_bounds__(1024)
backward_factor_kernel(int n, int N, int k, const S* rf, const S* cf, const S* rb,
                       const S* lw, const S* us, const long long* b_T, long long* picked) {
  extern __shared__ unsigned char smem[];
  S* w = reinterpret_cast<S*>(smem);
  S* red = w + N;
  int* bsel = reinterpret_cast<int*>(red + 33);
  backward_factor_chain<S>(Block<S>{(int)threadIdx.x, (int)blockDim.x, red}, (int)blockIdx.x,
                           n, N, k, rf, cf, rb, lw, us, b_T, picked, w, bsel);
}

// A block a step, a thread a cell of the step's N x kWarpN scores.
template <typename S>
__global__ void __launch_bounds__(kWarpN * kWarpN)
factor_pair_scores_kernel(int N, int k, int nv, const S* A, const S* B, const S* v0,
                          const S* v1, const S* v2, const S* s, S* records) {
  __shared__ S tile[2 * kWarpN * (kPairChunk + 1)];
  pair_record<S>((int)threadIdx.x, (int)blockDim.x, (int)blockIdx.x, N, k, nv, A, B, v0, v1,
                 v2, s, records, tile);
}

// Dynamic shared memory of a one-warp sweep: kStages barriers, then the
// ring's kStages slots of kChunk records of ow words (16-byte aligned).
template <typename S>
__device__ Ring<S> carve_ring(unsigned char* smem, int ow, int n, bool reverse) {
  auto* bars = reinterpret_cast<unsigned long long*>(smem);
  return Ring<S>{reinterpret_cast<S*>(bars + kStages), bars, ow, n, reverse};
}

inline size_t ring_bytes(int ow, size_t elem) {
  return kStages * sizeof(unsigned long long) + (size_t)kStages * kChunk * ow * elem;
}

template <typename S, bool kPgas>
__global__ void __launch_bounds__(32)
forward_factor_warp_kernel(int n, int N, const S* records, const S* w0, S* log_ws,
                           long long* anc) {
  extern __shared__ __align__(16) unsigned char smem[];
  forward_warp_chain<S, kPgas>((int)blockIdx.x, (int)threadIdx.x, n, N, records, w0, log_ws,
                               anc,
                               carve_ring<S>(smem, (int)record_words(N, 3, sizeof(S)), n, false));
}

template <typename S>
__global__ void __launch_bounds__(32)
backward_factor_warp_kernel(int n, int N, const S* records, const long long* b_T,
                            long long* picked) {
  extern __shared__ __align__(16) unsigned char smem[];
  backward_warp_chain<S>((int)blockIdx.x, (int)threadIdx.x, n, N, records, b_T, picked,
                         carve_ring<S>(smem, (int)record_words(N, 2, sizeof(S)), n, true));
}

}  // namespace

#define AUX_DEFINE_CSMC_FACTOR(SUFFIX, S)                                                     \
  extern "C" int aux_csmc_forward_factor_##SUFFIX(                                            \
      int C, int n, int N, int k, int pgas, const S* rf, const S* cf, const S* rb,            \
      const S* cb, const S* res_u, const S* anc_u, const S* w0, S* log_ws, long long* anc,    \
      void* stream) {                                                                         \
    if (C < 1 || n <= 0 || N < 1 || N > kMaxN || k < 1) return (int)cudaErrorInvalidValue;    \
    const size_t shmem = (2 * (size_t)N + 33) * sizeof(S) + sizeof(int);                      \
    void* args[] = {&n, &N, &k, &rf, &cf, &rb, &cb, &res_u, &anc_u, &w0, &log_ws, &anc};      \
    auto kernel = pgas ? forward_factor_kernel<S, true> : forward_factor_kernel<S, false>;    \
    return launch_blocks(kernel, shmem, C, threads_for(N), (cudaStream_t)stream, args);       \
  }                                                                                           \
  extern "C" int aux_csmc_backward_factor_##SUFFIX(                                           \
      int C, int n, int N, int k, const S* rf, const S* cf, const S* rb, const S* lw,         \
      const S* us, const long long* b_T, long long* picked, void* stream) {                   \
    if (C < 1 || n <= 0 || N < 1 || N > kMaxN || k < 1) return (int)cudaErrorInvalidValue;    \
    const size_t shmem = ((size_t)N + 33) * sizeof(S) + sizeof(int);                          \
    void* args[] = {&n, &N, &k, &rf, &cf, &rb, &lw, &us, &b_T, &picked};                      \
    return launch_blocks(backward_factor_kernel<S>, shmem, C, threads_for(N),                 \
                         (cudaStream_t)stream, args);                                         \
  }                                                                                           \
  extern "C" int aux_csmc_pair_scores_##SUFFIX(int n, int N, int k, int nv, const S* A,      \
                                               const S* B, const S* v0, const S* v1,          \
                                               const S* v2, const S* s, S* records,           \
                                               void* stream) {                                \
    if (n <= 0 || N < 1 || N > kWarpN || k < 1 || nv < 2 || nv > 3)                          \
      return (int)cudaErrorInvalidValue;                                                      \
    factor_pair_scores_kernel<S><<<n, N * kWarpN, 0, (cudaStream_t)stream>>>(                 \
        N, k, nv, A, B, v0, v1, v2, s, records);                                              \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  extern "C" int aux_csmc_forward_factor_warp_##SUFFIX(int C, int n, int N, int pgas,         \
                                                       const S* records, const S* w0,         \
                                                       S* log_ws, long long* anc,             \
                                                       void* stream) {                        \
    if (C < 1 || n <= 0 || N < 1 || N > kWarpN) return (int)cudaErrorInvalidValue;            \
    const size_t shmem = ring_bytes((int)record_words(N, 3, sizeof(S)), sizeof(S));           \
    void* args[] = {&n, &N, &records, &w0, &log_ws, &anc};                                    \
    auto kernel = pgas ? forward_factor_warp_kernel<S, true>                                  \
                       : forward_factor_warp_kernel<S, false>;                                \
    return launch_blocks(kernel, shmem, C, 32, (cudaStream_t)stream, args);                   \
  }                                                                                           \
  extern "C" int aux_csmc_backward_factor_warp_##SUFFIX(int C, int n, int N,                  \
                                                        const S* records,                     \
                                                        const long long* b_T,                 \
                                                        long long* picked, void* stream) {    \
    if (C < 1 || n <= 0 || N < 1 || N > kWarpN) return (int)cudaErrorInvalidValue;            \
    const size_t shmem = ring_bytes((int)record_words(N, 2, sizeof(S)), sizeof(S));           \
    void* args[] = {&n, &N, &records, &b_T, &picked};                                         \
    return launch_blocks(backward_factor_warp_kernel<S>, shmem, C, 32, (cudaStream_t)stream,  \
                         args);                                                               \
  }

AUX_DEFINE_CSMC_FACTOR(f32, float)
AUX_DEFINE_CSMC_FACTOR(f64, double)
#endif  // __CUDACC__
