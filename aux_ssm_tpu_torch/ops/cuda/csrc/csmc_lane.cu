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
// carry exp(lw - max) / sum. The counts take the prefix sums as
// nondecreasing, which they are up to rounding (they are taken in another
// order than the plain version's, so an index may flip where a uniform falls
// within rounding of a CDF step).
//
// What bounds it: T-1 dependent steps of O(N) cheap work (at T=256, N=256 the
// inputs and outputs are ~1.6 MB in all), so the length of a step's chain,
// not bytes or operations. Three paths, by N:
//  - N <= kWarpN (32; the rare-event models' N = 25): one warp, a lane a
//    particle, carry, prefix sums and previous particles in registers; the
//    collectives are a redux or shuffles, the ancestor counts shuffles and
//    a ballot, the gathers shuffles. No barrier.
//  - N <= kLaneBlockN (1024; theta-logistic's N = 256): one block, a thread
//    a particle, its carry and state in registers. Each collective is one
//    barrier: the warps' partials (a shuffle reduction or scan each) go to
//    shared memory and every thread reads them all. A prefix sum is never
//    assembled: each warp's local prefixes and the warps' boundaries (the
//    partials' running sums, which every thread adds up itself) are
//    searched in two levels, so a step has 3 barriers (4 under PGAS: the
//    reference lane is drawn by the warp whose boundaries hold the draw, by
//    a ballot, and that warp also computes particle 0's row).
//  - N up to kMaxLaneN (8192): the wide path, one block with the weights and
//    prefix sums in shared memory and a few barriers a collective.
// In the first two, a thread loads the rows of steps t + 1 and t + 2 (its
// particles' res_u and eps, anc_u, x*, the model's parameters) into
// registers while it runs step t, so no global load sits on a step's chain
// (a cp.async ring of rows in shared memory costs about a third of a step
// at N=256 on an H100, in issuing its copies); the new particle goes to the
// next step's gathers from the register that computed it. The
// TPU's dense/chunked split at N=1024, its (N, N) triangular-matmul cumsum
// and one-hot gather, its lane-broadcast (T-1, 1, N) parameter rows and its
// segmentation over T are not carried over. Nothing is shared between
// blocks, so a chain axis is blockIdx.x offsetting every pointer: C
// independent chains' sweeps in one launch, a block a chain, their
// operands chain after chain (eps (C, n, N), anc_u (C, n), x0 (C, N), params
// (C, n, kParams), ...; the constants shared; `LaneIO::chain`). C = 1 is the
// one-chain call, bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, no fast math (the
// model steps need IEEE exp and log).
#include "csmc_common.cuh"
#include "csmc_models.cuh"

namespace {

using namespace csmc;

constexpr int kLaneBlockN = 1024;  // the block path's N at most (a thread a particle)
#ifdef __CUDACC__
constexpr int kBP = 1;  // a thread's particles on the block path
#else
constexpr int kBP = kLaneBlockN;  // the host build's one thread holds them all
#endif
constexpr int kWP = AUX_LANES * kBP;  // particles of a warp

// Step t's rows as a thread needs them: its P particles' uniforms and
// noises (from particle j0; past N copies of N - 1's, unused), anc_u, x*
// and the functor's parameters. A thread holds the rows of the two steps
// after the one it runs, so their loads are in flight a step or two before
// their use and none sits on a step's chain.
template <typename S, class Model, int P>
struct StepRow {
  S u[P], e[P], au, xst, p[Model::kParams];

  AUX_HD void load(int t, int n, int N, int j0, const S* res_u, const S* eps, const S* anc_u,
                   const S* x_star, const S* params) {
    if (t >= n) return;
    for (int q = 0; q < P; ++q) {
      const long at = (long)t * N + imin(j0 + q, N - 1);
      u[q] = res_u[at];
      e[q] = eps[at];
    }
    au = anc_u[t];
    xst = x_star[t];
    for (int k = 0; k < Model::kParams; ++k) p[k] = params[(long)t * Model::kParams + k];
  }
};

// w / tot, 0 without a division where w is 0 (IEEE division of 0 takes the
// slow path).
template <typename S>
AUX_HD S normalised(S w, S tot) {
  return w == (S)0 ? (S)0 : w / tot;
}

// ---------------------------------------------------------------------------
// N <= kWarpN: one warp (lane `lane`), no shared memory. The functor is
// built each step on the step's parameters (its step index 0) and its
// constants, both in registers.
// ---------------------------------------------------------------------------

template <typename S, bool kPgas, class Model>
AUX_HD void lane_sweep_warp(int lane, int n, int N, const S* eps, const S* res_u,
                            const S* anc_u, const S* x_star, const S* x0, const S* w0,
                            const S* consts, const S* params, S* xs, S* log_ws,
                            long long* anc) {
  S cv[Model::kConsts];
  for (int k = 0; k < Model::kConsts; ++k) cv[k] = consts[k];
  StepRow<S, Model, kPer> r0, r1, r2;
  r0.load(0, n, N, lane * kPer, res_u, eps, anc_u, x_star, params);
  r1.load(1, n, N, lane * kPer, res_u, eps, anc_u, x_star, params);
  S w[kPer], cw[kPer], xp[kPer];
  for (int q = 0; q < kPer; ++q) {
    const int j = lane * kPer + q;
    w[q] = cw[q] = j < N ? w0[j] : (S)0;
    xp[q] = j < N ? x0[j] : (S)0;
  }
  lane_cumsum(cw, lane);
  for (int q = 0; q < kPer; ++q)
    if (lane * kPer + q >= N) cw[q] = -neg_inf<S>();
  for (int t = 0; t < n; ++t) {
    r2.load(t + 2, n, N, lane * kPer, res_u, eps, anc_u, x_star, params);
    const Model model(cv, r0.p);
    const S xst = r0.xst;
    int a0 = 0;
    if (kPgas) {
      S c[kPer], m = neg_inf<S>();
      for (int q = 0; q < kPer; ++q) {
        const int i = lane * kPer + q;
        c[q] = i < N ? log(w[q] > (S)1e-37 ? w[q] : (S)1e-37) + model.pgas_logpdf(0, xst, xp[q])
                     : neg_inf<S>();
        m = fmax(m, c[q]);
      }
      m = lanes_max(m);
      for (int q = 0; q < kPer; ++q) c[q] = exp(c[q] - m);
      lane_cumsum(c, lane);
      const S v = r0.au * lane_value(c, N - 1);
      int below = 0;
      for (int q = 0; q < kPer; ++q) below += lane * kPer + q < N && c[q] < v;
      a0 = imin(lanes_count(below), N - 1);
    }
    // The particles from their resampled ancestors (particle 0's as if its
    // ancestor were 0), off the reference lane's chain; under PGAS particle
    // 0's log weight again from its drawn ancestor.
    S lw[kPer], xt[kPer], m = neg_inf<S>();
    for (int q = 0; q < kPer; ++q) {
      const int j = lane * kPer + q;
      const int below = lanes_below(cw, j < N ? r0.u[q] : (S)0);
      const int a = j == 0 ? 0 : imin(below, N - 1);
      const S xr = lane_value(xp, a);
      xt[q] = j == 0 ? xst : model.propagate(0, r0.e[q], xr);
      lw[q] = j < N ? model.logw(0, xt[q], xr) : neg_inf<S>();
      if (j < N && !(kPgas && j == 0)) {
        const long at = (long)t * N + j;
        xs[at] = xt[q];
        log_ws[at] = lw[q];
        anc[at] = a;
      }
    }
    if (kPgas) {
      const S xr0 = lane_value(xp, a0);
      if (lane == 0) {
        lw[0] = model.logw(0, xst, xr0);
        xs[(long)t * N] = xst;
        log_ws[(long)t * N] = lw[0];
        anc[(long)t * N] = a0;
      }
    }
    for (int q = 0; q < kPer; ++q) m = fmax(m, lw[q]);
    m = lanes_max(m);
    S part = 0;
    for (int q = 0; q < kPer; ++q) {
      xp[q] = xt[q];
      w[q] = exp(lw[q] - m);
      part += w[q];
    }
    const S tot = warp_sum(part);
    for (int q = 0; q < kPer; ++q) cw[q] = w[q] = normalised(w[q], tot);
    lane_cumsum(cw, lane);
    for (int q = 0; q < kPer; ++q)
      if (lane * kPer + q >= N) cw[q] = -neg_inf<S>();
    r0 = r1;
    r1 = r2;
  }
}

// ---------------------------------------------------------------------------
// kWarpN < N <= kLaneBlockN: one block (thread tid of nt, nt a multiple of
// AUX_LANES), particle j = tid kBP + q in registers.
// ---------------------------------------------------------------------------

// Shared memory of the block path, in values: the previous particles twice
// (xp), the warps' local prefix sums of the carry (loc), five arrays of 32
// warp partials (those of missing warps hold the identity) and particle 0's
// log weight.
struct LaneBlockLayout {
  int np, xp, loc, red, lw0, words;
  AUX_HHD explicit LaneBlockLayout(int N) {
    np = (N + kWP - 1) / kWP * kWP;
    xp = 0;
    loc = xp + 2 * np;
    red = loc + np;
    lw0 = red + 5 * 32;
    words = lw0 + 2;
  }
};

// Inclusive prefix sums of the thread's values within its warp, in place;
// the warp's total on every lane.
template <typename S>
AUX_HD S warp_prefix(S (&v)[kBP], int lane) {
  for (int q = 1; q < kBP; ++q) v[q] += v[q - 1];
  v[kBP - 1] = warp_scan(v[kBP - 1], lane);
  return warp_last(v[kBP - 1]);
}

// The warps' boundaries, the running sums of their partials `red` summed in
// warp order (so the last prefix of warp u, its local prefix plus the
// running sum through u - 1, is boundary u): how many lie below x (at most
// NW; those of missing warps, whose partials are 0, equal the total), and
// the last of them (0 if none). Every thread sums the partials itself: no
// table, no fence.
template <int NW, typename S>
AUX_HD int warps_below(const S* red, S x, S& off) {
  S run = 0;
  int lo = 0;
  off = 0;
#pragma unroll
  for (int u = 0; u < NW; ++u) {
    run += red[u];
    if (run < x) {
      lo = u + 1;
      off = run;
    }
  }
  return lo;
}

// #{i : i-th prefix < u} over the block (at most N - 1), the prefixes as the
// warps' partials `red` and local sums `loc` give them: the warp by its
// boundaries, then the particle within it.
template <int NW, typename S>
AUX_HD int block_below(const S* red, const S* loc, int nw, int N, S u) {
  S off;
  const int lo = warps_below<NW>(red, u, off);
  if (lo >= nw) return N - 1;
  const S* l = loc + lo * kWP;
  int pos = 0;
#pragma unroll
  for (int step = kWP / 2; step > 0; step >>= 1)
    if (off + l[pos + step - 1] < u) pos += step;
  return imin(lo * kWP + pos, N - 1);
}

// Block partials: max of v (redux or shuffles) to red[warp].
template <typename S>
AUX_HD void part_max(const S (&v)[kBP], S* red, int warp, int lane) {
  S m = neg_inf<S>();
  for (int q = 0; q < kBP; ++q) m = fmax(m, v[q]);
  m = lanes_max(m);
  if (lane == 0) red[warp] = m;
}

template <int NW, typename S>
AUX_HD S all_max(const S* red) {
  S m = red[0];
#pragma unroll
  for (int u = 1; u < NW; ++u) m = fmax(m, red[u]);
  return m;
}

template <int NW, typename S>
AUX_HD S all_sum(const S* red) {
  S v = 0;
#pragma unroll
  for (int u = 0; u < NW; ++u) v += red[u];
  return v;
}

// NW: the warps' partials read, at least the block's warps (8 for N <= 256,
// else 32).
template <typename S, bool kPgas, int NW, class Model>
AUX_HD void lane_sweep_block(int tid, int nt, int n, int N, const S* eps, const S* res_u,
                             const S* anc_u, const S* x_star, const S* x0, const S* w0,
                             const S* consts, const S* params, S* xs, S* log_ws, long long* anc,
                             S* sh) {
  const LaneBlockLayout ly(N);
  const int lane = tid % AUX_LANES, warp = tid / AUX_LANES, nw = nt / AUX_LANES;
  S *xpb = sh + ly.xp, *loc = sh + ly.loc, *lw0 = sh + ly.lw0;
  S *redM = sh + ly.red, *redT = redM + 32, *redE = redT + 32, *redL = redE + 32,
    *redS = redL + 32;
  for (int u = tid; u < 32; u += nt) {  // the identity where no warp writes
    redM[u] = redL[u] = neg_inf<S>();
    redT[u] = redE[u] = redS[u] = (S)0;
  }
  S cv[Model::kConsts];
  for (int k = 0; k < Model::kConsts; ++k) cv[k] = consts[k];
  StepRow<S, Model, kBP> r0, r1, r2;
  r0.load(0, n, N, tid * kBP, res_u, eps, anc_u, x_star, params);
  r1.load(1, n, N, tid * kBP, res_u, eps, anc_u, x_star, params);
  S w[kBP], xp[kBP];
  for (int q = 0; q < kBP; ++q) {
    const int j = tid * kBP + q;
    w[q] = j < N ? w0[j] : (S)0;
    xp[q] = j < N ? x0[j] : (S)0;
    xpb[j] = xp[q];
  }
  AUX_BSYNC();
  for (int t = 0; t < n; ++t) {
    r2.load(t + 2, n, N, tid * kBP, res_u, eps, anc_u, x_star, params);
    const Model model(cv, r0.p);
    const S xst = r0.xst;
    const S *xcur = xpb + (t & 1) * ly.np;
    S* xnxt = xpb + ((t & 1) ^ 1) * ly.np;

    // Barrier 1: the carry's local prefix sums and warp totals (and the
    // reference lane's scores' maxima).
    S c[kBP];
    if (kPgas) {
      for (int q = 0; q < kBP; ++q)
        c[q] = tid * kBP + q < N
                   ? log(w[q] > (S)1e-37 ? w[q] : (S)1e-37) + model.pgas_logpdf(0, xst, xp[q])
                   : neg_inf<S>();
      part_max(c, redM, warp, lane);
    }
    {
      S p[kBP];
      for (int q = 0; q < kBP; ++q) p[q] = w[q];
      const S tw = warp_prefix(p, lane);
      for (int q = 0; q < kBP; ++q) loc[tid * kBP + q] = p[q];
      if (lane == 0) redT[warp] = tw;
    }
    AUX_BSYNC();
    if (kPgas) {  // the reference lane's exponentials' local prefixes and warp totals
      const S m = all_max<NW>(redM);
      for (int q = 0; q < kBP; ++q) c[q] = exp(c[q] - m);
      const S te = warp_prefix(c, lane);
      if (lane == 0) redE[warp] = te;
    }

    // The particles (particle 0 under PGAS below): ancestor, propagation,
    // log weight.
    S lw[kBP], ml = neg_inf<S>();
    for (int q = 0; q < kBP; ++q) {
      const int j = tid * kBP + q;
      lw[q] = neg_inf<S>();
      if (j >= N) continue;
      if (kPgas && j == 0) {
        xp[q] = xst;
        xnxt[0] = xst;
        continue;
      }
      const int a = j == 0 ? 0 : block_below<NW>(redT, loc, nw, N, r0.u[q]);
      const S xr = xcur[a];
      const S x = j == 0 ? xst : model.propagate(0, r0.e[q], xr);
      lw[q] = model.logw(0, x, xr);
      const long at = (long)t * N + j;
      xs[at] = x;
      log_ws[at] = lw[q];
      anc[at] = a;
      xp[q] = x;
      xnxt[j] = x;
      ml = fmax(ml, lw[q]);
    }
    if (kPgas) {
      // Barrier 2: the exponentials' warp totals; the warp whose boundaries
      // hold the draw counts it by a ballot, and its lane 0 computes particle
      // 0's row.
      AUX_BSYNC();
      const S v = r0.au * all_sum<NW>(redE);
      S off;
      const int ws = imin(warps_below<NW>(redE, v, off), nw - 1);  // past the last: the last
      if (warp == ws) {
        off = 0;  // boundary ws - 1
#pragma unroll
        for (int u = 0; u < NW; ++u)
          if (u < ws) off += redE[u];
        int below = 0;
        for (int q = 0; q < kBP; ++q) below += off + c[q] < v;
        const int a0 = imin(ws * kWP + lanes_count(below), N - 1);
        if (lane == 0) {
          const S l0 = model.logw(0, xst, xcur[a0]);
          xs[(long)t * N] = xst;
          log_ws[(long)t * N] = l0;
          anc[(long)t * N] = a0;
          *lw0 = l0;
          ml = fmax(ml, l0);
        }
      }
    }
    // Barrier 3: the log weights' maxima.
    ml = lanes_max(ml);
    if (lane == 0) redL[warp] = ml;
    AUX_BSYNC();
    const S m = all_max<NW>(redL);

    // Barrier 4: the exponentials' sum; the carry.
    S part = 0;
    for (int q = 0; q < kBP; ++q) {
      const int j = tid * kBP + q;
      const S l = kPgas && j == 0 ? *lw0 : lw[q];
      w[q] = j < N ? exp(l - m) : (S)0;
      part += w[q];
    }
    part = warp_sum(part);
    if (lane == 0) redS[warp] = part;
    AUX_BSYNC();
    const S tot = all_sum<NW>(redS);
    for (int q = 0; q < kBP; ++q) w[q] = normalised(w[q], tot);
    r0 = r1;
    r1 = r2;
  }
}

// ---------------------------------------------------------------------------
// N > kLaneBlockN: the wide path.
// ---------------------------------------------------------------------------

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

// A lane sweep's operands; `chain(c, n, N)` is chain c's slice of a
// chain-batched call's (n steps of N particles, its parameter rows; the
// constants shared).
template <typename S, class Model>
struct LaneIO {
  const S *eps, *res_u, *anc_u, *x_star, *x0, *w0, *consts, *params;
  S *xs, *log_ws;
  long long* anc;

  AUX_HD LaneIO chain(int c, int n, int N) const {
    const long nN = (long)n * N, cn = (long)c * n, cN = (long)c * N;
    return LaneIO{eps + c * nN,   res_u + c * nN, anc_u + cn,   x_star + cn,
                  x0 + cN,        w0 + cN,        consts,       params + cn * Model::kParams,
                  xs + c * nN,    log_ws + c * nN, anc + c * nN};
  }
};

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
__global__ void __launch_bounds__(32)
lane_warp_kernel(int n, int N, const S* eps, const S* res_u, const S* anc_u, const S* x_star,
                 const S* x0, const S* w0, const S* consts, const S* params, S* xs,
                 S* log_ws, long long* anc) {
  const auto io = LaneIO<S, Model>{eps, res_u, anc_u, x_star, x0, w0, consts, params, xs,
                                   log_ws, anc}.chain((int)blockIdx.x, n, N);
  lane_sweep_warp<S, kPgas, Model>((int)threadIdx.x, n, N, io.eps, io.res_u, io.anc_u,
                                   io.x_star, io.x0, io.w0, io.consts, io.params, io.xs,
                                   io.log_ws, io.anc);
}

template <typename S, bool kPgas, int NW, class Model>
__global__ void __launch_bounds__(kLaneBlockN)
lane_block_kernel(int n, int N, const S* eps, const S* res_u, const S* anc_u,
                  const S* x_star, const S* x0, const S* w0, const S* consts, const S* params,
                  S* xs, S* log_ws, long long* anc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const auto io = LaneIO<S, Model>{eps, res_u, anc_u, x_star, x0, w0, consts, params, xs,
                                   log_ws, anc}.chain((int)blockIdx.x, n, N);
  lane_sweep_block<S, kPgas, NW, Model>((int)threadIdx.x, (int)blockDim.x, n, N, io.eps,
                                        io.res_u, io.anc_u, io.x_star, io.x0, io.w0, io.consts,
                                        io.params, io.xs, io.log_ws, io.anc,
                                        reinterpret_cast<S*>(smem));
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
  const auto io = LaneIO<S, Model>{eps, res_u, anc_u, x_star, x0, w0, consts, params, xs,
                                   log_ws, anc}.chain((int)blockIdx.x, n, N);
  const Model model(io.consts, io.params);
  lane_sweep<S, kPgas>(Block<S>{(int)threadIdx.x, (int)blockDim.x, red}, n, N, io.eps,
                       io.res_u, io.anc_u, io.x_star, io.x0, io.w0, model, io.xs, io.log_ws,
                       io.anc, w, cw, xp, a0);
}

template <typename S, class Model>
int launch_lane(int C, int n, int N, int pgas, const S* eps, const S* res_u, const S* anc_u,
                const S* x_star, const S* x0, const S* w0, const S* consts, const S* params,
                S* xs, S* log_ws, long long* anc, void* stream) {
  if (C < 1 || n <= 0 || N < 1 || N > kMaxLaneN) return (int)cudaErrorInvalidValue;
  void* args[] = {&n, &N, &eps, &res_u, &anc_u, &x_star, &x0, &w0, &consts, &params, &xs,
                  &log_ws, &anc};
  const cudaStream_t s = (cudaStream_t)stream;
  if (N <= kWarpN) {
    auto kernel = pgas ? lane_warp_kernel<S, true, Model> : lane_warp_kernel<S, false, Model>;
    return launch_blocks(kernel, 0, C, 32, s, args);
  }
  if (N <= kLaneBlockN) {
    const size_t shmem = (size_t)LaneBlockLayout(N).words * sizeof(S);
    auto kernel = N <= 256 ? (pgas ? lane_block_kernel<S, true, 8, Model>
                                   : lane_block_kernel<S, false, 8, Model>)
                           : (pgas ? lane_block_kernel<S, true, 32, Model>
                                   : lane_block_kernel<S, false, 32, Model>);
    return launch_blocks(kernel, shmem, C, lane_threads(N), s, args);
  }
  const size_t shmem = (3 * (size_t)N + 33) * sizeof(S) + sizeof(int);
  auto kernel = pgas ? lane_kernel<S, true, Model> : lane_kernel<S, false, Model>;
  return launch_blocks(kernel, shmem, C, lane_threads(N), s, args);
}

}  // namespace

#define AUX_DEFINE_LANE(NAME, MODEL, SUFFIX, S)                                              \
  extern "C" int aux_csmc_lane_##NAME##_##SUFFIX(                                            \
      int C, int n, int N, int pgas, const S* eps, const S* res_u, const S* anc_u,           \
      const S* x_star, const S* x0, const S* w0, const S* consts, const S* params, S* xs,    \
      S* log_ws, long long* anc, void* stream) {                                             \
    return launch_lane<S, MODEL<S>>(C, n, N, pgas, eps, res_u, anc_u, x_star, x0, w0,        \
                                    consts, params, xs, log_ws, anc, stream);                \
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
