"""The arithmetic of the CUDA kernels (`aux_ssm_tpu_torch/ops/cuda/csrc/`),
built as host C++ with g++ and run one "thread" at a time, against the plain
PyTorch versions in float64.

Everything above each source's launch section is plain C++ on pointers, so
the per-step maps, the scans' passes (dense and scalar), the four cSMC
sweeps (the lane and block-lane sweeps with each of their model functors) and
the stitching kernels' rows and draws (row_lse, col_sample, block_masses,
stitch_draws and within_block_cols, with the counter hash) run here
unchanged; only the launch itself needs nvcc and a
card. The sweeps' and the column draws' indices must be identical, the
counter uniforms bit for bit. Tolerance: both sides compute the same
algebra in float64 with different summation orders and solvers (substitution
here, LAPACK there), so they agree to ~1e-12; rtol 1e-9 leaves margin and
still catches any wrong term.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import kalman_fused as KF  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import scalar_scan as SS  # noqa: E402
from aux_ssm_tpu_torch.ops import stitching as ST  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda._build import CSRC, instance_dim  # noqa: E402
from aux_ssm_tpu_torch.ops.filtering import (  # noqa: E402
    _make_associative_elements, filtering, kalman_update)
from aux_ssm_tpu_torch.ops.lgssm import LGSSM  # noqa: E402

_PRELUDE = """
#include <cmath>
using std::isfinite; using std::isinf; using std::isnan; using std::log; using std::sqrt;
#define AUX_HD inline
#define AUX_SYNC()
"""

_MAPS = """
#include "kalman_fused.cu"
// The padded steps (elements, ell, backward_maps, logdensity) on one
// "thread" (a team of 1), a block at a time, on a host copy of the block's
// shared memory, at the instance's D that the C entries pick by max(dx, dy):
// the n x C blocks of C chains' n steps, the inputs with bits in `shared`
// read once for every chain (StepAt), as the launch runs them.
template <int D>
static void host_elements(int n, int C, int sh_, int dx, int dy, ElementsIn<double> in,
                          ElementsOut<double> out) {
  static double sh[ElementsLay<D>::size];
  for (long g = 0; g < (long)n * C; ++g)
    elements_step<double, D, 1>(0, StepAt{g, C, (unsigned)sh_}, dx, dy, in, out, sh, nullptr);
}
template <int D>
static void host_ell(int n, int C, int sh_, int dx, int dy, ElementsIn<double> in, double* out) {
  static double sh[EllLay<D>::size];
  for (long g = 0; g < (long)n * C; ++g)
    ell_step<double, D, 1>(0, StepAt{g, C, (unsigned)sh_}, dx, dy, in, out, sh);
}
template <int D>
static void host_maps(int n, int C, int sh_, int dx, MapsIn<double> in, MapsOut<double> out) {
  static double sh[MapsLay<D>::size];
  for (long g = 0; g < (long)n * C; ++g)
    backward_maps_step<double, D, 1>(0, StepAt{g, C, (unsigned)sh_}, dx, in, out, sh, nullptr);
}
template <int D>
static void host_density(int n, int C, int sh_, int dx, int dy, DensityIn<double> in,
                         double* out) {
  static double sh[DensityLay<D>::size];
  for (long g = 0; g < (long)n * C; ++g)
    logdensity_step<double, D, 1>(0, StepAt{g, C, (unsigned)sh_}, dx, dy, in, out, sh);
}
// The instance's D for max(dx, dy), as on_instance picks it in float (the
// host build runs D = 48 in double too).
static int host_dim(int dx, int dy) {
  const int d = dx > dy ? dx : dy;
  return d <= kElemD ? kElemD : d <= kWideD ? kWideD : kWide48D;
}
#define AUX_ON_DIM(D_, CALL) \
  (D_ == kElemD ? CALL<kElemD> : D_ == kWideD ? CALL<kWideD> : CALL<kWide48D>)
extern "C" {
void h_make_elements(int n, int C, int shared, int dx, int dy, const double* F,
    const double* Q, const double* b, const double* H, const double* R, const double* c,
    const double* y, const double* m, const double* P, double* A, double* bel, double* Cm,
    double* eta, double* J) {
  const ElementsIn<double> in{F, Q, b, H, R, c, y, m, P};
  const ElementsOut<double> out{A, bel, Cm, eta, J};
  AUX_ON_DIM(host_dim(dx, dy), host_elements)(n, C, shared, dx, dy, in, out);
}
void h_ell(int n, int C, int shared, int dx, int dy, const double* F, const double* Q,
    const double* b, const double* H, const double* R, const double* c, const double* y,
    const double* m, const double* P, double* out) {
  const ElementsIn<double> in{F, Q, b, H, R, c, y, m, P};
  AUX_ON_DIM(host_dim(dx, dy), host_ell)(n, C, shared, dx, dy, in, out);
}
void h_backward_maps(int n, int C, int shared, int dx, const double* F, const double* Q,
    const double* b, const double* m, const double* P, const double* eps, double* G,
    double* inc) {
  const MapsIn<double> in{F, Q, b, m, P, eps};
  const MapsOut<double> out{G, inc};
  AUX_ON_DIM(host_dim(dx, 1), host_maps)(n, C, shared, dx, in, out);
}
void h_logdensity_steps(int n, int C, int shared, int dx, int dy, const double* F,
    const double* Q, const double* b, const double* H, const double* R, const double* c,
    const double* y, const double* xp, const double* xc, double* out) {
  const DensityIn<double> in{F, Q, b, H, R, c, y, xp, xc};
  AUX_ON_DIM(host_dim(dx, dy), host_density)(n, C, shared, dx, dy, in, out);
}
}
"""

_SCAN = """
#include <algorithm>
#include <vector>
#include "scan.cu"
// The scan kernel's phases, one block ("thread" 0 of 1) at a time: each
// chunk's scan; the levels (block c takes a copy of block c - 2^L's value,
// as from global memory); each chunk's apply, on the prefixes its scan left
// in shared memory (later windows staged from the output), each element on
// its own "team". The instance is the one the C entries pick by d (D = 48
// in double too), with its plan's ring of prefixes (1 at D = 32 in f64 and
// at D = 48: every later prefix staged back) and input slots.
// Elements (n, C, ...): chain c's scan on its own elements, as its blocks run.
template <class Op>
static void host_scan_chain(int n, int C, int chain, int d, bool rev, typename Op::View x,
                            typename Op::View out) {
  using S = typename Op::Scalar;
  constexpr int D = Op::D, M = Op::M, V = Op::V, slot = OpLay<Op>::slot, kRing = Op::ring,
                ins = Op::ins, per = kRing + ins + 2;
  const Order at{n, rev, C, chain};
  const ScanPlan pl = scan_plan(n);
  std::vector<S> mem((size_t)pl.chunks * per * slot), partner(slot), work(Op::work + 1);
  std::vector<S*> cur(pl.chunks);
  // Chunk c's slots: kRing prefixes, `ins` inputs, two running totals.
  auto slot_of = [&](int c, int g) { return mem.data() + ((size_t)c * per + g) * slot; };
  for (int c = 0; c < pl.chunks; ++c) {
    for (int g = 0; g < kRing + ins; ++g) pad_slot<S, D, M, V>(0, 1, d, slot_of(c, g));
    cur[c] = chunk_scan<Op, 1>(0, 0, pl, c, n, d, at, x, out, slot_of(c, 0), slot_of(c, kRing),
                               slot_of(c, kRing + ins), slot_of(c, kRing + ins + 1),
                               work.data());
  }
  for (int L = 0; L < pl.levels; ++L)
    for (int c = pl.chunks - 1; c >= (1 << L); --c) {
      std::copy(cur[c - (1 << L)], cur[c - (1 << L)] + slot, partner.data());
      S* dst = cur[c] == slot_of(c, kRing + ins) ? slot_of(c, kRing + ins + 1)
                                                 : slot_of(c, kRing + ins);
      level_combine<Op, 1>(0, 0, partner.data(), cur[c], dst, work.data());
      cur[c] = dst;
    }
  window_out<Op>(0, 1, pl, n, d, at, slot_of(0, 0), out);
  for (int c = pl.chunks - 1; c > 0; --c) {
    const long k0 = (long)c * pl.per;
    const long cnt = n - k0 < pl.per ? (n - k0 > 0 ? n - k0 : 0) : pl.per;
    for (long i0 = 0; i0 < cnt; i0 += kRing) {
      if (i0 > 0)  // a later window: its prefixes from the output
        for (long i = i0; i < i0 + kRing && i < cnt; ++i)
          stage_element<S, D, M, V>(0, 1, out, at(k0 + i), d, slot_of(c, (int)(i - i0)));
      for (long i = i0; i < i0 + kRing && i < cnt; ++i)
        apply_element<Op, 1>(0, 0, cur[c - 1], slot_of(c, (int)(i - i0)), work.data(), out,
                             at(k0 + i), d);
    }
  }
}
template <class Op>
static void host_scan(int n, int C, int d, bool rev, typename Op::View x, typename Op::View out) {
  for (int chain = 0; chain < C; ++chain) host_scan_chain<Op>(n, C, chain, d, rev, x, out);
}
template <int D>
static void host_filter(int n, int Cc, int d, double* A, double* b, double* C, double* e,
                        double* J, double* oA, double* ob, double* oC, double* oe, double* oJ) {
  using Op = FilterOp<double, D>;
  host_scan<Op>(n, Cc, d, false, typename Op::View{{A, C, J}, {b, e}},
                typename Op::View{{oA, oC, oJ}, {ob, oe}});
}
template <int D>
static void host_affine(int n, int C, int d, int rev, double* G, double* e, double* oG,
                        double* oe) {
  using Op = AffineOp<double, D>;
  host_scan<Op>(n, C, d, rev != 0, typename Op::View{{G}, {e}}, typename Op::View{{oG}, {oe}});
}
extern "C" {
void h_filter_scan(int n, int Cc, int d, double* A, double* b, double* C, double* e, double* J,
                   double* oA, double* ob, double* oC, double* oe, double* oJ) {
  (d <= kNarrowD ? host_filter<kNarrowD> : d <= kWideD ? host_filter<kWideD>
                                                      : host_filter<kWide48D>)(
      n, Cc, d, A, b, C, e, J, oA, ob, oC, oe, oJ);
}
void h_affine_scan(int n, int C, int d, int rev, double* G, double* e, double* oG, double* oe) {
  (d <= kNarrowD ? host_affine<kNarrowD> : d <= kWideD ? host_affine<kWideD>
                                                      : host_affine<kWide48D>)(
      n, C, d, rev, G, e, oG, oe);
}
// The kernel's plan for n elements (chunks, per, levels) and the values of a
// padded filter and affine element at D = 16, 32 and 48.
void h_scan_layout(int n, int* out) {
  const ScanPlan pl = scan_plan(n);
  out[0] = pl.chunks;
  out[1] = pl.per;
  out[2] = pl.levels;
  out[3] = OpLay<FilterOp<double, kNarrowD>>::slot;
  out[4] = OpLay<AffineOp<double, kNarrowD>>::slot;
  out[5] = OpLay<FilterOp<double, kWideD>>::slot;
  out[6] = OpLay<AffineOp<double, kWideD>>::slot;
  out[7] = OpLay<FilterOp<float, kWide48D>>::slot;
  out[8] = OpLay<AffineOp<float, kWide48D>>::slot;
}
}
"""


_CSMC_PRELUDE = """
#define AUX_HD inline
#define AUX_BSYNC()
#define AUX_LANES 1
#define AUX_WSYNC()
"""

_CSMC_FWD = """
#include <vector>
#include "csmc_fwd.cu"
// The pair-score pass over every step, one thread.
static void host_records(int n, int N, int k, int nv, const double* a, const double* b,
                         const double* v0, const double* v1, const double* v2, const double* s,
                         double* records) {
  std::vector<double> tile(2 * kWarpN * (kPairChunk + 1));
  for (int t = 0; t < n; ++t)
    pair_record<double>(0, 1, t, N, k, nv, a, b, v0, v1, v2, s, records, tile.data());
}
// A one-warp sweep's ring in host memory.
struct HostRing {
  std::vector<double> buf;
  unsigned long long bars[kStages];
  Ring<double> ring;
  HostRing(int ow, int n, bool reverse)
      : buf((long)kStages * kChunk * ow), ring{buf.data(), bars, ow, n, reverse} {}
};
// Each sweep on the path its launcher takes: N <= kWarpN the pair scores,
// then the one-warp sweep (one lane); past it the block sweep (one thread).
extern "C" {
void h_pair_scores(int n, int N, int k, int nv, const double* a, const double* b,
                   const double* v0, const double* v1, const double* v2, const double* s,
                   double* records) {
  host_records(n, N, k, nv, a, b, v0, v1, v2, s, records);
}
void h_forward_factor(int n, int N, int k, int pgas, const double* rf, const double* cf,
    const double* rb, const double* cb, const double* res_u, const double* anc_u,
    const double* w0, double* log_ws, long long* anc, double* w, double* cw) {
  if (N <= kWarpN) {
    const int ow = (int)record_words(N, 3, 8);
    std::vector<double> records((long)n * ow);
    host_records(n, N, k, 3, rf, cf, rb, cb, res_u, anc_u, records.data());
    HostRing r(ow, n, false);
    if (pgas)
      forward_warp_sweep<double, true>(0, n, N, records.data(), w0, log_ws, anc, r.ring);
    else
      forward_warp_sweep<double, false>(0, n, N, records.data(), w0, log_ws, anc, r.ring);
    return;
  }
  double red[33];
  int a0 = 0;
  const csmc::Block<double> b{0, 1, red};
  if (pgas)
    forward_factor_sweep<double, true>(b, n, N, k, rf, cf, rb, cb, res_u, anc_u, w0, log_ws,
                                       anc, w, cw, &a0);
  else
    forward_factor_sweep<double, false>(b, n, N, k, rf, cf, rb, cb, res_u, anc_u, w0, log_ws,
                                        anc, w, cw, &a0);
}
void h_backward_factor(int n, int N, int k, const double* rf, const double* cf,
    const double* rb, const double* lw, const double* us, const long long* b_T,
    long long* picked, double* w) {
  if (N <= kWarpN) {
    const int ow = (int)record_words(N, 2, 8);
    std::vector<double> records((long)n * ow);
    host_records(n, N, k, 2, cf, rf, lw, rb, nullptr, us, records.data());
    HostRing r(ow, n, true);
    backward_warp_sweep<double>(0, n, N, records.data(), b_T, picked, r.ring);
    return;
  }
  double red[33];
  int bsel = 0;
  backward_factor_sweep<double>(csmc::Block<double>{0, 1, red}, n, N, k, rf, cf, rb, lw, us,
                                b_T, picked, w, &bsel);
}
// The chain-batched launches: C chains' operands chain after chain, a block
// a chain (each in turn here) through the kernels' *_chain entries; at N <=
// kWarpN the pair-score pass over the C n steps first.
void h_forward_factor_chains(int C, int n, int N, int k, int pgas, const double* rf,
    const double* cf, const double* rb, const double* cb, const double* res_u,
    const double* anc_u, const double* w0, double* log_ws, long long* anc, double* w,
    double* cw) {
  if (N <= kWarpN) {
    const int ow = (int)record_words(N, 3, 8);
    std::vector<double> records((long)C * n * ow);
    host_records(C * n, N, k, 3, rf, cf, rb, cb, res_u, anc_u, records.data());
    for (int c = 0; c < C; ++c) {
      HostRing r(ow, n, false);
      if (pgas)
        forward_warp_chain<double, true>(c, 0, n, N, records.data(), w0, log_ws, anc, r.ring);
      else
        forward_warp_chain<double, false>(c, 0, n, N, records.data(), w0, log_ws, anc, r.ring);
    }
    return;
  }
  double red[33];
  int a0 = 0;
  const csmc::Block<double> b{0, 1, red};
  for (int c = 0; c < C; ++c)
    if (pgas)
      forward_factor_chain<double, true>(b, c, n, N, k, rf, cf, rb, cb, res_u, anc_u, w0, log_ws,
                                         anc, w, cw, &a0);
    else
      forward_factor_chain<double, false>(b, c, n, N, k, rf, cf, rb, cb, res_u, anc_u, w0,
                                          log_ws, anc, w, cw, &a0);
}
void h_backward_factor_chains(int C, int n, int N, int k, const double* rf, const double* cf,
    const double* rb, const double* lw, const double* us, const long long* b_T,
    long long* picked, double* w) {
  if (N <= kWarpN) {
    const int ow = (int)record_words(N, 2, 8);
    std::vector<double> records((long)C * n * ow);
    host_records(C * n, N, k, 2, cf, rf, lw, rb, nullptr, us, records.data());
    for (int c = 0; c < C; ++c) {
      HostRing r(ow, n, true);
      backward_warp_chain<double>(c, 0, n, N, records.data(), b_T, picked, r.ring);
    }
    return;
  }
  double red[33];
  int bsel = 0;
  for (int c = 0; c < C; ++c)
    backward_factor_chain<double>(csmc::Block<double>{0, 1, red}, c, n, N, k, rf, cf, rb, lw, us,
                                  b_T, picked, w, &bsel);
}
}
"""

_CSMC_BLOCK = """
#include "csmc_block_lane.cu"
// The sweep on each of its paths (path 0: particles in global memory and the
// block collectives; 1: staged, block collectives; 2: staged, the one-warp
// carry), one thread; `smem` holds sweep_words for the path.
template <class Model>
static void host_block_lane(int path, int n, int N, int d, const double* eps,
    const double* res_u, const double* x_star, const double* x0, const double* w0,
    const double* consts, const double* params, double* xs, double* log_ws, long long* anc,
    double* smem) {
  const Model model(d, N, consts);
  const SweepBuffers<double> sb = carve<double, Model>(smem, N, d, 1, path > 0);
  const csmc::Block<double> b{0, 1, sb.red};
  if (path == 0)
    block_lane_sweep<double, Model, false, false>(b, n, N, d, eps, params, res_u, x_star, x0, w0,
                                                  model, xs, log_ws, anc, sb);
  else if (path == 1)
    block_lane_sweep<double, Model, true, false>(b, n, N, d, eps, params, res_u, x_star, x0, w0,
                                                 model, xs, log_ws, anc, sb);
  else
    block_lane_sweep<double, Model, true, true>(b, n, N, d, eps, params, res_u, x_star, x0, w0,
                                                model, xs, log_ws, anc, sb);
}
#define HOST_BLOCK_LANE(NAME, MODEL)                                                         \
  extern "C" void h_block_lane_##NAME(int path, int n, int N, int d, const double* eps,      \
      const double* res_u, const double* x_star, const double* x0, const double* w0,         \
      const double* consts, const double* params, double* xs, double* log_ws,                \
      long long* anc, double* smem) {                                                        \
    host_block_lane<csmc::MODEL<double>>(path, n, N, d, eps, res_u, x_star, x0, w0, consts,  \
                                         params, xs, log_ws, anc, smem);                     \
  }                                                                                          \
  /* The chain-batched launch: chain c (a block in turn) on BlockLaneIO::chain(c). */        \
  extern "C" void h_block_lane_chains_##NAME(int path, int C, int n, int N, int d,           \
      const double* eps, const double* res_u, const double* x_star, const double* x0,        \
      const double* w0, const double* consts, const double* params, double* xs,              \
      double* log_ws, long long* anc, double* smem) {                                        \
    const BlockLaneIO<double> all{eps, res_u, x_star, x0, w0, consts, params, xs, log_ws,    \
                                  anc};                                                      \
    for (int c = 0; c < C; ++c) {                                                            \
      const auto io = all.chain(c, n, N, d, csmc::MODEL<double>::row_width(d));              \
      host_block_lane<csmc::MODEL<double>>(path, n, N, d, io.eps, io.res_u, io.x_star,       \
                                           io.x0, io.w0, io.consts, io.params, io.xs,        \
                                           io.log_ws, io.anc, smem);                         \
    }                                                                                        \
  }                                                                                          \
  extern "C" long h_block_lane_words_##NAME(int N, int d, int nwarps, int staged) {          \
    return sweep_words<csmc::MODEL<double>>(N, d, nwarps, staged != 0);                       \
  }                                                                                          \
  extern "C" int h_block_lane_staged_##NAME(int N, int d, int nconst, int nwarps, int elem,  \
                                            long limit) {                                    \
    return block_lane_staged<csmc::MODEL<double>>(N, d, nconst, nwarps, elem, limit);         \
  }
HOST_BLOCK_LANE(sv_guided, SvGuided)
HOST_BLOCK_LANE(spatial_guided, SpatialGuided)
// P v through SpatialGuided's row lists, row by row.
extern "C" void h_spatial_apply(int d, const double* consts, const double* v, double* out) {
  const csmc::SpatialGuided<double> model(d, 1, consts);
  for (int i = 0; i < d; ++i) out[i] = model.apply_row(i, v);
}
"""

_SCALAR_SCAN = """
#include <vector>
#include "scalar_scan.cu"
// The whole-column path, one block at a time: each (chunk, lane) thread's
// pass 1, the totals' levels, each thread's pass 3.
template <class Op>
static void host_cols(int n, int B, bool rev, const Arrays<Op>& x, const Arrays<Op>& out) {
  using S = typename Op::Scalar;
  static ColsTot<Op> sh;
  static S acc[kChunks][kColLanes][Op::kN], v[kChunks][kColLanes][kColWin<Op>][Op::kN];
  for (int b0 = 0; b0 < B; b0 += kColLanes) {
    for (int c = 0; c < kChunks; ++c)
      for (int l = 0; l < kColLanes; ++l) {
        if (b0 + l < B)
          cols_scan<Op>(c, b0 + l, n, B, rev, x, out, v[c][l], acc[c][l]);
        else
          Op::identity(acc[c][l]);
        for (int a = 0; a < Op::kN; ++a) sh.t[0][a][c][l] = acc[c][l][a];
      }
    for (int L = 0; L < kColLevels; ++L)
      for (int c = 0; c < kChunks; ++c)
        for (int l = 0; l < kColLanes; ++l) cols_level<Op>(L, c, l, sh, acc[c][l]);
    for (int c = 0; c < kChunks; ++c)
      for (int l = 0; l < kColLanes; ++l)
        if (b0 + l < B) {
          S pre[Op::kN];
          for (int a = 0; a < Op::kN; ++a) pre[a] = sh.t[1][a][c > 0 ? c - 1 : 0][l];
          cols_apply<Op>(c, b0 + l, n, B, rev, pre, v[c][l], out);
        }
  }
}
// The kernel's phases for the plan of `sms` SMs: the whole-column path, or
// one split block at a time in ticket order: its chunk threads' pass 1 and
// hand-overs, each warp's totals scan (its lanes in turn), its chunk
// threads' pass 3. seg[0] = the segments of a column that ran (0: whole).
template <class Op>
static void host_scalar_scan(int n, int B, int sms, bool rev, const Arrays<Op>& x,
                             const Arrays<Op>& out, int* seg) {
  using S = typename Op::Scalar;
  const int G = scalar_segments(n, B, sms);
  seg[0] = G;
  if (G == 0) return host_cols<Op>(n, B, rev, x, out);
  std::vector<unsigned long long> hand(scalar_hand_words<Op>(B));
  const HandOver<Op> ho{hand.data()};
  static ScanShared<Op> sh;
  static S v[kThreads][kWin][Op::kN], run[kThreads][Op::kN];
  for (int ticket = 0; ticket < (B + kCols - 1) / kCols * G; ++ticket) {
    const Seg sg(ticket, G, 1u);
    for (int t = 0; t < kCols * sg.CPS; ++t) {
      const ChunkAt ch(t, sg, n, B);
      chunk_scan<Op>(ch, n, B, rev, x, v[t], run[t]);
      publish_total<Op>(ch, sg, run[t], sh, ho);
    }
    for (int w = 0; w < kCols; ++w) warp_pre<Op>(w, sg, sh, ho);
    for (int t = 0; t < kCols * sg.CPS; ++t)
      chunk_apply<Op>(ChunkAt(t, sg, n, B), n, B, rev, x, sh, v[t], out);
  }
}
extern "C" {
void h_scalar_filter_scan(int n, int B, int sms, double* A, double* b, double* C, double* e,
                          double* J, double* oA, double* ob, double* oC, double* oe, double* oJ,
                          int* seg) {
  using Op = ScalarFilterOp<double>;
  host_scalar_scan<Op>(n, B, sms, false, Arrays<Op>{{A, b, C, e, J}},
                       Arrays<Op>{{oA, ob, oC, oe, oJ}}, seg);
}
void h_scalar_affine_scan(int n, int B, int sms, int rev, double* g, double* e, double* og,
                          double* oe, int* seg) {
  using Op = ScalarAffineOp<double>;
  host_scalar_scan<Op>(n, B, sms, rev != 0, Arrays<Op>{{g, e}}, Arrays<Op>{{og, oe}}, seg);
}
int h_scalar_segments(int n, int B, int sms) { return scalar_segments(n, B, sms); }
// The hand-over words of each scan and dtype at B columns: filter f32, f64,
// affine f32, f64.
void h_scalar_hand_words(int B, long long* out) {
  out[0] = scalar_hand_words<ScalarFilterOp<float>>(B);
  out[1] = scalar_hand_words<ScalarFilterOp<double>>(B);
  out[2] = scalar_hand_words<ScalarAffineOp<float>>(B);
  out[3] = scalar_hand_words<ScalarAffineOp<double>>(B);
}
}
"""

_CSMC_LANE = """
#include <type_traits>
#include <vector>
#include "csmc_lane.cu"
// The sweep on the path its launcher takes: N <= kWarpN one warp (one lane
// here), N <= kLaneBlockN one block (one thread), past it the wide path.
template <class Model>
static void host_lane(int n, int N, int pgas, const double* eps, const double* res_u,
    const double* anc_u, const double* x_star, const double* x0, const double* w0,
    const double* consts, const double* params, double* xs, double* log_ws, long long* anc) {
  if (N <= kWarpN) {
    if (pgas)
      lane_sweep_warp<double, true, Model>(0, n, N, eps, res_u, anc_u, x_star, x0, w0, consts,
                                           params, xs, log_ws, anc);
    else
      lane_sweep_warp<double, false, Model>(0, n, N, eps, res_u, anc_u, x_star, x0, w0, consts,
                                            params, xs, log_ws, anc);
  } else if (N <= kLaneBlockN) {
    std::vector<double> sh(LaneBlockLayout(N).words);
    auto run = [&](auto nw) {
      constexpr int NW = decltype(nw)::value;
      if (pgas)
        lane_sweep_block<double, true, NW, Model>(0, 1, n, N, eps, res_u, anc_u, x_star, x0,
                                                  w0, consts, params, xs, log_ws, anc,
                                                  sh.data());
      else
        lane_sweep_block<double, false, NW, Model>(0, 1, n, N, eps, res_u, anc_u, x_star, x0,
                                                   w0, consts, params, xs, log_ws, anc,
                                                   sh.data());
    };
    if (N <= 256) run(std::integral_constant<int, 8>());
    else run(std::integral_constant<int, 32>());
  } else {
    std::vector<double> sh(3 * (size_t)N + 33);
    int a0 = 0;
    const csmc::Block<double> b{0, 1, sh.data() + 3 * N};
    const Model model(consts, params);
    if (pgas)
      lane_sweep<double, true>(b, n, N, eps, res_u, anc_u, x_star, x0, w0, model, xs, log_ws,
                               anc, sh.data(), sh.data() + N, sh.data() + 2 * N, &a0);
    else
      lane_sweep<double, false>(b, n, N, eps, res_u, anc_u, x_star, x0, w0, model, xs, log_ws,
                                anc, sh.data(), sh.data() + N, sh.data() + 2 * N, &a0);
  }
}
#define HOST_LANE(NAME, MODEL)                                                               \
  extern "C" void h_lane_##NAME(int n, int N, int pgas, const double* eps,                   \
      const double* res_u, const double* anc_u, const double* x_star, const double* x0,      \
      const double* w0, const double* consts, const double* params, double* xs,              \
      double* log_ws, long long* anc) {                                                      \
    host_lane<csmc::MODEL<double>>(n, N, pgas, eps, res_u, anc_u, x_star, x0, w0, consts,    \
                                   params, xs, log_ws, anc);                                 \
  }                                                                                          \
  /* The chain-batched launch: chain c (a block in turn) on LaneIO::chain(c). */             \
  extern "C" void h_lane_chains_##NAME(int C, int n, int N, int pgas, const double* eps,     \
      const double* res_u, const double* anc_u, const double* x_star, const double* x0,      \
      const double* w0, const double* consts, const double* params, double* xs,              \
      double* log_ws, long long* anc) {                                                      \
    const LaneIO<double, csmc::MODEL<double>> all{eps, res_u, anc_u, x_star, x0, w0, consts, \
                                                  params, xs, log_ws, anc};                  \
    for (int c = 0; c < C; ++c) {                                                            \
      const auto io = all.chain(c, n, N);                                                    \
      host_lane<csmc::MODEL<double>>(n, N, pgas, io.eps, io.res_u, io.anc_u, io.x_star,      \
                                     io.x0, io.w0, io.consts, io.params, io.xs, io.log_ws,   \
                                     io.anc);                                                \
    }                                                                                        \
  }
HOST_LANE(theta_logistic, ThetaLogistic)
HOST_LANE(rare_event_guided, RareEventGuided)
HOST_LANE(rare_event_bootstrap, RareEventBootstrap)
HOST_LANE(ar1_gauss, Ar1Gauss)
"""


_STITCHING = """
#include <vector>
#include "stitching.cu"
using namespace stitch;
// Each kernel's rows, one "thread" (a whole block in turn) at a time, at the
// widest feature bound.
extern "C" {
void h_counter_uniform(int n, const int* seed, const int* pair, const int* block, const int* row,
                       const int* col, float* out) {
  for (int i = 0; i < n; ++i)
    out[i] = counter_uniform((uint32_t)seed[i], (uint32_t)pair[i], (uint32_t)block[i],
                             (uint32_t)row[i], (uint32_t)col[i]);
}
// row_lse by its launch plan for `sms` SMs (plan[] = G, R, RS, NPB, TC),
// through the kernel's width and row dispatch: each block's threads in turn,
// phase by phase, the shuffle butterfly on the threads' pairs. A plan whose
// tile holds fewer than kLseChunk columns is refused, as the launch refuses
// it.
void h_row_lse(int P, int nr, int nc, int k, int sms, const double* rf, const double* cf,
               const double* cb, double* out, int* plan) {
  const LsePlan pl = lse_plan(P, nr, nc, k, sizeof(double), sms);
  plan[0] = pl.G, plan[1] = pl.R, plan[2] = pl.RS, plan[3] = pl.NPB, plan[4] = pl.TC;
  if (pl.TC < kLseChunk) return;
  std::vector<double> sh(lse_smem_values(pl));
  with_width(k, [&](auto Kc) {
    with_lse_rows(pl.R, [&](auto Rc) {
      constexpr int K = decltype(Kc)::value, R = decltype(Rc)::value;
      static LseRows<double, R> th[kLseThreads];
      double m2[kLseThreads], a2[kLseThreads];
      for (int by = 0; by < (P + pl.NPB - 1) / pl.NPB; ++by)
        for (int bx = 0; bx < (nr + pl.RB - 1) / pl.RB; ++bx) {
          for (int t = 0; t < kLseThreads; ++t) lse_rows<double, R>(t, pl, bx, by, P, nr, th[t]);
          lse_stage_rows<double>(0, 1, pl, bx, by, P, nr, k, rf, sh.data());
          for (int j0 = 0; j0 < nc; j0 += pl.TC) {
            const int nt = nc - j0 < pl.TC ? nc - j0 : pl.TC;
            lse_stage_cols<double>(0, 1, pl, by, P, j0, nt, nc, k, cf, cb, sh.data());
            for (int t = 0; t < kLseThreads; ++t)
              if (th[t].live[0]) lse_tile<double, K, R>(pl, nt, k, sh.data(), th[t]);
          }
          for (int rr = 0; rr < R; ++rr) {
            for (int o = 1; o < pl.G; o *= 2) {
              for (int t = 0; t < kLseThreads; ++t)
                m2[t] = th[t ^ o].m[rr], a2[t] = th[t ^ o].a[rr];
              for (int t = 0; t < kLseThreads; ++t)
                lse_merge(th[t].m[rr], th[t].a[rr], m2[t], a2[t]);
            }
            for (int t = 0; t < kLseThreads; ++t)
              if (th[t].live[rr] && th[t].g == 0)
                out[(long)th[t].p * nr + th[t].i0 + th[t].rs + rr * pl.RS] =
                    lse_value(th[t].m[rr], th[t].a[rr]);
          }
        }
    });
  });
}
// col_sample on row_lse's plan (plan[] as h_row_lse's), through the
// kernel's width and row dispatch: each block's threads in turn, phase by
// phase, the shuffle butterfly on the threads' partials (col_merge).
void h_col_sample_chains(int P, int n, int nc, int k, int sms, const int* seeds,
                         int chain_pairs, int pair_offset, const double* rf, const double* cf,
                         const double* cb, long long* out, int* plan);
void h_col_sample(int P, int n, int nc, int k, int sms, int seed, int pair_offset,
                  const double* rf, const double* cf, const double* cb, long long* out,
                  int* plan) {
  h_col_sample_chains(P, n, nc, k, sms, &seed, P, pair_offset, rf, cf, cb, out, plan);
}
// The chain axis: the P pairs are C chains' chain_pairs each, chain c's with
// seeds[c] and its pairs counted within the chain (chain_of, as the kernel).
void h_col_sample_chains(int P, int n, int nc, int k, int sms, const int* seeds,
                         int chain_pairs, int pair_offset, const double* rf, const double* cf,
                         const double* cb, long long* out, int* plan) {
  const LsePlan pl = lse_plan(P, n, nc, k, sizeof(double), sms);
  plan[0] = pl.G, plan[1] = pl.R, plan[2] = pl.RS, plan[3] = pl.NPB, plan[4] = pl.TC;
  if (pl.TC < kLseChunk) return;
  std::vector<double> sh(lse_smem_values(pl));
  with_width(k, [&](auto Kc) {
    with_lse_rows(pl.R, [&](auto Rc) {
      constexpr int K = decltype(Kc)::value, R = decltype(Rc)::value;
      static LseRows<double, R> th[kLseThreads];
      static ColRows<double, R> cr[kLseThreads];
      double g2[kLseThreads];
      int j2[kLseThreads];
      for (int by = 0; by < (P + pl.NPB - 1) / pl.NPB; ++by)
        for (int bx = 0; bx < (n + pl.RB - 1) / pl.RB; ++bx) {
          for (int t = 0; t < kLseThreads; ++t) {
            lse_rows<double, R>(t, pl, bx, by, P, n, th[t]);
            const int c = chain_of(th[t].p, P, chain_pairs);
            col_rows<double, R>(pl, th[t], (uint32_t)seeds[c], pair_offset - c * chain_pairs,
                                cr[t]);
          }
          lse_stage_rows<double>(0, 1, pl, bx, by, P, n, k, rf, sh.data());
          for (int j0 = 0; j0 < nc; j0 += pl.TC) {
            const int nt = nc - j0 < pl.TC ? nc - j0 : pl.TC;
            lse_stage_cols<double>(0, 1, pl, by, P, j0, nt, nc, k, cf, cb, sh.data());
            for (int t = 0; t < kLseThreads; ++t)
              if (th[t].live[0]) col_tile<double, K, R>(pl, j0, nt, k, sh.data(), th[t], cr[t]);
          }
          for (int rr = 0; rr < R; ++rr) {
            for (int o = 1; o < pl.G; o *= 2) {
              for (int t = 0; t < kLseThreads; ++t)
                g2[t] = cr[t ^ o].best[rr], j2[t] = cr[t ^ o].arg[rr];
              for (int t = 0; t < kLseThreads; ++t)
                col_merge(cr[t].best[rr], cr[t].arg[rr], g2[t], j2[t]);
            }
            for (int t = 0; t < kLseThreads; ++t)
              if (th[t].live[rr] && th[t].g == 0)
                out[(long)th[t].p * n + th[t].i0 + th[t].rs + rr * pl.RS] =
                    col_pick(cr[t].arg[rr]);
          }
        }
    });
  });
}
// col_sample's butterfly on G hand-made partials (g[l], j[l]; j < 0: no
// column yet), as a row's G threads run it: out[l] the column thread l
// picks.
void h_col_sample_merge(int G, const double* g, const int* j, long long* out) {
  double best[32], g2[32];
  int arg[32], j2[32];
  for (int l = 0; l < G; ++l) best[l] = g[l], arg[l] = j[l] < 0 ? kNoCol : j[l];
  for (int o = 1; o < G; o *= 2) {
    for (int l = 0; l < G; ++l) g2[l] = best[l ^ o], j2[l] = arg[l ^ o];
    for (int l = 0; l < G; ++l) col_merge(best[l], arg[l], g2[l], j2[l]);
  }
  for (int l = 0; l < G; ++l) out[l] = col_pick(arg[l]);
}
void h_lse_plan(int P, int nr, int nc, int k, int elem_bytes, int sms, int* out) {
  const LsePlan pl = lse_plan(P, nr, nc, k, elem_bytes, sms);
  out[0] = pl.G, out[1] = pl.R, out[2] = pl.RS, out[3] = pl.NPB, out[4] = pl.TC;
}
void h_mass_plan(int P, int nr, int nc, int k, int elem_bytes, int sms, int* out) {
  const MassPlan plan = mass_plan(P, nr, nc, k, elem_bytes, sms);
  out[0] = plan.R;
  out[1] = plan.whole;
}
}
// block_masses through the kernel's own width and row dispatch: rows in
// groups of R (the last one ragged), one "thread" of one; `cols` holds the
// whole node's column records or one block's. used[0] = the R that ran.
template <typename S>
static void host_block_masses(int P, int nr, int nc, int k, int per_block_max, int R, int whole,
                              const S* rf, const S* cf, const S* cb, S* out, S* cols, int* used) {
  with_width(k, [&](auto Kc) {
    constexpr int K = decltype(Kc)::value;
    with_rows<K>(R, [&](auto Rc) {
      constexpr int RR = decltype(Rc)::value;
      used[0] = RR;
      for (int p = 0; p < P; ++p)
        for (int row0 = 0; row0 < nr; row0 += RR) {
          if (per_block_max)
            block_masses_rows<S, K, RR, true>(0, 1, p, row0, nr, nc, k, whole != 0, rf, cf, cb,
                                              out, cols);
          else
            block_masses_rows<S, K, RR, false>(0, 1, p, row0, nr, nc, k, whole != 0, rf, cf, cb,
                                               out, cols);
        }
    });
  });
}
#define HOST_MASSES(SUFFIX, S)                                                                \
  extern "C" void h_block_masses_##SUFFIX(int P, int nr, int nc, int k, int per_block_max,   \
      int R, int whole, const S* rf, const S* cf, const S* cb, S* out, S* cols, int* used) {  \
    host_block_masses<S>(P, nr, nc, k, per_block_max, R, whole, rf, cf, cb, out, cols, used); \
  }
HOST_MASSES(f32, float)
HOST_MASSES(f64, double)
// The draws, float and double, through the kernel's width dispatch: each
// node's row CDF by one "warp", then its draws in turn, each by one warp
// whose 32 lanes run in turn. The chain axis as the kernels take it: node
// p's seed and pair offset by chain_pair (chain_pairs = P: one seed).
template <typename S>
static void host_stitch_draws(int P, int N, int k, const int* seeds, int chain_pairs,
                              int pair_offset, const S* rl, const S* u, const S* Lb, const S* rf,
                              const S* cf, const S* cb, long long* rows, long long* cols) {
  static S ic[kMaxNb * kRows], cdf[kMaxNb], pre[kMaxNb + 1], red[1], buf[kWarp * (kMaxK | 1)];
  with_width(k, [&](auto Kc) {
    constexpr int K = decltype(Kc)::value;
    for (int p = 0; p < P; ++p) {
      int offset;
      const uint32_t s = chain_pair(p, P, chain_pairs, seeds, pair_offset, &offset);
      node_row_cdf<S>(0, 1, N, rl + (long)p * N, ic, cdf, pre, red);
      for (int i = 0; i < N; ++i)
        stitch_draw<S, K>(p, i, N, k, s, offset, u, Lb, rf, cf, cb, ic, cdf, pre, buf,
                          (int64_t*)rows, (int64_t*)cols);
    }
  });
}
template <typename S>
static void host_within_block_cols(int P, int n, int nc, int k, const int* seeds,
                                   int chain_pairs, int pair_offset, const long long* blocks,
                                   const S* rf_sel, const S* cf, const S* cb, long long* out) {
  static S buf[kWarp * (kMaxK | 1)];
  with_width(k, [&](auto Kc) {
    constexpr int K = decltype(Kc)::value;
    for (int p = 0; p < P; ++p) {
      int offset;
      const uint32_t s = chain_pair(p, P, chain_pairs, seeds, pair_offset, &offset);
      for (int i = 0; i < n; ++i)
        within_block_col<S, K>(p, i, n, nc, k, s, offset, (const int64_t*)blocks, rf_sel, cf,
                               cb, buf, (int64_t*)out);
    }
  });
}
#define HOST_DRAWS(SUFFIX, S)                                                                 \
  extern "C" void h_stitch_draws_##SUFFIX(int P, int N, int k, int seed, int pair_offset,     \
      const S* rl, const S* u, const S* Lb, const S* rf, const S* cf, const S* cb,            \
      long long* rows, long long* cols) {                                                     \
    host_stitch_draws<S>(P, N, k, &seed, P, pair_offset, rl, u, Lb, rf, cf, cb, rows, cols);  \
  }                                                                                           \
  extern "C" void h_stitch_draws_chains_##SUFFIX(int P, int N, int k, const int* seeds,       \
      int chain_pairs, int pair_offset, const S* rl, const S* u, const S* Lb, const S* rf,    \
      const S* cf, const S* cb, long long* rows, long long* cols) {                           \
    host_stitch_draws<S>(P, N, k, seeds, chain_pairs, pair_offset, rl, u, Lb, rf, cf, cb,     \
                         rows, cols);                                                         \
  }                                                                                           \
  extern "C" void h_within_block_cols_##SUFFIX(int P, int n, int nc, int k, int seed,         \
      int pair_offset, const long long* blocks, const S* rf_sel, const S* cf, const S* cb,    \
      long long* out) {                                                                       \
    host_within_block_cols<S>(P, n, nc, k, &seed, P, pair_offset, blocks, rf_sel, cf, cb,     \
                              out);                                                           \
  }                                                                                           \
  extern "C" void h_within_block_cols_chains_##SUFFIX(int P, int n, int nc, int k,            \
      const int* seeds, int chain_pairs, int pair_offset, const long long* blocks,            \
      const S* rf_sel, const S* cf, const S* cb, long long* out) {                            \
    host_within_block_cols<S>(P, n, nc, k, seeds, chain_pairs, pair_offset, blocks, rf_sel,   \
                              cf, cb, out);                                                   \
  }
HOST_DRAWS(f32, float)
HOST_DRAWS(f64, double)
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources as host code")
    out = tmp_path_factory.mktemp("csrc_host")
    libs = {}
    for name, body in (("maps", _PRELUDE + _MAPS),
                       ("scan", _PRELUDE + _SCAN),
                       ("csmc_fwd", _CSMC_PRELUDE + _CSMC_FWD),
                       ("scalar_scan", _PRELUDE + _SCALAR_SCAN),
                       ("csmc_block", _CSMC_PRELUDE + _CSMC_BLOCK),
                       ("csmc_lane", _CSMC_PRELUDE + _CSMC_LANE),
                       ("stitching", _PRELUDE + _STITCHING)):
        src = out / f"{name}.cpp"
        src.write_text(body)
        so = out / f"lib{name}.so"
        subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(CSRC),
                        "-o", str(so), str(src)], check=True, capture_output=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _call(fn, *args):
    c_args = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
              else ctypes.c_int(int(a)) for a in args]
    fn(*c_args)


def _model(T, dx, dy, seed, nan_frac=0.0, nan_model=False, stable=False):
    """A random LGSSM and its observations, a share `nan_frac` of them
    missing (NaN); with `nan_model`, also H, R and c NaN on the missing rows
    and step 1 missing whole; with `stable`, F scaled as in
    tests/test_torch_cuda.py, so that it stays stable at large dx."""
    from oracles import random_lgssm, simulate
    rng = np.random.default_rng(seed)
    params = list(random_lgssm(rng, T, dx, dy))
    if stable:
        params[2] = params[2] * min(1.0, 2.0 / np.sqrt(dx))
    ys = simulate(rng, *params)
    if nan_frac:
        ys = np.where(rng.uniform(size=ys.shape) < nan_frac, np.nan, ys)
    if nan_model:
        ys[1] = np.nan
        miss = np.isnan(ys)
        H, R, c = (np.array(z) for z in params[5:8])
        H[miss] = np.nan
        R[miss] = np.nan
        R.transpose(0, 2, 1)[miss] = np.nan
        c[miss] = np.nan
        params[5:8] = H, R, c
    return LGSSM(*(torch.as_tensor(z) for z in params)), torch.as_tensor(ys)


def _close(got, want, rtol=1e-9, atol=1e-11):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol, atol=atol)


# The elements, ell and logdensity steps pad dx, dy to the instance's D: at
# D = 16 d = 16 exactly (the main path's), dx = 16 over padded observation
# rows (dy = 5), d = 1, dy < dx and dy > dx, n = 1 and n = 2; at D = 32
# (16 < max(dx, dy)) the SV model's d = 30, the edges 17 and 32 and dx != dy
# padded on either side; at D = 48 (32 < max(dx, dy), float32 only on the
# card) the SV width d = 40, the edges 33 and 48 on either side of dx != dy,
# dy > 32 over dx = 3; missing observations on every masking branch (NaN
# y; H, R, c NaN where y is; a step missing whole, whose ell increment is 0).
@pytest.mark.parametrize("T,dx,dy,nan_frac,nan_model", [
    (23, 2, 2, 0.0, False), (64, 4, 3, 0.3, False), (40, 3, 1, 0.0, False),
    (40, 16, 16, 0.2, True), (30, 1, 1, 0.3, False), (2, 3, 2, 0.0, False),
    (3, 5, 2, 0.5, True), (20, 2, 5, 0.4, True), (24, 16, 5, 0.0, False),
    (24, 16, 5, 0.3, True),
    (10, 30, 30, 0.0, False), (10, 30, 30, 0.3, True), (8, 17, 30, 0.0, False),
    (8, 17, 30, 0.3, True), (8, 32, 32, 0.0, False), (8, 32, 32, 0.2, True),
    (8, 30, 17, 0.0, False), (8, 30, 17, 0.4, True),
    (6, 40, 40, 0.0, False), (6, 40, 40, 0.2, True), (5, 33, 48, 0.0, False),
    (5, 48, 7, 0.0, False), (6, 3, 41, 0.2, False)])
def test_host_maps_match_plain(host_lib, T, dx, dy, nan_frac, nan_model):
    lib = host_lib["maps"]
    lg, ys = _model(T, dx, dy, seed=T, nan_frac=nan_frac, nan_model=nan_model, stable=True)
    m0, P0, Fs, Qs, bs, Hs, Rs, cs = lg
    n = T - 1
    obs = (Hs[1:].contiguous(), Rs[1:].contiguous(), cs[1:].contiguous(), ys[1:].contiguous())

    m0u, P0u, _ = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])
    m = torch.cat([m0u[None], torch.zeros(n - 1, dx, dtype=torch.float64)])
    P = torch.cat([P0u[None], torch.zeros(n - 1, dx, dx, dtype=torch.float64)])
    want = KF.make_elements_plain(Fs, Qs, bs, *obs, m, P)
    got = tuple(torch.empty_like(w) for w in want)
    _call(lib.h_make_elements, n, 1, 0, dx, dy, Fs, Qs, bs, *obs, m, P, *got)
    for g, w in zip(got, want):
        _close(g, w)

    ms, Ps, _ = filtering(ys, lg, parallel=True)
    ms0, Ps0 = ms[:-1].contiguous(), Ps[:-1].contiguous()
    want = KF.ell_plain(Fs, Qs, bs, *obs, ms0, Ps0)
    got = torch.empty_like(want)
    _call(lib.h_ell, n, 1, 0, dx, dy, Fs, Qs, bs, *obs, ms0, Ps0, got)
    _close(got, want)
    if nan_model:  # step 0 of the maps (y_1) is missing whole
        assert float(got[0]) == 0.0 == float(want[0])

    eps = torch.as_tensor(np.random.default_rng(1).standard_normal((n, dx)))
    want = KF.backward_maps_plain(Fs, Qs, bs, ms0, Ps0, eps)
    got = tuple(torch.empty_like(w) for w in want)
    _call(lib.h_backward_maps, n, 1, 0, dx, Fs, Qs, bs, ms0, Ps0, eps, *got)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-7, atol=1e-9)  # jittered Cholesky of a near-singular cov

    xs = torch.as_tensor(np.random.default_rng(2).standard_normal((T, dx)))
    xp, xc = xs[:-1].contiguous(), xs[1:].contiguous()
    want = KF.logdensity_steps_plain(Fs, Qs, bs, *obs, xp, xc)
    got = torch.empty_like(want)
    _call(lib.h_logdensity_steps, n, 1, 0, dx, dy, Fs, Qs, bs, *obs, xp, xc, got)
    _close(got, want)


def test_host_elements_huge_observation_variance(host_lib):
    """The Lorenz proposal's shape (dx = 3, the u rows stacked on two data
    rows, dy = 5) with R = 1e160 on the u rows and the data rows missing:
    a 2 x 2 pivot block of S then holds two diagonal entries whose product
    overflows float64 (as R = 5e19 does float32 at delta = 1e20). Every
    output, J's u-row part and eta included (each ~1e-160 here), must equal
    the plain version's to rtol 1e-9 with no absolute slack."""
    lib = host_lib["maps"]
    T, dx, dy, big = 12, 3, 5, 1e160
    lg, ys = _model(T, dx, dy, seed=7, stable=True)
    m0, P0, Fs, Qs, bs, Hs, Rs, cs = lg
    Hs, Rs, cs, ys = (z.clone() for z in (Hs, Rs, cs, ys))
    Hs[:, :3] = torch.eye(3, dtype=torch.float64)
    Rs[:, :3] = 0.0
    Rs[:, :, :3] = 0.0
    Rs[:, :3, :3] = big * torch.eye(3, dtype=torch.float64)
    cs[:, :3] = 0.0
    ys[:, :3] = big ** 0.5 * ys[:, :3]
    ys[1:, 3:] = float("nan")
    n = T - 1
    obs = (Hs[1:].contiguous(), Rs[1:].contiguous(), cs[1:].contiguous(), ys[1:].contiguous())
    m0u, P0u, _ = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])
    m = torch.cat([m0u[None], torch.zeros(n - 1, dx, dtype=torch.float64)])
    P = torch.cat([P0u[None], torch.zeros(n - 1, dx, dx, dtype=torch.float64)])
    want = KF.make_elements_plain(Fs, Qs, bs, *obs, m, P)
    got = tuple(torch.empty_like(w) for w in want)
    _call(lib.h_make_elements, n, 1, 0, dx, dy, Fs, Qs, bs, *obs, m, P, *got)
    assert float(want[4][1:].abs().max()) < 1e-150  # J: the u rows alone
    for g, w in zip(got, want):
        _close(g, w, atol=0.0)


@pytest.mark.parametrize("case", ["zero_cov", "not_pd"])
def test_host_backward_maps_degenerate_covariance(host_lib, case):
    """backward_maps where the conditional covariance is degenerate (n = 8,
    dx = 3). zero_cov: step 3 has P = 0, so cov is exactly 0 (trace 0, no
    jitter): its gain is 0, its factor all zero and its increment m exactly,
    as the plain version gives. not_pd: F = 0.9 I, Q = I, P = diag(1, 0.5,
    -0.3), whose cov is not positive definite past column 1: the kernel
    follows the column-order Cholesky of JAX's Pallas kernel (run in
    interpret mode), whose columns before the failing pivot keep their
    noise."""
    rng = np.random.default_rng(11)
    n, dx = 8, 3
    b, m, eps = (torch.as_tensor(rng.standard_normal((n, dx))) for _ in range(3))
    if case == "zero_cov":
        A = rng.standard_normal((n, dx, dx))
        P = torch.as_tensor(A @ A.transpose(0, 2, 1) / dx + 0.1 * np.eye(dx))
        P[3] = 0.0
        F = torch.as_tensor(0.5 * rng.standard_normal((n, dx, dx)))
        B = rng.standard_normal((n, dx, dx))
        Q = torch.as_tensor(B @ B.transpose(0, 2, 1) / dx + 0.5 * np.eye(dx))
    else:
        eye = torch.eye(dx, dtype=torch.float64).expand(n, dx, dx)
        F, Q = 0.9 * eye, eye.clone()
        P = torch.diag_embed(torch.tensor([1.0, 0.5, -0.3], dtype=torch.float64)).expand(n, dx, dx)
    args = tuple(z.contiguous() for z in (F, Q, b, m, P, eps))
    G, inc = torch.empty_like(args[0]), torch.empty_like(args[2])
    _call(host_lib["maps"].h_backward_maps, n, 1, 0, dx, *args, G, inc)
    if case == "zero_cov":
        want = KF.backward_maps_plain(*args)
        for g, w in zip((G, inc), want):
            _close(g, w, rtol=1e-7, atol=1e-9)
        assert not bool(G[3].any()) and torch.equal(inc[3], m[3]) and torch.equal(want[1][3], m[3])
    else:
        import jax.numpy as jnp
        from aux_ssm_tpu.ops.pallas.kalman_fused import fused_backward_maps
        want = fused_backward_maps(*(jnp.asarray(z.numpy()) for z in args), interpret=True)
        for g, w in zip((G, inc), want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


# T - 1 = n elements in the kernel's scan_plan(n) chunks of ceil(n / chunks): one
# chunk (n = 1), an empty last chunk and n not a multiple of the chunk (n =
# 9, 299), d = 1 and d = 16, the main path's n = 1023 (128 chunks of 8) at a
# small d, and chunks longer than the prefixes the kernel keeps (n = 1100: 9);
# the D = 32 instance at n = 2, the SV model's n = 249 (64 chunks of 4) and
# n = 1023 (past f64's one kept prefix: later ones staged back from the
# output), d = 30, 17 and 32 (F scaled to stay stable there); the D = 48
# instance (one kept prefix, one input slot) at the SV shape n = 127 (32
# chunks of 4), d = 40, and at the edges d = 33 and 48 (n = 2, 20).
@pytest.mark.parametrize("T,dx,dy", [(17, 2, 2), (300, 3, 2), (129, 1, 1), (2, 2, 2),
                                     (10, 3, 2), (40, 16, 16), (1024, 2, 1), (1101, 1, 1),
                                     (3, 30, 30), (250, 30, 30), (250, 17, 5), (1024, 32, 32),
                                     (128, 40, 40), (3, 33, 48), (21, 48, 7)])
def test_host_filter_scan_matches_plain(host_lib, T, dx, dy):
    lg, ys = _model(T, dx, dy, seed=3, stable=dx > 16)
    m0, P0, Fs, Qs, bs, Hs, Rs, cs = lg
    m0u, P0u, _ = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])
    elems = tuple(z.contiguous() for z in _make_associative_elements(
        Fs, Qs, bs, Hs[1:], Rs[1:], cs[1:], ys[1:], m0u, P0u))
    want = FS.filter_scan_plain(elems)
    got = tuple(torch.empty_like(z) for z in elems)
    _call(host_lib["scan"].h_filter_scan, T - 1, 1, dx, *elems, *got)
    for g, w in zip(got, want):
        _close(g, w)


# n elements in the kernel's scan_plan(n) chunks of ceil(n / chunks),
# forward and reversed: the main path's n = 1024 at d = 16, d = 1, one chunk
# (n = 1, 2), an empty chunk and n not a multiple of the chunk (n = 9, 37,
# 50), chunks longer than the prefixes the kernel keeps (n = 1100: 9); the
# D = 32 instance at n = 2, 249 and 1023, d = 30, 17 and 32; the D = 48
# instance at n = 128 (d = 40), 2 and 50 (d = 48, 33). The gains are
# 0.4 standard normals, scaled by 2 / sqrt(d) past d = 4 so that their
# products stay of one size at large d.
@pytest.mark.parametrize("T,d,reverse", [(50, 3, True), (300, 2, True), (100, 4, False),
                                         (1024, 16, True), (1024, 16, False), (37, 1, True),
                                         (1, 2, False), (2, 1, True), (9, 3, False),
                                         (1100, 2, True), (2, 30, True), (249, 30, True),
                                         (249, 17, False), (1023, 32, True),
                                         (128, 40, True), (2, 48, True), (50, 33, False)])
def test_host_affine_scan_matches_plain(host_lib, T, d, reverse):
    rng = np.random.default_rng(1)
    gains = torch.as_tensor(0.4 * min(1.0, 2.0 / np.sqrt(d)) * rng.standard_normal((T, d, d)))
    incs = torch.as_tensor(rng.standard_normal((T, d)))
    want = FS.affine_scan_plain(gains, incs, reverse=reverse)
    got = tuple(torch.empty_like(z) for z in want)
    _call(host_lib["scan"].h_affine_scan, T, 1, d, reverse, gains, incs, *got)
    for g, w in zip(got, want):
        _close(g, w)


# The chain axis of rows 1, 4, 5 and 7 (the dense batched layout): 3 chains'
# steps in one call, a block a (step, chain) pair, F, Q and b shared (their
# bits set in the call's `shared` mask: the (n, ...) arrays, read once for
# every chain), the rest (n, C, ...). Each chain equals a one-chain call on
# its inputs bit for bit, C = 1 equals the one-chain call, the shared
# operands equal the same operands copied to every chain, and the outputs
# equal the plain versions on the (n, C, ...) layout (they broadcast the
# shared operands) to rtol 1e-9. At D = 16 (dx = 3, dy = 2, a share of the
# observations missing), D = 32 (d = 30) and D = 48 (d = 40 with a share
# missing, dx = 33 under dy = 48, dx = 48 over dy = 7, dy = 41 over dx = 3).
@pytest.mark.parametrize("T,dx,dy,nan_frac", [(9, 3, 2, 0.3), (5, 30, 30, 0.0),
                                              (4, 40, 40, 0.2), (3, 33, 48, 0.0),
                                              (3, 48, 7, 0.0), (3, 3, 41, 0.0)])
def test_host_maps_chain_axis(host_lib, T, dx, dy, nan_frac):
    lib = host_lib["maps"]
    Cc, n, shared = 3, T - 1, 0b111
    models = [_model(T, dx, dy, seed=T + c, nan_frac=nan_frac, stable=True) for c in range(Cc)]
    Fs, Qs, bs = (z.contiguous() for z in models[0][0][2:5])
    rng = np.random.default_rng(T)
    per_chain = []  # each chain's (H, R, c, y, m, P, ms, Ps, eps, xp, xc), (n, ...)
    for lg, ys in models:
        lg = lg._replace(Fs=Fs, Qs=Qs, bs=bs)
        m0u, P0u, _ = kalman_update(ys[0], lg.m0, lg.P0, lg.Hs[0], lg.cs[0], lg.Rs[0])
        m = torch.cat([m0u[None], torch.zeros(n - 1, dx, dtype=torch.float64)])
        P = torch.cat([P0u[None], torch.zeros(n - 1, dx, dx, dtype=torch.float64)])
        ms, Ps, _ = filtering(ys, lg, parallel=True)
        xs = torch.as_tensor(rng.standard_normal((T, dx)))
        per_chain.append(tuple(z.contiguous() for z in (
            lg.Hs[1:], lg.Rs[1:], lg.cs[1:], ys[1:], m, P, ms[:-1], Ps[:-1],
            torch.as_tensor(rng.standard_normal((n, dx))), xs[:-1], xs[1:])))
    stacked = tuple(torch.stack(z, 1).contiguous() for z in zip(*per_chain))
    copied = tuple(z[:, None].expand((n, Cc) + z.shape[1:]).contiguous() for z in (Fs, Qs, bs))

    def run(fn, C, mask, shared_args, args, outs):
        got = tuple(torch.empty((n, C) + o if C else (n,) + o, dtype=torch.float64)
                    for o in outs)
        _call(fn, n, max(C, 1), mask, dx, *(() if fn is lib.h_backward_maps else (dy,)),
              *shared_args, *args, *got)
        return got

    H, R, c, y, m, P, ms, Ps, eps, xp, xc = range(11)
    cases = (  # entry, its per-chain inputs, its outputs' trailing shapes, plain version
        (lib.h_make_elements, (H, R, c, y, m, P), ((dx, dx), (dx,), (dx, dx), (dx,), (dx, dx)),
         KF.make_elements_plain),
        (lib.h_ell, (H, R, c, y, ms, Ps), ((),), KF.ell_plain),
        (lib.h_backward_maps, (ms, Ps, eps), ((dx, dx), (dx,)), KF.backward_maps_plain),
        (lib.h_logdensity_steps, (H, R, c, y, xp, xc), ((),), KF.logdensity_steps_plain))
    for fn, which, outs, plain in cases:
        chained = run(fn, Cc, shared, (Fs, Qs, bs), [stacked[i] for i in which], outs)
        for k in range(Cc):
            one = run(fn, 0, 0, (Fs, Qs, bs), [per_chain[k][i] for i in which], outs)
            for g, w in zip(chained, one):
                assert torch.equal(g[:, k], w), (fn.__name__, k)
            if k == 0:
                first = run(fn, 1, 0, (Fs, Qs, bs),
                            [stacked[i][:, :1].contiguous() for i in which], outs)
                assert all(torch.equal(g[:, 0], w) for g, w in zip(first, one)), fn.__name__
        full = run(fn, Cc, 0, copied, [stacked[i] for i in which], outs)
        assert all(torch.equal(g, w) for g, w in zip(full, chained)), fn.__name__
        views = tuple(z[:, None].expand((n, Cc) + z.shape[1:]) for z in (Fs, Qs, bs))
        want = plain(*views, *[stacked[i] for i in which])
        for g, w in zip(chained, want if isinstance(want, tuple) else (want,)):
            _close(g, w, rtol=1e-7 if fn is lib.h_backward_maps else 1e-9,
                   atol=1e-9 if fn is lib.h_backward_maps else 1e-11)


# The chain axis of both scans (rows 2-3 and 6): 3 chains' elements laid out
# (n, C, ...) in one call, each chain's scan on its own hand-over rows: each
# chain equals a one-chain call on its elements bit for bit, and all equal
# the plain versions on the (n, C, ...) layout (the same chunks, batched over
# C) to rtol 1e-9. The filter scan at D = 16 (n = 8 and n = 1099, chunks
# longer than the 8 kept prefixes), D = 32 (d = 30, f64's one kept prefix)
# and D = 48 (d = 40, 33 and 48: one kept prefix, one input slot); the
# affine scan forward and reversed.
@pytest.mark.parametrize("T,d", [(9, 3), (1100, 1), (6, 30), (10, 40), (6, 33), (5, 48)])
def test_host_scans_chain_axis(host_lib, T, d):
    lib = host_lib["scan"]
    Cc, n = 3, T - 1
    chains = []
    for k in range(Cc):
        lg, ys = _model(T, d, d, seed=5 + k, stable=d > 16)
        m0u, P0u, _ = kalman_update(ys[0], lg.m0, lg.P0, lg.Hs[0], lg.cs[0], lg.Rs[0])
        chains.append(tuple(z.contiguous() for z in _make_associative_elements(
            lg.Fs, lg.Qs, lg.bs, lg.Hs[1:], lg.Rs[1:], lg.cs[1:], ys[1:], m0u, P0u)))
    elems = tuple(torch.stack(z, 1).contiguous() for z in zip(*chains))
    got = tuple(torch.empty_like(z) for z in elems)
    _call(lib.h_filter_scan, n, Cc, d, *elems, *got)
    for k, one in enumerate(chains):
        want = tuple(torch.empty_like(z) for z in one)
        _call(lib.h_filter_scan, n, 1, d, *one, *want)
        assert all(torch.equal(g[:, k], w) for g, w in zip(got, want)), k
    for g, w in zip(got, FS.filter_scan_plain(elems)):
        _close(g, w)

    rng = np.random.default_rng(d)
    gains = torch.as_tensor(0.4 * min(1.0, 2.0 / np.sqrt(d)) * rng.standard_normal((n, Cc, d, d)))
    incs = torch.as_tensor(rng.standard_normal((n, Cc, d)))
    for reverse in (False, True):
        got = (torch.empty_like(gains), torch.empty_like(incs))
        _call(lib.h_affine_scan, n, Cc, d, reverse, gains, incs, *got)
        for k in range(Cc):
            one = (gains[:, k].contiguous(), incs[:, k].contiguous())
            want = tuple(torch.empty_like(z) for z in one)
            _call(lib.h_affine_scan, n, 1, d, reverse, *one, *want)
            assert all(torch.equal(g[:, k], w) for g, w in zip(got, want)), (reverse, k)
        for g, w in zip(got, FS.affine_scan_plain(gains, incs, reverse=reverse)):
            _close(g, w)


# The plan the kernel takes from n is the one the plain versions and the
# hand-over buffer take (FS.scan_chunks), and the padded element's size at
# each instance's D the one the buffer is sized by (FS.SLOTS, by the D that
# instance_dim picks).
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 9, 37, 299, 511, 512, 513, 1023, 1024, 1100, 5000])
def test_host_scan_plan_matches_the_wrappers(host_lib, n):
    out = torch.zeros(9, dtype=torch.int32)
    _call(host_lib["scan"].h_scan_layout, n, out)
    chunks = FS.scan_chunks(n)
    assert out.tolist() == [chunks, -(-n // chunks), chunks.bit_length() - 1,
                            FS.SLOTS["filter"][16], FS.SLOTS["affine"][16],
                            FS.SLOTS["filter"][32], FS.SLOTS["affine"][32],
                            FS.SLOTS["filter"][48], FS.SLOTS["affine"][48]]
    f32, f64 = torch.float32, torch.float64
    assert [instance_dim(d, f32) for d in (1, 16, 17, 30, 32, 33, 40, 48)] == [
        16, 16, 32, 32, 32, 48, 48, 48]
    assert [instance_dim(d, f64) for d in (1, 16, 17, 32)] == [16, 16, 32, 32]
    with pytest.raises(ValueError):
        instance_dim(49, f32)
    with pytest.raises(ValueError):
        instance_dim(33, f64)


def _factor_inputs(n, N, k, seed):
    rng = np.random.default_rng(seed)
    w0 = rng.uniform(0.1, 1.0, N)
    return tuple(torch.as_tensor(z) for z in (
        0.5 * rng.standard_normal((n, N, k)), 0.5 * rng.standard_normal((n, N, k)),
        rng.standard_normal((n, N)), rng.standard_normal((n, N)), rng.uniform(size=(n, N)),
        rng.uniform(size=n), w0 / w0.sum()))


# N <= 32 runs the pair scores and the one-warp sweep, past it the block sweep.
@pytest.mark.parametrize("n,N,k,pgas", [(23, 32, 2, False), (23, 32, 2, True),
                                        (9, 300, 30, False), (5, 2048, 1, True),
                                        (31, 25, 64, False), (31, 25, 64, True),
                                        (17, 1, 4, True), (17, 32, 8, False)])
def test_host_forward_factor_matches_plain(host_lib, n, N, k, pgas):
    args = _factor_inputs(n, N, k, seed=N + k)
    want_lw, want_anc = CF.forward_factor_scan_plain(*args, pgas=pgas)
    lw, anc = torch.empty(n, N, dtype=torch.float64), torch.empty(n, N, dtype=torch.int64)
    w, cw = torch.empty(N, dtype=torch.float64), torch.empty(N, dtype=torch.float64)
    _call(host_lib["csmc_fwd"].h_forward_factor, n, N, k, pgas, *args, lw, anc, w, cw)
    np.testing.assert_array_equal(anc.numpy(), want_anc.numpy())
    _close(lw, want_lw)


@pytest.mark.parametrize("n,N,k", [(19, 16, 3), (6, 2048, 1), (24, 25, 30), (31, 25, 64),
                                   (17, 1, 4), (17, 32, 8)])
def test_host_backward_factor_matches_plain(host_lib, n, N, k):
    rf, cf, rb, lw, _, us, _ = _factor_inputs(n, N, k, seed=k)
    b_T = torch.tensor(min(3, N - 1), dtype=torch.int64)
    want = CF.backward_factor_scan_plain(rf, cf, rb, lw, us, b_T)
    got = torch.empty(n, dtype=torch.int64)
    w = torch.empty(N, dtype=torch.float64)
    _call(host_lib["csmc_fwd"].h_backward_factor, n, N, k, rf, cf, rb, lw, us, b_T.reshape(1),
          got, w)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# The chain axis (rows 8 and 9 of the kernel table): 3 chains at once through
# the launches' chain offsets, each chain equal to a one-chain call on its
# slice; both paths (N <= 32: the pair scores over the chains' steps, then a
# one-warp sweep a chain; past 32 a block a chain).
@pytest.mark.parametrize("n,N,k,pgas", [(1, 25, 1, False), (5, 25, 3, True), (4, 40, 2, False)])
def test_host_factor_sweeps_chain_axis(host_lib, n, N, k, pgas):
    Cc = 3
    chains = [_factor_inputs(n, N, k, seed=N + k + c) for c in range(Cc)]
    args = tuple(torch.stack(z).contiguous() for z in zip(*chains))
    lw, anc = torch.empty(Cc, n, N, dtype=torch.float64), torch.empty(Cc, n, N, dtype=torch.int64)
    w, cw = torch.empty(N, dtype=torch.float64), torch.empty(N, dtype=torch.float64)
    _call(host_lib["csmc_fwd"].h_forward_factor_chains, Cc, n, N, k, pgas, *args, lw, anc, w, cw)
    rf, cf, rb, cb, _, us, _ = args
    b_T = torch.tensor([0, N - 1, N // 2], dtype=torch.int64)
    picked = torch.empty(Cc, n, dtype=torch.int64)
    _call(host_lib["csmc_fwd"].h_backward_factor_chains, Cc, n, N, k, rf, cf, rb, cb, us, b_T,
          picked, w)
    for c, one in enumerate(chains):
        want_lw, want_anc = CF.forward_factor_scan_plain(*one, pgas=pgas)
        np.testing.assert_array_equal(anc[c].numpy(), want_anc.numpy())
        _close(lw[c], want_lw)
        want = CF.backward_factor_scan_plain(one[0], one[1], one[2], one[3], one[5], b_T[c])
        np.testing.assert_array_equal(picked[c].numpy(), want.numpy())
    got_lw, got_anc = CF.forward_factor_scan(*args, pgas=pgas)  # the wrappers' plain path
    assert torch.equal(got_lw, lw) and torch.equal(got_anc, anc)
    assert torch.equal(CF.backward_factor_scan(rf, cf, rb, cb, us, b_T), picked)


@pytest.mark.parametrize("n,N,k,nv", [(7, 25, 64, 3), (5, 1, 4, 2), (4, 32, 130, 3),
                                       (6, 25, 30, 2)])
def test_host_pair_scores_match_plain(host_lib, n, N, k, nv):
    """The pair-score pass alone: each step's record (the (N, WARP_N) scores,
    the columns past N zero, then the step's rows of the vectors, its
    scalar and the padding to 16 bytes); k = 130 stages three chunks of
    factor columns."""
    a, b, v0, v1, v2, s, _ = _factor_inputs(n, N, k, seed=k)
    vectors = (v0, v1, v2)[:nv]
    want = CF.pair_scores_plain(a, b, vectors, s)
    got = torch.full_like(want, float("nan"))
    _call(host_lib["csmc_fwd"].h_pair_scores, n, N, k, nv, a, b, *(vectors + (v1,))[:3], s, got)
    _close(got, want)
    assert bool((got[:, :N * CF.WARP_N].reshape(n, N, CF.WARP_N)[..., N:] == 0).all())


def _host_block_lane_paths(host_lib, model, n, N, d, eps, res_u, x_star, x0, w0, consts, params,
                           want):
    """The host build of the block-lane sweep on each of its three paths
    (particles in global memory; staged with the block collectives; staged
    with the one-warp carry) against the plain version `want`: identical
    ancestors, values to rtol 1e-9."""
    lib = host_lib["csmc_block"]
    words = getattr(lib, f"h_block_lane_words_{model}")
    words.restype = ctypes.c_long
    for path in (0, 1, 2):
        xs, lw = torch.empty(n, d, N, dtype=torch.float64), torch.empty(n, N, dtype=torch.float64)
        anc = torch.empty(n, N, dtype=torch.int64)
        smem = torch.full((words(N, d, 1, int(path > 0)),), float("nan"), dtype=torch.float64)
        _call(getattr(lib, f"h_block_lane_{model}"), path, n, N, d, eps, res_u, x_star, x0, w0,
              consts, params.contiguous(), xs, lw, anc, smem)
        np.testing.assert_array_equal(anc.numpy(), want[2].numpy())
        _close(xs, want[0])
        _close(lw, want[1])


@pytest.mark.parametrize("T,D,N", [(12, 3, 16), (9, 30, 25), (5, 70, 8)])
def test_host_block_lane_sv_guided_matches_plain(host_lib, T, D, N):
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    _, ys = sv.get_data(0.0, 0.9, 2.0, 0.25, D, T, generator=torch.Generator().manual_seed(T),
                        device="cpu")
    factory, _ = sv.make_guided_factory(ys, 0.0, 0.9, 2.0, 0.25)
    rng = np.random.default_rng(D)
    u = torch.as_tensor(rng.standard_normal((T, D)))
    scale = torch.as_tensor(rng.uniform(0.3, 0.6, size=T))
    _, _, Mt, Gt = factory(u, scale)
    n = T - 1
    eps, x0 = (torch.as_tensor(rng.standard_normal(s)) for s in ((n, D, N), (D, N)))
    res_u = torch.as_tensor(rng.uniform(size=(n, N)))
    x_star = torch.as_tensor(rng.standard_normal((n, D)))
    w0 = torch.full((N,), 1.0 / N, dtype=torch.float64)
    want = CF.block_lane_scan(Mt, Gt, eps, res_u, x_star, x0, w0)
    consts, params = Gt.cuda_operands()
    _host_block_lane_paths(host_lib, "sv_guided", n, N, D, eps, res_u, x_star, x0, w0, consts,
                           params, want)


@pytest.mark.parametrize("gradient", [False, True])
@pytest.mark.parametrize("T,D,N", [(12, 2, 16), (9, 3, 25), (6, 8, 25), (5, 9, 16)])
def test_host_block_lane_spatial_guided_matches_plain(host_lib, T, D, N, gradient):
    """The functor SpatialGuided at d = D * D in {4, 9, 64, 81} against the
    model's (d, N)-block callables: d = 81 is past the register width
    (`kRegBlockD` = 64 components a warp, the host build's one lane included),
    so its lanes keep their components in the warp's scratch."""
    from aux_ssm_tpu_torch.models import spatial
    rng = np.random.default_rng(T + D)
    d = D * D
    _, ys = spatial.get_data(rng, 0.3, 1, -0.25, 4.0, D, T, device="cpu")
    factory, _ = spatial.make_guided_factory(ys, 0.3, 4.0, -0.25, 1, D, gradient)
    u = ys + torch.as_tensor(0.3 * rng.standard_normal((T, d)))
    scale = torch.as_tensor(rng.uniform(0.2, 0.6, size=T))
    _, _, Mt, Gt = factory(u, scale)
    n = T - 1
    eps = torch.as_tensor(rng.standard_normal((n, d, N)))
    x0 = ys[0][:, None] + torch.as_tensor(0.3 * rng.standard_normal((d, N)))
    res_u = torch.as_tensor(rng.uniform(size=(n, N)))
    x_star = ys[1:] + torch.as_tensor(0.3 * rng.standard_normal((n, d)))
    w0 = torch.full((N,), 1.0 / N, dtype=torch.float64)
    want = CF.block_lane_scan(Mt, Gt, eps, res_u, x_star, x0, w0)
    consts, params = Gt.cuda_operands()
    mats, vecs, lists, scalars, row_vecs, row_scalars = CF.BLOCK_LANE_MODELS[Gt.cuda_model]
    assert consts.shape == (mats * d * d + vecs * d + lists * d * Gt.ell_width + scalars,)
    assert params.shape == (n, row_vecs * d + row_scalars)
    assert len(np.unique(want[2].numpy())) > 2  # the sweep did resample
    _host_block_lane_paths(host_lib, "spatial_guided", n, N, d, eps, res_u, x_star, x0, w0,
                           consts, params, want)


# The block-lane sweep's chain axis (row 11): both functors over 3 chains at
# once, each chain with its own u, scales and operands (its rows (C, n,
# row)), the constants shared; every sweep path (particles in global memory;
# staged with the block collectives; staged with the one-warp carry): each
# chain equals a one-chain host call on its slice bit for bit, and the plain
# version (chain by chain) to rtol 1e-9 with identical ancestors.
@pytest.mark.parametrize("model,T,D,N,gradient", [("sv_guided", 9, 4, 16, False),
                                                  ("spatial_guided", 7, 3, 25, False),
                                                  ("spatial_guided", 7, 3, 25, True),
                                                  ("spatial_guided", 4, 9, 8, True)])
def test_host_block_lane_chain_axis(host_lib, model, T, D, N, gradient):
    from aux_ssm_tpu_torch.models import spatial, stochastic_volatility as sv
    Cc, n = 3, T - 1
    rng = np.random.default_rng(T + D + N + gradient)
    if model == "sv_guided":
        d = D
        _, ys = sv.get_data(0.0, 0.9, 2.0, 0.25, D, T, generator=torch.Generator().manual_seed(T),
                            device="cpu")
        factory, _ = sv.make_guided_factory(ys, 0.0, 0.9, 2.0, 0.25, gradient)
        u = torch.as_tensor(rng.standard_normal((Cc, T, d)))
        x_star = torch.as_tensor(rng.standard_normal((Cc, n, d)))
        x0 = torch.as_tensor(rng.standard_normal((Cc, d, N)))
    else:
        d = D * D
        _, ys = spatial.get_data(rng, 0.3, 1, -0.25, 4.0, D, T, device="cpu")
        factory, _ = spatial.make_guided_factory(ys, 0.3, 4.0, -0.25, 1, D, gradient)
        u = ys + torch.as_tensor(0.3 * rng.standard_normal((Cc, T, d)))
        x_star = ys[1:] + torch.as_tensor(0.3 * rng.standard_normal((Cc, n, d)))
        x0 = ys[0][:, None] + torch.as_tensor(0.3 * rng.standard_normal((Cc, d, N)))
    scale = torch.as_tensor(rng.uniform(0.2, 0.6, size=(Cc, T)))
    _, _, Mt, Gt = factory(u, scale)
    consts, params = Gt.cuda_operands()
    assert params.shape == (Cc, n, CF.BLOCK_LANE_MODELS[model][4] * d
                            + CF.BLOCK_LANE_MODELS[model][5])
    w0 = rng.uniform(0.1, 1.0, (Cc, N))
    inputs = (torch.as_tensor(rng.standard_normal((Cc, n, d, N))),
              torch.as_tensor(rng.uniform(size=(Cc, n, N))), x_star, x0,
              torch.as_tensor(w0 / w0.sum(1, keepdims=True)))
    want = CF.block_lane_scan(Mt, Gt, *inputs)  # the plain path, chain by chain
    lib = host_lib["csmc_block"]
    words = getattr(lib, f"h_block_lane_words_{model}")
    words.restype = ctypes.c_long
    for path in (0, 1, 2):
        smem = torch.full((words(N, d, 1, int(path > 0)),), float("nan"), dtype=torch.float64)
        xs, lw = (torch.empty(Cc, n, d, N, dtype=torch.float64),
                  torch.empty(Cc, n, N, dtype=torch.float64))
        anc = torch.empty(Cc, n, N, dtype=torch.int64)
        _call(getattr(lib, f"h_block_lane_chains_{model}"), path, Cc, n, N, d, *inputs, consts,
              params.contiguous(), xs, lw, anc, smem)
        for c in range(Cc):
            one = (torch.empty(n, d, N, dtype=torch.float64),
                   torch.empty(n, N, dtype=torch.float64), torch.empty(n, N, dtype=torch.int64))
            _call(getattr(lib, f"h_block_lane_{model}"), path, n, N, d,
                  *(z[c].contiguous() for z in inputs), consts, params[c].contiguous(), *one,
                  smem)
            assert all(torch.equal(g[c], o) for g, o in zip((xs, lw, anc), one))
        np.testing.assert_array_equal(anc.numpy(), want[2].numpy())
        _close(xs, want[0])
        _close(lw, want[1])
    assert len(np.unique(want[2].numpy())) > 2  # the sweeps did resample


@pytest.mark.parametrize("case", ["r_y=1", "r_y=2", "random", "random sparse"])
def test_host_spatial_row_lists_give_the_dense_product(host_lib, case):
    """P's row lists (`precision_rows`), applied by SpatialGuided row by row,
    give the dense product summed in column order bit for bit: the grid
    precision at r_y = 1 (W = 5) and 2 (W = 13) on the 8 x 8 grid, and
    random dense and sparse matrices."""
    from aux_ssm_tpu_torch.native.precision import make_precision_dense, precision_rows
    rng = np.random.default_rng(len(case))
    d = 64
    if case.startswith("r_y"):
        P = make_precision_dense(-0.25, int(case[-1]), 8)
    else:
        P = rng.standard_normal((d, d))
        if case == "random sparse":
            P[rng.uniform(size=(d, d)) < 0.8] = 0.0
    vals, cols = precision_rows(P)
    assert vals.shape[1] == {"r_y=1": 5, "r_y=2": 13, "random": d}.get(case, vals.shape[1])
    consts = torch.as_tensor(np.concatenate([[0.3, 4.0, 0.0, vals.shape[1]], vals.reshape(-1),
                                             cols.reshape(-1)]))
    for v in (rng.standard_normal(d), 1e3 * rng.standard_normal(d)):
        got = torch.empty(d, dtype=torch.float64)
        _call(host_lib["csmc_block"].h_spatial_apply, d, consts, torch.as_tensor(v), got)
        want = np.zeros(d)
        for k in range(d):  # the dense loop: s_i += P_ik v_k, k ascending
            want = want + P[:, k] * v[k]
        np.testing.assert_array_equal(got.numpy().view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("model,N,d,elem,staged", [
    ("sv_guided", 25, 30, 8, True), ("sv_guided", 100, 30, 8, True),
    ("sv_guided", 1024, 30, 4, False), ("spatial_guided", 25, 64, 8, True),
    ("spatial_guided", 64, 64, 8, True), ("spatial_guided", 1024, 64, 4, False),
    ("spatial_guided", 25, 81, 8, True), ("spatial_guided", 1024, 81, 8, False)])
def test_host_block_lane_staged_plan(host_lib, model, N, d, elem, staged):
    """Which shapes the block-lane sweep stages in shared memory (the H100's
    227 KB a block): the published N = 25 in both widths, the 9 x 9 grid's d
    = 81 (three d-vectors of scratch a warp) and the moderate N the on-card
    tests use stage; N = 1024 keeps its particles in global memory."""
    nconst = 3 * d * d + 2 * d + 1 if model == "sv_guided" else 4 + 2 * d * 5
    fn = getattr(host_lib["csmc_block"], f"h_block_lane_staged_{model}")
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_long]
    assert bool(fn(N, d, nconst, min(N, 32), elem, 232448)) == staged


@pytest.mark.parametrize("n,B", [(1, 5), (37, 1), (100, 36), (513, 13), (1023, 64)])
def test_host_scalar_filter_scan_matches_plain(host_lib, n, B):
    rng = np.random.default_rng(n + B)
    elems = tuple(torch.as_tensor(z) for z in (
        rng.uniform(0.5, 1.0, (n, B)), rng.standard_normal((n, B)), rng.uniform(0.1, 1.0, (n, B)),
        rng.standard_normal((n, B)), rng.uniform(0.0, 0.5, (n, B))))
    want = SS.scalar_filter_scan_plain(elems)
    got = tuple(torch.full_like(z, float("nan")) for z in elems)
    seg = torch.zeros(1, dtype=torch.int32)
    _call(host_lib["scalar_scan"].h_scalar_filter_scan, n, B, 132, *elems, *got, seg)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n,B", [(1, 3), (50, 7), (300, 64), (1024, 9)])
def test_host_scalar_affine_scan_matches_plain(host_lib, n, B, reverse):
    rng = np.random.default_rng(n + B)
    gains = torch.as_tensor(rng.uniform(-0.9, 0.9, (n, B)))
    incs = torch.as_tensor(rng.standard_normal((n, B)))
    want = SS.scalar_affine_scan_plain(gains, incs, reverse=reverse)
    got = tuple(torch.full_like(z, float("nan")) for z in want)
    seg = torch.zeros(1, dtype=torch.int32)
    _call(host_lib["scalar_scan"].h_scalar_affine_scan, n, B, 132, reverse, gains, incs, *got, seg)
    for g, w in zip(got, want):
        _close(g, w)


# The plan's paths and edges (scalar_segments for the SM count given): the
# whole-column path (0: n below 512, or 8-column groups >= SMs) with B not a
# multiple of its 8 columns (13, 7, 6, 9, 1057), n below the chunk count
# (50, 1), a chunk in one window (its prefixes kept in registers) and
# chunks past one window (2 steps of the float64 filter, 3 of the float64
# affine map: 300 and 1023, 3 and 8 a chunk; 2100: 17);
# the split path at each segment count, 4, 8 and 16 (the most), with B not a
# multiple of its 8 columns (5, 3, 13), n not a multiple of the chunk length
# (517: 104 chunks of 5, the last of 2) and chunks past one window of 8
# steps (2100: 17 a chunk, windows of 8, 8, 1; 1500: 12, windows of 8, 4).
@pytest.mark.parametrize("n,B,sms,seg", [
    (100, 13, 132, 0), (300, 7, 16, 0), (50, 6, 4, 0), (1, 9, 132, 0), (299, 64, 30, 0),
    (1023, 1057, 132, 0), (2100, 20, 2, 0), (517, 5, 8, 8), (2100, 3, 132, 16),
    (1500, 16, 132, 16), (1023, 64, 132, 16), (600, 13, 4, 4)])
def test_host_scalar_scan_layout_edges(host_lib, n, B, sms, seg):
    rng = np.random.default_rng(n + B)
    elems = tuple(torch.as_tensor(z) for z in (
        rng.uniform(0.5, 1.0, (n, B)), rng.standard_normal((n, B)), rng.uniform(0.1, 1.0, (n, B)),
        rng.standard_normal((n, B)), rng.uniform(0.0, 0.5, (n, B))))
    used = torch.zeros(1, dtype=torch.int32)
    got = tuple(torch.full_like(z, float("nan")) for z in elems)
    _call(host_lib["scalar_scan"].h_scalar_filter_scan, n, B, sms, *elems, *got, used)
    assert int(used) == seg
    for g, w in zip(got, SS.scalar_filter_scan_plain(elems)):
        _close(g, w)
    gains = torch.as_tensor(rng.uniform(-0.9, 0.9, (n, B)))
    for reverse in (False, True):
        got = tuple(torch.full_like(z, float("nan")) for z in elems[:2])
        _call(host_lib["scalar_scan"].h_scalar_affine_scan, n, B, sms, reverse, gains, elems[1],
              *got, used)
        for g, w in zip(got, SS.scalar_affine_scan_plain(gains, elems[1], reverse=reverse)):
            _close(g, w)


@pytest.mark.parametrize("B", [1, 8, 9, 64, 4096])
def test_host_scalar_hand_words_match_the_wrappers(host_lib, B):
    """The wrappers size the hand-over buffer as the kernel lays it out, and
    pass one exactly where the kernel takes the split path."""
    out = torch.zeros(4, dtype=torch.int64)
    _call(host_lib["scalar_scan"].h_scalar_hand_words, B, out)
    assert out.tolist() == [SS.hand_words(B, values, elem)
                            for values in (5, 2) for elem in (4, 8)]
    segments = host_lib["scalar_scan"].h_scalar_segments
    for n in (1, 511, 512, 1023, 5000):
        for sms in (1, -(-B // 8), -(-B // 8) + 1, 132):
            assert (segments(n, B, sms) > 0) == SS.split_path(n, B, sms)


def _lane_model(model, T):
    """(Mt, Gt) of a model with lane callables, float64 on the CPU."""
    from aux_ssm_tpu_torch.models import ar1_gauss, rare_event, theta_logistic
    rng = np.random.default_rng(T)
    if model == "theta_logistic":
        return theta_logistic.get_feynman_kac(
            torch.as_tensor(1.0 + 0.3 * rng.standard_normal((T, 1))))[2:]
    if model == "ar1_gauss":
        return ar1_gauss.get_feynman_kac(torch.as_tensor(rng.standard_normal((T - 1, 1))))[2:]
    if model == "rare_event_bootstrap":
        return rare_event.get_feynman_kac(5.0, 0.8, 0.5, T, device="cpu")[2:]
    captured = {}
    with pytest.MonkeyPatch.context() as mp:  # the factory, from where csmc_aux receives it
        mp.setattr(rare_event.csmc_aux, "get_kernel",
                   lambda factory, *a, **k: captured.setdefault("factory", factory))
        rare_event.get_guided_csmc_kernel(5.0, 0.8, 0.5, T, 8, gradient=model.endswith("grad"),
                                          device="cpu")
    return captured["factory"](torch.as_tensor(rng.standard_normal((T, 1))),
                               torch.as_tensor(rng.uniform(0.3, 0.9, T)))[2:]


# Each path the launcher takes: N <= 32 one warp (N = 1, 16, 25, 32), N <=
# 1024 one block (33, 256, 300), past it the wide path (2048).
@pytest.mark.parametrize("pgas", [False, True])
@pytest.mark.parametrize("model,T,N", [
    ("theta_logistic", 24, 32), ("theta_logistic", 5, 2048), ("rare_event_guided", 2, 25),
    ("rare_event_guided", 9, 16), ("rare_event_guided_grad", 9, 16),
    ("rare_event_bootstrap", 9, 16), ("ar1_gauss", 12, 300),
    ("theta_logistic", 12, 1), ("theta_logistic", 12, 25), ("theta_logistic", 12, 33),
    ("theta_logistic", 12, 256), ("rare_event_guided", 9, 1), ("rare_event_guided", 9, 33),
    ("rare_event_guided_grad", 9, 256), ("rare_event_bootstrap", 9, 32),
    ("rare_event_bootstrap", 9, 33), ("rare_event_bootstrap", 9, 256), ("ar1_gauss", 12, 1),
    ("ar1_gauss", 12, 25), ("ar1_gauss", 12, 33), ("ar1_gauss", 12, 256)])
def test_host_lane_matches_plain(host_lib, model, T, N, pgas):
    Mt, Gt = _lane_model(model, T)
    n = T - 1
    rng = np.random.default_rng(N)
    w0 = rng.uniform(0.1, 1.0, N)
    inputs = tuple(torch.as_tensor(z) for z in (
        rng.standard_normal((n, N)), rng.uniform(size=(n, N)), rng.uniform(size=n),
        1.0 + 0.5 * rng.standard_normal(n), 1.0 + 0.5 * rng.standard_normal(N), w0 / w0.sum()))
    want = CF.lane_scan(Mt, Gt, Mt if pgas else None, *inputs)
    consts, params = Gt.cuda_operands()
    assert (consts.numel(), params.shape[1]) == CF.LANE_MODELS[Gt.cuda_model]
    xs, lw = (torch.empty(n, N, dtype=torch.float64) for _ in range(2))
    anc = torch.empty(n, N, dtype=torch.int64)
    _call(getattr(host_lib["csmc_lane"], f"h_lane_{Gt.cuda_model}"), n, N, pgas, *inputs,
          consts, params.contiguous(), xs, lw, anc)
    np.testing.assert_array_equal(anc.numpy(), want[2].numpy())
    _close(xs, want[0])
    _close(lw, want[1])


# The lane sweep's chain axis (row 10): the rare-event models over 3 cells
# (rho, r2) at once, per-chain rows and shared constants, each chain equal to
# a one-chain call; one warp (N = 25), one block (N = 40), the wide path
# (N = 1100).
@pytest.mark.parametrize("model,T,N,pgas", [("rare_event_guided", 2, 25, False),
                                            ("rare_event_guided_grad", 6, 25, False),
                                            ("rare_event_bootstrap", 6, 40, True),
                                            ("rare_event_guided", 3, 1100, False)])
def test_host_lane_chain_axis(host_lib, model, T, N, pgas):
    from aux_ssm_tpu_torch.models import rare_event
    Cc, n = 3, T - 1
    rho = torch.tensor([0.0, 0.8, 0.999], dtype=torch.float64)
    r2 = torch.tensor([1e-3, 0.5, 1.0], dtype=torch.float64)
    rng = np.random.default_rng(T + N)
    if model == "rare_event_bootstrap":
        Mt, Gt = rare_event.get_feynman_kac(5.0, rho, r2, T, device="cpu")[2:]
    else:
        captured = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(rare_event.csmc_aux, "get_kernel",
                       lambda factory, *a, **k: captured.setdefault("factory", factory))
            rare_event.get_guided_csmc_kernel(5.0, rho, r2, T, 8, device="cpu",
                                              gradient=model.endswith("grad"))
        Mt, Gt = captured["factory"](torch.as_tensor(rng.standard_normal((Cc, T, 1))),
                                     torch.as_tensor(rng.uniform(0.3, 0.9, (Cc, T))))[2:]
    w0 = rng.uniform(0.1, 1.0, (Cc, N))
    inputs = tuple(torch.as_tensor(z) for z in (
        rng.standard_normal((Cc, n, N)), rng.uniform(size=(Cc, n, N)), rng.uniform(size=(Cc, n)),
        1.0 + 0.5 * rng.standard_normal((Cc, n)), 1.0 + 0.5 * rng.standard_normal((Cc, N)),
        w0 / w0.sum(1, keepdims=True)))
    consts, params = Gt.cuda_operands()
    assert params.shape == (Cc, n, CF.LANE_MODELS[Gt.cuda_model][1])
    xs, lw = (torch.empty(Cc, n, N, dtype=torch.float64) for _ in range(2))
    anc = torch.empty(Cc, n, N, dtype=torch.int64)
    _call(getattr(host_lib["csmc_lane"], f"h_lane_chains_{Gt.cuda_model}"), Cc, n, N, pgas,
          *inputs, consts, params.contiguous(), xs, lw, anc)
    want = CF.lane_scan(Mt, Gt, Mt if pgas else None, *inputs)  # the plain path, chain by chain
    for c in range(Cc):
        one = CF.lane_scan_plain(Mt.lane_propagate, Gt.lane_logw,
                                 Mt.lane_logpdf if pgas else None,
                                 *(({k: v[c] for k, v in z.items()} if z is not None else None)
                                   for z in (Mt.params, Gt.params, Mt.params if pgas else None)),
                                 *(z[c] for z in inputs))
        np.testing.assert_array_equal(anc[c].numpy(), one[2].numpy())
        _close(xs[c], one[0])
        _close(lw[c], one[1])
        for got, w in zip(want, one):
            assert torch.equal(got[c], w)


# col_sample's chain axis (row 15): 3 chains' level nodes (P = 3 x 4 pairs)
# with a seed each, each chain's columns those of a one-chain call with its
# seed; one seed for all the pairs is the one-chain call.
@pytest.mark.parametrize("n,N,k", [(25, 25, 1), (6, 25, 1), (40, 70, 64)])
def test_host_col_sample_chain_axis(host_lib, n, N, k):
    Cc, P = 3, 4
    rng = np.random.default_rng(n + N + k)
    rf, cf, cb = (torch.as_tensor(z) for z in (0.4 * rng.standard_normal((Cc * P, n, k)),
                                                0.4 * rng.standard_normal((Cc * P, N, k)),
                                                rng.standard_normal((Cc * P, N))))
    seeds = torch.tensor([-1, 123456, 7], dtype=torch.int32)
    lib = host_lib["stitching"]
    got = torch.full((Cc * P, n), -1, dtype=torch.int64)
    plan = torch.zeros(5, dtype=torch.int32)
    _call(lib.h_col_sample_chains, Cc * P, n, N, k, 132, seeds, P, 3, rf, cf, cb, got, plan)
    for c in range(Cc):
        sl = slice(c * P, (c + 1) * P)
        one = torch.full((P, n), -1, dtype=torch.int64)
        _call(lib.h_col_sample, P, n, N, k, 132, int(seeds[c]), 3, rf[sl], cf[sl], cb[sl], one,
              plan)
        np.testing.assert_array_equal(got[sl].numpy(), one.numpy())
    np.testing.assert_array_equal(got.numpy(), ST.col_sample(seeds, rf, cf, cb, 3, chains=Cc)
                                  .numpy())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("N,k", [(128, 1), (256, 5)])
def test_host_draws_chain_axis(host_lib, dtype, N, k):
    """stitch_draws' and within_block_cols' chain instances, as the kernels
    take them (`chain_pair`): the P nodes are C chains' chain_pairs each,
    chain c's with seeds[c] and its nodes counted within the chain; each
    chain equals a one-seed call on its nodes, and the whole launch the
    plain chain twin (`ops.stitching`, `chains=C`), bit for bit."""
    Cc, per, offset = 3, 2, 4
    P, nb = Cc * per, N // 128
    rng = np.random.default_rng(N + k)
    rf, cf = (torch.as_tensor(0.4 * rng.standard_normal((P, N, k)), dtype=dtype)
              for _ in range(2))
    cb = torch.as_tensor(rng.standard_normal((P, N)), dtype=dtype)
    Lb = ST.block_masses(rf, cf, cb)
    rl = torch.as_tensor(rng.standard_normal((P, N)), dtype=dtype) + torch.logsumexp(Lb, -1)
    u = torch.as_tensor(rng.uniform(size=(P, N)), dtype=dtype)
    blocks = torch.as_tensor(rng.integers(0, nb, (P, 40)))
    rf_sel = rf[:, :40].contiguous()
    seeds = torch.tensor([-1, 987654, 7], dtype=torch.int32)
    suffix = "f64" if dtype == torch.float64 else "f32"
    lib = host_lib["stitching"]
    rows, cols, wcols = (torch.full(shape, -1, dtype=torch.int64)
                         for shape in ((P, N), (P, N), (P, 40)))
    _call(getattr(lib, f"h_stitch_draws_chains_{suffix}"), P, N, k, seeds, per, offset, rl, u,
          Lb, rf, cf, cb, rows, cols)
    _call(getattr(lib, f"h_within_block_cols_chains_{suffix}"), P, 40, N, k, seeds, per, offset,
          blocks, rf_sel, cf, cb, wcols)
    for c in range(Cc):
        sl = slice(c * per, (c + 1) * per)
        r1, c1, w1 = (torch.full(shape, -1, dtype=torch.int64)
                      for shape in ((per, N), (per, N), (per, 40)))
        _call(getattr(lib, f"h_stitch_draws_{suffix}"), per, N, k, int(seeds[c]), offset, rl[sl],
              u[sl], Lb[sl], rf[sl], cf[sl], cb[sl], r1, c1)
        _call(getattr(lib, f"h_within_block_cols_{suffix}"), per, 40, N, k, int(seeds[c]),
              offset, blocks[sl], rf_sel[sl].contiguous(), cf[sl], cb[sl], w1)
        for got, want in ((rows[sl], r1), (cols[sl], c1), (wcols[sl], w1)):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    want_rows, want_cols = ST.stitch_draws(seeds, rl, u, Lb, rf, cf, cb, offset, chains=Cc)
    np.testing.assert_array_equal(rows.numpy(), want_rows.numpy())
    np.testing.assert_array_equal(cols.numpy(), want_cols.numpy())
    np.testing.assert_array_equal(
        wcols.numpy(), ST.within_block_cols(seeds, blocks, rf_sel, cf, cb, offset, chains=Cc)
        .numpy())


def test_host_counter_uniform_bitwise(host_lib):
    rng = np.random.default_rng(0)
    n = 4096
    ints = [rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, n, dtype=np.int64)
            .astype(np.int32) for _ in range(5)]
    ints[0][:4] = [-1, 0, np.iinfo(np.int32).max, np.iinfo(np.int32).min]
    args = [torch.as_tensor(z) for z in ints]
    got = torch.empty(n, dtype=torch.float32)
    _call(host_lib["stitching"].h_counter_uniform, n, *args, got)
    want = ST.counter_uniform(*args)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.numpy().view(np.uint32))


def _rows_case(P, n, N, k, dead=False):
    return pytest.param(P, n, N, k, dead, id=f"{P}-{n}-{N}-{k}" + ("-dead" if dead else ""))


# row_lse's plans (H100, 132 SMs): a node's rows over several blocks and 32
# threads a row (P = 1, N = 1000), N = 25 with many nodes (P = 64, k = 64),
# 4 rows a thread (P = 600, 200 columns, k = 8: ragged row slots), column
# tiles (N = 1500, k = 64), several nodes a block (n = 4), nodes a block
# capped by shared memory (N = 4 and 8 at k = 64: 4-column tiles), row slots
# capped by it (1000 rows of 4 columns at k = 64), and dead columns (-inf
# biases in node 0) and a dead node (every score -inf: NaN; col_sample's
# column 0). col_sample runs on the same plans: G = 1, 2, 4, 8, 16 (3, 20,
# 50, 8) and 32, R = 1, 2 (features in registers at k = 1, from shared
# memory at k = 64) and 4, several nodes a block (also at k = 64: 5, 10,
# 20, 64; and with a dead node: 37, 4, 9, 1).
@pytest.mark.parametrize("P,n,N,k,dead", [
    _rows_case(3, 25, 25, 30), _rows_case(2, 130, 200, 1), _rows_case(2, 40, 70, 64),
    _rows_case(1, 5, 3, 8), _rows_case(1, 1000, 1000, 1), _rows_case(64, 25, 25, 64),
    _rows_case(2, 40, 1500, 64), _rows_case(37, 4, 9, 1), _rows_case(600, 25, 200, 8),
    _rows_case(64, 4, 4, 64), _rows_case(64, 8, 8, 64), _rows_case(2, 1000, 4, 64),
    _rows_case(3, 25, 25, 30, True),
    _rows_case(2, 300, 700, 1, True), _rows_case(3, 20, 50, 8), _rows_case(5, 10, 20, 64),
    _rows_case(37, 4, 9, 1, True)])
def test_host_stitching_rows_match_plain(host_lib, P, n, N, k, dead):
    rng = np.random.default_rng(n + k)
    rf, cf, cb = (torch.as_tensor(z) for z in (0.4 * rng.standard_normal((P, n, k)),
                                                0.4 * rng.standard_normal((P, N, k)),
                                                rng.standard_normal((P, N))))
    if dead:
        cb[0, ::3] = -float("inf")
        cb[-1] = -float("inf")
    lib = host_lib["stitching"]
    got = torch.full((P, n), 0.0, dtype=torch.float64)
    plan = torch.zeros(5, dtype=torch.int32)
    _call(lib.h_row_lse, P, n, N, k, 132, rf, cf, cb, got, plan)
    want = ST.row_lse(rf, cf, cb)
    assert bool(torch.isnan(want[-1]).all()) == dead and bool(torch.isfinite(want[0]).all())
    _close(got, want, rtol=1e-12, atol=1e-12)
    for seed, offset in ((-1, 0), (123456, 9)):
        cols = torch.full((P, n), -1, dtype=torch.int64)
        col_plan = torch.zeros(5, dtype=torch.int32)
        _call(lib.h_col_sample, P, n, N, k, 132, seed, offset, rf, cf, cb, cols, col_plan)
        assert torch.equal(col_plan, plan)
        want_cols = ST.col_sample(seed, rf, cf, cb, offset)
        np.testing.assert_array_equal(cols.numpy(), want_cols.numpy())
        if dead:
            assert not bool(want_cols[-1].any())  # the dead node: column 0


# col_sample's butterfly on hand-made partials (g, column; -1: no column):
# the larger g wins; on equal g the lower column, also against a later
# thread's; -inf never wins over a finite g; a row whose every partial is
# -inf (or holds no column) takes column 0; +inf wins, the lowest first.
@pytest.mark.parametrize("g,j,want", [
    ([0.5, 0.5], [7, 3], 3), ([0.5, 0.5, 0.5, 0.5], [9, 2, 14, 6], 2),
    ([-np.inf, -np.inf, 0.1, -np.inf], [-1, -1, 6, -1], 6), ([-np.inf] * 8, [-1] * 8, 0),
    ([-np.inf, -np.inf], [-1, 5], 5), ([-2.0, 1.0, 1.0, 3.0e-3], [0, 13, 1, 2], 1),
    ([np.inf, 1.0, np.inf, -np.inf], [12, 0, 3, -1], 3), ([1.5], [4], 4),
    ([0.25] * 16 + [0.5] + [0.25] * 15, list(range(32, 0, -1)), 16),
    ([-1.0] * 32, [31 - l for l in range(32)], 0)])
def test_host_col_sample_merge(host_lib, g, j, want):
    G = len(g)
    out = torch.full((G,), -2, dtype=torch.int64)
    _call(host_lib["stitching"].h_col_sample_merge, G, torch.tensor(g, dtype=torch.float64),
          torch.tensor(j, dtype=torch.int32), out)
    assert out.tolist() == [want] * G


# (P, nr, nc, k, element bytes) -> lse_plan's (G, R, RS, NPB, TC) at 132
# SMs: the N = 4096 root (32 threads a row, 2 rows a thread: 4, or 16
# threads, would leave SMs idle), 8 nodes of it (4 rows a thread, 8 threads a
# row), N = 25 levels (7 chunks: 8 threads a row, one chunk and one row a
# thread; 25 row slots, one node a block), a float64 node tiled (TC columns
# of 65 features in 96 KB beside the rows), short rows several nodes a block
# (capped by P), 200 columns at P = 600 (4 rows a thread, 4 nodes a block),
# nodes a block capped so that each keeps a 4-column tile (N = 4 and 8 at
# k = 64, N = 4 at k = 30), and row slots capped by shared memory (1000 rows
# of 4 columns at k = 64).
@pytest.mark.parametrize("shape,want", [
    ((1, 4096, 4096, 1, 4), (32, 2, 8, 1, 4096)), ((1, 4096, 4096, 1, 8), (32, 2, 8, 1, 4096)),
    ((8, 4096, 4096, 1, 4), (8, 4, 32, 1, 4096)), ((512, 25, 25, 64, 4), (8, 1, 25, 1, 28)),
    ((1, 25, 25, 30, 4), (8, 1, 25, 1, 28)), ((2, 40, 1500, 64, 8), (32, 2, 8, 1, 172)),
    ((100, 4, 9, 1, 4), (4, 1, 4, 16, 12)), ((3, 4, 9, 1, 4), (4, 1, 4, 3, 12)),
    ((1, 1000, 1000, 1, 8), (32, 2, 8, 1, 1000)), ((600, 25, 200, 8, 8), (8, 4, 7, 4, 200)),
    ((512, 4, 4, 64, 4), (1, 1, 4, 46, 4)), ((64, 8, 8, 64, 8), (2, 1, 8, 15, 4)),
    ((64, 4, 4, 30, 8), (1, 1, 4, 45, 4)), ((2, 1000, 4, 64, 8), (1, 1, 176, 1, 4))])
def test_host_lse_plan(host_lib, shape, want):
    P, nr, nc, k, elem = shape
    out = torch.zeros(5, dtype=torch.int32)
    _call(host_lib["stitching"].h_lse_plan, P, nr, nc, k, elem, 132, out)
    assert tuple(out.tolist()) == want


def _host_masses(lib, rf, cf, cb, per_block_max, R, whole):
    """block_masses of the host build with R rows a thread (capped by the
    feature bound) and the node whole in shared memory or tiled; returns
    (masses, the R that ran)."""
    P, n, k = rf.shape
    N = cf.shape[1]
    out = torch.full((P, n, N // 128), float("nan"), dtype=rf.dtype)
    cols = torch.empty((N if whole else 128) * (k + 1), dtype=rf.dtype)
    used = torch.zeros(1, dtype=torch.int32)
    suffix = "f64" if rf.dtype == torch.float64 else "f32"
    _call(getattr(lib, f"h_block_masses_{suffix}"), P, n, N, k, per_block_max, R, whole, rf, cf,
          cb, out, cols, used)
    return out, int(used)


@pytest.mark.parametrize("per_block_max", [False, True])
@pytest.mark.parametrize("P,n,N,k", [(2, 130, 256, 1), (1, 20, 384, 9), (1, 300, 512, 30),
                                     (2, 37, 256, 64), (1, 1030, 384, 1)])
def test_host_block_masses_match_plain(host_lib, P, n, N, k, per_block_max):
    """Both stabilisers, the node whole in shared memory and tiled, one row a
    thread and R > 1 with a ragged last group (n not a multiple of R); every
    feature bound."""
    rng = np.random.default_rng(N + k)
    rf, cf, cb = (torch.as_tensor(z) for z in (rng.standard_normal((P, n, k)),
                                                rng.standard_normal((P, N, k)),
                                                rng.standard_normal((P, N))))
    cb[0, 128:256] = -900.0   # block 1 of node 0 underflows: -inf under the row max
    want = ST.block_masses(rf, cf, cb, per_block_max)
    assert bool(torch.isinf(want[0, :, 1]).all()) != per_block_max
    ran = set()
    for R in (1, 4):
        for whole in (True, False):
            got, used = _host_masses(host_lib["stitching"], rf, cf, cb, per_block_max, R, whole)
            ran.add(used)
            _close(got, want, rtol=1e-12, atol=1e-12)
    assert ran == ({1, 4} if k <= 8 else {1, 2} if k <= 32 else {1})


@pytest.mark.parametrize("per_block_max", [False, True])
def test_host_block_masses_f32_underflow_pattern(host_lib, per_block_max):
    """The float32 arithmetic (base 2, fused multiply-adds; exp2f here where
    the card takes ex2.approx.ftz): a block wholly in expf's denormal range
    under the row max (scores ~95 below it) is summed again about its own max
    and stays finite, as in the plain version; a block ~120 below is -inf in
    both. Values against float64 on the same inputs."""
    rng = np.random.default_rng(3)
    P, n, N, k = 1, 40, 512, 1
    rf, cf = (torch.as_tensor(0.4 * rng.standard_normal((P, m, k)), dtype=torch.float32)
              for m in (n, N))
    cb = torch.as_tensor(rng.standard_normal((P, N)), dtype=torch.float32)
    cb[0, 128:256] -= 95.0
    cb[0, 256:384] -= 120.0
    want32 = ST.block_masses(rf, cf, cb, per_block_max)
    want64 = ST.block_masses(rf.double(), cf.double(), cb.double(), per_block_max)
    assert bool(torch.isfinite(want32[0, :, 1]).all())
    assert bool(torch.isinf(want32[0, :, 2]).all()) != per_block_max
    for whole in (True, False):
        got, _ = _host_masses(host_lib["stitching"], rf, cf, cb, per_block_max, 4, whole)
        assert torch.equal(torch.isfinite(got), torch.isfinite(want32))
        fin = torch.isfinite(want32)
        _close(got[fin].double(), want64[fin], rtol=2e-6, atol=2e-5)


@pytest.mark.parametrize("P,nr,N,k,elem,R,whole", [
    (512, 4096, 4096, 1, 4, 4, True), (32, 4096, 4096, 1, 4, 2, True),
    (1, 4096, 4096, 1, 4, 1, True), (512, 4096, 4096, 1, 8, 4, True),
    (512, 4096, 4096, 30, 4, 2, False), (512, 25, 25, 64, 4, 1, True),
    (125, 25, 25, 30, 8, 1, True)])
def test_host_mass_plan(host_lib, P, nr, N, k, elem, R, whole):
    """block_masses' launch plan on 132 SMs: R rows a thread, as many as keep
    two blocks on every SM (at most 4, 2 past k = 8, 1 past k = 32); the node
    whole in shared memory up to 96 KB of column records."""
    out = torch.zeros(2, dtype=torch.int32)
    _call(host_lib["stitching"].h_mass_plan, P, nr, N, k, elem, 132, out)
    assert out.tolist() == [R, int(whole)]


_DRAW_SHAPES = {"nb64-k1": (1, 8192, 1), "nb1-k3": (2, 128, 3), "nb2-k64": (2, 256, 64)}


@pytest.mark.parametrize(
    "dtype,P,N,k",
    [(torch.float64, 2, 256, 3), (torch.float32, 2, 256, 3)]
    + [(dt, *shape) for shape in _DRAW_SHAPES.values() for dt in (torch.float64, torch.float32)],
    ids=["dtype0", "dtype1"] + [f"{name}-{dt}" for name in _DRAW_SHAPES for dt in ("f64", "f32")])
def test_host_stitch_draws_and_within_block_cols_match_plain(host_lib, dtype, P, N, k):
    """The draws' stages (the row CDF, each draw's row, block and column, one
    warp a draw with its 32 lanes in turn) in both widths, through the
    kernel's width dispatch (k = 1 reads cf directly, k > 1 through the
    warp's staging buffer), -inf biases and block masses included: indices
    bit-equal to the plain version's. nb = N / 128 = 64 runs the prefix sums'
    shift-32 steps from the low lanes' blocks into the high ones; nb = 1 a
    single tile. The block masses are those of the factors up to N = 256 and
    random past it (the plain version would build an N x N score matrix)."""
    offset = 5
    nb = N // 128
    rng = np.random.default_rng(6)
    rf, cf = (torch.as_tensor(0.4 * rng.standard_normal((P, N, k)), dtype=dtype)
              for _ in range(2))
    cb = torch.as_tensor(rng.standard_normal((P, N)), dtype=dtype)
    cb[0, [3, N - 56]] = -float("inf")
    if N <= 256:
        Lb = ST.block_masses(rf, cf, cb)
    else:
        Lb = torch.as_tensor(3.0 * rng.standard_normal((P, N, nb)), dtype=dtype)
    Lb[P - 1, 7, 0] = -float("inf")
    rl = torch.as_tensor(rng.standard_normal((P, N)), dtype=dtype) + torch.logsumexp(Lb, -1)
    u = torch.as_tensor(rng.uniform(size=(P, N)), dtype=dtype)
    suffix = "f64" if dtype == torch.float64 else "f32"
    rows, cols = (torch.full((P, N), -1, dtype=torch.int64) for _ in range(2))
    _call(getattr(host_lib["stitching"], f"h_stitch_draws_{suffix}"), P, N, k, -7, offset, rl, u,
          Lb, rf, cf, cb, rows, cols)
    want_rows, want_cols = ST.stitch_draws(-7, rl, u, Lb, rf, cf, cb, offset)
    np.testing.assert_array_equal(rows.numpy(), want_rows.numpy())
    np.testing.assert_array_equal(cols.numpy(), want_cols.numpy())
    assert len(set(want_rows.flatten().tolist())) > N // 4   # the rows spread over the tiles
    if nb > 1:
        assert len(set((want_cols // 128).flatten().tolist())) == nb
    blocks = torch.as_tensor(rng.integers(0, nb, (P, 100)))
    rf_sel = rf[:, :100].contiguous()
    got = torch.full((P, 100), -1, dtype=torch.int64)
    _call(getattr(host_lib["stitching"], f"h_within_block_cols_{suffix}"), P, 100, N, k, 11,
          offset, blocks, rf_sel, cf, cb, got)
    np.testing.assert_array_equal(
        got.numpy(), ST.within_block_cols(11, blocks, rf_sel, cf, cb, offset).numpy())
    # The block of each node's first draw all -inf: every score floors to
    # -1e30 and the Gumbel term vanishes beside it, so its 128 columns tie;
    # the first wins.
    cb_tie = cb.clone()
    for p in range(P):
        cb_tie[p, 128 * blocks[p, 0]:128 * (blocks[p, 0] + 1)] = -float("inf")
    _call(getattr(host_lib["stitching"], f"h_within_block_cols_{suffix}"), P, 100, N, k, 11,
          offset, blocks, rf_sel, cf, cb_tie, got)
    want = ST.within_block_cols(11, blocks, rf_sel, cf, cb_tie, offset)
    assert bool((want[:, 0] == 128 * blocks[:, 0]).all())
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_host_stitch_draws_counted_tiles_not_a_prefix(host_lib):
    """The shift-add prefix sums of the tile sums need not rise (float32, tile
    sums of very different sizes): a draw whose t1 = u * total falls between
    cdf[b + 1] < t1 <= cdf[b] counts tile b + 1 but not tile b. Such draws
    take the tile sums in tile order (the plain version's loop), not the
    node's running sums, which here would move some offsets: rows and
    columns bit-equal to the plain version's."""
    P, N, k, nb = 1, 8192, 1, 64
    rng = np.random.default_rng(0)
    level = np.repeat(rng.uniform(-rng.uniform(1.0, 30.0), 0.0, nb), 128)
    rl = torch.as_tensor(level + 0.01 * rng.standard_normal(N), dtype=torch.float32)[None]
    w = torch.exp(rl - rl.amax(-1, keepdim=True))
    cdf = ST._lane_cumsum(ST._lane_cumsum(w.reshape(P, nb, 128))[..., -1])[0]
    falls = torch.nonzero(cdf[1:] < cdf[:-1])[:, 0]
    assert len(falls) > 0
    u = torch.as_tensor(rng.uniform(size=(P, N)), dtype=torch.float32)
    gaps = torch.stack([(cdf[falls + 1] + f * (cdf[falls] - cdf[falls + 1])) / cdf[-1]
                        for f in np.linspace(0.0, 1.0, 9)], 1).flatten()
    u[0, :len(gaps)] = gaps
    below = cdf[None, :] < (u[0] * cdf[-1])[:, None]                  # (N, nb)
    prefix = below.sum(-1, keepdim=True) > torch.arange(nb)[None, :]
    assert int((below != prefix).any(-1).sum()) > 0
    rf, cf = (torch.as_tensor(0.4 * rng.standard_normal((P, N, k)), dtype=torch.float32)
              for _ in range(2))
    cb = torch.as_tensor(rng.standard_normal((P, N)), dtype=torch.float32)
    Lb = torch.as_tensor(3.0 * rng.standard_normal((P, N, nb)), dtype=torch.float32)
    rows, cols = (torch.full((P, N), -1, dtype=torch.int64) for _ in range(2))
    _call(host_lib["stitching"].h_stitch_draws_f32, P, N, k, 3, 0, rl, u, Lb, rf, cf, cb, rows,
          cols)
    want_rows, want_cols = ST.stitch_draws(3, rl, u, Lb, rf, cf, cb)
    np.testing.assert_array_equal(rows.numpy(), want_rows.numpy())
    np.testing.assert_array_equal(cols.numpy(), want_cols.numpy())
