"""The arithmetic of the CUDA kernels (`aux_ssm_tpu_torch/ops/cuda/csrc/`),
built as host C++ with g++ and run one "thread" at a time, against the plain
PyTorch versions in float64.

Everything above each source's launch section is plain C++ on pointers, so
the per-step maps and the three scan passes run here unchanged; only the
launch itself needs nvcc and a card. Tolerance: both sides compute the same
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

from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda import kalman_fused as KF  # noqa: E402
from aux_ssm_tpu_torch.ops.cuda._build import CSRC, MAX_DIM  # noqa: E402
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
#define D %(D)d
extern "C" {
void h_make_elements(int n, int dx, int dy, const double* F, const double* Q,
    const double* b, const double* H, const double* R, const double* c, const double* y,
    const double* m, const double* P, double* A, double* bel, double* C, double* eta,
    double* J) {
  double sm[map_scratch<D>()];
  for (int t = 0; t < n; ++t)
    elements_step<double, D>(0, 1, t, dx, dy, F, Q, b, H, R, c, y, m, P, A, bel, C, eta, J, sm);
}
void h_ell(int n, int dx, int dy, const double* F, const double* Q, const double* b,
    const double* H, const double* R, const double* c, const double* y, const double* m,
    const double* P, double* out) {
  double sm[map_scratch<D>()];
  for (int t = 0; t < n; ++t) ell_step<double, D>(0, 1, t, dx, dy, F, Q, b, H, R, c, y, m, P, out, sm);
}
void h_backward_maps(int n, int dx, const double* F, const double* Q, const double* b,
    const double* m, const double* P, const double* eps, double* G, double* inc) {
  double sm[map_scratch<D>()];
  for (int t = 0; t < n; ++t) backward_maps_step<double, D>(0, 1, t, dx, F, Q, b, m, P, eps, G, inc, sm);
}
void h_logdensity_steps(int n, int dx, int dy, const double* F, const double* Q,
    const double* b, const double* H, const double* R, const double* c, const double* y,
    const double* xp, const double* xc, double* out) {
  double sm[map_scratch<D>()];
  for (int t = 0; t < n; ++t)
    logdensity_step<double, D>(0, 1, t, dx, dy, F, Q, b, H, R, c, y, xp, xc, out, sm);
}
}
"""

_SCAN = """
#include "scan.cu"
#define D %(D)d
template <class Op>
static void host_scan(int n, int d, bool rev, typename Op::View x, typename Op::View out,
                      typename Op::View t0, typename Op::View t1) {
  typename Op::Scalar sm[Op::kScratch];
  for (int c = 0; c < kChunks; ++c) scan_chunk<Op>(0, 1, c, n, d, rev, x, out, t0, sm);
  typename Op::View src = t0, dst = t1;
  for (int off = 1; off < kChunks; off *= 2) {
    for (int c = 0; c < kChunks; ++c) scan_level<Op>(0, 1, c, off, d, src, dst, sm);
    typename Op::View t = src; src = dst; dst = t;
  }
  for (int c = 0; c < kChunks; ++c) scan_apply<Op>(0, 1, c, n, d, rev, src, out, sm);
}
extern "C" {
void h_filter_scan(int n, int d, double* A, double* b, double* C, double* e, double* J,
                   double* oA, double* ob, double* oC, double* oe, double* oJ, double* s) {
  using V = FilterView<double>;
  const long mat = (long)kChunks * d * d, vec = (long)kChunks * d;
  double* s1 = s + 3 * mat + 2 * vec;
  host_scan<FilterOp<double, D>>(n, d, false, V{A, b, C, e, J}, V{oA, ob, oC, oe, oJ},
      V{s, s + mat, s + mat + vec, s + 2 * mat + vec, s + 2 * mat + 2 * vec},
      V{s1, s1 + mat, s1 + mat + vec, s1 + 2 * mat + vec, s1 + 2 * mat + 2 * vec});
}
void h_affine_scan(int n, int d, int rev, double* G, double* e, double* oG, double* oe,
                   double* s) {
  using V = AffineView<double>;
  const long mat = (long)kChunks * d * d, vec = (long)kChunks * d;
  double* s1 = s + mat + vec;
  host_scan<AffineOp<double, D>>(n, d, rev != 0, V{G, e}, V{oG, oe}, V{s, s + mat},
                                 V{s1, s1 + mat});
}
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources as host code")
    out = tmp_path_factory.mktemp("csrc_host")
    libs = {}
    for name, body in (("maps", _MAPS), ("scan", _SCAN)):
        src = out / f"{name}.cpp"
        src.write_text(_PRELUDE + body % {"D": MAX_DIM})
        so = out / f"lib{name}.so"
        subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(CSRC),
                        "-o", str(so), str(src)], check=True, capture_output=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _call(fn, *args):
    c_args = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
              else ctypes.c_int(int(a)) for a in args]
    fn(*c_args)


def _model(T, dx, dy, seed, nan_frac=0.0):
    from oracles import random_lgssm, simulate
    rng = np.random.default_rng(seed)
    params = random_lgssm(rng, T, dx, dy)
    ys = simulate(rng, *params)
    if nan_frac:
        ys = np.where(rng.uniform(size=ys.shape) < nan_frac, np.nan, ys)
    return LGSSM(*(torch.as_tensor(z) for z in params)), torch.as_tensor(ys)


def _close(got, want, rtol=1e-9, atol=1e-11):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("T,dx,dy,nan_frac", [(23, 2, 2, 0.0), (64, 4, 3, 0.3),
                                              (40, 3, 1, 0.0)])
def test_host_maps_match_plain(host_lib, T, dx, dy, nan_frac):
    lib = host_lib["maps"]
    lg, ys = _model(T, dx, dy, seed=T, nan_frac=nan_frac)
    m0, P0, Fs, Qs, bs, Hs, Rs, cs = lg
    n = T - 1
    obs = (Hs[1:].contiguous(), Rs[1:].contiguous(), cs[1:].contiguous(), ys[1:].contiguous())

    m0u, P0u, _ = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])
    m = torch.cat([m0u[None], torch.zeros(n - 1, dx, dtype=torch.float64)])
    P = torch.cat([P0u[None], torch.zeros(n - 1, dx, dx, dtype=torch.float64)])
    want = KF.make_elements_plain(Fs, Qs, bs, *obs, m, P)
    got = tuple(torch.empty_like(w) for w in want)
    _call(lib.h_make_elements, n, dx, dy, Fs, Qs, bs, *obs, m, P, *got)
    for g, w in zip(got, want):
        _close(g, w)

    ms, Ps, _ = filtering(ys, lg, parallel=True)
    ms0, Ps0 = ms[:-1].contiguous(), Ps[:-1].contiguous()
    want = KF.ell_plain(Fs, Qs, bs, *obs, ms0, Ps0)
    got = torch.empty_like(want)
    _call(lib.h_ell, n, dx, dy, Fs, Qs, bs, *obs, ms0, Ps0, got)
    _close(got, want)

    eps = torch.as_tensor(np.random.default_rng(1).standard_normal((n, dx)))
    want = KF.backward_maps_plain(Fs, Qs, bs, ms0, Ps0, eps)
    got = tuple(torch.empty_like(w) for w in want)
    _call(lib.h_backward_maps, n, dx, Fs, Qs, bs, ms0, Ps0, eps, *got)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-7, atol=1e-9)  # jittered Cholesky of a near-singular cov

    xs = torch.as_tensor(np.random.default_rng(2).standard_normal((T, dx)))
    xp, xc = xs[:-1].contiguous(), xs[1:].contiguous()
    want = KF.logdensity_steps_plain(Fs, Qs, bs, *obs, xp, xc)
    got = torch.empty_like(want)
    _call(lib.h_logdensity_steps, n, dx, dy, Fs, Qs, bs, *obs, xp, xc, got)
    _close(got, want)


@pytest.mark.parametrize("T,dx,dy", [(17, 2, 2), (300, 3, 2), (129, 1, 1)])
def test_host_filter_scan_matches_plain(host_lib, T, dx, dy):
    lg, ys = _model(T, dx, dy, seed=3)
    m0, P0, Fs, Qs, bs, Hs, Rs, cs = lg
    m0u, P0u, _ = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])
    elems = tuple(z.contiguous() for z in _make_associative_elements(
        Fs, Qs, bs, Hs[1:], Rs[1:], cs[1:], ys[1:], m0u, P0u))
    want = FS.filter_scan_plain(elems)
    got = tuple(torch.empty_like(z) for z in elems)
    scratch = torch.empty(2 * FS.CHUNKS * (3 * dx * dx + 2 * dx), dtype=torch.float64)
    _call(host_lib["scan"].h_filter_scan, T - 1, dx, *elems, *got, scratch)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("T,d,reverse", [(50, 3, True), (300, 2, True), (100, 4, False)])
def test_host_affine_scan_matches_plain(host_lib, T, d, reverse):
    rng = np.random.default_rng(1)
    gains = torch.as_tensor(0.4 * rng.standard_normal((T, d, d)))
    incs = torch.as_tensor(rng.standard_normal((T, d)))
    want = FS.affine_scan_plain(gains, incs, reverse=reverse)
    got = tuple(torch.empty_like(z) for z in want)
    scratch = torch.empty(2 * FS.CHUNKS * (d * d + d), dtype=torch.float64)
    _call(host_lib["scan"].h_affine_scan, T, d, reverse, gains, incs, *got, scratch)
    for g, w in zip(got, want):
        _close(g, w)
