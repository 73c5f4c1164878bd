"""Kalman filtering: sequential loop and parallel-in-time associative scan
(counterpart of `aux_ssm_tpu/ops/filtering.py`).

The parallel filter is the Särkkä & García-Fernández (2021) formulation:
each time step contributes a 5-tuple element (A, b, C, eta, J) and filtering
is their inclusive associative scan.

Two layouts, told apart by `bs.ndim` (see `lgssm`):
  - unbatched, one filter of state width dx: ys (T, dy), m0 (dx,), P0 (dx, dx),
    Fs/Qs (T-1, dx, dx), bs (T-1, dx), Hs (T, dy, dx), Rs (T, dy, dy),
    cs (T, dy). Elements, scan and log-likelihood increments go through the
    d x d wrappers of `ops/cuda/` where max(dx, dy) has a kernel instance
    in the dtype (`_build.has_instance`), else through their plain versions on any
    device; the t = 0 update stays in plain torch.
  - batched scalar, B independent filters with dx = dy = 1 (the spatial
    model): ys (T, B, 1), m0 (B, 1), P0 (B, 1, 1), Fs/Qs (T-1, B, 1, 1),
    bs (T-1, B, 1), Hs/Rs (T, B, 1, 1), cs (T, B, 1). Elements and
    log-likelihood increments are elementwise closed forms on (n, B) tensors
    in plain torch (the JAX package computes them outside any kernel too);
    only the scan goes through a kernel, `ops/cuda/scalar_scan`. The
    log-likelihood is summed over B.
  - dense batched, C independent filters of any width (C chains): ys (T, C,
    dy), the parameters (T[-1], C, ...) or broadcasting to it (`lgssm`).
    The d x d wrappers take the chain axis: each of the three kernels is one
    launch for all C chains, whatever C is.
Every wrapper of `ops/cuda/` launches its CUDA kernel for CUDA tensors and
runs its plain version for CPU tensors.
"""
import torch

from .batched import mT, mv, sym, bdiag
from .chol import cholesky
from .lgssm import LGSSM, batched_scalar_layout, mask_observation, _LOG_2PI
from .cuda import kalman_fused as _fused
from .cuda._build import has_instance
from .cuda.filter_scan import filter_scan, filter_scan_plain
from .cuda.scalar_scan import scalar_filter_scan


def filtering(ys, lgssm: LGSSM, parallel: bool, keep_batch: bool = False):
    """Kalman filter.

    Parameters
    ----------
    ys : Tensor (T, dy), or (T, B, dy) in a batched layout
        Observations; NaN components are treated as missing.
    lgssm : LGSSM
        Model parameters (see `lgssm.LGSSM` for shapes).
    parallel : bool
        The parallel-in-time associative-scan filter, or a sequential loop.

    Returns
    -------
    ms : Tensor (T, [B,] dx) — filtered means
    Ps : Tensor (T, [B,] dx, dx) — filtered covariances
    ell : scalar — marginal log-likelihood log p(y_{0:T}) (a batched layout:
        summed over B, or with `keep_batch` one a filter, (B,))
    """
    if not parallel:
        impl = _sequential_filtering  # broadcasts over a batched layout's B
    elif batched_scalar_layout(lgssm.bs, lgssm.cs):
        impl = _parallel_filtering_scalar
    else:
        impl = _parallel_filtering
    ms, Ps, ell = impl(ys, *lgssm)
    if ell.ndim >= 1 and not keep_batch:
        ell = ell.sum()
    return ms, Ps, ell


def kalman_update(y, m, P, H, c, R):
    """Masked measurement update. Missing components of `y` drop out exactly;
    a fully-missing step reduces to the identity (G = 0, ell_inc = 0).
    Broadcasts over leading batch dims."""
    y_eff, H_eff, c_eff, R_eff, mask = mask_observation(y, H, c, R)
    n_obs = mask.to(m.dtype).sum(-1)

    innov = torch.where(mask, y_eff - (mv(H_eff, m) + c_eff), 0.0)
    S = sym(R_eff + H_eff @ P @ mT(H_eff))

    if y.shape[-1] == 1:
        chol_S = torch.sqrt(S)
        G = (P @ mT(H_eff)) / S[..., :1, :]
        w = innov / chol_S[..., 0]
        log_det = torch.log(chol_S[..., 0, 0])
    else:
        chol_S = cholesky(S)
        G = mT(torch.cholesky_solve(H_eff @ P, chol_S))
        w = torch.linalg.solve_triangular(chol_S, innov.unsqueeze(-1), upper=False)[..., 0]
        log_det = torch.log(bdiag(chol_S)).sum(-1)

    # The masked block has a unit diagonal, so log det and the quadratic form
    # count observed dimensions only.
    ell_inc = -0.5 * (w * w).sum(-1) - log_det - 0.5 * n_obs * _LOG_2PI
    m_new = m + mv(G, innov)
    P_new = sym(P - G @ S @ mT(G))
    return m_new, P_new, ell_inc


def kalman_predict(m, P, F, b, Q):
    return mv(F, m) + b, sym(Q + F @ P @ mT(F))


def kalman_predict_update(m, P, F, b, Q, y, H, c, R):
    m, P = kalman_predict(m, P, F, b, Q)
    return kalman_update(y, m, P, H, c, R)


def _sequential_filtering(ys, m0, P0, Fs, Qs, bs, Hs, Rs, cs):
    m, P, ell = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])
    ms, Ps = [m], [P]
    for t in range(1, ys.shape[0]):
        m, P, ell_inc = kalman_predict_update(m, P, Fs[t - 1], bs[t - 1], Qs[t - 1],
                                              ys[t], Hs[t], cs[t], Rs[t])
        ell = ell + ell_inc
        ms.append(m)
        Ps.append(P)
    return torch.stack(ms), torch.stack(Ps), ell


def _parallel_filtering(ys, m0, P0, Fs, Qs, bs, Hs, Rs, cs):
    # The t = 0 update is outside the scan; the first element carries it.
    m0, P0, ell0 = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])
    elems = _make_associative_elements(Fs, Qs, bs, Hs[1:], Rs[1:], cs[1:], ys[1:], m0, P0)
    kernels = has_instance(m0.shape[-1], ys.shape[-1], dtype=bs.dtype)
    _, ms, Ps, _, _ = (filter_scan if kernels else filter_scan_plain)(elems)
    ms = torch.cat([m0[None], ms])
    Ps = torch.cat([P0[None], Ps])
    # The scan gives the filtered moments; the log-likelihood increments are
    # one embarrassingly parallel predict + update per step.
    ell = _fused.ell if kernels else _fused.ell_plain
    ell_incs = ell(Fs, Qs, bs, Hs[1:], Rs[1:], cs[1:], ys[1:], ms[:-1], Ps[:-1])
    return ms, Ps, ell0 + ell_incs.sum(0)


# --- batched scalar layout ------------------------------------------------

def _scalar_update(y, m, P, H, c, R):
    """`kalman_update` for dx = dy = 1 on tensors without the unit axes."""
    mask = torch.isfinite(y)
    H_eff = torch.where(mask, torch.nan_to_num(H), 0.0)
    innov = torch.where(mask, torch.nan_to_num(y) - (H_eff * m + torch.nan_to_num(c)), 0.0)
    S = torch.where(mask, torch.nan_to_num(R), 1.0) + H_eff * P * H_eff
    G = P * H_eff / S
    ell_inc = -0.5 * (innov * innov / S + torch.log(S)) - 0.5 * _LOG_2PI * mask.to(m.dtype)
    return m + G * innov, P - G * S * G, ell_inc


def _scalar_elements(F, Q, b, H, R, c, y, m0, P0):
    """`_make_associative_elements` for dx = dy = 1: (A, b, C, eta, J), each
    (n, B), from (n, B) parameters and the updated initial state (B,)."""
    mask = torch.isfinite(y)
    H_eff = torch.where(mask, torch.nan_to_num(H), 0.0)
    resid = torch.where(mask, torch.nan_to_num(y) - torch.nan_to_num(c), 0.0)

    # Only the first element carries a state: m_pred = b and P_pred = Q elsewhere.
    m_pred, P_pred = b.clone(), Q.clone()
    m_pred[0] += F[0] * m0
    P_pred[0] += F[0] * P0 * F[0]

    S = H_eff * P_pred * H_eff + torch.where(mask, torch.nan_to_num(R), 1.0)
    S_invH = H_eff / S
    K = P_pred * S_invH
    HF = H_eff * F
    A = F - K * HF
    b_el = m_pred + K * (resid - H_eff * m_pred)
    C = P_pred - K * S * K
    temp = F * S_invH
    eta = temp * (resid - H_eff * b)
    J = temp * HF
    return A, b_el, C, eta, J


def _parallel_filtering_scalar(ys, m0, P0, Fs, Qs, bs, Hs, Rs, cs):
    y, m0, P0 = ys[..., 0], m0[..., 0], P0[..., 0, 0]
    F, Q, b = Fs[..., 0, 0], Qs[..., 0, 0], bs[..., 0]
    H, R, c = Hs[..., 0, 0], Rs[..., 0, 0], cs[..., 0]
    m0, P0, ell0 = _scalar_update(y[0], m0, P0, H[0], c[0], R[0])
    if y.shape[0] == 1:
        return m0[None, :, None], P0[None, :, None, None], ell0
    shape = y[1:].shape
    elems = tuple(z.expand(shape) for z in
                  _scalar_elements(F, Q, b, H[1:], R[1:], c[1:], y[1:], m0, P0))
    _, ms, Ps, _, _ = scalar_filter_scan(elems)
    ms = torch.cat([m0[None], ms])
    Ps = torch.cat([P0[None], Ps])
    *_, ell_incs = _scalar_update(y[1:], F * ms[:-1] + b, Q + F * Ps[:-1] * F,
                                  H[1:], c[1:], R[1:])
    return ms[..., None], Ps[..., None, None], ell0 + ell_incs.sum(0)


# --- associative elements -------------------------------------------------

def filtering_operator(elem1, elem2):
    """Associative combination of two filtering elements (SGF 2021, Lemma 8).

    One inverse Z = (I + C1 J2)^{-1} serves both solves: since C and J are
    symmetric, (I + J2 C1)^T = I + C1 J2, hence A2 (I + C1 J2)^{-1} = A2 Z and
    solve((I + J2 C1)^T, A1)^T = (Z A1)^T. Batched over leading dims.
    """
    A1, b1, C1, eta1, J1 = elem1
    A2, b2, C2, eta2, J2 = elem2
    dx = A1.shape[-1]
    if dx == 1:
        # Scalar fast path: the inverse is a reciprocal and every matmul a product.
        a1, c1, j1 = A1[..., 0, 0], C1[..., 0, 0], J1[..., 0, 0]
        a2, c2, j2 = A2[..., 0, 0], C2[..., 0, 0], J2[..., 0, 0]
        v1, n1 = b1[..., 0], eta1[..., 0]
        v2, n2 = b2[..., 0], eta2[..., 0]
        z = 1.0 / (1.0 + c1 * j2)
        a2z = a2 * z
        za1 = z * a1
        A = a2z * a1
        b = a2z * (v1 + c1 * n2) + v2
        C = a2z * c1 * a2 + c2
        eta = za1 * (n2 - j2 * v1) + n1
        J = za1 * j2 * a1 + j1
        return (A[..., None, None], b[..., None], C[..., None, None],
                eta[..., None], J[..., None, None])
    eye = torch.eye(dx, dtype=A1.dtype, device=A1.device)

    Z = torch.linalg.inv(eye + C1 @ J2)
    A2Z = A2 @ Z
    ZA1 = Z @ A1

    A = A2Z @ A1
    b = mv(A2Z, b1 + mv(C1, eta2)) + b2
    C = A2Z @ (C1 @ mT(A2)) + C2
    eta = mv(mT(ZA1), eta2 - mv(J2, b1)) + eta1
    J = mT(ZA1) @ (J2 @ A1) + J1
    return A, b, sym(C), eta, sym(J)


def _make_associative_elements(Fs, Qs, bs, Hs, Rs, cs, ys, m0, P0):
    """All T-1 associative elements in one pass. The first element carries
    the updated initial state; the rest use zeros (the generic
    predict + update map). Fully missing observations reduce, exactly, to the
    pure-prediction element."""
    n = bs.shape[0]
    m = torch.cat([m0[None], m0.new_zeros((n - 1,) + m0.shape)])
    P = torch.cat([P0[None], P0.new_zeros((n - 1,) + P0.shape)])
    make = (_fused.make_elements if has_instance(m0.shape[-1], ys.shape[-1], dtype=bs.dtype)
            else _fused.make_elements_plain)
    return make(Fs, Qs, bs, Hs, Rs, cs, ys, m, P)
