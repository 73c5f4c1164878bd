"""Kalman filtering: sequential loop and parallel-in-time associative scan
(counterpart of `aux_ssm_tpu/ops/filtering.py`).

The parallel filter is the Särkkä & García-Fernández (2021) formulation:
each time step contributes a 5-tuple element (A, b, C, eta, J) and filtering
is their inclusive associative scan. Elements, scan and log-likelihood
increments go through the wrappers of `ops/cuda/`, which launch the CUDA
kernels for CUDA tensors and run the plain versions for CPU tensors. The
t = 0 update stays in plain torch.
"""
import torch

from .batched import mT, mv, sym, bdiag
from .chol import cholesky
from .lgssm import LGSSM, mask_observation, _LOG_2PI
from .cuda import kalman_fused as _fused
from .cuda.filter_scan import filter_scan


def filtering(ys, lgssm: LGSSM, parallel: bool):
    """Kalman filter.

    Parameters
    ----------
    ys : Tensor (T, dy)
        Observations; NaN components are treated as missing.
    lgssm : LGSSM
        Model parameters (see `lgssm.LGSSM` for shapes).
    parallel : bool
        The parallel-in-time associative-scan filter, or a sequential loop.

    Returns
    -------
    ms : Tensor (T, dx) — filtered means
    Ps : Tensor (T, dx, dx) — filtered covariances
    ell : scalar — marginal log-likelihood log p(y_{0:T})
    """
    impl = _parallel_filtering if parallel else _sequential_filtering
    ms, Ps, ell = impl(ys, *lgssm)
    if ell.ndim >= 1:
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
    _, ms, Ps, _, _ = filter_scan(elems)
    ms = torch.cat([m0[None], ms])
    Ps = torch.cat([P0[None], Ps])
    # The scan gives the filtered moments; the log-likelihood increments are
    # one embarrassingly parallel predict + update per step.
    ell_incs = _fused.ell(Fs, Qs, bs, Hs[1:], Rs[1:], cs[1:], ys[1:], ms[:-1], Ps[:-1])
    return ms, Ps, ell0 + ell_incs.sum(0)


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
    return _fused.make_elements(Fs, Qs, bs, Hs, Rs, cs, ys, m, P)
