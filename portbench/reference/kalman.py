"""Plain reference of one auxiliary-Kalman MH step (Corenflos & Särkkä's
auxiliary sampler) over C chains, for a model whose prior is a linear
Gaussian state-space model and whose proposal observes the state directly
(H = I, c = 0, R diagonal), as the stochastic-volatility model's.

One step at x, given its noise (eps_aux, eps_smooth (C, T, d), u_accept
(C,)):
  u = x + sqrt(delta / 2) eps_aux;
  the proposal LGSSM at x (the model's `aux_obs`), its Kalman filter and one
  backward draw x' from eps_smooth: x'_T = m_T + chol(P_T) e_T, then x'_t =
  m_t + G_t (x'_{t+1} - F m_t - b) + chol(P_t - G_t S_t G_t^T) e_t with S_t
  = F P_t F^T + Q, G_t = P_t F^T S_t^{-1};
  log alpha = target(x') - target(x) + log q(x | x', u) - log q(x' | x, u)
  - sum((x' - u)^2 - (x - u)^2) / delta, each q the proposal's smoothing
  density (joint density minus the filter's log-likelihood);
  accept where u_accept < min(1, alpha).

The filter and the draw run as sequential loops over time, batched over
the chains; every product goes through the model's `mm`, so a model in
TF32 (`gauss.tf32_matmul`) takes them all to TF32.
"""
import torch

from .gauss import LOG_2PI, chol, matvec, mvn_logpdf


def kalman_filter(aux, R, m0, P0, F, Q, b, mm=torch.matmul):
    """Filtered means (C, T, d), covariances (C, T, d, d) and the
    log-likelihood (C,) of observations `aux` (C, T, d) of the state with
    noise variances R (C, T, d)."""
    C, T, d = aux.shape
    m = m0.expand(C, d)
    P = P0.expand(C, d, d)
    ms, Ps = [], []
    ell = aux.new_zeros(C)
    for t in range(T):
        if t:
            m = matvec(F, m, mm) + b
            P = mm(mm(F, P), F.mT) + Q
        S = P + torch.diag_embed(R[:, t])
        L = chol(S)
        innov = aux[:, t] - m
        z = torch.linalg.solve_triangular(L, innov[..., None], upper=False)[..., 0]
        log_det = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        ell = ell - 0.5 * (z * z).sum(-1) - log_det - 0.5 * d * LOG_2PI
        K = torch.cholesky_solve(P, L).mT            # P S^{-1}
        m = m + matvec(K, innov, mm)
        P = P - mm(mm(K, S), K.mT)
        P = 0.5 * (P + P.mT)
        ms.append(m)
        Ps.append(P)
    return torch.stack(ms, 1), torch.stack(Ps, 1), ell


def backward_draw(ms, Ps, F, Q, b, eps, mm=torch.matmul):
    """One joint smoothing draw (C, T, d) from filtered moments and the
    standard normals eps (C, T, d)."""
    T = ms.shape[1]
    x = ms[:, -1] + matvec(chol(Ps[:, -1]), eps[:, -1], mm)
    out = [x]
    for t in range(T - 2, -1, -1):
        m, P = ms[:, t], Ps[:, t]
        FP = mm(F, P)
        S = mm(FP, F.mT) + Q
        G = torch.cholesky_solve(FP, chol(S)).mT  # P F^T S^{-1}
        cov = P - mm(mm(G, S), G.mT)
        x = (m + matvec(G, x - matvec(F, m, mm) - b, mm)
             + matvec(chol(cov), eps[:, t], mm))
        out.append(x)
    return torch.stack(out[::-1], 1)


def prior_logpdf(x, m0, P0, F, Q, b, mm=torch.matmul):
    """log p(x_{0:T}) of the linear Gaussian prior, one value a chain."""
    first = mvn_logpdf(x[:, 0], m0, chol(P0), mm)
    trans = mvn_logpdf(x[:, 1:], mm(x[:, :-1], F.mT) + b, chol(Q), mm)
    return first + trans.sum(-1)


def smoothing_logpdf(x, aux, R, ell, prior, mm=torch.matmul):
    """log q(x | aux) = log p(x) + log p(aux | x) - log p(aux)."""
    obs = (-0.5 * (aux - x) ** 2 / R - 0.5 * torch.log(R) - 0.5 * LOG_2PI).sum((1, 2))
    return prior_logpdf(x, *prior, mm=mm) + obs - ell


def mh_step(model, x, delta, noise):
    """The step's proposal, log alpha, accept decision and next state:
    {x_prop (C, T, d), log_alpha (C,), accept (C,) bool, x_new}. `delta`
    (C,); `model` gives `prior` (m0, P0, F, Q, b), `aux_obs(x, u, delta)
    -> (aux, R)`, `target(x) -> (C,)` and its matrix product `mm`."""
    eps_aux, eps_smooth, u_accept = noise
    dl = delta[:, None, None]
    prior, mm = model.prior, model.mm
    u = x + torch.sqrt(0.5 * dl) * eps_aux
    aux, R = model.aux_obs(x, u, dl)
    ms, Ps, ell = kalman_filter(aux, R, *prior, mm=mm)
    m0, P0, F, Q, b = prior
    x_prop = backward_draw(ms, Ps, F, Q, b, eps_smooth, mm)
    log_fwd = smoothing_logpdf(x_prop, aux, R, ell, prior, mm)
    aux_r, R_r = model.aux_obs(x_prop, u, dl)
    ell_r = kalman_filter(aux_r, R_r, *prior, mm=mm)[2]
    log_rev = smoothing_logpdf(x, aux_r, R_r, ell_r, prior, mm)
    corr = (((x_prop - u) ** 2 - (x - u) ** 2) / dl).sum((1, 2))
    log_alpha = model.target(x_prop) - model.target(x) + log_rev - log_fwd - corr
    accept = u_accept < torch.exp(torch.clamp(log_alpha, max=0.0))
    x_new = torch.where(accept[:, None, None], x_prop, x)
    return {"x_prop": x_prop, "log_alpha": log_alpha, "accept": accept, "x_new": x_new}
