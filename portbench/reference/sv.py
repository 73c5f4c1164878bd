"""Plain reference of the multivariate stochastic-volatility model
(Corenflos & Särkkä; AdrienCorenflos/aux-ssm-samplers,
examples/stochastic_volatility):

    x_0 ~ N(mu, Q),  x_{t+1} = mu + phi (x_t - mu) + e_t,  e_t ~ N(0, Q),
    y_t | x_t ~ N(0, diag(exp(x_t))),
    Q = tau ((1 - rho) I + rho 1 1^T) / (1 - phi^2),  mu = nu 1,

its data simulation, its target density, the second-order auxiliary
proposal of the kalman-2 sampler, and the guided proposal of the
csmc-guided sampler (the prior step N(F x + b, Q) combined with the
auxiliary observation u ~ N(x, delta / 2), worked in Q's eigenbasis, where
the proposal's gain and covariance are elementwise).
"""
import numpy as np
import torch

from .gauss import LOG_2PI, chol, mvn_logpdf, norm_logpdf, products


def constants(cfg):
    """(mu, Q, F, b) in float64 on the CPU."""
    d, phi, tau, rho, nu = cfg["D"], cfg["phi"], cfg["tau"], cfg["rho"], cfg["nu"]
    Q = tau * (rho * torch.ones(d, d, dtype=torch.float64)
               + (1 - rho) * torch.eye(d, dtype=torch.float64)) / (1 - phi ** 2)
    mu = nu * torch.ones(d, dtype=torch.float64)
    return mu, Q, phi * torch.eye(d, dtype=torch.float64), mu - phi * mu


def simulate(cfg, seed):
    """(xs, ys), each (T, D) float64 on the CPU, from NumPy's generator."""
    rng = np.random.default_rng(seed)
    mu, Q, F, b = (z.numpy() for z in constants(cfg))
    L = np.linalg.cholesky(Q)
    T, d = cfg["T"], cfg["D"]
    xs = np.empty((T, d))
    x = mu + L @ rng.standard_normal(d)
    for t in range(T):
        xs[t] = x
        x = F @ x + b + L @ rng.standard_normal(d)
    ys = np.exp(0.5 * xs) * rng.standard_normal((T, d))
    return torch.from_numpy(xs), torch.from_numpy(ys)


def obs_logpdf(x, y):
    """log N(y; 0, exp(x)) summed over the last axis; a non-finite term
    (a missing y) counts 0."""
    return torch.nan_to_num(norm_logpdf(y, 0.0, torch.exp(0.5 * x))).sum(-1)


class Model:
    """The model on a device and dtype, for C chains (x (C, T, d)); with
    `tf32`, every matrix product in TF32."""

    def __init__(self, cfg, ys, dtype, device, tf32=False):
        kw = dict(dtype=dtype, device=device)
        self.mm = products(tf32)
        mu, Q, F, b = constants(cfg)
        self.ys = ys.to(**kw)
        self.prior = tuple(z.to(**kw) for z in (mu, Q, F, Q, b))
        self.L_Q = chol(Q).to(**kw)
        self.F, self.b = F.to(**kw), b.to(**kw)
        lam, V = torch.linalg.eigh(Q)  # P0 = Q: one basis serves t = 0 and the steps
        self.lam, self.V = lam.to(**kw), V.to(**kw)
        self.m0 = mu.to(**kw)

    # ---- target and the kalman-2 proposal ----
    def target(self, x):
        m0, P0, F, Q, b = self.prior
        first = mvn_logpdf(x[:, 0], m0, self.L_Q, self.mm)
        trans = mvn_logpdf(x[:, 1:], self.mm(x[:, :-1], F.mT) + b, self.L_Q, self.mm).sum(-1)
        return first + trans + obs_logpdf(x, self.ys).sum(-1)

    def aux_obs(self, x, u, dl):
        """The second-order proposal's observations and their variances:
        the potential's diagonal Hessian h and gradient g at x, omega = 1 /
        (2 / delta - h), aux = omega (2 u / delta + g - h x)."""
        e = self.ys ** 2 * torch.exp(-x)
        h = torch.nan_to_num(-0.5 * e)
        g = torch.nan_to_num(0.5 * e - 0.5)
        omega = 1.0 / (2.0 / dl - h)
        return omega * (2.0 * u / dl + g - h * x), omega

    # ---- the guided proposal (particles (C, [n,] N, d)) ----
    def guided(self, u, scale):
        """Per-step parameters of the guided proposal at the auxiliary
        observations u (C, T, d) with scales (C, T)."""
        s2 = scale[..., None] ** 2
        g = self.lam / (self.lam + s2)
        var = self.lam * s2 / (self.lam + s2)
        return {"u": u, "scale": scale, "g": g, "sd": torch.sqrt(var),
                "half_logdet": 0.5 * torch.log(var).sum(-1), "rot_u": self.mm(u, self.V)}

    @staticmethod
    def _mean_z(zp, q):
        """The proposal mean in the eigenbasis from the prior mean's."""
        return zp + q["g"] * (q["rot_u"] - zp)

    def propose(self, p, sl, x_prev, eps):
        """Particles at steps `sl` of p (a slice of time, or 0) from their
        ancestors x_prev (None at t = 0: the prior N(mu, Q)) and normals eps
        (the eigenbasis coordinates at t >= 1, the state's at t = 0, as
        rotated by V there)."""
        q, mm = _rows(p, sl), self.mm
        if x_prev is None:
            zp = mm(self.m0[None], self.V)[0].expand_as(eps)
            eps = mm(eps, self.V)
        else:
            zp = mm(mm(x_prev, self.F.mT) + self.b, self.V)
        return mm(self._mean_z(zp, q) + q["sd"] * eps, self.V.mT)

    def log_weight(self, p, sl, x, x_prev, y):
        """Weights of particles x at steps `sl`: observation + prior step +
        auxiliary term - proposal density (all normalised)."""
        q, mm = _rows(p, sl), self.mm
        mean_prev = (self.m0.expand_as(x) if x_prev is None
                     else mm(x_prev, self.F.mT) + self.b)
        zp = mm(mean_prev, self.V)
        z = mm(x, self.V)
        zq = (z - zp) / torch.sqrt(self.lam)
        prior = -0.5 * (zq * zq).sum(-1) - 0.5 * torch.log(self.lam).sum() \
            - 0.5 * x.shape[-1] * LOG_2PI
        aux = norm_logpdf(x, q["u"], q["scale"][..., None]).sum(-1)
        zl = (z - self._mean_z(zp, q)) / q["sd"]
        prop = -0.5 * (zl * zl).sum(-1) - q["half_logdet"] - 0.5 * x.shape[-1] * LOG_2PI
        return obs_logpdf(x, y) + prior + aux - prop

    def trans_logpdf(self, x_next, x):
        """log N(x_next; F x + b, Q), broadcast."""
        return mvn_logpdf(x_next, self.mm(x, self.F.mT) + self.b, self.L_Q, self.mm)


def _rows(p, sl):
    """The parameters of steps `sl` aligned with particles (..., N, d)."""
    out = {}
    for k, v in p.items():
        v = v[:, sl]
        out[k] = v[..., None, :] if k in ("u", "g", "sd", "rot_u") else v[..., None]
    return out
