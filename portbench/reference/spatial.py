"""Plain reference of the spatio-temporal Student-t model (Corenflos &
Särkkä; AdrienCorenflos/aux-ssm-samplers, examples/spatial):

    x_t in R^B, B = d^2 (a d x d grid),  x_0 ~ N(0, sigma_x^2 I),
    x_{t+1} = x_t + sigma_x e_t,
    y_t ~ t_nu(x_t, P^{-1}),  P_ij = tau^D(i, j) where the Manhattan
    distance D(i, j) <= r_y on the grid, else 0,

its data simulation and the guided proposal of the csmc-guided sampler:
the random-walk step N(x_prev, sigma_x^2) combined with the auxiliary
observation u ~ N(x, scale^2), K = sigma_x^2 / (sigma_x^2 + scale^2).
The Student-t density is taken without its normalising constant, which
cancels from every normalised weight.
"""
import numpy as np
import torch

from .gauss import norm_logpdf, products


def precision(cfg):
    """The dense (B, B) precision, float64 NumPy."""
    d, tau, r = cfg["D"], cfg["tau"], cfg["r_y"]
    i = np.arange(d * d)
    D = (np.abs(i[:, None] // d - i[None, :] // d) + np.abs(i[:, None] % d - i[None, :] % d))
    return np.where(D <= r, np.power(float(tau), D.astype(np.float64)), 0.0)


def simulate(cfg, seed):
    """(xs, ys), each (T, B) float64 on the CPU, from NumPy's generator."""
    rng = np.random.default_rng(seed)
    T, B, nu, sx = cfg["T"], cfg["D"] ** 2, cfg["nu"], cfg["sigma_x"]
    L = np.linalg.cholesky(np.linalg.inv(precision(cfg)))
    xs = np.cumsum(sx * rng.standard_normal((T, B)), axis=0)
    g = rng.standard_normal((T, B)) @ L.T
    w = rng.chisquare(nu, size=(T, 1)) / nu
    return torch.from_numpy(xs), torch.from_numpy(xs + g / np.sqrt(w))


class Model:
    """The model on a device and dtype, for C chains (x (C, T, B)); with
    `tf32`, every matrix product in TF32."""

    def __init__(self, cfg, ys, dtype, device, tf32=False):
        kw = dict(dtype=dtype, device=device)
        self.mm = products(tf32)
        self.ys = ys.to(**kw)
        self.P = torch.as_tensor(precision(cfg), **kw)
        self.sx, self.nu, self.B = cfg["sigma_x"], cfg["nu"], cfg["D"] ** 2

    def potential(self, x, y):
        """-(nu + B) / 2 log(1 + (y - x)^T P (y - x) / nu), over the last
        axis."""
        r = y - x
        q = (self.mm(r, self.P) * r).sum(-1)
        return torch.nan_to_num(-0.5 * (self.nu + self.B) * torch.log1p(q / self.nu))

    def guided(self, u, scale):
        s2 = self.sx ** 2
        K = s2 / (s2 + scale ** 2)
        return {"u": u, "scale": scale, "K": K, "sd": torch.sqrt(s2 * (1.0 - K))}

    def propose(self, p, sl, x_prev, eps):
        q = _rows(p, sl)
        x_pred = torch.zeros_like(eps) if x_prev is None else x_prev
        return x_pred + q["K"] * (q["u"] - x_pred) + q["sd"] * eps

    def log_weight(self, p, sl, x, x_prev, y):
        q = _rows(p, sl)
        x_pred = torch.zeros_like(x) if x_prev is None else x_prev
        mean = x_pred + q["K"] * (q["u"] - x_pred)
        return (self.potential(x, y) + norm_logpdf(x, x_pred, self.sx).sum(-1)
                + norm_logpdf(x, q["u"], q["scale"]).sum(-1)
                - norm_logpdf(x, mean, q["sd"]).sum(-1))

    def trans_logpdf(self, x_next, x):
        return norm_logpdf(x_next, x, self.sx).sum(-1)


def _rows(p, sl):
    out = {}
    for k, v in p.items():
        v = v[:, sl]
        out[k] = v[..., None, :] if k == "u" else v[..., None, None]
    return out

