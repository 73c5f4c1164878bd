"""Theta-logistic population model: particle Gibbs with ancestor sampling
(PGAS) on the classic nonlinear population SSM (counterpart of
`aux_ssm_tpu/models/theta_logistic.py`).

Model (log-abundance x):
    x_0 ~ N(m0, sig0^2)
    x_{t+1} = x_t + tau0 - tau1 * exp(tau2 * x_t) + sig_x eps
    y_t = x_t + sig_y eta

The state is scalar and the proposals are the dynamics (bootstrap), so the
forward sweep is the lane sweep (`ops/cuda/csmc_fwd.lane_scan`), on the card
with the model compiled into the kernel as the functor `ThetaLogistic` of
`ops/cuda/csrc/csmc_models.cuh`. Functions that take a `device` allocate on
the card when it is None (`device.default_device`).
"""
from dataclasses import dataclass

import torch

from ..device import resolve
from ..kernels import csmc
from ..kernels.csmc_base import (Distribution, Dynamics, Potential, UnivariatePotential,
                                 diag_gaussian_pair_factors, mark_chains, rows,
                                 shared_by_chains)
from ..ops.mvn import norm_logpdf

DEFAULTS = dict(tau0=0.15, tau1=0.12, tau2=0.10, sig_x=0.3, sig_y=0.1, m0=1.0, sig0=0.5)


def drift(x, tau0, tau1, tau2):
    return x + tau0 - tau1 * torch.exp(tau2 * x)


def get_data(T, *, generator=None, dtype=torch.float64, device=None, **params):
    """Simulate (xs, ys), each (T, 1), with normals from `generator` (a CPU
    generator: the simulation runs in float64 on the CPU, and the result is
    moved to `device`)."""
    device = resolve(device)
    p = {**DEFAULTS, **params}
    eps = torch.randn(2 * T, generator=generator, dtype=torch.float64)
    x = p["m0"] + p["sig0"] * eps[0]
    xs = [x]
    for t in range(1, T):
        x = drift(x, p["tau0"], p["tau1"], p["tau2"]) + p["sig_x"] * eps[t]
        xs.append(x)
    xs = torch.stack(xs)[:, None]
    ys = xs + p["sig_y"] * eps[T:, None]
    return xs.to(dtype=dtype, device=device), ys.to(dtype=dtype, device=device)


@dataclass(frozen=True)
class ThetaM0(Distribution):
    """x_0 ~ N(m0, sig0^2)."""
    m0: float
    sig0: float

    def sample_from_noise(self, eps):
        return self.m0 + self.sig0 * eps

    def logpdf(self, x):
        return norm_logpdf(x, self.m0, self.sig0).sum(-1)


@dataclass(frozen=True, kw_only=True)
class ThetaMt(Dynamics):
    """The model's transition (the bootstrap proposal); params unused (T-1, 0)."""
    tau0: float
    tau1: float
    tau2: float
    sig_x: float
    cuda_model = "theta_logistic"

    def _mu(self, x):
        return drift(x, self.tau0, self.tau1, self.tau2)

    def sample_from_noise(self, eps, x_t, params):
        return self._mu(x_t) + self.sig_x * eps

    def logpdf(self, x_next, x_t, params):
        return norm_logpdf(x_next, self._mu(x_t), self.sig_x).sum(-1)

    def logpdf_factors(self, x_prev, x_next, params):
        return diag_gaussian_pair_factors(self._mu(x_prev), x_next, self.sig_x)

    # (N,)-row callables of the lane sweep.
    def lane_propagate(self, eps, x_prev, params):
        return self._mu(x_prev) + self.sig_x * eps

    def lane_logpdf(self, x_next, x_prev, params):
        return norm_logpdf(x_next, self._mu(x_prev), self.sig_x)


@dataclass(frozen=True)
class ThetaG0(UnivariatePotential):
    """log N(y_0; x, sig_y^2)."""
    y0: torch.Tensor
    sig_y: float

    def __call__(self, x):
        return norm_logpdf(self.y0, x, self.sig_y).sum(-1)


@dataclass(frozen=True, kw_only=True)
class ThetaGt(Potential):
    """log N(y_t; x_{t+1}, sig_y^2); params = ys[1:]. `consts` are the
    functor's constants [tau0, tau1, tau2, sig_x, sig_y]."""
    sig_y: float
    consts: torch.Tensor
    prev_dependent = False
    cuda_model = "theta_logistic"

    def __call__(self, x_next, x_t, y):
        return norm_logpdf(rows(y, x_next), x_next, self.sig_y).sum(-1)

    def lane_logw(self, x_next, x_prev, y):
        return norm_logpdf(y, x_next, self.sig_y)

    def cuda_operands(self):
        """(constants, per-step rows [y_t]) of the `theta_logistic` functor."""
        return self.consts, self.params


def get_feynman_kac(ys, chains=False, **params):
    """Bootstrap Feynman–Kac decomposition (M0, G0, Mt, Gt): proposals = model
    dynamics, potentials = observation densities. `ys` (T, 1) sets dtype and
    device. With `chains`, for C chains on a leading axis: the per-step
    params, which every chain shares, carry a unit chain axis
    (`csmc_base.shared_by_chains`)."""
    p = {**DEFAULTS, **params}
    T = ys.shape[0]
    consts = torch.tensor([p[k] for k in ("tau0", "tau1", "tau2", "sig_x", "sig_y")],
                          dtype=torch.float64).to(dtype=ys.dtype, device=ys.device)
    Mt = ThetaMt(params=ys.new_zeros(T - 1, 0), tau0=p["tau0"], tau1=p["tau1"], tau2=p["tau2"],
                 sig_x=p["sig_x"])
    Gt = ThetaGt(params=ys[1:], sig_y=p["sig_y"], consts=consts)
    if chains:
        Mt, Gt = shared_by_chains(Mt), shared_by_chains(Gt)
    return ThetaM0(p["m0"], p["sig0"]), ThetaG0(ys[0], p["sig_y"]), Mt, Gt


def get_pgas_kernel(ys, n_particles, backward=False, ancestor_sampling=True,
                    resampling="multinomial", chains=False, **params):
    """Particle Gibbs with ancestor sampling (bootstrap proposals). Returns
    (init, kernel) with `kernel(state, generator=None, noise=None)`: no delta
    (bootstrap cSMC has no auxiliary step size). With `chains`, C chains as
    one batched step over a leading chain axis (x (C, T, 1), the noise with
    a leading C; `kernels/csmc.py`): one lane sweep a step for all C chains,
    then ancestor scanning (or the backward factor sweep) over the chains;
    the kernel is marked `chain_axis`."""
    M0, G0, Mt, Gt = get_feynman_kac(ys, chains, **params)
    return mark_chains(csmc.get_kernel(M0, G0, Mt, Gt, n_particles, backward=backward, Pt=Mt,
                                       resampling=resampling,
                                       ancestor_sampling=ancestor_sampling), chains)
