"""The scalar AR(1) toy of the large-N cSMC benchmark configuration (the
model of `benchmarks/baseline_configs.py` config 5, T=1024, N=4096):
    x_0 ~ N(0, 1),  x_{t+1} = a x_t + sig_x eps,  y_t ~ N(x_t, sig_y^2)
with a = 0.9, sig_x = sig_y = 0.5. Its forward sweep is the lane sweep; on
the card the model is the functor `Ar1Gauss` of `ops/cuda/csrc/csmc_models.cuh`.
"""
from dataclasses import dataclass

import torch

from ..kernels.csmc_base import Distribution, Dynamics, Potential, UnivariatePotential, rows
from ..ops.mvn import norm_logpdf

A, SIG_X, SIG_Y = 0.9, 0.5, 0.5


@dataclass(frozen=True)
class Ar1M0(Distribution):
    def sample_from_noise(self, eps):
        return eps.clone()


@dataclass(frozen=True)
class Ar1G0(UnivariatePotential):
    def __call__(self, x):
        return norm_logpdf(x, 0.0, 1.0).sum(-1)


@dataclass(frozen=True)
class Ar1Mt(Dynamics):
    """params unused (T-1, 0)."""
    cuda_model = "ar1_gauss"

    def sample_from_noise(self, eps, x_t, params):
        return A * x_t + SIG_X * eps

    def logpdf(self, x_next, x_t, params):
        return norm_logpdf(x_next, A * x_t, SIG_X).sum(-1)

    def lane_propagate(self, eps, x_prev, params):
        return A * x_prev + SIG_X * eps

    def lane_logpdf(self, x_next, x_prev, params):
        return norm_logpdf(x_next, A * x_prev, SIG_X)


@dataclass(frozen=True, kw_only=True)
class Ar1Gt(Potential):
    """log N(y_t; x_{t+1}, sig_y^2); params = ys (T-1, 1). `consts` are the
    functor's constants [a, sig_x, sig_y]."""
    consts: torch.Tensor
    cuda_model = "ar1_gauss"

    def __call__(self, x_next, x_t, y):
        return norm_logpdf(rows(y, x_next), x_next, SIG_Y).sum(-1)

    def lane_logw(self, x_next, x_prev, y):
        return norm_logpdf(y, x_next, SIG_Y)

    def cuda_operands(self):
        """(constants, per-step rows [y_t]) of the `ar1_gauss` functor."""
        return self.consts, self.params


def get_feynman_kac(ys):
    """(M0, G0, Mt, Gt) for observations `ys` (T-1, 1) of steps 1..T-1, which
    set dtype and device (the benchmark configuration uses zeros)."""
    consts = torch.tensor([A, SIG_X, SIG_Y], dtype=torch.float64).to(dtype=ys.dtype,
                                                                      device=ys.device)
    return (Ar1M0(), Ar1G0(), Ar1Mt(params=ys.new_zeros(ys.shape[0], 0)),
            Ar1Gt(params=ys, consts=consts))
