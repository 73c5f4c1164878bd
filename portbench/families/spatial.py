"""The spatio-temporal Student-t configuration family: the benchmark's
data, the program's batched step as `experiments/spatial.py` builds it, the
driver's start, and the plain reference model (`reference/spatial.py`)."""
from types import SimpleNamespace

import torch

from portbench.reference import spatial as reference


def simulate(cfg):
    return reference.simulate(cfg, cfg["data_seed"])


def build(cfg, traffic, ys):
    """(init, kernel) of the driver's `build_kernel` with `--n-chains C`:
    the one batched step of all C chains."""
    from aux_ssm_tpu_torch.experiments import spatial as driver
    driver_params = {"sigma_x": driver.SIGMA_X, "tau": driver.TAU, "r_y": driver.R_Y,
                     "nu": driver.NU}
    if any(cfg[k] != v for k, v in driver_params.items()):
        raise ValueError(f"the configuration differs from the driver's {driver_params}")
    args = SimpleNamespace(n_chains=traffic["chains"], parallel=traffic["parallel"],
                           n_particles=traffic["particles"], backward=traffic["backward"],
                           gradient=traffic["gradient"], resampling=traffic["resampling"],
                           D=cfg["D"])
    (init, kernel), _ = driver.build_kernel(traffic["style"], ys, args)
    return init, kernel


def start(cfg, traffic, ys, seed):
    """One trajectory from the driver's start (`init_x_fn` on max(N, 32)
    particles)."""
    from aux_ssm_tpu_torch.models import spatial as sp
    from aux_ssm_tpu_torch.native.precision import precision_stencil
    stencil = torch.as_tensor(precision_stencil(cfg["tau"], cfg["r_y"]), dtype=ys.dtype,
                              device=ys.device)
    gen = torch.Generator(device=ys.device).manual_seed(seed)
    return sp.init_x_fn(ys, cfg["sigma_x"], cfg["nu"], stencil, cfg["D"],
                        max(traffic["particles"], 32), generator=gen)


def model(cfg, ys, dtype, device, tf32=False):
    return reference.Model(cfg, ys, dtype, device, tf32)


def width(cfg):
    return cfg["D"] ** 2


def block_lane_particle_ops(cfg):
    nnz = int((reference.precision(cfg) != 0).sum())
    return 2 * nnz + 40 * cfg["D"] ** 2


def block_lane_row_width(cfg):
    """[u, y, scale, K, lam, scale^2 (nu + B), log c, 1 / scale^2, 1 / lam^2]:
    2 B + 7."""
    return 2 * cfg["D"] ** 2 + 7
