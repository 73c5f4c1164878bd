"""The stochastic-volatility configuration family: the benchmark's data,
the program's batched step as `experiments/sv.py` builds it, the driver's
start, and the plain reference model (`reference/sv.py`)."""
from types import SimpleNamespace

import torch

from portbench.reference import sv as reference

PARAMS = ("nu", "phi", "tau", "rho")


def simulate(cfg):
    return reference.simulate(cfg, cfg["data_seed"])


def build(cfg, traffic, ys):
    """(init, kernel) of the driver's `build_kernel` with `--n-chains C`:
    the one batched step of all C chains."""
    from aux_ssm_tpu_torch.experiments import sv as driver
    driver_params = dict(zip(PARAMS, (driver.NU, driver.PHI, driver.TAU, driver.RHO)))
    if any(cfg[k] != v for k, v in driver_params.items()):
        raise ValueError(f"the configuration's {PARAMS} differ from the driver's {driver_params}")
    args = SimpleNamespace(n_chains=traffic["chains"], parallel=traffic["parallel"],
                           n_particles=traffic["particles"], backward=traffic["backward"],
                           gradient=traffic["gradient"], resampling=traffic["resampling"])
    return driver.build_kernel(traffic["style"], ys, args)


def start(cfg, traffic, ys, seed):
    """One trajectory from the driver's start (`init_x_fn` on max(N, 32)
    particles)."""
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    gen = torch.Generator(device=ys.device).manual_seed(seed)
    return sv.init_x_fn(ys, *(cfg[k] for k in PARAMS), max(traffic["particles"], 32),
                        generator=gen)


def model(cfg, ys, dtype, device, tf32=False):
    return reference.Model(cfg, ys, dtype, device, tf32)


def width(cfg):
    return cfg["D"]


def block_lane_particle_ops(cfg):
    d = cfg["D"]
    return 6 * d * d + 20 * d


def block_lane_row_width(cfg):
    """[u, y, rotS, g, sqrtL, inv_sqrtL, scale, hld]: 6 d + 2."""
    return 6 * cfg["D"] + 2
