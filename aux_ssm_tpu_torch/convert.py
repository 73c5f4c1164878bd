"""From the JAX package's parameters and data, given as NumPy arrays (for
example `np.asarray` of each field of an `aux_ssm_tpu.ops.LGSSM`), to the
port's tensors; and chain-batched Kalman and cSMC states both ways (JAX's
vmapped state leads with the chain axis, x (C, T, d); the port's batched
Kalman kernels run time first, x (T, C, d), its batched cSMC kernels chain
first, as JAX's)."""
import numpy as np
import torch

from .ops.lgssm import LGSSM


def lgssm_from_numpy(m0, P0, Fs, Qs, bs, Hs, Rs, cs, ys, *, device, dtype):
    """Returns `(LGSSM, ys)` as tensors of `dtype` on `device`."""
    params = tuple(torch.as_tensor(z, dtype=dtype, device=device)
                   for z in (m0, P0, Fs, Qs, bs, Hs, Rs, cs))
    return LGSSM(*params), torch.as_tensor(ys, dtype=dtype, device=device)


def kalman_chains_from_numpy(x, updated=None, log_target=None, *, device, dtype):
    """C chains' Kalman state of the JAX package (the fields of its vmapped
    `KalmanSampler`: x (C, T, d), updated (C,), log_target (C,) or None) as
    the port's time-first state for `kernels.kalman.get_kernel(...,
    chains=True)`: a `KalmanSampler` with x (T, C, d) (contiguous), updated
    (C,) (all True when not given) and log_target (C,) or None."""
    from .kernels.kalman import KalmanSampler  # the kernels import this package
    x = torch.as_tensor(np.asarray(x), dtype=dtype, device=device).transpose(0, 1).contiguous()
    updated = (torch.ones(x.shape[1], dtype=torch.bool, device=device) if updated is None
               else torch.as_tensor(np.asarray(updated), device=device).to(torch.bool))
    lt = (None if log_target is None
          else torch.as_tensor(np.asarray(log_target), dtype=dtype, device=device))
    return KalmanSampler(x=x, updated=updated, log_target=lt)


def kalman_chains_to_numpy(state):
    """The port's time-first chain state (x (T, C, d)) as the JAX package's
    vmapped `KalmanSampler` fields: a dict of NumPy arrays x (C, T, d),
    updated (C,) and log_target (C,) or None."""
    lt = state.log_target
    return {"x": state.x.transpose(0, 1).detach().cpu().numpy(),
            "updated": state.updated.detach().cpu().numpy(),
            "log_target": None if lt is None else lt.detach().cpu().numpy()}


def csmc_chains_from_numpy(x, updated=None, *, device, dtype):
    """C chains' cSMC state of the JAX package (the fields of its vmapped
    `CSMCState`: x (C, T, d), updated (C, T)) as the port's state for a
    cSMC kernel over the chain axis (`get_csmc_kernel(..., chains=True)`,
    `get_guided_csmc_kernel(..., chains=True)` of the SV and spatial
    models): a `CSMCState` with x (C, T, d) and updated (C, T) (all False
    when not given)."""
    from .kernels.csmc_base import CSMCState  # the kernels import this package
    x = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    updated = (torch.zeros(x.shape[:-1], dtype=torch.bool, device=device) if updated is None
               else torch.as_tensor(np.asarray(updated), device=device).to(torch.bool))
    return CSMCState(x=x, updated=updated)


def csmc_chains_to_numpy(state):
    """The port's chain-batched cSMC state as the JAX package's vmapped
    `CSMCState` fields: a dict of NumPy arrays x (C, T, d) and updated (C,
    T)."""
    return {"x": state.x.detach().cpu().numpy(), "updated": state.updated.detach().cpu().numpy()}


def sv_from_numpy(ys, xs=None, *, device, dtype):
    """The stochastic-volatility data of the JAX package (`sv.get_data`'s
    (xs, ys), or the `ys` and `xs_true` of an `experiments.sv` result file)
    as tensors: returns `(ys, xs)`, `xs` None when not given. The model's
    parameters (nu, phi, tau, rho) are Python floats on both sides."""
    ys = torch.as_tensor(ys, dtype=dtype, device=device)
    return ys, None if xs is None else torch.as_tensor(xs, dtype=dtype, device=device)


def theta_logistic_from_numpy(ys, xs=None, *, device, dtype):
    """The theta-logistic data of the JAX package (`theta_logistic.get_data`'s
    (xs, ys), each (T, 1)) as tensors: returns `(ys, xs)`, `xs` None when not
    given. The model's parameters are Python floats on both sides."""
    return sv_from_numpy(ys, xs, device=device, dtype=dtype)


def spatial_from_numpy(ys, xs=None, x0=None, *, device, dtype):
    """The spatial model's data and a start carried across: `ys` and, when
    given, `xs` (`spatial.get_data`'s, each (T, B)) and a trajectory `x0`
    (T, B) (e.g. `spatial.init_x_fn`'s draw). Returns `(ys, xs, x0)`, None
    where not given. The model's numbers (sigma_x, nu, tau, r_y, d) are
    Python numbers on both sides."""
    return tuple(None if z is None else torch.as_tensor(z, dtype=dtype, device=device)
                 for z in (ys, xs, x0))


def rare_event_from_numpy(x, delta=None, *, device, dtype):
    """A rare-event chain's state carried across: the trajectory `x` ((T,) or
    (T, 1), e.g. `rare_event.init_x`'s draw) and, when given, the step size
    `delta` (a scalar or (T,)). Returns `(x (T, 1), delta)`. The model itself
    is (y, rho, r2, T), Python numbers on both sides."""
    x = torch.as_tensor(x, dtype=dtype, device=device).reshape(-1, 1)
    return x, None if delta is None else torch.as_tensor(delta, dtype=dtype, device=device)


def rare_event_grid_from_numpy(x, rho, r2, updated=None, delta=None, *, device, dtype):
    """The rare-event grid's state carried across (the fields of the JAX
    driver's `GridState` as arrays: x (M, T) or (M, T, 1), each chain's cell
    rho and r2 (M,), `updated` (M,) or (M, T), all False when not given)
    and, when given, the chains' delta ((M,) or (M, T)). Returns
    `(experiments.rare_event.GridState, delta)`."""
    from .experiments.rare_event import GridState  # the driver imports this package
    x = torch.as_tensor(x, dtype=dtype, device=device)
    x = x.reshape(x.shape[0], -1, 1)
    rho, r2 = (torch.as_tensor(z, dtype=dtype, device=device) for z in (rho, r2))
    updated = (torch.zeros(x.shape[:1], dtype=torch.bool, device=device) if updated is None
               else torch.as_tensor(updated, device=device).to(torch.bool))
    state = GridState(x=x, updated=updated, rho=rho, r2=r2)
    return state, None if delta is None else torch.as_tensor(delta, dtype=dtype, device=device)
