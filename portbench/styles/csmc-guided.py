"""The csmc-guided style (guided auxiliary particle Gibbs: the block-lane
forward sweep, then backward sampling by the factor sweep) under the check:
the noise the harness hands a checked step, the sweeps' outputs it records
while that step runs, and the numbers it compares (`reference/csmc.py`
`judge`, stage by stage from the recorded carry: prop_err, logw_err,
anc_gap, back_gap, output_err).

The sweeps' outputs are read where the step hands them on: the program's
`ops.cuda.csmc_fwd.block_lane_scan` and `backward_factor_scan`, wrapped
for the checked step only (the wrapper calls them unchanged and keeps their
inputs and outputs).
"""
import contextlib

import torch

from portbench.reference import csmc

NUMBERS = ("prop_err", "logw_err", "anc_gap", "back_gap", "output_err")


def noise(state, traffic, gen):
    """(eps_aux, eps_m0, res_u, eps_prop, anc_u, us), the kernel's `noise=`
    in its order, each with the leading chain axis."""
    x = state.x
    C, T, d = x.shape
    N = traffic["particles"]
    kw = dict(generator=gen, dtype=x.dtype, device=x.device)
    return (torch.randn(C, T, d, **kw), torch.randn(C, N, d, **kw),
            torch.rand(C, T - 1, N, **kw), torch.randn(C, T - 1, N, d, **kw),
            torch.rand(C, T - 1, **kw), torch.rand(C, T, **kw))


@contextlib.contextmanager
def recording():
    from aux_ssm_tpu_torch.ops.cuda import csmc_fwd
    record = {}
    forward, backward = csmc_fwd.block_lane_scan, csmc_fwd.backward_factor_scan

    # The wrappers count their launches on the module's names, which name
    # the recorders while they are in place: the counts are carried over.
    def seen_forward(Mt, Gt, eps, res_u, x_star, x0, w0):
        seen_forward.launches = forward.launches
        xs, log_ws, anc = forward(Mt, Gt, eps, res_u, x_star, x0, w0)
        forward.launches = seen_forward.launches
        record.update(x0=x0, xs=xs, lw=log_ws, anc=anc)
        return xs, log_ws, anc

    def seen_backward(rf, cf, rb, log_ws, us, b_T):
        seen_backward.launches = backward.launches
        picked = backward(rf, cf, rb, log_ws, us, b_T)
        backward.launches = seen_backward.launches
        record.update(log_ws_bwd=log_ws, b_T=b_T, picked=picked)
        return picked

    csmc_fwd.block_lane_scan, csmc_fwd.backward_factor_scan = seen_forward, seen_backward
    try:
        yield record
    finally:
        csmc_fwd.block_lane_scan, csmc_fwd.backward_factor_scan = forward, backward


def outputs(state, record):
    """The judge's layout from the recorded sweeps and the step's state;
    None where a sweep was not seen."""
    if not {"xs", "picked"} <= record.keys():
        return None
    return {"x0": record["x0"].transpose(-1, -2), "lw0": record["log_ws_bwd"][:, 0],
            "xs": record["xs"].transpose(-1, -2), "lw": record["lw"], "anc": record["anc"],
            "picked": torch.cat([record["picked"], record["b_T"].reshape(-1, 1)], -1),
            "x_new": state.x, "updated": state.updated}


def judge(model, x, delta, noise_, out):
    if out is None:
        return {k: float("inf") for k in NUMBERS}
    return csmc.judge(model, x, delta, noise_, out)


def control(model, x, delta, noise_):
    dt = model.ys.dtype
    return csmc.sweep(model, x.to(dt), delta.to(dt), [z.to(dt) for z in noise_])
