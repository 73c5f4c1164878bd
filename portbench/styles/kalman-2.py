"""The kalman-2 style (second-order auxiliary Kalman MH) under the check:
the noise the harness hands a checked step, what it reads of the step's
output, and the numbers it compares (`reference/kalman.py`).

draw_err    largest |x_new - the reference's|: the reference's proposal
            where the program accepted, the step's own start where it
            rejected;
accept_gap  largest distance, in log-probability, by which the accept
            uniform lies on the other side of the reference's log alpha
            from the program's decision: 0 where they agree.
"""
import contextlib

import torch

from portbench.reference import kalman

NUMBERS = ("draw_err", "accept_gap")


def noise(state, traffic, gen):
    """(eps_aux, eps_smooth (C, T, d), u_accept (C,)), the kernel's
    `noise=`."""
    x = state.x
    kw = dict(generator=gen, dtype=x.dtype, device=x.device)
    return (torch.randn(x.shape, **kw), torch.randn(x.shape, **kw),
            torch.rand(x.shape[0], **kw))


@contextlib.contextmanager
def recording():
    """The MH step's outputs are its state: nothing inside is recorded."""
    yield {}


def outputs(state, record):
    return {"x_new": state.x, "updated": state.updated}


def judge(model, x, delta, noise_, out):
    dt = model.ys.dtype
    ref = kalman.mh_step(model, x.to(dt), delta.to(dt), [z.to(dt) for z in noise_])
    accepted = out["updated"].reshape(-1).bool()
    want = torch.where(accepted[:, None, None], ref["x_prop"], x.to(dt))
    draw_err = float((out["x_new"].to(dt) - want).abs().max())
    la = torch.clamp(ref["log_alpha"], max=0.0)
    lu = torch.log(noise_[2].to(dt))
    gap = torch.where(accepted, lu - la, la - lu).clamp(min=0.0)
    return {"draw_err": draw_err, "accept_gap": float(gap.max())}


def control(model, x, delta, noise_):
    """The reference in the model's (lower) precision, in the program's
    place: its outputs in `outputs`' layout."""
    dt = model.ys.dtype
    ref = kalman.mh_step(model, x.to(dt), delta.to(dt), [z.to(dt) for z in noise_])
    return {"x_new": ref["x_new"], "updated": ref["accept"]}
