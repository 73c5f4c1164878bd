"""Effective samples a second: the pooled ESS of the C chains' draws in the
window (Geyer's initial monotone sequence), averaged over the cell's 64
interior coordinates, over the window's seconds."""
from portbench.ess import mean_ess


def read(ctx):
    samples = ctx["samples"]
    if samples is None or samples.shape[1] < 4:
        return None
    ess = mean_ess(samples)
    return ess / ctx["window_s"] if ess == ess else None
