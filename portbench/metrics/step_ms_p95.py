"""95th percentile of the step period over the window: the time between
the CUDA events recorded after consecutive batched steps."""
import numpy as np


def read(ctx):
    ev = ctx["events"]
    if len(ev) < 21:
        return None
    periods = [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])]
    return float(np.percentile(periods, 95))
