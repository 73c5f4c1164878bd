"""Device milliseconds a step of the kernels the hand-written wrappers did
not launch: PyTorch's own kernels and the libraries', copies and fills, by
the profiler's name."""
from portbench.kernels import is_library


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return 1e-3 * sum(e - s for name, s, e in tr["kernels"] if is_library(name)) / tr["steps"]
