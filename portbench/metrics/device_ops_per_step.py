"""Device operations a step, every kernel, copy and fill the profiler lists
over the traced steps."""


def read(ctx):
    tr = ctx["trace"]
    return None if tr is None else len(tr["kernels"]) / tr["steps"]
