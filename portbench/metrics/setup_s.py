"""Process start to the first timed step: imports, CUDA start, the kernel
library's load (its build on a checkout's first run), data, the start, the
kernel's construction and the warm-up steps."""


def read(ctx):
    return ctx["setup_s"]
