"""Host milliseconds in each call of the batched kernel (the enqueue; no
fence), mean over the window's steps."""


def read(ctx):
    host = ctx["host_s"]
    return 1e3 * sum(host) / len(host) if host else None
