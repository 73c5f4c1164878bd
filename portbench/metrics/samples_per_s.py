"""Chain iterations completed by all C chains in the window, a second of it."""


def read(ctx):
    return ctx["chains"] * ctx["steps"] / ctx["window_s"]
