"""Launches of the hand-written kernels a step: the wrappers' `launches`
counters over the window, over its steps."""


def read(ctx):
    return ctx["launches"] / ctx["steps"]
