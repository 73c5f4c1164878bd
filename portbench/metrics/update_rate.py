"""The chains' mean update rate over the window's sampled steps: the mean
acceptance (MH) or the mean per-time update rate (cSMC), from the loop's
`OnlineStats.accept_cum`."""


def read(ctx):
    return float(ctx["stats"].accept_cum.double().mean())
