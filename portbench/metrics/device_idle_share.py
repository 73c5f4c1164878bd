"""Share of the traced steps' wall time in which no operation ran on the
device: 1 - (union of the device operations' intervals / wall), in %."""
from portbench.devtrace import summarise


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return 100.0 * (1.0 - summarise(tr)["busy_s"] / tr["wall_s"])
