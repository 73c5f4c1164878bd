"""Work of the filter scans of one auxiliary-Kalman step (both proposal
filters: at x and at the proposal), from the cell's shapes at the model's
width d (no padding).

A filter of T steps scans n = T - 1 associative elements (the t = 0 update
is outside) and needs n - 1 combines at least, each 8 d x d products and
one inverse: 18 d^3 operations (`mh_ops` of the repository's
`chip_smoke.py`). It reads the elements (A, C, J: d x d; b, eta: d) and
writes the filtered means and covariances (d, d x d), in float32.
"""
from portbench.manifest import load_module

NAMES = ("FilterOp",)
FILTERS_A_STEP = 2
BYTES = 4


def per_step(cfg, traffic):
    d = load_module("families", cfg["family"]).width(cfg)
    n, C = cfg["T"] - 1, traffic["chains"]
    operations = FILTERS_A_STEP * C * (n - 1) * 18 * d ** 3
    nbytes = FILTERS_A_STEP * C * n * (3 * d * d + 2 * d + d * d + d) * BYTES
    return operations, nbytes
