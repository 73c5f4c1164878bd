"""Work of the block-lane forward sweep of one guided cSMC step, from the
cell's shapes at the model's width d (no padding): C chains, n = T - 1
steps, N particles, each particle's step the family's
`block_lane_particle_ops` (SV: three d x d mat-vecs and ~20 elementwise
operations a component, 6 d^2 + 20 d; spatial: 2 operations a nonzero of
the precision and ~40 a component; the counts of the repository's
`chip_smoke.py`). It reads the noise (n, d, N), the uniforms (n, N), the
reference path (n, d), the first particles (d, N) and weights (N,) and the
step's parameter rows (n, the family's `block_lane_row_width`), and writes
the particles (n, d, N), log-weights (n, N) and int64 ancestors (n, N), a
chain each, in float32.
"""
from portbench.manifest import load_module

NAMES = ("block_lane_kernel",)
BYTES = 4


def per_step(cfg, traffic):
    family = load_module("families", cfg["family"])
    d, N, C = family.width(cfg), traffic["particles"], traffic["chains"]
    n = cfg["T"] - 1
    operations = C * n * N * family.block_lane_particle_ops(cfg)
    values = (2 * n * d * N + 2 * n * N + n * d + d * N + N
              + n * family.block_lane_row_width(cfg))
    return operations, C * (values * BYTES + n * N * 8)
