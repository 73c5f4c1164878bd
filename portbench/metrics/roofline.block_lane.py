"""The block-lane sweep's share of its roofline over the traced steps (`work/block_lane.py`)."""
from portbench.kernels import roofline


def read(ctx):
    return roofline(ctx, "block_lane")
