"""The filter scan's share of its roofline over the traced steps (`work/filter_scan.py`)."""
from portbench.kernels import roofline


def read(ctx):
    return roofline(ctx, "filter_scan")
