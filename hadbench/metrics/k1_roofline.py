"""Kernels: K1's (binary prefill attention) share of its roofline over
the profiled sub-window, live queries only."""
from hadbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "k1")
