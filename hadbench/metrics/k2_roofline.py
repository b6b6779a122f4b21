"""Kernels: K2's (binary paged decode attention) share of its roofline
over the profiled sub-window, live rows only."""
from hadbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "k2")
