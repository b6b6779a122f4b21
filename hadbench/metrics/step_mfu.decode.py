"""Serve step: % of the bf16 peak (989 TFLOP/s) that decode steps reach,
FLOPs of their live tokens over their execute time."""
from hadbench.metrics import step_mfu


def read(ctx):
    return step_mfu(ctx, "decode")
