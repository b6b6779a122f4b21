"""Serve step: % of the bf16 peak that prefill-carrying steps reach, FLOPs
of their live tokens (the chunk's and the same step's decode rows; not
the idle slot rows a chunk carries) over their execute time."""
from hadbench.metrics import step_mfu


def read(ctx):
    return step_mfu(ctx, "prefill")
