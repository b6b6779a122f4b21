"""Model runner: mean host ms of `execute` over the steps that carry a
prefill chunk."""
from hadbench.metrics import mean_ms, unprofiled


def read(ctx):
    return mean_ms(s["execute"] for s in unprofiled(ctx, "prefill"))
