"""Model runner: mean host ms of `execute` over the steps with a decode
and no prefill chunk (staging, the graph replay, the logits' copy to the
host and host sampling, ending in a sync)."""
from hadbench.metrics import mean_ms, unprofiled


def read(ctx):
    return mean_ms(s["execute"] for s in unprofiled(ctx, "decode"))
