"""Model runner: mean host ms of the ``runner.execute`` span less its
``runner.sync`` spans (the host blocking on the card), over the steps
with a decode and no prefill chunk: staging, the replay call, the
accounting, host sampling and the runner's own glue."""
from hadbench import spans
from hadbench.metrics import mean_ms, unprofiled


def read(ctx):
    pairs = spans.paired(ctx, unprofiled(ctx, "decode"))
    if pairs is None:
        return None
    return mean_ms(v for _, ev in pairs
                   for v in spans.host_less_sync(ev["spans"],
                                                 "runner.execute"))
