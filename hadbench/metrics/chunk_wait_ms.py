"""Engine and scheduler: p95 ms of ``request.wait``, from a request's
`submit()` to the start of the ``runner.execute`` span that runs its
first prefill chunk, over the requests whose first chunk ran in the
window (every step of it)."""
from hadbench import spans
from hadbench.stats import percentile


def read(ctx):
    pairs = spans.paired(ctx, ctx.steps)
    if pairs is None:
        return None
    waits = [1e3 * spans.duration(r) for _, ev in pairs
             for r in ev["spans"] if r[0] == "request.wait"]
    return percentile(waits, 95) if waits else None
