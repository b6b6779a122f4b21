"""Per-layer metric readers, one file a metric named as in
``BENCHMARK.json`` (``<name>.py``, loaded by path: names may hold
dots). Each defines `read(ctx)` -> the value, or None when the traced
run holds nothing to read (the metric is then left out of the line).
`ctx` is a `hadbench.trace.Context`."""
from __future__ import annotations


def unprofiled(ctx, kind: str | None = None) -> list[dict]:
    """The window's steps outside the profiled sub-window (whose host
    times the profiler inflates), of one kind ("decode": a decode and
    no prefill chunk; "prefill": a prefill chunk) or every working
    kind."""
    return [s for s in ctx.steps if not s["profiled"]
            and s["kind"] != "idle" and kind in (None, s["kind"])]


def mean_ms(values) -> float | None:
    values = list(values)
    return 1e3 * sum(values) / len(values) if values else None


def step_mfu(ctx, kind: str) -> float | None:
    """% of the bf16 peak that the steps of `kind` reach: the FLOPs of
    their live tokens (the cell's model module's `flops_per_token`; the
    head at each decode token and at each chunk's last position) over
    their execute time."""
    from hadbench import peaks
    steps = unprofiled(ctx, kind)
    secs = sum(s["execute"] for s in steps)
    if not steps or secs <= 0:
        return None
    per_token = ctx.module.flops_per_token
    work = 0.0
    for s in steps:
        work += sum(per_token(ctx.port, n, ctx.n) for n in s["decode_lens"])
        for lo, hi in s["chunks"]:
            work += sum(per_token(ctx.port, p + 1, ctx.n, head=p == hi - 1)
                        for p in range(lo, hi))
    return 100.0 * work / (secs * peaks.BF16_FLOPS)


def roofline(ctx, kernel: str) -> float | None:
    """% of its roofline that a kernel reaches over the profiled
    sub-window: the summed least time of its launches
    (``hadbench/kernels/<kernel>.py``) over its device time."""
    from hadbench import trace
    if not ctx.profiled:
        return None
    mod = trace.load("kernels", kernel)
    dev = ctx.kernel_s(mod.NAMES)
    bound = sum(mod.step_bound_s(s, ctx.shapes) for s in ctx.steps
                if s["profiled"])
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev
