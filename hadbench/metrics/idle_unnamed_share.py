"""Device: % of the in-step idle time over the profiled sub-window (the
card idle inside ``hadbench.step``) that no span below ``engine.step``
and no ``gc`` span covers: host work the program's spans do not name.
Kernels from the profiler, spans on the hub's clock (the same epoch
clock)."""
from hadbench import spans


def read(ctx):
    by = spans.idle_by_span(ctx)
    if by is None or ctx.step_idle_ns <= 0:
        return None
    return 100.0 * by[spans.UNNAMED] / ctx.step_idle_ns
