"""Device: % of the time inside `Engine.step` over the profiled
sub-window with no operation on the card."""


def read(ctx):
    if not ctx.profiled or ctx.step_ns <= 0:
        return None
    return 100.0 * ctx.step_idle_ns / ctx.step_ns
