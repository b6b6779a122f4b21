"""Engine and scheduler: mean host ms a step spends in the scheduler's
`schedule` and `commit` (the flight recorder's timings)."""
from hadbench.metrics import mean_ms, unprofiled


def read(ctx):
    return mean_ms(s["schedule"] + s["commit"] for s in unprofiled(ctx))
