"""Serve step: mean device ms a replay of the decode graph spends in its
SSM mixers (Mamba2, norm1 included). On the card, every replay in the
profiled sub-window (steps with prefill chunks too), its kernels
labelled by position with the hub's ``kernel_regions``
(``spans.labelled``); on the CPU, the host-clock ``device_ms`` of the
unprofiled steps with a decode and no prefill chunk."""
from hadbench import spans
from hadbench.metrics import unprofiled


def read(ctx):
    ms = spans.region_ms(ctx, unprofiled(ctx, "decode"), "decode", ("ssm",))
    return sum(ms) / len(ms) if ms else None
