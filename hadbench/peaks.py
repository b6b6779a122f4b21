"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit).

Frozen copy of ``src/repro_torch/launch/roofline.py``'s PEAK_FLOPS,
PEAK_INT8_OPS, PEAK_FP32_FLOPS and HBM_BW, and of ``chip_smoke.py``'s
``bound``.
"""
from __future__ import annotations

BF16_FLOPS = 989e12           # bf16 tensor cores
INT8_OPS = 1979e12            # int8 tensor cores
FP32_FLOPS = 67e12            # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, ops) -> float:
    """Least seconds for `nbytes` of memory traffic and `ops`, pairs of
    (operations, peak rate of the unit that does them): the larger of the
    bytes' time and the slowest unit's time."""
    return max([nbytes / HBM_BYTES_PER_S] + [n / rate for n, rate in ops])
