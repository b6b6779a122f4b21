"""Roofline terms of one step on one H100 (torch twin of
``repro.launch.roofline``).

Three terms per (arch, shape), in seconds:

    compute    = flops / PEAK_FLOPS
    memory     = bytes_hbm / HBM_BW
    collective = bytes_collective / LINK_BW

The flops and bytes come from ``launch.op_cost``, which counts the aten ops
one eager step executes and, for each hand-written kernel, the work
``kernels.cost``'s formulas give (``k1_work`` .. ``k5_work``, re-exported
here). One card moves nothing between cards: ``bytes_collective`` is 0
and ``chips`` is 1. A production-mesh record (``launch.mesh_cost``) holds
one chip's share of the step, its collective bytes and their time at
each group's link rate.

Hardware constants: NVIDIA H100 SXM data sheet, dense rates at 700 W.

Not ported from the JAX module, each because it reads XLA's artifacts:
``collective_bytes`` parses collectives out of SPMD HLO text;
``terms_from_compiled`` walks a compiled executable's HLO;
``xla_reference_cost`` reads XLA's own cost analysis.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.cost import (  # noqa: F401 (re-exported)
    k1_work, k2_work, k3_work, k4_work, k5_work)

PEAK_FLOPS = 989e12           # bf16 tensor cores, dense
PEAK_INT8_OPS = 1979e12       # int8 tensor cores, dense
PEAK_FP32_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BW = 3.35e12              # bytes/s
HBM_BYTES = 80e9              # device memory
LINK_BW = 450e9               # NVLink, bytes/s each way to the other cards


@dataclasses.dataclass
class RooflineTerms:
    """Flops and bytes of one step on one card."""

    flops: float
    bytes_hbm: float
    bytes_collective: float = 0.0
    chips: int = 1
    # the collectives' time where their groups move at different rates
    # (launch.mesh_cost), else bytes_collective / LINK_BW
    collective_s: float | None = None

    @property
    def global_flops(self) -> float:
        return self.flops * self.chips

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / HBM_BW

    @property
    def t_collective(self) -> float:
        if self.collective_s is not None:
            return self.collective_s
        return self.bytes_collective / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "global_flops": self.global_flops,
            "bytes_hbm": self.bytes_hbm,
            "bytes_collective": self.bytes_collective, "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
        }


def model_flops(cfg, shape, *, distill: bool = False) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) useful-work reference.

    Training processes D = batch*seq tokens with fwd+bwd (6ND). Distill
    adds the teacher forward (2ND). Decode/prefill are forward-only (2ND).
    """
    from repro_torch.models.model import active_param_count
    n = active_param_count(cfg)
    d_tokens = shape.global_batch * (1 if shape.kind == "decode"
                                     else shape.seq_len)
    if shape.kind == "train":
        per_tok = 8 * n if distill else 6 * n   # 6 student + 2 teacher fwd
    else:
        per_tok = 2 * n
    return float(per_tok) * d_tokens
