"""Distillation stage controller (torch twin of ``repro.core.distill``;
paper Alg. 1 + §3.9 training details).

The JAX package evaluates the learning rate and the attention-loss switch
as traced functions of the step; the port's eager step evaluates them for
a Python step with the same comparisons.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.binarize import CSchedule, Stage


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Hyperparameters of the 4-stage recipe (paper defaults)."""

    schedule: CSchedule = CSchedule()
    lr_stages_123: float = 1e-5
    lr_stage_4: float = 1e-6
    grad_clip: float = 0.5
    batch_size: int = 16
    sigma_batches: int = 100       # Eq. 12: 100 minibatches of 16
    sigma_batch_size: int = 16
    topn: int = 30                 # N at the training context length
    attention_loss: bool = True    # False = "w/o AD" ablation (table 1)

    @property
    def total_steps(self) -> int:
        return self.schedule.stage4_end

    def lr_at(self, step: int) -> float:
        """Learning rate at `step` (stage 4 drops it)."""
        return (self.lr_stages_123 if step < self.schedule.stage3_end
                else self.lr_stage_4)

    def use_attention_loss_at(self, step: int) -> bool:
        """Eq. 11 vs Eq. 19: the attention KL is on through stage 3 only."""
        return self.attention_loss and step < self.schedule.stage3_end

    def stage_at(self, step: int) -> Stage:
        return self.schedule.stage_at(step)


def tiny_schedule(steps_per_stage: int = 25) -> CSchedule:
    """A compressed schedule for tests and benchmarks: the same 4-stage
    structure in few steps, the decay chosen so c crosses the paper's
    stage boundaries."""
    d1 = math.exp(math.log(1 / 5) / steps_per_stage)
    return CSchedule(c0=5.0, decay=d1, stage2_c=1.0, stage3_c=0.05,
                     stage3_steps=steps_per_stage,
                     stage4_steps=steps_per_stage)


def no_tanh_schedule(total_steps: int) -> CSchedule:
    """"w/o Tanh" ablation: stages 1-2 removed, replaced by an equivalent
    number of STE steps (paper tables 1-2)."""
    half = max(total_steps // 2, 1)
    return CSchedule(c0=1.0, decay=0.5, stage2_c=1.0, stage3_c=1.0,
                     stage3_steps=half, stage4_steps=total_steps - half)
