"""Binarization machinery for HAD (torch twin of ``repro.core.binarize``,
paper §3.4-3.8).

The three parameterizations of the Q/K transform used across the four
distillation stages, the straight-through estimator, and the
standardization-coefficient (sigma) estimation.

Stage semantics (c is the annealing scalar, sigma the per-layer std):
  stage 1 (Eq. 13): x -> c*sigma * tanh(x / (c*sigma)),   c: 5.0 -> 1.0
  stage 2 (Eq. 15): x ->   sigma * tanh(x / (c*sigma)),   c: 1.0 -> 0.05
  stage 3 (Eq. 18): x ->   sigma * STE(x / sigma)         (sign fwd, clipped-identity bwd)
  stage 4         : same transform as stage 3 (only the loss/lr change)
  inference       : x ->   sigma * sign(x)  (packed to bits downstream)

The JAX package decides the stage inside one compiled step
(``lax.switch``); the port's eager step takes it as a Python int, which
``CSchedule.stage_at_traced`` gives for a Python step exactly as the JAX
function gives it for a traced one.
"""
from __future__ import annotations

import dataclasses
import enum
import math

import torch


class Stage(enum.IntEnum):
    """Distillation stage (Alg. 1)."""

    STAGE1_TANH = 1
    STAGE2_TIGHT_TANH = 2
    STAGE3_STE = 3
    STAGE4_REFINE = 4


class _SteSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return hard_sign(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    """sign(x) forward, sign(0) = +1 (a 0 would break the Hamming /
    bit-packing equivalence); clipped identity backward, g * (|x| <= 1)
    (Eq. 16-17)."""
    return _SteSign.apply(x)


def hard_sign(x: torch.Tensor) -> torch.Tensor:
    """Non-differentiable sign in {-1, +1} (inference path)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _as(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, device=like.device).to(like.dtype)


def binarize(x: torch.Tensor, *, stage: Stage | int,
             c: torch.Tensor | float,
             sigma: torch.Tensor | float) -> torch.Tensor:
    """Apply the stage's Q/K transform. c and sigma are cast to x's dtype,
    as the JAX function casts them. In stages 3/4 the result is exactly
    sigma * (+-1) with STE gradients."""
    stage = Stage(int(stage))
    sigma = _as(sigma, x)
    c = _as(c, x)
    if stage == Stage.STAGE1_TANH:
        cs = c * sigma
        return cs * torch.tanh(x / cs)
    if stage == Stage.STAGE2_TIGHT_TANH:
        return sigma * torch.tanh(x / (c * sigma))
    return sigma * ste_sign(x / sigma)


def binarize_inference(x: torch.Tensor, *,
                       sigma: torch.Tensor | float) -> torch.Tensor:
    """Inference-time transform: sigma * sign(x). No gradient defined."""
    return _as(sigma, x) * hard_sign(x)


@dataclasses.dataclass(frozen=True)
class CSchedule:
    """Exponential c decay: c_t = c0 * decay**t, clamped at c_end.

    The paper decays c by 0.9998 per minibatch; stage boundaries are where
    c crosses 1.0 (stage 1 -> 2) and 0.05 (stage 2 -> 3).
    """

    c0: float = 5.0
    decay: float = 0.9998
    stage2_c: float = 1.0
    stage3_c: float = 0.05
    stage3_steps: int = 10_000
    stage4_steps: int = 10_000

    def steps_to(self, c_target: float, c_from: float | None = None) -> int:
        c_from = self.c0 if c_from is None else c_from
        return max(0, math.ceil(math.log(c_target / c_from)
                                / math.log(self.decay)))

    @property
    def stage1_end(self) -> int:
        return self.steps_to(self.stage2_c)

    @property
    def stage2_end(self) -> int:
        return self.steps_to(self.stage3_c)

    @property
    def stage3_end(self) -> int:
        return self.stage2_end + self.stage3_steps

    @property
    def stage4_end(self) -> int:
        return self.stage3_end + self.stage4_steps

    def stage_at(self, step: int) -> Stage:
        if step < self.stage1_end:
            return Stage.STAGE1_TANH
        if step < self.stage2_end:
            return Stage.STAGE2_TIGHT_TANH
        if step < self.stage3_end:
            return Stage.STAGE3_STE
        return Stage.STAGE4_REFINE

    def c_at(self, step: int | torch.Tensor) -> torch.Tensor:
        """c as a float32 scalar tensor (valid in stages 1-2; clamped to
        stage3_c afterwards), computed in float32 as the JAX function
        does."""
        step = torch.as_tensor(step).to(torch.float32)
        c = torch.tensor(self.decay, dtype=torch.float32) ** step
        c = torch.tensor(self.c0, dtype=torch.float32) * c
        return torch.clamp(c, self.stage3_c, self.c0)

    def stage_at_traced(self, step: int) -> int:
        """Integer stage id, by the JAX function's rule (the same
        comparisons in the same order)."""
        s = 1 if step < self.stage1_end else 2
        if step >= self.stage2_end:
            s = 3
        if step >= self.stage3_end:
            s = 4
        return s


def binarize_scheduled(x: torch.Tensor, *, step: int, sched: CSchedule,
                       sigma: torch.Tensor | float) -> torch.Tensor:
    """The stage's transform at `step` (JAX ``binarize_scheduled``: stage
    from ``stage_at_traced``, c from ``c_at``)."""
    stage = min(max(sched.stage_at_traced(step), 1), 3)
    return binarize(x, stage=stage, c=sched.c_at(step).to(x.device),
                    sigma=sigma)


def estimate_sigma(samples: list[torch.Tensor]) -> torch.Tensor:
    """Standardization coefficient per paper Eq. 12: the std over all
    elements of each minibatch's activations (population std, as
    ``jnp.std``), averaged over minibatches. float32."""
    stds = [s.to(torch.float32).std(correction=0) for s in samples]
    return torch.stack(stds).mean()


def estimate_sigmas_from_capture(captures: list[dict[str, torch.Tensor]]
                                 ) -> dict[str, torch.Tensor]:
    """Per-layer sigma estimates from captured forward passes: one dict
    per minibatch mapping a capture key (e.g. "layer3/q") to the
    continuous Q_c/K_c activations."""
    if not captures:
        raise ValueError("need at least one captured minibatch")
    keys = captures[0].keys()
    return {k: estimate_sigma([cap[k] for cap in captures]) for k in keys}
