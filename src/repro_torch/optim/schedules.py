"""Learning-rate schedules (torch twin of ``repro.optim.schedules``):
functions of the step returning a float32 scalar tensor."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(lr: float, *, warmup: int, total: int, floor: float = 0.1):
    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * lr + (1 - floor) * lr * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return fn


def distill_stage_lr(cfg):
    """Paper §3.9: 1e-5 stages 1-3, 1e-6 stage 4 (cfg: DistillConfig)."""
    return cfg.lr_at
