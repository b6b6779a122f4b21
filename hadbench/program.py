"""The system under test, built from a configuration and a traffic mix:
``repro_torch``'s `Transformer` holding the benchmark's seeded weights
and its serving `Engine`. The only module of the benchmark, with
``run.py``, that imports the program."""
from __future__ import annotations

import torch

from hadbench import weights
from repro_torch.models import transformer as T
from repro_torch.models.config import HADConfig, ModelConfig
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import ServeConfig


def model_config(port: dict) -> ModelConfig:
    """The port's ModelConfig for a configuration's ``port`` block (its
    keys are ModelConfig's fields; ``had`` HADConfig's)."""
    fields = dict(port)
    had = HADConfig(**fields.pop("had"))
    return ModelConfig(**fields, had=had)


@torch.no_grad()
def build_model(port: dict, *, seed: int, device,
                rules: dict | None = None) -> T.Transformer:
    """The model with every tensor drawn by `weights.draw` on `device`,
    through `rules` (the model module's ``draw_rules``) first."""
    cfg = model_config(port)
    model = T.Transformer(cfg, device=device)
    for name, p in model.named_parameters():
        p.copy_(weights.draw(name, p.shape, seed=seed, device=device,
                             dtype=p.dtype, rules=rules))
    model.refresh_scales()
    return model


def build_engine(port: dict, model: T.Transformer, engine: dict, *,
                 device, telemetry=None) -> Engine:
    """The serving engine of a traffic mix's ``engine`` block (its keys
    are ServeConfig's fields)."""
    return Engine(model_config(port), model, ServeConfig(**engine),
                  telemetry=telemetry, device=device)
