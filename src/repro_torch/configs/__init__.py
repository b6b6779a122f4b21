"""Architecture registry: one module per assigned arch + the paper's own.

`get_config("<arch-id>")` returns the full published config;
`get_config("<arch-id>", reduced=True)` returns the CPU smoke-test shrink.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# arch-id -> module name
_MODULES = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "granite-3-8b": "granite_3_8b",
    "smollm-360m": "smollm_360m",
    "phi3-medium-14b": "phi3_medium_14b",
    "smollm-135m": "smollm_135m",
    "mamba2-130m": "mamba2_130m",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "dbrx-132b": "dbrx_132b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "hubert-xlarge": "hubert_xlarge",
    # paper's own evaluation models
    "bert-base-had": "bert_base_had",
    "deit-b": "deit_b",
    "deit-t": "deit_t",
    "quality-lm-base": "quality_lm_base",
}

ASSIGNED = list(_MODULES)[:10]
PAPER = list(_MODULES)[10:]

# configurations the port alone serves (the JAX package has no twin)
PORT_ONLY = {
    "granite-4.0-h-small": "granite_4_0_h_small",
}


def get_config(name: str, *, reduced: bool = False, **overrides) -> ModelConfig:
    modules = {**_MODULES, **PORT_ONLY}
    if name not in modules:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(modules)}")
    mod = importlib.import_module(f"repro_torch.configs.{modules[name]}")
    cfg: ModelConfig = mod.CONFIG
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        import dataclasses
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def list_archs() -> list[str]:
    return list(_MODULES) + list(PORT_ONLY)
