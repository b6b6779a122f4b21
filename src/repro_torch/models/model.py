"""Public model API (torch twin of ``repro.models.model``): forward
dispatch, analytic parameter counts and the input specs of the
dry-run shape cells, as (shape, dtype) pairs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

init_params = T.init_params
student_subset = T.student_subset
merge_student = T.merge_student
forward = T.forward
forward_distill = T.forward_distill
init_caches = T.init_caches
serve_step = T.serve_step


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


class TensorSpec(NamedTuple):
    """The shape and dtype of one model input (JAX's ShapeDtypeStruct)."""

    shape: tuple
    dtype: torch.dtype


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs; the reason when it is skipped."""
    if cfg.is_encoder and shape.kind == "decode":
        return False, "encoder-only arch has no autoregressive decode step"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                batch_override: int | None = None) -> dict[str, TensorSpec]:
    """The shape and dtype of every model input of this cell: training
    cells feed (tokens or frames, labels), prefill the prompt, decode one
    token per sequence; a model with cross layers adds image embeddings
    outside decode."""
    b = batch_override if batch_override is not None else shape.global_batch
    s = shape.seq_len
    frames = cfg.frontend_dim and "C" not in cfg.layer_pattern
    specs: dict[str, TensorSpec] = {}
    if shape.kind in ("train", "prefill"):
        if frames:
            specs["frames"] = TensorSpec((b, s, cfg.frontend_dim),
                                         torch.bfloat16)
        else:
            specs["tokens"] = TensorSpec((b, s), torch.int32)
        if shape.kind == "train":
            specs["labels"] = TensorSpec((b, s), torch.int32)
    else:
        specs["tokens"] = TensorSpec((b, 1), torch.int32)
    if "C" in cfg.layer_pattern and shape.kind != "decode":
        specs["image_embeds"] = TensorSpec(
            (b, cfg.n_image_tokens, cfg.frontend_dim), torch.bfloat16)
    return specs


def _uses_moe(cfg: ModelConfig, pos: int) -> bool:
    return T.layer_uses_moe(cfg, pos)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (no allocation), the JAX tree's: sigma_q
    and sigma_k count as two per attention layer."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    total = v * d
    if not cfg.tie_embeddings:
        total += d * v
    if cfg.pos == "learned":
        total += cfg.max_pos * d
    if cfg.frontend_dim:
        total += cfg.frontend_dim * d
    total += d
    for i, ch in enumerate(cfg.layer_pattern):
        per = d
        if ch in ("A", "C"):
            per += d * h * dh + 2 * d * hk * dh + h * dh * d + 2
        else:
            di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            per += d * (2 * di + 2 * n + nh) + di * d + 3 * nh + 4 * di + di
        if f > 0:
            per += d
            n_mats = 3 if cfg.act == "swiglu" else 2
            if _uses_moe(cfg, i):
                per += d * cfg.n_experts + cfg.n_experts * n_mats * d * f
            else:
                per += n_mats * d * f
        total += per * cfg.n_groups
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Active-per-token parameters (MoE: top-k experts only)."""
    if not cfg.n_experts:
        return param_count(cfg)
    d, f = cfg.d_model, cfg.d_ff
    n_mats = 3 if cfg.act == "swiglu" else 2
    inactive = (cfg.n_experts - cfg.experts_per_token) * n_mats * d * f
    n_moe = sum(cfg.n_groups for i, _ in enumerate(cfg.layer_pattern)
                if _uses_moe(cfg, i))
    return param_count(cfg) - inactive * n_moe


def trainable_param_count(cfg: ModelConfig) -> int:
    """Parameters in the student's trainable subset (optimizer-state
    load)."""
    if cfg.trainable == "all":
        return param_count(cfg)
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    per_attn = d * h * dh + 2 * d * hk * dh + h * dh * d + d + 2
    n_attn = sum(cfg.n_groups for ch in cfg.layer_pattern if ch in "AC")
    return per_attn * n_attn
