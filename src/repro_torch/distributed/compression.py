"""Gradient compression with error feedback (torch twin of
``repro.distributed.compression``): 1-bit sign compression (signSGD-EF)
and int8, as the lossy channel a cross-pod gradient reduce would be.

`compress_grads` quantizes and dequantizes each gradient with its error
feedback, inside the train step. `psum_compressed` is the collective
itself over a ``torch.distributed`` group: quantize locally, sum the int8
/ sign payload over the ranks, dequantize (JAX's shard_map building
block, with its quantities and order of operations).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.collectives import all_reduce_sum


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    method: str = "none"       # "none" | "onebit" | "int8"
    ef: bool = True            # error feedback


def init_error(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _onebit_one(g: torch.Tensor, e: torch.Tensor):
    x = g.to(torch.float32) + e
    scale = x.abs().mean()
    q = torch.where(x >= 0, scale, -scale)
    return q.to(g.dtype), x - q


def _int8_one(g: torch.Tensor, e: torch.Tensor):
    x = g.to(torch.float32) + e
    scale = x.abs().amax() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127) * scale
    return q.to(g.dtype), x - q


def compress_grads(grads: dict[str, torch.Tensor],
                   error: dict[str, torch.Tensor], cfg: CompressionConfig):
    """Quantize-dequantize each gradient with error feedback. Returns
    (the gradients as seen after the lossy reduce, the new error);
    method "none" is the identity."""
    if cfg.method == "none":
        return grads, error
    fn = {"onebit": _onebit_one, "int8": _int8_one}[cfg.method]
    qs, es = {}, {}
    for k, g in grads.items():
        e = error[k]
        q, resid = fn(g, e if cfg.ef else torch.zeros_like(e))
        qs[k], es[k] = q, resid if cfg.ef else e
    return qs, es


def psum_compressed(tree, group, cfg: CompressionConfig):
    """Compress -> sum over the ranks of `group` -> average, for a tensor
    or a (nested) dict of them (JAX ``psum_compressed`` over an axis).
    onebit: the sign payload summed as int32, the per-rank scales (mean
    |x|) summed, n = the summed ones, then sum * (scale_sum / n) / n;
    int8: each rank's dequantized int8 payload (scale max|x| / 127 +
    1e-12) summed, / n; "none": the mean. Returns the tree's dtypes."""
    if isinstance(tree, dict):
        return {k: psum_compressed(v, group, cfg) for k, v in tree.items()}
    g = tree
    n = all_reduce_sum(torch.ones((), dtype=torch.float32, device=g.device),
                       group)
    if cfg.method == "none":
        return all_reduce_sum(g, group) / n.to(g.dtype)
    x = g.to(torch.float32)
    if cfg.method == "onebit":
        scale = x.abs().mean()
        payload = torch.where(x >= 0, 1, -1).to(torch.int8)
        summed = all_reduce_sum(payload.to(torch.int32), group)
        scale_sum = all_reduce_sum(scale, group)
        return (summed.to(torch.float32) * (scale_sum / n) / n).to(g.dtype)
    scale = x.abs().amax() / 127.0 + 1e-12
    payload = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    summed = all_reduce_sum(payload.to(torch.float32) * scale, group)
    return (summed / n).to(g.dtype)
