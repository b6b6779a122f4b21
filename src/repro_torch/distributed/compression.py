"""Gradient compression with error feedback (torch twin of
``repro.distributed.compression``): 1-bit sign compression (signSGD-EF)
and int8, as the lossy channel a cross-pod gradient reduce would be.

`compress_grads` quantizes and dequantizes each gradient with its error
feedback, inside the train step. The JAX package's `psum_compressed`, the
collective itself, waits with tensor-parallel serving (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import torch


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
