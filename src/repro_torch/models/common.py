"""Shared building blocks (torch twin of ``repro.models.common``).

Weights keep the JAX package's [in, out] layout, so activations multiply
them on the right (``x @ w``) exactly as the JAX code does.
"""
from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# init helpers (torch.Generator; the numbers differ from jax.random's)
# ---------------------------------------------------------------------------


def dense_init(shape, dtype, *, generator: torch.Generator,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) init at std `scale`, by default the
    fan-in std (shape[0] of a 2-d or stacked weight, as in the JAX
    package), drawn on the generator's device."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(x, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return (std * x).to(dtype)


def embed_init(shape, dtype, *, generator: torch.Generator) -> torch.Tensor:
    x = torch.randn(shape, dtype=torch.float32, generator=generator,
                    device=generator.device)
    return (x * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rmsnorm(w: torch.Tensor, x: torch.Tensor, *, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def rope_freqs(dh: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: [B, H, S, Dh]; positions: [S] or [B, S] int (per-slot offsets).
    Pairs (2i, 2i+1) rotate by positions * freqs[i]."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)               # [Dh/2]
    ang = positions[..., :, None].to(torch.float32) * freqs      # [(B,)S,Dh/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    if cos.ndim == 3:            # per-batch positions: insert the head axis
        cos, sin = cos[:, None], sin[:, None]
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def mlp(w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor | None,
        x: torch.Tensor, *, act: str) -> torch.Tensor:
    """SwiGLU (w3 gates) or GeLU (tanh approximation, as jax.nn.gelu)."""
    h = x @ w1
    if act == "swiglu":
        h = torch.nn.functional.silu(h) * (x @ w3)
    else:
        h = torch.nn.functional.gelu(h, approximate="tanh")
    return h @ w2


def unembed(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [..., D] @ w [D, V] -> float32 logits."""
    return x.to(torch.float32) @ w.to(torch.float32)


# the serving step's unembed runs GEMMs this many vocabulary columns wide
UNEMBED_BLOCK = 4096


def unembed_blocked(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`unembed` as GEMMs of UNEMBED_BLOCK columns each, over contiguous
    row blocks of w's float32 transpose, when the vocabulary divides (else
    `unembed`). Every GEMM has one shape and one layout whether w is the
    whole vocabulary or a tensor-parallel rank's slice of it, so each
    column's float32 sum runs in one order: cuBLAS picks its algorithm by
    the product's shape, and on an H100 a 4-row [576, 49152] product and
    its [576, 16384] slice sum some columns differently."""
    v = w.shape[-1]
    if v % UNEMBED_BLOCK:
        return unembed(x, w)
    wt = w.t().to(torch.float32, memory_format=torch.contiguous_format)
    xf = x.to(torch.float32)
    return torch.cat([xf @ wt[i:i + UNEMBED_BLOCK].t()
                      for i in range(0, v, UNEMBED_BLOCK)], dim=-1)


# ---------------------------------------------------------------------------
# pooled per-slot state (indexed entry reads and writes)
# ---------------------------------------------------------------------------
# A state pool is a dict of [n_entries + 1, ...] tensors: entries
# [0, n_entries) match the JAX pool, and entry n_entries is a trash entry
# that absorbs dropped writes (the JAX package drops them through an
# out-of-bounds id, which torch's indexed writes refuse). No state table
# ever names it.


def pool_read(pool: dict, entries: torch.Tensor) -> dict:
    """Gather state entries into a batch view (a copy): entries [B] int
    ids, negative ids reading entry 0 (callers drop those rows' writes).
    Returns a dict of [B, ...] tensors."""
    idx = entries.to(torch.int64).clamp_min(0)
    return {name: leaf.index_select(0, idx) for name, leaf in pool.items()}


def pool_write(pool: dict, new: dict, entries: torch.Tensor,
               ok: torch.Tensor) -> None:
    """Scatter a batch view back into its entries, in place. Rows where
    `ok` is False, or whose id is negative, go to the trash entry."""
    for name, leaf in pool.items():
        trash = leaf.shape[0] - 1
        idx = torch.where(ok & (entries >= 0), entries.to(torch.int64),
                          trash)
        leaf.index_copy_(0, idx, new[name].to(leaf.dtype))
