"""Full-precision softmax attention (torch twin of the serving half of
``repro.core.attention``): the baseline that HAD is compared with.

Shape contract (grouped-query attention throughout):
  q: [B, H, Sq, D]     (H query heads)
  k: [B, Hk, Sk, D]    (Hk KV heads; H % Hk == 0)
  v: [B, Hk, Sk, Dv]
  out: [B, H, Sq, Dv]

The JAX package computes this with ``jnp.einsum`` outside any Pallas
kernel, so it has no kernel here either: the products are
``torch.einsum``. The train-time HAD variants wait for the training slice.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _group(q: torch.Tensor, hk: int) -> torch.Tensor:
    """[B, H, Sq, D] -> [B, Hk, G, Sq, D]."""
    b, h, sq, d = q.shape
    return q.reshape(b, hk, h // hk, sq, d)


def _ungroup(x: torch.Tensor) -> torch.Tensor:
    """[B, Hk, G, Sq, Dv] -> [B, H, Sq, Dv]."""
    b, hk, g, sq, dv = x.shape
    return x.reshape(b, hk * g, sq, dv)


def _key_mask(sq: int, sk: int, *, causal: bool,
              q_offset: torch.Tensor | int,
              kv_valid: torch.Tensor | None,
              device=None) -> torch.Tensor | None:
    """Validity mask [B or 1, 1, 1, sq, sk] (True = key usable).

    q_offset is a scalar (all rows share an offset) or a [B] tensor of
    per-slot offsets (ragged serving batches); kv_valid [B, sk] bool.
    """
    mask = None
    if causal:
        kj = torch.arange(sk, device=device)
        qi = torch.arange(sq, device=device)
        if isinstance(q_offset, torch.Tensor) and q_offset.ndim == 1:
            qi = q_offset.to(torch.int64)[:, None] + qi[None]   # [B, sq]
            mask = (kj <= qi[..., None])[:, None, None]         # [B,1,1,sq,sk]
        else:
            mask = (kj <= (qi + q_offset)[:, None])[None, None, None]
    if kv_valid is not None:
        kvm = kv_valid[:, None, None, None, :]                  # [B,1,1,1,sk]
        mask = kvm if mask is None else mask & kvm
    return mask


def standard_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       scale: float, causal: bool = True,
                       q_offset: torch.Tensor | int = 0,
                       kv_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Dense softmax attention (the teacher / baseline path).

    As in the JAX package: float32 logits of the grouped product, times
    `scale` after the product; masked keys get NEG_INF (not -inf, so a row
    with no usable key is uniform rather than NaN); float32 softmax and
    float32 product with V, cast to v's dtype. Returns [B, H, Sq, Dv].
    """
    hk = k.shape[1]
    qg = _group(q, hk).to(torch.float32)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg,
                          k.to(torch.float32)) * scale
    mask = _key_mask(q.shape[2], k.shape[2], causal=causal,
                     q_offset=q_offset, kv_valid=kv_valid, device=q.device)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    a = torch.softmax(logits, dim=-1)
    del logits
    out = torch.einsum("bhgqk,bhkd->bhgqd", a, v.to(torch.float32))
    return _ungroup(out).to(v.dtype)
