"""Attention variants (torch twin of ``repro.core.attention``): standard
(teacher / full-precision baseline), HAD train-time (top-N over dense
logits, and the fused teacher + student distillation pair), and the
plain inference-path HAD attention over packed bits.

Shape contract (grouped-query attention throughout):
  q: [B, H, Sq, D]     (H query heads)
  k: [B, Hk, Sk, D]    (Hk KV heads; H % Hk == 0)
  v: [B, Hk, Sk, Dv]
  out: [B, H, Sq, Dv]

The JAX package computes all of these with ``jnp.einsum`` outside any
Pallas kernel, so they have no kernel here either: the products are
``torch.einsum`` and the backward is autograd's. JAX's module-global
``ATTN_DTYPE`` (the train-path logit dtype) is the explicit `attn_dtype`
argument here, float32 by default.

Binarized logits and ties. When Q and K are sigma * (+-1) (stages 3-4 and
``had_eval``), the logits are sums of +-sigma_q * sigma_k, and many keys of
a row tie exactly at the N-th value. A float product of sigma-scaled signs
rounds its partial sums (m * c is not representable for most m unless c
is a power of two), so the same integer score can land on different
floats and the ``>=`` threshold splits the tie by summation order. The
train-time functions therefore take the signs and the scale apart
(`qk_scale`): the logits are the exact integer product of the signs times
sigma_q * sigma_k, monotone in the integer score, so a tie stays a tie on
every device, as the integer Hamming scores of `had_infer_attention` and
the serving kernels keep it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import hamming, losses, topn

NEG_INF = -1e30


def choose_block(s: int, target: int = 512) -> int:
    """Largest divisor of s that is <= target (>= 1)."""
    b = min(s, target)
    while s % b:
        b -= 1
    return b


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


def _logits(qg: torch.Tensor, k: torch.Tensor, attn_dtype,
            qk_scale: torch.Tensor | None) -> torch.Tensor:
    """Unscaled grouped logits [B, Hk, G, Sq, Sk] in `attn_dtype`: q . k,
    or, with `qk_scale`, (sign q . sign k) * qk_scale (exact ties)."""
    raw = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(attn_dtype),
                       k.to(attn_dtype))
    if qk_scale is not None:
        raw = raw * qk_scale.to(attn_dtype)
    return raw


def had_topn_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       n: int, scale: float, causal: bool = True,
                       q_offset: torch.Tensor | int = 0,
                       kv_valid: torch.Tensor | None = None,
                       return_logits: bool = False,
                       method: str | None = None,
                       qk_scale: torch.Tensor | None = None,
                       attn_dtype=torch.float32):
    """HAD student attention, Eq. 5-8 (dense compute, top-N mask).

    q/k are the (tanh-softened or binarized) Q/K; with `qk_scale` they are
    the signs (+-1) and qk_scale = sigma_q * sigma_k (see the module
    docstring). The top-N mask is taken on the unscaled logits (Eq. 6),
    then the softmax applies `scale` within the mask (Eq. 7). Returns out,
    and with return_logits also the scaled pre-mask logits (NEG_INF where
    invalid) for the Eq. 9 KL.
    """
    hk = k.shape[1]
    raw = _logits(_group(q, hk), k, attn_dtype, qk_scale)
    mask = _key_mask(q.shape[2], k.shape[2], causal=causal,
                     q_offset=q_offset, kv_valid=kv_valid, device=q.device)
    valid = None if mask is None else torch.broadcast_to(mask, raw.shape)
    keep = topn.topn_mask(raw, n, valid=valid, method=method)
    a = topn.sparse_softmax(raw, keep, scale=scale).to(attn_dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", a, v.to(attn_dtype))
    out = _ungroup(out).to(v.dtype)
    if return_logits:
        logits = raw * scale
        if valid is not None:
            logits = torch.where(valid, logits, NEG_INF)
        return out, logits
    return out


class DistillAttnOut(NamedTuple):
    teacher_out: torch.Tensor
    student_out: torch.Tensor
    kl_sum: torch.Tensor      # sum of per-row KL over all rows and heads
    row_count: torch.Tensor   # number of rows contributing (float32)


def distill_pair_attention(qt: torch.Tensor, kt: torch.Tensor,
                           vt: torch.Tensor, qs: torch.Tensor,
                           ks: torch.Tensor, vs: torch.Tensor, *, n: int,
                           scale: float, causal: bool = True,
                           kv_valid: torch.Tensor | None = None,
                           q_block: int = 512, method: str | None = None,
                           qk_scale: torch.Tensor | None = None,
                           attn_dtype=torch.float32) -> DistillAttnOut:
    """Fused teacher + student attention with Eq. 9 KL accumulation.

    Runs over query blocks of `choose_block(Sq, q_block)` rows; each block
    materializes the full [bq, Sk] teacher and student logit rows (exact
    top-N and the row-wise KL need them), computes both outputs and the KL
    contribution, then frees them. Each block runs under
    ``torch.utils.checkpoint`` (non-reentrant), so the backward recomputes
    its rows as ``jax.checkpoint`` does instead of holding every block's.
    The student's q/k and `qk_scale` are as in `had_topn_attention`.
    """
    b, h, sq, _ = qt.shape
    hk = kt.shape[1]
    bq = choose_block(sq, q_block)

    def blk(qt_b, qs_b, offset):
        mask = _key_mask(bq, kt.shape[2], causal=causal, q_offset=offset,
                         kv_valid=kv_valid, device=qt.device)
        lt = _logits(_group(qt_b, hk), kt, attn_dtype, None) * scale
        raw_s = _logits(_group(qs_b, hk), ks, attn_dtype, qk_scale)
        ls = raw_s * scale
        valid = None if mask is None else torch.broadcast_to(mask, lt.shape)
        lt_m = lt if valid is None else torch.where(valid, lt, NEG_INF)
        at = torch.softmax(lt_m.to(torch.float32), dim=-1)
        out_t = _ungroup(torch.einsum("bhgqk,bhkd->bhgqd", at.to(attn_dtype),
                                      vt.to(attn_dtype)))
        keep = topn.topn_mask(raw_s, n, valid=valid, method=method)
        as_ = topn.sparse_softmax(raw_s, keep, scale=scale)
        out_s = _ungroup(torch.einsum("bhgqk,bhkd->bhgqd",
                                      as_.to(attn_dtype), vs.to(attn_dtype)))
        kl = losses.kl_divergence(lt, ls, mask=valid)      # [B,Hk,G,bq]
        return out_t.to(vt.dtype), out_s.to(vs.dtype), kl.sum()

    outs_t, outs_s, kls = [], [], []
    for i in range(sq // bq):
        args = (qt[:, :, i * bq:(i + 1) * bq], qs[:, :, i * bq:(i + 1) * bq],
                i * bq)
        if torch.is_grad_enabled():
            o_t, o_s, kl = checkpoint(blk, *args, use_reentrant=False)
        else:
            o_t, o_s, kl = blk(*args)
        outs_t.append(o_t)
        outs_s.append(o_s)
        kls.append(kl)
    rows = torch.tensor(float(b * h * sq), dtype=torch.float32,
                        device=qt.device)
    return DistillAttnOut(torch.cat(outs_t, 2), torch.cat(outs_s, 2),
                          torch.stack(kls).sum(), rows)


def had_infer_attention(q_bits: torch.Tensor, k_bits: torch.Tensor,
                        v: torch.Tensor, *, d: int, n: int, scale: float,
                        causal: bool = True,
                        q_offset: torch.Tensor | int = 0,
                        kv_valid: torch.Tensor | None = None,
                        q_length: torch.Tensor | None = None,
                        q_block: int = 128,
                        k_chunk: int = 1024) -> torch.Tensor:
    """Inference-path HAD attention from packed bits (plain torch; the
    JAX package's pure-jnp reference of the serving kernels).

    q_bits [B, H, Sq, W] int32 words; k_bits [B, Hk, Sk, W]; v [B, Hk, Sk,
    Dv]. `scale` folds sigma_q * sigma_k / sqrt(d_k). q_offset: a scalar
    or [B] per-slot offsets; q_length: optional [B] valid query counts
    (rows past them are zeroed). Over query blocks, two passes over key
    chunks: integer scores -> cumulative level counts -> the exact top-N
    threshold; then the threshold-masked exp(scale * (s - d)) accumulation
    (bounded by 1, so no running max).
    """
    b, h, sq, _ = q_bits.shape
    hk, sk, dv = k_bits.shape[1], k_bits.shape[2], v.shape[-1]
    bq = choose_block(sq, q_block)
    bk = choose_block(sk, k_chunk)
    dev = q_bits.device
    levels = torch.arange(-d, d + 1, 2, dtype=torch.int32, device=dev)
    q_base = torch.broadcast_to(torch.as_tensor(q_offset, device=dev)
                                .to(torch.int64), (b,))
    outs = []
    for qi in range(sq // bq):
        qg = _group(q_bits[:, :, qi * bq:(qi + 1) * bq], hk)
        qpos = q_base[:, None] + qi * bq + torch.arange(bq, device=dev)

        def chunk_valid(ki):
            kpos = ki * bk + torch.arange(bk, device=dev)
            val = torch.ones((b, 1, 1, bq, bk), dtype=torch.bool, device=dev)
            if causal:
                cm = kpos[None, None, :] <= qpos[:, :, None]   # [B,bq,bk]
                val = val & cm[:, None, None]
            if kv_valid is not None:
                val = val & kv_valid[:, None, None, None,
                                     ki * bk:(ki + 1) * bk]
            return val

        def scores_for(ki):
            kb = k_bits[:, :, ki * bk:(ki + 1) * bk]            # [B,Hk,bk,W]
            return hamming.binary_scores(qg, kb[:, :, None], d)

        cc = torch.zeros((b, hk, h // hk, bq, d + 1), dtype=torch.int32,
                         device=dev)
        for ki in range(sk // bk):
            ge = (scores_for(ki)[..., None] >= levels) \
                & chunk_valid(ki)[..., None]
            cc = cc + ge.to(torch.int32).sum(-2)
        n_eff = torch.clamp_max(cc[..., 0:1], n)
        lv = torch.arange(d + 1, dtype=torch.int32, device=dev)
        idx = torch.where(cc >= n_eff, lv, -1).amax(-1)
        thresh = 2 * idx.clamp_min(0) - d                      # [B,Hk,G,bq]
        num = torch.zeros((b, hk, h // hk, bq, dv), dtype=torch.float32,
                          device=dev)
        den = torch.zeros((b, hk, h // hk, bq, 1), dtype=torch.float32,
                          device=dev)
        for ki in range(sk // bk):
            s = scores_for(ki)
            keep = (s >= thresh[..., None]) & chunk_valid(ki)
            e = torch.where(keep, torch.exp(scale * (s - d).to(torch.float32)),
                            0.0)
            vk = v[:, :, ki * bk:(ki + 1) * bk].to(torch.float32)
            num = num + torch.einsum("bhgqk,bhkd->bhgqd", e, vk)
            den = den + e.sum(-1, keepdim=True)
        outs.append(_ungroup(num / den.clamp_min(1e-30)))
    out = torch.cat(outs, 2)
    if q_length is not None:
        live = (torch.arange(sq, device=dev)[None, :]
                < q_length.to(torch.int64)[:, None])
        out = torch.where(live[:, None, :, None], out, 0.0)
    return out.to(v.dtype)
