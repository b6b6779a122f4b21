"""Distillation losses (torch twin of ``repro.core.losses``; paper Eq.
9-11) and standard objectives.

Eq. 9/10 are KL divergences between softmax distributions: for a teacher
logit row t and student logit row s,

    KL(row) = sum_j p_t(j) * (log p_t(j) - log p_s(j)),   p = softmax.

The attention KL is the unweighted mean over all rows of all attention maps
(1/(M n) in Eq. 9; the inner sum over j is the KL of one row). Every
reduction runs in float32.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _masked_log_softmax(logits: torch.Tensor,
                        mask: torch.Tensor | None) -> torch.Tensor:
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    return torch.log_softmax(logits, dim=-1)


def kl_divergence(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
                  *, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Row-wise KL(softmax(teacher) || softmax(student)) over the last axis.

    mask: optional bool mask of valid entries; masked entries get zero
    probability on both sides. Returns the [...]-shaped per-row KL.
    """
    lp_t = _masked_log_softmax(teacher_logits.to(torch.float32), mask)
    lp_s = _masked_log_softmax(student_logits.to(torch.float32), mask)
    per = torch.exp(lp_t) * (lp_t - lp_s)
    if mask is not None:
        per = torch.where(mask, per, 0.0)
    return per.sum(-1)


def attention_kl(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
                 *, mask: torch.Tensor | None = None,
                 row_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 9: mean over all rows / heads / maps of the per-row attention
    KL. row_valid: optional bool [..., q] of rows that exist (padding
    queries leave the mean)."""
    per_row = kl_divergence(teacher_logits, student_logits, mask=mask)
    if row_valid is not None:
        per_row = torch.where(row_valid, per_row, 0.0)
        denom = row_valid.to(torch.float32).sum().clamp_min(1.0)
        return per_row.sum() / denom
    return per_row.mean()


def _vocab_mask(logits: torch.Tensor, valid_size: int | None):
    if valid_size is None or valid_size == logits.shape[-1]:
        return None
    return torch.arange(logits.shape[-1], device=logits.device) < valid_size


def output_kl(teacher_logits: torch.Tensor, student_logits: torch.Tensor, *,
              valid: torch.Tensor | None = None,
              valid_size: int | None = None) -> torch.Tensor:
    """Eq. 10: KL on model output logits, mean over batch (and positions).

    valid: optional bool mask over the leading dims; valid_size: the true
    vocab size when the last axis is padded (pad columns leave both
    softmaxes).
    """
    mask = _vocab_mask(teacher_logits, valid_size)
    if mask is not None:
        mask = torch.broadcast_to(mask, teacher_logits.shape)
    per = kl_divergence(teacher_logits, student_logits, mask=mask)
    if valid is not None:
        per = torch.where(valid, per, 0.0)
        return per.sum() / valid.to(torch.float32).sum().clamp_min(1.0)
    return per.mean()


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          valid: torch.Tensor | None = None,
                          valid_size: int | None = None) -> torch.Tensor:
    """Token-level CE for the pretrain path; labels int [...]."""
    logits = logits.to(torch.float32)
    vmask = _vocab_mask(logits, valid_size)
    if vmask is not None:
        logits = torch.where(vmask, logits, NEG_INF)
    lp = torch.log_softmax(logits, dim=-1)
    nll = -lp.gather(-1, labels.to(torch.int64)[..., None])[..., 0]
    if valid is not None:
        nll = torch.where(valid, nll, 0.0)
        return nll.sum() / valid.to(torch.float32).sum().clamp_min(1.0)
    return nll.mean()


def combined_distill_loss(att_kl: torch.Tensor, out_kl: torch.Tensor, *,
                          use_attention_loss: bool) -> torch.Tensor:
    """Eq. 11 (stages 1-3) / Eq. 19 (stage 4: attention term dropped):
    w * att_kl + out_kl with w = 1.0 or 0.0."""
    return float(bool(use_attention_loss)) * att_kl + out_kl
