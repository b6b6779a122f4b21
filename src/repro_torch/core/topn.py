"""Top-N attention sparsification, histogram path (torch twin of the
inference half of ``repro.core.topn``).

Integer binary scores live on the d+1 lattice {-d, -d+2, ..., d}, so a
(d+1)-bin histogram and a reverse cumulative count give the exact top-N
threshold with no sort. Every element with score >= threshold is kept, so
the kept count is >= min(N, row length) (ties included).

Only what the kernels' plain versions need is here; the continuous
(training-time) threshold methods wait for the training slice.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def score_to_level(scores: torch.Tensor, d: int) -> torch.Tensor:
    """Map integer binary scores in {-d, ..., d} to bin index 0..d."""
    return torch.div(scores + d, 2, rounding_mode="floor")


def level_to_score(level: torch.Tensor, d: int) -> torch.Tensor:
    return 2 * level - d


def score_histogram(scores: torch.Tensor, d: int, *,
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    """Histogram over the d+1 score levels, summed over the last (key) axis.

    scores: [..., k] int32 on the binary-score lattice; valid: optional
    bool mask broadcastable to scores. Returns [..., d+1] int32 counts in
    ascending level order. Levels outside 0..d are dropped, as the JAX
    scatter's mode="drop" does.
    """
    levels = score_to_level(scores.to(torch.int64), d)
    k = scores.shape[-1]
    flat = levels.reshape(-1, k)
    weights = (torch.ones_like(flat) if valid is None else
               torch.broadcast_to(valid, scores.shape).reshape(-1, k)
               .to(torch.int64))
    in_range = (flat >= 0) & (flat <= d)
    weights = torch.where(in_range, weights, 0)
    hist = torch.zeros((flat.shape[0], d + 1), dtype=torch.int64,
                       device=scores.device)
    hist.scatter_add_(1, flat.clamp(0, d), weights)
    return hist.to(torch.int32).reshape(*scores.shape[:-1], d + 1)


def threshold_from_histogram(hist: torch.Tensor, n: int | torch.Tensor,
                             d: int) -> torch.Tensor:
    """Exact top-N threshold score from a level histogram.

    hist: [..., d+1] counts. Returns the largest score t (int32) such that
    count(score >= t) >= min(n, total).
    """
    cc = torch.flip(torch.cumsum(torch.flip(hist, (-1,)), -1), (-1,))
    total = cc[..., 0]
    n_eff = torch.minimum(torch.as_tensor(n, dtype=cc.dtype,
                                          device=cc.device), total)
    levels = torch.arange(d + 1, dtype=torch.int64, device=hist.device)
    ok = cc >= n_eff[..., None]
    idx = torch.where(ok, levels, -1).amax(-1).clamp_min(0)
    return level_to_score(idx, d).to(torch.int32)


def topn_mask_binary(scores: torch.Tensor, n: int | torch.Tensor, d: int, *,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """Top-N mask for integer binary scores via the histogram threshold."""
    hist = score_histogram(scores, d, valid=valid)
    t = threshold_from_histogram(hist, n, d)
    mask = scores >= t[..., None]
    if valid is not None:
        mask = mask & valid
    return mask


def sparse_softmax(logits: torch.Tensor, mask: torch.Tensor, *,
                   scale: float | torch.Tensor = 1.0) -> torch.Tensor:
    """softmax(scale * logits) restricted to mask, reduced in float32.

    Rows with an empty mask return all zeros.
    """
    logits = logits.to(torch.float32)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=logits.device)
    masked = torch.where(mask, logits * scale, neg)
    m = masked.amax(-1, keepdim=True)
    m = torch.where(m <= neg / 2, torch.zeros_like(m), m)
    e = torch.where(mask, torch.exp(masked - m), 0.0)
    z = e.sum(-1, keepdim=True)
    return e / torch.clamp_min(z, 1e-30)


def scale_n_with_context(context_len: int, *, frac: float = 0.117,
                         n_min: int = 16, n_max: int = 4096) -> int:
    """Paper §4.3: N scales linearly with context length, clamped."""
    return int(max(n_min, min(n_max, round(frac * context_len))))
