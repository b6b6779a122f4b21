"""Top-N attention sparsification (torch twin of ``repro.core.topn``,
paper §3.2, Eq. 6-7).

Two implementations:

* `topn_threshold_exact` -- continuous logits (training stages): the N-th
  largest value per row, by an ascending sort ("sort") or a fixed
  26-iteration bisection on the threshold ("bisect"); the mask keeps
  scores >= that value (ties at the threshold are kept).
* histogram path -- integer binary scores live on the d+1 lattice
  {-d, -d+2, ..., d}, so a (d+1)-bin histogram and a reverse cumulative
  count give the exact top-N threshold with no sort.

Every element with score >= threshold is kept, so the kept count is
>= min(N, row length) (ties included).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30

THRESHOLD_METHODS = ("sort", "bisect")


def _bisect_threshold(scores: torch.Tensor, n_eff: int, *,
                      valid: torch.Tensor | None = None,
                      iters: int = 26) -> torch.Tensor:
    """Bisect on [min_valid, max_valid] (masked NEG_INF entries never
    enter the range); count(scores >= lo) >= n_eff at every step."""
    if valid is not None:
        lo = torch.where(valid, scores, torch.inf).amin(-1)
        hi = torch.where(valid, scores, -torch.inf).amax(-1)
    else:
        lo = scores.amin(-1)
        hi = scores.amax(-1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = (scores >= mid[..., None]).to(torch.int32).sum(-1)
        ge = cnt >= n_eff
        lo = torch.where(ge, mid, lo)
        hi = torch.where(ge, hi, mid)
    return lo


def topn_threshold_exact(scores: torch.Tensor, n: int, *,
                         valid: torch.Tensor | None = None,
                         method: str | None = None) -> torch.Tensor:
    """Per-row threshold = N-th largest valid score.

    scores [..., m, k] float; valid: bool mask broadcastable to scores.
    Returns thresholds [..., m] such that (scores >= t) keeps >= min(n,
    row) elements; a row with fewer than n valid keys gets NEG_INF (keep
    all). The scores are detached (JAX's stop_gradient: the selection is
    a hard decision). method: "sort" (default: the (k - n)-th value of an
    ascending sort, as JAX takes it) or "bisect".
    """
    if valid is not None:
        scores = torch.where(valid, scores, NEG_INF)
    k = scores.shape[-1]
    n_eff = min(n, k)
    scores = scores.detach()
    method = "sort" if method is None else method
    assert method in THRESHOLD_METHODS, method
    if method == "bisect":
        return _bisect_threshold(
            scores, n_eff,
            valid=None if valid is None else torch.broadcast_to(
                valid, scores.shape))
    # the (k - n_eff)-th value of an ascending sort, found by selection
    # (the same element; no sorted copy and no index tensor)
    return torch.kthvalue(scores, k - n_eff + 1, dim=-1).values


def topn_mask(scores: torch.Tensor, n: int, *,
              valid: torch.Tensor | None = None,
              method: str | None = None) -> torch.Tensor:
    """Boolean mask keeping (at least) the top-n valid scores per row."""
    t = topn_threshold_exact(scores, n, valid=valid, method=method)
    mask = scores >= t[..., None]
    if valid is not None:
        mask = mask & valid
    return mask


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
