"""How `correct` is decided: once the window has closed and the program
is freed, a sample drawn from the seed of the requests that were served
(the one with the longest context always among them) is run through the
plain float32 reference of the cell's model module (`hadbench.reference`),
each prompt with the tokens the program served after it, and at every
served token the gap by which its reference logit lies below the
reference's best is read.
`numbers` reads them four ways: the widest gap (`gap_max`, in logits),
the mean gap (`gap_mean`), the share of served tokens that are not the
reference's best (`mismatch`) and the share whose gap exceeds a set
margin (`share_over`). A cell's
``limits/<cell>.json`` names the ones it compares, each with its limit
(and ``share_over`` its margin, ``gap``).

The control (``calibrate.py``) reads the same gaps for the tokens that
the fp8 reference puts first at each of those positions, and is judged
against the same limits (``run.judge``)."""
from __future__ import annotations

import numpy as np
import torch

from hadbench.loops import rng


def sample(records, seed: int, k: int) -> list:
    """Up to k served requests: the longest (prompt and served tokens)
    and k - 1 drawn by the seed, in request order."""
    served = [r for r in records if r.tokens]
    if not served:
        return []
    longest = max(served, key=lambda r: (len(r.prompt) + len(r.tokens),
                                         -r.rid))
    rest = [r for r in served if r is not longest]
    pick = rng(seed, 10).permutation(len(rest))[:max(0, k - 1)]
    return sorted([longest] + [rest[i] for i in pick], key=lambda r: r.rid)


def sequences(recs) -> tuple[list, list, list]:
    """(token sequences, positions whose logits predict a served token,
    the served tokens) of each sampled request."""
    seqs, pos, served = [], [], []
    for r in recs:
        toks = np.asarray(r.tokens, np.int64)
        p = np.asarray(r.prompt, np.int64)
        seqs.append(np.concatenate([p, toks[:-1]]))
        pos.append(np.arange(len(p) - 1, len(p) - 1 + len(toks)))
        served.append(toks)
    return seqs, pos, served


def gaps(logits: torch.Tensor, tokens) -> np.ndarray:
    """The reference's best logit minus its logit of each token, a row a
    position."""
    idx = torch.as_tensor(np.asarray(tokens, np.int64),
                          device=logits.device)
    got = logits.gather(1, idx[:, None])[:, 0]
    return (logits.max(-1).values - got).double().cpu().numpy()


def numbers(g: np.ndarray, over: float | None = None) -> dict:
    """The readings of one run's gaps (every served token's); with
    `over`, the share of gaps above that margin too."""
    if g.size == 0:
        return {}
    out = {"gap_max": float(g.max()), "gap_mean": float(g.mean()),
           "mismatch": float((g > 0).mean())}
    if over is not None:
        out["share_over"] = float((g > over).mean())
    return out


def served_gaps(module, port: dict, recs, *, seed: int, max_len: int,
                device, quant: str | None = None) -> np.ndarray:
    """Every gap of the served tokens of `recs` on the `Reference` of
    `module`, the cell's model module (``hadbench.reference``) (with
    `quant`: of the tokens that reference puts first, read on the float32
    one)."""
    seqs, pos, served = sequences(recs)
    ref = module.Reference(port, seed=seed, max_len=max_len, device=device)
    base = ref.logits(seqs, pos)
    if quant is not None:
        low = module.Reference(port, seed=seed, max_len=max_len,
                               device=device, quant=quant).logits(seqs, pos)
        served = [lg.argmax(-1).cpu().numpy() for lg in low]
        del low
    out = [gaps(lg, s) for lg, s in zip(base, served)]
    return np.concatenate(out) if out else np.zeros(0)
