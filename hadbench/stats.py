"""The end-to-end arithmetic of a window, on host stamps alone: a rate is
taken over all the window's work and all its time, and a percentile over
every sample."""
from __future__ import annotations

import dataclasses
import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, linearly interpolated
    between the closest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclasses.dataclass
class Record:
    """One request sent: the host times it was sent and its latencies
    count from (`origin`: due in an open loop, sent in a closed one), and
    the host stamp of each of its tokens as the scheduler delivered it."""
    rid: int
    client: int
    prompt: object
    sent: float
    origin: float
    stamps: list = dataclasses.field(default_factory=list)
    tokens: list = dataclasses.field(default_factory=list)
    finished: bool = False


def window(records, t0: float, t1: float) -> dict:
    """The window [t0, t1)'s samples and end-to-end metrics: `gen_tok_s`
    every token stamped inside it over its length; `ttft_ms` of every
    request sent inside it (to its first token, stamped inside the window
    or after); `itl_ms` every gap between two consecutive tokens of one
    request whose later token is stamped inside it."""
    n_tok = sum(1 for r in records for s in r.stamps if t0 <= s < t1)
    sent = [r for r in records if t0 <= r.sent < t1]
    ttft = [(r.stamps[0] - r.origin) * 1e3 for r in sent if r.stamps]
    itl = [(b - a) * 1e3 for r in records
           for a, b in zip(r.stamps, r.stamps[1:]) if t0 <= b < t1]
    out = {"gen_tok_s": n_tok / (t1 - t0), "tokens": n_tok,
           "attempted": len(sent),
           "failed": sum(1 for r in sent if not r.stamps),
           "finished": sum(1 for r in sent if r.finished),
           "ttft_ms": ttft, "itl_ms": itl}
    # a growing backlog: requests still unanswered at the close, and the
    # median TTFT of the window's last third against its first
    out["unanswered_at_close"] = sum(1 for r in sent
                                     if not r.stamps or r.stamps[0] >= t1)
    third = (t1 - t0) / 3
    for key, lo in (("ttft_p50_first_third_ms", t0),
                    ("ttft_p50_last_third_ms", t1 - third)):
        part = [(r.stamps[0] - r.origin) * 1e3 for r in sent
                if r.stamps and lo <= r.sent < lo + third]
        out[key] = percentile(part, 50) if part else None
    if ttft:
        out["ttft_p50_ms"] = percentile(ttft, 50)
        out["ttft_p95_ms"] = percentile(ttft, 95)
    if itl:
        out["itl_p50_ms"] = percentile(itl, 50)
        out["itl_p95_ms"] = percentile(itl, 95)
    return out
