"""Open loop: requests arrive at ``rate_per_s`` with exponential gaps
(Poisson arrivals) whether or not earlier ones have finished.

Traffic keys: ``rate_per_s``; ``prompt`` and ``output`` sizes.
A window of `seconds` sends n = round(rate * seconds) requests. Their gaps
are the n stratified quantiles of the exponential (scaled to last the
window), in the seed's order over the whole window, so arrivals bunch
and thin as Poisson arrivals do; their sizes are stratified sets in
orders of their own. So every seed sends the same work over the same
span, and a seed moves where the bursts fall and which sizes meet them.
"""
from __future__ import annotations

import numpy as np

from hadbench.loops import Req, rng, spread, tokens

KIND = "open"


class OpenLoop:
    KIND = KIND

    def __init__(self, traffic: dict, *, seed: int, vocab: int,
                 seconds: float):
        self.seed, self.vocab = seed, vocab
        rate = float(traffic["rate_per_s"])
        n = max(1, round(rate * seconds))
        u = (np.arange(n) + 0.5) / n
        gaps = -np.log1p(-u)
        gaps *= n / rate / gaps.sum()
        self.gaps = rng(seed, 6).permutation(gaps)
        self.prompts = spread(traffic["prompt"], n, rng(seed, 7))
        self.outputs = spread(traffic["output"], n, rng(seed, 8))
        self.times: np.ndarray | None = None
        self.next = 0

    def setup_prompts(self) -> list[np.ndarray]:
        return []

    def start(self, t0: float) -> None:
        self.times = t0 + np.cumsum(self.gaps) - self.gaps
        self.next = 0

    def due(self, now: float) -> list[Req]:
        out = []
        while self.next < len(self.times) and self.times[self.next] <= now:
            i = self.next
            self.next += 1
            out.append(Req(client=i, tokens=tokens(
                rng(self.seed, 9, i), self.prompts[i], self.vocab),
                max_new=int(self.outputs[i]), due=float(self.times[i])))
        return out

    def next_due(self) -> float | None:
        if self.times is None or self.next >= len(self.times):
            return None
        return float(self.times[self.next])

    def finished(self, req: Req, now: float) -> None:
        pass


def make(traffic: dict, *, seed: int, vocab: int, seconds: float):
    return OpenLoop(traffic, seed=seed, vocab=vocab, seconds=seconds)
