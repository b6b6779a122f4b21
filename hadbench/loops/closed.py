"""Closed loop: `clients` sessions, each sending its next request the
moment the last one finished (no think time).

Traffic keys: ``clients``; ``prefix`` (optional: one document a session,
prefilled into the engine's prefix cache during set-up, that starts
every prompt of the session); ``prompt`` (fresh tokens a request);
``output`` (tokens to generate); ``first_output`` (optional: the first
round's outputs, so that completions spread from the start);
``first_due_s`` (optional: [lo, hi], the first round's sends spread
over that span of the window, so the sessions do not all queue for
their first prefill at once).
Round r of the sessions' requests is one stratified set of sizes,
assigned to the sessions in the seed's order.
"""
from __future__ import annotations

import heapq

import numpy as np

from hadbench.loops import Req, rng, spread, tokens

KIND = "closed"


class ClosedLoop:
    KIND = KIND

    def __init__(self, traffic: dict, *, seed: int, vocab: int,
                 seconds: float):
        self.t = traffic
        self.seed, self.vocab = seed, vocab
        self.clients = int(traffic["clients"])
        self.docs = []
        if "prefix" in traffic:
            lens = spread(traffic["prefix"], self.clients, rng(seed, 1))
            gen = rng(seed, 2)
            self.docs = [tokens(gen, n, vocab) for n in lens]
        self.rounds: list[tuple] = []
        self.sent = [0] * self.clients
        self.heap: list[tuple[float, int]] = []

    def _round(self, r: int) -> tuple:
        while len(self.rounds) <= r:
            k = len(self.rounds)
            out_spec = (self.t["first_output"]
                        if k == 0 and "first_output" in self.t
                        else self.t["output"])
            self.rounds.append((
                spread(self.t["prompt"], self.clients, rng(self.seed, 3, k)),
                spread(out_spec, self.clients, rng(self.seed, 4, k))))
        return self.rounds[r]

    def request(self, c: int, due: float) -> Req:
        """Session c's next request."""
        r = self.sent[c]
        self.sent[c] += 1
        plen, out = self._round(r)
        fresh = tokens(rng(self.seed, 5, c, r), plen[c], self.vocab)
        prompt = (np.concatenate([self.docs[c], fresh]) if self.docs
                  else fresh)
        return Req(client=c, tokens=prompt, max_new=int(out[c]), due=due)

    def setup_prompts(self) -> list[np.ndarray]:
        """The documents to prefill before the window."""
        return list(self.docs)

    def start(self, t0: float) -> None:
        offsets = np.zeros(self.clients)
        if "first_due_s" in self.t:
            lo, hi = self.t["first_due_s"]
            u = (np.arange(self.clients) + 0.5) / self.clients
            offsets = rng(self.seed, 12).permutation(lo + u * (hi - lo))
        self.heap = [(t0 + float(o), c) for c, o in enumerate(offsets)]
        heapq.heapify(self.heap)

    def due(self, now: float) -> list[Req]:
        out = []
        while self.heap and self.heap[0][0] <= now:
            t, c = heapq.heappop(self.heap)
            out.append(self.request(c, t))
        return out

    def next_due(self) -> float | None:
        return self.heap[0][0] if self.heap else None

    def finished(self, req: Req, now: float) -> None:
        heapq.heappush(self.heap, (now, req.client))


def make(traffic: dict, *, seed: int, vocab: int, seconds: float):
    return ClosedLoop(traffic, seed=seed, vocab=vocab, seconds=seconds)
