"""Replay: `clients` closed-loop clients walking one fixed schedule of
(prompt tokens, output tokens) pairs, each sending its next request the
moment the last one finished (no think time).

Traffic keys: ``schedule`` ([[prompt, output], ...], cycled);
``start_entry`` (each client's first entry); ``first_due_s`` (each
client's first send, seconds into the window). Every seed sends the same
lengths in the same order at the same first times; the seed draws the
token ids alone (uniform over the vocabulary), so the work of a run does
not move with its seed.
"""
from __future__ import annotations

import heapq

from hadbench.loops import Req, rng, tokens
from hadbench.loops.closed import ClosedLoop

KIND = "replay"


class ReplayLoop(ClosedLoop):
    KIND = KIND

    def __init__(self, traffic: dict, *, seed: int, vocab: int,
                 seconds: float):
        self.seed, self.vocab = seed, vocab
        self.schedule = [(int(p), int(o)) for p, o in traffic["schedule"]]
        self.clients = int(traffic["clients"])
        self.first = [int(e) for e in traffic["start_entry"]]
        self.first_due = [float(t) for t in traffic["first_due_s"]]
        self.sent = [0] * self.clients
        self.heap: list[tuple[float, int]] = []

    def request(self, c: int, due: float) -> Req:
        """Client c's next request: the schedule's next entry for it."""
        r = self.sent[c]
        self.sent[c] += 1
        plen, out = self.schedule[(self.first[c] + r) % len(self.schedule)]
        return Req(client=c, tokens=tokens(rng(self.seed, 13, c, r), plen,
                                           self.vocab),
                   max_new=out, due=due)

    def setup_prompts(self) -> list:
        return []

    def start(self, t0: float) -> None:
        self.heap = [(t0 + t, c) for c, t in enumerate(self.first_due)]
        heapq.heapify(self.heap)


def make(traffic: dict, *, seed: int, vocab: int, seconds: float):
    return ReplayLoop(traffic, seed=seed, vocab=vocab, seconds=seconds)
