"""The measured window: the traffic loop submits through `Engine.submit`
and steps the synchronous `Engine.step()`; each token is stamped on the
host as the scheduler's `token_sink` delivers it."""
from __future__ import annotations

import time

from hadbench.stats import Record

DRAIN_S = 60.0      # how long past the close a sent request may wait


def busy(eng) -> bool:
    return bool(eng.queue) or any(s.request is not None for s in eng.slots)


def serve(eng, loop, seconds: float, *, tracer=None,
          clock=time.perf_counter) -> tuple[list[Record], float, float]:
    """Run the window of `seconds` from now, then step on (sending nothing
    more) until every request sent inside it has its first token or
    DRAIN_S have passed. Returns the records and the window's bounds."""
    records: dict[int, Record] = {}
    open_loop = loop.KIND == "open"

    def sink(rid: int, tok: int) -> None:
        rec = records.get(rid)
        if rec is not None:
            rec.stamps.append(clock())
            rec.tokens.append(int(tok))

    eng.scheduler.token_sink = sink
    t0 = clock()
    t1 = t0 + seconds
    loop.start(t0)

    def step(in_window: bool) -> None:
        fin = (eng.step() if tracer is None
               else tracer.step(eng, clock() - t0, in_window))
        now = clock()
        for f in fin:
            rec = records.get(f.request_id)
            if rec is not None:
                rec.finished = True
                if in_window:
                    loop.finished(rec, now)

    while True:
        now = clock()
        if now >= t1:
            break
        for req in loop.due(now):
            sent = clock()
            rid = eng.submit(req.tokens, req.max_new)
            records[rid] = Record(rid, req.client, req.tokens, sent,
                                  req.due if open_loop else sent)
        if busy(eng):
            step(True)
            continue
        nxt = loop.next_due()
        wait = (t1 if nxt is None else min(nxt, t1)) - clock()
        if wait > 0:
            time.sleep(wait)
    waiting = [r for r in records.values() if t0 <= r.sent < t1]
    while (any(not r.stamps for r in waiting) and busy(eng)
           and clock() < t1 + DRAIN_S):
        step(False)
    if tracer is not None:
        tracer.close()
    eng.scheduler.token_sink = None
    return sorted(records.values(), key=lambda r: r.rid), t0, t1
