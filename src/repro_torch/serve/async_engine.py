"""Asyncio serving front end over the pipelined engine (torch twin of
``repro.serve.async_engine``).

:class:`AsyncEngine` wraps an :class:`~repro_torch.serve.engine.Engine` and
drives its double-buffered `step_pipelined()` loop from an asyncio event
loop, adding the three things a network-facing server needs on top of the
batch API:

  * **async submission** — `await eng.submit(...)` returns an
    :class:`AsyncRequestHandle` immediately; the request is enqueued into
    the scheduler between steps (the engine never races its own worker).
  * **per-token streaming** — tokens land on each handle the step they
    are committed, via the scheduler's `token_sink` hook: consume them
    with `async for tok in handle` or a per-request `on_token` callback;
    `await handle.result()` waits for the full sequence.
  * **SLO-aware admission** — with `slo_ttft_s` set, submissions are
    refused (:class:`SLORejected`, counted in the `slo_rejected` stat)
    while the recent queue-time record says a new arrival would blow its
    time-to-first-token deadline anyway. Shedding at the door beats
    queueing work that is already dead on arrival — that is what keeps
    goodput (SLO-attaining throughput) from collapsing past saturation.

Threading model: each `step_pipelined()` runs in a worker thread via
`run_in_executor`, so the event loop stays responsive while the host
builds plans / syncs the device. Steps never overlap each other; the
scheduler is only ever touched from the worker during a step and from
the loop thread between steps. The token sink appends to plain per-
request buffers from the worker (GIL-atomic appends); the loop thread
drains them to the asyncio queues after each step, preserving order.

The loop thread makes no CUDA call: it touches only numpy, the host-side
scheduler and asyncio, and submissions stay on the host until the
worker's next step. Every device call, the CUDA graph captures of the
runner's first prefill chunk and decode step included, runs in the
worker. That matters because a capture runs in the "global" error mode,
where a CUDA call from another thread fails it.
"""
from __future__ import annotations

import asyncio
import collections
from typing import Any, Callable

import numpy as np

from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import SamplingParams
from repro_torch.serve.telemetry import RequestMetrics

__all__ = ["AsyncEngine", "AsyncRequestHandle", "SLORejected"]

_DONE = object()                       # stream sentinel


class SLORejected(RuntimeError):
    """Raised by `AsyncEngine.submit` when SLO-aware admission control
    predicts the request would miss its TTFT deadline in queue."""


class AsyncRequestHandle:
    """One submitted request's streaming view: an async iterator of
    tokens plus an awaitable final result."""

    def __init__(self, on_token: Callable[[int], None] | None = None):
        self.request_id: int = -1
        self._on_token = on_token
        self._q: asyncio.Queue = asyncio.Queue()
        self._done: asyncio.Future = (
            asyncio.get_running_loop().create_future())

    # -- producer side (AsyncEngine, loop thread) ----------------------
    def _push(self, tok: int) -> None:
        if self._on_token is not None:
            self._on_token(tok)
        self._q.put_nowait(tok)

    def _finish(self, tokens: np.ndarray) -> None:
        self._q.put_nowait(_DONE)
        if not self._done.done():
            self._done.set_result(tokens)

    # -- consumer side --------------------------------------------------
    def __aiter__(self):
        return self

    async def __anext__(self) -> int:
        tok = await self._q.get()
        if tok is _DONE:
            raise StopAsyncIteration
        return tok

    async def result(self) -> np.ndarray:
        """The full generated sequence (including eos if hit)."""
        return await self._done


class AsyncEngine:
    """Asyncio request front end driving one engine's pipelined loop."""

    def __init__(self, engine: Engine, *, slo_ttft_s: float | None = None,
                 queue_window: int = 32):
        self.engine = engine
        self.slo_ttft_s = slo_ttft_s
        # recent queue-time samples (seconds) feeding the admission gate;
        # populated from RequestMetrics as requests finish
        self._queue_times: collections.deque = collections.deque(
            maxlen=queue_window)
        self.finished_metrics: list[RequestMetrics] = []
        self._handles: dict[int, AsyncRequestHandle] = {}
        # worker-thread -> loop-thread token relay (per-request FIFO)
        self._token_buf: dict[int, collections.deque] = {}
        self._pending: list[tuple[AsyncRequestHandle, tuple, dict]] = []
        self._wake = asyncio.Event()
        self._stopping = False
        self.results: dict[int, np.ndarray] = {}
        engine.scheduler.token_sink = self._sink

    # -- token relay (called from the stepping worker thread) -----------
    def _sink(self, request_id: int, tok: int) -> None:
        self._token_buf.setdefault(
            request_id, collections.deque()).append(tok)

    # -- submission ------------------------------------------------------
    def queue_delay_estimate(self) -> float:
        """Predicted queue wait for a new arrival: the mean of the recent
        queue-time record (0 with no history — admission is optimistic
        until the record says otherwise)."""
        if not self._queue_times:
            return 0.0
        return sum(self._queue_times) / len(self._queue_times)

    async def submit(self, tokens: np.ndarray, max_new_tokens: int = 16, *,
                     eos_token: int | None = None,
                     sampling: SamplingParams | None = None,
                     extra: dict | None = None, priority: str = "batch",
                     on_token: Callable[[int], None] | None = None
                     ) -> AsyncRequestHandle:
        """Enqueue a request (`extra`: per-request model inputs, as
        `Engine.submit`); returns its streaming handle. Raises
        :class:`SLORejected` when the admission gate predicts the TTFT
        deadline is already lost in queue."""
        if (self.slo_ttft_s is not None
                and self.queue_delay_estimate() > self.slo_ttft_s):
            self.engine.stats["slo_rejected"] += 1
            raise SLORejected(
                f"predicted queue delay {self.queue_delay_estimate():.3f}s "
                f"exceeds the {self.slo_ttft_s:.3f}s TTFT deadline")
        handle = AsyncRequestHandle(on_token)
        self._pending.append((handle, (tokens, max_new_tokens),
                              dict(eos_token=eos_token, sampling=sampling,
                                   extra=extra, priority=priority)))
        self._wake.set()
        return handle

    def stop(self) -> None:
        """Let `run()` return once all accepted work has drained."""
        self._stopping = True
        self._wake.set()

    # -- the serving loop ------------------------------------------------
    def _drain_submissions(self) -> None:
        for handle, args, kw in self._pending:
            handle.request_id = self.engine.submit(*args, **kw)
            self._handles[handle.request_id] = handle
        self._pending.clear()

    def _drain_tokens(self) -> None:
        for rid, buf in self._token_buf.items():
            handle = self._handles.get(rid)
            while buf:
                tok = buf.popleft()
                if handle is not None:
                    handle._push(tok)

    def _busy(self) -> bool:
        eng = self.engine
        return bool(self._pending or eng.queue or eng._inflight is not None
                    or any(s.request is not None for s in eng.slots))

    async def run(self) -> dict[int, np.ndarray]:
        """Serve until `stop()` AND all accepted work has drained. Steps
        execute in a worker thread so submissions/consumers stay live
        mid-step; returns request_id -> generated tokens (also kept in
        `self.results`)."""
        loop = asyncio.get_running_loop()
        while True:
            self._drain_submissions()
            if not self._busy():
                if self._stopping:
                    break
                await self._wake.wait()
                self._wake.clear()
                continue
            finished = await loop.run_in_executor(
                None, self.engine.step_pipelined)
            self._drain_tokens()
            for fr in finished:
                self.results[fr.request_id] = fr.tokens
                handle = self._handles.pop(fr.request_id, None)
                self._token_buf.pop(fr.request_id, None)
                if handle is not None:
                    handle._finish(fr.tokens)
            for m in self.engine.pop_finished_metrics():
                self.finished_metrics.append(m)
                if m.queue_time is not None:
                    self._queue_times.append(m.queue_time)
        for fr in self.engine.scheduler._drain_finished():
            self.results[fr.request_id] = fr.tokens
        return self.results
