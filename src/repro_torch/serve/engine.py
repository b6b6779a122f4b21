"""Continuous-batching serving engine (torch twin of ``repro.serve.engine``).

A thin facade over the scheduler/runner split:

  * `Scheduler` (copied verbatim from the JAX package) is pure host-side
    policy -- queue, slots, BlockAllocator / PrefixCache bookkeeping,
    admission, the prefill budget, victim selection -- and emits a
    frozen `SchedulePlan`.
  * `ModelRunner` executes the plan on the device and returns the
    sampled tokens.
  * `Engine.step()` is exactly `commit(plan, execute(schedule()))`.

This slice serves the binary path and the full-precision baseline
(`ServeConfig(binary=False)`) over the paged cache (with recompute
preemption, `prefix_cache` and page-sparse decode, `page_topn`) or the
dense cache (`paged=False`). Everything else raises NotImplementedError
when the engine builds its runner; see ROADMAP.md. The engine runs on the
card unless the caller asks for the CPU, each step as a CUDA graph replay
unless it asks for the eager step (`eager=True`).
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.serve.paged import BlockAllocator
from repro_torch.serve.runner import ModelRunner
from repro_torch.serve.scheduler import (FinishedRequest, Request,
                                         SamplingParams, Scheduler,
                                         ServeConfig)
from repro_torch.serve.telemetry import RequestMetrics, Telemetry

__all__ = ["Engine", "FinishedRequest", "Request", "RequestMetrics",
           "SamplingParams", "ServeConfig", "Telemetry"]


class Engine:
    def __init__(self, cfg: ModelConfig, model: Transformer,
                 scfg: ServeConfig, telemetry: Telemetry | None = None, *,
                 device="cuda", eager: bool = False):
        self.cfg = cfg
        self.scfg = scfg
        self.telemetry = telemetry
        self.scheduler = Scheduler(
            scfg, stats=(telemetry.registry if telemetry else None),
            state_layers=0)
        self.scheduler.telemetry = telemetry
        self.runner = ModelRunner(cfg, model, scfg,
                                  stats=self.scheduler.stats, device=device,
                                  eager=eager)
        self.runner.telemetry = telemetry
        self.n = self.runner.n

    # ------------------------------------------------------------------
    # facade: shared state lives on the scheduler (host) / runner (device)
    # ------------------------------------------------------------------
    @property
    def stats(self) -> dict:
        return self.scheduler.stats

    @property
    def slots(self):
        return self.scheduler.slots

    @property
    def queue(self):
        return self.scheduler.queue

    @property
    def allocator(self) -> BlockAllocator | None:
        return self.scheduler.allocator

    # ------------------------------------------------------------------
    # scheduler API
    # ------------------------------------------------------------------
    def submit(self, tokens: np.ndarray | Request, max_new_tokens: int = 16,
               *, eos_token: int | None = None,
               sampling: SamplingParams | None = None,
               priority: str = "batch") -> int:
        """Enqueue a request; returns its request_id. Admission happens at
        the next `step()` with a free slot."""
        return self.scheduler.submit(tokens, max_new_tokens,
                                     eos_token=eos_token, sampling=sampling,
                                     priority=priority)

    def step(self) -> list[FinishedRequest]:
        """One synchronous scheduler step; returns newly finished requests.

        With telemetry attached, each phase is timed on the host and the
        plan is recorded as one flight-recorder step event;
        `Telemetry(fence=True)` synchronizes the device before the
        execute->commit stamp so execute time is device time."""
        tel = self.telemetry
        if tel is None:
            plan = self.scheduler.schedule()
            return self.scheduler.commit(plan, self.runner.execute(plan))
        t0 = tel.clock()
        plan = self.scheduler.schedule()
        t1 = tel.clock()
        results = self.runner.execute(plan)
        if tel.fence:
            self.runner.sync()
        t2 = tel.clock()
        finished = self.scheduler.commit(plan, results)
        t3 = tel.clock()
        tel.record_step(plan, timings={"schedule": t1 - t0,
                                       "execute": t2 - t1,
                                       "commit": t3 - t2,
                                       "fenced": tel.fence},
                        pool=self.scheduler.watermarks())
        return finished

    def step_pipelined(self):
        raise NotImplementedError(
            "pipelined/async serving is not ported yet: see ROADMAP.md "
            "queue 1, 'Still to port'")

    def run(self) -> dict[int, np.ndarray]:
        """Step until queue and slots drain; returns request_id -> tokens."""
        out: dict[int, np.ndarray] = {}
        while self.queue or any(s.request is not None for s in self.slots):
            for fr in self.step():
                out[fr.request_id] = fr.tokens
        for fr in self.scheduler._drain_finished():
            out[fr.request_id] = fr.tokens
        return out

    def generate(self, prompts, steps: int) -> np.ndarray:
        """Greedy generation through the scheduler: prompts is [R, S] or a
        list of R 1-D prompts of any lengths. Returns [R, steps] tokens in
        submission order."""
        ids = [self.submit(np.asarray(p, np.int32), max_new_tokens=steps)
               for p in prompts]
        results = self.run()
        return np.stack([results[rid] for rid in ids], axis=0)

    def pop_finished_metrics(self) -> list[RequestMetrics]:
        """Drain the lifecycle records of requests finished since the last
        call (empty when telemetry is disabled)."""
        return (self.telemetry.pop_finished()
                if self.telemetry is not None else [])

    def check(self) -> None:
        """Run every pool invariant check (BlockAllocator accounting and
        slot <-> block-table cross-checks). On failure the flight recorder
        is dumped to the telemetry trace file, when one is configured."""
        try:
            self.scheduler.check()
        except Exception as e:
            tel = self.telemetry
            if tel is not None and tel.trace_file:
                tel.recorder.dump(
                    tel.trace_file, clock=tel.clock,
                    extra_events=[{"kind": "check", "ts": tel.clock(),
                                   "ok": False, "error": str(e)}],
                    note=f"invariant failure dump: {e}")
            raise
