"""Continuous-batching serving engine (torch twin of ``repro.serve.engine``).

A thin facade over the scheduler/runner split:

  * `Scheduler` (copied verbatim from the JAX package) is pure host-side
    policy -- queue, slots, BlockAllocator / PrefixCache / SwapPool
    bookkeeping, admission, the prefill budget, victim selection -- and
    emits a frozen `SchedulePlan`.
  * `ModelRunner` executes the plan on the device and returns the
    sampled tokens.
  * `Engine.step()` is exactly `commit(plan, execute(schedule()))`;
    `step_pipelined()` is the double-buffered form, which builds plan N+1
    while step N runs on the device.

The port serves the binary path and the full-precision baseline
(`ServeConfig(binary=False)`) over the paged cache (with recompute or
swap-out preemption, `swap_pages`, `prefix_cache` and page-sparse decode,
`page_topn`) or the dense cache (`paged=False`), stepped synchronously,
pipelined, or from asyncio (`serve/async_engine.py`), for decoders with
self-attention, cross-attention and SSM (Mamba2) layers and dense or MoE
FFNs: a request's image embeddings ride in
`submit(..., extra={"image_embeds": [1, T_img, frontend_dim]})`, its
prompt frames (a model with a frontend) in `extra={"frames": [1, S,
frontend_dim]}`, and a paged engine keeps the cross caches and the SSM
state in a pooled state allocation (`statepool`). An encoder is refused
(ValueError: encoder-only, no decode loop) when the engine builds its
runner.
The engine runs on the card unless the caller asks for the CPU, each step
as a CUDA graph replay unless it asks for the eager step (`eager=True`).

Tensor-parallel serving (`ServeConfig(mesh=launch.mesh.make_host_mesh(
model=N))`, N ranks of one ``torch.distributed`` process group) is SPMD:
every rank builds the same Engine over the same full model. The mesh's
first rank drives it as usual (its Scheduler plans and its runner samples);
every other rank calls `serve_worker()`, which makes each call the first
rank's runner sends it (the frozen plan of every step, with the `extra`
arrays its prefill chunks read) until the first rank's `close()`. One
scheduler, so arrival order (wall time, under AsyncEngine) never splits
the ranks. On the card it runs the eager step (`eager=True`; see
``serve/runner.py``).

The low-level `prefill()` / `decode()` methods remain for lockstep use
(uniform-length batches driven by hand) and for tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.serve.paged import BlockAllocator, PrefixCache, SwapPool
from repro_torch.serve.runner import ModelRunner
from repro_torch.serve.scheduler import (FinishedRequest, Request,
                                         SamplingParams, SchedulePlan,
                                         Scheduler, ServeConfig)
from repro_torch.serve.runner import _chunk_extra
from repro_torch.serve.statepool import StatePool
from repro_torch.serve.telemetry import RequestMetrics, Telemetry, span
from repro_torch.serve.validate import state_layer_positions

__all__ = ["Engine", "FinishedRequest", "Request", "RequestMetrics",
           "SamplingParams", "ServeConfig", "Telemetry"]


@dataclasses.dataclass
class _Inflight:
    """One dispatched-but-uncommitted pipelined step: the resolved plan,
    the runner's pending handle, and the host timestamps needed to stamp
    its flight-recorder event once it lands."""
    plan: SchedulePlan
    pending: Any
    launch_ts: float                   # execute_async dispatch time
    sched_s: float                     # host time spent building the plan
    structural_s: float                # host time of commit_structural


class Engine:
    def __init__(self, cfg: ModelConfig, model: Transformer,
                 scfg: ServeConfig, telemetry: Telemetry | None = None, *,
                 device="cuda", eager: bool = False):
        self.cfg = cfg
        self.scfg = scfg
        self.telemetry = telemetry
        state_layers = (len(state_layer_positions(cfg.layer_pattern))
                        if scfg.paged else 0)
        self.scheduler = Scheduler(
            scfg, stats=(telemetry.registry if telemetry else None),
            state_layers=state_layers)
        self.scheduler.telemetry = telemetry
        self.runner = ModelRunner(cfg, model, scfg,
                                  stats=self.scheduler.stats, device=device,
                                  eager=eager)
        self.runner.telemetry = telemetry
        self.n = self.runner.n
        self.chunk = self.scheduler.chunk
        # the double buffer: at most ONE dispatched-but-uncommitted step
        self._inflight: _Inflight | None = None
        # pipelined-mode overlap accounting (seconds): how much host
        # schedule time was hidden under the previous step's device window
        self._pipe = {"overlap": 0.0, "schedule": 0.0, "steps": 0}

    # ------------------------------------------------------------------
    # facade: shared state lives on the scheduler (host) / runner (device)
    # ------------------------------------------------------------------
    @property
    def stats(self) -> dict:
        return self.scheduler.stats

    def serve_worker(self) -> int:
        """Tensor-parallel serving, on a rank other than the mesh's first:
        follow the first rank's runner until its `close()`; returns the
        calls made."""
        return self.runner.serve_worker()

    def close(self) -> None:
        """Tensor-parallel serving, on the mesh's first rank: release the
        other ranks' `serve_worker()`. A no-op without a mesh."""
        self.runner.close()

    @property
    def slots(self):
        return self.scheduler.slots

    @property
    def queue(self):
        return self.scheduler.queue

    @property
    def allocator(self) -> BlockAllocator | None:
        return self.scheduler.allocator

    @property
    def prefix(self) -> PrefixCache | None:
        return self.scheduler.prefix

    @property
    def swap(self) -> SwapPool | None:
        return self.scheduler.swap

    @property
    def statepool(self) -> StatePool | None:
        """The pooled state entries' accounting (a paged engine of a model
        with SSM or cross layers), else None."""
        return self.scheduler.statepool

    @property
    def block_tables(self):
        return self.scheduler.block_tables

    @property
    def state_tables(self):
        return self.scheduler.state_tables

    @property
    def max_blocks(self) -> int:
        return self.scheduler.max_blocks

    @property
    def page(self) -> int:
        return self.scheduler.page

    @property
    def caches(self) -> list[dict]:
        """The runner's caches, one dict of tensors per layer. Read-only
        here, unlike the JAX Engine's: the captured graphs hold these
        tensors' addresses, so they are written in place (see
        `runner.reset_caches`), never replaced."""
        return self.runner.caches

    # ------------------------------------------------------------------
    # scheduler API
    # ------------------------------------------------------------------
    def submit(self, tokens: np.ndarray | Request, max_new_tokens: int = 16,
               *, eos_token: int | None = None,
               sampling: SamplingParams | None = None,
               extra: dict | None = None, priority: str = "batch") -> int:
        """Enqueue a request; returns its request_id. Admission happens at
        the next `step()` with a free slot. `extra` holds per-request model
        inputs with a batch dimension of 1, e.g. {"image_embeds":
        [1, n_image_tokens, frontend_dim]} for a model with cross
        layers."""
        return self.scheduler.submit(tokens, max_new_tokens,
                                     eos_token=eos_token, sampling=sampling,
                                     extra=extra, priority=priority)

    def step(self) -> list[FinishedRequest]:
        """One synchronous scheduler step; returns newly finished requests
        (any in-flight pipelined step is landed first, so mixing the two
        stepping APIs never reorders commits).

        With telemetry attached, each phase is a span timed on the host,
        the step's region times are read after the commit, and the plan is
        recorded as one flight-recorder step event, stamped at the
        commit's end; `Telemetry(fence=True)` synchronizes the device
        before the execute->commit stamp so execute time is device
        time."""
        finished = self.flush()
        tel = self.telemetry
        if tel is None:
            plan = self.scheduler.schedule()
            results = self.runner.execute(plan)
            return finished + self.scheduler.commit(plan, results)
        with tel.span("engine.step"):
            with tel.span("scheduler.schedule") as sched:
                plan = self.scheduler.schedule()
            with tel.span("runner.execute") as execute:
                self._on_chunks(plan, execute[1])
                results = self.runner.execute(plan)
                if tel.fence:
                    self.runner.sync()
            with tel.span("scheduler.commit") as commit:
                finished += self.scheduler.commit(plan, results)
            with tel.span("telemetry.read"):
                device_ms = self.runner.region_ms()
        tel.record_step(plan, timings={"schedule": sched[2] - sched[1],
                                       "execute": execute[2] - sched[2],
                                       "commit": commit[2] - execute[2],
                                       "fenced": tel.fence},
                        pool=self.scheduler.watermarks(), ts=commit[2],
                        device_ms=device_ms)
        return finished

    def _on_chunks(self, plan: SchedulePlan, ts: float) -> None:
        """Stamp the plan's prefill chunks on the hub at the start (`ts`)
        of the ``runner.execute`` span that runs them."""
        for ch in plan.prefill:
            self.telemetry.on_chunk(ch.request.request_id, ts)

    # ------------------------------------------------------------------
    # pipelined stepping (double-buffered schedule/execute overlap)
    # ------------------------------------------------------------------
    def _clock(self):
        return self.telemetry.clock if self.telemetry else time.perf_counter

    def step_pipelined(self) -> list[FinishedRequest]:
        """One double-buffered step: build plan N+1 while step N is still
        on the device, then land step N (`runner.wait`), token-commit it,
        rebind plan N+1's stale decode inputs (`resolve_plan`), dispatch
        it (`execute_async`) and apply its structural commit. Tokens are
        bit-identical to `step()`'s; scheduling policy may differ
        (admissions and preemptions see token effects a step later).
        Returns the requests finished by the step that landed."""
        clock = self._clock()
        tel = self.telemetry
        t0 = clock()
        with span(tel, "scheduler.schedule"):
            plan = self.scheduler.schedule()
        t1 = clock()
        self._pipe["schedule"] += t1 - t0
        finished = (self._complete_inflight((t0, t1))
                    if self._inflight is not None else [])
        if not (plan.admissions or plan.swap_ins or plan.reclaims
                or plan.prefill or plan.decode):
            return finished            # nothing to dispatch: don't track
        with span(tel, "engine.launch"):
            plan = self.scheduler.resolve_plan(plan)
            launch = clock()
            with span(tel, "runner.execute") as execute:
                if tel is not None:
                    self._on_chunks(plan, execute[1])
                pending = self.runner.execute_async(plan)
            s0 = clock()
            with span(tel, "scheduler.commit"):
                self.scheduler.commit_structural(plan)
            s1 = clock()
        self._inflight = _Inflight(plan, pending, launch, t1 - t0, s1 - s0)
        self._pipe["steps"] += 1
        self.stats["pipelined_steps"] += 1
        return finished

    def _complete_inflight(self, overlap_interval: tuple[float, float]
                           | None = None) -> list[FinishedRequest]:
        """Land the in-flight step: host-sync its sampled tokens, token-
        commit them, and stamp its flight-recorder event. The event's
        `overlap` is how much of the given host interval (the NEXT plan's
        schedule phase) fell inside this step's device window
        [dispatch, wait-end]."""
        inflight = self._inflight
        self._inflight = None
        tel = self.telemetry
        with span(tel, "engine.land"):
            results = self.runner.wait(inflight.pending)
            clock = self._clock()
            t2 = clock()
            with span(tel, "scheduler.commit"):
                finished = self.scheduler.commit_tokens(inflight.plan,
                                                        results)
            t3 = clock()
        execute_s = t2 - inflight.launch_ts
        overlap = 0.0
        if overlap_interval is not None:
            o0, o1 = overlap_interval
            overlap = max(0.0, min(o1, t2) - max(o0, inflight.launch_ts))
        self._pipe["overlap"] += overlap
        if tel is not None:
            with tel.span("telemetry.read"):
                device_ms = self.runner.region_ms()
            tel.record_step(
                inflight.plan,
                timings={"schedule": inflight.sched_s,
                         "execute": execute_s,
                         "commit": inflight.structural_s + (t3 - t2),
                         "fenced": False,
                         "overlap": overlap,
                         "pipelined": True},
                pool=self.scheduler.watermarks(), device_ms=device_ms)
        return finished

    def flush(self) -> list[FinishedRequest]:
        """Land any in-flight pipelined step (no-op when none). Called on
        entry to every synchronous `step()`."""
        if self._inflight is None:
            return []
        return self._complete_inflight()

    def overlap_stats(self) -> dict:
        """Pipelined-overlap accounting: seconds of host schedule time in
        total and hidden under device windows, and their ratio."""
        s = self._pipe
        frac = (s["overlap"] / s["schedule"]) if s["schedule"] > 0 else 0.0
        return {"schedule_s": s["schedule"], "overlap_s": s["overlap"],
                "pipelined_steps": s["steps"], "overlap_frac": frac}

    def run(self) -> dict[int, np.ndarray]:
        """Step until queue and slots drain; returns request_id -> tokens."""
        out: dict[int, np.ndarray] = {}
        while self.queue or any(s.request is not None for s in self.slots):
            for fr in self.step():
                out[fr.request_id] = fr.tokens
        for fr in self.scheduler._drain_finished():
            out[fr.request_id] = fr.tokens
        return out

    def run_pipelined(self) -> dict[int, np.ndarray]:
        """`run()` over the double-buffered step: drains the queue, all
        slots AND the in-flight step; returns request_id -> tokens."""
        out: dict[int, np.ndarray] = {}
        while (self.queue or any(s.request is not None for s in self.slots)
               or self._inflight is not None):
            for fr in self.step_pipelined():
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
        """Run every pool invariant check (BlockAllocator / SwapPool
        accounting and slot <-> block-table cross-checks). On failure the
        flight recorder is dumped to the telemetry trace file, when one is
        configured."""
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

    def dump_trace(self, path: str | None = None, *,
                   requests=()) -> int:
        """Write the flight-recorder ring buffer as JSONL (meta header,
        buffered step events, live + undrained request records, and a
        check event from an auto-run `check()`). Records already drained
        via `pop_finished_metrics()` can be handed back through
        `requests` to appear in the dump. Returns the number of events
        written."""
        tel = self.telemetry
        if tel is None:
            raise RuntimeError("dump_trace requires an Engine telemetry "
                               "hub (Engine(..., telemetry=Telemetry()))")
        path = path if path is not None else tel.trace_file
        if path is None:
            raise RuntimeError("no trace path: pass one or set "
                               "Telemetry(trace_file=...)")
        ok, err = True, ""
        try:
            self.scheduler.check()
        except AssertionError as e:
            ok, err = False, str(e)
        extra = [m.to_event() for m in requests]
        extra += [m.to_event() for m in tel.live_requests]
        extra += [m.to_event() for m in tel._finished]
        extra.append({"kind": "check", "ts": tel.clock(), "ok": ok,
                      "error": err})
        n = tel.recorder.dump(path, extra_events=extra, clock=tel.clock)
        if not ok:
            raise AssertionError(err)
        return n

    def reset_stats(self) -> None:
        """Zero the counters and the pipelined-overlap accounting (e.g.
        after a warm-up pass); watermarks restart at current occupancy,
        and telemetry request records from before the reset are dropped."""
        self.scheduler.reset_stats()
        self._pipe = {"overlap": 0.0, "schedule": 0.0, "steps": 0}
        if self.telemetry is not None:
            self.telemetry.pop_finished()

    # ------------------------------------------------------------------
    # low-level lockstep API (uniform batches, hand-driven)
    # ------------------------------------------------------------------
    def prefill(self, tokens: np.ndarray,
                extra: dict | None = None) -> torch.Tensor:
        """Uniform-length batched prefill of ALL slots at once.

        tokens: [batch_slots, S]; extra: model inputs by row, e.g.
        {"image_embeds": [batch_slots, n_image_tokens, frontend_dim]}
        (first chunk only). Resets every slot (resident requests are
        dropped with their caches, sampling rngs and pending tokens) and
        raises if requests are still queued. Returns last-position logits
        [batch_slots, V], a copy: the step's own output is overwritten by
        the next step. Runs on the scheduler's prefill-chunk graph, one
        replay a slot a chunk."""
        if self.queue:
            raise RuntimeError(
                f"lockstep prefill() with {len(self.queue)} queued "
                f"request(s): it would silently orphan them — drain the "
                f"scheduler (run()) or don't mix the APIs")
        tokens = np.asarray(tokens, np.int32)
        b, s = tokens.shape
        if b != self.scfg.batch_slots:
            raise ValueError(f"prefill() takes one row per slot: {b} rows "
                             f"for {self.scfg.batch_slots} slots")
        self._inflight = None          # lockstep resets drop pending work
        self.scheduler.reset_for_lockstep()
        self.runner.reset_caches()
        if self.scfg.paged:
            for i in range(b):  # lockstep never preempts: all-or-error
                self.scheduler.lockstep_alloc(i, s)
        tables, states = self.block_tables, self.state_tables
        last = [None] * b
        for lo in range(0, s, self.chunk):
            hi = min(lo + self.chunk, s)
            extra_rows = _chunk_extra(extra, s, lo, hi, self.chunk)
            for i in range(b):
                logits = self.runner.prefill_step(
                    i, tokens[i, lo:hi], lo,
                    None if tables is None else tables[i],
                    -1 if states is None else int(states[i]),
                    {k: v[i:i + 1] for k, v in extra_rows.items()})
                if hi == s:
                    last[i] = logits[:, -1, :self.cfg.vocab_size].clone()
        for slot in self.slots:
            slot.length = s
            slot.prefill_pos = s
        if self.telemetry is not None:
            self.telemetry.drop_spans()    # no step event takes them
        return torch.cat(last)

    def decode(self, tokens: np.ndarray) -> torch.Tensor:
        """One ragged decode step for every slot. tokens: [batch_slots]
        int. Slots may sit at different positions (per-slot `pos`).
        Returns logits [batch_slots, V], a copy."""
        pos = np.array([s.length for s in self.slots], np.int32)
        if (pos >= self.scfg.max_len).any():
            raise ValueError(f"slot cache full (max_len={self.scfg.max_len})")
        b = self.scfg.batch_slots
        if self.scfg.paged:
            for i in range(b):  # lockstep never preempts: all-or-error
                self.scheduler.lockstep_alloc(i, int(pos[i]) + 1)
        logits = self.runner.decode_step(np.asarray(tokens, np.int32), pos,
                                         np.ones((b,), bool),
                                         self.block_tables,
                                         self.state_tables)
        for slot in self.slots:
            slot.length += 1
        if self.telemetry is not None:
            self.telemetry.drop_spans()    # no step event takes them
        return logits[:, 0, :self.cfg.vocab_size].clone()

    @property
    def lengths(self) -> np.ndarray:
        """Per-slot valid cache lengths, int32 (kernel dtype)."""
        return self.scheduler.lengths
