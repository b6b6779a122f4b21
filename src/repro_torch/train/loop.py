"""Fault-tolerant training loop (torch twin of ``repro.train.loop``).

  * checkpoint / restart: periodic atomic saves (the JAX state's layout,
    `steps.state_tree`); on (re)start the loop restores the latest
    checkpoint into the state and continues from its step, so a crash
    loses at most `ckpt_every` steps;
  * failure injection: `failure_hook(step)` may raise to simulate a crash
    (tests resume from it and compare bit for bit);
  * straggler mitigation: per-step wall time is tracked with an EWMA (the
    first step, which pays the warm-up, is skipped); steps slower than
    `straggler_factor` x EWMA are counted and flagged in their metrics;
  * metric logging to a JSONL file (restart-append safe).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Iterator


from repro_torch.checkpoint import CheckpointManager
from repro_torch.train.steps import load_state_tree, state_tree


@dataclasses.dataclass
class LoopConfig:
    max_steps: int
    ckpt_every: int = 100
    ckpt_dir: str | None = None
    keep: int = 3
    log_every: int = 10
    log_path: str | None = None
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1


@dataclasses.dataclass
class LoopResult:
    state: Any
    metrics_history: list
    straggler_events: int
    resumed_from: int | None


def run(step_fn: Callable, state: dict, data: Iterator, cfg: LoopConfig, *,
        failure_hook: Callable[[int], None] | None = None) -> LoopResult:
    mgr = (CheckpointManager(cfg.ckpt_dir, keep=cfg.keep) if cfg.ckpt_dir
           else None)
    resumed_from = None
    if mgr is not None and mgr.latest_step() is not None:
        step0, restored = mgr.restore({"state": state_tree(state)})
        load_state_tree(state, restored["state"])
        resumed_from = step0

    history: list = []
    ewma = None
    stragglers = 0
    warmup_done = False      # the first step warms up: not a straggler
    log_f = open(cfg.log_path, "a") if cfg.log_path else None

    for step in range(int(state["step"]), cfg.max_steps):
        if failure_hook is not None:
            failure_hook(step)
        batch = next(data)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])          # the host waits for the step
        dt = time.perf_counter() - t0

        if not warmup_done:
            warmup_done = True
        elif ewma is None:
            ewma = dt
        else:
            if dt > cfg.straggler_factor * ewma:
                stragglers += 1
                metrics = dict(metrics, straggler=1.0)
            ewma = (1 - cfg.ewma_alpha) * ewma + cfg.ewma_alpha * dt

        if step % cfg.log_every == 0 or step == cfg.max_steps - 1:
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(step=step, step_time_s=dt)
            history.append(rec)
            if log_f:
                log_f.write(json.dumps(rec) + "\n")
                log_f.flush()

        next_step = step + 1
        if mgr is not None and (next_step % cfg.ckpt_every == 0
                                or next_step == cfg.max_steps):
            mgr.save(next_step, {"state": state_tree(state)})

    if log_f:
        log_f.close()
    return LoopResult(state, history, stragglers, resumed_from)
