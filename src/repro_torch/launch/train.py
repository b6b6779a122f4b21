"""Training launcher for the PyTorch port: HAD distillation (or CE
pretrain) of seeded weights on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --reduced --steps 10 --steps-per-stage 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --reduced --device cpu          # no HAD attention: CE pretrain
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 100 --seq 512 --ckpt-dir ck   # on the GPU (the default)

The JAX launcher's flags (the mode is distill where HAD applies, else
pretrain; distillation follows `tiny_schedule(--steps-per-stage)`,
pretraining a constant 3e-4; --attn-dtype bf16 runs the distill
attention's logit blocks in bfloat16), plus --device: the card unless it
asks for the CPU; without a card the default raises (no fallback). Data is the
order-2 Markov `lm_stream` from --seed. With --ckpt-dir the loop saves
every --ckpt-every steps and resumes from the latest checkpoint. The
summary line names the stages the distill steps ran (tiny_schedule(2)
ends stage 3 at step 8, so --steps 10 runs all four).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.distill import DistillConfig, tiny_schedule
from repro_torch.data import lm_stream, shard_batches
from repro_torch.distributed.compression import CompressionConfig
from repro_torch.models import model as M
from repro_torch.optim import adam, schedules
from repro_torch.serve.runner import resolve_device
from repro_torch.train import (ATTN_DTYPES, LoopConfig, StepConfig,
                               build_distill_step, build_pretrain_step,
                               init_distill_state, init_pretrain_state, run)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale reduced config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "distill", "pretrain"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps-per-stage", type=int, default=25)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "onebit", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn-dtype", default="f32",
                    choices=list(ATTN_DTYPES),
                    help="dtype of the distill attention's logit blocks")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    mode = args.mode
    if mode == "auto":
        mode = ("distill" if cfg.had.enabled and cfg.has_attention
                else "pretrain")
    print(f"arch={cfg.name} mode={mode} params~{M.param_count(cfg):,} "
          f"device={device}")

    opt_cfg = adam.AdamWConfig()
    step_cfg = StepConfig(
        grad_accum=args.grad_accum,
        compression=CompressionConfig(method=args.compression))
    gen = torch.Generator().manual_seed(args.seed)
    if mode == "distill":
        dcfg = DistillConfig(schedule=tiny_schedule(args.steps_per_stage))
        state = init_distill_state(cfg, opt_cfg, step_cfg, generator=gen,
                                   device=device)
        step_fn = build_distill_step(cfg, dcfg, opt_cfg, step_cfg,
                                     attn_dtype=ATTN_DTYPES[args.attn_dtype])
        max_steps = min(args.steps, dcfg.total_steps)
    else:
        state = init_pretrain_state(cfg, opt_cfg, step_cfg, generator=gen,
                                    device=device)
        step_fn = build_pretrain_step(cfg, opt_cfg, schedules.constant(3e-4),
                                      step_cfg)
        max_steps = args.steps

    stages: list[int] = []           # the stage of every distill step

    def step_and_note(state, batch):
        state, metrics = step_fn(state, batch)
        if "stage" in metrics:
            stages.append(int(metrics["stage"]))
        return state, metrics

    data = shard_batches(
        lm_stream(vocab=cfg.vocab_size, batch=args.batch, seq=args.seq,
                  seed=args.seed), device)
    res = run(step_and_note, state, data,
              LoopConfig(max_steps=max_steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, log_every=10,
                         log_path=args.log))
    last = res.metrics_history[-1] if res.metrics_history else {}
    print(f"done: step={max_steps} metrics="
          f"{ {k: round(v, 4) for k, v in last.items()} } "
          f"stragglers={res.straggler_events} "
          f"resumed_from={res.resumed_from}"
          + (f" stages={sorted(set(stages))}" if stages else ""))
    return res


if __name__ == "__main__":
    main()
