"""Quickstart on the PyTorch port: the HAD pipeline end to end (the twin
of ``examples/quickstart.py``, same sizes, schedule and seeds).

1. build a small dense GQA LM,
2. estimate sigma_Q/K (paper Eq. 12),
3. run a few steps of every distillation stage (Alg. 1),
4. serve the binarized student with the packed-bit K cache and compare
   against the full-precision baseline.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The card is the default (``--device cuda``; with no card it raises).
Weights come from ``torch.Generator`` seeds, so the numbers differ from
the JAX example's; `main`'s steps are functions that take the config and
the weights, so a caller can pass JAX's weights converted with
``repro_torch.checkpoint.params_from_numpy``.
"""
from __future__ import annotations

import argparse
from typing import Callable

import numpy as np
import torch

from repro_torch.core.distill import DistillConfig, tiny_schedule
from repro_torch.data import lm_stream, shard_batches
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.config import HADConfig, ModelConfig
from repro_torch.optim import adam
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.runner import resolve_device
from repro_torch.train import (build_distill_step, estimate_and_set_sigmas,
                               init_distill_state)

CFG = ModelConfig(
    name="quickstart", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    had=HADConfig(topn_frac=0.117, n_min=4),
    param_dtype="float32", q_block=32, remat=False)
STEPS_PER_STAGE, TOPN = 8, 6


def make_data(cfg: ModelConfig, device, *, batch: int = 4, seq: int = 32,
              seed: int = 0):
    """The example's token stream on `device`."""
    return shard_batches(lm_stream(vocab=cfg.vocab_size, batch=batch,
                                   seq=seq, seed=seed), device)


def estimate_sigmas(teacher: T.Transformer, cfg: ModelConfig, data, *,
                    n_batches: int = 5) -> float:
    """Eq. 12 on `n_batches` of `data`, written into `teacher`; returns
    layer 0's sigma_q."""
    estimate_and_set_sigmas(teacher, cfg, data, n_batches=n_batches)
    return float(teacher.blocks[0].mixer.sigma_q)


def distill(cfg: ModelConfig, teacher: T.Transformer, data, device, *,
            steps_per_stage: int = STEPS_PER_STAGE, topn: int = TOPN,
            log=print, on_step: Callable | None = None) -> T.Transformer:
    """The 4-stage recipe on `tiny_schedule(steps_per_stage)`; returns the
    merged student. `on_step(i, metrics, state)` is called after each
    step."""
    dcfg = DistillConfig(schedule=tiny_schedule(steps_per_stage),
                         lr_stages_123=1e-4)
    opt_cfg = adam.AdamWConfig()
    state = init_distill_state(cfg, opt_cfg, teacher=teacher, device=device)
    step = build_distill_step(cfg, dcfg, opt_cfg, topn=topn)
    for i in range(dcfg.total_steps):
        state, m = step(state, next(data))
        if on_step is not None:
            on_step(i, m, state)
        if i % 8 == 0 or i == dcfg.total_steps - 1:
            log(f"step {i:>3} stage={int(m['stage'])} c={float(m['c']):.3f} "
                f"att_kl={float(m['att_kl']):.4f} "
                f"out_kl={float(m['out_kl']):.4f}")
    return T.merge_student(cfg, state["teacher"], state["student"])


def serve(cfg: ModelConfig, student: T.Transformer, prompts: np.ndarray,
          device, *, gen: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Greedy tokens of the binarized (HAD) and full-precision serving
    paths over the same prompts."""
    def run(binary):
        eng = Engine(cfg, student, ServeConfig(max_len=32, batch_slots=2,
                                               binary=binary), device=device)
        return eng.generate(prompts, steps=gen)
    return run(True), run(False)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = CFG
    print(f"model: {cfg.name}, {M.param_count(cfg):,} params")
    data = make_data(cfg, device)

    # --- teacher + Eq. 12 sigma estimation -------------------------------
    teacher = T.init_params(cfg, torch.Generator().manual_seed(0),
                            device=device)
    sq = estimate_sigmas(teacher, cfg, data)
    print(f"sigma_q(layer 0) = {sq:.3f}")

    # --- 4-stage distillation (compressed schedule) -----------------------
    student = distill(cfg, teacher, data, device)

    # --- serve the binarized student --------------------------------------
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    toks_had, toks_fp = serve(cfg, student, prompts, device)
    agree = float((toks_had == toks_fp).mean())
    print(f"\nHAD tokens:\n{toks_had}\nfp tokens:\n{toks_fp}")
    print(f"greedy-token agreement binarized-vs-fp serving: {agree:.2f}")
    print("(the binary path stores K bit-packed: "
          f"{cfg.dh} dims -> {cfg.dh // 32 or 1} uint32 words/key)")
    return {"sigma_q": sq, "had": toks_had, "fp": toks_fp, "agree": agree}


if __name__ == "__main__":
    main()
