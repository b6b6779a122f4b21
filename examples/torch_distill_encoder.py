"""End-to-end on the PyTorch port: train an encoder classifier, then run
the full HAD distillation and report teacher vs student accuracy (the
twin of ``examples/distill_encoder.py``: same sizes, schedule and seeds).

The container-scale version of the paper's GLUE experiment: a
full-precision teacher is trained from scratch on a synthetic
order-sensitive classification task, sigmas are estimated (Eq. 12), the
4-stage recipe (Alg. 1) distills the binarized student, and both are
evaluated on held-out data.

Run:  PYTHONPATH=src python examples/torch_distill_encoder.py \\
          [--fast] [--device cpu]

The card is the default (``--device cuda``; with no card it raises).
The JAX example's helpers live in ``benchmarks/common.py``; this file
carries its own copy of what the "had" variant needs (`encoder_cfg`,
`class_logits`, `train_teacher`, `evaluate`, `distill_had`), built on the
port's train steps, forward, losses and AdamW. Each takes the config and
the weights, so a caller can pass JAX's weights converted with
``repro_torch.checkpoint.params_from_numpy``.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Iterator, NamedTuple

import torch

from repro_torch.core import losses
from repro_torch.core.distill import DistillConfig, tiny_schedule
from repro_torch.data import classification_task, to_device
from repro_torch.models import transformer as T
from repro_torch.models.config import HADConfig, ModelConfig
from repro_torch.optim import adam
from repro_torch.serve.runner import resolve_device
from repro_torch.train.steps import estimate_and_set_sigmas


def encoder_cfg(*, d=64, layers=2, heads=4, vocab=512, seq=64, frontend=0,
                name="bench") -> ModelConfig:
    return ModelConfig(
        name=name, family="encoder", n_layers=layers, d_model=d,
        n_heads=heads, n_kv_heads=heads, head_dim=max(d // heads, 16),
        d_ff=2 * d, vocab_size=vocab, causal=False,
        pos="learned", max_pos=seq, frontend_dim=frontend, act="gelu",
        had=HADConfig(n_min=4), param_dtype="float32", q_block=32,
        remat=False)


def class_logits(cfg: ModelConfig, model: T.Transformer, batch: dict, *,
                 mode: str = "std", att: dict | None = None) -> torch.Tensor:
    """The classifier's logits: the vocabulary logits at the CLS position
    (0 for an encoder, the last position otherwise)."""
    out = T.forward(model, batch, cfg=cfg, mode=mode, att=att)
    pos = 0 if cfg.is_encoder else -1
    return out.logits[:, pos, :cfg.vocab_size]


def _batch(tb, device) -> tuple[dict, torch.Tensor]:
    return (to_device(tb.inputs, device),
            torch.as_tensor(tb.labels, dtype=torch.int64, device=device))


def _trainable(tensors: dict) -> dict:
    for t in tensors.values():
        t.requires_grad_(True)
    return tensors


def _grads(loss: torch.Tensor, params: dict) -> dict:
    """d loss / d params by name; a tensor the loss does not reach gets a
    zero gradient, as under jax.grad."""
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), gs)}


def train_teacher(cfg: ModelConfig, task: Iterator, device, *, steps: int,
                  lr: float = 3e-4, seed: int = 0,
                  model: T.Transformer | None = None,
                  on_step: Callable | None = None) -> T.Transformer:
    """`steps` AdamW steps (grad clip 1.0) of cross entropy on the CLS
    logits, from seeded weights (or `model`). `on_step(i, loss, params)`
    is called after each update."""
    if model is None:
        model = T.init_params(cfg, torch.Generator().manual_seed(seed),
                              device=device)
    params = _trainable(T.named_tensors(model))
    opt_cfg = adam.AdamWConfig(grad_clip=1.0)
    opt = adam.init(params, opt_cfg)
    for i in range(steps):
        batch, labels = _batch(next(task), device)
        loss = losses.softmax_cross_entropy(
            class_logits(cfg, model, batch), labels)
        opt, _ = adam.update(_grads(loss, params), opt, params, lr=lr,
                             cfg=opt_cfg)
        if on_step is not None:
            on_step(i, loss, params)
    for t in params.values():
        t.requires_grad_(False)
    return model


@torch.no_grad()
def evaluate(cfg: ModelConfig, model: T.Transformer, task: Iterator, device,
             *, n_batches: int = 20, mode: str = "std",
             n: int | None = None) -> float:
    att = {"n": n} if n is not None else None
    correct = total = 0
    for _ in range(n_batches):
        tb = next(task)
        lg = class_logits(cfg, model, to_device(tb.inputs, device),
                          mode=mode, att=att)
        correct += int((lg.argmax(-1).cpu().numpy() == tb.labels).sum())
        total += len(tb.labels)
    return correct / total


class DistillResult(NamedTuple):
    model: T.Transformer
    accuracy: float
    train_time_s: float
    us_per_step: float


def distill_had(cfg: ModelConfig, teacher: T.Transformer, task: Iterator,
                device, *, topn: int, steps_per_stage: int = 40,
                eval_task: Iterator | None = None,
                eval_batches: int = 20,
                on_step: Callable | None = None) -> DistillResult:
    """The "had" column of ``benchmarks.common.distill_variant``: sigma
    estimation on five training minibatches, `tiny_schedule`'s four stages
    with the attention KL through stage 3, the merged student evaluated
    through ``had_eval``. `on_step(i, loss, student tensors)` is called
    after each update."""
    dcfg = DistillConfig(schedule=tiny_schedule(steps_per_stage),
                         lr_stages_123=1e-4, lr_stage_4=1e-5)
    opt_cfg = adam.AdamWConfig(grad_clip=dcfg.grad_clip)
    estimate_and_set_sigmas(
        teacher, cfg, (to_device(next(task).inputs, device)
                       for _ in range(5)), n_batches=5)
    student = T.student_subset(cfg, teacher)
    own = _trainable(T.student_tensors(cfg, student))
    opt = adam.init(own, opt_cfg)
    t0 = time.perf_counter()
    for i in range(dcfg.total_steps):
        batch, _ = _batch(next(task), device)
        att = {"n": topn, "sched": dcfg.schedule, "step": i}
        out = T.forward_distill(teacher, student, batch, cfg=cfg, att=att)
        lt = out.teacher_logits[:, 0 if cfg.is_encoder else -1,
                                :cfg.vocab_size]
        ls = out.student_logits[:, 0 if cfg.is_encoder else -1,
                                :cfg.vocab_size]
        loss = losses.combined_distill_loss(
            out.attention_kl, losses.output_kl(lt, ls),
            use_attention_loss=dcfg.use_attention_loss_at(i))
        opt, _ = adam.update(_grads(loss, own), opt, own, lr=dcfg.lr_at(i),
                             cfg=opt_cfg)
        if on_step is not None:
            on_step(i, loss, own)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    for t in own.values():
        t.requires_grad_(False)
    eff = T.merge_student(cfg, teacher, student)
    acc = evaluate(cfg, eff, eval_task or task, device, mode="had_eval",
                   n=topn, n_batches=eval_batches)
    return DistillResult(eff, acc, dt, dt / max(dcfg.total_steps, 1) * 1e6)


CFG = encoder_cfg(d=48, layers=2, heads=4, vocab=64, seq=32,
                  name="distill-encoder")
TOPN, EVAL_BATCHES = 6, 15


def task(seed: int) -> Iterator:
    """The example's task stream: seed 0 trains, seed 99 evaluates."""
    return classification_task(vocab=64, n_classes=4, batch=32, seq=32,
                               seed=seed)


def run(device, *, fast: bool = False, cfg: ModelConfig = CFG,
        teacher: T.Transformer | None = None,
        steps_teacher: int | None = None,
        steps_per_stage: int | None = None) -> dict:
    """The example: teacher training, distillation, both accuracies.
    `teacher` (untrained weights) replaces the seeded draw; the step
    counts default to the JAX example's (--fast: 150 and 10)."""
    steps_teacher = steps_teacher or (150 if fast else 400)
    sps = steps_per_stage or (10 if fast else 40)

    print("training full-precision teacher...")
    t0 = time.perf_counter()
    teacher = train_teacher(cfg, task(0), device, steps=steps_teacher,
                            lr=1e-3, model=teacher)
    teacher_s = time.perf_counter() - t0
    acc_t = evaluate(cfg, teacher, task(99), device, n_batches=EVAL_BATCHES)
    print(f"teacher accuracy: {acc_t:.3f}")

    print("distilling HAD student (4 stages: tanh -> tight tanh -> STE -> "
          "refine)...")
    res = distill_had(cfg, teacher, task(0), device, topn=TOPN,
                      steps_per_stage=sps, eval_task=task(99),
                      eval_batches=EVAL_BATCHES)
    print(f"HAD student accuracy: {res.accuracy:.3f} "
          f"(gap {acc_t - res.accuracy:+.3f}; paper's GLUE gap: 1.78 pts)")
    print(f"distillation: {res.train_time_s:.0f}s "
          f"({res.us_per_step / 1e3:.0f} ms/step on "
          f"{torch.device(device).type})")
    return {"teacher_acc": acc_t, "student_acc": res.accuracy,
            "teacher_s": teacher_s, "distill_s": res.train_time_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(resolve_device(args.device), fast=args.fast)


if __name__ == "__main__":
    main()
