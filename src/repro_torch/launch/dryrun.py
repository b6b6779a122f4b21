"""One-card dry run (torch twin of ``repro.launch.dryrun``): every
(arch x shape) cell of ``models.model.SHAPES`` on one H100.

The JAX dry run lowers and compiles each cell's real step under the
production mesh and reads XLA's memory and cost analyses. Here a cell is:

  1. a meta build (``torch.device("meta")``: modules without storage, no
     init run) of the step's arguments at the shape's global batch, their
     bytes by part: parameters, and for train cells the student's own
     tensors and AdamW state (the distill step when HAD applies, else the
     pretrain step), for serve cells the dense caches; and the inputs;
  2. the run batch: ``--batch``, or else the largest power of two up to
     the global batch whose arguments fit FIT_SHARE of the card's 80 GB.
     A cell whose arguments do not fit at its run batch (or, without
     ``--batch``, at batch 1) is "does_not_fit";
  3. one real eager step on the device, seeded weights drawn there: the
     distill (or pretrain) step in microbatches of 2 (``grad_accum``), or
     ``serve_step(logits_mode="last")`` over the whole prompt (prefill)
     or one token at pos = seq_len - 1 over seeded random cache contents
     (decode), as JAX lowers it. It runs twice: once under
     ``launch.op_cost.Counter`` (the step's flops and bytes; it also warms
     up the kernels and the allocator), then once timed on the host clock
     between two synchronizations; its output (the last logits, or the
     loss) must be finite.

The record holds JAX's keys where they mean the same (arch, shape, mesh,
status, reason, memory.per_device_total_gb, roofline, collectives,
model_flops, useful_flop_ratio, distill / grad_accum or binary / topn),
and run_batch, build_s, step_s, mfu = model_flops / (step_s *
PEAK_FLOPS) and hbm_share = bytes_hbm / (step_s * HBM_BW), model_flops
being of the run batch. A failing cell is an "error" record with its
traceback, and the exit code is then 1.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape decode_32k                      # one cell, on the card
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device meta
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --out out/dryrun                        # the full table
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --table out/dryrun [--mesh both]        # its records, in markdown

``--device cuda`` is the default and raises with no card; ``--device
meta`` stops after the fit check (no step, any machine); ``--device cpu``
runs the step with the kernels' plain versions (small configs only).

The production mesh (``--mesh single|multi|both``: 16x16 and 2x16x16, the
JAX dry run's meshes) prices each cell per chip without running it
(`run_mesh_cell`, ``launch.mesh_cost``): `mesh_prices` gives the
arguments exactly, from the sharding rules on the meta build, FSDP as
JAX's `use_fsdp` decides, and collective bytes from one formula per kind
at an H100 cluster's link rates (``--carry sp|dp``: JAX's carry
patterns); `mesh_terms` compute and HBM from the cell's step counted on
the meta device. Status ok /
does_not_fit as on one card, per chip. The record holds JAX's keys plus
``fsdp`` and ``carry``. The default, ``--mesh card``, is the one-card run
above, not JAX's "single": this port runs on one H100, and the card's
records (``chip_smoke.py`` phase 10) are measured there, while a mesh
record is priced. ``--attn-dtype bf16`` runs the distill attention's logit
blocks in bfloat16 (JAX's ``set_attn_compute_dtype``), in the card's step
and in the mesh count.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
      --device meta                           # 80 priced records
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.core.distill import DistillConfig
from repro_torch.launch import mesh_cost as MC
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adam
from repro_torch.serve.runner import resolve_device
from repro_torch.train import steps as TS
from repro_torch.train.steps import ATTN_DTYPES

MESH = "1xH100"
FIT_SHARE = 0.75          # of RL.HBM_BYTES for the step's arguments
MICROBATCH = 2            # sequences per microbatch of a train step


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def opt_config(cfg: ModelConfig) -> adam.AdamWConfig:
    """JAX's choice: bf16 moments for attention-only students and models
    over 50 B parameters."""
    return adam.AdamWConfig(
        state_dtype="bfloat16" if cfg.trainable == "attention" or
        M.param_count(cfg) > 5e10 else "float32")


def default_grad_accum(batch: int) -> int:
    """Microbatches of MICROBATCH sequences (fewer when they do not divide
    the batch), as JAX's ``default_grad_accum`` on one data replica."""
    accum = max(batch // MICROBATCH, 1)
    while batch % accum:
        accum -= 1
    return accum


def is_distill(cfg: ModelConfig) -> bool:
    return bool(cfg.had.enabled and cfg.has_attention)


def train_state(cfg: ModelConfig, device, generator=None) -> dict:
    """The train step's state: on the meta device a storage-free build,
    else seeded weights drawn with `generator` on `device`."""
    teacher = (T.Transformer(cfg, device=device) if device.type == "meta"
               else T.init_params(cfg, generator, device=device))
    if is_distill(cfg):
        return TS.init_distill_state(cfg, opt_config(cfg), teacher=teacher,
                                     device=device)
    return TS.init_pretrain_state(cfg, opt_config(cfg), model=teacher,
                                  device=device)


def state_parts(cfg: ModelConfig, state: dict) -> dict:
    """Bytes of a train state by part: params (the teacher, or the
    pretrained model), student (its own tensors), opt (AdamW), step."""
    if "teacher" in state:
        params = T.named_tensors(state["teacher"])
        student = T.student_tensors(cfg, state["student"]).values()
    else:
        params, student = T.named_tensors(state["params"]), []
    opt = state["opt"]
    return {"params": _bytes(params.values()), "student": _bytes(student),
            "opt": _bytes(list(opt["mu"].values()) + list(opt["nu"].values())
                          + [opt["count"]]),
            "step": _bytes([state["step"]])}


def serve_caches(cfg: ModelConfig, batch: int, seq: int, device) -> list:
    return T.init_caches(cfg, paged=False, batch=batch, max_len=seq,
                         binary=is_distill(cfg), device=device)


def input_bytes(cfg: ModelConfig, shape: M.ShapeSpec, batch: int) -> int:
    return sum(torch.Size(s.shape).numel() * s.dtype.itemsize
               for s in M.input_specs(cfg, shape,
                                      batch_override=batch).values())


def argument_parts(cfg: ModelConfig, shape: M.ShapeSpec, batch: int,
                   state_bytes: dict | None = None) -> dict:
    """Bytes of the step's arguments at `batch`, by part, from a meta
    build (`state_bytes`: a train state's parts, which do not depend on
    the batch)."""
    meta = torch.device("meta")
    if shape.kind == "train":
        parts = dict(state_bytes if state_bytes is not None
                     else state_parts(cfg, train_state(cfg, meta)))
    else:
        parts = {"params": _bytes(T.named_tensors(
                     T.Transformer(cfg, device=meta)).values()),
                 "caches": _bytes(leaf for c in serve_caches(
                     cfg, batch, shape.seq_len, meta) for leaf in c.values())}
    parts["inputs"] = input_bytes(cfg, shape, batch)
    return parts


def fit_batch(cfg: ModelConfig, shape: M.ShapeSpec) -> tuple[int, dict]:
    """(run batch, argument parts at it): the largest power of two up to
    the global batch whose arguments fit FIT_SHARE of the card, or (0, the
    parts at batch 1) when none does."""
    limit = FIT_SHARE * RL.HBM_BYTES
    state_bytes = (state_parts(cfg, train_state(cfg, torch.device("meta")))
                   if shape.kind == "train" else None)
    b = 1 << (shape.global_batch.bit_length() - 1)
    while b >= 1:
        parts = argument_parts(cfg, shape, b, state_bytes)
        if sum(parts.values()) <= limit:
            return b, parts
        b //= 2
    return 0, argument_parts(cfg, shape, 1, state_bytes)


def _inputs(cfg: ModelConfig, shape: M.ShapeSpec, batch: int, device,
            gen: torch.Generator) -> dict:
    """Seeded inputs of the cell's specs: tokens and labels in the
    vocabulary, frames and image embeddings standard normal."""
    out = {}
    for name, spec in M.input_specs(cfg, shape,
                                    batch_override=batch).items():
        if spec.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, spec.shape,
                                      generator=gen, device=device,
                                      dtype=torch.int32)
        else:
            out[name] = torch.randn(spec.shape, generator=gen, device=device,
                                    dtype=torch.float32).to(spec.dtype)
    return out


def _fill_random(caches: list, gen: torch.Generator) -> None:
    """Seeded random cache contents in place: random bits in integer
    leaves (packed K), standard normal in float ones."""
    for cache in caches:
        for leaf in cache.values():
            if leaf.dtype == torch.int32:
                leaf.view(torch.uint8).random_(0, 256, generator=gen)
            else:
                leaf.normal_(generator=gen)


def _serve_runner(cfg, shape, batch, device, gen):
    """(step, extra): a thunk running one serve step of the cell."""
    binary = is_distill(cfg)
    n = cfg.had.topn(shape.seq_len) if binary else 0
    model = T.init_params(cfg, gen, device=device)
    caches = serve_caches(cfg, batch, shape.seq_len, device)
    inputs = _inputs(cfg, shape, batch, device, gen)
    if shape.kind == "decode":
        _fill_random(caches, gen)
        pos = shape.seq_len - 1
    else:
        pos = 0
    pos = torch.full((batch,), pos, dtype=torch.int32, device=device)
    tokens = inputs.get("tokens")
    if tokens is None:          # frames feed the chunk; tokens are unread
        tokens = torch.zeros(inputs["frames"].shape[:2], dtype=torch.int32,
                             device=device)

    def step():
        return T.serve_step(model, tokens, caches, pos=pos, n=n,
                            binary=binary, logits_mode="last",
                            image_embeds=inputs.get("image_embeds"),
                            frames=inputs.get("frames"))
    return step, {"binary": binary, "topn": n}


def _step_fn(cfg, shape, accum, threshold_method, attn_dtype):
    step_cfg = TS.StepConfig(grad_accum=accum)
    if is_distill(cfg):
        return TS.build_distill_step(
            cfg, DistillConfig(), opt_config(cfg), step_cfg,
            topn=cfg.had.topn(shape.seq_len),
            threshold_method=threshold_method, attn_dtype=attn_dtype)
    return TS.build_pretrain_step(cfg, opt_config(cfg), lambda s: 1e-5,
                                  step_cfg)


def _train_runner(cfg, shape, batch, device, gen, threshold_method,
                  attn_dtype):
    distill = is_distill(cfg)
    accum = default_grad_accum(batch)
    state = {"now": train_state(cfg, device, gen)}
    step_fn = _step_fn(cfg, shape, accum, threshold_method, attn_dtype)
    inputs = _inputs(cfg, shape, batch, device, gen)

    def step():
        state["now"], metrics = step_fn(state["now"], inputs)
        return metrics["loss"]
    return step, {"distill": distill, "grad_accum": accum}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(arch: str, shape_name: str, *, device="cuda",
             batch: int | None = None, shape: M.ShapeSpec | None = None,
             cfg: ModelConfig | None = None, q_block: int | None = None,
             threshold_method: str | None = None,
             attn_dtype: torch.dtype = torch.float32) -> dict:
    """One (arch, shape) cell's record (see the module docstring).
    `shape` / `cfg` override the registry's (tests run reduced configs at
    tiny shapes)."""
    if cfg is None:
        cfg = (get_config(arch, q_block=q_block) if q_block
               else get_config(arch))
    shape = M.SHAPES[shape_name] if shape is None else shape
    device = resolve_device(device)
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH,
           "device": device.type}
    ok, why = M.shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        fit, parts = fit_batch(cfg, shape)
        run_batch = batch or fit
        if batch and batch != fit:
            parts = argument_parts(cfg, shape, batch)
        args = sum(parts.values())
        mem = {"argument_size_in_bytes": args, "arguments": parts,
               "per_device_total_gb": round(args / 2**30, 3)}
        rec.update(run_batch=run_batch, fit_batch=fit, memory=mem,
                   collectives={})
        if run_batch == 0 or args > FIT_SHARE * RL.HBM_BYTES:
            rec.update(status="does_not_fit", reason=(
                f"the arguments need {args / 1e9:.1f} GB at batch "
                f"{max(run_batch, 1)}, over {FIT_SHARE:.0%} of "
                f"{RL.HBM_BYTES / 1e9:.0f} GB"))
            return rec
        if device.type == "meta":
            rec.update(status="ok")
            return rec
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        gen = torch.Generator(device=device).manual_seed(0)
        t0 = time.perf_counter()
        if shape.kind == "train":
            step, extra = _train_runner(cfg, shape, run_batch, device, gen,
                                        threshold_method, attn_dtype)
        else:
            step, extra = _serve_runner(cfg, shape, run_batch, device, gen)
        _sync(device)
        build_s = time.perf_counter() - t0
        with op_cost.Counter() as counter:
            step()
        _sync(device)
        t0 = time.perf_counter()
        out = step()
        _sync(device)
        step_s = time.perf_counter() - t0
        if not bool(torch.isfinite(out).all()):
            raise FloatingPointError(f"the step's {tuple(out.shape)} "
                                     f"output is not finite")
        terms = RL.RooflineTerms(counter.cost.flops, counter.cost.bytes)
        mf = RL.model_flops(cfg, dataclasses.replace(
            shape, global_batch=run_batch),
            distill=extra.get("distill", False))
        if device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(device)
            mem.update(peak_memory_in_bytes=peak,
                       per_device_total_gb=round(peak / 2**30, 3))
        rec.update(
            status="ok", **extra, build_s=build_s, step_s=step_s,
            roofline=terms.as_dict(), kernel_calls=counter.kernel_calls,
            model_flops=mf,
            useful_flop_ratio=(mf / terms.global_flops if terms.flops
                               else None),
            # shares of the card's peaks: only a step timed on the card
            mfu=(mf / (step_s * RL.PEAK_FLOPS) if device.type == "cuda"
                 else None),
            hbm_share=(terms.bytes_hbm / (step_s * RL.HBM_BW)
                       if device.type == "cuda" else None))
    except Exception as e:  # a failing cell is a bug: surface it loudly
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    finally:
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# the production mesh: priced, not run
# ---------------------------------------------------------------------------

META = torch.device("meta")


def _meta_inputs(cfg: ModelConfig, shape: M.ShapeSpec, batch: int) -> dict:
    return {name: torch.empty(spec.shape, dtype=spec.dtype, device=META)
            for name, spec in M.input_specs(
                cfg, shape, batch_override=batch).items()}


def _at_depth(cfg: ModelConfig, groups: int) -> ModelConfig:
    return dataclasses.replace(cfg, n_layers=groups * cfg.group_size)


def over_groups(cfg: ModelConfig, count_at) -> tuple[float, float]:
    """count_at(cfg) -> (flops, bytes) at the config's full depth, from
    its counts at one and two layer groups: every group runs the same ops
    on the same shapes (the pattern repeats, MoE positions included), so
    a count is affine in the groups, exactly."""
    if cfg.n_groups <= 2:
        return count_at(cfg)
    f1, b1 = count_at(_at_depth(cfg, 1))
    f2, b2 = count_at(_at_depth(cfg, 2))
    k = cfg.n_groups - 1
    return f1 + k * (f2 - f1), b1 + k * (b2 - b1)


def _counted(fn) -> tuple[float, float]:
    with op_cost.Counter() as c:
        fn()
    return c.cost.flops, c.cost.bytes


def meta_train_state(cfg: ModelConfig) -> dict:
    """The train state on the meta device, its step counter on the host:
    a meta tensor holds no value, and the step reads its step (the
    cell's first, 0) to pick the stage."""
    state = train_state(cfg, META)
    state["step"] = torch.zeros((), dtype=torch.int32)
    return state


def count_train_step(cfg: ModelConfig, shape: M.ShapeSpec, batch: int,
                     accum: int, *, threshold_method=None,
                     attn_dtype=torch.float32) -> tuple[float, float]:
    """(flops, bytes) of one train step of `batch` sequences in `accum`
    microbatches, run on the meta device under the counter."""
    state = meta_train_state(cfg)
    step = _step_fn(cfg, shape, accum, threshold_method, attn_dtype)
    inputs = _meta_inputs(cfg, shape, batch)
    return _counted(lambda: step(state, inputs))


def count_update(cfg: ModelConfig) -> tuple[float, float]:
    """(flops, bytes) of the AdamW update of the trainable tensors."""
    state = meta_train_state(cfg)
    own = (T.student_tensors(cfg, state["student"]) if "student" in state
           else T.named_tensors(state["params"]))
    grads = {n: torch.empty_like(t) for n, t in own.items()}
    return _counted(lambda: adam.update(grads, state["opt"], own, lr=1e-5,
                                        cfg=opt_config(cfg)))


def count_serve_step(cfg: ModelConfig, shape: M.ShapeSpec,
                     batch: int) -> tuple[float, float]:
    """(flops, bytes) of one serve step of `batch` sequences on the meta
    device: the whole prompt from position 0, or one token at
    seq_len - 1."""
    binary = is_distill(cfg)
    model = T.Transformer(cfg, device=META)
    caches = serve_caches(cfg, batch, shape.seq_len, META)
    inputs = _meta_inputs(cfg, shape, batch)
    pos = torch.full((batch,), 0 if shape.kind == "prefill"
                     else shape.seq_len - 1, dtype=torch.int32, device=META)
    tokens = inputs.get("tokens")
    if tokens is None:
        tokens = torch.empty(inputs["frames"].shape[:2], dtype=torch.int32,
                             device=META)
    return _counted(lambda: T.serve_step(
        model, tokens, caches, pos=pos,
        n=cfg.had.topn(shape.seq_len) if binary else 0, binary=binary,
        logits_mode="last", image_embeds=inputs.get("image_embeds"),
        frames=inputs.get("frames")))


def mesh_terms(cfg: ModelConfig, shape: M.ShapeSpec, mesh, *,
               threshold_method=None, attn_dtype=torch.float32
               ) -> tuple[float, float]:
    """Per-chip (flops, HBM bytes) of the cell's step on `mesh`, a lower
    bound (``launch.mesh_cost``'s docstring): a data replica's step is
    counted on meta (a train step as its microbatches of the replica's
    sequences and one AdamW update; each count over the layer groups by
    `over_groups`), the global step is the replicas' steps with one
    update, and a chip does 1/chips of it."""
    b, replicas = MC.replica_batch(shape, mesh)
    if shape.kind == "train":
        accum = MC.default_grad_accum(shape, mesh)
        mb = max(b // accum, 1)
        step = over_groups(cfg, lambda c: count_train_step(
            c, shape, mb, 1, threshold_method=threshold_method,
            attn_dtype=attn_dtype))
        upd = over_groups(cfg, count_update)
        total = [replicas * accum * (s - u) + u for s, u in zip(step, upd)]
    else:
        total = [replicas * x for x in over_groups(
            cfg, lambda c: count_serve_step(c, shape, b))]
    n = MC.chips(mesh)
    return total[0] / n, total[1] / n


def mesh_prices(cfg: ModelConfig, shape: M.ShapeSpec, mesh, *,
                carry: str = "sp") -> tuple[bool, dict, int, MC.Collectives,
                                            dict]:
    """A cell's per-chip pricing on `mesh` without its step: (fsdp, the
    argument bytes by part, saved carry bytes, collectives, the record's
    distill / grad_accum or binary / topn)."""
    if shape.kind == "train":
        state = train_state(cfg, META)
        distill = "teacher" in state
        fsdp = MC.use_fsdp(cfg, train=True) if distill else True
        accum = MC.default_grad_accum(shape, mesh)
        parts = MC.train_parts(cfg, state, shape, mesh, fsdp=fsdp)
        col, saved = MC.train_collectives(cfg, state, shape, mesh, fsdp=fsdp,
                                          carry=carry, accum=accum)
        return fsdp, parts, saved, col, {"distill": distill,
                                         "grad_accum": accum}
    fsdp = MC.use_fsdp(cfg, train=False)
    params = T.named_tensors(T.Transformer(cfg, device=META))
    caches = serve_caches(cfg, shape.global_batch, shape.seq_len, META)
    parts = {"params": MC.tensor_bytes(cfg, params, mesh, fsdp=fsdp),
             **MC.cache_parts(cfg, caches, shape, mesh),
             "inputs": MC.input_bytes(cfg, shape, mesh)}
    col = MC.serve_collectives(cfg, params, shape, mesh, fsdp=fsdp)
    binary = is_distill(cfg)
    return fsdp, parts, 0, col, {
        "binary": binary, "topn": cfg.had.topn(shape.seq_len) if binary
        else 0}


def run_mesh_cell(arch: str, shape_name: str, *, multi_pod: bool,
                  carry: str = "sp", attn_dtype: torch.dtype = torch.float32,
                  threshold_method: str | None = None,
                  cfg: ModelConfig | None = None,
                  shape: M.ShapeSpec | None = None, mesh=None) -> dict:
    """One cell priced on the production mesh (see the module docstring
    and ``launch.mesh_cost``); `mesh` overrides the production mesh
    (tests price tiny configs on small meshes)."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = M.SHAPES[shape_name] if shape is None else shape
    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None else mesh
    rec = {"arch": arch, "shape": shape_name, "mesh": MC.mesh_name(mesh),
           "device": "meta", "carry": carry}
    ok, why = M.shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        fsdp, parts, saved, col, extra = mesh_prices(cfg, shape, mesh,
                                                     carry=carry)
        args = sum(parts.values())
        flops, nbytes = mesh_terms(cfg, shape, mesh,
                                   threshold_method=threshold_method,
                                   attn_dtype=attn_dtype)
        terms = RL.RooflineTerms(flops, nbytes, sum(col.bytes.values()),
                                 chips=MC.chips(mesh),
                                 collective_s=col.seconds)
        mf = RL.model_flops(cfg, shape, distill=extra.get("distill", False))
        rec.update(
            status=("ok" if args <= FIT_SHARE * RL.HBM_BYTES
                    else "does_not_fit"), fsdp=fsdp, **extra,
            memory={"argument_size_in_bytes": args, "arguments": parts,
                    "saved_carries_bytes": saved,
                    "per_device_total_gb": round(args / 2**30, 3)},
            roofline=terms.as_dict(), collectives=col.as_dict(),
            model_flops=mf,
            useful_flop_ratio=mf / terms.global_flops if flops else None)
        if rec["status"] == "does_not_fit":
            rec["reason"] = (f"the arguments need {args / 1e9:.1f} GB a "
                             f"chip, over {FIT_SHARE:.0%} of "
                             f"{RL.HBM_BYTES / 1e9:.0f} GB")
    except Exception as e:  # a failing cell is a bug: surface it loudly
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return rec


def summary(rec: dict) -> str:
    """The cell's one-line report."""
    status = rec["status"]
    if rec.get("device") == "meta" and "roofline" in rec:
        r = rec["roofline"]
        extra = (f"fsdp={rec['fsdp']} carry={rec['carry']} "
                 f"dom={r['dominant']} tc={r['t_compute_s']:.3e} "
                 f"tm={r['t_memory_s']:.3e} tx={r['t_collective_s']:.3e} "
                 f"args/chip={rec['memory']['per_device_total_gb']}GB")
    elif status == "ok" and "roofline" in rec:
        r = rec["roofline"]
        extra = (f"batch={rec['run_batch']} dom={r['dominant']} "
                 f"tc={r['t_compute_s']:.3e} tm={r['t_memory_s']:.3e} "
                 f"step={rec['step_s']:.3e}s ({rec['device']}) "
                 + (f"mfu={rec['mfu']:.4f} hbm={rec['hbm_share']:.4f} "
                    if rec["mfu"] is not None else "") +
                 f"mem/dev={rec['memory']['per_device_total_gb']}GB")
    elif status == "ok":
        extra = (f"batch={rec['run_batch']} "
                 f"args={rec['memory']['per_device_total_gb']}GB")
    elif status == "error":
        extra = rec["error"][:200]
    else:
        extra = rec["reason"]
    return (f"[{status:12s}] {rec['arch']:24s} {rec['shape']:12s} "
            f"{rec['mesh']:8s} {extra}")


def mesh_table(records: list[dict]) -> str:
    """Production-mesh records as a markdown table: per chip, argument GB,
    the three roofline terms (ms) and the dominant one, collective bytes,
    and the useful flop ratio."""
    rows = ["| arch | shape | mesh | status | fsdp | args GB/chip | compute "
            "ms | memory ms | collective ms | dominant | collective GB/chip "
            "| useful |", "|" + " --- |" * 12]
    for r in records:
        mem, ro = r.get("memory", {}), r.get("roofline")
        cells = [r["arch"], r["shape"], r["mesh"], r["status"],
                 r.get("fsdp", ""),
                 f"{mem['argument_size_in_bytes'] / 1e9:.2f}" if mem else ""]
        if ro:
            ufr = r["useful_flop_ratio"]
            cells += [f"{ro['t_compute_s'] * 1e3:.3f}",
                      f"{ro['t_memory_s'] * 1e3:.3f}",
                      f"{ro['t_collective_s'] * 1e3:.3f}", ro["dominant"],
                      f"{ro['bytes_collective'] / 1e9:.3f}",
                      f"{ufr:.3f}" if ufr is not None else ""]
        else:
            cells += [""] * 6
        rows.append("| " + " | ".join(str(c) for c in cells) + " |")
    return "\n".join(rows)


def table(records: list[dict]) -> str:
    """The records as a markdown table: status, run batch, argument and
    peak GB, step ms, the three roofline terms (ms), dominant term, mfu
    and hbm_share (production-mesh records: `mesh_table`)."""
    rows = ["| arch | shape | status | batch | args GB | peak GB | step ms "
            "| compute ms | memory ms | collective ms | dominant | mfu "
            "| hbm_share |", "|" + " --- |" * 13]
    for r in records:
        mem, ro = r.get("memory", {}), r.get("roofline")
        cells = [r["arch"], r["shape"], r["status"], r.get("run_batch", ""),
                 f"{mem['argument_size_in_bytes'] / 1e9:.2f}" if mem else "",
                 f"{mem['peak_memory_in_bytes'] / 1e9:.2f}"
                 if "peak_memory_in_bytes" in mem else ""]
        if ro:
            cells += [f"{r['step_s'] * 1e3:.1f}",
                      f"{ro['t_compute_s'] * 1e3:.3f}",
                      f"{ro['t_memory_s'] * 1e3:.3f}",
                      f"{ro['t_collective_s'] * 1e3:.0f}", ro["dominant"],
                      f"{r['mfu']:.4f}" if r["mfu"] is not None else "",
                      f"{r['hbm_share']:.4f}"
                      if r["hbm_share"] is not None else ""]
        else:
            cells += [""] * 7
        rows.append("| " + " | ".join(str(c) for c in cells) + " |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(M.SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="run batch (default: the largest power of two "
                         "whose arguments fit)")
    ap.add_argument("--device", default="cuda",
                    choices=["cuda", "meta", "cpu"])
    ap.add_argument("--threshold", default="sort", choices=["sort", "bisect"])
    ap.add_argument("--q-block", type=int, default=None)
    ap.add_argument("--table", metavar="DIR", default=None,
                    help="print the records under DIR as a markdown "
                         "table and exit")
    ap.add_argument("--mesh", default="card",
                    choices=["card", "single", "multi", "both"],
                    help="card: run on one H100 (default); single / multi "
                         "/ both: price per chip on 16x16 / 2x16x16")
    ap.add_argument("--carry", default="sp", choices=["sp", "dp"],
                    help="the mesh's inter-layer carry: sp (\"bq.\") or dp "
                         "(\"b..\")")
    ap.add_argument("--attn-dtype", default="f32", choices=list(ATTN_DTYPES))
    args = ap.parse_args(argv)
    if args.table:
        order = {(a, sh): i for i, (a, sh) in enumerate(
            (a, sh) for a in ASSIGNED for sh in M.SHAPES)}
        recs = []
        for fn in sorted(os.listdir(args.table)):
            with open(os.path.join(args.table, fn)) as f:
                recs.append(json.load(f))
        recs.sort(key=lambda r: order.get((r["arch"], r["shape"]), -1))
        print(table(recs) if args.mesh == "card" else mesh_table(recs))
        return 0
    resolve_device(args.device)
    archs = ASSIGNED if args.all or args.arch is None else [args.arch]
    shapes = list(M.SHAPES) if args.shape is None else [args.shape]
    meshes = {"card": [None], "single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    attn_dtype = ATTN_DTYPES[args.attn_dtype]
    records = []
    for arch, shape, mp in ((a, sh, m) for a in archs for sh in shapes
                            for m in meshes):
        if mp is None:
            rec = run_cell(arch, shape, device=args.device, batch=args.batch,
                           q_block=args.q_block,
                           threshold_method=args.threshold,
                           attn_dtype=attn_dtype)
        else:
            rec = run_mesh_cell(
                arch, shape, multi_pod=mp, carry=args.carry,
                attn_dtype=attn_dtype, threshold_method=args.threshold,
                cfg=get_config(arch, q_block=args.q_block) if args.q_block
                else None)
        records.append(rec)
        print(summary(rec), flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            fn = f"{arch}__{shape}__{rec['mesh']}.json"
            with open(os.path.join(args.out, fn), "w") as f:
                json.dump(rec, f, indent=1)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"\n{len(records)} cells: "
          f"{sum(r['status'] == 'ok' for r in records)} ok, "
          f"{sum(r['status'] == 'skipped' for r in records)} skipped, "
          f"{sum(r['status'] == 'does_not_fit' for r in records)} do not "
          f"fit, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
