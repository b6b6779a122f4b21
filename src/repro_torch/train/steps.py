"""Train steps (torch twin of ``repro.train.steps``): pretrain (CE) and
HAD distillation (paper Alg. 1).

Both builders return a `step(state, batch) -> (state, metrics)` that runs
eagerly: the forward, autograd's backward over the trainable tensors,
gradient compression and AdamW (in place). Where the JAX step decides
stage, c, lr and the attention-loss switch as traced functions of
state["step"], the port's step reads the step to the host once and
evaluates the same functions for it (``CSchedule.stage_at_traced``,
``DistillConfig.lr_at``), so every step, stage boundaries included, runs
the stage JAX's would.

A state is a dict: pretrain {"params": Transformer, "opt", "step"},
distill {"teacher", "student", "opt", "step"}, and "error" with gradient
compression. "opt" is AdamW's {"mu", "nu", "count"} over the trainable
tensors by name; "step" an int32 scalar tensor. `state_tree` /
`load_state_tree` map a state to and from the JAX state's tree (the
checkpoint layout).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.checkpoint import bridge
from repro_torch.core import losses
from repro_torch.core.distill import DistillConfig
from repro_torch.distributed import compression as C
from repro_torch.models import common
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adam
from repro_torch.serve.runner import resolve_device


# the CLI's --attn-dtype names
ATTN_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class StepConfig:
    moe_aux_weight: float = 0.01
    compression: C.CompressionConfig = C.CompressionConfig()
    output_positions: str = "all"      # "all" | "last" (classification)
    grad_accum: int = 1                # microbatches per step


def _accumulate_grads(loss_fn: Callable, params: dict[str, torch.Tensor],
                      batch: dict, accum: int):
    """(loss, extras, grads by name) over `accum` microbatches of `batch`
    (split along axis 0). One microbatch: grads in the parameters' dtype;
    more: float32 sums times 1/accum, loss and extras likewise, as the JAX
    scan accumulates them. A tensor the loss does not reach (a sigma in
    the std forward) gets a zero gradient, as under jax.grad."""
    names = list(params)

    def grads_of(mb):
        loss, extras = loss_fn(mb)
        gs = torch.autograd.grad(loss, [params[n] for n in names],
                                 allow_unused=True)
        return loss.detach(), {k: v.detach() for k, v in extras.items()}, {
            n: torch.zeros_like(params[n]) if g is None else g
            for n, g in zip(names, gs)}

    if accum == 1:
        return grads_of(batch)
    micro = [{k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
              for k, v in batch.items()} for i in range(accum)]
    gsum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
    lsum, esum = None, None
    for mb in micro:
        loss, extras, grads = grads_of(mb)
        gsum = {n: gsum[n] + grads[n].to(torch.float32) for n in names}
        lsum = loss if lsum is None else lsum + loss
        esum = extras if esum is None else {k: esum[k] + v
                                            for k, v in extras.items()}
    inv = 1.0 / accum
    return (lsum * inv, {k: v * inv for k, v in esum.items()},
            {n: (g * inv).to(torch.float32) for n, g in gsum.items()})


def _set_trainable(tensors: dict[str, torch.Tensor]) -> None:
    for t in tensors.values():
        t.requires_grad_(True)


def _new_model(cfg: ModelConfig, generator: torch.Generator | None,
               device) -> T.Transformer:
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    return T.init_params(cfg, gen, device=device)


# ---------------------------------------------------------------------------
# pretrain (CE): the path for HAD-inapplicable archs (mamba2) and baselines
# ---------------------------------------------------------------------------

def init_pretrain_state(cfg: ModelConfig, opt_cfg: adam.AdamWConfig,
                        step_cfg: StepConfig = StepConfig(), *,
                        generator: torch.Generator | None = None,
                        model: T.Transformer | None = None,
                        device="cuda") -> dict:
    """A pretrain state over `model`, or over seeded weights drawn with
    `generator` (default: a CPU generator seeded 0) on `device`."""
    device = resolve_device(device)
    model = (_new_model(cfg, generator, device) if model is None
             else model.to(device))
    named = T.named_tensors(model)
    _set_trainable(named)
    state = {"params": model, "opt": adam.init(named, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if step_cfg.compression.method != "none":
        state["error"] = C.init_error(named)
    return state


def build_pretrain_step(cfg: ModelConfig, opt_cfg: adam.AdamWConfig,
                        lr_fn: Callable, step_cfg: StepConfig = StepConfig(),
                        *, had_train: bool = False,
                        dcfg: DistillConfig | None = None,
                        threshold_method: str | None = None,
                        attn_dtype: torch.dtype = torch.float32
                        ) -> Callable:
    """Next-token CE training step. had_train=True trains with the HAD
    attention in the loop (binarization-aware pretraining, on dcfg's
    schedule), its logit blocks in `attn_dtype` (JAX's module-global
    ``ATTN_DTYPE``, an argument here)."""

    def step_fn(state: dict, batch: dict):
        model = state["params"]
        step = int(state["step"])

        def loss_fn(mb):
            if had_train and cfg.has_attention:
                att = {"n": cfg.had.topn(mb["labels"].shape[1]),
                       "sched": dcfg.schedule, "step": step,
                       "threshold_method": threshold_method,
                       "attn_dtype": attn_dtype}
                out = T.forward(model, mb, cfg=cfg, mode="had_train",
                                att=att)
            else:
                out = T.forward(model, mb, cfg=cfg, mode="std")
            ce = losses.softmax_cross_entropy(out.logits, mb["labels"],
                                              valid_size=cfg.vocab_size)
            loss = ce + step_cfg.moe_aux_weight * out.moe_aux
            return loss, {"ce": ce, "moe_aux": out.moe_aux}

        named = T.named_tensors(model)
        return _apply(state, named, step_cfg, opt_cfg, lr_fn(step),
                      _accumulate_grads(loss_fn, named, batch,
                                        step_cfg.grad_accum), {})

    return step_fn


def _apply(state: dict, params: dict, step_cfg: StepConfig,
           opt_cfg: adam.AdamWConfig, lr, accumulated, more: dict):
    """Compression, AdamW and the step count; returns (state, metrics)."""
    loss, extras, grads = accumulated
    new_state = dict(state)
    if step_cfg.compression.method != "none":
        grads, new_state["error"] = C.compress_grads(
            grads, state["error"], step_cfg.compression)
    new_state["opt"], om = adam.update(grads, state["opt"], params, lr=lr,
                                       cfg=opt_cfg)
    new_state["step"] = state["step"] + 1
    lr32 = torch.as_tensor(lr, device=loss.device).to(torch.float32)
    return new_state, {"loss": loss, **extras, **om, "lr": lr32, **more}


# ---------------------------------------------------------------------------
# HAD distillation (paper Alg. 1)
# ---------------------------------------------------------------------------

def init_distill_state(cfg: ModelConfig, opt_cfg: adam.AdamWConfig,
                       step_cfg: StepConfig = StepConfig(), *,
                       teacher: T.Transformer | None = None,
                       generator: torch.Generator | None = None,
                       device="cuda") -> dict:
    """Student <- copy of the teacher's trainable subset (Alg. 1 line 1).
    The teacher is `teacher` or seeded weights; its tensors stay frozen."""
    device = resolve_device(device)
    teacher = (_new_model(cfg, generator, device) if teacher is None
               else teacher.to(device))
    student = T.student_subset(cfg, teacher)
    own = T.student_tensors(cfg, student)
    state = {"teacher": teacher, "student": student,
             "opt": adam.init(own, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if step_cfg.compression.method != "none":
        state["error"] = C.init_error(own)
    return state


def build_distill_step(cfg: ModelConfig, dcfg: DistillConfig,
                       opt_cfg: adam.AdamWConfig,
                       step_cfg: StepConfig = StepConfig(), *,
                       topn: int | None = None,
                       threshold_method: str | None = None,
                       attn_dtype: torch.dtype = torch.float32) -> Callable:
    """The paper's training step: the fused teacher + student forward, the
    Eq. 11 loss (Eq. 19 in stage 4), AdamW on the student's subset.
    `attn_dtype` is the dtype of the attention logit blocks, their top-N
    and A.V (JAX's ``set_attn_compute_dtype``; softmax and KL reduce in
    float32 either way).
    Metrics: loss, att_kl, out_kl, moe_aux, grad_norm, lr, stage, c. The
    output KL runs on the final hidden states a block of rows at a time
    (`transformer.output_kl_from_hidden`), so the step never holds the
    full [B, S, vocab] logits of either model."""

    def step_fn(state: dict, batch: dict):
        teacher, student = state["teacher"], state["student"]
        step = int(state["step"])

        def loss_fn(mb):
            seq = next(iter(mb.values())).shape[1]
            att = {"n": topn if topn is not None else cfg.had.topn(seq),
                   "sched": dcfg.schedule, "step": step,
                   "threshold_method": threshold_method,
                   "attn_dtype": attn_dtype}
            ht, hs, att_kl, moe_aux = T.distill_hidden(
                teacher, student, mb, cfg=cfg, att=att)
            if step_cfg.output_positions == "last":
                ht, hs = ht[:, -1], hs[:, -1]
            out_kl = T.output_kl_from_hidden(teacher, student, ht, hs,
                                             cfg=cfg)
            loss = losses.combined_distill_loss(
                att_kl, out_kl,
                use_attention_loss=dcfg.use_attention_loss_at(step))
            loss = loss + step_cfg.moe_aux_weight * moe_aux
            return loss, {"att_kl": att_kl, "out_kl": out_kl,
                          "moe_aux": moe_aux}

        own = T.student_tensors(cfg, student)
        dev = state["step"].device
        more = {"stage": torch.tensor(dcfg.schedule.stage_at_traced(step),
                                      dtype=torch.int32, device=dev),
                "c": dcfg.schedule.c_at(step).to(dev)}
        return _apply(state, own, step_cfg, opt_cfg, dcfg.lr_at(step),
                      _accumulate_grads(loss_fn, own, batch,
                                        step_cfg.grad_accum), more)

    return step_fn


# ---------------------------------------------------------------------------
# sigma estimation (paper Eq. 12 / Alg. 1 line 2)
# ---------------------------------------------------------------------------

@torch.no_grad()
def estimate_and_set_sigmas(model: T.Transformer, cfg: ModelConfig,
                            batches, *, n_batches: int = 100
                            ) -> T.Transformer:
    """Run the std forward on up to `n_batches` minibatches, take each
    attention layer's sigma_Q and sigma_K (the std of norm1(x) @ wq and of
    its key input @ wk over all elements, before RoPE, averaged over
    minibatches), write them into the layers' sigma buffers in place and
    refresh the serving scales. Returns `model`."""
    kinds = T.layer_kinds(cfg)
    stats: dict[tuple[int, str], list] = {}
    for count, batch in enumerate(batches):
        if count >= n_batches:
            break
        x = T._embed_inputs(model, batch, cfg)
        img = T._image_context(model, batch, cfg)
        for i, (kind, blk) in enumerate(zip(kinds, model.blocks)):
            if kind in "AC":
                h = common.rmsnorm(blk.norm1.w, x, eps=cfg.norm_eps)
                hkv = h if kind == "A" else img
                for name, src, w in (("q", h, blk.mixer.wq),
                                     ("k", hkv, blk.mixer.wk)):
                    stats.setdefault((i, name), []).append(
                        (src @ w).to(torch.float32).std(correction=0))
            x, _ = T._layer_fwd(blk, x, kind, cfg=cfg, mode="std", att={},
                                img=img)
    for i, kind in enumerate(kinds):
        if kind in "AC":
            mixer = model.blocks[i].mixer
            mixer.sigma_q.copy_(torch.stack(stats[(i, "q")]).mean())
            mixer.sigma_k.copy_(torch.stack(stats[(i, "k")]).mean())
    model.refresh_scales()
    return model


# ---------------------------------------------------------------------------
# the JAX state tree (checkpoint layout)
# ---------------------------------------------------------------------------

def _models(state: dict) -> dict[str, tuple[T.Transformer, Callable]]:
    """The state's models by key, each with the function naming its
    tensors in the JAX state (a student: its own subset)."""
    if "params" in state:
        return {"params": (state["params"], T.named_tensors)}
    cfg = state["student"].cfg
    return {"teacher": (state["teacher"], T.named_tensors),
            "student": (state["student"],
                        lambda m: T.student_tensors(cfg, m))}


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *parents, leaf = key.split(bridge.SEP)
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = val
    return tree


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{bridge.SEP}{key}" if prefix else key
        out.update(_flat(val, path) if isinstance(val, dict)
                   else {path: val})
    return out


def state_tree(state: dict) -> dict:
    """The JAX train state's tree of numpy arrays: models in the JAX
    parameter layout (stacked over groups), AdamW's moments likewise (a
    sigma's zero-size moment as is), count, step and error."""
    cfg = next(iter(_models(state).values()))[0].cfg
    tree = {key: _nest(bridge.to_jax_flat(cfg, names(model)))
            for key, (model, names) in _models(state).items()}
    opt = state["opt"]
    tree["opt"] = {"count": bridge.to_numpy(opt["count"])}
    for mom in ("mu", "nu"):
        kept = {n: t for n, t in opt[mom].items()
                if adam.default_mask(n, t)}
        flat = bridge.to_jax_flat(cfg, kept)
        for n, t in opt[mom].items():
            if n not in kept:
                flat[bridge.jax_key(cfg, n)[0]] = bridge.to_numpy(t)
        tree["opt"][mom] = _nest(flat)
    tree["step"] = bridge.to_numpy(state["step"])
    if "error" in state:
        tree["error"] = _nest(bridge.to_jax_flat(cfg, state["error"]))
    return tree


@torch.no_grad()
def load_state_tree(state: dict, tree: dict) -> dict:
    """Copy a JAX-layout state tree (numpy leaves, e.g. a restored
    checkpoint) into `state`'s tensors in place. Returns `state`."""
    cfg = next(iter(_models(state).values()))[0].cfg

    def fill(targets: dict[str, torch.Tensor], sub: dict) -> None:
        got = bridge.from_jax_flat(cfg, _flat(sub), targets)
        for n, t in targets.items():
            t.copy_(got[n].to(t.dtype))

    for key, (model, names) in _models(state).items():
        fill(names(model), tree[key])
    opt = state["opt"]
    for mom in ("mu", "nu"):
        fill({n: t for n, t in opt[mom].items() if adam.default_mask(n, t)},
             tree["opt"][mom])
    opt["count"].copy_(bridge.to_torch(tree["opt"]["count"]))
    state["step"].copy_(bridge.to_torch(tree["step"]))
    if "error" in state:
        fill(state["error"], tree["error"])
    return state
