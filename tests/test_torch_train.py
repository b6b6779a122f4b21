"""The port's training path against the JAX package, model by model.

Reduced configs, float32: smollm-135m (dense), dbrx-132b (MoE: the
training dispatch with capacity drops and the aux loss), jamba-1.5-large
(hybrid MMMMAMMM, `trainable="attention"`: the student owns only its
attention mixer and norm1), llama-3.2-vision-11b (cross layers over
`image_embeds`), mamba2-130m (no attention: pretrain only), and the
encoders bert-base-had, deit-t and hubert-xlarge (bidirectional, learned
positions; deit and hubert embed `frames`). The same JAX weights go into
the port (`params_from_numpy`), the inputs are numpy-seeded.

Pinned: `forward` in every mode (std, fp_topn, had_train in each stage,
had_eval, sab_train / sab_eval) at LOGIT_TOL, and the MoE aux at TOL;
`forward_distill` logits, attention KL and the student's gradients
(GRAD_TOL); 3 pretrain steps and 4 distill steps, one in each stage, each
from JAX's state (metrics at TOL, the state after each at STEP_TOL);
grad_accum=2 against grad_accum=1; estimate_and_set_sigmas;
the analytic parameter counts and input specs; the launcher on the CPU.

Sigmas: stages 1-2 (tanh) run at the sigmas JAX's Eq. 12 estimation gives.
Stages 3-4 and had_eval compare whole models at sigma = 1 (the value
before estimation): there every product of sigma-scaled signs is exact in
both frameworks. At other sigmas JAX's float logits split exact ties at
the top-N threshold by summation order, which the port's logits (integer
sign products times sigma_q * sigma_k) do not; test_torch_train_core.py
pins that finding and holds the port's binarized attention at estimated
sigmas against JAX's integer-score reference, `had_infer_attention`.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.core.binarize import CSchedule as JCSchedule
from repro.core.distill import DistillConfig as JDistillConfig
from repro.core.distill import tiny_schedule as jtiny
from repro.models import model as JM
from repro.optim import adam as jadam
from repro.train import steps as JSTEPS
from repro_torch.checkpoint import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.core.binarize import CSchedule
from repro_torch.core.distill import DistillConfig, tiny_schedule
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim import adam
from repro_torch.train import steps as STEPS

TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=2e-5)    # float32, XLA vs ATen sum order
# gradients pass through a backward whose sums run in another order:
# 1e-4 relative, atol 1e-5 of the largest gradient
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# after a step: parameters within a tenth of one AdamW step (lr 1e-3) --
# in AdamW's first steps an element moves by about lr * g / |g| whatever
# |g|, so an element whose gradient is a cancellation at float noise moves
# a noise-chosen part of a step (up to 2.8e-5 in one step here)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
# the metrics of a free run's second step (grad_accum), after one update
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
# jamba's logits pass through seven SSD scans (exp of chunked cumsums:
# 1.5e-6 absolute on outputs of mean magnitude 0.37 for one layer, port
# against JAX); a few of its 32768 smallest logits land 4e-5 apart
SSM_LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)

SMOLLM, DBRX, JAMBA, VISION = ("smollm-135m", "dbrx-132b",
                               "jamba-1.5-large-398b", "llama-3.2-vision-11b")
MAMBA, BERT, DEIT, HUBERT = ("mamba2-130m", "bert-base-had", "deit-t",
                             "hubert-xlarge")
FAMILIES = [SMOLLM, DBRX, JAMBA, VISION, BERT, DEIT, HUBERT]
# jamba distills only its attention layers, as its published config does
OVERRIDES = {JAMBA: dict(trainable="attention")}
B, S = 2, 64                       # two query blocks of the reduced q_block


def _logit_tol(arch):
    return SSM_LOGIT_TOL if arch == JAMBA else LOGIT_TOL


def _cfgs(arch):
    kw = OVERRIDES.get(arch, {})
    return (jget_config(arch, reduced=True, **kw),
            get_config(arch, reduced=True, **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed=0, sigma="init"):
    """JAX weights; sigma="est": the sigmas of JAX's Eq. 12 estimation on
    two seeded batches (so the tanh stages see sigma != 1)."""
    jcfg, _ = _cfgs(arch)
    p = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    if sigma == "est":
        p = JSTEPS.estimate_and_set_sigmas(
            p, jcfg, [_jbatch(arch, i + 10) for i in range(2)], n_batches=2)
    return p


def _model(arch, **kw):
    _, tcfg = _cfgs(arch)
    return params_from_numpy(jax.tree.map(np.asarray, _jax_params(arch, **kw)),
                             tcfg)


@functools.lru_cache(maxsize=None)
def _np_batch(arch, seed=0):
    jcfg, _ = _cfgs(arch)
    rng = np.random.default_rng(seed)
    out = {}
    if jcfg.frontend_dim and "C" not in jcfg.layer_pattern:
        out["frames"] = rng.standard_normal(
            (B, S, jcfg.frontend_dim)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, jcfg.vocab_size, (B, S)
                                     ).astype(np.int32)
    out["labels"] = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    if "C" in jcfg.layer_pattern:
        out["image_embeds"] = rng.standard_normal(
            (B, jcfg.n_image_tokens, jcfg.frontend_dim)).astype(np.float32)
    return out


def _jbatch(arch, seed=0):
    return {k: jnp.asarray(v) for k, v in _np_batch(arch, seed).items()}


def _tbatch(arch, seed=0):
    return {k: torch.from_numpy(v) for k, v in _np_batch(arch, seed).items()}


SCHED = tiny_schedule(2)
JSCHED = jtiny(2)
# one step of each stage of tiny_schedule(2): stage = [1, 1, 2, 2, 2, 2,
# 3, 3, 4, 4, 4][step]
STAGE_STEP = {1: 0, 2: 3, 3: 6, 4: 9}


# the step tests' schedule: one step in each stage (c 5.0, 0.5, 0.05, 0.05)
STEP_SCHED = dict(c0=5.0, decay=0.1, stage3_steps=1, stage4_steps=1)
N_STEPS = {"pretrain": 3, "distill": 4}


def _att(step, sched):
    return {"n": 8, "sched": sched, "step": step}


# ---------------------------------------------------------------------------
# forward, every mode
# ---------------------------------------------------------------------------

MODES = ["std", "fp_topn", "had_train_1", "had_train_2", "had_train_3",
         "had_train_4", "had_eval", "sab_train", "sab_eval"]


def _mode_cases():
    out = [(SMOLLM, m) for m in MODES]
    for arch in (DBRX, JAMBA, VISION, BERT, DEIT, HUBERT):
        out += [(arch, m) for m in ("std", "had_train_2", "had_train_3",
                                    "had_eval")]
    return out + [(MAMBA, "std")]


def _sigma_for(mode):
    """Estimated sigmas for the modes where the float logits have no
    exact ties; sigma 1 where they are sums of sigma-scaled signs."""
    return "init" if mode in ("had_train_3", "had_train_4",
                              "had_eval") else "est"


@functools.lru_cache(maxsize=None)
def _jax_forward(arch, mode):
    """JAX's jitted forward with the step traced: one compile serves every
    stage (JAX's lax.switch over the stage)."""
    jcfg, _ = _cfgs(arch)
    return jax.jit(lambda p, batch, step: JM.forward(
        p, batch, cfg=jcfg, mode=mode, att=_att(step, JSCHED)))


@pytest.mark.parametrize("arch,mode", _mode_cases())
def test_forward_every_mode(arch, mode):
    jcfg, tcfg = _cfgs(arch)
    sigma = _sigma_for(mode)
    base, _, stage = mode.partition("_train_")
    run_mode = base + "_train" if stage else mode
    step = STAGE_STEP[int(stage)] if stage else 0
    jout = _jax_forward(arch, run_mode)(_jax_params(arch, sigma=sigma),
                                        _jbatch(arch), step)
    with torch.no_grad():
        tout = T.forward(_model(arch, sigma=sigma), _tbatch(arch), cfg=tcfg,
                         mode=run_mode, att=_att(step, SCHED))
    assert tout.logits.shape == (B, S, tcfg.padded_vocab)
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits),
                               **_logit_tol(arch))
    np.testing.assert_allclose(float(tout.moe_aux), float(jout.moe_aux),
                               **TOL)
    if arch == DBRX:
        assert float(tout.moe_aux) > 0.0


# ---------------------------------------------------------------------------
# forward_distill: logits, the KL and the student's gradients
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_student_grad(arch):
    """jax.value_and_grad of the test's student loss, jitted once with the
    step traced."""
    jcfg, _ = _cfgs(arch)

    def fn(student, teacher, batch, step):
        out = JM.forward_distill(teacher, student, batch, cfg=jcfg,
                                 att=_att(step, JSCHED))
        w = jnp.cos(jnp.arange(out.student_logits.size, dtype=jnp.float32)
                    ).reshape(out.student_logits.shape)
        return (jnp.sum(out.student_logits * w) * 1e-3 + out.attention_kl
                + out.moe_aux), out
    return jax.jit(jax.value_and_grad(fn, has_aux=True))


@pytest.mark.parametrize("stage", [1, 3])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_distill_and_student_grads(arch, stage):
    jcfg, tcfg = _cfgs(arch)
    step = STAGE_STEP[stage]
    sigma = "est" if stage < 3 else "init"
    pj = _jax_params(arch, sigma=sigma)
    sj = JM.student_subset(jcfg, pj)
    (_, jout), jgrad = _jax_student_grad(arch)(sj, pj, _jbatch(arch), step)

    teacher = _model(arch, sigma=sigma)
    student = T.student_subset(tcfg, teacher)
    own = T.student_tensors(tcfg, student)
    out = T.forward_distill(teacher, student, _tbatch(arch), cfg=tcfg,
                            att=_att(step, SCHED))
    w = torch.cos(torch.arange(out.student_logits.numel(),
                               dtype=torch.float32)).reshape(
        out.student_logits.shape)
    loss = (out.student_logits * w).sum() * 1e-3 + out.attention_kl \
        + out.moe_aux
    grads = dict(zip(own, torch.autograd.grad(loss, list(own.values()),
                                              allow_unused=True)))
    for a, b in ((out.teacher_logits, jout.teacher_logits),
                 (out.student_logits, jout.student_logits)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   **_logit_tol(arch))
    np.testing.assert_allclose(out.attention_kl.item(),
                               float(jout.attention_kl), **TOL)
    assert out.attention_kl.item() > 0.0
    # every student tensor, JAX-stacked, against jax.grad (a None grad is
    # a tensor the loss does not reach: JAX's is zero)
    from repro_torch.checkpoint import to_jax_flat
    got = to_jax_flat(tcfg, {n: torch.zeros_like(t) if g is None else g
                             for (n, t), g in zip(own.items(),
                                                  grads.values())})
    want = {"//".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jgrad)[0]}
    assert set(got) == set(want)
    scale = max(np.abs(v).max() for v in want.values())
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] * scale, err_msg=key)
    # the student's subset: "attention" owns only A/C mixers and norm1;
    # everything else is the teacher's tensor, shared
    if tcfg.trainable == "attention":
        shared = set(T.named_tensors(teacher).values())
        assert not any(t in shared for t in own.values())
        assert student.embed is teacher.embed
        merged = T.merge_student(tcfg, teacher, student)
        for i, kind in enumerate(T.layer_kinds(tcfg)):
            src = student if kind in "AC" else teacher
            assert merged.blocks[i].mixer is src.blocks[i].mixer
            assert merged.blocks[i].norm2 is teacher.blocks[i].norm2
        assert all(any(k.startswith(f"blocks.{i}.") for k in own)
                   == (kind in "AC")
                   for i, kind in enumerate(T.layer_kinds(tcfg)))
    assert not any(t.requires_grad for t in T.named_tensors(teacher).values()
                   if t not in set(own.values()))


@pytest.mark.parametrize("arch", [SMOLLM, BERT])
def test_output_kl_from_hidden_in_blocks(arch, monkeypatch):
    """The step's output KL, from the final hidden states through each
    head a block of rows at a time (here 7 rows a block), equals JAX's
    `output_kl` on the full logits (bert's padded vocabulary masked), and
    so do its gradients to the student's hidden states and head."""
    from repro.core import losses as JL
    jcfg, tcfg = _cfgs(arch)
    monkeypatch.setattr(T, "KL_BLOCK_LOGITS", 7 * tcfg.padded_vocab)
    teacher = _model(arch)
    student = T.student_subset(tcfg, teacher)
    rng = np.random.default_rng(8)
    ht = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    hs = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    hs_t = torch.from_numpy(hs).requires_grad_(True)
    got = T.output_kl_from_hidden(teacher, student, torch.from_numpy(ht),
                                  hs_t, cfg=tcfg)
    got.backward()
    head = "embed" if tcfg.tie_embeddings else "lm_head"
    pj = _jax_params(arch)
    wt = pj[head].T if tcfg.tie_embeddings else pj[head]

    def jf(hs, w):
        return JL.output_kl(jnp.asarray(ht) @ wt, hs @ w,
                            valid_size=jcfg.vocab_size)
    want, (gh, gw) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(hs), wt)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(hs_t.grad.numpy(), np.asarray(gh), **GRAD_TOL)
    w = getattr(student, head)
    gw_port = (w.grad.T if tcfg.tie_embeddings else w.grad).numpy()
    np.testing.assert_allclose(gw_port, np.asarray(gw), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(gw)).max())


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

STEP_CASES = [(SMOLLM, "pretrain"), (SMOLLM, "distill"), (DBRX, "pretrain"),
              (DBRX, "distill"), (JAMBA, "distill"), (DEIT, "pretrain"),
              (DEIT, "distill"), (MAMBA, "pretrain")]


@functools.lru_cache(maxsize=None)
def _jax_steps(arch, kind, accum=1, n_steps=None):
    """JAX's metrics and state (numpy tree) after each of n_steps steps."""
    jcfg, _ = _cfgs(arch)
    opt = jadam.AdamWConfig()
    scfg = JSTEPS.StepConfig(grad_accum=accum)
    p = _jax_params(arch)
    if kind == "pretrain":
        state = {"params": p, "opt": jadam.init(p, opt),
                 "step": jnp.zeros((), jnp.int32)}
        fn = JSTEPS.build_pretrain_step(jcfg, opt, lambda s: 1e-3, scfg)
    else:
        state = JSTEPS.init_distill_state(jax.random.PRNGKey(0), jcfg, opt,
                                          scfg, teacher=p)
        dcfg = JDistillConfig(schedule=JCSchedule(**STEP_SCHED),
                              lr_stages_123=1e-3, lr_stage_4=1e-4)
        fn = JSTEPS.build_distill_step(jcfg, dcfg, opt, scfg, topn=8)
    fn = jax.jit(fn)
    hist, states = [], []
    for i in range(n_steps or N_STEPS[kind]):
        state, m = fn(state, _jbatch(arch, 100 + i))
        hist.append({k: float(v) for k, v in m.items()})
        states.append(jax.tree.map(np.asarray, state))
    return hist, states


def _port_steps(arch, kind, accum=1, n_steps=None, restart_from=None):
    """The port's metrics and state after each step. With `restart_from`
    (JAX's states), step i > 0 starts from JAX's state after step i - 1
    (`load_state_tree`), so that each step is held against JAX's from the
    same state."""
    _, tcfg = _cfgs(arch)
    opt = adam.AdamWConfig()
    scfg = STEPS.StepConfig(grad_accum=accum)
    model = _model(arch)
    if kind == "pretrain":
        state = STEPS.init_pretrain_state(tcfg, opt, scfg, model=model,
                                          device="cpu")
        fn = STEPS.build_pretrain_step(tcfg, opt, lambda s: 1e-3, scfg)
    else:
        state = STEPS.init_distill_state(tcfg, opt, scfg, teacher=model,
                                         device="cpu")
        dcfg = DistillConfig(schedule=CSchedule(**STEP_SCHED),
                             lr_stages_123=1e-3, lr_stage_4=1e-4)
        fn = STEPS.build_distill_step(tcfg, dcfg, opt, scfg, topn=8)
    hist, trees = [], []
    for i in range(n_steps or N_STEPS[kind]):
        if restart_from is not None and i > 0:
            STEPS.load_state_tree(state, restart_from[i - 1])
        state, m = fn(state, _tbatch(arch, 100 + i))
        hist.append({k: float(v) for k, v in m.items()})
        trees.append(STEPS.state_tree(state))
    return hist, trees, state


def _compare_state(tree_port, tree_jax, tol):
    from repro.checkpoint.manager import _flatten
    want = _flatten(tree_jax)
    from repro_torch.checkpoint.manager import _flatten as tflat
    got = tflat(tree_port)
    assert set(got) == set(want), set(got) ^ set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


@pytest.mark.parametrize("arch,kind", STEP_CASES)
def test_three_steps_match_jax(arch, kind):
    """Three pretrain steps, or four distill steps (one in each stage),
    each from the same state and batch as JAX's (step i > 0 starts from
    JAX's state after step i - 1, loaded into the port's): every metric at
    TOL, and the whole state after each step -- trainable tensors, AdamW
    moments, count, step -- at STEP_TOL. (Run free, the two drift apart
    where a float-noise difference flips an MoE routing choice: jamba's
    third pretrain step moves one token's top-1 expert and its gradient
    norm by 0.2%.)"""
    jhist, jstates = _jax_steps(arch, kind)
    thist, ttrees, _ = _port_steps(arch, kind, restart_from=jstates)
    for i, (j, t) in enumerate(zip(jhist, thist)):
        assert set(j) == set(t)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], err_msg=f"{i} {k}",
                                       **TOL)
        _compare_state(ttrees[i], jstates[i], STEP_TOL)
    if kind == "distill":
        assert [t["stage"] for t in thist] == [1, 2, 3, 4]
        assert [t["lr"] for t in thist] == [np.float32(1e-3)] * 3 + [
            np.float32(1e-4)]


def test_grad_accum_two_equals_one():
    """grad_accum=2 (two microbatches, float32 sums) against grad_accum=1
    in the port, and against JAX's grad_accum=2."""
    one, _, s1 = _port_steps(SMOLLM, "distill", accum=1, n_steps=2)
    two, _, s2 = _port_steps(SMOLLM, "distill", accum=2, n_steps=2)
    jtwo, _ = _jax_steps(SMOLLM, "distill", accum=2, n_steps=2)
    for a, b, c in zip(one, two, jtwo):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], err_msg=k, **STEP_TOL)
            np.testing.assert_allclose(b[k], c[k], err_msg=k, **METRIC_TOL)
    for (n, a), b in zip(T.student_tensors(_cfgs(SMOLLM)[1],
                                           s1["student"]).items(),
                         T.student_tensors(_cfgs(SMOLLM)[1],
                                           s2["student"]).values()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   err_msg=n, **STEP_TOL)


@pytest.mark.parametrize("arch", [SMOLLM, VISION, DEIT])
def test_estimate_and_set_sigmas(arch):
    """Eq. 12 per layer against JAX's, and the serving scale refreshed
    from the new sigmas."""
    jcfg, tcfg = _cfgs(arch)
    want = _jax_params(arch, sigma="est")
    model = _model(arch)
    STEPS.estimate_and_set_sigmas(model, tcfg, [_tbatch(arch, i + 10)
                                                for i in range(2)],
                                  n_batches=2)
    got = params_to_numpy(model)
    for i, ch in enumerate(tcfg.layer_pattern):
        if ch not in "AC":
            continue
        for name in ("sigma_q", "sigma_k"):
            w = np.asarray(want["blocks"][f"pos{i}"]["mixer"][name])
            np.testing.assert_allclose(got["blocks"][f"pos{i}"]["mixer"][name],
                                       w, **TOL)
            assert not np.allclose(w, 1.0)
    for blk in model.blocks:
        if hasattr(blk.mixer, "scale"):
            want_scale = float(np.float32(
                np.float32(blk.mixer.sigma_q.item())
                * np.float32(blk.mixer.sigma_k.item()))
                * np.float32(tcfg.dh ** -0.5))
            assert blk.mixer.scale == want_scale


# ---------------------------------------------------------------------------
# counts and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_and_specs_match_jax(arch):
    for reduced in (False, True):
        jcfg = jget_config(arch, reduced=reduced)
        tcfg = get_config(arch, reduced=reduced)
        for fn in ("param_count", "active_param_count",
                   "trainable_param_count"):
            assert getattr(M, fn)(tcfg) == getattr(JM, fn)(jcfg), fn
        for name, shape in M.SHAPES.items():
            assert M.shape_applicable(tcfg, shape) == JM.shape_applicable(
                jcfg, JM.SHAPES[name])
            got = M.input_specs(tcfg, shape, batch_override=2)
            want = JM.input_specs(jcfg, JM.SHAPES[name], batch_override=2)
            assert list(got) == list(want)
            for k in want:
                assert got[k].shape == want[k].shape
                assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    # the reduced model's tensors count what the analytic count says
    tcfg = get_config(arch, reduced=True)
    if arch in (SMOLLM, DEIT):
        model = T.init_params(tcfg, torch.Generator().manual_seed(0))
        assert sum(t.numel() for t in T.named_tensors(model).values()) \
            == M.param_count(tcfg)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_distills_all_four_stages_on_cpu(capsys):
    from repro_torch.launch import train as launch
    res = launch.main(["--arch", SMOLLM, "--reduced", "--steps", "10",
                       "--steps-per-stage", "2", "--device", "cpu",
                       "--seq", "32", "--batch", "2"])
    text = capsys.readouterr().out
    assert "mode=distill" in text and "stages=[1, 2, 3, 4]" in text
    assert int(res.state["step"]) == 10
    assert all(np.isfinite(v) for r in res.metrics_history
               for v in r.values())


def test_launcher_pretrains_mamba_with_checkpoints(tmp_path, capsys):
    from repro_torch.launch import train as launch
    argv = ["--arch", MAMBA, "--reduced", "--steps", "4", "--device", "cpu",
            "--seq", "16", "--batch", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log", str(tmp_path / "log.jsonl")]
    res = launch.main(argv)
    assert "mode=pretrain" in capsys.readouterr().out
    assert res.resumed_from is None and int(res.state["step"]) == 4
    again = launch.main(argv[:4] + ["6"] + argv[5:])
    assert again.resumed_from == 4 and int(again.state["step"]) == 6
    assert (tmp_path / "log.jsonl").read_text().count("\n") >= 3


def test_launcher_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", SMOLLM,
         "--reduced", "--steps", "1"],
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")),
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "device='cpu'" in res.stderr


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", [SMOLLM, DEIT])
def test_distill_step_on_card_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tcfg = _cfgs(arch)
    opt = adam.AdamWConfig()
    dcfg = DistillConfig(schedule=CSchedule(**STEP_SCHED),
                         lr_stages_123=1e-3)
    out = {}
    for dev in ("cpu", "cuda"):
        state = STEPS.init_distill_state(tcfg, opt, teacher=_model(arch),
                                         device=dev)
        fn = STEPS.build_distill_step(tcfg, dcfg, opt, topn=8)
        batch = {k: v.to(dev) for k, v in _tbatch(arch, 100).items()}
        state, m = fn(state, batch)
        out[dev] = ({k: float(v) for k, v in m.items()},
                    {n: t.detach().cpu() for n, t in
                     T.student_tensors(tcfg, state["student"]).items()})
    for k, v in out["cpu"][0].items():
        np.testing.assert_allclose(out["cuda"][0][k], v, err_msg=k,
                                   **STEP_TOL)
    for n, t in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][n].numpy(), t.numpy(),
                                   err_msg=n, **STEP_TOL)
