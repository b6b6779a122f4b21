"""The examples' training loops against the JAX package, step by step.

``examples/torch_distill_encoder.py`` carries its own copy of the
``benchmarks/common.py`` helpers of the "had" run; here it runs from JAX's
initial weights (``params_from_numpy``) on the same seeded task stream as
``benchmarks.common.train_teacher`` and ``distill_variant("had")``, at
reduced step counts: 100 teacher steps (the teacher learns the task) and
2 a stage (every stage of the schedule runs). ``torch_quickstart``'s
`distill` runs its full schedule, 8 a stage, against the JAX example's
loop (``repro.train.build_distill_step`` under jit) from JAX's teacher
and stream. The JAX side's per-step losses and parameters are read
from inside its jitted steps (``jax.debug.callback`` around the loss and
``adam.update``), so the reference is the JAX code itself.

Both sides estimate the sigmas (Eq. 12), and the estimates agree at
rtol 1e-5. Each side then rounds its own to the nearest power of two:
JAX's float logits split exact top-N ties by summation order
(ROADMAP §3, "Ties at the top-N threshold in training"), and with
sigma_q and sigma_k powers of two every sum of scaled signs is exact in
float32, so JAX keeps the ties as the port does and the binarized stages
can be compared whole. Pinned, run free: every step's loss at LOSS_TOL;
the trained parameters after the first step and after the last at
STEP_TOL; the accuracies (480 held-out samples) exactly; the quickstart's
per-step metrics and its served greedy tokens.
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.core import losses as jlosses
from repro.core.distill import DistillConfig as JDistillConfig
from repro.core.distill import tiny_schedule as jtiny
from repro.data import lm_stream as jlm_stream
from repro.data import shard_batches as jshard_batches
from repro.models import ModelConfig as JModelConfig
from repro.models import model as JM
from repro.models.config import HADConfig as JHADConfig
from repro.optim import adam as jadam
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro.train import build_distill_step as jbuild_distill_step
from repro.train import estimate_and_set_sigmas as jestimate
from repro.train import init_distill_state as jinit_distill_state
from repro_torch.checkpoint import params_from_numpy
from repro_torch.checkpoint.bridge import to_jax_flat
from repro_torch.models import transformer as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a free run's losses, float32 in both: XLA's and ATen's sums differ in
# order by ~1e-7 relative a step; over 100 teacher and 10 distill steps
# the losses stay within 5e-6 of JAX's
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
SIGMA_TOL = dict(rtol=1e-5)
# parameters after a step: within a tenth of an AdamW step (lr 1e-3),
# as tests/test_torch_train.py holds them
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
TEACHER_STEPS, STEPS_PER_STAGE = 100, 2


def _twin(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pow2(x):
    return np.exp2(np.round(np.log2(np.asarray(x, np.float32)))).astype(
        np.float32)


def _round_port_sigmas(model: T.Transformer) -> list:
    """The model's estimated (sigma_q, sigma_k) a layer, then each set to
    its nearest power of two in place (and the host-side logit scales
    recomputed, as `estimate_and_set_sigmas` does)."""
    est = []
    with torch.no_grad():
        for blk in model.blocks:
            m = blk.mixer
            est.append((float(m.sigma_q), float(m.sigma_k)))
            for t in (m.sigma_q, m.sigma_k):
                t.copy_(torch.from_numpy(_pow2(t.numpy().reshape(-1)))
                        .reshape(t.shape))
    model.refresh_scales()           # the serving logit scale, on the host
    return est


def _round_jax_sigmas(params: dict) -> tuple[dict, list]:
    """JAX's tree with each estimated sigma at its nearest power of two,
    and the estimates (sigma_q, sigma_k) a layer."""
    blocks = dict(params["blocks"])
    pos = dict(blocks["pos0"])
    mixer = dict(pos["mixer"])
    est = list(zip(np.asarray(mixer["sigma_q"]).tolist(),
                   np.asarray(mixer["sigma_k"]).tolist()))
    for k in ("sigma_q", "sigma_k"):
        mixer[k] = jnp.asarray(_pow2(mixer[k]))
    pos["mixer"] = mixer
    blocks["pos0"] = pos
    return dict(params, blocks=blocks), est


class _JaxTape:
    """Every value of a loss function and every tree `adam.update`
    returns, read from inside JAX's jitted steps."""

    def __init__(self, monkeypatch, loss_names):
        self.losses, self.trees = [], []
        for name in loss_names:
            real = getattr(jlosses, name)

            def loss(*a, _real=real, **kw):
                v = _real(*a, **kw)
                jax.debug.callback(lambda x: self.losses.append(float(x)),
                                   v)
                return v
            monkeypatch.setattr(jlosses, name, loss)
        real_update = jadam.update

        def update(*a, **kw):
            out = real_update(*a, **kw)
            jax.debug.callback(lambda t: self.trees.append(
                jax.tree.map(np.asarray, t)), out[0])
            return out
        monkeypatch.setattr(jadam, "update", update)

    def take(self):
        out = self.losses[:], self.trees[:]
        self.losses.clear()
        self.trees.clear()
        return out


def _assert_tree_close(port_flat: dict, jax_tree: dict, tol: dict):
    want = _flatten(jax_tree)
    assert set(port_flat) == set(want), set(port_flat) ^ set(want)
    for key, v in want.items():
        np.testing.assert_allclose(port_flat[key], v, err_msg=key, **tol)


# ---------------------------------------------------------------------------
# torch_distill_encoder vs benchmarks.common
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def encoder_runs():
    """Both pipelines, teacher then "had" distillation, at reduced step
    counts: {side: dict(teacher_losses, teacher_trees, teacher_acc,
    sigmas, distill_losses, student_trees, student_acc)}."""
    from benchmarks import common as C
    tw = _twin("torch_distill_encoder")
    cfg = tw.CFG
    jcfg = C.encoder_cfg(d=48, layers=2, heads=4, vocab=64, seq=32,
                         name="distill-encoder")
    out = {"jax": {}, "port": {}}
    mp = pytest.MonkeyPatch()
    try:
        tape = _JaxTape(mp, ("softmax_cross_entropy",
                             "combined_distill_loss"))

        jax_real = C.estimate_and_set_sigmas

        def jax_estimate(params, cfg_, data, n_batches):
            params, est = _round_jax_sigmas(
                jax_real(params, cfg_, data, n_batches=n_batches))
            out["jax"]["sigmas"] = est
            return params
        mp.setattr(C, "estimate_and_set_sigmas", jax_estimate)
        teacher = C.train_teacher(jcfg, tw.task(0), steps=TEACHER_STEPS,
                                  lr=1e-3)
        out["jax"]["teacher_losses"], out["jax"]["teacher_trees"] = \
            tape.take()
        out["jax"]["teacher_acc"] = C.evaluate(
            jcfg, teacher, tw.task(99), n_batches=tw.EVAL_BATCHES)
        res = C.distill_variant(
            jcfg, teacher, tw.task(0), variant="had", topn=tw.TOPN,
            steps_per_stage=STEPS_PER_STAGE, eval_task=tw.task(99),
            eval_batches=tw.EVAL_BATCHES)
        out["jax"]["distill_losses"], out["jax"]["student_trees"] = \
            tape.take()
        out["jax"]["student_acc"] = res.accuracy

        port_real = tw.estimate_and_set_sigmas

        def port_estimate(model, cfg_, data, n_batches):
            port_real(model, cfg_, data, n_batches=n_batches)
            out["port"]["sigmas"] = _round_port_sigmas(model)
            return model
        mp.setattr(tw, "estimate_and_set_sigmas", port_estimate)
        port = out["port"]
        port.update(teacher_losses=[], teacher_trees=[], distill_losses=[],
                    student_trees=[])

        def on_step(losses, trees):
            def f(i, loss, tensors):
                losses.append(float(loss.detach()))
                trees.append(to_jax_flat(cfg, tensors))
            return f
        model = params_from_numpy(jax.tree.map(
            np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg)), cfg)
        model = tw.train_teacher(cfg, tw.task(0), "cpu",
                                 steps=TEACHER_STEPS, lr=1e-3, model=model,
                                 on_step=on_step(port["teacher_losses"],
                                                 port["teacher_trees"]))
        port["teacher_acc"] = tw.evaluate(cfg, model, tw.task(99), "cpu",
                                          n_batches=tw.EVAL_BATCHES)
        res = tw.distill_had(cfg, model, tw.task(0), "cpu", topn=tw.TOPN,
                             steps_per_stage=STEPS_PER_STAGE,
                             eval_task=tw.task(99),
                             eval_batches=tw.EVAL_BATCHES,
                             on_step=on_step(port["distill_losses"],
                                             port["student_trees"]))
        port["student_acc"] = res.accuracy
    finally:
        mp.undo()
    return out


def test_distill_encoder_teacher_equals_jax(encoder_runs):
    """train_teacher: the loss of each of the 100 steps, the weights
    after the first and after the last step, the held-out accuracy."""
    j, p = encoder_runs["jax"], encoder_runs["port"]
    assert len(p["teacher_losses"]) == len(j["teacher_losses"]) \
        == TEACHER_STEPS
    np.testing.assert_allclose(p["teacher_losses"], j["teacher_losses"],
                               **LOSS_TOL)
    for i in (0, -1):
        _assert_tree_close(p["teacher_trees"][i], j["teacher_trees"][i],
                           STEP_TOL)
    assert p["teacher_acc"] == j["teacher_acc"]
    assert p["teacher_acc"] > 0.5          # the task was learned (4 classes)


def test_distill_encoder_student_equals_jax(encoder_runs):
    """distill_had against distill_variant("had"): the Eq. 12 estimates,
    the loss of each step through all four stages, the student after the
    first and the last step, its had_eval accuracy."""
    j, p = encoder_runs["jax"], encoder_runs["port"]
    np.testing.assert_allclose(p["sigmas"], j["sigmas"], **SIGMA_TOL)
    assert len(p["distill_losses"]) == len(j["distill_losses"]) \
        == JDistillConfig(schedule=jtiny(STEPS_PER_STAGE)).total_steps
    np.testing.assert_allclose(p["distill_losses"], j["distill_losses"],
                               **LOSS_TOL)
    for i in (0, -1):
        _assert_tree_close(p["student_trees"][i], j["student_trees"][i],
                           STEP_TOL)
    assert p["student_acc"] == j["student_acc"]


# ---------------------------------------------------------------------------
# torch_quickstart's distillation vs the JAX example's loop
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _quickstart_runs():
    """The JAX example's distillation and the twin's `distill`, from JAX's
    teacher and stream (five batches for Eq. 12, then one a step):
    (jax metrics, jax states, jax student), and the port's."""
    mod = _twin("torch_quickstart")
    c = mod.CFG
    jcfg = JModelConfig(
        name=c.name, family=c.family, n_layers=c.n_layers,
        d_model=c.d_model, n_heads=c.n_heads, n_kv_heads=c.n_kv_heads,
        head_dim=c.head_dim, d_ff=c.d_ff, vocab_size=c.vocab_size,
        had=JHADConfig(topn_frac=c.had.topn_frac, n_min=c.had.n_min),
        param_dtype=c.param_dtype, q_block=c.q_block, remat=c.remat)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    teacher = params_from_numpy(jax.tree.map(np.asarray, params), c)

    jdata = jshard_batches(jlm_stream(vocab=c.vocab_size, batch=4, seq=32,
                                      seed=0))
    params, jsig = _round_jax_sigmas(jestimate(params, jcfg, jdata,
                                               n_batches=5))
    dcfg = JDistillConfig(schedule=jtiny(mod.STEPS_PER_STAGE),
                          lr_stages_123=1e-4)
    opt = jadam.AdamWConfig()
    state = jinit_distill_state(jax.random.PRNGKey(1), jcfg, opt,
                                teacher=params)
    step = jax.jit(jbuild_distill_step(jcfg, dcfg, opt, topn=mod.TOPN))
    jm, js = [], []
    for _ in range(dcfg.total_steps):
        state, m = step(state, next(jdata))
        jm.append({k: float(v) for k, v in m.items()})
        js.append(jax.tree.map(np.asarray, state["student"]))
    jstudent = JM.merge_student(jcfg, state["teacher"], state["student"])

    data = mod.make_data(c, "cpu")
    mod.estimate_sigmas(teacher, c, data)
    tsig = _round_port_sigmas(teacher)
    tm, ts = [], []

    def on_step(i, m, st):
        tm.append({k: float(v) for k, v in m.items()})
        ts.append(to_jax_flat(c, T.student_tensors(c, st["student"])))
    student = mod.distill(c, teacher, data, "cpu", log=lambda s: None,
                          on_step=on_step)
    return (jcfg, jsig, jm, js, jstudent), (c, tsig, tm, ts, student)


def test_quickstart_distill_equals_jax():
    """The twin's 39 steps (tiny_schedule(8)) against the JAX example's: every
    metric of every step (loss, both KLs, c, stage, lr, ...) at LOSS_TOL,
    the student after the first and the last step at STEP_TOL."""
    (_, jsig, jm, js, _), (_, tsig, tm, ts, _) = _quickstart_runs()
    np.testing.assert_allclose(tsig, jsig, **SIGMA_TOL)
    assert len(tm) == len(jm) == JDistillConfig(
        schedule=jtiny(8)).total_steps
    for i, (a, b) in enumerate(zip(tm, jm)):
        assert set(a) == set(b), (i, set(a) ^ set(b))
        for k in b:
            np.testing.assert_allclose(a[k], b[k], err_msg=f"{i} {k}",
                                       **LOSS_TOL)
    assert sorted({int(m["stage"]) for m in tm}) == [1, 2, 3, 4]
    for i in (0, -1):
        _assert_tree_close(ts[i], js[i], STEP_TOL)


def test_quickstart_served_tokens_equal_jax():
    """The distilled students served as the example serves them (binary
    and full precision, 2 prompts of 16, 8 greedy tokens): the twin's
    `serve` gives the JAX Engine's tokens."""
    (jcfg, _, _, _, jstudent), (c, _, _, _, student) = _quickstart_runs()
    mod = _twin("torch_quickstart")
    prompts = np.random.default_rng(2).integers(
        0, c.vocab_size, (2, 16)).astype(np.int32)
    got = mod.serve(c, student, prompts, "cpu")
    for binary, toks in zip((True, False), got):
        eng = JEngine(jcfg, jstudent, JServeConfig(max_len=32, batch_slots=2,
                                                   binary=binary))
        want = np.asarray(eng.generate(prompts, steps=8))
        np.testing.assert_array_equal(toks, want, err_msg=f"binary "
                                      f"{binary}")
