"""The port's training core against the JAX package, function by
function: the STE and the stage transforms (values and gradients against
`jax.grad`), the c schedule step by step, the top-N thresholds and masks
(sort and bisect), every loss, the two train-time attentions with their
gradients, the inference-path attention over packed bits, one AdamW
step, gradient compression, the synthetic data streams, and checkpoints
JAX -> port -> JAX. Inside the port: the loop's crash and resume, bit for
bit, and its straggler counting. Inputs are numpy-seeded; TOL for module
outputs, GRAD_TOL for gradients.

Ties. With sigma-scaled signs as Q and K (stages 3-4, had_eval) the
logits are sums of +-sigma_q * sigma_k. JAX's float product rounds its
partial sums, so one integer score lands on several floats and the top-N
`>=` splits exact ties by summation order (`test_jax_float_logits_split_
ties`: hundreds of mask entries at sigmas that are not powers of two).
The port takes those logits as the integer sign product times sigma_q *
sigma_k, whose ties stay ties; it is held at sigma 1 against JAX's own
function (exact there) and at estimated sigmas against JAX's integer
reference `had_infer_attention`.
"""
import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.core import attention as JA
from repro.core import binarize as JBZ
from repro.core import hamming as JH
from repro.core import losses as JL
from repro.core import topn as JT
from repro.core.distill import no_tanh_schedule as jno_tanh
from repro.core.distill import tiny_schedule as jtiny
from repro.data import synthetic as JSYN
from repro.distributed import compression as JC
from repro.models import model as JM
from repro.optim import adam as jadam
from repro.train import steps as JSTEPS
from repro_torch.checkpoint import CheckpointManager, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import attention as A
from repro_torch.core import binarize as BZ
from repro_torch.core import hamming
from repro_torch.core import losses as L
from repro_torch.core import topn
from repro_torch.core.distill import DistillConfig, no_tanh_schedule, \
    tiny_schedule
from repro_torch.data import synthetic as SYN
from repro_torch.distributed import compression as C
from repro_torch.optim import adam
from repro_torch.train import LoopConfig, run
from repro_torch.train import steps as STEPS

TOL = dict(rtol=1e-5, atol=1e-6)
# gradients: the backward's sums run in another order
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=msg, **tol)


# ---------------------------------------------------------------------------
# STE, stages, schedule
# ---------------------------------------------------------------------------

def _x(n=400, seed=0):
    x = _rng(seed).normal(size=n).astype(np.float32) * 1.5
    x[:6] = [0.0, -0.0, 1.0, -1.0, 1.0000001, -0.9999999]
    return x


def test_ste_sign_forward_and_backward():
    x = _x()
    w = _rng(1).normal(size=x.shape).astype(np.float32)
    jy, jg = jax.value_and_grad(
        lambda v: jnp.sum(JBZ.ste_sign(v) * w))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = BZ.ste_sign(xt)
    (y * _t(w)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(JBZ.ste_sign(jnp.asarray(x))))
    assert set(np.unique(y.detach().numpy())) == {-1.0, 1.0}
    assert y.detach().numpy()[0] == 1.0 and y.detach().numpy()[1] == 1.0
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(
        BZ.hard_sign(_t(x)).numpy(), np.asarray(JBZ.hard_sign(jnp.asarray(x))))


@pytest.mark.parametrize("stage", [1, 2, 3, 4, "inference"])
def test_binarize_each_stage(stage):
    x, c, sigma = _x(seed=2), 2.3, 0.731
    w = _rng(3).normal(size=x.shape).astype(np.float32)
    if stage == "inference":
        want = JBZ.binarize_inference(jnp.asarray(x), sigma=sigma)
        _close(BZ.binarize_inference(_t(x), sigma=sigma), want)
        return

    def jf(v):
        return jnp.sum(JBZ.binarize(v, stage=stage, c=c, sigma=sigma) * w)
    jg = jax.grad(jf)(jnp.asarray(x))
    want = JBZ.binarize(jnp.asarray(x), stage=stage, c=c, sigma=sigma)
    xt = _t(x).requires_grad_(True)
    got = BZ.binarize(xt, stage=stage, c=c, sigma=sigma)
    (got * _t(w)).sum().backward()
    _close(got, want)
    _close(xt.grad, jg, GRAD_TOL)


@pytest.mark.parametrize("which", ["tiny1", "tiny3", "tiny25", "no_tanh",
                                   "paper"])
def test_c_schedule_step_by_step(which):
    """stage_at, stage_at_traced and c_at at every step 0 .. stage4_end
    (the paper's schedule: every 37th step and the boundaries), the
    eager step's stage equal to JAX's traced one."""
    sched, jsched = {
        "tiny1": (tiny_schedule(1), jtiny(1)),
        "tiny3": (tiny_schedule(3), jtiny(3)),
        "tiny25": (tiny_schedule(25), jtiny(25)),
        "no_tanh": (no_tanh_schedule(7), jno_tanh(7)),
        "paper": (BZ.CSchedule(), JBZ.CSchedule()),
    }[which]
    for prop in ("stage1_end", "stage2_end", "stage3_end", "stage4_end"):
        assert getattr(sched, prop) == getattr(jsched, prop)
    steps = list(range(sched.stage4_end + 2))
    if which == "paper":
        edges = [sched.stage1_end, sched.stage2_end, sched.stage3_end]
        steps = sorted(set(steps[::37] + [e + d for e in edges
                                          for d in (-1, 0, 1)]))
    traced = jax.jit(jsched.stage_at_traced)
    c_j = jax.jit(jsched.c_at)
    for s in steps:
        assert sched.stage_at(s) == jsched.stage_at(s), s
        assert sched.stage_at_traced(s) == int(traced(s)), s
        _close(sched.c_at(s), c_j(s), msg=str(s))
    dcfg = DistillConfig(schedule=sched)
    from repro.core.distill import DistillConfig as JD
    jd = JD(schedule=jsched)
    for s in steps[::max(1, len(steps) // 40)]:
        assert np.float32(dcfg.lr_at(s)) == np.float32(jd.lr_at(s))
        assert dcfg.use_attention_loss_at(s) == bool(
            jd.use_attention_loss_at(s))


@pytest.mark.parametrize("step", [0, 3, 6, 9])
def test_binarize_scheduled(step):
    x = _x(seed=4)
    got = BZ.binarize_scheduled(_t(x), step=step, sched=tiny_schedule(2),
                                sigma=0.6)
    _close(got, JBZ.binarize_scheduled(jnp.asarray(x), step=jnp.int32(step),
                                       sched=jtiny(2), sigma=0.6))


def test_estimate_sigma_eq12():
    caps = [{"a/q": _rng(i).normal(size=(3, 5, 7)).astype(np.float32) * (i + 1),
             "a/k": _rng(i + 9).normal(size=(4, 6)).astype(np.float32)}
            for i in range(3)]
    want = JBZ.estimate_sigmas_from_capture(
        [{k: jnp.asarray(v) for k, v in c.items()} for c in caps])
    got = BZ.estimate_sigmas_from_capture(
        [{k: _t(v) for k, v in c.items()} for c in caps])
    for k in want:
        _close(got[k], want[k], msg=k)
    with pytest.raises(ValueError):
        BZ.estimate_sigmas_from_capture([])


# ---------------------------------------------------------------------------
# top-N thresholds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["sort", "bisect"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [1, 5, 40])
def test_topn_threshold_and_mask(method, masked, n):
    rng = _rng(5)
    s = rng.normal(size=(2, 3, 8, 33)).astype(np.float32)
    s[0, 0, 0, :4] = s[0, 0, 0, 4]                 # ties at a threshold
    valid = (rng.random((2, 1, 8, 33)) < 0.7) if masked else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else _t(valid)
    want_t = JT.topn_threshold_exact(jnp.asarray(s), n, valid=jv,
                                     method=method)
    got_t = topn.topn_threshold_exact(_t(s), n, valid=tv, method=method)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    want = JT.topn_mask(jnp.asarray(s), n, valid=jv, method=method)
    got = topn.topn_mask(_t(s), n, valid=tv, method=method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.sum(-1).numpy() >= np.minimum(
        n, 33 if valid is None else np.broadcast_to(valid, s.shape).sum(-1))
    ).all()


def test_topn_threshold_is_detached():
    s = _t(_rng(6).normal(size=(4, 9)).astype(np.float32)).requires_grad_()
    assert not topn.topn_threshold_exact(s, 3).requires_grad


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_losses():
    rng = _rng(7)
    t = rng.normal(size=(2, 3, 5, 11)).astype(np.float32) * 2
    s = rng.normal(size=(2, 3, 5, 11)).astype(np.float32) * 2
    mask = rng.random((2, 1, 5, 11)) < 0.8
    mask[..., 0] = True
    rows = rng.random((2, 3, 5)) < 0.6
    jt, js = jnp.asarray(t), jnp.asarray(s)
    _close(L.kl_divergence(_t(t), _t(s)), JL.kl_divergence(jt, js))
    _close(L.kl_divergence(_t(t), _t(s), mask=_t(mask)),
           JL.kl_divergence(jt, js, mask=jnp.asarray(mask)))
    _close(L.attention_kl(_t(t), _t(s), mask=_t(mask)),
           JL.attention_kl(jt, js, mask=jnp.asarray(mask)))
    _close(L.attention_kl(_t(t), _t(s), row_valid=_t(rows)),
           JL.attention_kl(jt, js, row_valid=jnp.asarray(rows)))
    valid = rng.random((2, 3, 5)) < 0.5
    for kw in ({}, {"valid_size": 9}):
        _close(L.output_kl(_t(t), _t(s), **kw), JL.output_kl(jt, js, **kw))
        _close(L.output_kl(_t(t), _t(s), valid=_t(valid), **kw),
               JL.output_kl(jt, js, valid=jnp.asarray(valid), **kw))
    labels = rng.integers(0, 9, size=(2, 3, 5)).astype(np.int32)
    for kw in ({}, {"valid_size": 9}):
        _close(L.softmax_cross_entropy(_t(s), _t(labels), **kw),
               JL.softmax_cross_entropy(js, jnp.asarray(labels), **kw))
        _close(L.softmax_cross_entropy(_t(s), _t(labels), valid=_t(valid),
                                       **kw),
               JL.softmax_cross_entropy(js, jnp.asarray(labels),
                                        valid=jnp.asarray(valid), **kw))
    for use in (True, False):
        _close(L.combined_distill_loss(torch.tensor(0.7), torch.tensor(1.3),
                                       use_attention_loss=use),
               JL.combined_distill_loss(0.7, 1.3, use_attention_loss=use))


# ---------------------------------------------------------------------------
# train-time attention
# ---------------------------------------------------------------------------

def _qkv(seed, b=2, h=4, hk=2, sq=24, sk=24, d=16):
    rng = _rng(seed)
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, hk, sk, d)).astype(np.float32),
            rng.normal(size=(b, hk, sk, d)).astype(np.float32))


@pytest.mark.parametrize("causal,kv", [(True, False), (False, False),
                                       (True, True)])
@pytest.mark.parametrize("method", ["sort", "bisect"])
def test_had_topn_attention_and_grads(causal, kv, method):
    """Continuous q / k (the tanh stages and fp_topn): output, scaled
    logits and d(out . w + logits . u)/d(q, k, v) against jax.grad."""
    q, k, v = _qkv(8)
    kv_valid = (_rng(9).random((2, 24)) < 0.8) if kv else None
    w = _rng(10).normal(size=(2, 4, 24, 16)).astype(np.float32)
    u = _rng(11).normal(size=(2, 2, 2, 24, 24)).astype(np.float32) * 1e-2
    kw = dict(n=5, scale=0.25, causal=causal, method=method,
              return_logits=True)

    def jf(q, k, v):
        out, lg = JA.had_topn_attention(
            q, k, v, kv_valid=None if kv_valid is None
            else jnp.asarray(kv_valid), **kw)
        lg = jnp.where(lg > -1e29, lg, 0.0)
        return jnp.sum(out * w) + jnp.sum(lg * u), (out, lg)
    (_, (jo, jl)), jg = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out, lg = A.had_topn_attention(
        *ts, kv_valid=None if kv_valid is None else _t(kv_valid), **kw)
    lg = torch.where(lg > -1e29, lg, 0.0)
    ((out * _t(w)).sum() + (lg * _t(u)).sum()).backward()
    _close(out, jo)
    _close(lg, jl)
    for got, want, name in zip(ts, jg, "qkv"):
        _close(got.grad, want, GRAD_TOL, name)


def _binarized(seed, sq_, sk_):
    """sigma-scaled sign q / k (as JAX's stage 3 builds them) and the
    port's parts: the signs and sigma_q * sigma_k."""
    q, k, v = _qkv(seed)
    sign = lambda a: np.where(a >= 0, 1.0, -1.0).astype(np.float32)
    return (q, k, v, sign(q) * np.float32(sq_), sign(k) * np.float32(sk_),
            torch.tensor(np.float32(sq_) * np.float32(sk_)))


def test_binarized_attention_at_sigma_one_matches_jax():
    """sigma 1: JAX's sums of +-1 products are exact, so its function and
    the port's integer path agree, ties and gradients included."""
    q, k, v, qb, kb, qk = _binarized(12, 1.0, 1.0)
    w = _rng(13).normal(size=(2, 4, 24, 16)).astype(np.float32)

    def jf(qb, kb, v):
        return jnp.sum(JA.had_topn_attention(qb, kb, v, n=5, scale=0.25) * w)
    jo = JA.had_topn_attention(jnp.asarray(qb), jnp.asarray(kb),
                               jnp.asarray(v), n=5, scale=0.25)
    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(qb), jnp.asarray(kb),
                                         jnp.asarray(v))
    ts = [_t(a).requires_grad_(True) for a in (qb, kb, v)]
    out = A.had_topn_attention(*ts, n=5, scale=0.25, qk_scale=qk)
    (out * _t(w)).sum().backward()
    _close(out, jo)
    for got, want, name in zip(ts, jg, "qkv"):
        _close(got.grad, want, GRAD_TOL, name)


@pytest.mark.parametrize("sigmas", [(0.7311, 1.9337), (0.413, 0.77)])
def test_jax_float_logits_split_ties(sigmas):
    """The finding: at sigmas that are not powers of two, JAX's float
    logits of sigma-scaled signs put one integer score on several floats,
    and its top-N mask differs from the exact (integer-score) mask; the
    port's mask is the exact one, and equals the histogram mask of the
    integer Hamming scores."""
    q, k, v, qb, kb, qk = _binarized(14, *sigmas)
    raw = jnp.einsum("bhgqd,bhkd->bhgqk", JA._group(jnp.asarray(qb), 2),
                     jnp.asarray(kb))
    valid = jnp.broadcast_to(jnp.tril(jnp.ones((24, 24), bool)), raw.shape)
    jax_mask = np.asarray(JT.topn_mask(raw, 5, valid=valid))
    ints = np.einsum("bhgqd,bhkd->bhgqk", np.sign(qb).reshape(2, 2, 2, 24, 16),
                     np.sign(kb)).astype(np.int32)
    exact = np.asarray(JT.topn_mask_binary(jnp.asarray(ints), 5, 16,
                                           valid=valid))
    logits = A._logits(A._group(_t(np.sign(qb)), 2), _t(np.sign(kb)),
                       torch.float32, qk)
    port_mask = topn.topn_mask(logits, 5, valid=_t(np.asarray(valid)))
    np.testing.assert_array_equal(port_mask.numpy(), exact)
    assert (jax_mask != exact).sum() > 0
    distinct = max(len(np.unique(np.asarray(raw)[ints == m]))
                   for m in np.unique(ints))
    assert distinct > 1


@pytest.mark.parametrize("sigmas", [(0.7311, 1.9337), (0.413, 0.77)])
def test_binarized_attention_matches_jax_integer_reference(sigmas):
    """At estimated-like sigmas the port's binarized top-N attention
    equals JAX's integer-score reference `had_infer_attention` (scale =
    sigma_q * sigma_k / sqrt(d)), causal and not."""
    q, k, v, qb, kb, qk = _binarized(15, *sigmas)
    jq = JH.pack_bits(jnp.asarray(q))
    jk = JH.pack_bits(jnp.asarray(k))
    scale = float(np.float32(qk.item()) * np.float32(0.25))
    for causal in (True, False):
        want = JA.had_infer_attention(jq, jk, jnp.asarray(v), d=16, n=5,
                                      scale=scale, causal=causal,
                                      q_block=8, k_chunk=8)
        got = A.had_topn_attention(_t(np.sign(qb)), _t(np.sign(kb)), _t(v),
                                   n=5, scale=0.25, causal=causal,
                                   qk_scale=qk)
        _close(got, want, msg=str(causal))


@pytest.mark.parametrize("stage_kind", ["continuous", "binarized"])
@pytest.mark.parametrize("causal", [True, False])
def test_distill_pair_attention_and_grads(stage_kind, causal):
    """Two query blocks of 16: teacher and student outputs, the KL sum and
    row count, and the student's q / k / v gradients against jax.grad (the
    binarized student at sigma 1, where JAX's logits are exact)."""
    qt, kt, vt = _qkv(16, sq=32, sk=32)
    qs, ks, vs = _qkv(17, sq=32, sk=32)
    qk = None
    if stage_kind == "binarized":
        qs, ks = np.sign(qs).astype(np.float32), np.sign(ks).astype(
            np.float32)
        qk = torch.tensor(1.0)
    w = _rng(18).normal(size=(2, 4, 32, 16)).astype(np.float32)
    kw = dict(n=6, scale=0.25, causal=causal, q_block=16)

    def jf(qs, ks, vs):
        r = JA.distill_pair_attention(
            jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt), qs, ks, vs,
            **kw)
        return jnp.sum(r.student_out * w) + r.kl_sum * 1e-2, r
    (_, jr), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(vs))
    ts = [_t(a).requires_grad_(True) for a in (qs, ks, vs)]
    r = A.distill_pair_attention(_t(qt), _t(kt), _t(vt), *ts, qk_scale=qk,
                                 **kw)
    ((r.student_out * _t(w)).sum() + r.kl_sum * 1e-2).backward()
    _close(r.teacher_out, jr.teacher_out)
    _close(r.student_out, jr.student_out)
    _close(r.kl_sum, jr.kl_sum, dict(rtol=1e-5, atol=1e-5))
    assert float(r.row_count) == float(jr.row_count) == 2 * 4 * 32
    for got, want, name in zip(ts, jg, "qkv"):
        _close(got.grad, want, GRAD_TOL, name)


def test_choose_block():
    for s in (1, 7, 32, 96, 2048, 197):
        for t in (16, 32, 512):
            assert A.choose_block(s, t) == JA.choose_block(s, t)


@pytest.mark.parametrize("ragged", [False, True])
def test_had_infer_attention(ragged):
    q, k, v = _qkv(19, sq=16, sk=32)
    jq, jk = JH.pack_bits(jnp.asarray(q)), JH.pack_bits(jnp.asarray(k))
    kw = dict(d=16, n=5, scale=0.3, q_block=8, k_chunk=16)
    extra = {}
    if ragged:
        extra = dict(q_offset=np.array([16, 3], np.int32),
                     kv_valid=_rng(20).random((2, 32)) < 0.9,
                     q_length=np.array([16, 9], np.int32))
    want = JA.had_infer_attention(jq, jk, jnp.asarray(v), **kw, **{
        key: jnp.asarray(val) for key, val in extra.items()})
    got = A.had_infer_attention(
        _t(np.asarray(jq).view(np.int32)), _t(np.asarray(jk).view(np.int32)),
        _t(v), **kw, **{key: _t(val) for key, val in extra.items()})
    _close(got, want)
    np.testing.assert_array_equal(
        hamming.pack_bits(_t(q)).numpy(), np.asarray(jq).view(np.int32))


# ---------------------------------------------------------------------------
# AdamW and compression
# ---------------------------------------------------------------------------

def _tree(seed):
    rng = _rng(seed)
    return {"w": rng.normal(size=(5, 7)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32),
            "sigma_q": np.float32(0.8)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.5, 0.0, 100.0])
def test_adamw_step(state_dtype, clip):
    """Two AdamW steps: parameters, moments, count and grad_norm; the
    sigma gets no state and no update but counts in the norm."""
    cfg_kw = dict(grad_clip=clip, state_dtype=state_dtype, weight_decay=0.01)
    jcfg, tcfg = jadam.AdamWConfig(**cfg_kw), adam.AdamWConfig(**cfg_kw)
    params = _tree(21)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v).clone() for k, v in params.items()}
    js, ts = jadam.init(jp, jcfg), adam.init(tp, tcfg)
    assert ts["mu"]["sigma_q"].shape == js["mu"]["sigma_q"].shape == (0,)
    for i in range(2):
        g = _tree(30 + i)
        jp, js, jm = jadam.update({k: jnp.asarray(v) for k, v in g.items()},
                                  js, jp, lr=1e-2, cfg=jcfg)
        ts, tm = adam.update({k: _t(v) for k, v in g.items()}, ts, tp,
                             lr=1e-2, cfg=tcfg)
        _close(tm["grad_norm"], jm["grad_norm"])
        assert int(ts["count"]) == int(js["count"]) == i + 1
    for k in params:
        _close(tp[k], jp[k], msg=k)
    assert tp["sigma_q"].item() == np.float32(0.8)
    for mom in ("mu", "nu"):
        for k in ("w", "b"):
            assert ts[mom][k].dtype == tcfg.sdtype
            _close(ts[mom][k].float(), js[mom][k].astype(jnp.float32),
                   msg=f"{mom} {k}")


def test_lr_schedules():
    from repro.optim import schedules as JSCH
    from repro_torch.optim import schedules as SCH
    for step in (0, 1, 5, 9, 10, 37, 100, 150):
        _close(SCH.constant(3e-4)(step), JSCH.constant(3e-4)(step))
        _close(SCH.warmup_cosine(1e-3, warmup=10, total=100)(step),
               JSCH.warmup_cosine(1e-3, warmup=10, total=100)(step))
    d = DistillConfig(schedule=tiny_schedule(2))
    assert SCH.distill_stage_lr(d)(7) == 1e-5 and \
        SCH.distill_stage_lr(d)(8) == 1e-6


@pytest.mark.parametrize("method", ["onebit", "int8"])
@pytest.mark.parametrize("ef", [True, False])
def test_compression(method, ef):
    jcfg = JC.CompressionConfig(method=method, ef=ef)
    tcfg = C.CompressionConfig(method=method, ef=ef)
    g = {k: v for k, v in _tree(40).items() if k != "sigma_q"}
    je = JC.init_error({k: jnp.asarray(v) for k, v in g.items()})
    te = C.init_error({k: _t(v) for k, v in g.items()})
    for i in range(3):
        gi = {k: v * (i + 1) for k, v in g.items()}
        jq, je = JC.compress_grads({k: jnp.asarray(v) for k, v in gi.items()},
                                   je, jcfg)
        tq, te = C.compress_grads({k: _t(v) for k, v in gi.items()}, te, tcfg)
        for k in g:
            _close(tq[k], jq[k], msg=k)
            _close(te[k], je[k], msg=k)
    none = C.compress_grads({"a": torch.ones(2)}, {"a": torch.zeros(2)},
                            C.CompressionConfig())
    assert torch.equal(none[0]["a"], torch.ones(2))


# ---------------------------------------------------------------------------
# data, checkpoints, the loop
# ---------------------------------------------------------------------------

def _equal_batches(a, b):
    if hasattr(a, "inputs"):
        _equal_batches(a.inputs, b.inputs)
        np.testing.assert_array_equal(a.labels, b.labels)
        return
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("task", ["lm_stream", "classification_task",
                                  "patch_task", "retrieval_qa_task"])
def test_synthetic_streams_equal(task):
    kw = {"lm_stream": dict(vocab=50, batch=3, seq=12, seed=4),
          "classification_task": dict(vocab=60, n_classes=3, batch=3,
                                      seq=16, seed=5),
          "patch_task": dict(dim=8, n_patches=10, n_classes=4, batch=3,
                             seed=6),
          "retrieval_qa_task": dict(vocab=70, batch=3, seq=20, seed=7)}[task]
    a, b = getattr(JSYN, task)(**kw), getattr(SYN, task)(**kw)
    for _ in range(3):
        _equal_batches(next(a), next(b))


@functools.lru_cache(maxsize=None)
def _small_cfgs():
    kw = dict(n_layers=2)
    return (jget_config("smollm-135m", reduced=True, **kw),
            get_config("smollm-135m", reduced=True, **kw))


def _distill_fns():
    from repro.core.distill import DistillConfig as JD
    jcfg, tcfg = _small_cfgs()
    jstep = JSTEPS.build_distill_step(jcfg, JD(schedule=jtiny(1)),
                                      jadam.AdamWConfig(), topn=4)
    tstep = STEPS.build_distill_step(tcfg, DistillConfig(
        schedule=tiny_schedule(1)), adam.AdamWConfig(), topn=4)
    return jstep, tstep


def test_checkpoint_jax_to_port_to_jax(tmp_path):
    """A JAX distill state after one step, saved by the JAX manager,
    restores into the port's state (every tensor equal), takes a port
    step, is saved by the port's manager, and restores into JAX's state
    structure with every leaf equal to the port's."""
    jcfg, tcfg = _small_cfgs()
    jstate = JSTEPS.init_distill_state(jax.random.PRNGKey(3), jcfg,
                                       jadam.AdamWConfig())
    jstep, tstep = _distill_fns()
    batch = {"tokens": _rng(50).integers(0, 256, (2, 16)).astype(np.int32)}
    jstate, _ = jax.jit(jstep)(jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    JCheckpointManager(str(tmp_path / "jax")).save(1, {"state": jstate})

    teacher = params_from_numpy(jax.tree.map(np.asarray, jstate["teacher"]),
                                tcfg)
    tstate = STEPS.init_distill_state(tcfg, adam.AdamWConfig(),
                                      teacher=teacher, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "jax"))
    assert mgr.latest_step() == 1
    step, got = mgr.restore({"state": STEPS.state_tree(tstate)})
    STEPS.load_state_tree(tstate, got["state"])
    from repro.checkpoint.manager import _flatten
    want = _flatten(jstate)
    from repro_torch.checkpoint.manager import _flatten as tflat
    mine = tflat(STEPS.state_tree(tstate))
    assert set(mine) == set(want)
    for key in want:
        np.testing.assert_array_equal(mine[key], want[key], err_msg=key)
    assert int(tstate["step"]) == 1 and int(tstate["opt"]["count"]) == 1

    tstate, _ = tstep(tstate, {k: _t(v) for k, v in batch.items()})
    CheckpointManager(str(tmp_path / "port")).save(2, {"state": STEPS
                                                       .state_tree(tstate)})
    _, back = JCheckpointManager(str(tmp_path / "port")).restore(
        {"state": jstate})
    mine = tflat(STEPS.state_tree(tstate))
    for key, val in _flatten(back["state"]).items():
        np.testing.assert_array_equal(val, mine[key], err_msg=key)
    assert int(back["state"]["step"]) == 2


def test_checkpoint_manager_atomic_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"c": {"a": torch.full((2,), float(s)),
                           "b": {"x": torch.ones(1, dtype=torch.bfloat16)}}})
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    os.makedirs(tmp_path / "step_0000000009.tmp")    # a crashed save
    assert mgr.latest_step() == 3
    _, got = mgr.restore({"c": {"a": torch.zeros(2),
                                "b": {"x": torch.zeros(1,
                                                       dtype=torch.bfloat16)}}})
    np.testing.assert_array_equal(got["c"]["a"], [3.0, 3.0])
    assert got["c"]["b"]["x"].dtype == np.dtype("V2")


def _loop_parts(tmp_path=None):
    _, tcfg = _small_cfgs()
    teacher = STEPS.init_pretrain_state(
        tcfg, adam.AdamWConfig(), generator=torch.Generator().manual_seed(1),
        device="cpu")["params"]
    for t in teacher.parameters():
        t.requires_grad_(False)
    state = STEPS.init_distill_state(tcfg, adam.AdamWConfig(),
                                     teacher=teacher, device="cpu")
    data = ({k: _t(v) for k, v in b.items()} for b in SYN.lm_stream(
        vocab=tcfg.vocab_size, batch=2, seq=16, seed=3))
    return state, _distill_fns()[1], data


def test_loop_crash_and_resume_bit_for_bit(tmp_path):
    """A run that crashes at step 5 (checkpoints every 2 steps) and is
    restarted from fresh weights resumes from step 4 and ends bit for bit
    where an uninterrupted run ends; its JSONL log appends."""
    state, step_fn, data = _loop_parts()
    clean = run(step_fn, state, data, LoopConfig(max_steps=7, log_every=1))

    def crash(step):
        if step == 5:
            raise RuntimeError("injected failure")

    ck = dict(max_steps=7, ckpt_every=2, ckpt_dir=str(tmp_path / "ck"),
              log_every=1, log_path=str(tmp_path / "log.jsonl"))
    state, step_fn, data = _loop_parts()
    with pytest.raises(RuntimeError, match="injected"):
        run(step_fn, state, data, LoopConfig(**ck), failure_hook=crash)
    state, step_fn, data = _loop_parts()
    for _ in range(4):                     # the batches steps 0-3 took
        next(data)
    res = run(step_fn, state, data, LoopConfig(**ck))
    assert res.resumed_from == 4
    a = STEPS.state_tree(clean.state)
    b = STEPS.state_tree(res.state)
    from repro_torch.checkpoint.manager import _flatten
    fa, fb = _flatten(a), _flatten(b)
    for key in fa:
        np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)
    assert [r["loss"] for r in res.metrics_history] == [
        r["loss"] for r in clean.metrics_history[4:]]
    lines = (tmp_path / "log.jsonl").read_text().splitlines()
    assert len(lines) == 5 + 3


def test_loop_straggler_counting():
    """The first step (warm-up) never counts; a step slower than 3x the
    EWMA does, and is flagged in its metrics."""
    delays = iter([0.3, 0.01, 0.01, 0.01, 0.2, 0.01])

    def step_fn(state, batch):
        time.sleep(next(delays))
        return dict(state, step=state["step"] + 1), {
            "loss": torch.tensor(1.0)}

    res = run(step_fn, {"step": torch.zeros((), dtype=torch.int32)},
              iter(range(10)), LoopConfig(max_steps=6, log_every=1))
    assert res.straggler_events == 1
    assert [r.get("straggler", 0.0) for r in res.metrics_history] == [
        0, 0, 0, 0, 1.0, 0]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("stage_kind", ["continuous", "binarized"])
def test_distill_pair_attention_on_card_matches_cpu(stage_kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    qt, kt, vt = _qkv(16, sq=64, sk=64)
    qs, ks, vs = _qkv(17, sq=64, sk=64)
    qk = None
    if stage_kind == "binarized":
        qs, ks = np.sign(qs).astype(np.float32), np.sign(ks).astype(
            np.float32)
        qk = torch.tensor(0.413 * 0.77)
    out = {}
    for dev in ("cpu", "cuda"):
        ts = [_t(a).to(dev).requires_grad_(True) for a in (qs, ks, vs)]
        r = A.distill_pair_attention(
            _t(qt).to(dev), _t(kt).to(dev), _t(vt).to(dev), *ts, n=6,
            scale=0.25, q_block=16,
            qk_scale=None if qk is None else qk.to(dev))
        (r.student_out.sum() + r.kl_sum).backward()
        out[dev] = [r.student_out.detach().cpu(), r.kl_sum.detach().cpu()] \
            + [t.grad.cpu() for t in ts]
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
