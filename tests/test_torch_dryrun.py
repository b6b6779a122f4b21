"""The port's one-card dry run (``repro_torch.launch.dryrun``), roofline
(``launch.roofline``) and step-cost counter (``launch.op_cost``), and K1's
bounded scratch, against the JAX package.

Exact: ``model_flops`` for every arch x shape, distill on and off; the
meta build's parameter, student and AdamW bytes equal the nbytes of JAX's
``eval_shape`` trees, and its dense-cache bytes JAX's plus the port's one
trash position a self-attention leaf; the statuses of the ten assigned
archs x four shapes by the 80 GB rule, skips as JAX's
``shape_applicable``; a counted loop of matmuls; the kernel work a counted
binary serve step reports (formulas against brute-force pair counts) and
that the plain versions' ops inside it are not counted; K1's waves cover
every (row, query) once and give the one-call result on the CPU. Within
1%: the counter's matmul flops over a reduced forward against
``hlo_cost.module_cost`` on JAX's compiled forward. On the card (`cuda`
marker): K1 at T = 32768 in waves and K4 over 524288 positions against
their plain versions.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED as JASSIGNED
from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.launch import hlo_cost as HC
from repro.launch import roofline as JRL
from repro.models import model as JM
from repro.optim import adam as jadam
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.core import hamming
from repro_torch.kernels import binary_prefill_attention as pre
from repro_torch.kernels import cost as KC
from repro_torch.kernels import ref
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as RL
from repro_torch.models import model as M
from repro_torch.models import transformer as T

TOL = dict(atol=1e-5, rtol=1e-4)
KEYS = {"arch", "shape", "mesh", "status", "memory", "roofline",
        "collectives", "model_flops", "useful_flop_ratio"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _nbytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(tree))


def test_assigned_archs_match_jax():
    assert ASSIGNED == list(JASSIGNED)


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in M.SHAPES.values():
        jshape = JM.SHAPES[shape.name]
        for distill in (False, True):
            assert RL.model_flops(cfg, shape, distill=distill) == \
                JRL.model_flops(jcfg, jshape, distill=distill)


def test_roofline_terms_keys_and_constants():
    terms = RL.RooflineTerms(2 * RL.PEAK_FLOPS, RL.HBM_BW)
    jterms = JRL.RooflineTerms(1.0, 1.0, 0.0, 1)
    assert set(terms.as_dict()) == set(jterms.as_dict())
    assert (terms.t_compute, terms.t_memory, terms.t_collective) == \
        (2.0, 1.0, 0.0)
    assert terms.dominant == "compute" and terms.bound_time == 2.0
    assert (RL.HBM_BW, RL.PEAK_FLOPS) == (3.35e12, 989e12)


@functools.cache
def _jax_train_parts(jcfg) -> dict:
    """JAX's train-state bytes by part (its dry run's abstract state)."""
    opt_cfg = jadam.AdamWConfig(
        state_dtype="bfloat16" if jcfg.trainable == "attention" or
        JM.param_count(jcfg) > 5e10 else "float32")
    distill = bool(jcfg.had.enabled and jcfg.has_attention)

    def build(_):
        params = JM.init_params(jax.random.PRNGKey(0), jcfg)
        own = JM.student_subset(jcfg, params) if distill else params
        return {"params": params, "student": own if distill else {},
                "opt": jadam.init(own, opt_cfg),
                "step": jnp.zeros((), jnp.int32)}

    state = jax.eval_shape(build, 0)
    return {k: _nbytes(v) for k, v in state.items()}


def _jax_cache_bytes(jcfg, batch: int, seq: int) -> int:
    binary = bool(jcfg.had.enabled and jcfg.has_attention)
    return _nbytes(jax.eval_shape(
        lambda _: JM.init_caches(jcfg, batch, seq, binary=binary), 0))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_meta_bytes_equal_jax(arch):
    """Parameters, student, AdamW state and step of the meta build equal
    JAX's eval_shape trees; dense caches equal JAX's plus one trash
    position a self-attention leaf."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    parts = D.state_parts(cfg, D.train_state(cfg, torch.device("meta")))
    assert parts == _jax_train_parts(jcfg)
    b, s = 2, M.SHAPES["decode_32k"].seq_len
    caches = D.serve_caches(cfg, b, s, torch.device("meta"))
    total = sum(x.numel() * x.element_size() for c in caches
                for x in c.values())
    trash = sum(x.numel() * x.element_size() // (s + 1)
                for kind, c in zip(T.layer_kinds(cfg), caches)
                if kind == "A" for x in c.values())
    assert total == _jax_cache_bytes(jcfg, b, s) + trash
    serve = D.argument_parts(cfg, M.SHAPES["decode_32k"], b)
    assert serve["params"] == parts["params"] and serve["caches"] == total


def _expected_status(cfg, jcfg, shape) -> tuple[str, int]:
    """(status, run batch) by the 80 GB rule on JAX's own byte counts."""
    ok, _ = JM.shape_applicable(jcfg, JM.SHAPES[shape.name])
    if not ok:
        return "skipped", None
    if shape.kind == "train":
        fixed = sum(_jax_train_parts(jcfg).values())
    else:
        fixed = _jax_train_parts(jcfg)["params"]
    b = 1 << (shape.global_batch.bit_length() - 1)
    while b >= 1:
        args = fixed + D.input_bytes(cfg, shape, b)
        if shape.kind != "train":   # the port's caches, pinned above
            args += b * sum(x.numel() * x.element_size() for c in
                            D.serve_caches(cfg, 1, shape.seq_len, "meta")
                            for x in c.values())
        if args <= D.FIT_SHARE * RL.HBM_BYTES:
            return "ok", b
        b //= 2
    return "does_not_fit", 0


@pytest.mark.parametrize("arch", ASSIGNED)
def test_meta_statuses(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in M.SHAPES.items():
        rec = D.run_cell(arch, name, device="meta")
        status, batch = _expected_status(cfg, jcfg, shape)
        assert rec["status"] == status, (name, rec)
        assert rec["mesh"] == "1xH100"
        if status != "skipped":
            assert rec["run_batch"] == batch
            assert rec["memory"]["argument_size_in_bytes"] == sum(
                rec["memory"]["arguments"].values())


def test_meta_statuses_expected_cells():
    """The three largest archs fit one card in no cell; smollm-135m's
    decode_32k runs at its global batch of 128."""
    for arch in ("kimi-k2-1t-a32b", "jamba-1.5-large-398b", "dbrx-132b"):
        for name in M.SHAPES:
            assert D.run_cell(arch, name, device="meta")["status"] == \
                "does_not_fit"
    rec = D.run_cell("smollm-135m", "decode_32k", device="meta")
    assert rec["run_batch"] == 128


def test_counter_counts_each_matmul_of_a_loop():
    """The twin of test_hlo_cost's trip-count tests: ten n x n matmuls in
    a Python loop count 10 x 2n^3 flops and 10 x 3n^2 floats of bytes."""
    n = 32
    a = torch.randn(n, n)
    with op_cost.Counter() as c:
        x = a
        for _ in range(10):
            x = x @ a
    assert c.cost.flops == 10 * 2 * n ** 3
    assert c.cost.bytes == 10 * 3 * n * n * 4
    assert c.cost.collective_bytes == 0


def test_counter_counts_backward_and_remat():
    """Autograd's matmuls count: a checkpointed tanh(x @ w) runs its
    product twice (the forward, and the recompute that restores the tanh
    output in the backward), and the backward adds the weight gradient's
    product."""
    n = 16
    w = torch.randn(n, n, requires_grad=True)
    x = torch.randn(n, n)
    with op_cost.Counter() as c:
        y = torch.utils.checkpoint.checkpoint(lambda t: torch.tanh(t @ w),
                                              x, use_reentrant=False)
        y.sum().backward()
    assert c.cost.flops == 2 * n ** 3 * (1 + 1 + 1)


def _reduced(arch):
    return get_config(arch, reduced=True), jget_config(arch, reduced=True)


def test_counter_flops_match_hlo_cost_forward():
    """The counter's matmul flops over a reduced smollm forward
    (binary=False, mode "std") against hlo_cost.module_cost on JAX's
    compiled forward: within 1%. No op differs: both count the q/k/v/o,
    MLP and lm_head products and the two attention einsums."""
    cfg, jcfg = _reduced("smollm-135m")
    b, s = 2, 64
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    params = jax.eval_shape(lambda _: JM.init_params(
        jax.random.PRNGKey(0), jcfg), 0)
    params = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), params)
    fn = jax.jit(lambda p, t: JM.forward(p, {"tokens": t}, cfg=jcfg,
                                         mode="std").logits)
    hlo = fn.lower(params, jnp.asarray(tokens)).compile().as_text()
    want = HC.module_cost(hlo).flops
    model = T.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad(), op_cost.Counter() as c:
        T.forward(model, {"tokens": torch.from_numpy(tokens)}, cfg=cfg,
                  mode="std")
    assert abs(c.cost.flops - want) <= 0.01 * want, (c.cost.flops, want)


def _pairs_brute(s, kvl, qoff, qlen, causal) -> int:
    i = np.arange(s)[:, None]
    j = np.arange(max(kvl) + 1)[None, :]
    n = 0
    for L, o, q in zip(kvl, qoff, qlen):
        m = (i < q) & (j < L)
        if causal:
            m &= j <= o + i
        n += int(m.sum())
    return n


@pytest.mark.parametrize("causal", [True, False])
def test_k1_work_pair_count(causal):
    """k1_work's closed-form pair count against a brute-force mask count:
    ragged offsets, a partial chunk, idle rows, short caches."""
    kvl = [600, 300, 0, 77, 512, 40]
    qoff = [88, 0, 0, 70, 500, 50]
    qlen = [512, 300, 0, 7, 12, 20]
    s, w, dv = 512, 2, 64
    flops, nbytes = RL.k1_work(rows=6, s=s, w=w, dv=dv, v_bytes=2,
                               group_size=3, kv_length=kvl, q_offset=qoff,
                               q_length=qlen, causal=causal)
    pairs = _pairs_brute(s, kvl, qoff, qlen, causal)
    assert flops == pairs * ((2 * w + 2) + 2 * (dv + 1))
    kend = [min(L, o + q) if causal else L if q else 0
            for L, o, q in zip(kvl, qoff, qlen)]
    kend = [max(k, 0) if q else 0 for k, q in zip(kend, qlen)]
    keys = max(kend[:3]) + max(kend[3:])
    assert nbytes == (sum(qlen) * w * 4 + keys * (w * 4 + dv * 2)
                      + 6 * s * dv * 4 + 3 * 6 * 4)


def _serve(cfg, model, caches, tokens, pos, n):
    return T.serve_step(model, tokens, caches, pos=pos, n=n, binary=True,
                        logits_mode="last")


def test_binary_serve_step_counts_the_formulas(monkeypatch):
    """A reduced binary serve step (a dense prefill, then a decode step)
    counts the kernels' work as the formulas give it from shapes and
    lengths, and none of the plain versions' own ops: the same cost with
    the plain versions replaced by zeros."""
    cfg = get_config("smollm-135m", reduced=True)
    model = T.init_params(cfg, torch.Generator().manual_seed(0))
    b, s, max_len = 2, 24, 40
    n = cfg.had.topn(max_len)
    tokens = torch.randint(0, cfg.vocab_size, (b, s + 1),
                           generator=torch.Generator().manual_seed(1))

    def count():
        caches = T.init_caches(cfg, paged=False, batch=b, max_len=max_len)
        with op_cost.Counter() as c:
            _serve(cfg, model, caches, tokens[:, :s],
                   torch.zeros(b, dtype=torch.int32), n)
            _serve(cfg, model, caches, tokens[:, s:],
                   torch.full((b,), s, dtype=torch.int32), n)
        return c

    full = count()
    layers = cfg.n_layers
    assert full.kernel_calls == {pre.NAME: layers,
                                 "binary_decode_attention": layers}
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    w = hamming.packed_words(dh)
    pairs = _pairs_brute(s, [s] * b * h, [0] * b * h, [s] * b * h, True)
    k1_flops = pairs * ((2 * w + 2) + 2 * (dh + 1))
    vb = cfg.dtype.itemsize
    k1_bytes = (b * h * s * w * 4 + b * hk * s * (w * 4 + dh * vb)
                + b * h * s * dh * 4 + 3 * b * h * 4)
    keys = b * hk * (s + 1)
    k4_flops = keys * (h // hk) * ((2 * w + 2) + 2 * (dh + 1))
    k4_bytes = (b * h * w * 4 + keys * (w * 4 + dh * vb) + b * hk * 4
                + b * h * dh * 4)
    monkeypatch.setattr(KC, "k1_work", lambda **kw: (0.0, 0.0))
    monkeypatch.setattr(KC, "k4_work", lambda **kw: (0.0, 0.0))
    aten_only = count()
    assert full.cost.flops - aten_only.cost.flops == \
        layers * (k1_flops + k4_flops)
    assert full.cost.bytes - aten_only.cost.bytes == \
        layers * (k1_bytes + k4_bytes)
    monkeypatch.setattr(ref, "prefill_attention_ref", lambda q, k, v, **kw:
                        torch.zeros(q.shape[:2] + v.shape[-1:]))
    monkeypatch.setattr(ref, "decode_attention_ref", lambda q, k, v, **kw:
                        torch.zeros(q.shape[:2] + v.shape[-1:]))
    stubbed = count()
    assert (stubbed.cost.flops, stubbed.cost.bytes) == \
        (aten_only.cost.flops, aten_only.cost.bytes)


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-130m",
                                  "hubert-xlarge", "llama-3.2-vision-11b",
                                  "dbrx-132b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_run_cell_cpu_reduced(arch, kind):
    """run_cell on the CPU, reduced config, tiny shape: an "ok" record
    with JAX's keys (a skip for an encoder's decode), the counter's terms,
    the kernels on the binary path, and no device shares."""
    cfg, jcfg = _reduced(arch)
    shape = M.ShapeSpec(f"{kind}_tiny", {"train": 32, "prefill": 32,
                                         "decode": 48}[kind], 4, kind)
    rec = D.run_cell(arch, shape.name, device="cpu", shape=shape, cfg=cfg)
    ok, _ = JM.shape_applicable(jcfg, JM.ShapeSpec(
        shape.name, shape.seq_len, shape.global_batch, kind))
    if not ok:
        assert rec["status"] == "skipped"
        return
    assert rec["status"] == "ok", rec.get("trace")
    assert KEYS <= set(rec) and rec["collectives"] == {}
    assert set(rec["roofline"]) == set(JRL.RooflineTerms(
        1, 1, 0, 1).as_dict())
    assert rec["roofline"]["bytes_collective"] == 0
    assert rec["roofline"]["chips"] == 1 and rec["run_batch"] == 4
    assert rec["mfu"] is None and rec["hbm_share"] is None
    assert rec["model_flops"] == JRL.model_flops(
        jcfg, JM.ShapeSpec(shape.name, shape.seq_len, 4, kind),
        distill=rec.get("distill", False))
    if kind == "train":
        assert rec["grad_accum"] == 2 and "distill" in rec
    else:
        assert {"binary", "topn"} <= set(rec)
        want = {"prefill": "binary_prefill_attention",
                "decode": "binary_decode_attention"}[kind]
        assert (want in rec["kernel_calls"]) == rec["binary"]


def test_dryrun_cli(tmp_path, capsys):
    """--all --device meta: exit 0, one record per assigned arch x shape;
    --mesh single --device meta: exit 0, 40 priced 16x16 records, none an
    error, each with JAX's keys and fsdp / carry; the default device
    raises without a card."""
    assert D.main(["--all", "--device", "meta", "--out",
                   str(tmp_path / "card")]) == 0
    assert len(os.listdir(tmp_path / "card")) == len(ASSIGNED) * len(M.SHAPES)
    assert "40 cells" in capsys.readouterr().out
    out = tmp_path / "mesh"
    assert D.main(["--all", "--mesh", "single", "--device", "meta",
                   "--out", str(out)]) == 0
    assert "40 cells" in capsys.readouterr().out
    recs = [json.loads((out / fn).read_text()) for fn in os.listdir(out)]
    assert len(recs) == 40
    for rec in recs:
        assert rec["mesh"] == "16x16" and rec["status"] != "error"
        if rec["status"] != "skipped":
            assert KEYS | {"fsdp", "carry"} <= set(rec)
            assert rec["carry"] == "sp"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            D.main(["--arch", "smollm-135m", "--shape", "decode_32k"])


def test_dryrun_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import repro_torch.launch.dryrun\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "assert 'XLA_FLAGS' not in __import__('os').environ\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.path.join(root, "src")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# ---------------------------------------------------------------------------
# K1's bounded scratch
# ---------------------------------------------------------------------------

def _old_words(bh, s, t, dv, d, tiles=pre.SPLIT_TILES):
    n_q, n_s = -(-s // 64), -(-t // (tiles * 64))
    return bh * n_q * n_s * (64 * (d + 1) // 2 + 64 * (dv + 1))


# (rows, S, T, d = Dv, G): phases 2 / 4 (smollm), 6 (vision self and
# cross), 8 (dbrx)
SERVING = {"smollm": (36, 512, 4096, 64, 3),
           "vision": (128, 512, 4096, 128, 4),
           "vision cross": (128, 512, 1601, 128, 4),
           "dbrx": (192, 512, 4096, 128, 6)}


@pytest.mark.parametrize("name", list(SERVING))
def test_k1_serving_shapes_one_wave(name):
    bh, s, t, d, g = SERVING[name]
    plan = pre.split_plan((bh, s, d // 32), t, d, d, group_size=g)
    assert (plan.wave_rows, plan.wave_qtiles) == (bh, plan.n_qtiles)
    assert plan.scratch_words == _old_words(bh, s, t, d, d)
    assert len(list(pre.waves(plan, bh, s))) == 1


@pytest.mark.parametrize("batch", [1, 32])
def test_k1_scratch_bounded_at_prefill_32k(batch):
    """smollm-135m's prefill_32k step (9 heads over 3, d 64, S 32768 over
    the 32769-position dense cache): the scratch stays within the budget
    (it needs 14.7 GiB at batch 1, 471 GB at 32 in one launch) and the
    waves cover every (row, query) once, in whole GQA groups."""
    bh, s, t = 9 * batch, 32768, 32769
    assert _old_words(bh, s, t, 64, 64) > pre.SCRATCH_WORDS
    plan = pre.split_plan((bh, s, 2), t, 64, 64, group_size=3)
    assert plan.scratch_words <= pre.SCRATCH_WORDS
    cover = np.zeros((bh, s), np.int32)
    for r0, r1, s0, s1 in pre.waves(plan, bh, s):
        assert r0 % 3 == 0 and r1 % 3 == 0 and s0 % 64 == 0
        assert (r1 - r0) * -(-(s1 - s0) // 64) * plan.n_splits * (
            64 * 65 // 2 + 64 * 65) <= plan.scratch_words
        cover[r0:r1, s0:s1] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("budget", [150_000, 800_000, 10 ** 7])
def test_k1_waves_equal_one_call_on_cpu(monkeypatch, causal, budget):
    """Each wave's inputs (`wave_inputs`: kv rows of its groups, window
    offsets and live queries) through the plain version give, pasted
    together, the one-call result bit for bit: small budgets force query
    windows, then row blocks, then one wave."""
    gen = torch.Generator().manual_seed(0)
    bh, g, s, t, d = 12, 3, 200, 260, 64
    q = hamming.pack_bits(torch.randn((bh, s, d), generator=gen))
    k = hamming.pack_bits(torch.randn((bh // g, t, d), generator=gen))
    v = torch.randn((bh // g, t, d), generator=gen).to(torch.bfloat16)
    qoff = torch.tensor([0, 0, 0, 60, 60, 60, 7, 7, 7, 0, 0, 0],
                        dtype=torch.int32)
    qlen = torch.tensor([200, 200, 200, 150, 150, 150, 0, 0, 0, 65, 65, 65],
                        dtype=torch.int32)
    kvl = (qoff + qlen) if causal else torch.full_like(qoff, t)
    kw = dict(d=d, nsel=21, scale=0.125, group_size=g, causal=causal)
    want = ref.prefill_attention_ref(q, k, v, kv_length=kvl, q_offset=qoff,
                                     q_length=qlen, **kw)
    monkeypatch.setattr(pre, "SCRATCH_WORDS", budget)
    plan = pre.split_plan(q.shape, t, d, d, 1, group_size=g)
    got = torch.full_like(want, float("nan"))
    n = 0
    for r0, r1, s0, s1 in pre.waves(plan, bh, s):
        qw, kw_, vw, kvlw, qo, ql = pre.wave_inputs(
            q, k, v, kvl, qoff, qlen, g, r0, r1, s0, s1)
        got[r0:r1, s0:s1] = ref.prefill_attention_ref(
            qw, kw_, vw, kv_length=kvlw, q_offset=qo, q_length=ql, **kw)
        n += 1
    assert n > 1 or budget == 10 ** 7
    assert torch.equal(got, want)


def test_k1_plan_refuses_an_impossible_budget(monkeypatch):
    monkeypatch.setattr(pre, "SCRATCH_WORDS", 100)
    with pytest.raises(ValueError, match="over the budget"):
        pre.split_plan((3, 64, 2), 4096, 64, 64, group_size=3)


# ---------------------------------------------------------------------------
# on the card: K1 at T = 32768 in waves, K4 over 524288 positions
# ---------------------------------------------------------------------------

def _bits(shape, gen):
    return hamming.pack_bits(torch.randn(shape, generator=gen,
                                         device="cuda")).contiguous()


@pytest.mark.cuda
def test_k1_waves_at_32k_on_card(cuda):
    """One causal K1 call over smollm's prefill_32k widths at batch 1 (9
    rows over 3 kv rows, S = 32768 over the 32769-position cache: 9 waves
    of 171-tile windows) against the plain version on query windows at
    the start, the middle and the end."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    bh, g, s, t, d = 9, 3, 32768, 32769, 64
    nsel = get_config("smollm-135m").had.topn(s)
    q = _bits((bh, s, d), gen)
    k = _bits((bh // g, t, d), gen)
    v = torch.randn((bh // g, t, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    zero = torch.zeros(bh, dtype=torch.int32, device="cuda")
    full = torch.full((bh,), s, dtype=torch.int32, device="cuda")
    kw = dict(d=d, nsel=nsel, scale=0.125, causal=True)
    plan = pre.split_plan(q.shape, t, d, d, group_size=g)
    assert len(list(pre.waves(plan, bh, s))) > 1
    got = pre.prefill_attention(q, k, v, kv_length=full, q_offset=zero,
                                q_length=full, group_size=g, n_kv_heads=1,
                                **kw)
    for s0 in (0, 16384 - 64, s - 256):
        s1 = s0 + 256
        qw, kw_, vw, kvl, qo, ql = pre.wave_inputs(
            q, k, v, full, zero, full, g, 0, bh, s0, s1)
        want = ref.prefill_attention_ref(qw, kw_, vw, kv_length=kvl,
                                         q_offset=qo, q_length=ql,
                                         group_size=g, **kw)
        torch.testing.assert_close(got[:, s0:s1], want, **TOL)


@pytest.mark.cuda
def test_k4_at_524288_on_card(cuda):
    """K4 over the long_500k cache (3 rows of 3 grouped queries, 524289
    positions with the trash slot) at full and ragged lengths against its
    plain version."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    r, g, t, d = 3, 3, 524289, 64
    q = _bits((r, g, d), gen)
    k = _bits((r, t, d), gen)
    v = torch.randn((r, t, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    lengths = torch.tensor([524288, 300001, 1], dtype=torch.int32,
                           device="cuda")
    from repro_torch.kernels import binary_decode_attention as dec
    kw = dict(d=d, nsel=get_config("smollm-135m").had.topn(t - 1),
              scale=0.125)
    got = dec.decode_attention(q, k.transpose(-1, -2).contiguous(), v,
                               lengths, **kw)
    want = ref.decode_attention_ref(q, k, v, lengths=lengths, **kw)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_k1_head_dim_80_on_card(cuda, causal, vdtype):
    """K1 at hubert-xlarge's heads (d = Dv = 80: 3 words, the kernel's
    V-width-80 instance), 16 heads over 16 kv heads, ragged rows, against
    the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, s, t, d = 2, 16, 200, 300, 80
    q = _bits((b * h, s, d), gen)
    k = _bits((b * h, t, d), gen)
    v = torch.randn((b * h, t, d), generator=gen, device="cuda").to(vdtype)
    per_row = lambda x: torch.tensor(x, dtype=torch.int32,  # noqa: E731
                                     device="cuda").repeat_interleave(h)
    qoff, qlen = per_row([0, 70]), per_row([200, 130])
    kvl = qoff + qlen if causal else per_row([300, 250])
    kw = dict(d=d, nsel=35, scale=d ** -0.5, kv_length=kvl, q_offset=qoff,
              q_length=qlen, causal=causal)
    got = pre.prefill_attention(q, k, v, group_size=1, n_kv_heads=h, **kw)
    want = ref.prefill_attention_ref(q, k, v, group_size=1, **kw)
    torch.testing.assert_close(got, want, **TOL)


def test_batch_flag_keeps_the_fit_rule():
    """--batch sets the run batch, and the 80 GB rule still holds at it:
    a cell whose arguments do not fit at the asked batch is
    "does_not_fit" (granite-3-8b's train_4k at any batch, smollm-135m's
    decode_32k at 256), never a step that runs out of memory."""
    for arch, shape, batch in (("granite-3-8b", "train_4k", 2),
                               ("dbrx-132b", "prefill_32k", 1),
                               ("smollm-135m", "decode_32k", 256)):
        rec = D.run_cell(arch, shape, device="meta", batch=batch)
        assert rec["status"] == "does_not_fit", rec
        assert rec["run_batch"] == batch
    rec = D.run_cell("smollm-135m", "train_4k", device="meta", batch=2)
    assert rec["status"] == "ok" and rec["run_batch"] == 2


def test_ssd_gradients_finite_where_the_decay_overflows():
    """The dry run's train_4k step on mamba2-130m found NaN parameters
    after one step: above the diagonal of a long chunk exp(cum_t - cum_s)
    overflows, and a mask applied after the exp back-propagates 0 * inf.
    The port masks the exponent first: the forward equals JAX's
    `ssd_chunked`, the gradients are finite (JAX's are NaN there), and
    where nothing overflows they equal JAX's."""
    from repro.models import ssm as JSSM
    from repro_torch.models import ssm
    rng = np.random.default_rng(0)
    b, s, nh, p, n = 2, 16, 3, 4, 5
    xh = rng.normal(size=(b, s, nh, p)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, s, nh))) + 0.5).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32)
              for _ in range(2))
    dsk = rng.normal(size=nh).astype(np.float32)

    def jax_grads(a):
        def loss(*x):
            y, h = JSSM.ssd_chunked(*x, jnp.asarray(a), jnp.asarray(dsk),
                                    chunk=16)
            return y.sum() + h.sum()
        return jax.grad(loss, argnums=(0, 1, 2, 3))(
            *map(jnp.asarray, (xh, dt, bm, cm)))

    def torch_grads(a):
        ins = [torch.tensor(x, requires_grad=True) for x in (xh, dt, bm, cm)]
        y, h = ssm.ssd_chunked(*ins, torch.tensor(a), torch.tensor(dsk),
                               chunk=16)
        (y.sum() + h.sum()).backward()
        return y, [x.grad for x in ins]

    fast = np.array([-0.3, -1.2, -200.0], np.float32)
    y, grads = torch_grads(fast)
    jy, _ = JSSM.ssd_chunked(*map(jnp.asarray, (xh, dt, bm, cm, fast, dsk)),
                             chunk=16)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    assert all(torch.isfinite(g).all() for g in grads)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax_grads(fast))
    slow = np.array([-0.3, -1.2, -0.05], np.float32)
    _, grads = torch_grads(slow)
    for g, jg in zip(grads, jax_grads(slow)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4)
