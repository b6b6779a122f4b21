"""The dry run's production mesh (``repro_torch.launch.dryrun --mesh``,
``launch.mesh_cost``) against the JAX package, and bf16 train attention.

Exact: ``use_fsdp`` and ``default_grad_accum`` equal JAX's for the ten
assigned archs (JAX's functions run in a subprocess: importing
``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices); per-chip
argument bytes by part at 16x16 and 2x16x16 equal those of JAX's
``param_spec`` / ``cache_spec`` / ``batch_spec`` over its ``eval_shape``
trees on a ``jax.sharding.AbstractMesh`` (the caches JAX's plus one
trash position a self-attention leaf); the meta count of a reduced
cell's step equals its CPU count, and the group extrapolation equals the
full-depth count; the collective formulas against bytes computed by hand
for a tiny config on a 2x4 mesh. Once against XLA itself (a subprocess
with 8 host devices): reduced smollm-135m's train and decode cells lowered
by JAX's ``lower_train`` / ``lower_serve`` on a 2x4 mesh have the port's
per-chip arguments (less what the port adds or XLA drops: the trash
position, the unused labels, the scalar ``pos``); XLA's collective bytes
are printed beside the port's formulas, not gated. Within a bf16
tolerance: one ``attn_dtype=bfloat16`` distill step against JAX's under
``set_attn_compute_dtype(jnp.bfloat16)``.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed import sharding as JSH
from repro.models import model as JM
from repro.optim import adam as jadam
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh_cost as MC
from repro_torch.launch import roofline as RL
from repro_torch.models import model as M
from repro_torch.models.config import HADConfig, ModelConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _subprocess(code: str, *, devices: int | None = None) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@functools.lru_cache(maxsize=None)
def _jax_dryrun_rules() -> dict:
    """JAX's use_fsdp and default_grad_accum, from a subprocess."""
    code = (
        "import json\n"
        "from jax.sharding import AbstractMesh\n"
        "from repro.configs import ASSIGNED, get_config\n"
        "from repro.launch import dryrun as JD\n"
        "from repro.models import model as M\n"
        f"meshes = {MESHES!r}\n"
        "out = {}\n"
        "for a in ASSIGNED:\n"
        "    cfg = get_config(a)\n"
        "    out[a] = {'fsdp': [JD.use_fsdp(cfg, train=True),\n"
        "                       JD.use_fsdp(cfg, train=False)],\n"
        "              'accum': {f'{m}/{s}': JD.default_grad_accum(\n"
        "                  M.SHAPES[s], AbstractMesh(*meshes[m]))\n"
        "                  for m in meshes for s in M.SHAPES}}\n"
        "print(json.dumps(out))\n")
    return _subprocess(code)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_use_fsdp_and_grad_accum_equal_jax(arch):
    want = _jax_dryrun_rules()[arch]
    cfg = get_config(arch)
    assert [MC.use_fsdp(cfg, train=True),
            MC.use_fsdp(cfg, train=False)] == want["fsdp"]
    for m, (sizes, names) in MESHES.items():
        for s, shape in M.SHAPES.items():
            assert MC.default_grad_accum(shape, AbstractMesh(sizes, names)) \
                == want["accum"][f"{m}/{s}"], (m, s)


# ---------------------------------------------------------------------------
# per-chip arguments against JAX's specs
# ---------------------------------------------------------------------------

def _shard_bytes(leaf, spec, mesh) -> int:
    shape = list(leaf.shape)
    for i, ax in enumerate(tuple(spec)):
        if ax is not None:
            axes = (ax,) if isinstance(ax, str) else ax
            shape[i] //= math.prod(mesh.shape[a] for a in axes)
    return math.prod(shape) * leaf.dtype.itemsize


def _param_bytes(tree, mesh, fsdp) -> int:
    return sum(_shard_bytes(leaf, JSH.param_spec(path, leaf, mesh,
                                                 fsdp_enabled=fsdp), mesh)
               for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0])


def _input_bytes(jcfg, shape, mesh) -> int:
    specs = JM.input_specs(jcfg, shape)
    shardings = JSH.batch_spec(specs, mesh, global_batch=shape.global_batch)
    return sum(_shard_bytes(specs[k], shardings[k].spec, mesh)
               for k in specs)


def _opt_cfg(jcfg):
    return jadam.AdamWConfig(
        state_dtype="bfloat16" if jcfg.trainable == "attention" or
        JM.param_count(jcfg) > 5e10 else "float32")


@functools.lru_cache(maxsize=None)
def _jax_trees(arch):
    jcfg = jget_config(arch)
    params = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    student = jax.eval_shape(lambda p: JM.student_subset(jcfg, p), params)
    opt = jax.eval_shape(lambda s: jadam.init(s, _opt_cfg(jcfg)), student)
    return jcfg, params, student, opt


def _jax_parts(arch, shape_name, mesh, fsdp_train, fsdp_serve) -> dict:
    """JAX's per-chip argument bytes of a cell, by the port's parts."""
    jcfg, params, student, opt = _jax_trees(arch)
    shape = JM.SHAPES[shape_name]
    inputs = _input_bytes(jcfg, shape, mesh)
    if shape.kind == "train":
        distill = bool(jcfg.had.enabled and jcfg.has_attention)
        fsdp = fsdp_train if distill else True
        moments = (opt if distill else jax.eval_shape(
            lambda p: jadam.init(p, _opt_cfg(jcfg)), params))
        return {"params": _param_bytes(params, mesh, fsdp),
                "student": _param_bytes(student, mesh, fsdp) if distill
                else 0,
                "opt": _param_bytes(moments["mu"], mesh, fsdp)
                + _param_bytes(moments["nu"], mesh, fsdp) + 4,
                "step": 4, "inputs": inputs}
    binary = bool(jcfg.had.enabled and jcfg.has_attention)
    caches = jax.eval_shape(lambda: JM.init_caches(
        jcfg, shape.global_batch, shape.seq_len, binary=binary))
    cache_b = sum(_shard_bytes(leaf, JSH.cache_spec(
        path, leaf, mesh, global_batch=shape.global_batch), mesh)
        for path, leaf in jax.tree_util.tree_flatten_with_path(caches)[0])
    return {"params": _param_bytes(params, mesh, fsdp_serve),
            "caches": cache_b, "inputs": inputs}


def _trash(cfg, shape, mesh) -> int:
    """One position a self-attention leaf: its batch shard (the batch over
    the data axes when it divides), every kv head, one position."""
    b, _ = MC.replica_batch(shape, mesh)
    w = (cfg.dh + 31) // 32
    binary = bool(cfg.had.enabled and cfg.has_attention)
    k = b * cfg.n_kv_heads * (w * 4 if binary else
                              cfg.dh * cfg.dtype.itemsize)
    v = b * cfg.n_kv_heads * cfg.dh * cfg.dtype.itemsize
    return cfg.layer_pattern.count("A") * cfg.n_groups * (k + v)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_per_chip_arguments_equal_jax_specs(arch):
    """Every cell's per-chip arguments by part at 16x16 and 2x16x16."""
    from jax.sharding import AbstractMesh as JAbstractMesh
    cfg = get_config(arch)
    for name, (sizes, names) in MESHES.items():
        mesh = AbstractMesh(sizes, names)
        jmesh = JAbstractMesh(sizes, names)
        for shape_name, shape in M.SHAPES.items():
            if not M.shape_applicable(cfg, shape)[0]:
                continue
            got = dict(D.mesh_prices(cfg, shape, mesh)[1])
            want = _jax_parts(arch, shape_name, jmesh,
                              MC.use_fsdp(cfg, train=True),
                              MC.use_fsdp(cfg, train=False))
            if shape.kind != "train":
                assert got.pop("trash") == _trash(cfg, shape, mesh)
            assert got == want, (name, shape_name)


# ---------------------------------------------------------------------------
# the meta count
# ---------------------------------------------------------------------------

TINY = M.ShapeSpec("tiny", 64, 4, "train")
COUNT_CASES = [("smollm-135m", "train"), ("smollm-135m", "prefill"),
               ("smollm-135m", "decode"), ("jamba-1.5-large-398b", "train"),
               ("dbrx-132b", "decode"), ("llama-3.2-vision-11b", "prefill"),
               ("mamba2-130m", "train"), ("bert-base-had", "train")]


@pytest.mark.parametrize("arch,kind", COUNT_CASES)
def test_meta_count_equals_cpu_count(arch, kind):
    """The step counted on meta (empty kernel outputs, work from shapes;
    the counter's memo) gives the CPU run's flops and bytes exactly."""
    cfg = get_config(arch, reduced=True)
    shape = M.ShapeSpec("tiny", 64, 4, kind)
    rec = D.run_cell(arch, "tiny", device="cpu", cfg=cfg, shape=shape)
    assert rec["status"] == "ok", rec.get("trace")
    if kind == "train":
        got = D.count_train_step(cfg, shape, 4, rec["grad_accum"])
    else:
        got = D.count_serve_step(cfg, shape, 4)
    assert got == (rec["roofline"]["flops"], rec["roofline"]["bytes_hbm"])


@pytest.mark.parametrize("arch", ["smollm-135m", "jamba-1.5-large-398b"])
def test_group_extrapolation_equals_full_depth(arch):
    """over_groups' counts at one and two groups give the count of four
    groups exactly, train and serve."""
    base = get_config(arch, reduced=True)
    cfg = D._at_depth(base, 4)
    for kind in ("train", "decode"):
        shape = M.ShapeSpec("tiny", 32, 2, kind)
        if kind == "train":
            fn = functools.partial(D.count_train_step, shape=shape, batch=2,
                                   accum=1)
        else:
            fn = functools.partial(D.count_serve_step, shape=shape, batch=2)
        assert D.over_groups(cfg, lambda c: fn(c)) == fn(cfg)


def test_mesh_terms_are_the_replicas_microbatches():
    """A train cell's per-chip terms: the replicas' microbatches and one
    update over the chips (mesh_terms against the counts it combines)."""
    cfg = get_config("smollm-135m", reduced=True)
    mesh = AbstractMesh((2, 4), ("data", "model"))
    shape = M.ShapeSpec("tiny", 32, 8, "train")
    accum = MC.default_grad_accum(shape, mesh)
    assert accum == 2
    step = D.count_train_step(cfg, shape, 2, 1)
    upd = D.count_update(cfg)
    want = [(2 * accum * (s - u) + u) / 8 for s, u in zip(step, upd)]
    assert list(D.mesh_terms(cfg, shape, mesh)) == want


# ---------------------------------------------------------------------------
# collective formulas, by hand
# ---------------------------------------------------------------------------

TINY_CFG = ModelConfig(
    name="tiny", family="dense", n_layers=1, d_model=8, n_heads=2,
    n_kv_heads=2, head_dim=4, d_ff=16, vocab_size=32,
    had=HADConfig(n_min=2), param_dtype="float32", q_block=8)
MESH_2X4 = AbstractMesh((2, 4), ("data", "model"))


def test_link_rates():
    """The model axis of 4 lies in one node (NVLink); data (stride 4)
    spans 8 chips, still one node; on 16x16 both axes span nodes."""
    assert MC.group_bw(MESH_2X4, "model") == RL.LINK_BW
    assert MC.group_bw(MESH_2X4, ("data",)) == RL.LINK_BW
    big = AbstractMesh((16, 16), ("data", "model"))
    assert MC.group_bw(big, "model") == MC.NET_BW == 50e9
    assert MC.group_bw(big, "data") == MC.NET_BW
    assert MC.group_bw(AbstractMesh((2, 2), ("data", "model")),
                       ("data", "model")) == RL.LINK_BW


def test_serve_collectives_by_hand():
    """Decode, batch 4 (2 a replica), seq 32 over model: the activation
    all-reduces, the logits gather, the histogram all-reduce."""
    shape = M.ShapeSpec("d", 32, 4, "decode")
    col = MC.serve_collectives(TINY_CFG, {}, shape, MESH_2X4, fsdp=False)
    act = 2 * 1 * 8 * 4                       # b, s, d, float32
    ar = 2 * act * 3 / 4 * 2                  # two sublayers
    stats = 2 * 2 * (5 * 4 + 6 * 4)           # b, heads, hist + partials
    ar += 2 * stats * 3 / 4
    ag = 2 * 32 * 4 * 3 / 4                   # logits [b, V] float32
    assert col.as_dict() == {"all-reduce": ar, "all-gather": ag}
    assert col.seconds == pytest.approx((ar + ag) / RL.LINK_BW, rel=1e-12)


@pytest.mark.parametrize("carry", ["sp", "dp"])
def test_train_collectives_by_hand(carry):
    """Pretrain (always FSDP), batch 8 (4 a replica, 2 microbatches),
    seq 16: every matrix sharded over data and model is gathered twice a
    microbatch (forward, remat) and its gradient reduce-scattered once;
    norms and sigmas are replicated and all-reduced; the activations per
    carry; the logits' row statistics."""
    cfg = dataclasses.replace(TINY_CFG, had=HADConfig(enabled=False))
    shape = M.ShapeSpec("t", 16, 8, "train")
    state = D.train_state(cfg, torch.device("meta"))
    col, saved = MC.train_collectives(cfg, state, shape, MESH_2X4,
                                      fsdp=True, carry=carry, accum=2)
    # matrices (elements): embed 32x8, wq wk wv wo 8x8, w1 w3 8x16, w2
    # 16x8, lm_head 8x32: 1152 float32 over 8 chips = 576 B a chip, and
    # gathered over the data pair: 576 B each time
    fsdp_ag = 576 * 2 * 2                     # x (fwd + remat) x accum
    rs = 576 * 2                              # x accum
    # norm1, norm2, final (8 floats each) and the two sigma scalars
    replicated = 3 * 8 * 4 + 2 * 4
    ar_norms = 2 * replicated * 1 / 2 * 2     # x accum
    act = 2 * 16 * 8 * 4                      # microbatch 2, seq, d, f32
    tp = act * 3 / 4 * 2 * 3 * 2              # sublayers, passes, accum
    # rows x 2 floats, forward and backward, each microbatch
    stats = 2 * (2 * 16 * 2 * 4) * 3 / 4 * 2 * 2
    want = {"all-gather": fsdp_ag, "reduce-scatter": rs,
            "all-reduce": ar_norms + stats}
    if carry == "sp":
        want["all-gather"] += tp
        want["reduce-scatter"] += tp
    else:
        want["all-reduce"] += 2 * tp
    assert col.as_dict() == pytest.approx(want, rel=1e-12)
    assert saved == act // (4 if carry == "sp" else 1)


# ---------------------------------------------------------------------------
# XLA's own arguments, once
# ---------------------------------------------------------------------------

def test_arguments_equal_xla_memory_analysis(capsys):
    """Reduced smollm-135m's train and decode cells compiled by JAX's dry
    run on a 2x4 mesh of host devices: XLA's per-device argument bytes
    equal the port's less the trash positions (serve) and the labels the
    distill step never reads (jit drops unused arguments), plus JAX's
    scalar pos (serve; the port's step takes a [B] vector, not priced)."""
    code = (
        "import json\n"
        "import jax\n"
        "import numpy as np\n"
        "assert len(jax.devices()) == 8\n"
        "from jax.sharding import Mesh\n"
        "from repro.launch import dryrun as JD\n"
        "from repro.launch import hlo_cost as HC\n"
        "from repro.configs import get_config\n"
        "from repro.models import model as M\n"
        "cfg = get_config('smollm-135m', reduced=True)\n"
        "mesh = Mesh(np.array(jax.devices()).reshape(2, 4),\n"
        "            ('data', 'model'))\n"
        "out = {}\n"
        "for kind in ('train', 'decode'):\n"
        "    shape = M.ShapeSpec(kind, 64, 8, kind)\n"
        "    lower = JD.lower_train if kind == 'train' else JD.lower_serve\n"
        "    comp = lower(cfg, shape, mesh)[0].compile()\n"
        "    coll = HC.module_cost(comp.as_text()).collective\n"
        "    out[kind] = {'args': int(\n"
        "        comp.memory_analysis().argument_size_in_bytes),\n"
        "        'collectives': {k: v for k, v in coll.items() if v}}\n"
        "print(json.dumps(out))\n")
    xla = _subprocess(code, devices=8)
    cfg = get_config("smollm-135m", reduced=True)
    for kind in ("train", "decode"):
        shape = M.ShapeSpec(kind, 64, 8, kind)
        rec = D.run_mesh_cell("smollm-135m", kind, multi_pod=False, cfg=cfg,
                              shape=shape, mesh=MESH_2X4)
        parts = rec["memory"]["arguments"]
        if kind == "train":
            labels = 8 * 64 * 4 // 2
            want = rec["memory"]["argument_size_in_bytes"] - labels
        else:
            want = (rec["memory"]["argument_size_in_bytes"] - parts["trash"]
                    + 4)
        assert xla[kind]["args"] == want, (kind, xla[kind], parts)
        with capsys.disabled():
            print(f"\n{kind}: XLA collectives {xla[kind]['collectives']}; "
                  f"port formulas {rec['collectives']}")


# ---------------------------------------------------------------------------
# bf16 attention
# ---------------------------------------------------------------------------

def test_bf16_distill_step_equals_jax():
    """One distill step (stage 1) with the attention logit blocks in
    bfloat16, from JAX's weights and batch: loss and KLs within 2e-2
    relative (bf16 keeps 8 bits of mantissa: the logits differ by ~4e-3
    relative between XLA's and ATen's bf16 products, and top-N can take a
    different key at a near tie); the student after the step: 99% of its
    elements within 1e-4, every one within 2e-3 (AdamW's first step moves
    an element by lr = 1e-3 along its gradient's sign, so an element whose
    bf16 gradient is at noise level and flips sign lands 2 lr away)."""
    from repro.core import attention as JA
    from repro.core.distill import DistillConfig as JDistillConfig
    from repro.core.distill import tiny_schedule as jtiny
    from repro.train import steps as JSTEPS
    from repro_torch.core.distill import DistillConfig, tiny_schedule
    from repro_torch.optim import adam
    from repro_torch.train import steps as STEPS

    jcfg = jget_config("smollm-135m", reduced=True)
    cfg = get_config("smollm-135m", reduced=True)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
             for k in ("tokens", "labels")}
    jopt = jadam.AdamWConfig()
    jstate = JSTEPS.init_distill_state(jax.random.PRNGKey(0), jcfg, jopt,
                                       teacher=params)
    dcfg = dict(lr_stages_123=1e-3, lr_stage_4=1e-4)
    old = JA.ATTN_DTYPE
    try:
        JA.set_attn_compute_dtype(jnp.bfloat16)
        jfn = JSTEPS.build_distill_step(
            jcfg, JDistillConfig(schedule=jtiny(2), **dcfg), jopt, topn=8)
        jnew, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jm = {k: float(v) for k, v in jm.items()}
    finally:
        JA.set_attn_compute_dtype(old)
    assert JA.ATTN_DTYPE == old

    def port(attn_dtype):
        model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
        state = STEPS.init_distill_state(cfg, adam.AdamWConfig(),
                                         teacher=model, device="cpu")
        fn = STEPS.build_distill_step(
            cfg, DistillConfig(schedule=tiny_schedule(2), **dcfg),
            adam.AdamWConfig(), topn=8, attn_dtype=attn_dtype)
        new, m = fn(state, {k: torch.from_numpy(v)
                            for k, v in batch.items()})
        return STEPS.state_tree(new), {k: float(v) for k, v in m.items()}

    tree, tm = port(torch.bfloat16)
    _, tm32 = port(torch.float32)
    for k in ("loss", "att_kl", "out_kl"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=2e-2, err_msg=k)
    # the bf16 path is taken: its attention KL is not float32's
    assert tm["att_kl"] != tm32["att_kl"]
    from repro.checkpoint.manager import _flatten
    from repro_torch.checkpoint.manager import _flatten as tflat
    want = _flatten(jax.tree.map(np.asarray, jnew["student"]))
    got = tflat(tree["student"])
    assert set(got) == set(want)
    close = total = 0
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=2e-3,
                                   err_msg=key)
        close += int((np.abs(got[key] - want[key]) <= 1e-4).sum())
        total += got[key].size
    assert close >= 0.99 * total, (close, total)


def test_kernel_entries_on_meta():
    """Each ``kernels.ops`` entry on meta tensors: an empty output of the
    right shape, and the work of a fully valid call reported through
    ``kernels.cost`` (nothing read: the lengths passed are meta too)."""
    from repro_torch.kernels import cost as KC
    from repro_torch.kernels import ops

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    b, h, hk, w, s, t, dv, page, nb = 2, 4, 2, 2, 8, 33, 16, 8, 4
    lens = meta(b)
    cases = [
        (lambda: ops.decode_attention(
            meta(b, h, w), meta(b, hk, w, t), meta(b, hk, t, dv,
                                                   dtype=torch.bfloat16),
            d=64, nsel=8, scale=1.0, lengths=lens, bitplanes=True),
         (b, h, dv), KC.k4_work(rows=b * hk, g=2, w=w, dv=dv, v_bytes=2,
                                lengths=[t - 1] * (b * hk))),
        (lambda: ops.prefill_attention(
            meta(b, h, s, w), meta(b, hk, t, w), meta(b, hk, t, dv,
                                                      dtype=torch.float32),
            d=64, nsel=8, scale=1.0, kv_length=lens, q_offset=lens,
            q_length=lens),
         (b, h, s, dv), KC.k1_work(rows=b * h, s=s, w=w, dv=dv, v_bytes=4,
                                   group_size=2, kv_length=[s] * (b * h),
                                   q_offset=[0] * (b * h),
                                   q_length=[s] * (b * h), causal=True)),
        (lambda: ops.paged_decode_attention(
            meta(b, h, w), meta(9, hk, w, page), meta(9, hk, page, dv,
                                                      dtype=torch.float32),
            meta(b, nb), d=64, nsel=8, scale=1.0, lengths=lens),
         (b, h, dv), KC.k2_work(rows=b * hk, g=2, w=w, dv=dv, v_bytes=4,
                                nb=nb, counts=[[page] * nb] * (b * hk))),
        (lambda: ops.hamming_scores(meta(3, 5, w), meta(3, 7, w), 64),
         (3, 5, 7), KC.k5_work(batch=3, m=5, n=7, w=w)),
    ]
    class Works:
        """A counter that keeps only what the kernels report."""
        def __init__(self):
            self.added = []

        def mute(self):
            pass

        def unmute(self):
            pass

        def add_kernel(self, name, flops, nbytes):
            self.added.append((flops, nbytes))

    for call, shape, work in cases:
        works = Works()
        KC.counters.append(works)
        try:
            out = call()
        finally:
            KC.counters.remove(works)
        assert out.is_meta and tuple(out.shape) == shape
        assert works.added == [work]


def test_table_of_mesh_records(tmp_path, capsys):
    """`--table DIR --mesh single` prints production-mesh records with
    the per-chip columns; the default (`--mesh card`) the card's."""
    cfg = get_config("smollm-135m", reduced=True)
    for kind in ("train", "decode"):
        rec = D.run_mesh_cell("smollm-135m", kind, multi_pod=False, cfg=cfg,
                              shape=M.ShapeSpec(kind, 64, 8, kind),
                              mesh=MESH_2X4)
        (tmp_path / f"{kind}.json").write_text(json.dumps(rec))
    assert D.main(["--table", str(tmp_path), "--mesh", "single"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "args GB/chip" in out[0] and len(out) == 4
    assert all(line.startswith("| smollm-135m |") for line in out[2:])


def test_train_group_shape_is_the_training_dispatch(monkeypatch):
    """`moe.train_group_shape` is what `moe_ffn_train` dispatches with:
    the expert buffer's groups, tokens a group and capacity, at reduced
    dbrx's widths (the mesh pricing's all-to-all reads it)."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    cfg = get_config("dbrx-132b", reduced=True)
    gen = torch.Generator().manual_seed(0)
    model = T.init_params(cfg, gen)
    ffn = next(b.ffn for b in model.blocks if isinstance(b.ffn, moe.MoE))
    seen = []
    real = moe._experts

    def spy(p, xg, gates, experts, cap, cfg_):
        seen.append((xg.shape[0], xg.shape[1], cap))
        return real(p, xg, gates, experts, cap, cfg_)
    monkeypatch.setattr(moe, "_experts", spy)
    for b, s in ((2, 64), (3, 40), (1, 7)):
        seen.clear()
        moe.moe_ffn_train(ffn, torch.randn(b, s, cfg.d_model,
                                           generator=gen), cfg=cfg)
        assert seen == [moe.train_group_shape(b * s, cfg)]
