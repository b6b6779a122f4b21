"""Tensor-parallel serving in the port against one device and the JAX
package, on the CPU over gloo.

In this process (``tests/test_mesh_serving.py``'s units on the port):
`make_host_mesh`'s errors, the duck-typed `mesh_model_size`, the GQA
divisibility gate with its pure-SSM exemption, the model == 1 mesh being
inert; the port's sharding rules equal to ``repro.distributed.sharding``'s
(`serve_param_spec`, `serve_cache_spec`, `param_spec`, `cache_spec`,
`batch_spec`) leaf by leaf over every assigned arch's reduced trees, on a
1 x 2 and a 16 x 16 abstract mesh (no devices); `shard_model` slicing.

Spawned ranks (``launch.mesh.spawn``, a ``FileStore`` under the test's
temporary directory, one spawn group per mesh size for the whole module,
every rank joined within `RANK_TIMEOUT`): ``tests/mesh_parity_main.py``'s
15 serving cases at tp 2 (and its three tp 4 cases at tp 4), each run
unsharded and tensor-parallel on the ranks' rank 0. Tokens equal the
unsharded port's and the JAX single-device Engine's (the JAX side on its
jnp path for the "binary-jnp" and fp cases, on its Pallas kernels in
interpret mode for the "kernel" cases; the port has one binary path,
whose page selection is the kernel's, per slot and kv head). Also: 2 step
graphs under TP, per-rank cache bytes x tp == total, the swap blobs of a
tp 2 run byte-equal to the unsharded run's, reduced llama-3.2-vision-11b
with images and reduced jamba-1.5-large-398b (MoE and SSM replicated) at
tp 2, and `psum_compressed` against JAX's under ``shard_map`` (a
subprocess with forced host devices, as the JAX suite runs). On the card
(`cuda` marker): a tensor-parallel runner without eager=True raises.
"""
import asyncio
import dataclasses
import hashlib
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import params_from_numpy
from repro_torch.checkpoint.bridge import shard_model
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.compression import (CompressionConfig,
                                                 psum_compressed)
from repro_torch.launch.mesh import make_host_mesh, start
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_params
from repro_torch.launch import serve as launch
from repro_torch.serve import AsyncEngine, Engine, ServeConfig
from repro_torch.serve.runner import ModelRunner
from repro_torch.serve.validate import mesh_model_size, validate_serve_mesh

RANK_TIMEOUT = 240.0

# tests/mesh_parity_main.py's models, in the port's config
CFG_KW = dict(name="mesh", family="dense", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab_size=64, head_dim=16,
              param_dtype="float32", q_block=16, remat=False)
CFG = ModelConfig(**CFG_KW)
CFG4 = dataclasses.replace(CFG, n_kv_heads=4)
PROMPT_LENS = (11, 7, 14, 9)
GEN = 5
PSUM_SHAPES = {"a": (5, 3), "b": (7,), "c": (4, 4)}


def _fake_mesh(model: int):
    """A mesh stand-in exposing .shape (and no group): validate.py is
    duck-typed."""
    return types.SimpleNamespace(shape={"data": 1, "model": model},
                                 group=None)


# ---------------------------------------------------------------------------
# in-process units
# ---------------------------------------------------------------------------

def test_host_mesh_rejects_oversubscription():
    with pytest.raises(ValueError, match="visible"):
        make_host_mesh(data=1, model=2)
    with pytest.raises(ValueError, match="init_process_group"):
        make_host_mesh(data=2, model=1)


def test_host_mesh_rejects_bad_axes():
    with pytest.raises(ValueError, match="model axis"):
        make_host_mesh(model=0)
    with pytest.raises(ValueError, match="data axis"):
        make_host_mesh(data=0, model=1)


def test_host_mesh_default_data_axis():
    mesh = make_host_mesh()
    assert dict(mesh.shape) == {"data": 1, "model": 1}
    assert mesh.group is None and mesh.rank == 0


def test_mesh_model_size_duck_typed():
    assert mesh_model_size(ServeConfig(max_len=32, batch_slots=1)) == 1
    scfg = ServeConfig(max_len=32, batch_slots=1, mesh=_fake_mesh(4))
    assert mesh_model_size(scfg) == 4
    bad = ServeConfig(max_len=32, batch_slots=1,
                      mesh=types.SimpleNamespace(shape=7))
    with pytest.raises(ValueError, match="model"):
        mesh_model_size(bad)


def test_validate_serve_mesh_gqa_divisibility():
    scfg = ServeConfig(max_len=32, batch_slots=1, mesh=_fake_mesh(3))
    with pytest.raises(ValueError, match="n_kv_heads"):
        validate_serve_mesh(CFG, scfg)
    validate_serve_mesh(CFG, ServeConfig(max_len=32, batch_slots=1,
                                         mesh=_fake_mesh(2)))
    validate_serve_mesh(CFG, ServeConfig(max_len=32, batch_slots=1))


def test_validate_serve_mesh_pure_ssm_is_exempt():
    ssm_cfg = ModelConfig(name="meshssm", family="ssm", n_layers=2,
                          d_model=32, n_heads=0, n_kv_heads=0, d_ff=0,
                          vocab_size=64, ssm_state=16, layer_pattern="M",
                          param_dtype="float32", remat=False)
    validate_serve_mesh(ssm_cfg, ServeConfig(max_len=32, batch_slots=1,
                                             mesh=_fake_mesh(3)))


def _model(cfg=CFG, seed=0):
    return init_params(cfg, torch.Generator().manual_seed(seed))


def test_engine_rejects_indivisible_mesh():
    scfg = ServeConfig(max_len=32, batch_slots=1, paged=True, page_size=8,
                       mesh=_fake_mesh(3))
    with pytest.raises(ValueError, match="n_kv_heads"):
        Engine(CFG, _model(), scfg, device="cpu")


def test_single_device_mesh_is_inert():
    """model axis 1: the runner keeps the whole model and gives the no-mesh
    tokens."""
    model = _model()
    prompts = [np.arange(9) % CFG.vocab_size, np.arange(5) % CFG.vocab_size]

    def toks(mesh):
        eng = Engine(CFG, model, ServeConfig(
            max_len=32, batch_slots=2, topn=6, prefill_chunk=8, paged=True,
            page_size=8, mesh=mesh), device="cpu")
        assert eng.runner.model is model
        ids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        out = eng.run()
        return [out[i].tolist() for i in ids]

    assert toks(make_host_mesh(data=1, model=1)) == toks(None)


@pytest.mark.cuda
def test_cuda_mesh_runner_needs_eager():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the check is of a runner on the "
                    "card")
    scfg = ServeConfig(max_len=32, batch_slots=1, paged=True, page_size=8,
                       mesh=_fake_mesh(2))
    with pytest.raises(ValueError, match="item 2a"):
        ModelRunner(CFG, _model(), scfg, {}, device="cuda")


def test_shard_model_slices_heads_and_vocab():
    """Each rank's wq / wk / wv columns and lm_head vocabulary slice, the
    rest whole, under the per-rank config."""
    cfg = get_config("smollm-135m", reduced=True, n_layers=2)
    model = _model(cfg)
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2})
    for rank in range(2):
        local = shard_model(model, mesh, rank)
        assert (local.cfg.n_heads, local.cfg.n_kv_heads, local.cfg.dh) == (
            cfg.n_heads // 2, cfg.n_kv_heads // 2, cfg.dh)
        for full, part in zip(model.blocks, local.blocks):
            for name in ("wq", "wk", "wv"):
                w = getattr(full.mixer, name)
                n = w.shape[1] // 2
                assert torch.equal(getattr(part.mixer, name),
                                   w[:, rank * n:(rank + 1) * n])
            assert torch.equal(part.mixer.wo, full.mixer.wo)
            assert torch.equal(part.ffn.w1, full.ffn.w1)
            assert part.mixer.scale == full.mixer.scale
        v = cfg.padded_vocab // 2
        assert torch.equal(local.lm_head,
                           model.lm_head[:, rank * v:(rank + 1) * v])
        assert torch.equal(local.embed, model.embed)
        assert not any(t.is_meta for t in local.parameters())


# ---------------------------------------------------------------------------
# the sharding rules against the JAX package's
# ---------------------------------------------------------------------------

def _jax_meshes():
    from jax.sharding import AbstractMesh
    return {"1x2": (AbstractMesh((1, 2), ("data", "model")),
                    sharding.AbstractMesh((1, 2), ("data", "model"))),
            "16x16": (AbstractMesh((16, 16), ("data", "model")),
                      sharding.AbstractMesh((16, 16), ("data", "model"))),
            "2x16x16": (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                        sharding.AbstractMesh((2, 16, 16),
                                              ("pod", "data", "model")))}


def _spec_or_error(fn):
    try:
        return tuple(fn())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_specs_equal_jax_leaf_by_leaf(arch):
    import jax
    from repro.configs import get_config as jget_config
    from repro.distributed import sharding as jsh
    from repro.models import model as JM
    jcfg = jget_config(arch, reduced=True)
    params = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    caches = {}
    for paged in (False, True):
        for binary in (False, True):
            kw = dict(paged=True, n_pages=6, page_size=8) if paged else {}
            if "M" in jcfg.layer_pattern or "C" in jcfg.layer_pattern:
                kw.update(state_pages=4 if paged else None)
            caches[(paged, binary)] = jax.eval_shape(
                lambda kw=kw, b=binary: JM.init_caches(jcfg, 2, 32, binary=b,
                                                       **kw))
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    n = 0
    for jmesh, mesh in _jax_meshes().values():
        for path, leaf in leaves:
            want = _spec_or_error(lambda: jsh.serve_param_spec(path, leaf,
                                                               jmesh))
            got = _spec_or_error(lambda: sharding.serve_param_spec(
                path, leaf.shape, mesh))
            assert got == want, (path, "serve")
            for fsdp in (True, False):
                want = tuple(jsh.param_spec(path, leaf, jmesh,
                                            fsdp_enabled=fsdp))
                got = tuple(sharding.param_spec(path, leaf.shape, mesh,
                                                fsdp_enabled=fsdp))
                assert got == want, (path, fsdp)
            n += 1
        for tree in caches.values():
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                want = _spec_or_error(lambda: jsh.serve_cache_spec(
                    path, leaf, jmesh))
                got = _spec_or_error(lambda: sharding.serve_cache_spec(
                    path, leaf.shape, mesh))
                assert got == want, (path, "serve cache")
                for gb in (1, 2, 32, 512):
                    want = tuple(jsh.cache_spec(path, leaf, jmesh,
                                                global_batch=gb))
                    got = tuple(sharding.cache_spec(path, leaf.shape, mesh,
                                                    global_batch=gb))
                    assert got == want, (path, gb)
                    jb = jsh.batch_spec(leaf, jmesh, global_batch=gb).spec
                    assert tuple(sharding.batch_spec(
                        leaf.shape, mesh, global_batch=gb)) == tuple(jb)
                n += 1
    assert n > 0
    # the tree wrappers agree with the leaf rules
    _, mesh = _jax_meshes()["1x2"]
    tree = jax.tree.map(lambda x: np.zeros(x.shape, np.int8), params) \
        if arch == "smollm-135m" else None
    if tree is not None:
        specs = sharding.serve_param_specs(tree, mesh)
        assert specs["blocks"]["pos0"]["mixer"]["wq"] == (None, None,
                                                          "model")
        assert specs["embed"] == ()
        pools = sharding.serve_cache_specs(
            jax.tree.map(lambda x: np.zeros(x.shape, np.int8),
                         caches[(True, True)]), mesh)
        assert pools["pos0"]["k_bits"] == (None, None, "model")


def test_shard_tensor_and_shapes():
    mesh = sharding.AbstractMesh((2, 4), ("data", "model"))
    full = torch.arange(8 * 12).reshape(8, 12)
    spec = sharding.Spec(("data",), "model")
    assert spec == ("data", "model")
    assert sharding.shard_shape(full.shape, spec, mesh) == (4, 3)
    for rank in range(8):
        d, m = divmod(rank, 4)
        assert torch.equal(sharding.shard_tensor(full, spec, mesh, rank),
                           full[d * 4:(d + 1) * 4, m * 3:(m + 1) * 3])
    both = sharding.Spec(None, ("data", "model"))
    assert torch.equal(sharding.shard_tensor(full[:, :8], both, mesh, 5),
                       full[:, 5:6])


# ---------------------------------------------------------------------------
# serving on spawned ranks
# ---------------------------------------------------------------------------

def _scfg(binary, mesh=None, **kw):
    """mesh_parity_main's ServeConfig."""
    kw.setdefault("paged", True)
    kw.setdefault("page_size", 8)
    return dict(max_len=48, batch_slots=2, binary=binary, topn=6,
                prefill_chunk=8, mesh=mesh, **kw)


# name -> (model, ServeConfig fields, `_drive` options, JAX reference path)
# (mesh_parity_main's cases; "jnp" / "kernel": which JAX path the tokens
# are held against). The port's binary page-sparse decode selects pages
# per slot and kv head, as JAX's kernel path does (its jnp path takes one
# selection a slot), so binary page-sparse cases are held against the
# kernel path.
CASES = {
    "binary-jnp paged": ("cfg", _scfg(True), {}, "jnp"),
    "kernel paged": ("cfg", _scfg(True), {}, "kernel"),
    "fp paged": ("cfg", _scfg(False), {}, "jnp"),
    "binary-jnp dense": ("cfg", _scfg(True, paged=False), {}, "jnp"),
    "prefix-warm binary": ("cfg", _scfg(True, prefix_cache=True),
                           {"warm_pass": True}, "jnp"),
    "prefix-warm kernel": ("cfg", _scfg(True, prefix_cache=True),
                           {"warm_pass": True}, "kernel"),
    "swap-restored binary": ("cfg", _scfg(True, n_pages=4, swap_pages=32),
                             {}, "jnp"),
    "swap-restored fp": ("cfg", _scfg(False, n_pages=4, swap_pages=32), {},
                         "jnp"),
    "page-sparse binary-jnp": ("cfg", _scfg(True, page_topn=2), {},
                               "kernel"),
    "page-sparse kernel": ("cfg", _scfg(True, page_topn=2), {}, "kernel"),
    "page-sparse fp": ("cfg", _scfg(False, page_topn=2), {}, "jnp"),
    "pipelined binary": ("cfg", _scfg(True, prefix_cache=True,
                                      swap_pages=32),
                         {"pipelined": True}, "jnp"),
    # not a mesh_parity_main case: the asyncio front end on rank 0 (its
    # steps run in a worker thread, which sends the plans)
    "asyncio binary": ("cfg", _scfg(True, n_pages=4, swap_pages=32),
                       {"asyncio_front": True}, "jnp"),
}
CASES4 = {
    "binary-jnp paged x4": ("cfg4", _scfg(True), {}, "jnp"),
    "kernel paged x4": ("cfg4", _scfg(True), {}, "kernel"),
    "page-sparse x4": ("cfg4", _scfg(True, page_topn=2), {}, "kernel"),
}


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, CFG.vocab_size, size=s) for s in PROMPT_LENS]


def _blob_digests(eng) -> list:
    """Spy on the runner's swap-outs: the sha1 of every stored blob leaf."""
    seen = []
    out = eng.runner._swap_out_pages

    def spy(rid, pages, state_page=-1):
        out(rid, pages, state_page)
        seen.append([hashlib.sha1(t.contiguous().view(torch.uint8).numpy()
                                  .tobytes()).hexdigest()
                     for layer in eng.runner._swap_store[rid]
                     for t in layer.values()])
    eng.runner._swap_out_pages = spy
    return seen


def _run_async(eng, prompts, gen, extras) -> tuple[list, dict]:
    """The requests through an AsyncEngine over `eng`, all submitted from
    the event loop before its first step: (ids, tokens by id), the ids
    in submission order."""
    async def go():
        aeng = AsyncEngine(eng)
        handles = [await aeng.submit(p, max_new_tokens=gen, extra=e)
                   for p, e in zip(prompts, extras)]
        runner = asyncio.ensure_future(aeng.run())
        out = [await h.result() for h in handles]
        aeng.stop()
        await runner
        return list(range(len(out))), dict(enumerate(out))
    return asyncio.run(go())


def _drive(cfg, model, scfg_kw, prompts, gen, *, mesh=None, extras=None,
           pipelined=False, warm_pass=False,
           asyncio_front=False) -> dict | None:
    """Serve `prompts` to completion (twice with warm_pass, the second
    pass's tokens kept; through an AsyncEngine with asyncio_front). On a
    mesh's other ranks, follow rank 0 and return None."""
    eng = Engine(cfg, model, ServeConfig(**dict(scfg_kw, mesh=mesh)),
                 device="cpu")
    if mesh is not None and mesh.model_rank != 0:
        eng.serve_worker()
        return None
    blobs = _blob_digests(eng)
    extras = extras or [None] * len(prompts)
    try:
        for _ in range(2 if warm_pass else 1):
            if asyncio_front:
                ids, out = _run_async(eng, prompts, gen, extras)
                continue
            ids = [eng.submit(p, max_new_tokens=gen, extra=e)
                   for p, e in zip(prompts, extras)]
            out = eng.run_pipelined() if pipelined else eng.run()
        eng.check()
    finally:
        eng.close()
    return dict(tokens=[out[i].tolist() for i in ids],
                stats=dict(eng.stats), graphs=eng.runner.graph_count(),
                bytes=eng.runner.cache_device_bytes(), blobs=blobs)


def _rank_cases(tp: int, cases: list) -> dict:
    """One rank of the module's spawn group: every case served unsharded
    (rank 0 only) and over the tp-rank mesh; rank 0 returns both results
    by case name."""
    torch.set_num_threads(1)
    mesh = make_host_mesh(data=1, model=tp)
    out = {}
    for case in cases:
        name = case["name"]
        if name.startswith("psum"):
            out[name] = _rank_psum(mesh, case["method"])
            continue
        cfg = case["cfg"]
        model = (params_from_numpy(case["tree"], cfg) if "tree" in case
                 else init_params(cfg, torch.Generator().manual_seed(0)))
        kw = dict(scfg_kw=case["scfg"], prompts=case["prompts"],
                  gen=case["gen"], extras=case.get("extras"),
                  **case["opts"])
        one = (_drive(cfg, model, mesh=None, **kw) if mesh.model_rank == 0
               else None)
        out[name] = (one, _drive(cfg, model, mesh=mesh, **kw))
    return out if mesh.model_rank == 0 else {}


def _psum_inputs(rank: int) -> dict:
    rng = np.random.default_rng(100 + rank)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in PSUM_SHAPES.items()}


def _rank_psum(mesh, method):
    tree = {k: torch.from_numpy(v)
            for k, v in _psum_inputs(mesh.rank).items()}
    out = psum_compressed(tree, mesh.group, CompressionConfig(method=method))
    return {k: v.numpy() for k, v in out.items()}


def _jax_tree(cfg_kw, seed):
    import jax
    from repro.models import ModelConfig as JModelConfig
    from repro.models import model as JM
    params = JM.init_params(jax.random.PRNGKey(seed), JModelConfig(**cfg_kw))
    return jax.tree.map(np.asarray, params)


class _Group:
    """A spawn group, running while this process computes the JAX
    references; `result()` joins it once (a failure is raised again at
    every later call)."""

    def __init__(self, tp, cases, tmp):
        self.ranks = start(_rank_cases, tp, tp, cases, timeout=RANK_TIMEOUT,
                           tmp_dir=str(tmp))
        self._out = self._err = None

    def result(self) -> dict:
        if self._out is None and self._err is None:
            try:
                self._out = self.ranks.join()[0]
            except BaseException as e:
                self._err = e
        if self._err is not None:
            raise self._err
        return self._out


def _vision_jamba_cases():
    out = []
    vcfg = get_config("llama-3.2-vision-11b", reduced=True)
    rng = np.random.default_rng(9)
    img = [{"image_embeds": rng.normal(size=(
        1, vcfg.n_image_tokens, vcfg.frontend_dim)).astype(np.float32)}
        if i % 2 == 0 else None for i in range(4)]
    vprompts = [rng.integers(0, vcfg.vocab_size, n) for n in (13, 9, 20, 6)]
    for name, kw in (("vision paged", dict(paged=True, page_size=8)),
                     ("vision dense", dict(paged=False)),
                     ("vision fp swap", dict(paged=True, page_size=8,
                                             binary=False, n_pages=4,
                                             swap_pages=32))):
        base = dict(max_len=48, batch_slots=2, binary=True, topn=6,
                    prefill_chunk=8)
        out.append(dict(name=name, cfg=vcfg, scfg=dict(base, **kw),
                        prompts=vprompts, gen=5, extras=img, opts={}))
    jcfg = get_config("jamba-1.5-large-398b", reduced=True)
    jprompts = [rng.integers(0, jcfg.vocab_size, n) for n in (12, 21, 7)]
    for name, kw in (("jamba paged", dict(paged=True, page_size=8)),
                     ("jamba dense", dict(paged=False))):
        base = dict(max_len=48, batch_slots=2, binary=True, topn=6,
                    prefill_chunk=8)
        out.append(dict(name=name, cfg=jcfg, scfg=dict(base, **kw),
                        prompts=jprompts, gen=4, opts={}))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both spawn groups, started at once: tp 2 (mesh_parity_main's tp-2
    cases, vision, jamba, psum) and tp 4 (its tp-4 cases, psum)."""
    trees = {"cfg": _jax_tree(CFG_KW, 0),
             "cfg4": _jax_tree(dict(CFG_KW, n_kv_heads=4), 1)}
    cfgs = {"cfg": CFG, "cfg4": CFG4}

    def cases(table):
        return [dict(name=name, cfg=cfgs[m], tree=trees[m], scfg=scfg,
                     prompts=_prompts(), gen=GEN, opts=opts)
                for name, (m, scfg, opts, _) in table.items()]

    psum = [dict(name=f"psum {m}", method=m)
            for m in ("none", "onebit", "int8")]
    tmp = tmp_path_factory.mktemp("ranks")
    groups = {2: _Group(2, cases(CASES) + _vision_jamba_cases() + psum, tmp),
              4: _Group(4, cases(CASES4) + psum, tmp)}
    yield dict(groups, trees=trees)
    for g in groups.values():
        g.ranks.kill()


def _jax_tokens(name, table, trees):
    """The JAX single-device Engine's tokens of a case (mesh_parity_main's
    `drive`; the asyncio case's, as a synchronous run: greedy tokens do
    not depend on the stepping)."""
    import jax
    from repro.models import ModelConfig as JModelConfig
    from repro.models.config import HADConfig as JHADConfig
    from repro.serve import Engine as JEngine
    from repro.serve import ServeConfig as JServeConfig
    m, scfg, opts, path = table[name]
    jkw = dict(CFG_KW, n_kv_heads=4) if m == "cfg4" else dict(CFG_KW)
    if path == "kernel":
        jkw["had"] = JHADConfig(use_kernels=True, kernel_block_q=8,
                                kernel_block_t=16)
    params = jax.tree.map(jax.numpy.asarray, trees[m])
    eng = JEngine(JModelConfig(**jkw), params, JServeConfig(**scfg))
    for _ in range(2 if opts.get("warm_pass") else 1):
        ids = [eng.submit(p, max_new_tokens=GEN) for p in _prompts()]
        out = eng.run_pipelined() if opts.get("pipelined") else eng.run()
    return [out[i].tolist() for i in ids]


def _check_case(ranks, tp, table, name):
    want = _jax_tokens(name, table, ranks["trees"])
    one, got = ranks[tp].result()[name]
    assert one["tokens"] == want, (name, "unsharded port vs JAX")
    assert got["tokens"] == want, (name, f"tp {tp} vs JAX")
    assert got["stats"] == one["stats"], name
    assert got["graphs"] == 2 and one["graphs"] == 2, name
    total, per = got["bytes"]
    assert per * tp == total and total == one["bytes"][0], name
    assert got["blobs"] == one["blobs"], name
    return one, got


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_parity_tp2(ranks, name):
    one, got = _check_case(ranks, 2, CASES, name)
    if name.startswith("prefix-warm"):
        assert got["stats"]["cached_tokens"] > 0
    if name.startswith("swap"):
        assert got["stats"]["swap_outs"] > 0 and len(got["blobs"]) > 0


@pytest.mark.parametrize("name", list(CASES4))
def test_mesh_parity_tp4(ranks, name):
    _check_case(ranks, 4, CASES4, name)


@pytest.mark.parametrize("name", ["vision paged", "vision dense",
                                  "vision fp swap", "jamba paged",
                                  "jamba dense"])
def test_vision_and_jamba_tp2(ranks, name):
    """Cross layers (each rank fills its heads of the pooled or dense
    cross caches from the image) and SSM / MoE layers (replicated): tp 2
    tokens, counters and swap blobs equal the unsharded run's."""
    one, got = ranks[2].result()[name]
    assert got["tokens"] == one["tokens"] and got["stats"] == one["stats"]
    assert got["graphs"] == 2
    assert got["blobs"] == one["blobs"]
    total, per = got["bytes"]
    if name.startswith("vision"):
        assert per * 2 == total             # every cache leaf head-sharded
    else:
        assert per < total < 2 * per        # SSM state replicated
    if name == "vision fp swap":
        assert got["stats"]["swap_outs"] > 0


_JAX_PSUM = """
import os, sys
import jax, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed.compression import CompressionConfig, psum_compressed
n, out = int(sys.argv[1]), sys.argv[2]
mesh = Mesh(np.array(jax.devices()[:n]), ("pod",))
ins = [np.load(os.path.join(out, f"in{r}.npz")) for r in range(n)]
tree = {k: np.stack([i[k] for i in ins]) for k in ins[0].files}
res = {}
for method in ("none", "onebit", "int8"):
    def body(t, method=method):
        t = jax.tree.map(lambda x: x.reshape(x.shape[1:]), t)
        return jax.tree.map(lambda x: x.reshape((1,) + x.shape),
                            psum_compressed(t, "pod",
                                            CompressionConfig(method=method)))
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P("pod"),
                           out_specs=P("pod"), check_rep=False))
    for k, v in fn(tree).items():
        res[f"{method}/{k}"] = np.asarray(v)[0]
np.savez(os.path.join(out, "jax.npz"), **res)
"""


@pytest.mark.parametrize("tp", [2, 4])
def test_psum_compressed_equals_jax(ranks, tp, tmp_path):
    """Each rank's seeded float32 tree through `psum_compressed` (gloo)
    against JAX's under shard_map over `tp` forced host devices: the
    same integer payload sums and scales; float32 sums of tp terms of
    magnitude below 2 in another order, so allclose at rtol 1e-6 and atol
    1e-6 (a few ulps of 2)."""
    for r in range(tp):
        np.savez(tmp_path / f"in{r}.npz", **_psum_inputs(r))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(root, "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_force_"
                          f"host_platform_device_count={tp}").strip())
    res = subprocess.run([sys.executable, "-c", _JAX_PSUM, str(tp),
                          str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    want = np.load(tmp_path / "jax.npz")
    got = ranks[tp].result()
    for method in ("none", "onebit", "int8"):
        for k in PSUM_SHAPES:
            np.testing.assert_allclose(got[f"psum {method}"][k],
                                       want[f"{method}/{k}"], rtol=1e-6,
                                       atol=1e-6)


def test_launcher_mesh_model_serves_as_one_rank():
    """`--mesh-model 2` (two spawned ranks, gloo on the CPU) serves the
    tokens of `--mesh-model 1`."""
    argv = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
            "--paged", "--prompt-len", "16", "--gen", "3", "--slots", "2",
            "--requests", "3", "--prefill-chunk", "8", "--page-size", "8"]
    one = launch.main(argv)
    two = launch.main(argv + ["--mesh-model", "2"])
    assert {k: v.tolist() for k, v in two.items()} == \
        {k: v.tolist() for k, v in one.items()}
    with pytest.raises(SystemExit, match="mesh-model"):
        launch.main(argv + ["--mesh-model", "0"])
