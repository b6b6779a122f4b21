"""The port's serving slice against the JAX package.

Configs field for field, the weight bridge bit for bit, `serve_step`
logits (allclose) and k_bits caches (exactly) after the same prefill and
decode steps on the paged and the dense cache, the copied Scheduler plan
for plan, and greedy tokens and decode-traffic counters of the port's
Engine against the JAX Engine on reduced smollm-135m (paged, dense and
page-sparse). The JAX side runs its Pallas kernels in interpret mode, as
its own serving tests do. Also, inside the port: ragged == sequential
(with prefix caching, page-sparse decode and recompute preemption), dense
== paged bit for bit, the default device refusing to fall back to the
CPU, and the package importing no JAX. The
full-precision baseline's tests are in test_torch_baseline.py; swap-out
preemption's in test_torch_swap.py; pipelined and asyncio serving's, and
the rest of the Engine surface's, in test_torch_pipelined.py.
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

from repro.checkpoint.manager import CheckpointManager
from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.models import model as JM
from repro.models.config import HADConfig as JHADConfig
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro.serve import scheduler as JS
from repro_torch.checkpoint import load_npz, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve import scheduler as S

ARCH = "smollm-135m"
# ModelConfig fields of the port alone (granite-4.0-h-small's)
PORT_FIELDS = ("ssm_mixer", "shared_expert_width", "embedding_multiplier",
               "residual_multiplier", "attention_multiplier",
               "logits_scaling")
LOGIT_TOL = dict(rtol=1e-4, atol=2e-5)   # float32, XLA vs ATen sum order
JHAD = JHADConfig(use_kernels=True, kernel_block_q=8, kernel_block_t=16)


def _cfgs(**kw):
    """(JAX cfg on the Pallas kernel path, port cfg) — reduced smollm."""
    return (jget_config(ARCH, reduced=True, had=JHAD, **kw),
            get_config(ARCH, reduced=True, **kw))


@functools.lru_cache(maxsize=None)
def _params(n_layers=1, seed=0):
    jcfg, tcfg = _cfgs(n_layers=n_layers)
    pj = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, pj)
    return pj, tree


def _model(n_layers=1, seed=0):
    _, tcfg = _cfgs(n_layers=n_layers)
    return params_from_numpy(_params(n_layers, seed)[1], tcfg, device="cpu")


# ---------------------------------------------------------------------------
# config copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_config_copy_field_for_field(arch, reduced):
    """Every field the JAX package has, equal; the port's own fields (the
    published Mamba2 mixer, shared expert and multipliers of a model the
    JAX package lacks) at their defaults, which add no operation."""
    want = jget_config(arch, reduced=reduced)
    got = get_config(arch, reduced=reduced)
    got_d, want_d = dataclasses.asdict(got), dataclasses.asdict(want)
    own = {f.name: f.default for f in dataclasses.fields(got)
           if f.name not in want_d}
    assert set(own) == set(PORT_FIELDS)
    assert got_d == dict(want_d, **own)
    for prop in ("padded_vocab", "dh", "n_groups", "group_size",
                 "has_attention", "is_encoder", "d_inner", "ssm_heads"):
        assert getattr(got, prop) == getattr(want, prop), prop
    for ctx in (256, 4096, 100_000):
        assert got.had.topn(ctx) == want.had.topn(ctx)
    assert got.dtype == {"bfloat16": torch.bfloat16,
                         "float32": torch.float32}[want.param_dtype]


# ---------------------------------------------------------------------------
# weight bridge
# ---------------------------------------------------------------------------

def test_params_from_numpy_unstacks_layers():
    _, tree = _params(n_layers=2)
    model = _model(n_layers=2)
    blocks = tree["blocks"]["pos0"]
    for layer, blk in enumerate(model.blocks):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(getattr(blk.mixer, name).numpy(),
                                          blocks["mixer"][name][layer])
        for name in ("w1", "w2", "w3"):
            np.testing.assert_array_equal(getattr(blk.ffn, name).numpy(),
                                          blocks["ffn"][name][layer])
        np.testing.assert_array_equal(blk.norm1.w.numpy(),
                                      blocks["norm1"]["w"][layer])
    np.testing.assert_array_equal(model.embed.numpy(), tree["embed"])
    np.testing.assert_array_equal(model.lm_head.numpy(), tree["lm_head"])
    assert model.blocks[0].mixer.scale == np.float32(16 ** -0.5)


def test_load_npz_bfloat16_checkpoint_bit_exact(tmp_path):
    jcfg = jget_config(ARCH, reduced=True, param_dtype="bfloat16")
    tcfg = get_config(ARCH, reduced=True, param_dtype="bfloat16")
    pj = JM.init_params(jax.random.PRNGKey(3), jcfg)
    step_dir = CheckpointManager(str(tmp_path)).save(7, {"params": pj})
    model = params_from_numpy(load_npz(step_dir), tcfg)
    assert model.embed.dtype == torch.bfloat16
    want = np.asarray(pj["blocks"]["pos0"]["mixer"]["wq"][0])
    got = model.blocks[0].mixer.wq.view(torch.int16).numpy()
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    np.testing.assert_array_equal(
        model.lm_head.view(torch.int16).numpy().view(np.uint16),
        np.asarray(pj["lm_head"]).view(np.uint16))


# ---------------------------------------------------------------------------
# serve_step: logits allclose, k_bits pools exactly equal
# ---------------------------------------------------------------------------

def test_serve_step_logits_and_pools_match_jax():
    n_layers, b, page, nb, n_pages, chunk, n = 2, 2, 8, 4, 10, 8, 4
    jcfg, tcfg = _cfgs(n_layers=n_layers)
    pj, _ = _params(n_layers)
    model = _model(n_layers)
    jstep = jax.jit(functools.partial(JM.serve_step, cfg=jcfg, n=n,
                                      binary=True, logits_mode="last"))
    jcaches = JM.init_caches(jcfg, b, nb * page, binary=True, paged=True,
                             n_pages=n_pages, page_size=page)
    tcaches = T.init_caches(tcfg, paged=True, n_pages=n_pages,
                            page_size=page)
    bt = np.array([[3, 7, 9, -1], [0, 5, -1, -1]], np.int32)
    rng = np.random.default_rng(0)
    # (tokens, pos, active, n_valid): three prefill chunks interleaving
    # the two slots (inactive rows ride along), then two decode steps
    steps = []
    for slot, pos, nv in ((0, 0, 8), (1, 0, 5), (0, 8, 3)):
        tok = np.zeros((b, chunk), np.int32)
        tok[slot, :nv] = rng.integers(0, tcfg.vocab_size, nv)
        steps.append((tok, np.array([pos, pos], np.int32),
                      np.arange(b) == slot, np.where(np.arange(b) == slot,
                                                     nv, 0).astype(np.int32)))
    for pos in ((11, 5), (12, 6)):
        steps.append((rng.integers(0, tcfg.vocab_size, (b, 1)).astype(
            np.int32), np.array(pos, np.int32), np.ones(b, bool), None))
    for tok, pos, active, nv in steps:
        jl, jcaches = jstep(pj, {"tokens": jnp.asarray(tok)}, jcaches,
                            pos=jnp.asarray(pos), active=jnp.asarray(active),
                            n_valid=None if nv is None else jnp.asarray(nv),
                            block_tables=jnp.asarray(bt))
        tl = T.serve_step(model, torch.from_numpy(tok), tcaches,
                          pos=torch.from_numpy(pos), n=n,
                          block_tables=torch.from_numpy(bt),
                          active=torch.from_numpy(active),
                          n_valid=None if nv is None else torch.from_numpy(nv),
                          logits_mode="last")
        rows = np.flatnonzero(active)
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   **LOGIT_TOL)
    for layer in range(n_layers):
        jk = np.asarray(jcaches["pos0"]["k_bits"][layer])
        tk = tcaches[layer]["k_bits"][:n_pages].numpy().view(np.uint32)
        np.testing.assert_array_equal(tk, jk)
        assert jk.any()
        np.testing.assert_allclose(tcaches[layer]["v"][:n_pages].numpy(),
                                   np.asarray(jcaches["pos0"]["v"][layer]),
                                   rtol=1e-5, atol=1e-6)


def test_dense_serve_step_logits_and_cache_match_jax():
    """The dense cache: logits allclose and k_bits equal to JAX's on
    [0, max_len) after interleaved prefill chunks (inactive rows riding
    along) and decode steps; the trash position is the port's own."""
    n_layers, b, max_len, chunk, n = 2, 2, 24, 8, 4
    jcfg, tcfg = _cfgs(n_layers=n_layers)
    pj, _ = _params(n_layers)
    model = _model(n_layers)
    jstep = jax.jit(functools.partial(JM.serve_step, cfg=jcfg, n=n,
                                      binary=True, logits_mode="last"))
    jcaches = JM.init_caches(jcfg, b, max_len, binary=True)
    tcaches = T.init_caches(tcfg, paged=False, batch=b, max_len=max_len)
    rng = np.random.default_rng(1)
    steps = []
    for slot, pos, nv in ((0, 0, 8), (1, 0, 5), (0, 8, 3), (1, 5, 8)):
        tok = np.zeros((b, chunk), np.int32)
        tok[slot, :nv] = rng.integers(0, tcfg.vocab_size, nv)
        pos_v = np.array([pos, 0], np.int32)[::1 - 2 * slot].copy()
        steps.append((tok, pos_v, np.arange(b) == slot,
                      np.where(np.arange(b) == slot, nv, 0).astype(np.int32)))
    for pos in ((11, 13), (12, 14)):
        steps.append((rng.integers(0, tcfg.vocab_size, (b, 1)).astype(
            np.int32), np.array(pos, np.int32), np.ones(b, bool), None))
    for tok, pos, active, nv in steps:
        jl, jcaches = jstep(pj, {"tokens": jnp.asarray(tok)}, jcaches,
                            pos=jnp.asarray(pos), active=jnp.asarray(active),
                            n_valid=None if nv is None else jnp.asarray(nv))
        tl = T.serve_step(model, torch.from_numpy(tok), tcaches,
                          pos=torch.from_numpy(pos), n=n,
                          active=torch.from_numpy(active),
                          n_valid=None if nv is None else torch.from_numpy(nv),
                          logits_mode="last")
        rows = np.flatnonzero(active)
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   **LOGIT_TOL)
    for layer in range(n_layers):
        jk = np.asarray(jcaches["pos0"]["k_bits"][layer])
        tk = tcaches[layer]["k_bits"][..., :max_len].numpy().view(np.uint32)
        np.testing.assert_array_equal(tk, jk)
        assert jk.any()
        np.testing.assert_allclose(tcaches[layer]["v"][:, :, :max_len].numpy(),
                                   np.asarray(jcaches["pos0"]["v"][layer]),
                                   rtol=1e-5, atol=1e-6)


def test_dense_write_drops_padding_inactive_rows_and_overflow():
    tcfg = get_config(ARCH, reduced=True)
    cache = T.init_caches(tcfg, paged=False, batch=3, max_len=6)[0]
    from repro_torch.models.attention_block import _cache_write
    buf = cache["v"]                                 # [3, Hk, 7, Dh]
    new = torch.arange(1, 5, dtype=buf.dtype)[None, None, :, None].expand(
        3, buf.shape[1], 4, buf.shape[3])
    _cache_write(buf, new, torch.tensor([0, 4, 1]), axis=2,
                 n_valid=torch.tensor([2, 4, 3]),
                 active=torch.tensor([True, True, False]))
    got = buf[:, 0, :6, 0].tolist()
    assert got[0] == [1, 2, 0, 0, 0, 0]        # padding past n_valid dropped
    assert got[1] == [0, 0, 0, 0, 1, 2]        # positions past max_len dropped
    assert got[2] == [0] * 6                   # inactive row untouched


def test_paged_write_drops_minus_one_and_padding():
    tcfg = get_config(ARCH, reduced=True)
    cache = T.init_caches(tcfg, paged=True, n_pages=3, page_size=4)[0]
    from repro_torch.models.attention_block import _paged_cache_write
    pool = cache["v"]
    new = torch.ones((2, 6, pool.shape[1], pool.shape[3]))
    bt = torch.tensor([[2, -1], [1, 0]])
    _paged_cache_write(pool, new, torch.tensor([0, 2]), bt, offset_axis=2,
                       n_valid=torch.tensor([6, 3]),
                       active=torch.tensor([True, True]))
    # slot 0: tokens 0..3 -> page 2; tokens 4, 5 hit the -1 entry: dropped
    assert pool[2].eq(1).all()
    # slot 1: 3 valid tokens at positions 2, 3 (page 1) and 4 (page 0)
    assert pool[1, :, 2:].eq(1).all() and pool[1, :, :2].eq(0).all()
    assert pool[0, :, 0].eq(1).all() and pool[0, :, 1:].eq(0).all()


# ---------------------------------------------------------------------------
# Engine: greedy tokens vs the JAX Engine, ragged == sequential in-port
# ---------------------------------------------------------------------------

def _scfg(cls, slots, **kw):
    base = dict(max_len=48, batch_slots=slots, binary=True, topn=6,
                prefill_chunk=8, paged=True, page_size=8)
    base.update(kw)
    return cls(**base)


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lengths]


def _serve(eng, prompts, gen):
    ids = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    out = eng.run()
    return [out[i] for i in ids]


def test_engine_greedy_tokens_match_jax_engine():
    jcfg, tcfg = _cfgs()
    pj, _ = _params()
    prompts = _prompts((13, 5, 9, 20), seed=1)
    want = _serve(JEngine(jcfg, pj, _scfg(JServeConfig, 2)), prompts, 5)
    got = _serve(Engine(tcfg, _model(), _scfg(ServeConfig, 2), device="cpu"),
                 prompts, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [dict(paged=False), dict(page_topn=3)],
                         ids=["dense", "page_topn"])
def test_engine_greedy_tokens_match_jax_engine_on_new_paths(kw):
    """The dense cache (K4 decode, K1 over cache rows) and page-sparse
    decode (K3 + select_pages + K2 over compacted tables, with prompts
    long enough that pages are dropped): tokens and decode-traffic
    counters equal the JAX Engine's on its kernel path."""
    jcfg, tcfg = _cfgs()
    pj, _ = _params()
    prompts = _prompts((13, 5, 30, 20), seed=6)
    jeng = JEngine(jcfg, pj, _scfg(JServeConfig, 2, **kw))
    teng = Engine(tcfg, _model(), _scfg(ServeConfig, 2, **kw), device="cpu")
    want, got = _serve(jeng, prompts, 6), _serve(teng, prompts, 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for key in ("decode_steps", "decode_pages_touched", "decode_hbm_bytes"):
        assert teng.stats[key] == jeng.stats[key], key
    if "page_topn" in kw:
        assert 0 < teng.stats["decode_pages_touched"] < sum(
            -(-(len(p) + i) // 8) for p in prompts for i in range(1, 6))


def test_dense_serving_equals_paged_bit_for_bit():
    """serve_step logits on the dense cache equal the paged cache's, and a
    page-sparse decode that keeps every resident page equals both."""
    n_layers, b, page, nb, chunk, n = 2, 2, 8, 4, 8, 4
    _, tcfg = _cfgs(n_layers=n_layers)
    model = _model(n_layers)
    bt = torch.tensor([[3, 7, 9, -1], [0, 5, -1, -1]], dtype=torch.int32)
    caches = {"dense": T.init_caches(tcfg, paged=False, batch=b,
                                     max_len=nb * page - 3),
              "paged": T.init_caches(tcfg, paged=True, n_pages=10,
                                     page_size=page),
              "sparse": T.init_caches(tcfg, paged=True, n_pages=10,
                                      page_size=page)}
    rng = np.random.default_rng(7)
    for step, (pos, nv) in enumerate(((0, 8), (0, 5), (8, 3))):
        slot = step % 2
        tok = np.zeros((b, chunk), np.int64)
        tok[slot, :nv] = rng.integers(0, tcfg.vocab_size, nv)
        active = torch.arange(b) == slot
        kw = dict(pos=torch.tensor([pos, pos]), n=n, active=active,
                  n_valid=torch.where(active, nv, 0).to(torch.int32),
                  logits_mode="last")
        out = {name: T.serve_step(model, torch.from_numpy(tok), c,
                                  block_tables=None if name == "dense"
                                  else bt, **kw)
               for name, c in caches.items()}
        assert torch.equal(out["dense"][slot], out["paged"][slot])
    for pos in ((11, 5), (12, 6), (13, 7)):
        tok = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (b, 1)))
        kw = dict(pos=torch.tensor(pos), n=n, active=torch.ones(b, dtype=torch.bool),
                  logits_mode="last")
        dense = T.serve_step(model, tok, caches["dense"], **kw)
        paged = T.serve_step(model, tok, caches["paged"], block_tables=bt,
                             **kw)
        sparse = T.serve_step(model, tok, caches["sparse"], block_tables=bt,
                              page_topn=2, **kw)
        assert torch.equal(dense, paged) and torch.equal(dense, sparse)


@pytest.mark.parametrize("variant", ["plain", "prefix_cache", "preempt",
                                     "dense", "prefix_cache_page_topn"])
def test_ragged_equals_sequential_in_port(variant):
    """Ragged batches equal one request at a time, bit for bit; warm
    prefix-cached prompts equal cold ones (also under page-sparse
    decode)."""
    _, tcfg = _cfgs()
    model = _model()
    kw = {"plain": {}, "prefix_cache": {"prefix_cache": True},
          "preempt": {"n_pages": 7}, "dense": {"paged": False},
          "prefix_cache_page_topn": {"prefix_cache": True, "page_topn": 2},
          }[variant]
    shared = _prompts((16,), seed=2)[0]
    prompts = [np.concatenate([shared, p])
               for p in _prompts((3, 9, 1, 12), seed=3)]
    eng = Engine(tcfg, model, _scfg(ServeConfig, 3, **kw), device="cpu")
    got = _serve(eng, prompts, 6)
    eng.check()
    if variant == "prefix_cache":
        assert eng.stats["cached_tokens"] > 0
    if variant == "preempt":
        assert eng.stats["preemptions"] > 0
    for p, g in zip(prompts, got):
        one = Engine(tcfg, model, _scfg(ServeConfig, 1, **{
            k: v for k, v in kw.items() if k in ("paged", "page_topn")}),
            device="cpu")
        np.testing.assert_array_equal(g, _serve(one, [p], 6)[0])


# ---------------------------------------------------------------------------
# the copied Scheduler: plan for plan
# ---------------------------------------------------------------------------

def _canon(x):
    """Framework-neutral form of a plan: dataclasses by field, arrays by
    value, sampling rngs by generator state."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                tuple((f.name, _canon(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.tolist())
    if isinstance(x, np.random.Generator):
        return ("rng", repr(x.bit_generator.state))
    if isinstance(x, (list, tuple)):
        return tuple(_canon(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _canon(v)) for k, v in x.items()))
    return x


def _fake_results(plan):
    """Synthetic runner: deterministic tokens, eos (3) now and then."""
    results, tok = {}, 7
    for ch in plan.prefill:
        if ch.samples:
            results.setdefault(ch.slot, []).append(tok)
            tok += 1
    for e in plan.decode:
        results.setdefault(e.slot, []).append(3 if tok % 13 == 0
                                              else 4 + tok % 50)
        tok += 1
    return results


@pytest.mark.parametrize("kw,reclaims", [
    (dict(prefix_cache=True, n_pages=12), {"lru-evict", "recompute-preempt"}),
    (dict(n_pages=8, policy="shortest-prompt", victim_policy="longest-idle"),
     {"recompute-preempt"})])
def test_copied_scheduler_plans_equal_reference(kw, reclaims):
    scheds = [mod.Scheduler(mod.ServeConfig(
        max_len=32, batch_slots=3, topn=6, prefill_chunk=6, paged=True,
        page_size=4, **kw)) for mod in (JS, S)]
    prompts = _prompts((9, 3, 14, 9, 5, 11), seed=4)
    prompts[3][:8] = prompts[0][:8]                  # a shared prefix
    seen = set()
    for step in range(200):
        if step < len(prompts):
            for sch in scheds:
                sch.submit(prompts[step], max_new_tokens=6 + step % 5,
                           eos_token=3)
        if not scheds[0].queue and all(s.request is None
                                       for s in scheds[0].slots):
            break
        plans = [sch.schedule() for sch in scheds]
        assert _canon(plans[1]) == _canon(plans[0]), f"step {step}"
        seen |= {rc.kind for rc in plans[0].reclaims}
        fins = [sch.commit(p, _fake_results(p))
                for sch, p in zip(scheds, plans)]
        assert _canon(fins[1]) == _canon(fins[0])
    else:
        raise AssertionError("schedulers did not drain")
    # the port counts the rows its runner's prefill chunks carry too (a
    # scheduler runs no chunk), and state checkpoints evicted and prefix
    # matches cut short for want of one (a stateless model takes none)
    assert dict(scheds[1].stats) == dict(scheds[0].stats, prefill_rows=0,
                                         state_evictions=0, state_misses=0)
    assert seen == reclaims


# ---------------------------------------------------------------------------
# what this slice refuses, and how it picks the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b",
                                  "dbrx-132b"])
def test_ssm_and_moe_layer_patterns_build_from_jax(arch):
    """SSM layers (mamba2, jamba's "M" positions) and MoE FFNs (jamba,
    dbrx) are served: the model builds, and the weight bridge carries
    every JAX leaf into it bit for bit (SSM mixers by name, the float32
    router, stacked [E, D, F] expert weights), one port parameter per
    leaf. Their serving parity is pinned in test_torch_ssm_moe.py."""
    jcfg = jget_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(3),
                                                   jcfg))
    model = params_from_numpy(tree, cfg)
    span, n_leaves = len(cfg.layer_pattern), 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[0] != "blocks":
            continue
        n_leaves += 1
        pos = int(keys[1][3:])
        for g in range(cfg.n_groups):
            obj = model.blocks[g * span + pos]
            for key in keys[2:]:     # an SSM's gated norm is one tensor
                if not isinstance(obj, torch.Tensor):
                    obj = getattr(obj, key)
            np.testing.assert_array_equal(obj.numpy(), leaf[g])
    assert n_leaves * cfg.n_groups == sum(
        1 for name in model.state_dict() if name.startswith("blocks."))


@pytest.mark.parametrize("arch", ["bert-base-had", "hubert-xlarge",
                                  "deit-t"])
def test_unported_layer_patterns_raise(arch):
    """The encoders, once refused here (learned positions, bidirectional
    attention; hubert's and deit's frames frontend), are ported: the model
    builds, and its std and had_eval forwards equal JAX's logits on the
    same weights (LOGIT_TOL). The Engine refuses them with the JAX
    launcher's reason (`test_engine_refuses_encoders`)."""
    jcfg, cfg = jget_config(arch, reduced=True), get_config(arch, reduced=True)
    pj = JM.init_params(jax.random.PRNGKey(2), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, pj), cfg)
    assert model.pos_embed is not None and not cfg.causal
    rng = np.random.default_rng(3)
    if cfg.frontend_dim:
        batch = {"frames": rng.standard_normal(
            (2, 24, cfg.frontend_dim)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24)
                                        ).astype(np.int32)}
    for mode in ("std", "had_eval"):
        want = JM.forward(pj, {k: jnp.asarray(v) for k, v in batch.items()},
                          cfg=jcfg, mode=mode, att={"n": 6})
        with torch.no_grad():
            got = T.forward(model, {k: torch.from_numpy(v)
                                    for k, v in batch.items()},
                            cfg=cfg, mode=mode, att={"n": 6})
        np.testing.assert_allclose(got.logits.numpy(),
                                   np.asarray(want.logits), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ["bert-base-had", "hubert-xlarge",
                                  "deit-t"])
def test_engine_refuses_encoders(arch):
    """An encoder has no decode loop: the Engine refuses it with the JAX
    launcher's reason, and so does the port's launcher."""
    from repro_torch.launch import serve as launch
    cfg = get_config(arch, reduced=True)
    model = T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="encoder-only — no decode loop"):
        Engine(cfg, model, ServeConfig(max_len=32, batch_slots=1),
               device="cpu")
    with pytest.raises(SystemExit, match="encoder-only — no decode loop"):
        launch.main(["--arch", arch, "--reduced", "--device", "cpu"])


@pytest.mark.parametrize("flags", [[], ["--paged"], ["--page-topn", "1"],
                                   ["--baseline", "--paged"]],
                         ids=["dense", "paged", "page_topn", "baseline"])
def test_launcher_cache_flags(flags, capsys):
    """The dense cache is the default; --page-topn implies --paged and
    reports its decode traffic. Dense and paged tokens agree, on HAD and
    on the full-precision baseline (--baseline), whose tokens differ from
    HAD's. Every run captures its two step kinds."""
    from repro_torch.launch import serve as launch
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--prompt-len",
            "40", "--gen", "3", "--slots", "2", "--requests", "3"]
    got = launch.main(argv + flags)
    text = capsys.readouterr().out
    assert ("kv pool:" in text) == bool(flags)
    assert "step graphs: 2" in text
    assert ("full precision" in text) == ("--baseline" in flags)
    if flags == ["--page-topn", "1"]:
        assert "top-1 page-sparse" in text
    if "--paged" in flags:
        dense = launch.main([f for f in flags if f != "--paged"] + argv)
        assert {k: v.tolist() for k, v in got.items()} == \
            {k: v.tolist() for k, v in dense.items()}
    if "--baseline" in flags:
        had = launch.main(argv)
        assert {k: v.tolist() for k, v in got.items()} != \
            {k: v.tolist() for k, v in had.items()}


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(tcfg, _model(), _scfg(ServeConfig, 1))


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    code += (
        "need = ['repro_torch.core.binarize', 'repro_torch.core.losses',\n"
        "        'repro_torch.core.distill', 'repro_torch.optim.adam',\n"
        "        'repro_torch.optim.schedules', 'repro_torch.data.synthetic',\n"
        "        'repro_torch.data.pipeline', 'repro_torch.train.steps',\n"
        "        'repro_torch.train.loop', 'repro_torch.checkpoint.manager',\n"
        "        'repro_torch.distributed.compression',\n"
        "        'repro_torch.distributed.sharding',\n"
        "        'repro_torch.distributed.collectives',\n"
        "        'repro_torch.launch.mesh', 'repro_torch.launch.mesh_cost',\n"
        "        'repro_torch.launch.dryrun',\n"
        "        'repro_torch.models.model', 'repro_torch.launch.train']\n"
        "assert all(m in sys.modules for m in need), need\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[0]) >= 20
