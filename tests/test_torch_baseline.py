"""The port's full-precision baseline (`ServeConfig(binary=False)`) against
the JAX package, and its pins inside the port.

Across frameworks: `standard_attention` and `serve_step` logits allclose,
the fp k / v pools allclose over pages [0, n_pages) and positions
[0, max_len), `_page_topn_keep` equal exactly (ties, -inf, the frontier),
and greedy tokens and decode-traffic counters of the port's Engine equal
to the JAX Engine's on reduced smollm-135m over the paged cache, the dense
cache and page-sparse decode. Inside the port, bit for bit: paged ==
dense, page_topn >= resident == paged, ragged == sequential.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as JA
from repro.models import attention_block as JAB
from repro.models import model as JM
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.core import attention as A
from repro_torch.models import attention_block as AB
from repro_torch.models import transformer as T
from repro_torch.serve import Engine, ServeConfig

from test_torch_serve import (LOGIT_TOL, _cfgs, _model, _params, _prompts,
                              _scfg, _serve)

POOL_TOL = dict(rtol=1e-5, atol=1e-6)


def _fp_scfg(cls, slots, **kw):
    return _scfg(cls, slots, binary=False, **kw)


# ---------------------------------------------------------------------------
# core.attention.standard_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,offsets,valid", [
    (True, None, None), (True, "ragged", None), (True, "ragged", "ragged"),
    (False, None, "ragged"), (True, 5, "ragged")],
    ids=["causal", "offsets", "offsets_valid", "valid", "scalar_offset"])
def test_standard_attention_matches_jax(causal, offsets, valid):
    """GQA softmax attention (H 6, Hk 2) on the same float32 inputs, with
    per-slot query offsets and key masks, one slot with no usable key."""
    rng = np.random.default_rng(11)
    b, h, hk, sq, sk, d = 3, 6, 2, 5, 12, 16
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((b, h, sq, d), (b, hk, sk, d), (b, hk, sk, d)))
    q_off = (np.array([0, 4, 7], np.int32) if offsets == "ragged"
             else offsets or 0)
    kv_valid = (np.arange(sk)[None] < np.array([[12], [6], [0]])
                if valid else None)
    want = JA.standard_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=d ** -0.5,
        causal=causal, q_offset=jnp.asarray(q_off),
        kv_valid=None if kv_valid is None else jnp.asarray(kv_valid))
    got = A.standard_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=d ** -0.5, causal=causal,
        q_offset=(torch.from_numpy(q_off) if isinstance(q_off, np.ndarray)
                  else q_off),
        kv_valid=None if kv_valid is None else torch.from_numpy(kv_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# _page_topn_keep: exact against JAX
# ---------------------------------------------------------------------------

def _score_sets():
    rng = np.random.default_rng(5)
    b, nb = 4, 9
    rand = rng.normal(size=(b, nb)).astype(np.float32)
    ties = rng.integers(0, 3, (b, nb)).astype(np.float32)
    neg = np.where(rng.random((b, nb)) < 0.4, -np.inf, rand).astype(
        np.float32)
    return {"random": rand, "ties": ties, "minus_inf": neg,
            "all_equal": np.zeros((b, nb), np.float32)}


@pytest.mark.parametrize("n_sel", [1, 3, 8, 12])
@pytest.mark.parametrize("scores", ["random", "ties", "minus_inf",
                                    "all_equal"])
def test_page_topn_keep_matches_jax(scores, n_sel):
    """The same score arrays give the same token mask: the frontier page
    always kept, pages past the length never ranked in, ties (and -inf
    scores) to the lowest block; lengths 0, 1, mid-page, a page multiple
    and the whole table."""
    page = 4
    sc = _score_sets()[scores]
    kv_len = np.array([0, 13, 16, 36], np.int32)
    want = JAB._page_topn_keep(jnp.asarray(sc), jnp.asarray(kv_len),
                               page=page, n_sel=n_sel)
    got = AB._page_topn_keep(torch.from_numpy(sc), torch.from_numpy(kv_len),
                             page=page, n_sel=n_sel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# serve_step: logits and fp pools allclose to JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["paged", "dense", "page_topn"])
def test_fp_serve_step_logits_and_pools_match_jax(kind):
    """Three interleaved prefill chunks (inactive rows riding along), then
    decode steps; page_topn 2 drops pages at the last steps."""
    n_layers, b, page, nb, n_pages, chunk, n = 2, 2, 8, 4, 10, 8, 4
    max_len = nb * page
    jcfg, tcfg = _cfgs(n_layers=n_layers)
    pj, _ = _params(n_layers)
    model = _model(n_layers)
    paged = kind != "dense"
    page_topn = 2 if kind == "page_topn" else None
    bt = np.array([[3, 7, 9, -1], [0, 5, -1, -1]], np.int32)
    if paged:
        jcaches = JM.init_caches(jcfg, b, max_len, binary=False, paged=True,
                                 n_pages=n_pages, page_size=page)
        tcaches = T.init_caches(tcfg, paged=True, n_pages=n_pages,
                                page_size=page, binary=False)
    else:
        jcaches = JM.init_caches(jcfg, b, max_len, binary=False)
        tcaches = T.init_caches(tcfg, paged=False, batch=b, max_len=max_len,
                                binary=False)
    rng = np.random.default_rng(3)
    steps = []
    for slot, pos, nv in ((0, 0, 8), (1, 0, 5), (0, 8, 8)):
        tok = np.zeros((b, chunk), np.int32)
        tok[slot, :nv] = rng.integers(0, tcfg.vocab_size, nv)
        steps.append((tok, np.array([pos, pos], np.int32),
                      np.arange(b) == slot, np.where(np.arange(b) == slot,
                                                     nv, 0).astype(np.int32)))
    for pos in ((16, 5), (17, 6), (18, 7)):
        steps.append((rng.integers(0, tcfg.vocab_size, (b, 1)).astype(
            np.int32), np.array(pos, np.int32), np.ones(b, bool), None))
    tables = dict(block_tables=bt) if paged else {}
    for tok, pos, active, nv in steps:
        ptn = page_topn if nv is None else None
        jl, jcaches = JM.serve_step(
            pj, {"tokens": jnp.asarray(tok)}, jcaches, cfg=jcfg, n=n,
            binary=False, logits_mode="last", pos=jnp.asarray(pos),
            active=jnp.asarray(active), page_topn=ptn,
            n_valid=None if nv is None else jnp.asarray(nv),
            **{k: jnp.asarray(v) for k, v in tables.items()})
        tl = T.serve_step(
            model, torch.from_numpy(tok), tcaches, pos=torch.from_numpy(pos),
            n=n, active=torch.from_numpy(active), page_topn=ptn,
            n_valid=None if nv is None else torch.from_numpy(nv),
            binary=False, logits_mode="last",
            **{k: torch.from_numpy(v) for k, v in tables.items()})
        rows = np.flatnonzero(active)
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   **LOGIT_TOL)
    # layer 0's K and V are projections of the embeddings (POOL_TOL, the
    # binary test's v-pool tolerance); deeper layers' follow the float32
    # attention sums of the layers below, as the logits do (LOGIT_TOL)
    for layer in range(n_layers):
        for name in ("k", "v"):
            want = np.asarray(jcaches["pos0"][name][layer])
            got = (tcaches[layer][name][:n_pages] if paged
                   else tcaches[layer][name][:, :, :max_len]).numpy()
            np.testing.assert_allclose(got, want,
                                       **(POOL_TOL if layer == 0
                                          else LOGIT_TOL))
            assert np.abs(want).max() > 0


# ---------------------------------------------------------------------------
# Engine: greedy tokens vs the JAX Engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(paged=False), dict(page_topn=3)],
                         ids=["paged", "dense", "page_topn"])
def test_fp_engine_greedy_tokens_match_jax_engine(kw):
    """binary=False: greedy tokens and decode-traffic counters (fp K pages)
    equal the JAX Engine's; page_topn 3 drops pages."""
    jcfg, tcfg = _cfgs()
    pj, _ = _params()
    prompts = _prompts((13, 5, 30, 20), seed=6)
    jeng = JEngine(jcfg, pj, _fp_scfg(JServeConfig, 2, **kw))
    teng = Engine(tcfg, _model(), _fp_scfg(ServeConfig, 2, **kw),
                  device="cpu")
    want, got = _serve(jeng, prompts, 6), _serve(teng, prompts, 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for key in ("decode_steps", "decode_pages_touched", "decode_hbm_bytes"):
        assert teng.stats[key] == jeng.stats[key], key
    if "page_topn" in kw:
        assert 0 < teng.stats["decode_pages_touched"] < sum(
            -(-(len(p) + i) // 8) for p in prompts for i in range(1, 6))


# ---------------------------------------------------------------------------
# pins inside the port, bit for bit
# ---------------------------------------------------------------------------

def test_fp_dense_serving_equals_paged_bit_for_bit():
    """serve_step logits on the fp dense cache (max_len a page multiple)
    equal the paged pool's, and page-sparse decode keeping every resident
    page equals both."""
    n_layers, b, page, nb, chunk, n = 2, 2, 8, 4, 8, 4
    _, tcfg = _cfgs(n_layers=n_layers)
    model = _model(n_layers)
    bt = torch.tensor([[3, 7, 9, -1], [0, 5, -1, -1]], dtype=torch.int32)
    caches = {"dense": T.init_caches(tcfg, paged=False, batch=b,
                                     max_len=nb * page, binary=False),
              "paged": T.init_caches(tcfg, paged=True, n_pages=10,
                                     page_size=page, binary=False),
              "sparse": T.init_caches(tcfg, paged=True, n_pages=10,
                                      page_size=page, binary=False)}
    rng = np.random.default_rng(7)
    for step, (pos, nv) in enumerate(((0, 8), (0, 5), (8, 3))):
        slot = step % 2
        tok = np.zeros((b, chunk), np.int64)
        tok[slot, :nv] = rng.integers(0, tcfg.vocab_size, nv)
        active = torch.arange(b) == slot
        kw = dict(pos=torch.tensor([pos, pos]), n=n, active=active,
                  n_valid=torch.where(active, nv, 0).to(torch.int32),
                  binary=False, logits_mode="last")
        out = {name: T.serve_step(model, torch.from_numpy(tok), c,
                                  block_tables=None if name == "dense"
                                  else bt, **kw)
               for name, c in caches.items()}
        assert torch.equal(out["dense"][slot], out["paged"][slot])
    for pos in ((11, 5), (12, 6), (13, 7)):
        tok = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (b, 1)))
        kw = dict(pos=torch.tensor(pos), n=n,
                  active=torch.ones(b, dtype=torch.bool), binary=False,
                  logits_mode="last")
        dense = T.serve_step(model, tok, caches["dense"], **kw)
        paged = T.serve_step(model, tok, caches["paged"], block_tables=bt,
                             **kw)
        sparse = T.serve_step(model, tok, caches["sparse"], block_tables=bt,
                              page_topn=2, **kw)
        assert torch.equal(dense, paged) and torch.equal(dense, sparse)


def test_fp_engine_page_topn_at_resident_equals_paged():
    """Engine tokens: fp page_topn >= every slot's resident pages == fp
    paged == fp dense, bit for bit."""
    _, tcfg = _cfgs()
    model = _model()
    prompts = _prompts((13, 5, 30, 20), seed=8)
    out = {name: _serve(Engine(tcfg, model, _fp_scfg(ServeConfig, 2, **kw),
                               device="cpu"), prompts, 6)
           for name, kw in (("paged", {}), ("dense", dict(paged=False)),
                            ("page_topn", dict(page_topn=6)))}
    for name in ("dense", "page_topn"):
        for g, w in zip(out[name], out["paged"]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("variant", ["plain", "prefix_cache", "preempt",
                                     "dense", "prefix_cache_page_topn"])
def test_fp_ragged_equals_sequential_in_port(variant):
    """The full-precision twin of test_ragged_equals_sequential_in_port."""
    _, tcfg = _cfgs()
    model = _model()
    kw = {"plain": {}, "prefix_cache": {"prefix_cache": True},
          "preempt": {"n_pages": 7}, "dense": {"paged": False},
          "prefix_cache_page_topn": {"prefix_cache": True, "page_topn": 2},
          }[variant]
    shared = _prompts((16,), seed=2)[0]
    prompts = [np.concatenate([shared, p])
               for p in _prompts((3, 9, 1, 12), seed=3)]
    eng = Engine(tcfg, model, _fp_scfg(ServeConfig, 3, **kw), device="cpu")
    got = _serve(eng, prompts, 6)
    eng.check()
    if variant == "prefix_cache":
        assert eng.stats["cached_tokens"] > 0
    if variant == "preempt":
        assert eng.stats["preemptions"] > 0
    for p, g in zip(prompts, got):
        one = Engine(tcfg, model, _fp_scfg(ServeConfig, 1, **{
            k: v for k, v in kw.items() if k in ("paged", "page_topn")}),
            device="cpu")
        np.testing.assert_array_equal(g, _serve(one, [p], 6)[0])


def test_fp_caches_hold_k_in_the_model_dtype():
    _, tcfg = _cfgs()
    paged = T.init_caches(tcfg, paged=True, n_pages=5, page_size=8,
                          binary=False)[0]
    dense = T.init_caches(tcfg, paged=False, batch=2, max_len=24,
                          binary=False)[0]
    assert set(paged) == set(dense) == {"k", "v"}
    assert paged["k"].shape == paged["v"].shape == (6, tcfg.n_kv_heads, 8,
                                                    tcfg.dh)
    assert dense["k"].shape == (2, tcfg.n_kv_heads, 25, tcfg.dh)
    assert paged["k"].dtype == dense["v"].dtype == tcfg.dtype
    assert paged["k"].data_ptr() != paged["v"].data_ptr()


@pytest.mark.cuda
def test_fp_attention_of_each_kv_head_alone_on_card():
    """The full-precision serving attention of one row (a prefill chunk)
    over every kv head of smollm-135m equals each kv head's alone, bit for
    bit, as a tensor-parallel rank holding it computes it: on the card a
    float32 GEMM rounds by its batch count, so each kv head is its own
    product."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses

    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("smollm-135m")                   # 9 / 3 heads of 64
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, device="cuda", generator=g).to(cfg.dtype)

    q, k, v = rand(1, 9, 512, 64), rand(1, 3, 512, 64), rand(1, 3, 512, 64)
    cache = {"k": rand(1, 3, 4097, 64), "v": rand(1, 3, 4097, 64)}
    pos = torch.tensor([3000], device="cuda")
    kw = dict(pos=pos, kv_len=pos + 512, block_tables=None, n_valid=None,
              active=None, page_topn=None)
    full = AB._attn_std(q, k, v, cfg=cfg, cache=dict(cache), **kw)
    head = dataclasses.replace(cfg, n_heads=3, n_kv_heads=1)
    parts = [AB._attn_std(q[:, 3 * i:3 * i + 3], k[:, i:i + 1],
                          v[:, i:i + 1], cfg=head,
                          cache={n: c[:, i:i + 1].clone()
                                 for n, c in cache.items()}, **kw)
             for i in range(3)]
    assert torch.equal(full, torch.cat(parts, 1))
