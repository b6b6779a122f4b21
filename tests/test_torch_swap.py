"""Swap-out preemption in the port (runner `_swap_out_pages` /
`_finalize_swaps` / `_swap_in_pages`), and the runner's cache surface.

Inside the port, bit for bit: an overcommitted pool with swap space serves
every request as the unpreempted engine does, with zero re-prefilled
tokens and both pools drained (binary and fp, paged and page_topn); swap
and recompute preemption give the same tokens, swap with strictly less
prefill; swap composes with the prefix cache; the runner keeps its two
step graphs. Against the JAX Engine: greedy tokens and the swap counters
on a swap-forcing workload, and the caches' byte count (the port's holds
one trash page or position per leaf more). `reset_caches` zeroes the
tensors the graphs read, in place. On the card (`cuda` marker): swapped
== unpreempted under graphs, where a rebound cache tensor would show.
"""
import numpy as np
import pytest
import torch

from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.serve import Engine, ServeConfig

from test_torch_serve import _cfgs, _model, _params, _prompts, _scfg, _serve

PATHS = {"binary-paged": {}, "binary-page_topn": dict(page_topn=2),
         "fp-paged": dict(binary=False),
         "fp-page_topn": dict(binary=False, page_topn=2)}
SWAP = dict(n_pages=3, swap_pages=8)          # 3 slots overcommit 3 pages
COUNTERS = ("swap_outs", "swap_ins", "swapped_tokens", "replayed_tokens",
            "preemptions", "swap_out_bytes", "swap_in_bytes")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


def _engine(kw, slots=3, device="cpu", model=None):
    _, tcfg = _cfgs()
    model = _model() if model is None else model
    return Engine(tcfg, model, _scfg(ServeConfig, slots, **kw),
                  device=device)


def _check_swapped(eng):
    st = eng.stats
    assert st["swap_outs"] > 0, "pool never forced a swap: test void"
    assert st["swap_ins"] == st["swap_outs"]
    assert st["replayed_tokens"] == 0                 # zero re-prefill
    assert st["swapped_tokens"] > 0
    assert eng.allocator.in_use == 0 and eng.swap.in_use == 0
    assert eng.runner.graph_count() == 2
    assert not eng.runner._swap_store
    eng.check()


def _swapped_vs_unpreempted(path, device="cpu", model=None):
    prompts = _prompts((13, 5, 9), seed=33)
    want = _serve(_engine(PATHS[path], device=device, model=model),
                  prompts, 5)
    eng = _engine(dict(PATHS[path], **SWAP), device=device, model=model)
    got = _serve(eng, prompts, 5)
    _check_swapped(eng)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("path", list(PATHS))
def test_swap_preemption_bit_identical_with_zero_reprefill(path):
    """The JAX acceptance pin in the port: swapped victims resume from
    their restored pages and serve the unpreempted tokens."""
    _swapped_vs_unpreempted(path)


def test_swap_matches_recompute_preemption_outputs():
    """Swap-out is a pure mechanism change: the same overcommitted
    workload gives identical tokens with swap on (zero re-prefill) and off
    (recompute), with strictly less prefill work on swap."""
    prompts = _prompts((13, 9, 11), seed=35)
    outs, ptoks = {}, {}
    for swap in (0, 8):
        eng = _engine(dict(n_pages=4, swap_pages=swap))
        outs[swap] = _serve(eng, prompts, 12)
        assert eng.stats["preemptions"] >= 2, eng.stats
        key = "swap_outs" if swap else "replayed_tokens"
        assert eng.stats[key] > 0, key
        ptoks[swap] = eng.stats["prefill_tokens"]
    for a, b in zip(outs[0], outs[8]):
        np.testing.assert_array_equal(a, b)
    assert ptoks[8] < ptoks[0]


def test_swap_composes_with_prefix_cache():
    """Shared prefixes + pool pressure + swap-outs still serve cold
    tokens, and swapped-in pages never alias the index: every indexed
    page is allocator-cached."""
    rng = np.random.default_rng(36)
    shared = rng.integers(0, 256, 2 * 8)
    prompts = [np.concatenate([shared, rng.integers(0, 256, 5 + i)])
               for i in range(3)]
    eng = _engine(dict(n_pages=4, prefix_cache=True, swap_pages=8))
    got = _serve(eng, prompts, 8)
    assert eng.stats["swap_outs"] > 0, "pool never forced a swap: test void"
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, _serve(_engine({}, slots=1),
                                                [p], 8)[0])
    for page in eng.prefix._page_of.values():
        assert eng.allocator.is_cached(page)
    assert eng.allocator.in_use == 0 and eng.swap.in_use == 0


def test_swap_heavy_run_keeps_two_step_graphs():
    """Swap transfers are indexed copies outside the step: a swap-heavy
    run sets up the same two step kinds, and each transfer is counted in
    bytes once each way."""
    eng = _engine(dict(n_pages=4, swap_pages=8))
    _serve(eng, _prompts((13, 9, 11, 7), seed=37), 12)
    assert eng.stats["swap_outs"] >= 2
    assert eng.runner.graph_count() == 2
    assert eng.stats["swap_out_bytes"] == eng.stats["swap_in_bytes"] > 0


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fp"])
def test_swap_tokens_and_counters_match_jax_engine(binary):
    """One swap-forcing workload through both engines: the same greedy
    tokens, and the same swap counters (bytes too: a page's bytes in each
    pool leaf are the same in both packages)."""
    jcfg, tcfg = _cfgs()
    pj, _ = _params()
    prompts = _prompts((13, 5, 9), seed=33)
    kw = dict(binary=binary, **SWAP)
    jeng = JEngine(jcfg, pj, _scfg(JServeConfig, 3, **kw))
    teng = Engine(tcfg, _model(), _scfg(ServeConfig, 3, **kw), device="cpu")
    want, got = _serve(jeng, prompts, 5), _serve(teng, prompts, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert teng.stats["swap_outs"] > 0, "pool never forced a swap: test void"
    for key in COUNTERS:
        assert teng.stats[key] == jeng.stats[key], key


def test_swap_requires_the_paged_cache_and_refuses_state_entries():
    """As in JAX, a dense cache has no pages to swap (a construction
    error). A pooled state entry, which the port refused before it served
    cross-attention models (the test keeps its name), now moves with the
    victim's pages: on reduced llama-3.2-vision-11b, pages and the state
    entry of every cross layer go to the host and come back into other
    pages and another entry bit for bit, their bytes counted as the JAX
    runner counts them."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    with pytest.raises(ValueError, match="paged"):
        _engine(dict(paged=False, swap_pages=4))
    cfg = get_config("llama-3.2-vision-11b", reduced=True)
    model = T.init_params(cfg, torch.Generator().manual_seed(5))
    eng = Engine(cfg, model, _scfg(ServeConfig, 2, **SWAP), device="cpu")
    runner = eng.runner
    assert runner._pool_layers == [0, 1, 2, 3]
    assert runner._state_layers == [4]
    gen = torch.Generator().manual_seed(6)
    for cache in runner.caches:
        for leaf in cache.values():
            leaf.copy_(torch.randint(-9, 9, leaf.shape, generator=gen))
    want = ([{k: v[[0, 2]].clone() for k, v in c.items()}
             for c in runner.caches[:4]],
            {k: v[1].clone() for k, v in runner.caches[4].items()})
    runner._swap_out_pages(7, (0, 2), state_page=1)
    runner._finalize_swaps()
    for cache in runner.caches:
        for leaf in cache.values():
            leaf.zero_()
    runner._swap_in_pages(7, (1, 0), state_page=0)
    for c, w in zip(runner.caches[:4], want[0]):
        for k in c:
            assert torch.equal(c[k][[1, 0]], w[k])
    for k, leaf in runner.caches[4].items():
        assert torch.equal(leaf[0], want[1][k])
    page = sum(v[0].numel() * v.element_size()
               for c in runner.caches[:4] for v in c.values())
    entry = sum(v[0].numel() * v.element_size()
                for v in runner.caches[4].values())
    assert eng.stats["swap_out_bytes"] == 2 * page + entry
    assert eng.stats["swap_in_bytes"] == 2 * page + entry
    assert not runner._swap_store


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_cache_device_bytes_counts_one_trash_page_more_than_jax(paged):
    """(total, per_device), equal on one device; the port's total is the
    JAX runner's plus one trash page (or position) per leaf."""
    jcfg, tcfg = _cfgs()
    pj, _ = _params()
    kw = dict(paged=paged, binary=True)
    jtotal, jper = JEngine(jcfg, pj, _scfg(JServeConfig, 2, **kw)) \
        .runner.cache_device_bytes()
    runner = Engine(tcfg, _model(), _scfg(ServeConfig, 2, **kw),
                    device="cpu").runner
    total, per = runner.cache_device_bytes()
    trash = 0
    for cache in runner.caches:
        for name, leaf in cache.items():
            axis = 0 if paged else (3 if name == "k_bits" else 2)
            trash += leaf.numel() * leaf.element_size() // leaf.shape[axis]
    assert total == per and jtotal == jper
    assert total == jtotal + trash


def test_reset_caches_zeroes_in_place_and_keeps_the_graphs():
    """reset_caches writes zeros into the tensors the step reads (trash
    page included), drops swapped contents, and keeps both step kinds."""
    eng = _engine(dict(n_pages=4, swap_pages=8))
    runner = eng.runner
    _serve(eng, _prompts((13, 9, 11), seed=35), 6)
    ptrs = [{k: v.data_ptr() for k, v in c.items()} for c in runner.caches]
    assert any(v.any() for c in runner.caches for v in c.values())
    runner._swap_store[99] = []
    runner.reset_caches()
    assert [{k: v.data_ptr() for k, v in c.items()}
            for c in runner.caches] == ptrs
    assert not any(v.any() for c in runner.caches for v in c.values())
    assert not runner._swap_store and runner.graph_count() == 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_swap_bit_identical_on_card(cuda, path):
    """Under CUDA graphs: swapped tokens equal the unpreempted ones, so the
    swap-in wrote into the very tensors the graphs replay over."""
    _swapped_vs_unpreempted(path, device=cuda, model=_model().to(cuda))


@pytest.mark.cuda
def test_swap_payload_is_pinned_host_memory_on_card(cuda):
    """A swap-out's bytes go to pinned host tensors by non-blocking copies
    and land at wait(); the decode logits' host buffer is pinned too."""
    eng = _engine(SWAP, device=cuda, model=_model().to(cuda))
    for p in _prompts((13, 5, 9), seed=33):
        eng.submit(p, max_new_tokens=5)
    seen = []
    while eng.queue or any(s.request is not None for s in eng.slots):
        eng.step()
        seen += [t for layer in eng.runner._swap_store.values()
                 for c in layer for t in c.values()]
    assert seen and all(t.device.type == "cpu" and t.is_pinned()
                        for t in seen)
    assert eng.runner._host_logits.is_pinned()
    _check_swapped(eng)
