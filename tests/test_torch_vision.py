"""Cross-attention serving in the port (llama-3.2-vision-11b, reduced:
AAAAC, d 64, head_dim 16, 8 image tokens, frontend 32, float32) against
the JAX package.

The JAX side runs on its plain reference path (``HADConfig()``), as its
own vision serving tests do, on the same weights (`params_from_numpy`)
and numpy-seeded inputs. Pinned: `fill_cross_cache` words exactly and V
allclose; `pool_read` / `pool_write` exactly on entries [0, n_entries)
(the port's pools hold one trash entry more), with -1 entries and
dropped rows; `serve_step` logits allclose (LOGIT_TOL) and cross caches
exactly (binary words) over a prefill with images, a text chunk, decode
steps and a fresh row without an image, binary with pooled state and fp
with dense caches; the non-causal prefill kernel's plain version against
the JAX Pallas kernel in interpret mode; Engine greedy tokens and every
serve counter equal to the JAX Engine's over a mix of image and
text-only requests (paged with pooled state, dense, binary, fp, and
swap-out preemption with the statepool counters); the lockstep
`prefill(tokens, extra)`. A JAX engine compiles its own steps, so the
tests share three JAX runs (`_jax_run`). Inside the port: chunked ==
single-chunk prefill with an image, no cross-cache leak across a slot
refill (dense and pooled), text-only prefix caching warm == cold,
swapped == unpreempted, two step graphs whatever the mix, sync ==
pipelined == AsyncEngine with `extra=`. On the card (`cuda` marker):
graph == eager and the state swap, bit for bit.
"""
import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import attention_block as JAB
from repro.models import common as JC
from repro.models import model as JM
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import hamming
from repro_torch.kernels import ops
from repro_torch.models import attention_block as AB
from repro_torch.models import common
from repro_torch.models import transformer as T
from repro_torch.serve import AsyncEngine, Engine, ServeConfig
from repro_torch.serve.telemetry import SERVE_COUNTERS

# serve counters of the port alone
PORT_COUNTERS = ("state_evictions", "state_misses")

ARCH = "llama-3.2-vision-11b"
LOGIT_TOL = dict(rtol=1e-4, atol=2e-5)   # float32, XLA vs ATen sum order
TOL = dict(rtol=1e-5, atol=1e-6)
STATEPOOL = ("hits", "misses", "registered", "evictions", "peak_held")


def _cfgs():
    return (jget_config(ARCH, reduced=True), get_config(ARCH, reduced=True))


@functools.lru_cache(maxsize=None)
def _params(seed=0):
    jcfg, _ = _cfgs()
    pj = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return pj, jax.tree.map(np.asarray, pj)


def _model(seed=0):
    return params_from_numpy(_params(seed)[1], _cfgs()[1], device="cpu")


def _image(seed, rows=1):
    cfg = _cfgs()[1]
    return np.random.default_rng(seed).normal(
        size=(rows, cfg.n_image_tokens, cfg.frontend_dim)).astype(np.float32)


def _scfg(cls, slots, **kw):
    base = dict(max_len=48, batch_slots=slots, binary=True, topn=6,
                prefill_chunk=8, paged=True, page_size=8)
    base.update(kw)
    return cls(**base)


def _requests(lengths=(13, 5, 9, 20), seed=1):
    """Prompts, with an image on every other request (the first has one)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, n).astype(np.int32),
             {"image_embeds": _image(seed + i)} if i % 2 == 0 else None)
            for i, n in enumerate(lengths)]


def _serve(eng, reqs, gen=5):
    ids = [eng.submit(p, max_new_tokens=gen, extra=e) for p, e in reqs]
    out = eng.run()
    return [out[i] for i in ids]


def _counters(eng):
    """Every serve counter the JAX Engine has too (it counts no state
    evictions or misses). It counts no `prefill_rows`: the port's chunks
    carry one row each, so its count is the JAX chunks'."""
    jax_side = isinstance(eng, JEngine)
    return {k: eng.stats["prefill_chunks" if jax_side and k == "prefill_rows"
                         else k] for k in SERVE_COUNTERS
            if k not in PORT_COUNTERS}


# ---------------------------------------------------------------------------
# the cross cache and the state pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fp"])
def test_fill_cross_cache_matches_jax(binary):
    jcfg, tcfg = _cfgs()
    pj, _ = _params()
    model = _model()
    img = _image(3, rows=2)
    proj = img @ np.asarray(pj["frontend_proj"])
    mixer = jax.tree.map(lambda x: x[0], pj["blocks"]["pos4"]["mixer"])
    want = JAB.fill_cross_cache(mixer, jnp.asarray(proj), cfg=jcfg,
                                binary=binary)
    got = AB.fill_cross_cache(model.blocks[4].mixer, torch.from_numpy(proj),
                              cfg=tcfg, binary=binary)
    if binary:
        np.testing.assert_array_equal(
            got["k_bits"].numpy(), np.asarray(want["k_bits"]).view(np.int32))
    else:
        np.testing.assert_allclose(got["k"].numpy(), np.asarray(want["k"]),
                                   **TOL)
    np.testing.assert_allclose(got["v"].numpy(), np.asarray(want["v"]),
                               **TOL)


def test_pool_read_and_write_match_jax():
    """Entries [0, n) exactly: -1 ids read entry 0, and rows that are not
    ok never land (the port's go to its trash entry n). As the serve step
    does, the -1 row is not ok: JAX would write an ok -1 row to its last
    entry, where the port drops it."""
    rng = np.random.default_rng(4)
    n, b = 6, 5
    pool = {"k_bits": rng.integers(-2 ** 31, 2 ** 31, (n, 2, 1, 8),
                                   dtype=np.int64).astype(np.int32),
            "v": rng.normal(size=(n, 2, 8, 16)).astype(np.float32)}
    new = {k: (v[:b] * 3 + 1).astype(v.dtype) for k, v in pool.items()}
    entries = np.array([4, -1, 0, 2, 5], np.int32)
    ok = np.array([True, False, False, True, True])
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    tpool = {k: torch.from_numpy(np.concatenate([v, v[:1] * 0]))
             for k, v in pool.items()}
    jread = JC.pool_read(jpool, jnp.asarray(entries))
    tread = common.pool_read(tpool, torch.from_numpy(entries))
    for k in pool:
        np.testing.assert_array_equal(tread[k].numpy(), np.asarray(jread[k]))
    jw = JC.pool_write(jpool, {k: jnp.asarray(v) for k, v in new.items()},
                       jnp.asarray(entries), jnp.asarray(ok))
    common.pool_write(tpool, {k: torch.from_numpy(v) for k, v in new.items()},
                      torch.from_numpy(entries), torch.from_numpy(ok))
    for k in pool:
        np.testing.assert_array_equal(tpool[k][:n].numpy(), np.asarray(jw[k]))
        assert not np.array_equal(tpool[k][:n].numpy(), pool[k])


# ---------------------------------------------------------------------------
# serve_step against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pooled,binary", [(True, True), (False, False)],
                         ids=["pooled-binary", "dense-fp"])
def test_serve_step_matches_jax(pooled, binary):
    """A prefill chunk with images (row 1 padded); a chunk without, where
    row 0 goes on and row 1 is refilled fresh without an image (its cross
    cache must read zeros); a decode step. Paged self-attention pools and
    pooled cross state (entries 3 and 1 of 4), binary; or dense caches,
    full precision (each JAX step runs op by op, so the other two pairings
    are left to the Engine tests)."""
    jcfg, tcfg = _cfgs()
    pj, _ = _params()
    model = _model()
    b, max_len, page, n_pages, entries = 2, 32, 8, 8, 4
    rng = np.random.default_rng(6)
    img = _image(7, rows=b)
    if pooled:
        jc = JM.init_caches(jcfg, b, max_len, binary=binary, paged=True,
                            n_pages=n_pages, page_size=page,
                            state_pages=entries)
        tc = T.init_caches(tcfg, paged=True, n_pages=n_pages, page_size=page,
                           binary=binary, state_pages=entries)
        bt = np.array([[2, 5, 0, 6], [1, 3, 7, 4]], np.int32)
        st = np.array([3, 1], np.int32)
    else:
        jc = JM.init_caches(jcfg, b, max_len, binary=binary)
        tc = T.init_caches(tcfg, paged=False, batch=b, max_len=max_len,
                           binary=binary)
        bt = st = None
    steps = [  # (tokens [B, S], pos, active, n_valid, images)
        (rng.integers(0, 256, (b, 8)), [0, 0], [1, 1], [8, 5], img),
        (rng.integers(0, 256, (b, 8)), [8, 0], [1, 1], [6, 7], None),
        (rng.integers(0, 256, (b, 1)), [14, 7], [1, 1], None, None),
    ]
    key = "k_bits" if binary else "k"
    for tok, pos, act, nv, images in steps:
        tok = np.asarray(tok, np.int32)
        pos, act = np.asarray(pos, np.int32), np.asarray(act, bool)
        batch = {"tokens": jnp.asarray(tok)}
        if images is not None:
            batch["image_embeds"] = jnp.asarray(images)
        jl, jc = JM.serve_step(
            pj, batch, jc, cfg=jcfg, pos=jnp.asarray(pos), n=6,
            binary=binary, logits_mode="last", active=jnp.asarray(act),
            n_valid=None if nv is None else jnp.asarray(nv, jnp.int32),
            block_tables=None if bt is None else jnp.asarray(bt),
            state_tables=None if st is None else jnp.asarray(st))
        tl = T.serve_step(
            model, torch.from_numpy(tok), tc, pos=torch.from_numpy(pos), n=6,
            binary=binary, logits_mode="last", active=torch.from_numpy(act),
            n_valid=None if nv is None else torch.tensor(nv,
                                                         dtype=torch.int32),
            block_tables=None if bt is None else torch.from_numpy(bt),
            state_tables=None if st is None else torch.from_numpy(st),
            image_embeds=None if images is None else torch.from_numpy(images))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        want, got = np.asarray(jc["pos4"][key][0]), tc[4][key].numpy()
        if pooled:
            got = got[:entries]
        if binary:
            np.testing.assert_array_equal(got, want.view(np.int32))
        else:
            np.testing.assert_allclose(got, want, **TOL)
        if images is not None:
            assert tc[4]["v"].any()
    # row 1 was refilled without an image: its cross cache is zero
    row = st[1] if pooled else 1
    assert not tc[4]["v"][row].any() and not tc[4][key][row].any()


@pytest.mark.parametrize("nsel", [3, 8, 40])
def test_prefill_noncausal_plain_matches_jax_kernel(nsel):
    """The cross layers' prefill: every query row attends all T image keys
    (kv_length T, no causal mask), nsel below, at and above T."""
    b, h, hk, s, t, d, dv = 2, 4, 2, 16, 24, 48, 16
    rng = np.random.default_rng(nsel)
    qb = hamming.pack_bits(torch.from_numpy(
        rng.normal(size=(b, h, s, d)).astype(np.float32)))
    kb = hamming.pack_bits(torch.from_numpy(
        rng.normal(size=(b, hk, t, d)).astype(np.float32)))
    v = rng.normal(size=(b, hk, t, dv)).astype(np.float32)
    qoff = np.array([0, 9], np.int32)
    scale = float(np.float32(1.0 / np.sqrt(d)))
    want = np.asarray(jops.prefill_attention(
        jnp.asarray(qb.numpy().view(np.uint32)),
        jnp.asarray(kb.numpy().view(np.uint32)), jnp.asarray(v), d=d,
        nsel=nsel, scale=scale, kv_length=t, q_offset=jnp.asarray(qoff),
        causal=False, block_q=8, block_t=8, interpret=True))
    got = ops.prefill_attention(
        qb, kb, torch.from_numpy(v), d=d, nsel=nsel, scale=scale,
        kv_length=torch.full((b,), t, dtype=torch.int32),
        q_offset=torch.from_numpy(qoff), causal=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# the Engine against the JAX Engine
# ---------------------------------------------------------------------------

ENGINE_PATHS = {"binary-paged": {}, "binary-dense": dict(paged=False),
                "fp-paged": dict(binary=False),
                "fp-dense": dict(binary=False, paged=False)}
SWAP = dict(n_pages=4, swap_pages=8)      # a pool that forces swap-outs
# counters of paged decode traffic: 0 on a dense cache, in both packages
PAGED_ONLY = ("decode_pages_touched", "decode_hbm_bytes")


def _statepool(eng):
    return {k: getattr(eng.statepool, k) for k in STATEPOOL}


@functools.lru_cache(maxsize=None)
def _jax_run(precision, swap=False):
    """The JAX Engine over `_requests()` on the paged cache (pooled cross
    state), binary or fp, with a roomy pool or SWAP's: (engine, tokens,
    serve counters, statepool counters). Each JAX engine compiles its own
    steps, so the tests share these runs."""
    jcfg, _ = _cfgs()
    eng = JEngine(jcfg, _params()[0], _scfg(
        JServeConfig, 2, binary=precision == "binary", **(SWAP if swap
                                                         else {})))
    return eng, _serve(eng, _requests()), _counters(eng), _statepool(eng)


@pytest.mark.parametrize("path", list(ENGINE_PATHS))
def test_engine_greedy_tokens_and_stats_match_jax_engine(path):
    """Tokens and every serve counter equal to the JAX Engine's paged run
    of the same precision. A dense engine is held to that run too: the
    JAX engine gives the same tokens and counters on its dense cache, less
    the paged decode traffic, which is 0 there."""
    precision, cache = path.split("-")
    _, want, want_stats, _ = _jax_run(precision)
    if cache == "dense":
        want_stats = dict(want_stats, **dict.fromkeys(PAGED_ONLY, 0))
    eng = Engine(_cfgs()[1], _model(), _scfg(ServeConfig, 2,
                                             **ENGINE_PATHS[path]),
                 device="cpu")
    got = _serve(eng, _requests())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert _counters(eng) == want_stats
    assert eng.runner.graph_count() == 2
    assert (eng.statepool is not None) == (cache == "paged")
    eng.check()


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fp"])
def test_pooled_state_swap_and_refill_match_jax(binary):
    """The port's test_cross_state_pooled_swap_and_refill_no_leak: under
    pool pressure with swap space the pooled cross entry swaps with the
    victim's pages; tokens equal the JAX Engine's and the unpreempted
    engine's (the JAX roomy run's); every serve counter and statepool
    counter equal JAX's under the same pressure (binary); refills of
    slots after image requests read zero cross caches, or the tokens
    would differ."""
    precision = "binary" if binary else "fp"
    _, tcfg = _cfgs()
    eng = Engine(tcfg, _model(), _scfg(ServeConfig, 2, binary=binary,
                                       **SWAP), device="cpu")
    got = _serve(eng, _requests())
    for g, w in zip(got, _jax_run(precision)[1]):
        np.testing.assert_array_equal(g, w)
    assert eng.stats["swap_outs"] > 0, "pool never forced a swap: test void"
    assert eng.stats["replayed_tokens"] == 0
    if binary:
        _, want, want_stats, want_pool = _jax_run(precision, swap=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert _counters(eng) == want_stats
        assert _statepool(eng) == want_pool
    assert eng.statepool.n_held == 0 and not eng.runner._swap_store
    assert eng.allocator.in_use == 0 and eng.swap.in_use == 0
    eng.statepool.check()
    eng.check()
    assert eng.runner.graph_count() == 2


def test_lockstep_prefill_with_images_matches_jax():
    """Engine.prefill(tokens, extra) then decode(), logits allclose to the
    JAX Engine's lockstep API on the paged cache with pooled state (the
    JAX engine of the binary run, which the lockstep prefill resets); the
    image rides with the first of two chunks."""
    _, tcfg = _cfgs()
    rng = np.random.default_rng(12)
    tok = rng.integers(0, 256, (2, 11)).astype(np.int32)
    extra = {"image_embeds": _image(13, rows=2)}
    jeng = _jax_run("binary")[0]
    eng = Engine(tcfg, _model(), _scfg(ServeConfig, 2), device="cpu")
    np.testing.assert_allclose(eng.prefill(tok, extra).numpy(),
                               np.asarray(jeng.prefill(tok, extra)),
                               **LOGIT_TOL)
    nxt = np.array([3, 250], np.int32)
    np.testing.assert_allclose(eng.decode(nxt).numpy(),
                               np.asarray(jeng.decode(nxt)), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fp"])
def test_state_swap_equals_unpreempted(binary):
    """Swap-out preemption with pooled state: tokens equal the engine
    whose pool never runs short, nothing is recomputed, every pool
    drains."""
    _, tcfg = _cfgs()
    model = _model()
    reqs = _requests((13, 5, 9), seed=45)
    want = _serve(Engine(tcfg, model, _scfg(ServeConfig, 2, binary=binary),
                         device="cpu"), reqs)
    eng = Engine(tcfg, model, _scfg(ServeConfig, 2, n_pages=3, swap_pages=8,
                                    binary=binary), device="cpu")
    got = _serve(eng, reqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    st = eng.stats
    assert st["swap_outs"] > 0 and st["replayed_tokens"] == 0
    assert eng.allocator.in_use == 0 and eng.swap.in_use == 0
    assert eng.statepool.n_held == 0
    eng.statepool.check()
    assert eng.runner.graph_count() == 2


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_prefill_chunks_keep_image_embeds(paged):
    """A prompt longer than the chunk: three chunks == one chunk, so the
    image filled before the first chunk survives the later ones."""
    _, tcfg = _cfgs()
    model = _model(seed=1)
    prompt = np.random.default_rng(7).integers(0, 256, 12).astype(np.int32)
    outs = {}
    for chunk in (4, 16):
        eng = Engine(tcfg, model, _scfg(ServeConfig, 1, max_len=24,
                                        prefill_chunk=chunk, paged=paged),
                     device="cpu")
        outs[chunk] = _serve(eng, [(prompt, {"image_embeds": _image(8)})],
                             4)[0]
    np.testing.assert_array_equal(outs[4], outs[16])


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_cross_cache_does_not_leak_across_slot_refill(paged):
    """A refilled slot whose new request carries no image attends a zero
    cross cache, not the previous occupant's image K/V."""
    _, tcfg = _cfgs()
    model = _model(seed=2)
    rng = np.random.default_rng(15)
    p_a, p_b = (rng.integers(0, 256, n).astype(np.int32) for n in (9, 5))
    scfg = _scfg(ServeConfig, 1, max_len=24, paged=paged)
    eng = Engine(tcfg, model, scfg, device="cpu")
    _serve(eng, [(p_a, {"image_embeds": _image(16)})], 3)
    # the slot's dense row, or the pool's one entry (less the trash entry)
    cross = eng.runner.caches[4]["v"][:1]
    assert cross.any()                            # the image is resident
    got = _serve(eng, [(p_b, None)], 3)[0]
    assert not cross.any()
    fresh = Engine(tcfg, model, scfg, device="cpu")
    np.testing.assert_array_equal(got, _serve(fresh, [(p_b, None)], 3)[0])


def test_text_only_prefix_cache_warm_equals_cold():
    """Text-only requests sharing a prefix: the warm engine (pages and a
    state checkpoint restored) gives the cold engine's tokens; requests
    with images never publish or consume cached pages."""
    _, tcfg = _cfgs()
    model = _model()
    rng = np.random.default_rng(20)
    shared = rng.integers(0, 256, 16).astype(np.int32)
    reqs = [(np.concatenate([shared, rng.integers(0, 256, n)
                             .astype(np.int32)]), None) for n in (5, 9)]
    img_req = [(np.concatenate([shared, [7, 8]]).astype(np.int32),
                {"image_embeds": _image(21)})]
    cold = [_serve(Engine(tcfg, model, _scfg(ServeConfig, 2), device="cpu"),
                   [r])[0] for r in reqs + img_req]
    eng = Engine(tcfg, model, _scfg(ServeConfig, 2, prefix_cache=True),
                 device="cpu")
    warm = [_serve(eng, [r])[0] for r in reqs + img_req]
    for w, c in zip(warm, cold):
        np.testing.assert_array_equal(w, c)
    assert eng.stats["cached_tokens"] == 16
    assert eng.stats["state_restores"] == 1
    assert eng.stats["state_ckpt_bytes"] > 0
    assert eng.runner.graph_count() == 2
    eng.statepool.check()
    eng.check()


def test_sync_pipelined_and_async_tokens_equal_with_extra():
    """Image and text-only requests, under sampling: step(),
    step_pipelined() and the AsyncEngine (submit(..., extra=)) give the
    same tokens; every engine keeps its two step graphs."""
    from repro_torch.serve import SamplingParams
    _, tcfg = _cfgs()
    model = _model()
    reqs = _requests((11, 6, 17), seed=30)
    sp = SamplingParams(temperature=0.8, top_k=20, seed=3)

    def engine():
        return Engine(tcfg, model, _scfg(ServeConfig, 2), device="cpu")

    def drive(eng, step):
        ids = [eng.submit(p, max_new_tokens=5, extra=e, sampling=sp)
               for p, e in reqs]
        out = {}
        while (eng.queue or any(s.request is not None for s in eng.slots)
               or eng._inflight is not None):
            for fr in step(eng)():
                out[fr.request_id] = fr.tokens
        return [out[i] for i in ids], eng

    sync, e1 = drive(engine(), lambda e: e.step)
    piped, e2 = drive(engine(), lambda e: e.step_pipelined)

    async def serve():
        aeng = AsyncEngine(engine())
        runner = asyncio.ensure_future(aeng.run())
        handles = [await aeng.submit(p, max_new_tokens=5, extra=e,
                                     sampling=sp) for p, e in reqs]
        outs = [await h.result() for h in handles]
        aeng.stop()
        await runner
        return outs, aeng.engine

    asynced, e3 = asyncio.run(serve())
    for a, b, c in zip(sync, piped, asynced):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert [e.runner.graph_count() for e in (e1, e2, e3)] == [2, 2, 2]


def test_vision_refusals_stay_pinned():
    """Requests with sequence-aligned `frames`, once refused here, are
    served: a 13-position frames prompt (two chunks) with an image, on the
    paged (pooled cross state) and the dense engine, gives the same tokens
    on both, other tokens than its placeholder token ids alone, and 2
    step graphs. (test_torch_frames.py holds frames on this model against
    the JAX Engine.)"""
    _, tcfg = _cfgs()
    prompt = np.arange(13, dtype=np.int32)
    frames = np.random.default_rng(2).normal(
        size=(1, 13, tcfg.frontend_dim)).astype(np.float32)
    reqs = [(prompt, {"frames": frames, "image_embeds": _image(3)}),
            (prompt, {"image_embeds": _image(3)})]
    got = {}
    for name, kw in (("paged", {}), ("dense", dict(paged=False))):
        eng = Engine(tcfg, _model(), _scfg(ServeConfig, 2, **kw),
                     device="cpu")
        got[name] = _serve(eng, reqs)
        assert eng.runner.graph_count() == 2
    for a, b in zip(got["paged"], got["dense"]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got["paged"][0], got["paged"][1])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(ENGINE_PATHS))
def test_graph_equals_eager_on_card(cuda, path):
    """Image and text-only requests through the captured step graphs and
    the eager step: the same tokens, bit for bit; 2 graphs and 0."""
    _, tcfg = _cfgs()
    model = _model().to(cuda)
    outs = []
    for eager in (False, True):
        eng = Engine(tcfg, model, _scfg(ServeConfig, 2,
                                        **ENGINE_PATHS[path]),
                     device=cuda, eager=eager)
        outs.append(_serve(eng, _requests()))
        assert eng.runner.graph_count() == (0 if eager else 2)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fp"])
def test_state_swap_on_card(cuda, binary):
    """Under CUDA graphs, swapped (pages and state entries) == unpreempted
    tokens: the swap-in wrote into the tensors the graphs replay over."""
    _, tcfg = _cfgs()
    model = _model().to(cuda)
    reqs = _requests((13, 5, 9), seed=45)
    base = Engine(tcfg, model, _scfg(ServeConfig, 2, binary=binary),
                  device=cuda)
    eng = Engine(tcfg, model, _scfg(ServeConfig, 2, n_pages=3, swap_pages=8,
                                    binary=binary), device=cuda)
    want, got = _serve(base, reqs), _serve(eng, reqs)
    assert eng.stats["swap_outs"] > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.runner.graph_count() == 2 and eng.statepool.n_held == 0
