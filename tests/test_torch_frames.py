"""`frames` requests through the port's serving stack against the JAX
package, and the frames-slot resume rule.

A prompt may arrive as frames (`extra={"frames": [1, S, frontend_dim]}`,
the audio / vision stub frontend): each prefill chunk embeds its slice
through ``frontend_proj`` instead of the token table, then decode runs on
the sampled tokens as usual. No JAX test serves frames, so these cases
hold the port's Engine against the JAX Engine run here, on the causal
config of the JAX ragged-serving tests with a frontend (`frontend_dim`
8, float32), over paged and dense caches, binary and full precision,
with frames prompts longer than one chunk beside token prompts: greedy
tokens and every serve counter equal; `serve_step`'s logits over a
frames chunk at LOGIT_TOL. The scheduler's resume rule for sequence-
aligned extras (copied from the JAX package) is live: a frames slot that
has generated tokens is never a preemption victim. Reduced
llama-3.2-vision-11b takes frames prompts beside image embeddings.
On the card (`cuda` marker): a frames engine's tokens on the card equal
the CPU's, and a reduced deit-t distill step on the card the CPU's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ModelConfig as JModelConfig
from repro.models import model as JM
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro.serve.engine import Request as JRequest
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.scheduler import Request
from repro_torch.serve.telemetry import SERVE_COUNTERS

# serve counters of the port alone
PORT_COUNTERS = ("state_evictions", "state_misses")

LOGIT_TOL = dict(rtol=1e-4, atol=2e-5)   # float32, XLA vs ATen sum order
FD = 8                                   # frontend_dim
# tests/test_serve_ragged.py's CFG, with a frontend
CFG_KW = dict(name="rag", family="dense", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab_size=64, head_dim=16,
              param_dtype="float32", q_block=16, remat=False,
              frontend_dim=FD)
JCFG, TCFG = JModelConfig(**CFG_KW), ModelConfig(**CFG_KW)
PATHS = {"binary-paged": {}, "binary-dense": dict(paged=False),
         "fp-paged": dict(binary=False),
         "fp-dense": dict(binary=False, paged=False)}
PAGED_ONLY = ("decode_pages_touched", "decode_hbm_bytes")


@functools.lru_cache(maxsize=None)
def _params(seed=10):
    return JM.init_params(jax.random.PRNGKey(seed), JCFG)


def _model():
    return params_from_numpy(jax.tree.map(np.asarray, _params()), TCFG)


def _scfg(cls, slots=3, **kw):
    base = dict(max_len=48, batch_slots=slots, binary=True, topn=6,
                prefill_chunk=8, paged=True, page_size=8)
    base.update(kw)
    return cls(**base)


@functools.lru_cache(maxsize=None)
def _requests():
    """Frames prompts of 13 and 6 positions (13 spans two chunks) and a
    token prompt of 9, each with 5 new tokens."""
    rng = np.random.default_rng(3)
    out = []
    for n, frames in ((13, True), (9, False), (6, True)):
        toks = rng.integers(0, 64, n).astype(np.int32)
        extra = ({"frames": rng.standard_normal((1, n, FD)).astype(
            np.float32)} if frames else None)
        out.append((toks, extra))
    return tuple(out)


def _serve(eng, reqs, gen=5):
    ids = [eng.submit(t, max_new_tokens=gen, extra=e) for t, e in reqs]
    out = eng.run()
    return [np.asarray(out[i]) for i in ids]


def _counters(eng):
    """Every serve counter the JAX Engine has too (it counts no state
    evictions or misses). It counts no `prefill_rows`: the port's chunks
    carry one row each, so its count is the JAX chunks'."""
    jax_side = isinstance(eng, JEngine)
    return {k: eng.stats["prefill_chunks" if jax_side and k == "prefill_rows"
                         else k] for k in SERVE_COUNTERS
            if k not in PORT_COUNTERS}


@functools.lru_cache(maxsize=None)
def _jax_run(binary):
    eng = JEngine(JCFG, _params(), _scfg(JServeConfig, binary=binary))
    toks = _serve(eng, _requests())
    return toks, _counters(eng)


@pytest.mark.parametrize("path", list(PATHS))
def test_frames_engine_matches_jax_engine(path):
    precision, cache = path.split("-")
    want, want_stats = _jax_run(precision == "binary")
    if cache == "dense":
        want_stats = dict(want_stats, **dict.fromkeys(PAGED_ONLY, 0))
    eng = Engine(TCFG, _model(), _scfg(ServeConfig, **PATHS[path]),
                 device="cpu")
    got = _serve(eng, _requests())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert _counters(eng) == want_stats
    assert eng.stats["prefill_chunks"] == 2 + 2 + 1
    assert eng.runner.graph_count() == 2


def test_frames_change_the_tokens():
    """The frames, not the placeholder tokens, feed the prompt: the same
    token ids without frames give other tokens."""
    eng = Engine(TCFG, _model(), _scfg(ServeConfig), device="cpu")
    with_frames = _serve(eng, _requests())
    without = _serve(eng, [(t, None) for t, _ in _requests()])
    assert not np.array_equal(with_frames[0], without[0])
    np.testing.assert_array_equal(with_frames[1], without[1])


@pytest.mark.parametrize("rows", ["all", "one"])
def test_serve_step_frames_logits(rows):
    """A prefill chunk embedded through frontend_proj: logits against the
    JAX serve_step over the same frames (every row, or one row's frames
    beside token rows in the port)."""
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 64, (2, 8)).astype(np.int32)
    frames = rng.standard_normal((2, 8, FD)).astype(np.float32)
    jcaches = JM.init_caches(JCFG, 2, 16, binary=True)
    jl, _ = JM.serve_step(_params(), {"tokens": jnp.asarray(tokens),
                                      "frames": jnp.asarray(frames)},
                          jcaches, cfg=JCFG, pos=jnp.zeros((2,), jnp.int32),
                          n=6, binary=True)
    model = _model()
    caches = T.init_caches(TCFG, paged=False, batch=2, max_len=16)
    sel = None if rows == "all" else torch.tensor([True, False])
    got = T.serve_step(model, torch.from_numpy(tokens), caches,
                       pos=torch.zeros(2, dtype=torch.int32), n=6,
                       frames=torch.from_numpy(frames), frames_rows=sel)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jl)[0],
                               **LOGIT_TOL)
    if rows == "one":
        plain = T.serve_step(model, torch.from_numpy(tokens),
                             T.init_caches(TCFG, paged=False, batch=2,
                                           max_len=16),
                             pos=torch.zeros(2, dtype=torch.int32), n=6)
        np.testing.assert_array_equal(got[1].numpy(), plain[1].numpy())
    else:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(jl)[1],
                                   **LOGIT_TOL)


def test_frames_slot_is_never_a_preemption_victim():
    """The JAX rule (tests/test_serve_ragged.py): recompute resume cannot
    replay sequence-aligned extras for generated positions, so a frames
    slot with generated tokens is never a victim; with no clean victim the
    scheduler raises; before its first token it is a clean replay."""
    eng = Engine(TCFG, _model(), _scfg(ServeConfig, 2, n_pages=4),
                 device="cpu")
    sched = eng.scheduler
    r0 = Request(tokens=np.arange(6, dtype=np.int32), request_id=0,
                 extra={"frames": np.zeros((1, 6, FD), np.float32)})
    r1 = Request(tokens=np.arange(4, dtype=np.int32), request_id=1)
    sched._admit(0, r0)
    sched._admit(1, r1)
    sched.slots[0].generated = [3]
    sched.slots[1].generated = [5]
    assert sched._pick_victim() == 1
    sched.slots[1].request = None
    with pytest.raises(RuntimeError):
        sched._pick_victim()
    sched.slots[0].generated = []
    assert sched._pick_victim() == 0
    # the JAX scheduler decides the same
    jeng = JEngine(JCFG, _params(), _scfg(JServeConfig, 2, n_pages=4))
    jeng._admit(0, JRequest(tokens=r0.tokens, request_id=0, extra=r0.extra))
    jeng._admit(1, JRequest(tokens=r1.tokens, request_id=1))
    jeng.slots[0].generated = [3]
    jeng.slots[1].generated = [5]
    assert jeng._pick_victim() == 1


def test_frames_preempted_pool_serves_clean_victims_first():
    """A pool too small for three requests preempts by recompute: the
    token request is the victim, never a frames request that has started
    decoding, and every request's tokens equal a roomy engine's."""
    roomy = Engine(TCFG, _model(), _scfg(ServeConfig), device="cpu")
    want = _serve(roomy, _requests(), gen=12)
    eng = Engine(TCFG, _model(), _scfg(ServeConfig, n_pages=6),
                 device="cpu")
    got = _serve(eng, _requests(), gen=12)
    assert eng.stats["preemptions"] >= 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@functools.lru_cache(maxsize=None)
def _vision_run():
    jcfg = jget_config("llama-3.2-vision-11b", reduced=True)
    p = JM.init_params(jax.random.PRNGKey(5), jcfg)
    rng = np.random.default_rng(6)
    reqs = []
    for n, kind in ((12, "frames+image"), (7, "frames"), (9, "image")):
        extra = {}
        if "frames" in kind:
            extra["frames"] = rng.standard_normal(
                (1, n, jcfg.frontend_dim)).astype(np.float32)
        if "image" in kind:
            extra["image_embeds"] = rng.standard_normal(
                (1, jcfg.n_image_tokens, jcfg.frontend_dim)).astype(
                np.float32)
        reqs.append((rng.integers(0, jcfg.vocab_size, n).astype(np.int32),
                     extra))
    eng = JEngine(jcfg, p, _scfg(JServeConfig, max_len=32))
    return p, tuple(reqs), _serve(eng, reqs, gen=4)


@pytest.mark.parametrize("paged", [True, False])
def test_frames_on_reduced_vision_match_jax(paged):
    """llama-3.2-vision-11b (AAAAC, reduced): frames prompts with and
    without image embeddings beside an image request, on the pooled
    paged engine and the dense one: tokens equal the JAX Engine's."""
    p, reqs, want = _vision_run()
    cfg = get_config("llama-3.2-vision-11b", reduced=True)
    eng = Engine(cfg, params_from_numpy(jax.tree.map(np.asarray, p), cfg),
                 _scfg(ServeConfig, max_len=32, paged=paged), device="cpu")
    for g, w in zip(_serve(eng, reqs, gen=4), want):
        np.testing.assert_array_equal(g, w)
    assert eng.runner.graph_count() == 2


def test_frames_need_a_frontend():
    cfg = dataclasses.replace(TCFG, frontend_dim=0)
    model = T.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, model, _scfg(ServeConfig), device="cpu")
    eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=2,
               extra={"frames": np.zeros((1, 5, FD), np.float32)})
    with pytest.raises(ValueError, match="frontend"):
        eng.run()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("path", ["binary-paged", "fp-dense"])
def test_frames_engine_on_card_matches_cpu(path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(TCFG, _model(), _scfg(ServeConfig, **PATHS[path]),
                     device=dev)
        out[dev] = _serve(eng, _requests())
        assert eng.runner.graph_count() == 2
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_one_row_prefill_graph_equals_eager_on_card(path):
    """Frames and token chunks through the one-row prefill graph and the
    eager step: the logits of every chunk bit for bit (a frames chunk on
    slot 0, a token chunk on slot 2, slot 0's second frames chunk), then
    the served tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((1, 16, FD)).astype(np.float32)
    toks = rng.integers(0, 64, 16).astype(np.int32)
    bt = np.arange(18, dtype=np.int32).reshape(3, 6)
    chunks = [(0, toks[:8], 0, {"frames": frames[:, :8]}),
              (2, toks[:5], 0, None), (0, toks[8:], 8,
                                       {"frames": frames[:, 8:]})]
    logits, served = [], []
    for eager in (False, True):
        eng = Engine(TCFG, _model(), _scfg(ServeConfig, **PATHS[path]),
                     device="cuda", eager=eager)
        paged = eng.scfg.paged
        logits.append([eng.runner.prefill_step(
            slot, t, pos, bt[slot] if paged else None, -1, extra).clone()
            for slot, t, pos, extra in chunks])
        assert eng.runner._inputs["prefill"].views["tokens"].shape == (1, 8)
        eng = Engine(TCFG, _model(), _scfg(ServeConfig, **PATHS[path]),
                     device="cuda", eager=eager)
        served.append(_serve(eng, _requests()))
        assert eng.runner.graph_count() == (0 if eager else 2)
    for a, b in zip(*logits):
        assert torch.equal(a, b)
    for a, b in zip(*served):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_deit_frames_distill_step_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core.distill import DistillConfig, tiny_schedule
    from repro_torch.optim import adam
    from repro_torch.train import steps as STEPS
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("deit-t", reduced=True)
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((2, 32, cfg.frontend_dim)).astype(
        np.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        teacher = T.init_params(cfg, torch.Generator().manual_seed(0),
                                device=dev)
        state = STEPS.init_distill_state(cfg, adam.AdamWConfig(),
                                         teacher=teacher, device=dev)
        fn = STEPS.build_distill_step(cfg, DistillConfig(
            schedule=tiny_schedule(1), lr_stages_123=1e-3),
            adam.AdamWConfig(), topn=8)
        state, m = fn(state, {"frames": torch.from_numpy(frames).to(dev)})
        res[dev] = {k: float(v) for k, v in m.items()}
    for k, v in res["cpu"].items():
        np.testing.assert_allclose(res["cuda"][k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
