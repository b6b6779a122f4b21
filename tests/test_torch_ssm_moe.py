"""SSM (Mamba2) layers and MoE FFNs in the port against the JAX package:
reduced mamba2-130m (two "M" layers), reduced jamba-1.5-large-398b
(MMMMAMMM, MoE at every second position) and reduced dbrx-132b (one "A"
layer with an MoE FFN), float32.

The JAX side runs on its plain reference path (``HADConfig()``), on the
same weights (`params_from_numpy`) and numpy-seeded inputs. Pinned at
TOL (module outputs and state) or LOGIT_TOL (logits): `_conv_causal` with
per-row n_valid (0 included), `ssd_chunked` at a length the chunk does
not divide with an initial state, `ssd_step`, `ssm_forward` /
`ssm_decode`, `moe_ffn(no_drop=True)` with groups spanning rows, with
capacity drops and with forced ties between experts; `serve_step` over a prefill chunk (a padded
row), a chunk where one row is refilled fresh, and decode steps, on the
three models with pooled and dense state, binary and fp (SSM state h and
conv allclose); Engine greedy tokens and every serve counter (and the
statepool's) equal to the JAX Engine's on paged (pooled state), dense,
prefix warm == cold and swap-out preemption. A JAX engine compiles its
own steps, so the tests share the JAX runs (`_jax_run`). Inside the port:
swapped == unpreempted, ragged == sequential, recompute, two step graphs.
On the card (`cuda` marker): graph == eager and the state swap, bit for
bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import ssm as JSSM
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import moe, ssm
from repro_torch.models import transformer as T
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.telemetry import SERVE_COUNTERS

from test_torch_graphs import _clone, _randomize, _rows_changed

# serve counters of the port alone
PORT_COUNTERS = ("state_evictions", "state_misses")

MAMBA, JAMBA, DBRX = "mamba2-130m", "jamba-1.5-large-398b", "dbrx-132b"
LOGIT_TOL = dict(rtol=1e-4, atol=2e-5)   # float32, XLA vs ATen sum order
TOL = dict(rtol=1e-5, atol=1e-6)
STATEPOOL = ("hits", "misses", "registered", "evictions", "peak_held")
# the reduced configs; mamba2 at two layers, so that state passes a layer
LAYERS = {MAMBA: 2, JAMBA: 8, DBRX: 1}


def _cfgs(arch):
    kw = dict(n_layers=LAYERS[arch])
    return (jget_config(arch, reduced=True, **kw),
            get_config(arch, reduced=True, **kw))


@functools.lru_cache(maxsize=None)
def _params(arch, seed=0):
    jcfg, _ = _cfgs(arch)
    pj = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return pj, jax.tree.map(np.asarray, pj)


def _model(arch, seed=0):
    return params_from_numpy(_params(arch, seed)[1], _cfgs(arch)[1],
                             device="cpu")


def _layer(arch, pos, seed=0):
    """(JAX params of pattern position `pos`, group 0; the port's block)."""
    pj, _ = _params(arch, seed)
    return (jax.tree.map(lambda x: x[0], pj["blocks"][f"pos{pos}"]),
            _model(arch, seed).blocks[pos])


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# the SSM layer's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_conv_causal_matches_jax(with_state):
    """Per-row n_valid 0 (the old state carries), 3 (< K-1 + ...), the
    full chunk and one past K-1; the output and the carried K-1 inputs."""
    rng = np.random.default_rng(1)
    b, s, di, k = 4, 6, 8, 4
    xs = rng.normal(size=(b, s, di)).astype(np.float32)
    w = rng.normal(size=(k, di)).astype(np.float32)
    state = (rng.normal(size=(b, k - 1, di)).astype(np.float32)
             if with_state else None)
    nv = np.array([0, 3, 6, 4], np.int32)
    for n_valid in (None, nv):
        jy, js = JSSM._conv_causal(
            jnp.asarray(xs), jnp.asarray(w),
            None if state is None else jnp.asarray(state),
            n_valid=None if n_valid is None else jnp.asarray(n_valid))
        ty, ts = ssm._conv_causal(
            _t(xs), _t(w), None if state is None else _t(state),
            n_valid=None if n_valid is None else _t(n_valid))
        np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
        np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)
    if with_state:          # n_valid 0 carries the old state unchanged
        np.testing.assert_array_equal(ts[0].numpy(), state[0])


@pytest.mark.parametrize("s,chunk", [(12, 8), (7, 4), (8, 8)],
                         ids=["12-by-8", "7-by-4", "8-by-8"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_ssd_chunked_matches_jax(s, chunk, with_h0):
    """S not divisible by the chunk (the chunk shrinks to a divisor: 12 ->
    6, 7 -> 1), and a dividing one; from zero or from a carried state.
    The last head decays fast (A = -200): above the diagonal its
    exp(cum_t - cum_s) overflows to inf, which must not leak NaN."""
    rng = np.random.default_rng(s + chunk)
    b, nh, p, n = 2, 3, 4, 5
    xh = rng.normal(size=(b, s, nh, p)).astype(np.float32)
    dt = np.abs(rng.normal(size=(b, s, nh))).astype(np.float32) + 0.5
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32)
              for _ in range(2))
    a = np.array([-0.3, -1.2, -200.0], np.float32)
    dsk = rng.normal(size=nh).astype(np.float32)
    h0 = (rng.normal(size=(b, nh, n, p)).astype(np.float32) if with_h0
          else None)
    jy, jh = JSSM.ssd_chunked(*map(jnp.asarray, (xh, dt, bm, cm, a, dsk)),
                              chunk=chunk,
                              h0=None if h0 is None else jnp.asarray(h0))
    ty, th = ssm.ssd_chunked(*map(_t, (xh, dt, bm, cm, a, dsk)),
                             chunk=chunk, h0=None if h0 is None else _t(h0))
    assert torch.isfinite(ty).all() and torch.isfinite(th).all()
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)


def test_ssd_step_matches_jax():
    rng = np.random.default_rng(3)
    b, nh, p, n = 3, 4, 8, 6
    xh = rng.normal(size=(b, nh, p)).astype(np.float32)
    dt = np.abs(rng.normal(size=(b, nh))).astype(np.float32)
    bv, cv = (rng.normal(size=(b, n)).astype(np.float32) for _ in range(2))
    a = -np.exp(rng.normal(size=nh)).astype(np.float32)
    dsk = rng.normal(size=nh).astype(np.float32)
    h = rng.normal(size=(b, nh, n, p)).astype(np.float32)
    args = (xh, dt, bv, cv, a, dsk, h)
    jy, jh = JSSM.ssd_step(*map(jnp.asarray, args))
    ty, th = ssm.ssd_step(*map(_t, args))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)


def _random_ssm_params(arch, seed):
    """Position 0's SSM weights with A_log, D and dt_bias drawn (the init
    gives them constants) in both packages."""
    jp, blk = _layer(arch, 0)
    rng = np.random.default_rng(seed)
    mixer = dict(jp["mixer"])
    for name in ("A_log", "D", "dt_bias"):
        val = rng.normal(size=mixer[name].shape).astype(np.float32) * 0.5
        mixer[name] = jnp.asarray(val)
        getattr(blk.mixer, name).copy_(_t(val))
    return mixer, blk.mixer


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_ssm_forward_and_decode_match_jax(arch):
    """A padded chunk (row 1 has 5 valid tokens of 11; the chunk shrinks
    below the config's) from a carried state, then two decode steps: the
    outputs at valid positions and the state, h and conv."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _random_ssm_params(arch, 4)
    rng = np.random.default_rng(5)
    b, s = 2, 11
    x = rng.normal(size=(b, s, tcfg.d_model)).astype(np.float32)
    state = {"h": rng.normal(size=(b, tcfg.ssm_heads, tcfg.ssm_state,
                                   tcfg.ssm_head_dim)).astype(np.float32),
             "conv": rng.normal(size=(b, 3, tcfg.d_inner)).astype(
                 np.float32)}
    nv = np.array([s, 5], np.int32)
    jo, js = JSSM.ssm_forward(jp, jnp.asarray(x), cfg=jcfg,
                              state={k: jnp.asarray(v)
                                     for k, v in state.items()},
                              n_valid=jnp.asarray(nv))
    to, ts = ssm.ssm_forward(tp, _t(x), cfg=tcfg,
                             state={k: _t(v) for k, v in state.items()},
                             n_valid=_t(nv))
    np.testing.assert_allclose(to[0].numpy(), _np(jo[0]), **TOL)
    np.testing.assert_allclose(to[1, :5].numpy(), _np(jo[1, :5]), **TOL)
    for _ in range(2):
        for key in ("h", "conv"):
            np.testing.assert_allclose(ts[key].numpy(), _np(js[key]), **TOL)
        x1 = rng.normal(size=(b, 1, tcfg.d_model)).astype(np.float32)
        jo, js = JSSM.ssm_decode(jp, jnp.asarray(x1), cfg=jcfg, state=js)
        to, ts = ssm.ssm_decode(tp, _t(x1), cfg=tcfg, state=ts)
        np.testing.assert_allclose(to.numpy(), _np(jo), **TOL)


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------

MOE_CASES = {  # (arch, experts, top-k, tokens [B, S], router)
    "dbrx": (DBRX, 4, 2, (3, 7), "normal"),
    "groups-span-rows": (DBRX, 4, 2, (3, 200), "normal"),
    "jamba-drops": (JAMBA, 16, 2, (2, 32), "skewed"),
    "tie-all": (DBRX, 4, 2, (2, 5), "zero"),
    "tie-pair": (DBRX, 4, 2, (2, 6), "pair"),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_matches_jax(case):
    """moe_ffn(no_drop=True) on seeded weights at fan-in std: 21 tokens (one
    group); 600 (groups of 300 spanning rows); jamba's 16 experts top-2 at
    64 tokens, where capacity (33) is below the group and a router skewed
    to expert 0 overflows it (dropped slots add nothing); ties: a zero
    router (every expert ties: experts 0 and 1 win) and a router whose
    experts 1 and 2 share a column (each token's two tie)."""
    arch, e, k, shape, router = MOE_CASES[case]
    jcfg, tcfg = (dataclasses.replace(c, n_experts=e, experts_per_token=k)
                  for c in _cfgs(arch))
    d, f = tcfg.d_model, tcfg.d_ff
    rng = np.random.default_rng(len(case))
    w = {"router": rng.normal(size=(d, e)).astype(np.float32) * d ** -0.5,
         "w1": rng.normal(size=(e, d, f)).astype(np.float32) * d ** -0.5,
         "w2": rng.normal(size=(e, f, d)).astype(np.float32) * f ** -0.5,
         "w3": rng.normal(size=(e, d, f)).astype(np.float32) * d ** -0.5}
    if router == "zero":
        w["router"][:] = 0
    elif router == "pair":
        w["router"][:, 2] = w["router"][:, 1]
    tffn = moe.MoE(tcfg)
    x = rng.normal(size=shape + (d,)).astype(np.float32)
    if router == "skewed":             # inputs with a mean expert 0 reads
        w["router"][:, 0] = 0.2
        x += 1
    for name, val in w.items():
        getattr(tffn, name).copy_(_t(val))
    g, tg, cap = moe.group_shape(shape[0] * shape[1], tcfg)
    _, experts = moe.route(tffn, _t(x).reshape(g, tg, d), tcfg)
    if router in ("zero", "pair"):     # the tie holds in the port's probs
        probs = torch.softmax(_t(x).reshape(g, tg, d) @ tffn.router, -1)
        assert torch.equal(probs[..., 1], probs[..., 2])
        assert (experts[..., 0] < experts[..., 1]).all() or router == "pair"
    if router == "skewed":             # some slots overflow their expert
        assert cap < tg and int((experts == 0).sum()) > cap
    want, _ = JMOE.moe_ffn({n: jnp.asarray(v) for n, v in w.items()},
                           jnp.asarray(x), cfg=jcfg, no_drop=True)
    got = moe.moe_ffn(tffn, _t(x), cfg=tcfg)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# ---------------------------------------------------------------------------
# serve_step against JAX
# ---------------------------------------------------------------------------

SERVE_PATHS = {"pooled-binary": (True, True), "dense-fp": (False, False)}


@pytest.mark.parametrize("path", list(SERVE_PATHS))
@pytest.mark.parametrize("arch", [MAMBA, JAMBA, DBRX])
def test_serve_step_matches_jax(arch, path):
    """A prefill chunk (row 1 padded to 5 of 8 tokens), a chunk where row 0
    goes on and row 1 is refilled fresh (its SSM state must read zeros),
    then two decode steps, the second with row 0 inactive (its state must
    not move). Paged self-attention pools and pooled state (entries 3 and
    1 of 4) on the binary path, or dense caches in full precision (each
    JAX step runs op by op, so the other two pairings are left to the
    Engine tests). The active rows' logits
    allclose (LOGIT_TOL) and every SSM layer's h and conv after each step:
    the first layer's at TOL, later layers' at LOGIT_TOL (their inputs
    carry the float32 differences of the layers below, MoE outputs of
    magnitude ~100 among them)."""
    pooled, binary = SERVE_PATHS[path]
    jcfg, tcfg = _cfgs(arch)
    pj, _ = _params(arch)
    model = _model(arch)
    b, max_len, page, n_pages, entries = 2, 32, 8, 8, 4
    rng = np.random.default_rng(6)
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
    steps = [  # (tokens [B, S], pos, active, n_valid)
        (rng.integers(0, 256, (b, 8)), [0, 0], [1, 1], [8, 5]),
        (rng.integers(0, 256, (b, 8)), [8, 0], [1, 1], [6, 7]),
        (rng.integers(0, 256, (b, 1)), [14, 7], [1, 1], None),
        (rng.integers(0, 256, (b, 1)), [15, 8], [0, 1], None),
    ]
    kinds = T.layer_kinds(tcfg)
    for tok, pos, act, nv in steps:
        tok = np.asarray(tok, np.int32)
        pos, act = np.asarray(pos, np.int32), np.asarray(act, bool)
        jl, jc = JM.serve_step(
            pj, {"tokens": jnp.asarray(tok)}, jc, cfg=jcfg,
            pos=jnp.asarray(pos), n=6, binary=binary, logits_mode="last",
            active=jnp.asarray(act),
            n_valid=None if nv is None else jnp.asarray(nv, jnp.int32),
            block_tables=None if bt is None else jnp.asarray(bt),
            state_tables=None if st is None else jnp.asarray(st))
        tl = T.serve_step(
            model, _t(tok), tc, pos=_t(pos), n=6, binary=binary,
            logits_mode="last", active=_t(act),
            n_valid=None if nv is None else torch.tensor(nv,
                                                         dtype=torch.int32),
            block_tables=None if bt is None else _t(bt),
            state_tables=None if st is None else _t(st))
        # an inactive row's logits are garbage in both packages
        np.testing.assert_allclose(tl.numpy()[act], _np(jl)[act],
                                   **LOGIT_TOL)
        for layer, kind in enumerate(kinds):
            if kind != "M":
                continue
            g, i = divmod(layer, tcfg.group_size)
            for key in ("h", "conv"):
                want = _np(jc[f"pos{i}"][key][g])
                got = tc[layer][key].numpy()
                np.testing.assert_allclose(
                    got[:entries] if pooled else got, want,
                    **(TOL if layer == 0 else LOGIT_TOL))


# ---------------------------------------------------------------------------
# the Engine against the JAX Engine
# ---------------------------------------------------------------------------

ENGINE_PATHS = {"binary-paged": {}, "binary-dense": dict(paged=False),
                "fp-paged": dict(binary=False),
                "fp-dense": dict(binary=False, paged=False)}
SWAP = dict(n_pages=4, swap_pages=8)      # a pool that forces swap-outs
# counters of paged decode traffic: 0 on a dense cache, in both packages
PAGED_ONLY = ("decode_pages_touched", "decode_hbm_bytes")


def _scfg(cls, slots, **kw):
    base = dict(max_len=48, batch_slots=slots, binary=True, topn=6,
                prefill_chunk=8, paged=True, page_size=8)
    base.update(kw)
    return cls(**base)


def _requests(lengths=(13, 5, 9, 20), seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lengths]


def _prefixed(seed=20):
    """Three prompts sharing a 16-token (two-page) prefix."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, 16).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, 256, n).astype(
        np.int32)]) for n in (5, 9, 3)]


def _serve(eng, prompts, gen=5, one_by_one=False):
    """Greedy tokens of `prompts`: all submitted, then run; or each run to
    its end before the next is submitted (`one_by_one`)."""
    if one_by_one:
        return [_serve(eng, [p], gen)[0] for p in prompts]
    ids = [eng.submit(p, max_new_tokens=gen) for p in prompts]
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


def _statepool(eng):
    return {k: getattr(eng.statepool, k) for k in STATEPOOL}


def _precision(arch, precision):
    """mamba2 has no attention layer, so its binary and fp engines are one
    engine: the JAX launcher serves it with binary=False."""
    return "fp" if arch == MAMBA else precision


@functools.lru_cache(maxsize=None)
def _jax_run(arch, precision, kind="paged"):
    """The JAX Engine over the paged cache (pooled state), binary or fp:
    `_requests()` with a roomy pool ("paged") or SWAP's ("swap"), or
    `_prefixed()` one by one with prefix caching ("prefix"). Returns
    (tokens, serve counters, statepool counters or None). Each JAX engine
    compiles its own steps, so the tests share these runs."""
    jcfg, _ = _cfgs(arch)
    kw = dict(binary=precision == "binary", **(SWAP if kind == "swap"
                                               else {}))
    if kind == "prefix":
        kw["prefix_cache"] = True
    eng = JEngine(jcfg, _params(arch)[0], _scfg(JServeConfig, 2, **kw))
    toks = (_serve(eng, _prefixed(), one_by_one=True) if kind == "prefix"
            else _serve(eng, _requests()))
    return (toks, _counters(eng),
            None if eng.statepool is None else _statepool(eng))


def _engine(arch, slots=2, model=None, device="cpu", **kw):
    return Engine(_cfgs(arch)[1], _model(arch) if model is None else model,
                  _scfg(ServeConfig, slots, **kw), device=device)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("path", list(ENGINE_PATHS))
@pytest.mark.parametrize("arch", [MAMBA, JAMBA, DBRX])
def test_engine_greedy_tokens_and_stats_match_jax_engine(arch, path):
    """Tokens and every serve counter equal to the JAX Engine's paged run
    of the same precision (pooled SSM state, statepool counters too). A
    dense engine (per-slot state rows) is held to that run too: the JAX
    engine gives the same tokens and counters on its dense cache, less
    the paged decode traffic, which is 0 there."""
    precision, cache = path.split("-")
    want, want_stats, want_pool = _jax_run(arch, _precision(arch, precision))
    if cache == "dense":
        want_stats = dict(want_stats, **dict.fromkeys(PAGED_ONLY, 0))
    eng = _engine(arch, **ENGINE_PATHS[path])
    _equal(_serve(eng, _requests()), want)
    assert _counters(eng) == want_stats
    assert eng.runner.graph_count() == 2
    has_state = arch != DBRX
    assert (eng.statepool is not None) == (cache == "paged" and has_state)
    if eng.statepool is not None:
        assert _statepool(eng) == want_pool
        assert eng.statepool.n_held == 0
        eng.statepool.check()
    eng.check()


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_state_swap_matches_jax_and_unpreempted(arch):
    """Under pool pressure with swap space, each victim's pooled state
    entry (h, conv) swaps with its pages: tokens equal the JAX Engine's
    under the same pressure and the unpreempted run's, nothing is
    recomputed, every serve and statepool counter equals JAX's, and every
    pool drains."""
    want, want_stats, want_pool = _jax_run(arch, "binary", "swap")
    eng = _engine(arch, **SWAP)
    got = _serve(eng, _requests())
    _equal(got, want)
    _equal(got, _jax_run(arch, "binary")[0])
    st = eng.stats
    assert st["swap_outs"] > 0, "pool never forced a swap: test void"
    assert st["replayed_tokens"] == 0
    assert _counters(eng) == want_stats
    assert _statepool(eng) == want_pool
    assert eng.statepool.n_held == 0 and not eng.runner._swap_store
    assert eng.allocator.in_use == 0 and eng.swap.in_use == 0
    eng.statepool.check()
    eng.check()
    assert eng.runner.graph_count() == 2


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_prefix_cache_warm_matches_jax_and_cold(arch):
    """Prompts sharing a two-page prefix, one at a time: the warm engine
    restores the pages and the SSM state checkpoint; its tokens, serve
    counters and statepool counters equal the JAX Engine's, and its
    tokens equal cold engines' (one fresh engine a prompt)."""
    want, want_stats, want_pool = _jax_run(arch, "binary", "prefix")
    eng = _engine(arch, prefix_cache=True)
    warm = _serve(eng, _prefixed(), one_by_one=True)
    _equal(warm, want)
    assert _counters(eng) == want_stats
    assert _statepool(eng) == want_pool
    assert eng.stats["state_restores"] == 2
    assert eng.stats["state_ckpt_bytes"] > 0
    model = _model(arch)
    cold = [_serve(_engine(arch, model=model), [p])[0] for p in _prefixed()]
    _equal(warm, cold)
    eng.statepool.check()
    eng.check()
    assert eng.runner.graph_count() == 2


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------

RAGGED = {"paged": {}, "dense": dict(paged=False),
          "recompute": dict(n_pages=5), "swap": dict(n_pages=5,
                                                     swap_pages=16)}


@pytest.mark.parametrize("variant", list(RAGGED))
@pytest.mark.parametrize("arch", [MAMBA, JAMBA, DBRX])
def test_ragged_equals_sequential(arch, variant):
    """Three slots of ragged batches equal one request at a time, bit for
    bit, on the paged and dense caches and under recompute and swap-out
    preemption (a recomputed request restarts from zero state; a swapped
    one resumes its state entry). The MoE groups span rows, and no token
    is dropped at these sizes, so a row's tokens never depend on the
    others'."""
    model = _model(arch)
    prompts = _requests((19, 4, 11, 25, 7), seed=3)
    kw = RAGGED[variant]
    eng = _engine(arch, slots=3, model=model, **kw)
    got = _serve(eng, prompts, 6)
    eng.check()
    if variant in ("recompute", "swap"):
        assert eng.stats["preemptions"] > 0
    assert (eng.stats["swap_outs"] > 0) == (variant == "swap")
    one = _engine(arch, slots=1, model=model,
                  **{k: v for k, v in kw.items() if k == "paged"})
    _equal(got, [_serve(one, [p], 6)[0] for p in prompts])
    assert eng.runner.graph_count() == 2


def test_cache_device_bytes_count_ssm_state():
    """A pure-SSM engine holds no page pool: its cache bytes are its SSM
    state, dense rows or pooled entries (plus the trash entry), float32 h
    and conv inputs in the model dtype."""
    _, tcfg = _cfgs(MAMBA)
    per = (tcfg.ssm_heads * tcfg.ssm_state * tcfg.ssm_head_dim * 4
           + 3 * tcfg.d_inner * 4) * tcfg.n_layers
    for kw, rows in ((dict(paged=False), 2), ({}, 3),
                     (dict(state_pages=5), 6)):
        eng = _engine(MAMBA, **kw)
        assert eng.runner.cache_device_bytes() == (per * rows, per * rows)


@pytest.mark.parametrize("argv", [
    ["--arch", MAMBA, "--paged"], ["--arch", JAMBA],
    ["--arch", DBRX, "--page-topn", "1"]],
    ids=["mamba2-paged", "jamba-dense", "dbrx-page_topn"])
def test_launcher_serves_ssm_and_moe_archs(argv, capsys):
    """The launcher serves the three archs reduced on the CPU with two step
    graphs; mamba2 (no attention, HAD off) without the binary path, as the
    JAX launcher does."""
    from repro_torch.launch import serve as launch
    got = launch.main(argv + ["--reduced", "--device", "cpu", "--prompt-len",
                              "24", "--gen", "4"])
    text = capsys.readouterr().out
    assert "step graphs: 2" in text
    assert ("full precision" in text) == (MAMBA in argv)
    assert len(got) == 8 and all(v.shape == (4,) for v in got.values())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["binary-paged", "fp-dense"])
@pytest.mark.parametrize("arch", [MAMBA, JAMBA, DBRX])
def test_graph_equals_eager_on_card(cuda, arch, path):
    """Through the captured step graphs and the eager step: the same
    tokens, bit for bit; 2 graphs and 0."""
    model = _model(arch).to(cuda)
    outs = []
    for eager in (False, True):
        eng = Engine(_cfgs(arch)[1], model,
                     _scfg(ServeConfig, 2, **ENGINE_PATHS[path]),
                     device=cuda, eager=eager)
        outs.append(_serve(eng, _requests()))
        assert eng.runner.graph_count() == (0 if eager else 2)
    _equal(*outs)


@pytest.mark.parametrize("path", list(ENGINE_PATHS))
def test_chunk_leaves_other_slots_state_unchanged(path):
    """A fresh chunk on slot 1 (position 0; state entry 2 in the paged
    engine's state pool) of reduced jamba, after the step's warm-up,
    writes slot 1's dense rows, or its page, the trash page its padding
    goes to and its state entry; every other slot's rows, page and state
    entry bit for bit as before."""
    eng = _engine(JAMBA, slots=3, **ENGINE_PATHS[path])
    runner = eng.runner
    paged = eng.scfg.paged
    table = np.array([7, -1, -1, -1, -1, -1], np.int32)
    args = (1, _requests((5,), seed=2)[0], 0, table if paged else None, 2)
    runner.prefill_step(*args)          # the warm-up writes the trash
    _randomize(runner.caches)
    before = _clone(runner.caches)
    runner.prefill_step(*args)
    for i, rows in enumerate(_rows_changed(before, runner.caches)):
        if not paged:
            want = {1}
        elif i in runner._state_layers:
            want = {2}
        else:
            want = {7, runner.n_pages}
        assert rows == want, i


def _chunks(cfg, paged):
    """prefill_step arguments: a full chunk on slot 0, a 5-token chunk on
    slot 1, then slot 0's second chunk (its state carried)."""
    rng = np.random.default_rng(4)
    bt = np.array([[0, 3, -1, -1, -1, -1], [1, -1, -1, -1, -1, -1]],
                  np.int32)
    return [(slot, rng.integers(0, cfg.vocab_size, nv).astype(np.int32),
             pos, bt[slot] if paged else None, slot)
            for slot, nv, pos in ((0, 8, 0), (1, 5, 0), (0, 8, 8))]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["binary-paged", "binary-dense",
                                  "fp-paged"])
def test_one_row_prefill_graph_equals_eager_on_card(cuda, path):
    """The one-row prefill graph of reduced jamba (SSM state carried
    between a slot's chunks, pooled or dense) against the eager step: the
    logits of every chunk bit for bit, tokens [1, chunk] staged."""
    model = _model(JAMBA).to(cuda)
    logits = []
    for eager in (False, True):
        eng = Engine(_cfgs(JAMBA)[1], model,
                     _scfg(ServeConfig, 2, **ENGINE_PATHS[path]),
                     device=cuda, eager=eager)
        logits.append([eng.runner.prefill_step(*args).clone()
                       for args in _chunks(eng.cfg, eng.scfg.paged)])
        assert eng.runner.graph_count() == (0 if eager else 1)
        assert eng.runner._inputs["prefill"].views["tokens"].shape == (1, 8)
        assert eng.stats["prefill_rows"] == eng.stats["prefill_chunks"] == 3
    for a, b in zip(*logits):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_state_swap_on_card(cuda, arch):
    """Under CUDA graphs, swapped (pages and SSM state entries) ==
    unpreempted tokens: the swap-in wrote into the tensors the graphs
    replay over."""
    model = _model(arch).to(cuda)
    base = _engine(arch, model=model, device=cuda)
    eng = _engine(arch, model=model, device=cuda, **SWAP)
    want, got = _serve(base, _requests()), _serve(eng, _requests())
    assert eng.stats["swap_outs"] > 0
    _equal(got, want)
    assert eng.runner.graph_count() == 2 and eng.statepool.n_held == 0
