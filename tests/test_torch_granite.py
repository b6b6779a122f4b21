"""granite-4.0-h-small's parts in the port, on the CPU at a reduced size,
float32: the published Mamba2 mixer (conv over x, B and C with a bias,
the gate before the norm) against a plain sequential recurrence written
here, over chunks that carry state and decode steps; the MoE's shared
expert and its top-k-then-softmax gate against a hand computation; the
multipliers at 1 (every configuration but granite's) adding no operation
to a serve step (the ops dispatched, counted before the fields existed); the
scheduler's document checkpoints ("documents"): sixteen documents of
uneven lengths prefilled, then three rounds of turns, every turn restoring
its own document's checkpoint at the document's last full page, none cut
short, the state pool's entry invariant holding at every step. The port
against the benchmark's plain reference is in
``hadbench/tests/test_hadbench_granite.py``."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.models import moe, ssm
from repro_torch.models import transformer as T
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve import scheduler as S

GRANITE = "granite-4.0-h-small"
# float32 on both sides; the chunked SSD and the sequential recurrence
# sum the same terms in another order
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(**kw):
    return get_config(GRANITE, reduced=True, **kw)


def _mixer(cfg, seed=0):
    p = ssm.SSM(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.randn(t.shape, generator=gen) * 0.3)
        p.A_log.copy_(torch.rand(p.A_log.shape, generator=gen) * 2)
        p.dt_bias.copy_(torch.randn(p.dt_bias.shape, generator=gen) - 3)
        p.norm.add_(1.0)
    return p


def _sequential(p, x, cfg):
    """The published mixer one token at a time: x [S, D] -> [S, D]."""
    di, n, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    xs, z, b, c, dt = torch.split(x @ p.w_in, [di, di, n, n, nh], dim=-1)
    xbc = torch.cat([xs, b, c], dim=-1)
    k = p.conv_w.shape[0]
    h = torch.zeros((nh, n, hd))
    a = -torch.exp(p.A_log)
    out = []
    for t in range(x.shape[0]):
        conv = p.conv_b.clone()
        for i in range(k):
            if t - (k - 1) + i >= 0:
                conv = conv + p.conv_w[i] * xbc[t - (k - 1) + i]
        u = F.silu(conv)
        xt, bt, ct = u[:di].view(nh, hd), u[di:di + n], u[di + n:]
        d = F.softplus(dt[t] + p.dt_bias)
        h = torch.exp(d * a)[:, None, None] * h \
            + d[:, None, None] * bt[None, :, None] * xt[:, None, :]
        y = torch.einsum("n,hnp->hp", ct, h) + p.D[:, None] * xt
        g = y.reshape(di) * F.silu(z[t])
        g = g * torch.rsqrt((g * g).mean() + cfg.norm_eps) * p.norm
        out.append(g @ p.w_out)
    return torch.stack(out)


def test_published_mixer_equals_a_sequential_recurrence():
    """Two chunks carrying {h, conv} (lengths the SSD chunk does not
    divide, the second padded past its valid tokens), then decode steps,
    equal the sequential recurrence over the whole sequence; the conv
    state spans x, B and C."""
    cfg = _cfg()
    assert cfg.ssm_mixer == "published" and _mixer(cfg).conv_b is not None
    p = _mixer(cfg)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, 27, cfg.d_model), generator=gen)
    want = _sequential(p, x[0], cfg)
    y1, st = ssm.ssm_forward(p, x[:, :13], cfg=cfg)
    assert st["conv"].shape == (1, ssm.CONV_K - 1, cfg.ssm_conv_width)
    assert cfg.ssm_conv_width == cfg.d_inner + 2 * cfg.ssm_state
    pad = torch.cat([x[:, 13:24], torch.zeros((1, 5, cfg.d_model))], dim=1)
    y2, st = ssm.ssm_forward(p, pad, cfg=cfg, state=st,
                             n_valid=torch.tensor([11]))
    got = [y1[0], y2[0, :11]]
    for i in range(24, 27):
        y, st = ssm.ssm_decode(p, x[:, i:i + 1], cfg=cfg, state=st)
        got.append(y[0])
    torch.testing.assert_close(torch.cat(got), want, **TOL)


def test_default_mixer_keeps_the_norm_before_the_gate():
    """The JAX package's mixer (the defaults): x alone convolved, no
    bias, rmsnorm(y) * silu(z); its state is as before, d_inner wide."""
    cfg = dataclasses.replace(_cfg(), ssm_mixer="jax")
    p = ssm.SSM(cfg)
    assert p.conv_b is None and p.conv_w.shape == (4, cfg.d_inner)
    assert ssm.init_state(cfg, 2)["conv"].shape == (2, 3, cfg.d_inner)
    y = torch.randn((2, 3, cfg.d_inner))
    z = torch.randn((2, 3, cfg.d_inner))
    with torch.no_grad():
        p.w_out.copy_(torch.eye(cfg.d_inner, cfg.d_model))
        p.norm.fill_(1.0)
    rms = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + cfg.norm_eps)
    torch.testing.assert_close(ssm._gate_out(p, y, z, cfg),
                               (rms * F.silu(z)) @ p.w_out, **TOL)


def test_shared_expert_and_gate_match_a_hand_computation():
    """Each token: the softmax over its top-k router logits weights its
    experts' SwiGLU outputs, and the shared SwiGLU expert is added."""
    cfg = _cfg(n_experts=6, experts_per_token=3, shared_expert_width=24)
    p = moe.MoE(cfg)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for t in p.parameters():
            t.copy_(torch.randn(t.shape, generator=gen) * 0.2)
    x = torch.randn((2, 5, cfg.d_model), generator=gen)
    got = moe.moe_ffn(p, x, cfg=cfg)

    def swiglu(v, w1, w2, w3):
        return (F.silu(v @ w1) * (v @ w3)) @ w2

    want = torch.empty_like(x)
    for b in range(2):
        for s in range(5):
            v = x[b, s]
            logits = v @ p.router
            top = torch.argsort(logits, descending=True)[:3]
            gates = torch.softmax(logits[top], dim=0)
            y = swiglu(v, p.ws1, p.ws2, p.ws3)
            for g, e in zip(gates, top):
                y = y + g * swiglu(v, p.w1[e], p.w2[e], p.w3[e])
            want[b, s] = y
    torch.testing.assert_close(got, want, **TOL)
    # no shared expert: the routed sum alone
    plain = dataclasses.replace(cfg, shared_expert_width=0)
    q = moe.MoE(plain)
    assert q.ws1 is None and q.ws2 is None and q.ws3 is None
    with torch.no_grad():
        for name in ("router", "w1", "w2", "w3"):
            getattr(q, name).copy_(getattr(p, name))
    torch.testing.assert_close(moe.moe_ffn(q, x, cfg=plain),
                               got - swiglu(x, p.ws1, p.ws2, p.ws3), **TOL)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


# ops dispatched by one serve step (prefill chunk, decode), read on the
# commit before the new fields: at their defaults they add none, so the
# captured graphs of these models keep every node
STEP_OPS = {"smollm-135m": (2, 655, 586), "dbrx-132b": (1, 417, 380),
            "jamba-1.5-large-398b": (8, 2154, 1445),
            "mamba2-130m": (2, 410, 213)}


@pytest.mark.parametrize("arch", sorted(STEP_OPS))
def test_default_fields_add_no_operation_to_the_step(arch, monkeypatch):
    n_layers, prefill, decode = STEP_OPS[arch]
    cfg = get_config(arch, reduced=True, n_layers=n_layers)
    model = T.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, model, ServeConfig(max_len=64, batch_slots=2,
                                         paged=True, page_size=8,
                                         prefill_chunk=16), device="cpu")
    seen: dict[str, set] = {}
    step = T.serve_step

    def counted(*a, **kw):
        with _Count() as c:
            out = step(*a, **kw)
        seen.setdefault("decode" if a[1].shape[1] == 1 else "prefill",
                        set()).add(c.n)
        return out

    monkeypatch.setattr(T, "serve_step", counted)
    gen = np.random.default_rng(0)
    for n in (20, 9):
        eng.submit(gen.integers(0, cfg.vocab_size, n), 3)
    eng.run()
    assert seen == {"prefill": {prefill}, "decode": {decode}}


def test_full_precision_serving_equals_the_std_forward(monkeypatch):
    """binary=False serving (paged K/V, pooled SSM state, chunked prefill,
    then decode) gives the full forward's mode="std" logits at every
    served token: both paths scale attention logits by
    attention_multiplier, not head_dim^-0.5. A capacity factor of
    n_experts / top-k keeps the training forward's MoE from dropping a
    token, as serving never does."""
    from repro_torch.serve import runner as R
    cfg = _cfg()
    cfg = dataclasses.replace(cfg, capacity_factor=float(
        cfg.n_experts) / cfg.experts_per_token)
    assert cfg.attn_scale == cfg.attention_multiplier != cfg.dh ** -0.5
    model = T.init_params(cfg, torch.Generator().manual_seed(5))
    eng = Engine(cfg, model, ServeConfig(
        max_len=64, batch_slots=2, paged=True, page_size=8,
        prefill_chunk=16, binary=False), device="cpu")
    rows = []
    sample = R._sample_token

    def record(logits, sp, rng):
        rows.append(torch.as_tensor(np.array(logits, np.float32)))
        return sample(logits, sp, rng)

    monkeypatch.setattr(R, "_sample_token", record)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 37)
    rid = eng.submit(prompt, 5)
    toks = eng.run()[rid]
    seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]))[None]
    with torch.no_grad():
        want = T.forward(model, {"tokens": seq}, cfg=cfg,
                         mode="std").logits[0, len(prompt) - 1:]
    got = torch.stack(rows)
    assert got.shape[0] == len(toks) == 5
    torch.testing.assert_close(got, want[:, :got.shape[1]], **TOL)


# ---------------------------------------------------------------------------
# the scheduler's document checkpoints (no model)
# ---------------------------------------------------------------------------

PAGE, CHUNK, SLOTS = 16, 64, 16


def _sched(mode: str) -> S.Scheduler:
    return S.Scheduler(S.ServeConfig(
        max_len=544, batch_slots=SLOTS, paged=True, page_size=PAGE,
        prefill_chunk=CHUNK, prefix_cache=True, state_pages=2 * SLOTS,
        state_checkpoints=mode), state_layers=1)


def _drain(sch, on_plan=None) -> list:
    """Schedule and commit (one token a sampled row) until idle."""
    done = []
    for _ in range(10_000):
        if not sch.queue and all(s.request is None for s in sch.slots):
            return done
        plan = sch.schedule()
        if on_plan is not None:
            on_plan(plan)
        res = {}
        for ch in plan.prefill:
            if ch.samples:
                res.setdefault(ch.slot, []).append(5)
        for e in plan.decode:
            res.setdefault(e.slot, []).append(5)
        done += sch.commit(plan, res)
        sch.check()
    raise AssertionError("the scheduler did not drain")


def _turns(mode: str):
    """16 documents of uneven lengths, none page-aligned, prefilled; then
    three rounds of turns (the document plus 20-60 new tokens, 3-9 out).
    Returns (scheduler, the documents, each round's admissions as (slot
    request, cached tokens, restored entry), each document's
    checkpoint entry after its prefill)."""
    sch = _sched(mode)
    gen = np.random.default_rng(4)
    lens = [97 + 24 * i for i in range(SLOTS)]
    assert all(n % PAGE for n in lens)
    docs = [gen.integers(0, 1000, n).astype(np.int32) for n in lens]
    for d in docs:
        sch.submit(d, 0)
    _drain(sch)
    tails = [sch.statepool.peek(_tail_key(sch, d)) for d in docs]
    rounds = []
    for r in range(3):
        adm = []
        rid_doc = {}
        for i, d in enumerate(docs):
            new = gen.integers(0, 1000, 20 + 13 * ((i + r) % 4))
            rid = sch.submit(np.concatenate([d, new]), 3 + (i + r) % 7)
            rid_doc[rid] = i
        _drain(sch, lambda plan: adm.extend(
            (rid_doc[a.request.request_id], a.cached_tokens,
             a.state_restore) for a in plan.admissions))
        rounds.append(adm)
    return sch, docs, rounds, tails


def _tail_key(sch, doc):
    n_full = len(doc) // PAGE
    return list(sch._chain_keys(doc, n_full))[-1]


def test_every_turn_restores_its_documents_last_full_page():
    sch, docs, rounds, tails = _turns("documents")
    assert all(t is not None for t in tails), tails
    for adm in rounds:
        assert sorted(i for i, _, _ in adm) == list(range(SLOTS))
        for i, cached, src in adm:
            # restored at the last full page: at most 15 document tokens
            # left to prefill before the turn's new ones
            assert cached == len(docs[i]) // PAGE * PAGE
            assert 0 < len(docs[i]) - cached < PAGE
            assert src == tails[i]
    st = sch.stats
    assert st["state_misses"] == 0
    assert st["state_restores"] == 3 * SLOTS
    # a live entry a slot and a checkpoint a document fill the pool
    # (2 x batch_slots entries): the turns take no checkpoint, so nothing
    # was evicted
    assert st["state_ckpts"] == SLOTS
    assert st["state_evictions"] == 0
    assert [sch.statepool.peek(_tail_key(sch, d)) for d in docs] == tails
    sch.statepool.check()
    assert sch.statepool.n_held == 0


def test_chunk_checkpoints_lose_documents_to_turns():
    """The same traffic with checkpoints at chunk ends (the JAX
    package's): documents whose checkpoint is gone or short of their last
    page prefill again, which "documents" exists to avoid."""
    sch, docs, rounds, _ = _turns("chunks")
    short = sum(len(docs[i]) - cached >= PAGE
                for adm in rounds for i, cached, _ in adm)
    assert short > 0
    assert sch.stats["state_misses"] > 0
    sch.statepool.check()


def test_prompt_checkpoints_cut_the_chunk_at_the_last_full_page():
    sch = _sched("documents")
    sch.submit(np.arange(150, dtype=np.int32), 0)
    plans = []
    _drain(sch, plans.append)
    spans = [(ch.lo, ch.hi, ch.state_ckpt >= 0) for p in plans
             for ch in p.prefill]
    # 150 tokens: chunks of 64 up to 128, cut at 144 (9 full pages)
    assert spans == [(0, 64, False), (64, 128, False), (128, 144, True),
                     (144, 150, False)]


@pytest.mark.parametrize("n", [150, 128])
def test_a_prompt_that_asks_for_tokens_takes_no_checkpoint(n):
    """A turn (max_new_tokens > 0) runs its chunks uncut and captures no
    state, page-aligned or not: only documents' checkpoints are taken."""
    sch = _sched("documents")
    sch.submit(np.arange(n, dtype=np.int32), 3)
    plans = []
    _drain(sch, plans.append)
    spans = [(ch.lo, ch.hi, ch.state_ckpt >= 0) for p in plans
             for ch in p.prefill]
    assert spans == [(0, 64, False), (64, 128, False)] + (
        [(128, 150, False)] if n == 150 else [])
    assert sch.stats["state_ckpts"] == 0
    assert sch.statepool.n_ckpt == 0


def test_unknown_state_checkpoints_is_refused():
    with pytest.raises(ValueError, match="state_checkpoints"):
        _sched("pages")
