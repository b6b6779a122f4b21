"""The runner's step as captured CUDA graphs: one for a prefill chunk,
which carries its slot's row only, and one for the decode step (the
port's form of the JAX runner's one-prefill + one-decode trace pin), fed
from static input buffers.

On the CPU, which has no graphs, the same static-buffer path runs and
counts its step kinds: 2 after prompts of several lengths on every path
and through the lockstep prefill, the same tokens as the eager step, a
one-row prefill input, a chunk that leaves every other slot's pages and
rows unchanged, and a warm-up that leaves pages [0, n_pages) and
positions [0, max_len) untouched. On the card (the `cuda` marker): graph
== eager bit for bit, two captures across prompt lengths, and kernel
launches counted through replays.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.runner import _StepInputs

from test_torch_serve import _cfgs, _model, _prompts, _scfg, _serve

PATHS = {"binary-paged": {}, "binary-dense": dict(paged=False),
         "binary-page_topn": dict(page_topn=2),
         "fp-paged": dict(binary=False),
         "fp-dense": dict(binary=False, paged=False),
         "fp-page_topn": dict(binary=False, page_topn=2)}
# prompts of 1 to 4 chunks of 8 tokens, and one past a page boundary
LENGTHS = (3, 13, 30, 8, 21)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


def _engine(kw, device="cpu", eager=False, model=None, slots=2):
    _, tcfg = _cfgs()
    model = _model() if model is None else model
    return Engine(tcfg, model, _scfg(ServeConfig, slots, **kw),
                  device=device, eager=eager)


def _randomize(caches, seed=0) -> None:
    """Fill every cache leaf with seeded noise, in place."""
    gen = torch.Generator().manual_seed(seed)
    for cache in caches:
        for buf in cache.values():
            if buf.dtype == torch.int32:
                buf.copy_(torch.randint(-2 ** 31, 2 ** 31 - 1, buf.shape,
                                        generator=gen, dtype=torch.int32))
            else:
                buf.copy_(torch.randn(buf.shape, generator=gen))


def _clone(caches) -> list[dict]:
    return [{k: v.clone() for k, v in c.items()} for c in caches]


def _rows_changed(before, caches) -> list[set[int]]:
    """Per layer, the rows (axis 0: pages, slots or state entries) in
    which any leaf differs from `before`."""
    return [{i for name, buf in new.items() for i in range(buf.shape[0])
             if not torch.equal(buf[i], old[name][i])}
            for old, new in zip(before, caches)]


# ---------------------------------------------------------------------------
# on the CPU: the static-buffer plumbing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", list(PATHS))
def test_step_kinds_are_two_across_prompt_lengths(path):
    """Mirrors the JAX pins `eng._step._cache_size() == 2`: after prompts
    of several lengths the runner has set up exactly two step kinds (on
    the card, captured two graphs); the eager runner none."""
    eng = _engine(PATHS[path])
    _serve(eng, _prompts((30,), seed=0), 1)        # prefill chunks only
    assert eng.runner.graph_count() == 1
    _serve(eng, _prompts(LENGTHS, seed=1), 4)
    assert eng.runner.graph_count() == 2
    _serve(eng, _prompts((40, 2), seed=2), 3)
    assert eng.runner.graph_count() == 2
    eager = _engine(PATHS[path], eager=True)
    _serve(eager, _prompts(LENGTHS, seed=1), 4)
    assert eager.runner.graph_count() == 0


@pytest.mark.parametrize("path", list(PATHS))
def test_static_buffer_step_equals_eager_step(path):
    """Greedy tokens through the static-buffer step (with its warm-ups on
    the null plan) equal the eager step's, bit for bit."""
    prompts = _prompts(LENGTHS, seed=3)
    want = _serve(_engine(PATHS[path], eager=True), prompts, 5)
    got = _serve(_engine(PATHS[path]), prompts, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fp"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_warmup_leaves_real_pages_and_positions_unchanged(paged, binary):
    """The warm-up (and, on the card, the capture) runs the step for real
    on the null plan: every row inactive, n_valid 0, every table entry -1.
    Its writes land in the trash page or position only."""
    eng = _engine(dict(paged=paged, binary=binary))
    runner = eng.runner
    _randomize(runner.caches)
    before = _clone(runner.caches)
    for kind in ("prefill", "decode"):
        runner._capture(kind)
    for old, new in zip(before, runner.caches):
        for name, buf in new.items():
            axis = 0 if paged else (3 if name == "k_bits" else 2)
            real = buf.shape[axis] - 1
            assert torch.equal(buf.narrow(axis, 0, real),
                               old[name].narrow(axis, 0, real)), name
            # the writes did happen, into the trash
            assert not torch.equal(buf.narrow(axis, real, 1),
                                   old[name].narrow(axis, real, 1)), name


@pytest.mark.parametrize("path", list(PATHS))
def test_prefill_inputs_are_one_slot_row(path):
    """A prefill chunk stages its slot's row only: tokens [1, chunk], pos,
    active and n_valid [1], and the slot's block table row (paged) or
    its `slot` (dense); the decode step stages every slot. After a served
    mix every chunk carried one row: prefill_rows == prefill_chunks."""
    eng = _engine(PATHS[path], slots=3)
    _serve(eng, _prompts(LENGTHS, seed=7), 3)
    v = eng.runner._inputs["prefill"].views
    assert v["tokens"].shape == (1, eng.scfg.prefill_chunk)
    assert [v[k].shape for k in ("pos", "active", "n_valid")] == [(1,)] * 3
    if eng.scfg.paged:
        assert v["tables"].shape == (1, 48 // 8) and "slot" not in v
    else:
        assert v["slot"].shape == (1,) and "tables" not in v
    assert eng.runner._inputs["decode"].views["tokens"].shape == (3, 1)
    st = eng.stats
    assert st["prefill_rows"] == st["prefill_chunks"] > len(LENGTHS)


@pytest.mark.parametrize("path", list(PATHS))
def test_lockstep_prefill_replays_one_row_a_slot(path):
    """Engine.prefill replays the one-row chunk once a slot a chunk: still
    two step kinds after it and decode(), slots x chunks rows, and the
    greedy tokens of the served path."""
    prompts = _prompts((19, 19, 19), seed=8)            # 3 chunks of 8
    eng = _engine(PATHS[path], slots=3)
    logits = eng.prefill(np.stack(prompts))
    assert logits.shape == (3, eng.cfg.vocab_size)
    assert eng.stats["prefill_rows"] == eng.stats["prefill_chunks"] == 9
    toks = [logits.argmax(-1)]
    for _ in range(2):
        toks.append(eng.decode(toks[-1].numpy().astype(np.int32))
                    .argmax(-1))
    assert eng.runner.graph_count() == 2
    want = _serve(_engine(PATHS[path], slots=3), prompts, 3)
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(),
                                  np.stack(want))


@pytest.mark.parametrize("path", list(PATHS))
def test_chunk_leaves_other_slots_unchanged(path):
    """A chunk on slot 1 (5 tokens at position 8: its second page), after
    the step's warm-up, writes that page, or that dense row, and the
    trash page its padding goes to; every other page, and every other
    slot's dense row, bit for bit as before."""
    eng = _engine(PATHS[path], slots=3)
    runner = eng.runner
    table = np.array([4, 9, -1, -1, -1, -1], np.int32)
    paged = eng.scfg.paged
    args = (1, _prompts((5,), seed=9)[0], 8, table if paged else None)
    runner.prefill_step(*args)          # the warm-up writes the trash
    _randomize(runner.caches)
    before = _clone(runner.caches)
    runner.prefill_step(*args)
    trash = runner.n_pages
    for changed in _rows_changed(before, runner.caches):
        assert changed == ({9, trash} if paged else {1})


def test_step_inputs_share_one_buffer():
    """Every plan array of a step is a view of one device buffer, staged by
    one copy; the null plan is all zeros with -1 tables."""
    inp = _StepInputs(dict(tokens=(2, 3), pos=(2,), active=(2,),
                           tables=(2, 4)), torch.device("cpu"))
    assert inp.dev.numel() == 6 + 2 + 2 + 8
    inp.stage(tokens=np.arange(6).reshape(2, 3), pos=np.array([5, 7]),
              active=np.array([True, False]),
              tables=np.array([[1, 2, -1, -1], [3, -1, -1, -1]]))
    v = inp.views
    assert all(x.untyped_storage().data_ptr()
               == inp.dev.untyped_storage().data_ptr() for x in v.values())
    assert v["tokens"].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert v["pos"].tolist() == [5, 7] and v["active"].tolist() == [1, 0]
    assert v["tables"][1].tolist() == [3, -1, -1, -1]
    inp.stage_null()
    assert not inp.dev[:10].any() and (v["tables"] == -1).all()


def test_failed_step_setup_raises_and_nothing_falls_back(monkeypatch):
    """A step kind whose warm-up (on the card: capture) fails raises out of
    Engine.step; no eager step runs in its place."""
    eng = _engine({})
    calls = []

    def broken(*args, **kw):
        calls.append(1)
        raise RuntimeError("step failed")

    monkeypatch.setattr(T, "serve_step", broken)
    eng.submit(_prompts((5,), seed=4)[0], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="step failed"):
        eng.step()
    assert calls == [1] and eng.runner.graph_count() == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _drive(runner, steps):
    """Run `steps` (kind, numpy arrays) through a runner's low-level steps;
    each step's logits copied out before the next replay."""
    out = []
    for kind, args in steps:
        fn = runner.prefill_step if kind == "prefill" else runner.decode_step
        out.append(fn(*args).clone())
    return out


def _steps(cfg, paged):
    """Two prefill chunks (one per slot), then three decode steps of both
    slots."""
    rng = np.random.default_rng(9)
    bt = np.array([[0, 3, 5, -1, -1, -1], [1, 2, -1, -1, -1, -1]],
                  np.int32) if paged else None
    steps = []
    for slot, nv in ((0, 8), (1, 5)):
        tok = rng.integers(0, cfg.vocab_size, nv).astype(np.int32)
        steps.append(("prefill", (slot, tok, 0,
                                  None if bt is None else bt[slot])))
    for i in range(3):
        steps.append(("decode", (rng.integers(0, cfg.vocab_size, 2).astype(
            np.int32), np.array([8 + i, 5 + i], np.int32), np.ones(2, bool),
            bt)))
    return steps


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_graph_equals_eager_on_card(cuda, path):
    """Logits of a prefill + decode sequence, and Engine tokens, through the
    captured graphs equal the eager step's bit for bit."""
    _, tcfg = _cfgs()
    model = _model().to(cuda)
    kw = PATHS[path]
    logits = {}
    for eager in (True, False):
        eng = _engine(kw, cuda, eager=eager, model=model)
        logits[eager] = _drive(eng.runner, _steps(tcfg, eng.scfg.paged))
        assert eng.runner.graph_count() == (0 if eager else 2)
    for a, b in zip(logits[True], logits[False]):
        assert torch.equal(a, b)
    prompts = _prompts(LENGTHS, seed=5)
    want = _serve(_engine(kw, cuda, eager=True, model=model), prompts, 5)
    got = _serve(_engine(kw, cuda, model=model), prompts, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_two_captures_across_prompt_lengths_on_card(cuda, path):
    eng = _engine(PATHS[path], cuda, model=_model().to(cuda))
    for lengths in (LENGTHS, (1, 40), (17,)):
        _serve(eng, _prompts(lengths, seed=len(lengths)), 3)
        assert eng.runner.graph_count() == 2


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["binary-paged", "binary-dense",
                                  "binary-page_topn", "fp-paged"])
def test_launch_counts_through_replays_on_card(cuda, path):
    """Launch counts of a graphed run equal the eager run's: one per layer
    a prefill chunk (K1) and a decode step (K2, K4, K3 + K2); none on the
    full-precision path. Warm-up and capture add nothing."""
    from repro_torch.kernels import (binary_decode_attention as dec,
                                     binary_page_score as pscore,
                                     binary_paged_decode_attention as pdec,
                                     binary_prefill_attention as pre)
    _, tcfg = _cfgs()
    model = _model().to(cuda)
    decoders = {"binary-paged": (pdec,), "binary-dense": (dec,),
                "binary-page_topn": (pdec, pscore), "fp-paged": ()}[path]
    counts = {}
    for eager in (True, False):
        eng = _engine(PATHS[path], cuda, eager=eager, model=model)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        _serve(eng, _prompts(LENGTHS, seed=6), 5)
        torch.cuda.synchronize()
        counts[eager] = ops.launch_counts()
        st = eng.stats
        want = {k: 0 for k in counts[eager]}
        if eng.scfg.binary:
            want[pre.NAME] = tcfg.n_layers * st["prefill_chunks"]
        for mod in decoders:
            want[mod.NAME] = tcfg.n_layers * st["decode_steps"]
        assert counts[eager] == want, (eager, counts[eager], want)
    assert counts[True] == counts[False]
