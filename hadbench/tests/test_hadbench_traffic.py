"""The traffic generators: the same seed gives the same requests; another
seed the same sizes and gaps in another order."""
import numpy as np
import pytest

from hadbench import manifest
from hadbench.loops import closed, open as open_loop, quantiles

VOCAB = 49152


def _closed_run(traffic, seed, rounds=3):
    loop = closed.make(traffic, seed=seed, vocab=VOCAB, seconds=30)
    loop.start(0.0)
    reqs = loop.due(100.0)
    for r in range(2, rounds + 1):
        for q in list(reqs[-loop.clients:]):
            loop.finished(q, 100.0 * r)
        reqs += loop.due(100.0 * r)
    return loop, reqs


def _fresh(loop, q):
    """Prompt tokens after the session's document."""
    docs = loop.setup_prompts()
    return q.tokens.size - (docs[q.client].size if docs else 0)


@pytest.mark.parametrize("mix", ["doc_turns", "reasoning"])
def test_closed_loop_is_seeded(mix):
    t = manifest.read_json("traffic", mix)
    la, a = _closed_run(t, 2 ** 31 + 17)
    _, b = _closed_run(t, 2 ** 31 + 17)
    lc, c = _closed_run(t, 12345)
    assert [(q.client, q.max_new, q.tokens.tolist()) for q in a] == \
        [(q.client, q.max_new, q.tokens.tolist()) for q in b]
    assert [q.tokens.size for q in a] != [q.tokens.size for q in c]
    n = t["clients"]
    for r in range(3):      # each round: one set of sizes, reordered
        ra, rc = a[r * n:(r + 1) * n], c[r * n:(r + 1) * n]
        assert sorted(q.max_new for q in ra) == sorted(q.max_new
                                                       for q in rc)
        assert sorted(_fresh(la, q) for q in ra) == \
            sorted(_fresh(lc, q) for q in rc)
    assert all(0 <= q.tokens.min() and q.tokens.max() < VOCAB for q in a)


def test_documents_start_every_turn_of_their_session():
    t = manifest.read_json("traffic", "doc_turns")
    loop, reqs = _closed_run(t, 7)
    docs = loop.setup_prompts()
    assert len(docs) == t["clients"]
    lo, hi = t["prefix"]["tokens"]
    assert all(lo <= d.size <= hi for d in docs)
    for q in reqs:
        d = docs[q.client]
        assert np.array_equal(q.tokens[:d.size], d)
        assert 64 <= q.tokens.size - d.size <= 256
        assert q.tokens.size + q.max_new <= t["engine"]["max_len"]


def test_open_loop_is_seeded_and_keeps_its_rate():
    t = manifest.read_json("traffic", "short_chat")
    runs = []
    for seed in (99, 99, 2 ** 31 + 100):
        loop = open_loop.make(t, seed=seed, vocab=VOCAB, seconds=30)
        loop.start(0.0)
        runs.append(loop.due(1e9))
    a, b, c = runs
    assert [(q.due, q.tokens.tolist()) for q in a] == \
        [(q.due, q.tokens.tolist()) for q in b]
    rate = t["rate_per_s"]
    n = round(rate * 30)
    assert len(a) == len(c) == n and a[0].due == 0.0
    assert [q.due for q in a] != [q.due for q in c]
    # every seed: the same set of gaps over the same span, and the same
    # sizes, in another order
    gaps = [np.diff([q.due for q in x] + [n / rate]) for x in (a, c)]
    assert sorted(gaps[0]) == pytest.approx(sorted(gaps[1]))
    assert min(gaps[0]) > 0
    assert sorted(q.max_new for q in a) == sorted(q.max_new for q in c)
    assert sorted(q.tokens.size for q in a) == \
        sorted(q.tokens.size for q in c)
    # arrivals bunch and thin as Poisson arrivals do: the count a second
    # varies about as much as its mean
    for x in (a, c):
        per_s = np.bincount([int(q.due) for q in x], minlength=30)
        assert per_s.max() >= rate + 4 and per_s.min() <= rate - 3
        assert 0.5 < per_s.var() / per_s.mean() < 1.6


def test_first_round_spreads_over_its_span():
    t = manifest.read_json("traffic", "doc_turns")
    loop = closed.make(t, seed=3, vocab=VOCAB, seconds=30)
    loop.start(10.0)
    lo, hi = t["first_due_s"]
    assert loop.due(10.0 + lo) == []
    dues = sorted(q.due for q in loop.due(10.0 + hi))
    n = t["clients"]
    assert len(dues) == n
    assert np.diff(dues) == pytest.approx(np.full(n - 1, (hi - lo) / n))


def test_quantiles_are_stratified():
    u = quantiles({"tokens": [64, 256]}, 4)
    assert u.tolist() == [88, 136, 184, 232]
    lg = quantiles({"tokens": [16, 256], "dist": "loguniform"}, 2)
    assert lg.tolist() == [32, 128]
