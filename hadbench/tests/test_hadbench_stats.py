"""The window's arithmetic on synthetic stamps with a stall: the rate over
all the work and all the time, percentiles over every sample."""
import numpy as np
import pytest

from hadbench.stats import Record, percentile, window


def _rec(rid, sent, stamps, origin=None):
    return Record(rid=rid, client=rid, prompt=np.zeros(4, np.int32),
                  sent=sent,
                  origin=sent if origin is None else origin,
                  stamps=list(stamps), tokens=[1] * len(stamps),
                  finished=True)


def test_percentile_matches_linear_interpolation():
    xs = [5.0, 1.0, 9.0, 3.0, 7.0, 100.0]
    for q in (0, 50, 95, 100):
        assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_window_with_a_stall():
    # request 0: tokens every 10 ms from 0.05 s, with one 500 ms stall
    stamps = [0.05 + 0.01 * i for i in range(20)]
    stamps = stamps[:10] + [s + 0.5 for s in stamps[10:]]
    a = _rec(0, 0.0, stamps)
    # request 1 is due at 0.9 s but sent at 1.0 s (the loop ran late):
    # its latency counts from 0.9; one token falls after the window
    b = _rec(1, 1.0, [1.2, 1.21, 2.5], origin=0.9)
    # sent before the window: its tokens count, its TTFT does not
    c = _rec(2, -1.0, [0.1, 0.2])
    out = window([a, b, c], 0.0, 2.0)
    assert out["tokens"] == 20 + 2 + 2
    assert out["gen_tok_s"] == pytest.approx(24 / 2.0)
    assert out["attempted"] == 2 and out["failed"] == 0
    assert sorted(out["ttft_ms"]) == pytest.approx([50.0, 300.0])
    gaps = ([10.0] * 9 + [510.0] + [10.0] * 9 + [10.0] + [100.0])
    assert sorted(out["itl_ms"]) == pytest.approx(sorted(gaps))
    assert out["itl_p95_ms"] == pytest.approx(np.percentile(gaps, 95))
    assert out["itl_p50_ms"] == pytest.approx(10.0)


def test_a_request_that_never_answers_fails():
    out = window([_rec(0, 0.5, [])], 0.0, 1.0)
    assert out["attempted"] == 1 and out["failed"] == 1
    assert out["gen_tok_s"] == 0 and "ttft_p95_ms" not in out
