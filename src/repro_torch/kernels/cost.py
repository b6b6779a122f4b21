"""Work of the hand-written kernels, and the hook through which each
``kernels/ops.py`` entry reports it to a step-cost counter
(``launch.op_cost.Counter``).

    with cost.kernel(name, lambda: k4_work(...)):
        out = <the kernel, or its plain version>

Inside the block every active counter adds the formula's (flops, bytes)
once and counts none of the aten ops that run there: the plain version's
on the CPU, the wrapper's copies on the card. So a counted step gives the
same flops and bytes on either device. Outside a counter the block costs
nothing and the formula is never evaluated.
"""
from __future__ import annotations

import contextlib

import numpy as np

# the counters now counting, outermost first; each has mute(), unmute()
# and add_kernel(name, flops, bytes)
counters: list = []


@contextlib.contextmanager
def kernel(name: str, work):
    """A hand-written kernel's call: `work()` gives its (flops, bytes),
    which every active counter adds; the aten ops inside the block are
    not counted."""
    active = list(counters)
    for c in active:
        c.mute()
    try:
        if active:
            f, b = work()
            for c in active:
                c.add_kernel(name, f, b)
        yield
    finally:
        for c in active:
            c.unmute()


# ---------------------------------------------------------------------------
# Formulas, from shapes, lengths and n_sel alone (never from scores), as
# (flops, bytes). They follow chip_smoke.py phase 2's conventions with
# every valid key counted where those count the kept keys: a score costs
# 2*W + 2 operations (XOR and popcount a word, the sum, the compare), E.V
# one multiply-add per V column and one for the denominator, 2 * (Dv + 1)
# a pair; bytes read every input once (the queries' words, every key any
# live query may use, its V row) and write every output once. Lengths
# arrive as host integers or arrays.
# ---------------------------------------------------------------------------

def _clipped_sum(a, n, m):
    """sum_{i < n} min(m, a + i), elementwise over arrays (a >= 0)."""
    a, n, m = (np.asarray(x, np.int64) for x in (a, n, m))
    c = np.clip(m - a, 0, n)                 # terms below the cap
    return (c * a + c * (c - 1) // 2 + (n - c) * m).sum()


def k1_work(*, rows: int, s: int, w: int, dv: int, v_bytes: int,
            group_size: int, kv_length, q_offset, q_length,
            causal: bool) -> tuple[float, float]:
    """Top-N prefill attention (K1) of `rows` query rows of a chunk of `s`
    queries over per-row kv_length / q_offset / q_length [rows]: valid
    pairs are key < kv_length (and key <= q_offset + i if causal) for
    live queries i < q_length."""
    kvl = np.asarray(kv_length, np.int64)
    qoff = np.asarray(q_offset, np.int64)
    qlen = np.clip(np.asarray(q_length, np.int64), 0, s)
    if causal:
        pairs = _clipped_sum(qoff + 1, qlen, kvl)
        kend = np.minimum(kvl, qoff + qlen)
    else:
        pairs = int((qlen * kvl).sum())
        kend = kvl
    kend = np.where(qlen > 0, np.maximum(kend, 0), 0)
    keys = int(kend.reshape(-1, group_size).max(axis=1).sum())
    flops = pairs * (2 * w + 2) + pairs * 2 * (dv + 1)
    nbytes = (int(qlen.sum()) * w * 4 + keys * (w * 4 + dv * v_bytes)
              + rows * s * dv * 4 + 3 * rows * 4)
    return float(flops), float(nbytes)


def decode_work(*, rows: int, g: int, w: int, dv: int, v_bytes: int,
                lengths, index_bytes: int) -> tuple[float, float]:
    """Top-N decode attention of `rows` (slot, kv-head) rows of `g`
    grouped queries over lengths [rows] valid keys (K2 over a block
    table, whose tables and counts are `index_bytes`; K4 over a dense
    cache, whose lengths are)."""
    n_keys = int(np.asarray(lengths, np.int64).clip(min=0).sum())
    flops = n_keys * g * (2 * w + 2) + n_keys * g * 2 * (dv + 1)
    nbytes = (rows * g * w * 4 + n_keys * (w * 4 + dv * v_bytes)
              + index_bytes + rows * g * dv * 4)
    return float(flops), float(nbytes)


def k2_work(*, rows: int, g: int, w: int, dv: int, v_bytes: int, nb: int,
            counts) -> tuple[float, float]:
    """K2: paged decode over row tables and per-block counts [rows, nb]."""
    lengths = np.asarray(counts, np.int64).clip(min=0).sum(axis=-1)
    return decode_work(rows=rows, g=g, w=w, dv=dv, v_bytes=v_bytes,
                       lengths=lengths, index_bytes=2 * rows * nb * 4)


def k3_work(*, rows: int, g: int, w: int, nb: int, n_sel: int,
            counts) -> tuple[float, float]:
    """K3: the page bound of every listed page (its valid keys' words,
    scored against each grouped query) and the selection of `n_sel`
    pages a row: compacted tables, counts and logical ids out."""
    n_keys = int(np.asarray(counts, np.int64).clip(min=0).sum())
    flops = n_keys * g * (2 * w + 2)
    nbytes = (rows * g * w * 4 + n_keys * w * 4 + 2 * rows * nb * 4
              + rows * 4 + 3 * rows * n_sel * 4)
    return float(flops), float(nbytes)


def k4_work(*, rows: int, g: int, w: int, dv: int, v_bytes: int,
            lengths) -> tuple[float, float]:
    """K4: decode over the dense cache's rows, lengths [rows]."""
    return decode_work(rows=rows, g=g, w=w, dv=dv, v_bytes=v_bytes,
                       lengths=lengths, index_bytes=rows * 4)


def k5_work(*, batch: int, m: int, n: int, w: int) -> tuple[float, float]:
    """K5: the [m, n] integer score matrix of `batch` pairs of packed
    query and key blocks."""
    out = batch * m * n
    return (float(out * (2 * w + 2)),
            float(batch * (m + n) * w * 4 + out * 4))
