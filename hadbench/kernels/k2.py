"""K2: binary paged decode attention
(``src/repro_torch/kernels/csrc/binary_paged_decode_attention.cu`` over
``had_decode.cuh``), one launch an attention layer a decode step.

Frozen from ``chip_smoke.py``'s ``_decode_rows_work`` (PR 23). Where that
formula reads the data (the union of kept keys over a group's query
heads), the benchmark counts the least the inputs allow: min(N, L) keys a
row of L valid keys.
"""
from __future__ import annotations

import math

from hadbench import peaks

NAMES = ("split_scores_kernel", "split_tile_sums_kernel",
         "split_combine_kernel")


def rows_work(lengths, *, g: int, w: int, dv: int, nsel: int,
              index_bytes: int, v_rows=None, v_bytes: int = 2):
    """(bytes, [(operations, rate)]) of one launch over rows (slot x kv
    head) of `lengths` valid keys each, `g` query heads a row, `w` 32-bit
    words a key, V width `dv`. Bytes: the queries, every valid key's
    words, the V rows read (`v_rows`, by default the least: min(nsel, L)
    a row), the tables, the float32 output. Operations on the CUDA cores:
    the scores of every valid key for each query head, and E.V of the
    kept keys (at least min(nsel, L) a query head)."""
    r = len(lengths)
    n_keys = sum(lengths)
    least = [min(nsel, n) for n in lengths]
    v = sum(least) if v_rows is None else v_rows
    nbytes = (r * g * w * 4 + n_keys * w * 4 + v * dv * v_bytes
              + index_bytes + r * g * dv * 4)
    nops = g * sum(least) * (2 * dv + 1) + n_keys * g * (2 * w + 2)
    return nbytes, [(nops, peaks.FP32_FLOPS)]


def step_bound_s(step: dict, shapes: dict) -> float:
    """Least seconds of K2's launches in one step: `step["decode_lens"]`
    the valid keys of each live decode row after its write (pos + 1),
    one launch an attention layer over every live slot's kv heads."""
    lens = step.get("decode_lens") or []
    if not lens:
        return 0.0
    hk, page = shapes["n_kv_heads"], shapes["page_size"]
    rows = [n for n in lens for _ in range(hk)]
    index_bytes = sum(math.ceil(n / page) * 4 + 4 for n in rows)
    nbytes, ops = rows_work(rows, g=shapes["n_heads"] // hk,
                            w=math.ceil(shapes["head_dim"] / 32),
                            dv=shapes["head_dim"], nsel=shapes["topn"],
                            index_bytes=index_bytes)
    return shapes["attn_layers"] * peaks.bound_s(nbytes, ops)
