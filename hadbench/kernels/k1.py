"""K1: binary prefill attention
(``src/repro_torch/kernels/csrc/binary_prefill_attention.cu``), one launch
an attention layer a prefill chunk.

Frozen from ``chip_smoke.py``'s ``_k1_work`` (PR 23), counted from the
chunk's shape: its live queries over the cached prefix and themselves,
causal. Where that formula reads the data (the keys whose V some live
query keeps), the benchmark counts the least the inputs allow:
min(N, kv length) a kv head.
"""
from __future__ import annotations

import math

from hadbench import peaks

NAMES = ("prefill_hist_kernel", "prefill_partial_kernel",
         "prefill_combine_kernel")


def _sum_min(n: int, a: int, b: int) -> int:
    """sum(min(n, x) for x in range(a, b + 1))."""
    if b < a:
        return 0
    lo_hi = min(b, n)
    below = (lo_hi * (lo_hi + 1) - (a - 1) * a) // 2 if lo_hi >= a else 0
    return below + n * (b - max(a - 1, lo_hi))


def chunk_work(lo: int, nv: int, *, h: int, hk: int, w: int, dv: int,
               nsel: int, out_rows: int, call_rows: int, v_rows=None,
               v_bytes: int = 2):
    """(bytes, [(operations, rate)]) of one launch: `nv` live queries at
    positions [lo, lo + nv) of one slot, each over the keys up to itself,
    `h` query heads over `hk` kv heads, `w` words a key, V width `dv`.
    Bytes: the live queries' words, every key up to lo + nv (words), the
    V rows read a kv head (`v_rows`, by default the least: min(nsel,
    lo + nv)), `out_rows` float32 output rows a head, and the call's three
    int32 row arrays (`call_rows` rows of the call). Operations: the
    scores of the valid pairs on the CUDA cores (2w + 2 a pair), E.V of
    the kept pairs and their sum(E) on the bf16 tensor cores (three bf16
    products a multiply-add)."""
    hi = lo + nv
    n_valid = nv * lo + nv * (nv + 1) // 2
    n_kept = _sum_min(nsel, lo + 1, hi)
    v = min(nsel, hi) if v_rows is None else v_rows
    nbytes = (nv * h * w * 4 + hk * hi * w * 4 + hk * v * dv * v_bytes
              + out_rows * h * dv * 4 + 3 * call_rows * h * 4)
    return nbytes, [(n_valid * h * (2 * w + 2), peaks.FP32_FLOPS),
                    (3 * n_kept * h * 2 * (dv + 1), peaks.BF16_FLOPS)]


def step_bound_s(step: dict, shapes: dict) -> float:
    """Least seconds of K1's launches in one step: one launch an
    attention layer for each prefill chunk (`step["chunks"]`: (lo, hi)
    of its live row), live queries only."""
    total = 0.0
    for lo, hi in step.get("chunks") or []:
        nbytes, ops = chunk_work(
            lo, hi - lo, h=shapes["n_heads"], hk=shapes["n_kv_heads"],
            w=math.ceil(shapes["head_dim"] / 32), dv=shapes["head_dim"],
            nsel=shapes["topn"], out_rows=hi - lo,
            call_rows=shapes["batch_slots"])
        total += shapes["attn_layers"] * peaks.bound_s(nbytes, ops)
    return total
