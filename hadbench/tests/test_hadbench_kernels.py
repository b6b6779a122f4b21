"""The frozen kernel work formulas at chip_smoke's phase-2 shapes (4 slots,
9 / 3 heads of 64, N 479, 4096-token tables, 16-token pages) give the
bounds of PERF.md's kernel table, with the kept keys read from random
keys as chip_smoke reads them; and never more than that with the least
the inputs allow."""
import torch

from hadbench import peaks
from hadbench.kernels import k1, k2

B, H, HK, D, N, PAGE, NB = 4, 9, 3, 64, 479, 16, 256
G = H // HK


def _signs(shape, gen):
    return torch.where(torch.randn(shape, generator=gen) >= 0, 1.0, -1.0)


def _kept_any(q, k, valid):
    """Keys some query keeps (top-N with ties): q [Q, d], k [T, d]."""
    s = q @ k.T
    s = torch.where(valid, s, -1e9)
    n_eff = valid.sum(-1).clamp(max=N)
    t = torch.sort(s, descending=True).values.gather(
        1, (n_eff - 1)[:, None])
    return ((s >= t) & valid).any(0)


def test_k2_bound_at_phase_2():
    gen = torch.Generator().manual_seed(0)
    lens = [3104, 1537, 600, 33]
    v_rows = 0
    for n in lens:
        for _ in range(HK):
            valid = torch.ones((G, n), dtype=torch.bool)
            v_rows += int(_kept_any(_signs((G, D), gen), _signs((n, D), gen),
                                    valid).sum())
    rows = [n for n in lens for _ in range(HK)]
    work = dict(g=G, w=2, dv=D, nsel=N, index_bytes=2 * B * HK * NB * 4)
    ms = peaks.bound_s(*k2.rows_work(rows, v_rows=v_rows, **work)) * 1e3
    assert round(ms, 5) == 0.00042
    least = peaks.bound_s(*k2.rows_work(rows, **work)) * 1e3
    assert least < ms


def test_k1_bound_at_phase_2():
    gen = torch.Generator().manual_seed(1)
    lo, nv = 2560, 512
    pos = torch.arange(lo, lo + nv)
    valid = torch.arange(lo + nv)[None, :] <= pos[:, None]
    v_rows = 0
    for _ in range(HK):
        k = _signs((lo + nv, D), gen)
        q = _signs((G * nv, D), gen)
        v_rows += int(_kept_any(q, k, valid.repeat(G, 1)).sum())
    work = dict(h=H, hk=HK, w=2, dv=D, nsel=N, out_rows=B * nv,
                call_rows=B)
    ms = peaks.bound_s(*k1.chunk_work(lo, nv, v_rows=v_rows // HK,
                                      **work)) * 1e3
    assert round(ms, 5) == 0.00179
    live = dict(work, out_rows=nv)
    assert peaks.bound_s(*k1.chunk_work(lo, nv, **live)) * 1e3 < ms


def test_sum_of_kept_pairs():
    assert k1._sum_min(5, 1, 10) == sum(min(5, x) for x in range(1, 11))
    assert k1._sum_min(5, 7, 9) == 15
    assert k1._sum_min(50, 3, 9) == sum(range(3, 10))
