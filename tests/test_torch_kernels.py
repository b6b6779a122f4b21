"""The two ported kernels: plain versions against the JAX Pallas kernels,
and the CUDA kernels against the plain versions.

On the CPU the port's ops layer runs the kernels' plain versions; they are
held against the JAX package's Pallas kernels run in interpret mode on the
same numpy-seeded inputs (float32 atol 1e-6, rtol 1e-5: the two sum the
same terms in different orders, and the Pallas kernels skip the softmax's
max subtraction). The CUDA cases need a card and skip without one; on the
card they hold the kernels to the plain versions at atol 1e-5, rtol 1e-4.
The machine with the card has no JAX: there the JAX cases skip and the
CUDA cases run (`python -m pytest tests/test_torch_kernels.py`).
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jnp = jops = jref = None
from repro_torch.core import hamming as th
from repro_torch.kernels import binary_paged_decode_attention as pdec
from repro_torch.kernels import binary_prefill_attention as pre
from repro_torch.kernels import ops, ref

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def jax_ref():
    if jops is None:
        pytest.skip("needs the JAX reference package")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return th.pack_bits(torch.from_numpy(x)).numpy().view(np.uint32)


def _t(words):
    return torch.from_numpy(np.array(words).view(np.int32))


# ---------------------------------------------------------------------------
# K1: prefill
# ---------------------------------------------------------------------------

def _prefill_inputs(b, h, hk, s, t, d, dv, seed):
    qb, kb = _bits((b, h, s, d), seed), _bits((b, hk, t, d), seed + 1)
    v = np.random.default_rng(seed + 2).normal(
        size=(b, hk, t, dv)).astype(np.float32)
    return qb, kb, v


PREFILL_CASES = {
    # name: (b, h, hk, s, t, d, dv, nsel, kv_length, q_offset, q_length)
    "full_causal": (1, 2, 2, 32, 32, 64, 16, 8, 32, 0, None),
    "ragged_gqa": (3, 4, 2, 16, 48, 48, 16, 6, [20, 48, 33], [4, 32, 17],
                   [16, 16, 16]),
    "padded_chunk_and_idle_rows": (3, 2, 1, 16, 48, 16, 16, 5, [9, 30, 0],
                                   [0, 18, 0], [9, 12, 0]),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill_plain_matches_jax_kernel(jax_ref, case):
    b, h, hk, s, t, d, dv, nsel, kvl, qoff, qlen = PREFILL_CASES[case]
    qb, kb, v = _prefill_inputs(b, h, hk, s, t, d, dv, seed=len(case))
    scale = float(np.float32(1.0 / np.sqrt(d)))

    def vec(x):
        return None if x is None else np.asarray(x, np.int32)

    want = np.asarray(jops.prefill_attention(
        jnp.asarray(qb), jnp.asarray(kb), jnp.asarray(v), d=d, nsel=nsel,
        scale=scale, kv_length=vec(kvl), q_offset=vec(qoff),
        q_length=vec(qlen), block_q=8, block_t=16, interpret=True))
    got = ops.prefill_attention(
        _t(qb), _t(kb), torch.from_numpy(v), d=d, nsel=nsel, scale=scale,
        kv_length=vec(kvl), q_offset=vec(qoff), q_length=vec(qlen)).numpy()
    # the Pallas kernel leaves rows past q_length inside a live block
    # unspecified; the port zeros them, like the JAX plain version
    live = np.arange(s)[None, :] < np.broadcast_to(
        s if qlen is None else np.asarray(qlen), (b,))[:, None]
    np.testing.assert_allclose(got[live[:, None].repeat(h, 1)],
                               want[live[:, None].repeat(h, 1)], **TOL)
    assert (got[~live[:, None].repeat(h, 1)] == 0).all()


def test_prefill_plain_matches_jax_plain_version(jax_ref):
    """The twin of ref.prefill_attention_ref, row for row, padded rows too."""
    b, h, hk, s, t, d, dv, nsel = 2, 4, 2, 16, 32, 64, 8, 7
    qb, kb, v = _prefill_inputs(b, h, hk, s, t, d, dv, seed=5)
    # per query-head row: slot 0 is mid-prompt, slot 1 a short padded chunk
    kvl = np.repeat(np.array([25, 9], np.int32), h)
    qoff = np.repeat(np.array([9, 0], np.int32), h)
    qlen = np.repeat(np.array([16, 9], np.int32), h)
    args = dict(d=d, nsel=nsel, scale=0.125, group_size=h // hk)
    want = jref.prefill_attention_ref(
        jnp.asarray(qb.reshape(b * h, s, -1)),
        jnp.asarray(kb.reshape(b * hk, t, -1)),
        jnp.asarray(v.reshape(b * hk, t, dv)), kv_length=jnp.asarray(kvl),
        q_offset=jnp.asarray(qoff), q_length=jnp.asarray(qlen), **args)
    got = ref.prefill_attention_ref(
        _t(qb.reshape(b * h, s, -1)), _t(kb.reshape(b * hk, t, -1)),
        torch.from_numpy(v.reshape(b * hk, t, dv)),
        kv_length=torch.from_numpy(kvl), q_offset=torch.from_numpy(qoff),
        q_length=torch.from_numpy(qlen), **args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# K2: paged decode
# ---------------------------------------------------------------------------

def _paged_inputs(b, h, hk, nb, page, d, dv, n_pages, lengths, seed,
                  holes=True):
    """Shuffled physical pages; unallocated table entries past each row's
    length are -1 (when `holes`) so the wrapper's clamp is exercised."""
    rng = np.random.default_rng(seed)
    qb = _bits((b, h, d), seed + 1)
    w = qb.shape[-1]
    k_pool = _bits((n_pages, hk, page, d), seed + 2).swapaxes(-1, -2).copy()
    v_pool = rng.normal(size=(n_pages, hk, page, dv)).astype(np.float32)
    bt = rng.permutation(n_pages)[: b * nb].reshape(b, nb).astype(np.int32)
    if holes:
        for i, n in enumerate(lengths):
            bt[i, -(-n // page):] = -1
    assert k_pool.shape == (n_pages, hk, w, page)
    return qb, k_pool, v_pool, bt, np.asarray(lengths, np.int32)


PAGED_CASES = {
    # name: (b, h, hk, nb, page, d, dv, n_pages, lengths, nsel)
    "smollm_like": (2, 6, 2, 5, 16, 64, 16, 12, [80, 33], 10),
    "ragged_tail": (3, 4, 2, 8, 8, 48, 16, 30, [64, 17, 1], 5),
    "n_exceeds": (1, 2, 1, 4, 8, 16, 16, 6, [20], 1000),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_decode_plain_matches_jax_kernel(jax_ref, case):
    b, h, hk, nb, page, d, dv, n_pages, lengths, nsel = PAGED_CASES[case]
    qb, k_pool, v_pool, bt, lens = _paged_inputs(
        b, h, hk, nb, page, d, dv, n_pages, lengths, seed=len(case))
    scale = float(np.float32(1.0 / np.sqrt(d)))
    want = np.asarray(jops.paged_decode_attention(
        jnp.asarray(qb), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(bt), d=d, nsel=nsel, scale=scale,
        lengths=jnp.asarray(lens), interpret=True))
    got = ops.paged_decode_attention(
        _t(qb), _t(k_pool), torch.from_numpy(v_pool), torch.from_numpy(bt),
        d=d, nsel=nsel, scale=scale, lengths=torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_row_tables_match_jax(jax_ref):
    bt = np.array([[3, 1, -1, -1], [0, 2, 5, -1]], np.int32)
    lens = np.array([20, 37], np.int32)
    want = jops._row_tables(jnp.asarray(bt), jnp.asarray(lens), 3, 16)
    got = ops._row_tables(torch.from_numpy(bt), torch.from_numpy(lens), 3, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_page_topn_is_not_ported():
    qb, k_pool, v_pool, bt, lens = _paged_inputs(1, 2, 1, 2, 8, 16, 16, 4,
                                                 [9], seed=0)
    with pytest.raises(NotImplementedError, match="K3"):
        ops.paged_decode_attention(
            _t(qb), _t(k_pool), torch.from_numpy(v_pool),
            torch.from_numpy(bt), d=16, nsel=4, scale=0.25,
            lengths=torch.from_numpy(lens), page_topn=1)


def test_cpu_tensors_never_launch_kernels(jax_ref):
    ops.reset_launch_counts()
    test_paged_decode_plain_matches_jax_kernel(None, "ragged_tail")
    test_prefill_plain_matches_jax_kernel(None, "ragged_gqa")
    assert ops.launch_counts() == {pre.NAME: 0, pdec.NAME: 0}


# ---------------------------------------------------------------------------
# CUDA kernels vs plain versions (on the card only)
# ---------------------------------------------------------------------------

CUDA_TOL = dict(rtol=1e-4, atol=1e-5)
# wider shapes on the card only (their plain versions run there too): four
# words per key, V width 128 and long tables take the kernels past 48 KB
# of shared memory, the opt-in path
CUDA_PREFILL_CASES = dict(PREFILL_CASES, wide_d128_dv128=(
    2, 4, 2, 96, 160, 128, 128, 20, [160, 70], [64, 0], [96, 70]))
CUDA_PAGED_CASES = dict(PAGED_CASES, long_table_dv128=(
    1, 4, 1, 1500, 16, 128, 128, 1600, [23900], 500))


@pytest.mark.cuda
@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CUDA_PREFILL_CASES))
def test_prefill_cuda_matches_plain(cuda, case, vdtype):
    b, h, hk, s, t, d, dv, nsel, kvl, qoff, qlen = CUDA_PREFILL_CASES[case]
    qb, kb, v = _prefill_inputs(b, h, hk, s, t, d, dv, seed=len(case))
    v = torch.from_numpy(v).to(vdtype)
    kw = dict(d=d, nsel=nsel, scale=0.125, kv_length=kvl,
              q_offset=qoff, q_length=qlen)
    want = ops.prefill_attention(_t(qb), _t(kb), v, **kw)
    before = pre.launches
    got = ops.prefill_attention(_t(qb).to(cuda), _t(kb).to(cuda), v.to(cuda),
                                **kw)
    torch.cuda.synchronize()
    assert pre.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CUDA_PAGED_CASES))
def test_paged_decode_cuda_matches_plain(cuda, case, vdtype):
    b, h, hk, nb, page, d, dv, n_pages, lengths, nsel = \
        CUDA_PAGED_CASES[case]
    qb, k_pool, v_pool, bt, lens = _paged_inputs(
        b, h, hk, nb, page, d, dv, n_pages, lengths, seed=len(case))
    args = [_t(qb), _t(k_pool), torch.from_numpy(v_pool).to(vdtype),
            torch.from_numpy(bt)]
    kw = dict(d=d, nsel=nsel, scale=0.125)
    want = ops.paged_decode_attention(*args, lengths=torch.from_numpy(lens),
                                      **kw)
    before = pdec.launches
    got = ops.paged_decode_attention(*[a.to(cuda) for a in args],
                                     lengths=torch.from_numpy(lens).to(cuda),
                                     **kw)
    torch.cuda.synchronize()
    assert pdec.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **CUDA_TOL)
