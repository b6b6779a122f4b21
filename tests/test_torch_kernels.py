"""The five ported kernels: plain versions against the JAX Pallas kernels,
and the CUDA kernels against the plain versions (K3's fused bounds +
selection + compaction against JAX's page scores followed by JAX's
select_pages).

On the CPU the port's ops layer runs the kernels' plain versions; they are
held against the JAX package's Pallas kernels run in interpret mode on the
same numpy-seeded inputs: integers (scores, page bounds, selected tables)
exactly, float32 outputs at atol 1e-6, rtol 1e-5 (the two sum the same
terms in different orders). Inside the port, the same tokens give
bit-identical decode outputs on the dense cache, the paged cache and a
compacted page table that keeps every resident page. The CUDA cases need a
card and skip without one; on the card they hold the kernels to the plain
versions (floats at atol 1e-5, rtol 1e-4; integers exactly). The machine
with the card has a CUDA build of JAX too: run this file there with
`JAX_PLATFORMS=cpu` (`JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_kernels.py`), or JAX's float32 matmuls run in TF32. The
JAX cases skip where JAX is missing.
"""
import inspect

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

try:
    import jax.numpy as jnp
    from repro.kernels import binary_page_score as JPS
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jnp = JPS = jops = jref = None
from repro_torch.core import hamming as th
from repro_torch.kernels import binary_decode_attention as dec
from repro_torch.kernels import binary_page_score as pscore
from repro_torch.kernels import binary_paged_decode_attention as pdec
from repro_torch.kernels import binary_prefill_attention as pre
from repro_torch.kernels import hamming_score as hs
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


def test_plain_paged_decode_takes_the_kernels_row_tables(jax_ref):
    """The CPU path runs K2's plain version on the row tables and counts
    the kernel takes; the per-slot JAX oracle agrees with it."""
    b, h, hk, nb, page, d, dv, n_pages, lengths, nsel = PAGED_CASES[
        "ragged_tail"]
    qb, k_pool, v_pool, bt, lens = _paged_inputs(
        b, h, hk, nb, page, d, dv, n_pages, lengths, seed=3)
    tables, counts, _ = ops._row_tables(torch.from_numpy(bt),
                                        torch.from_numpy(lens), hk, page)
    g = h // hk
    got = ref.paged_decode_attention_rows_ref(
        _t(qb.reshape(b * hk, g, -1)), _t(k_pool), torch.from_numpy(v_pool),
        tables, counts, d=d, nsel=nsel, scale=0.25)
    want = jref.paged_decode_attention_ref(
        jnp.asarray(qb.reshape(b, hk, g, -1)), jnp.asarray(k_pool),
        jnp.asarray(v_pool), jnp.asarray(bt), d=d, nsel=nsel, scale=0.25,
        lengths=jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(b * hk, g, dv), **TOL)


def test_out_of_range_table_entries_count_as_zero():
    """K2's and K3's plain versions, like the kernels, read table entries
    outside [0, n_pages) as count 0, whatever count they carry."""
    qb, k_pool, v_pool, bt, lens = _paged_inputs(1, 2, 1, 4, 8, 48, 8, 6,
                                                 [32], seed=4, holes=False)
    tables, counts, _ = ops._row_tables(torch.from_numpy(bt),
                                        torch.from_numpy(lens), 1, 8)
    bad = tables.clone()
    bad[0, 1], bad[0, 3] = 6, -3                 # n_pages, negative
    zeroed = counts.clone()
    zeroed[0, 1] = zeroed[0, 3] = 0
    args = (_t(qb).reshape(1, 2, -1), _t(k_pool))
    got = ref.paged_page_scores_ref(*args, bad, counts, d=48)
    assert got[0, 1] == got[0, 3] == -48
    np.testing.assert_array_equal(
        got.numpy(), ref.paged_page_scores_ref(*args, tables, zeroed,
                                               d=48).numpy())
    kw = dict(d=48, nsel=5, scale=0.25)
    v = torch.from_numpy(v_pool)
    assert torch.equal(
        ref.paged_decode_attention_rows_ref(*args[:1], args[1], v, bad,
                                            counts, **kw),
        ref.paged_decode_attention_rows_ref(*args[:1], args[1], v, tables,
                                            zeroed, **kw))


@pytest.mark.parametrize("nb,page", [(256, 16), (255, 16), (64, 16),
                                     (34, 48), (3, 1)])
def test_split_plan_depends_on_shapes_only(nb, page):
    """K2's grid and scratch come from tensor shapes: rows with different
    lengths (so different counts) give the same plan, and the splits cut
    the row's 64-position tiles into runs of SPLIT_TILES."""
    b, h, hk, d, dv = 2, 6, 2, 64, 16
    plans = []
    for lengths in ([nb * page, 1], [0, nb * page // 2]):
        qb, k_pool, _, bt, lens = _paged_inputs(
            b, h, hk, nb, page, d, dv, b * nb, lengths, seed=nb, holes=False)
        tables, counts, _ = ops._row_tables(torch.from_numpy(bt),
                                            torch.from_numpy(lens), hk, page)
        q = _t(qb).reshape(b * hk, h // hk, -1)
        plans.append(pdec.split_plan(q.shape, tables.shape[1] * page, dv, d))
    assert plans[0] == plans[1]
    plan = plans[0]
    r, g, t = b * hk, h // hk, ref.TILE_KEYS
    assert plan.n_tiles == -(-nb * page // t)
    assert (plan.n_splits - 1) * pdec.SPLIT_TILES < plan.n_tiles \
        <= plan.n_splits * pdec.SPLIT_TILES
    assert plan.scratch_words == r * (plan.n_splits * g * (d + 1)
                                      + plan.n_tiles + 1
                                      + plan.n_tiles * (g * dv + g))
    assert pdec.split_plan((r, g, 2), nb * page, dv, d,
                           split_tiles=4).n_splits == -(-plan.n_tiles // 4)


@pytest.mark.parametrize("kernel,t", [("prefill", 4096), ("prefill", 4097),
                                      ("prefill", 1), ("decode", 4096),
                                      ("decode", 53), ("decode", 1)])
def test_k1_k4_plans_depend_on_shapes_only(kernel, t):
    """K1's and K4's grids and scratch come from tensor shapes alone (no
    plan argument can carry a length or an offset; K1's also takes the
    GQA group size, which shapes its waves), and
    their splits cut the key axis into runs of SPLIT_TILES 64-key tiles
    counted from key 0. K4 takes K2's plan with T positions a row."""
    b, h, hk, s, d, dv = 2, 6, 2, 300, 64, 32
    g = h // hk
    mod = pre if kernel == "prefill" else pdec
    assert list(inspect.signature(mod.split_plan).parameters) == [
        "q_shape", "t" if kernel == "prefill" else "n_pos", "dv", "d",
        "split_tiles"] + (["group_size"] if kernel == "prefill" else [])
    keys = mod.SPLIT_TILES * ref.TILE_KEYS
    if kernel == "prefill":
        plan = pre.split_plan((b * h, s, 2), t, dv, d)
        assert plan.n_qtiles == -(-s // pre.QUERY_TILE)
        blocks = b * h * plan.n_qtiles * plan.n_splits
        # per block: uint16 histograms [64, d+1], float32 sums [64, dv+1]
        assert plan.scratch_words * 4 == blocks * pre.QUERY_TILE * (
            2 * (d + 1) + 4 * (dv + 1))
        assert pre.split_plan((b * h, s, 2), t, dv, d, split_tiles=4) \
            .n_splits == -(-t // (4 * ref.TILE_KEYS))
    else:
        plan = pdec.split_plan((b * hk, g, 2), t, dv, d)
        assert plan.n_tiles == -(-t // ref.TILE_KEYS)
        assert plan.scratch_words == b * hk * (
            plan.n_splits * g * (d + 1) + plan.n_tiles + 1
            + plan.n_tiles * (g * dv + g))
    assert (plan.n_splits - 1) * keys < t <= plan.n_splits * keys


# ---------------------------------------------------------------------------
# K3: page scores, and page-sparse decode through select_pages
# ---------------------------------------------------------------------------

SPARSE_CASE = (2, 4, 2, 6, 8, 64, 16, 13, [48, 38], 10)


@pytest.mark.parametrize("d", [16, 48, 64])
def test_page_scores_plain_match_jax_kernel(jax_ref, d):
    """Count-0 blocks (-1 entries past each row's pages, a zero-length
    row) score exactly -d; d = 48 has 16 tail bits per query word."""
    b, h, hk, nb, page = 3, 4, 2, 6, 8
    g = h // hk
    qb, k_pool, _, bt, lens = _paged_inputs(b, h, hk, nb, page, d, 8, 20,
                                            [48, 19, 0], seed=d)
    jt, jc, _ = jops._row_tables(jnp.asarray(bt), jnp.asarray(lens), hk,
                                 page)
    qf = qb.reshape(b * hk, g, -1)
    want = np.asarray(JPS.paged_page_scores(
        jnp.asarray(qf), jnp.asarray(k_pool), jt, jc, d=d, n_kv_heads=hk,
        interpret=True))
    tables, counts, _ = ops._row_tables(torch.from_numpy(bt),
                                        torch.from_numpy(lens), hk, page)
    got = ref.paged_page_scores_ref(_t(qf), _t(k_pool), tables, counts, d=d)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[counts == 0] == -d).all() and (counts == 0).sum() > nb
    twin = ref.page_scores_ref(_t(qb.reshape(b, hk, g, -1)), _t(k_pool),
                               torch.from_numpy(bt), d=d,
                               lengths=torch.from_numpy(lens))
    np.testing.assert_array_equal(twin.numpy(), np.asarray(jref.page_scores_ref(
        jnp.asarray(qb.reshape(b, hk, g, -1)), jnp.asarray(k_pool),
        jnp.asarray(bt), d=d, lengths=jnp.asarray(lens))))


@given(st.integers(1, 7), st.integers(0, 10_000))
@settings(max_examples=20, deadline=None)
def test_select_pages_matches_jax(n_sel, seed):
    """Tables, counts and logical ids equal JAX's exactly, on scores drawn
    from three levels so that ties are everywhere (lax.top_k breaks them
    toward the lowest block)."""
    if jops is None:
        pytest.skip("needs the JAX reference package")
    r, nb, page, n_pages = 5, 6, 8, 40
    rng = np.random.default_rng(seed)
    scores = (rng.integers(-1, 2, size=(r, nb)) * 2).astype(np.int32)
    bt = rng.integers(0, n_pages, size=(r, nb)).astype(np.int32)
    bt[:, -2:] = -1
    lengths = rng.integers(0, (nb - 2) * page + 1, size=r).astype(np.int32)
    want = jops.select_pages(jnp.asarray(scores), jnp.asarray(bt),
                             jnp.asarray(lengths), page=page, n_sel=n_sel)
    got = ops.select_pages(torch.from_numpy(scores), torch.from_numpy(bt),
                           torch.from_numpy(lengths), page=page, n_sel=n_sel)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _select_inputs(d, lengths, seed, ties=False, nb=6, page=8, b=3, h=4,
                   hk=2):
    """Row inputs of the fused page select: q [R, G, W], a pool, row tables
    and counts from shuffled per-slot tables, per-row lengths. With `ties`,
    every key of a page is one of three words, so many pages share a
    bound. Blocks holding no valid key get out-of-range table entries."""
    n_pages = b * nb + 4
    qb, k_pool, _, bt, lens = _paged_inputs(b, h, hk, nb, page, d, 8,
                                            n_pages, lengths, seed=seed)
    if ties:
        rng = np.random.default_rng(seed + 5)
        words = _bits((3, d), seed + 6)                      # [3, W]
        pick = rng.integers(0, 3, size=n_pages)
        k_pool[:] = words[pick][:, None, :, None]
    tables, counts, len_f = ops._row_tables(torch.from_numpy(bt),
                                            torch.from_numpy(lens), hk, page)
    odd = (torch.arange(nb) % 2 == 1)[None]
    tables = torch.where((counts == 0) & odd, n_pages + 5, tables)
    qf = qb.reshape(b * hk, h // hk, -1)
    return qf, k_pool, tables, counts, len_f, hk, page


def _jax_select(qf, k_pool, tables, counts, len_f, *, d, hk, page, n_sel):
    """The JAX kernel path: the Pallas page scores (interpret mode), then
    the JAX select_pages."""
    scores = JPS.paged_page_scores(
        jnp.asarray(qf), jnp.asarray(k_pool), jnp.asarray(tables.numpy()),
        jnp.asarray(counts.numpy()), d=d, n_kv_heads=hk, interpret=True)
    return jops.select_pages(scores, jnp.asarray(tables.numpy()),
                             jnp.asarray(len_f.numpy()), page=page,
                             n_sel=n_sel)


@pytest.mark.parametrize("n_sel", [1, 2, 3, 6, 9])
@pytest.mark.parametrize("d", [16, 48, 64])
def test_paged_select_pages_plain_matches_jax(jax_ref, d, n_sel):
    """The fused kernel's plain version equals JAX's page scores followed by
    JAX's select_pages exactly: rows with 6, 3 and 0 resident blocks of 6,
    n_sel from the frontier alone to past the table, out-of-range entries
    where blocks hold no key."""
    qf, k_pool, tables, counts, len_f, hk, page = _select_inputs(
        d, [48, 19, 0], seed=d + n_sel)
    got = ref.paged_select_pages_ref(_t(qf), _t(k_pool), tables, counts,
                                     len_f, d=d, page=page, n_sel=n_sel)
    want = _jax_select(qf, k_pool, tables, counts, len_f, d=d, hk=hk,
                       page=page, n_sel=n_sel)
    assert (tables >= k_pool.shape[0]).any() and (len_f == 0).any()
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (6, min(n_sel, 6))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@given(st.integers(1, 8), st.lists(st.integers(0, 48), min_size=3,
                                   max_size=3), st.integers(0, 10_000))
@settings(max_examples=15, deadline=None)
def test_paged_select_pages_ties_match_jax(n_sel, lengths, seed):
    """Tie-heavy keys (every key of a page one of three words): the plain
    fused select still equals JAX's, ties going to the lowest block."""
    if jops is None:
        pytest.skip("needs the JAX reference package")
    qf, k_pool, tables, counts, len_f, hk, page = _select_inputs(
        48, lengths, seed=seed, ties=True)
    got = ref.paged_select_pages_ref(_t(qf), _t(k_pool), tables, counts,
                                     len_f, d=48, page=page, n_sel=n_sel)
    want = _jax_select(qf, k_pool, tables, counts, len_f, d=48, hk=hk,
                       page=page, n_sel=n_sel)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_page_select_wrapper_rejects_bad_inputs():
    """The fused kernel's wrapper checks what its C entry point assumes
    before any launch: the pool's page size, one length a row, n_sel >= 1,
    the bounds' shape, and CUDA tensors (on the CPU it raises; the ops
    layer runs the plain version there)."""
    qf, k_pool, tables, counts, len_f, _, page = _select_inputs(
        64, [48, 19, 0], seed=3)
    args = (_t(qf), _t(k_pool), tables, counts, len_f)
    before = pscore.launches
    for kw, match in ((dict(page=page + 1, n_sel=2), "page"),
                      (dict(page=page, n_sel=0), "n_sel"),
                      (dict(page=page, n_sel=2,
                            scores_out=torch.empty(2, 2, dtype=torch.int32)),
                       "scores_out"),
                      (dict(page=page, n_sel=2), "CUDA")):
        with pytest.raises(ValueError, match=match):
            pscore.paged_select_pages(*args, d=64, **kw)
    with pytest.raises(ValueError, match="lengths"):
        pscore.paged_select_pages(*args[:4], len_f[:2], d=64, page=page,
                                  n_sel=2)
    assert pscore.launches == before


@pytest.mark.parametrize("page_topn", [1, 2, 3])
def test_paged_sparse_plain_matches_jax(jax_ref, page_topn):
    b, h, hk, nb, page, d, dv, n_pages, lengths, nsel = SPARSE_CASE
    g = h // hk
    qb, k_pool, v_pool, bt, lens = _paged_inputs(
        b, h, hk, nb, page, d, dv, n_pages, lengths, seed=17)
    kw = dict(d=d, nsel=nsel, scale=0.125, page_topn=page_topn)
    want = np.asarray(jops.paged_decode_attention(
        jnp.asarray(qb), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(bt), lengths=jnp.asarray(lens), interpret=True, **kw))
    got = ops.paged_decode_attention(
        _t(qb), _t(k_pool), torch.from_numpy(v_pool), torch.from_numpy(bt),
        lengths=torch.from_numpy(lens), **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    twin = ref.paged_sparse_decode_attention_ref(
        _t(qb.reshape(b, hk, g, -1)), _t(k_pool), torch.from_numpy(v_pool),
        torch.from_numpy(bt), lengths=torch.from_numpy(lens), **kw)
    jtwin = jref.paged_sparse_decode_attention_ref(
        jnp.asarray(qb.reshape(b, hk, g, -1)), jnp.asarray(k_pool),
        jnp.asarray(v_pool), jnp.asarray(bt), lengths=jnp.asarray(lens), **kw)
    np.testing.assert_allclose(twin.numpy(), np.asarray(jtwin), **TOL)
    np.testing.assert_allclose(got, twin.reshape(b, h, dv).numpy(), **TOL)


@pytest.mark.parametrize("page_topn", [3, 4, 5, 6, 9])
def test_page_topn_covering_resident_pages_is_bit_identical(page_topn):
    """page_topn >= each row's resident pages: the compacted table lists
    every resident page in logical order, then count-0 entries, and the
    result equals the full-table walk bit for bit (for page_topn < nb the
    page scores run)."""
    b, h, hk, nb, page, d, dv = 3, 4, 2, 6, 8, 64, 16
    qb, k_pool, v_pool, bt, lens = _paged_inputs(
        b, h, hk, nb, page, d, dv, 20, [24, 13, 1], seed=21)
    args = (_t(qb), _t(k_pool), torch.from_numpy(v_pool),
            torch.from_numpy(bt))
    kw = dict(d=d, nsel=7, scale=0.125, lengths=torch.from_numpy(lens))
    assert torch.equal(ops.paged_decode_attention(*args, **kw),
                       ops.paged_decode_attention(*args, page_topn=page_topn,
                                                  **kw))


# ---------------------------------------------------------------------------
# K4: decode over a contiguous (dense) cache
# ---------------------------------------------------------------------------

DECODE_CASES = {
    # name: (b, h, hk, t, d, dv, nsel, lengths)
    "ragged": (3, 4, 2, 48, 48, 16, 5, [48, 17, 1]),
    "smollm_like": (2, 6, 2, 80, 64, 16, 10, [80, 33]),
    "n_exceeds": (1, 2, 1, 32, 16, 8, 1000, [20]),
}


def _decode_inputs(b, h, hk, t, d, dv, seed):
    v = np.random.default_rng(seed + 2).normal(
        size=(b, hk, t, dv)).astype(np.float32)
    return _bits((b, h, d), seed), _bits((b, hk, t, d), seed + 1), v


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_jax_kernel(jax_ref, case):
    b, h, hk, t, d, dv, nsel, lengths = DECODE_CASES[case]
    qb, kb, v = _decode_inputs(b, h, hk, t, d, dv, seed=len(case))
    lens = np.asarray(lengths, np.int32)
    kw = dict(d=d, nsel=nsel, scale=float(np.float32(1 / np.sqrt(d))))
    want = np.asarray(jops.decode_attention(
        jnp.asarray(qb), jnp.asarray(kb), jnp.asarray(v),
        lengths=jnp.asarray(lens), block_t=16, interpret=True, **kw))
    got = ops.decode_attention(_t(qb), _t(kb), torch.from_numpy(v),
                               lengths=torch.from_numpy(lens), **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the dense cache's own bit-plane layout gives the same result
    planes = _t(kb).transpose(-1, -2).contiguous()
    assert torch.equal(got, ops.decode_attention(
        _t(qb), planes, torch.from_numpy(v), lengths=torch.from_numpy(lens),
        bitplanes=True, **kw))


def _dense_and_paged(b, h, hk, nb, page, d, dv, t_dense, lengths, seed):
    """The same tokens in a dense cache of t_dense positions (garbage past
    each row's length) and in shuffled pages of a pool."""
    rng = np.random.default_rng(seed)
    qb = _bits((b, h, d), seed + 1)
    kb = _bits((b, hk, t_dense, d), seed + 2)
    v = rng.normal(size=(b, hk, t_dense, dv)).astype(np.float32)
    w = kb.shape[-1]
    n_pages = b * nb + 2
    k_pool = _bits((n_pages, hk, page, d), seed + 3).swapaxes(-1, -2).copy()
    v_pool = rng.normal(size=(n_pages, hk, page, dv)).astype(np.float32)
    bt = rng.permutation(n_pages)[: b * nb].reshape(b, nb).astype(np.int32)
    for i, n in enumerate(lengths):
        for j in range(-(-n // page)):
            lo, hi = j * page, min((j + 1) * page, n)
            k_pool[bt[i, j], :, :, : hi - lo] = kb[i, :, lo:hi].swapaxes(
                -1, -2)
            v_pool[bt[i, j], :, : hi - lo] = v[i, :, lo:hi]
        bt[i, -(-n // page):] = -1
    assert k_pool.shape[2] == w
    return (qb, kb, v, k_pool, v_pool, bt, np.asarray(lengths, np.int32))


def test_dense_decode_equals_paged_bit_for_bit():
    """Dense cache (53 positions: neither a page nor a tile multiple),
    paged cache, and a page-sparse table that keeps every resident page
    give the same bits for the same tokens."""
    b, h, hk, nb, page, d, dv = 3, 4, 2, 6, 8, 64, 16
    qb, kb, v, k_pool, v_pool, bt, lens = _dense_and_paged(
        b, h, hk, nb, page, d, dv, 53, [40, 19, 1], seed=9)
    kw = dict(d=d, nsel=9, scale=0.125, lengths=torch.from_numpy(lens))
    dense = ops.decode_attention(_t(qb), _t(kb), torch.from_numpy(v), **kw)
    args = (_t(qb), _t(k_pool), torch.from_numpy(v_pool),
            torch.from_numpy(bt))
    assert torch.equal(dense, ops.paged_decode_attention(*args, **kw))
    assert torch.equal(dense, ops.paged_decode_attention(*args, page_topn=5,
                                                         **kw))


# ---------------------------------------------------------------------------
# K5: the binary score matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["xor", "int8"])
@pytest.mark.parametrize("d", [48, 64])
def test_hamming_scores_match_jax(jax_ref, d, method):
    qb, kb = _bits((2, 3, 5, d), d), _bits((2, 3, 7, d), d + 1)
    want = np.asarray(jops.hamming_scores(
        jnp.asarray(qb), jnp.asarray(kb), d, block_m=4, block_n=4,
        method=method, interpret=True))
    got = ops.hamming_scores(_t(qb), _t(kb), d, method=method)
    assert got.dtype == torch.int32 and got.shape == (2, 3, 5, 7)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.hamming_score_ref(_t(qb), _t(kb), d).numpy(),
        np.asarray(jref.hamming_score_ref(jnp.asarray(qb), jnp.asarray(kb),
                                          d)))


def test_hamming_scores_rejects_unknown_method():
    qb = _t(_bits((2, 32), 0))
    with pytest.raises(ValueError, match="method"):
        ops.hamming_scores(qb, qb, 32, method="fp16")


def test_cpu_tensors_never_launch_kernels(jax_ref):
    ops.reset_launch_counts()
    test_paged_decode_plain_matches_jax_kernel(None, "ragged_tail")
    test_prefill_plain_matches_jax_kernel(None, "ragged_gqa")
    test_paged_sparse_plain_matches_jax(None, 2)
    test_decode_plain_matches_jax_kernel(None, "ragged")
    test_hamming_scores_match_jax(None, 48, "int8")
    counts = ops.launch_counts()
    assert set(counts) == {pre.NAME, pdec.NAME, pscore.NAME, dec.NAME,
                           hs.NAME}
    assert not any(counts.values()), counts


def test_split_launch_counters_ride_with_the_counts():
    """The split counters (K1's non-causal launches, K4's cross-tagged
    ones) are zeroed by a reset, added from a graph's replay counts, and
    left as they are by a restore from counts that do not hold them."""
    splits = {f"{pre.NAME}.noncausal_launches", f"{dec.NAME}.cross_launches"}
    ops.reset_launch_counts()
    every = ops.launch_counts(splits=True)
    assert set(every) == set(ops.launch_counts()) | splits
    assert not any(every.values())
    ops.add_launch_counts({pre.NAME: 3, dec.NAME: 2,
                           f"{pre.NAME}.noncausal_launches": 1,
                           f"{dec.NAME}.cross_launches": 2})
    got = ops.launch_counts(splits=True)
    assert [got[k] for k in sorted(splits)] == [2, 1]
    assert (got[pre.NAME], got[dec.NAME]) == (3, 2)
    ops.reset_launch_counts(ops.launch_counts())
    assert ops.launch_counts(splits=True) == got
    ops.reset_launch_counts()
    assert not any(ops.launch_counts(splits=True).values())


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


# the cross layers' chunk of llama-3.2-vision-11b: every query attends all
# T image keys (no causal mask), T = 1601 not a multiple of a tile, d 128,
# 4 query heads a kv head; nsel below, at, and past the valid keys
CUDA_CROSS_CASES = {
    # name: (b, h, hk, s, t, d, dv, nsel, q_offset)
    "vision_t1601": (2, 8, 2, 70, 1601, 128, 128, 479, [0, 512]),
    "nsel_at_t": (1, 8, 2, 64, 1601, 128, 128, 1601, [37]),
    "nsel_past_t": (2, 4, 1, 33, 1601, 128, 128, 2000, [5, 0]),
    "short_t": (1, 4, 1, 96, 40, 64, 64, 8, [0]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CUDA_CROSS_CASES))
def test_prefill_noncausal_cuda_matches_plain(cuda, case, vdtype):
    b, h, hk, s, t, d, dv, nsel, qoff = CUDA_CROSS_CASES[case]
    qb, kb, v = _prefill_inputs(b, h, hk, s, t, d, dv, seed=len(case))
    v = torch.from_numpy(v).to(vdtype)
    kw = dict(d=d, nsel=nsel, scale=0.125, kv_length=t, q_offset=qoff,
              causal=False)
    want = ops.prefill_attention(_t(qb), _t(kb), v, **kw)
    before = (pre.launches, pre.noncausal_launches)
    got = ops.prefill_attention(_t(qb).to(cuda), _t(kb).to(cuda), v.to(cuda),
                                **kw)
    torch.cuda.synchronize()
    assert (pre.launches, pre.noncausal_launches) == (before[0] + 1,
                                                      before[1] + 1)
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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 48, 64, 128])
def test_page_scores_cuda_matches_plain(cuda, d):
    """Exact integers, with count-0 blocks, a zero-length row and table
    entries outside [0, n_pages)."""
    b, h, hk, nb, page = 3, 6, 2, 40, 16
    qb, k_pool, _, bt, lens = _paged_inputs(b, h, hk, nb, page, d, 8, 130,
                                            [611, 17, 0], seed=d)
    tables, counts, _ = ops._row_tables(torch.from_numpy(bt),
                                        torch.from_numpy(lens), hk, page)
    tables[0, 3], tables[1, 0] = 130, -2
    qf = _t(qb).reshape(b * hk, h // hk, -1)
    want = ref.paged_page_scores_ref(qf, _t(k_pool), tables, counts, d=d)
    before = pscore.launches
    got = pscore.paged_page_scores(qf.to(cuda), _t(k_pool).to(cuda),
                                   tables.to(cuda), counts.to(cuda), d=d)
    torch.cuda.synchronize()
    assert pscore.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("page_topn", [1, 3, 30])
def test_paged_sparse_cuda_matches_plain(cuda, page_topn):
    b, h, hk, nb, page, d, dv = 3, 6, 2, 40, 16, 64, 64
    qb, k_pool, v_pool, bt, lens = _paged_inputs(
        b, h, hk, nb, page, d, dv, 130, [611, 170, 9], seed=page_topn)
    args = [_t(qb), _t(k_pool), torch.from_numpy(v_pool).to(torch.bfloat16),
            torch.from_numpy(bt)]
    kw = dict(d=d, nsel=40, scale=0.125, page_topn=page_topn)
    want = ops.paged_decode_attention(*args, lengths=torch.from_numpy(lens),
                                      **kw)
    before = (pscore.launches, pdec.launches)
    got = ops.paged_decode_attention(*[a.to(cuda) for a in args],
                                     lengths=torch.from_numpy(lens).to(cuda),
                                     **kw)
    torch.cuda.synchronize()
    assert (pscore.launches, pdec.launches) == (before[0] + 1, before[1] + 1)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("keys", ["random", "ties"])
@pytest.mark.parametrize("page", [8, 16, 48])
@pytest.mark.parametrize("nb", [40, 255, 256])
@pytest.mark.parametrize("d", [16, 48, 64, 128])
def test_page_select_cuda_matches_plain(cuda, d, nb, page, keys):
    """The fused bounds + selection + compaction kernel equals its plain
    version exactly -- bounds (scores_out), tables, counts and logical ids --
    at n_sel 1, 3, a row's resident blocks, nb - 1 and past nb, on rows of
    length 0, a page multiple, the whole table and a ragged length, with
    out-of-range table entries inside resident blocks too."""
    lengths = [0, page * (nb // 2), nb * page, nb * page // 3 + 5]
    qf, k_pool, tables, counts, len_f, hk, _ = _select_inputs(
        d, lengths, seed=d + nb + page, ties=keys == "ties", nb=nb,
        page=page, b=4, h=6)
    n_pages = k_pool.shape[0]
    tables[4, 5], tables[6, 0] = n_pages + 7, -4     # resident blocks
    args = [x.to(cuda) for x in (_t(qf), _t(k_pool), tables, counts, len_f)]
    want_scores = ref.paged_page_scores_ref(*args[:4], d=d)
    resident = -(-lengths[3] // page)
    for n_sel in (1, 3, resident, nb - 1, nb + 2):
        want = ref.paged_select_pages_ref(*args, d=d, page=page, n_sel=n_sel)
        scores = torch.full_like(want_scores, 7 * d)
        before = pscore.launches
        got = pscore.paged_select_pages(*args, d=d, page=page, n_sel=n_sel,
                                        scores_out=scores)
        torch.cuda.synchronize()
        assert pscore.launches == before + 1
        assert torch.equal(scores, want_scores), n_sel
        for g, w in zip(got, want):
            assert g.shape == (len(qf), min(n_sel, nb))
            assert torch.equal(g, w), n_sel


@pytest.mark.cuda
def test_paged_sparse_cuda_selects_in_one_kernel(cuda):
    """Between the row tables and K2, page-sparse decode on the card runs
    one kernel, the fused select: no sort, gather or bounds-only kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    b, h, hk, nb, page, d, dv = 3, 6, 2, 40, 16, 64, 64
    qb, k_pool, v_pool, bt, lens = _paged_inputs(
        b, h, hk, nb, page, d, dv, 130, [611, 170, 9], seed=5)
    args = [_t(qb), _t(k_pool), torch.from_numpy(v_pool).to(torch.bfloat16),
            torch.from_numpy(bt), torch.from_numpy(lens)]
    kw = dict(d=d, nsel=40, scale=0.125, page_topn=8)
    want = ops.paged_decode_attention(*args[:4], lengths=args[4], **kw)
    args = [a.to(cuda) for a in args]
    ops.paged_decode_attention(*args[:4], lengths=args[4], **kw)  # warm-up
    torch.cuda.synchronize()
    before = (pscore.launches, pdec.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = ops.paged_decode_attention(*args[:4], lengths=args[4], **kw)
        torch.cuda.synchronize()
    assert (pscore.launches, pdec.launches) == (before[0] + 1, before[1] + 1)
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert sum("page_select_kernel" in n for n in names) == 1, names
    assert not [n for n in names if "sort" in n.lower() or "gather" in
                n.lower() or "page_score_kernel" in n], names
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **CUDA_TOL)


def _split_case(name, split):
    """Row tables and counts that put the split K2's edges to work, with
    split = its positions per split: lengths split-1, split and split+1; a
    row with one valid key next to an all-idle row; a row whose only valid
    keys lie in its last split (earlier blocks count 0) beside an all-idle
    row."""
    b, h, hk, page, d, dv = 3, 6, 2, 16, 64, 64
    nb = 3 * split // page
    lengths = {"split_edges": [split - 1, split, split + 1],
               "one_key_and_idle": [1, 0, 2 * split],
               "last_split_only": [3 * split, 0, 3 * split - 5]}[name]
    qb, k_pool, v_pool, bt, lens = _paged_inputs(
        b, h, hk, nb, page, d, dv, b * nb + 3, lengths, seed=len(name))
    tables, counts, _ = ops._row_tables(torch.from_numpy(bt),
                                        torch.from_numpy(lens), hk, page)
    if name == "last_split_only":
        counts[:, : 2 * split // page] = 0
    q = _t(qb).reshape(b * hk, h // hk, -1)
    return q, _t(k_pool), torch.from_numpy(v_pool), tables, counts


@pytest.mark.cuda
@pytest.mark.parametrize("split_tiles", [4, 8])
@pytest.mark.parametrize("name", ["split_edges", "one_key_and_idle",
                                  "last_split_only"])
def test_split_paged_decode_cuda_matches_plain(cuda, monkeypatch, name,
                                               split_tiles):
    """The split K2 against its plain version at the edges of its splits;
    another split size gives the same bits; idle rows are exactly 0."""
    q, k_pool, v_pool, tables, counts = _split_case(
        name, split_tiles * ref.TILE_KEYS)
    v_pool = v_pool.to(torch.bfloat16)
    kw = dict(d=64, nsel=100, scale=0.125)
    want = ref.paged_decode_attention_rows_ref(q, k_pool, v_pool, tables,
                                               counts, **kw)
    args = [x.to(cuda) for x in (q, k_pool, v_pool, tables, counts)]
    before = pdec.launches
    monkeypatch.setattr(pdec, "SPLIT_TILES", split_tiles)
    got = pdec.paged_decode_attention(*args, **kw)
    monkeypatch.setattr(pdec, "SPLIT_TILES", {4: 8, 8: 4}[split_tiles])
    other = pdec.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pdec.launches == before + 2
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **CUDA_TOL)
    assert torch.equal(got, other)
    idle = (counts.sum(1) == 0).to(cuda)
    assert bool(idle.any()) == (name != "split_edges")
    assert (got[idle] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("page_topn", [1, 3])
def test_split_paged_decode_compacted_cuda_matches_plain(cuda, page_topn):
    """The split K2 on tables compacted by page-sparse selection (nb =
    page_topn) from rows of several splits."""
    b, h, hk, nb, page, d, dv = 3, 6, 2, 100, 16, 64, 64
    qb, k_pool, v_pool, bt, lens = _paged_inputs(
        b, h, hk, nb, page, d, dv, b * nb + 3, [1500, 700, 9],
        seed=page_topn)
    args = [_t(qb), _t(k_pool), torch.from_numpy(v_pool).to(torch.bfloat16),
            torch.from_numpy(bt)]
    kw = dict(d=d, nsel=60, scale=0.125, page_topn=page_topn)
    want = ops.paged_decode_attention(*args, lengths=torch.from_numpy(lens),
                                      **kw)
    before = pdec.launches
    got = ops.paged_decode_attention(*[a.to(cuda) for a in args],
                                     lengths=torch.from_numpy(lens).to(cuda),
                                     **kw)
    torch.cuda.synchronize()
    assert pdec.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **CUDA_TOL)


CUDA_DECODE_CASES = dict(DECODE_CASES, long_d128_dv128=(
    1, 4, 1, 24000, 128, 128, 500, [23900]),
    # a cross layer's decode step: the 1601-key image cache, d 128, G 4,
    # 8 kv heads, every key valid, nsel below and past the 1601 keys
    vision_cross_t1601=(2, 32, 8, 1601, 128, 128, 479, [1601, 1601]),
    vision_cross_nsel_past_t=(1, 32, 8, 1601, 128, 128, 2000, [1601]))


@pytest.mark.cuda
@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CUDA_DECODE_CASES))
def test_decode_cuda_matches_plain(cuda, case, vdtype):
    b, h, hk, t, d, dv, nsel, lengths = CUDA_DECODE_CASES[case]
    qb, kb, v = _decode_inputs(b, h, hk, t, d, dv, seed=len(case))
    planes = _t(kb).transpose(-1, -2).contiguous()
    v = torch.from_numpy(v).to(vdtype)
    lens = torch.tensor(lengths, dtype=torch.int32)
    kw = dict(d=d, nsel=nsel, scale=0.125, bitplanes=True)
    want = ops.decode_attention(_t(qb), planes, v, lengths=lens, **kw)
    cross = case.startswith("vision_cross")     # tags the launch only
    before = (dec.launches, dec.cross_launches)
    got = ops.decode_attention(_t(qb).to(cuda), planes.to(cuda), v.to(cuda),
                               lengths=lens.to(cuda), cross=cross, **kw)
    torch.cuda.synchronize()
    assert (dec.launches, dec.cross_launches) == (before[0] + 1,
                                                  before[1] + cross)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("page", [8, 16, 48])
def test_dense_and_paged_kernels_bit_identical(cuda, page):
    """K4 on the dense cache, K2 on the pages and K2 on a page-sparse table
    that keeps every resident page: the same bits, for any page size."""
    b, h, hk, d, dv = 3, 6, 2, 64, 64
    nb = 1600 // page
    qb, kb, v, k_pool, v_pool, bt, lens = _dense_and_paged(
        b, h, hk, nb, page, d, dv, 1601, [1500, 190, 1], seed=page)
    kw = dict(d=d, nsel=100, scale=0.125,
              lengths=torch.from_numpy(lens).to(cuda))
    dense = ops.decode_attention(_t(qb).to(cuda), _t(kb).to(cuda),
                                 torch.from_numpy(v).to(cuda), **kw)
    args = [_t(qb), _t(k_pool), torch.from_numpy(v_pool),
            torch.from_numpy(bt)]
    args = [a.to(cuda) for a in args]
    paged = ops.paged_decode_attention(*args, **kw)
    sparse = ops.paged_decode_attention(*args, page_topn=-(-1500 // page),
                                        **kw)
    torch.cuda.synchronize()
    assert torch.equal(dense, paged) and torch.equal(dense, sparse)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["xor", "int8"])
@pytest.mark.parametrize("d", [48, 64, 128, 256])
def test_hamming_scores_cuda_exact(cuda, d, method):
    """Exact integers for M, N that are not tile multiples."""
    qb, kb = _t(_bits((2, 70, d), d)), _t(_bits((2, 130, d), d + 1))
    want = ops.hamming_scores(qb, kb, d, method=method)
    before = hs.launches
    got = ops.hamming_scores(qb.to(cuda), kb.to(cuda), d, method=method)
    torch.cuda.synchronize()
    assert hs.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 70, 130), (3, 129, 260), (1, 1, 1)])
@pytest.mark.parametrize("d", [16, 48, 64, 128, 256])
def test_hamming_int8_cuda_exact(cuda, d, shape):
    """The int8 tensor-core method equals the plain version exactly: d from
    one mma step (16, padded to 32) to eight (256), and M, N off the
    64 x 128 tile (N % 4 != 0 takes the 4-byte stores, 260 the 16-byte)."""
    bt, m, n = shape
    qb, kb = _t(_bits((bt, m, d), d)), _t(_bits((bt, n, d), d + 1))
    want = ref.hamming_score_ref(qb, kb, d)
    before = hs.launches
    got = hs.hamming_score(qb.to(cuda), kb.to(cuda), d, method="int8")
    torch.cuda.synchronize()
    assert hs.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 70, 130), (3, 129, 260), (1, 1, 1),
                                   (2, 65, 131)])
@pytest.mark.parametrize("d", [16, 48, 64, 128, 256])
def test_hamming_xor_cuda_exact(cuda, d, shape):
    """The xor method equals the plain version exactly: every word count
    its per-W instantiations take, M, N off the 64 x 128 tile, and N % 4 of
    0 (16-byte stores), 1, 2 and 3 (4-byte stores)."""
    bt, m, n = shape
    qb, kb = _t(_bits((bt, m, d), d)), _t(_bits((bt, n, d), d + 1))
    want = ref.hamming_score_ref(qb, kb, d)
    before = hs.launches
    got = hs.hamming_score(qb.to(cuda), kb.to(cuda), d, method="xor")
    torch.cuda.synchronize()
    assert hs.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# the split K1 at the edges of its splits and query tiles (SPLIT = its keys
# per split): name -> (b, h, hk, s, t, d, dv, kv_length, q_offset, q_length)
SPLIT = pre.SPLIT_TILES * ref.TILE_KEYS
K1_EDGE_CASES = {
    "kv_length_split_edges": (3, 2, 1, 64, 3 * SPLIT, 64, 64,
                              [SPLIT - 1, SPLIT, SPLIT + 1],
                              [SPLIT - 65, SPLIT - 64, SPLIT - 63],
                              [64, 64, 64]),
    "q_tile_straddles_q_length": (2, 4, 2, 192, 2 * SPLIT, 64, 64,
                                  [250, 108], [100, 0], [150, 108]),
    "one_visible_key": (2, 2, 1, 64, SPLIT, 64, 64, [1, 1], [0, 700],
                        [1, 5]),
    "q_offset_0_one_query": (2, 2, 1, 128, 2 * SPLIT, 64, 64, [1, SPLIT + 9],
                             [0, SPLIT - 119], [1, 128]),
    "all_slots_idle": (3, 2, 1, 64, SPLIT, 64, 64, [0, 40, 0], [0, 40, 0],
                       [0, 0, 0]),
    "dv16_d16": (2, 2, 1, 96, SPLIT + 64, 16, 16, [SPLIT + 50, 96],
                 [SPLIT - 40, 0], [90, 96]),
    "dv32_d48": (2, 2, 1, 96, SPLIT + 64, 48, 32, [SPLIT + 50, 96],
                 [SPLIT - 40, 0], [90, 96]),
    "dv128_d128": (2, 2, 1, 96, SPLIT + 64, 128, 128, [SPLIT + 50, 96],
                   [SPLIT - 40, 0], [90, 96]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(K1_EDGE_CASES))
def test_split_prefill_cuda_matches_plain(cuda, case, vdtype):
    """The split K1 against its plain version where splits, query tiles and
    lengths meet; rows at or past q_length are exactly 0."""
    b, h, hk, s, t, d, dv, kvl, qoff, qlen = K1_EDGE_CASES[case]
    qb, kb, v = _prefill_inputs(b, h, hk, s, t, d, dv, seed=len(case))
    v = torch.from_numpy(v).to(vdtype)
    kw = dict(d=d, nsel=100, scale=0.125, kv_length=kvl, q_offset=qoff,
              q_length=qlen)
    want = ops.prefill_attention(_t(qb), _t(kb), v, **kw)
    before = pre.launches
    got = ops.prefill_attention(_t(qb).to(cuda), _t(kb).to(cuda), v.to(cuda),
                                **kw).cpu()
    assert pre.launches == before + 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), **CUDA_TOL)
    past = torch.arange(s)[None, :] >= torch.tensor(qlen)[:, None]
    assert (got[past[:, None].expand(b, h, s)] == 0).all()


def _invariance_inputs(slot, t, seed=11):
    """4 slots (3 heads, 1 kv head, d 64, bf16 V), the queries and keys of
    one 512-token chunk at offset 1000 in `slot`, every other slot idle."""
    b, h, s, d, dv, off = 4, 3, 512, 64, 64, 1000
    qb, kb, v = _prefill_inputs(1, h, 1, s, t, d, dv, seed=seed)
    q = torch.zeros((b, h, s, qb.shape[-1]), dtype=torch.int32)
    k = torch.zeros((b, 1, t, kb.shape[-1]), dtype=torch.int32)
    vv = torch.zeros((b, 1, t, dv), dtype=torch.bfloat16)
    q[slot], k[slot], vv[slot] = _t(qb)[0], _t(kb)[0], torch.from_numpy(
        v[0]).to(torch.bfloat16)
    lengths = torch.zeros(b, dtype=torch.int32)

    def run(lo, hi):           # queries [lo, hi) of the chunk as one call
        qlen, qoff = lengths.clone(), lengths.clone()
        qlen[slot], qoff[slot] = hi - lo, off + lo
        out = ops.prefill_attention(
            q[:, :, lo:hi].contiguous().cuda(), k.cuda(), vv.cuda(), d=d,
            nsel=200, scale=0.125, kv_length=(qoff + qlen).cuda(),
            q_offset=qoff.cuda(), q_length=qlen.cuda())
        return out[slot].cpu()
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("setup", ["two_256_chunks", "chunks_200_312",
                                   "t_4097", "slot_3"])
def test_split_prefill_cuda_invariance(cuda, setup):
    """A query's K1 output depends only on its own kept keys at their
    logical positions: the same queries and keys give bit-identical rows as
    one 512-query chunk or as two chunks (a 200/312 cut moves every query
    to another row of its tile), with T = 4096 or 4097, in slot 0 or 3."""
    run = _invariance_inputs(0, 4096)
    whole = run(0, 512)
    if setup == "two_256_chunks":
        other = torch.cat([run(0, 256), run(256, 512)], dim=1)
    elif setup == "chunks_200_312":
        other = torch.cat([run(0, 200), run(200, 512)], dim=1)
    elif setup == "t_4097":
        other = _invariance_inputs(0, 4097)(0, 512)
    else:
        other = _invariance_inputs(3, 4096)(0, 512)
    assert torch.equal(whole, other)


@pytest.mark.cuda
@pytest.mark.parametrize("split_tiles", [1, 2, 4, 8])
def test_dense_decode_split_sizes_equal_paged(cuda, monkeypatch, split_tiles):
    """K4 on K2's split launches: bit-identical across split sizes, and
    equal to K2 bit for bit at lengths split-1, split and split+1."""
    split = pdec.SPLIT_TILES * ref.TILE_KEYS
    b, h, hk, page, d, dv = 3, 6, 2, 16, 64, 64
    nb = 3 * split // page
    lengths = [split - 1, split, split + 1]
    qb, kb, v, k_pool, v_pool, bt, lens = _dense_and_paged(
        b, h, hk, nb, page, d, dv, 3 * split + 5, lengths, seed=split_tiles)
    g, t = h // hk, kb.shape[2]
    q = _t(qb).reshape(b * hk, g, -1).to(cuda)
    planes = _t(kb).transpose(-1, -2).reshape(b * hk, -1, t).contiguous() \
        .to(cuda)
    vv = torch.from_numpy(v).to(torch.bfloat16).reshape(b * hk, t, dv) \
        .to(cuda)
    len_f = torch.from_numpy(lens).repeat_interleave(hk).to(cuda)
    kw = dict(d=d, nsel=100, scale=0.125)
    before = dec.launches
    default = dec.decode_attention(q, planes, vv, len_f, **kw)
    paged = ops.paged_decode_attention(
        _t(qb).to(cuda), _t(k_pool).to(cuda),
        torch.from_numpy(v_pool).to(torch.bfloat16).to(cuda),
        torch.from_numpy(bt).to(cuda), lengths=torch.from_numpy(lens).to(cuda),
        **kw)
    monkeypatch.setattr(pdec, "SPLIT_TILES", split_tiles)
    got = dec.decode_attention(q, planes, vv, len_f, **kw)
    torch.cuda.synchronize()
    assert dec.launches == before + 2
    want = ref.decode_attention_ref(q.cpu(), planes.cpu().transpose(-1, -2),
                                    vv.cpu(), lengths=len_f.cpu(), **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **CUDA_TOL)
    assert torch.equal(got, default)
    assert torch.equal(got.reshape(b, h, dv), paged)
