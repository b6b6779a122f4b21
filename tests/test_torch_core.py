"""The port's HAD core math against the JAX package, exactly.

Packed words, popcounts, Hamming scores, level histograms and top-N
thresholds are integers: the same numpy-seeded inputs must give the same
numbers in both frameworks. Head dims 16 and 48 exercise the zero tail
bits of a partial word, 64 the two-word width of smollm-135m.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hamming as jh
from repro.core import topn as jt
from repro_torch.core import hamming as th
from repro_torch.core import topn as tt

DIMS = [16, 48, 64]


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _words(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int32
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("d", DIMS)
def test_pack_bits_words_equal(d):
    x = _x((3, 5, d), d)
    x[0, 0, :4] = 0.0                       # x >= 0 -> bit 1, zeros included
    got = th.pack_bits(torch.from_numpy(x))
    want = np.asarray(jh.pack_bits(jnp.asarray(x)))
    assert th.packed_words(d) == jh.packed_words(d) == want.shape[-1]
    np.testing.assert_array_equal(_words(got), want)


@pytest.mark.parametrize("d", DIMS)
def test_unpack_bits_roundtrip_equal(d):
    words = th.pack_bits(torch.from_numpy(_x((4, d), d + 1)))
    got = th.unpack_bits(words, d).numpy()
    want = np.asarray(jh.unpack_bits(jnp.asarray(_words(words)), d))
    np.testing.assert_array_equal(got, want)


def test_popcount_matches_bit_count():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2 ** 32, size=1000, dtype=np.uint64).astype(np.uint32)
    u[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    got = th.popcount(torch.from_numpy(u.view(np.int32))).numpy()
    want = np.array([bin(int(v)).count("1") for v in u], np.int32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", DIMS)
def test_binary_scores_equal(d):
    qx, kx = _x((2, 7, d), d + 2), _x((2, 11, d), d + 3)
    got = th.binary_scores(th.pack_bits(torch.from_numpy(qx)),
                           th.pack_bits(torch.from_numpy(kx)), d)
    want = jh.binary_scores(jh.pack_bits(jnp.asarray(qx)),
                            jh.pack_bits(jnp.asarray(kx)), d)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the identity the scores stand for: dot of the +-1 vectors
    dots = np.einsum("bmd,bnd->bmn", np.where(qx >= 0, 1, -1),
                     np.where(kx >= 0, 1, -1))
    np.testing.assert_array_equal(got.numpy(), dots)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("nsel", [1, 5, 40])
def test_histogram_threshold_mask_equal(d, nsel):
    qx, kx = _x((3, 6, d), d + 4), _x((3, 30, d), d + 5)
    valid = np.random.default_rng(d + nsel).random((3, 6, 30)) < 0.7
    valid[0, 0] = False                                    # an empty row
    st = th.binary_scores(th.pack_bits(torch.from_numpy(qx)),
                          th.pack_bits(torch.from_numpy(kx)), d)
    sj = jnp.asarray(st.numpy())
    vt, vj = torch.from_numpy(valid), jnp.asarray(valid)
    hist_t = tt.score_histogram(st, d, valid=vt)
    hist_j = jt.score_histogram(sj, d, valid=vj)
    np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j))
    np.testing.assert_array_equal(
        tt.threshold_from_histogram(hist_t, nsel, d).numpy(),
        np.asarray(jt.threshold_from_histogram(hist_j, nsel, d)))
    np.testing.assert_array_equal(
        tt.topn_mask_binary(st, nsel, d, valid=vt).numpy(),
        np.asarray(jt.topn_mask_binary(sj, nsel, d, valid=vj)))


def test_sparse_softmax_allclose():
    logits = _x((4, 9), 1)
    mask = np.random.default_rng(2).random((4, 9)) < 0.5
    mask[1] = False                                        # all-masked row
    got = tt.sparse_softmax(torch.from_numpy(logits), torch.from_numpy(mask),
                            scale=0.25).numpy()
    want = np.asarray(jt.sparse_softmax(jnp.asarray(logits),
                                        jnp.asarray(mask), scale=0.25))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("ctx", [1, 128, 256, 4096, 100_000])
def test_scale_n_with_context_equal(ctx):
    assert tt.scale_n_with_context(ctx) == jt.scale_n_with_context(ctx)
