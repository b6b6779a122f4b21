"""Bit packing and Hamming-distance scores (torch twin of
``repro.core.hamming``).

For q, k in {-1, +1}^d with bit encodings b(q), b(k) (bit 1 <=> +1),

    dot(q, k) = d - 2 * popcount(b(q) XOR b(k))

Packed words are held as ``int32`` with the same bit pattern as the JAX
package's ``uint32`` words: torch has no popcount op and no ``>>`` on
``uint32`` CPU tensors, so bit arithmetic widens to ``int64`` and masks to
the low 32 bits. Compare words across frameworks with
``.numpy().view(np.uint32)``.
"""
from __future__ import annotations

import torch

WORD_BITS = 32
_LOW32 = 0xFFFFFFFF


def packed_words(d: int) -> int:
    """Number of 32-bit words needed for d bits."""
    return (d + WORD_BITS - 1) // WORD_BITS


def _to_int32(words64: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of non-negative int64 values as int32 (two's complement)."""
    return torch.where(words64 >= 2 ** 31, words64 - 2 ** 32,
                       words64).to(torch.int32)


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Pack the sign pattern of x along the last axis into 32-bit words.

    x: [..., d] real-valued (x >= 0 maps to bit 1). Element 32*w + j lands
    in bit j of word w. Returns [..., ceil(d/32)] int32; tail bits past d
    are 0, so XOR-based scores ignore them.
    """
    d = x.shape[-1]
    w = packed_words(d)
    bits = (x >= 0).to(torch.int64)
    pad = w * WORD_BITS - d
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(*x.shape[:-1], w, WORD_BITS)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=x.device)
    return _to_int32((bits << shifts).sum(-1))


def unpack_bits(packed: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of pack_bits: [..., w] int32 -> [..., d] float32 in {-1, +1}."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=packed.device)
    words = packed.to(torch.int64) & _LOW32
    bits = (words[..., None] >> shifts) & 1
    flat = bits.reshape(*packed.shape[:-1], packed.shape[-1] * WORD_BITS)
    return torch.where(flat[..., :d] == 1, 1.0, -1.0).to(torch.float32)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits per 32-bit word (SWAR on the int64-widened low 32 bits).

    words: int32 (or int64 holding 32-bit values) -> same shape int32.
    """
    x = words.to(torch.int64) & _LOW32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & _LOW32) >> 24).to(torch.int32)


def binary_scores(q_bits: torch.Tensor, k_bits: torch.Tensor,
                  d: int) -> torch.Tensor:
    """Integer dot products of +-1 vectors from packed bits.

    q_bits: [..., m, w]; k_bits: [..., n, w] -> [..., m, n] int32 with
    scores[i, j] = d - 2 * ham(q_i, k_j). Zero tail bits in both operands
    contribute nothing to the XOR, so the identity holds with the true d.
    """
    x = torch.bitwise_xor(q_bits[..., :, None, :], k_bits[..., None, :, :])
    ham = popcount(x).sum(-1, dtype=torch.int32)
    return (d - 2 * ham).to(torch.int32)
