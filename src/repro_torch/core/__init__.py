"""HAD core math: bit packing, Hamming scores, histogram top-N, and the
full-precision baseline attention."""
