"""HAD core math: bit packing, Hamming scores, histogram top-N."""
