"""Gradient compression (torch twin of ``repro.distributed.compression``)."""
from repro_torch.distributed.compression import (CompressionConfig,
                                                 compress_grads, init_error)
