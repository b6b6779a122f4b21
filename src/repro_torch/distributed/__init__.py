"""Distribution (torch twin of ``repro.distributed``): gradient compression
and its collective (`compression`), the sharding rules (`sharding`) and
the collectives of tensor-parallel serving (`collectives`).

Not ported: ``repro.distributed.constraints``. It pins activations with
GSPMD's ``with_sharding_constraint`` so that XLA's sharding propagation
stays anchored through scans and reshapes; eager PyTorch has no
propagation to anchor, and every collective here is an explicit call.
"""
from repro_torch.distributed.compression import (CompressionConfig,
                                                 compress_grads, init_error,
                                                 psum_compressed)
