"""Optimizers and schedules (torch twin of ``repro.optim``)."""
from repro_torch.optim import schedules
from repro_torch.optim.adam import (AdamWConfig, clip_by_global_norm,
                                    default_mask, global_norm, init, update)
