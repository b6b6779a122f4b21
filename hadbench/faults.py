"""Faults a served cell can have, planted under the timed path: the
check must find each (``tests/test_hadbench_run.py`` on the CPU;
``calibrate.py --fault`` on the card, at the cell's own size)."""
from __future__ import annotations

import contextlib

import numpy as np


def _altered_token(orig):
    def sample(logits, sp, rng):
        return (orig(logits, sp, rng) + 1) % logits.shape[-1]
    return sample


def _half_batch_left_out(orig):
    def decode_step(self, tokens, pos, active, *a, **kw):
        active = np.array(active, copy=True)
        active[len(active) // 2:] = False
        return orig(self, tokens, pos, active, *a, **kw)
    return decode_step


def _targets() -> dict:
    from repro_torch.models import attention_block as AB
    from repro_torch.serve import runner as R
    return {
        # a token altered where it is produced (host sampling)
        "token": (R, "_sample_token", _altered_token),
        # a step that returns its state unchanged: no K/V reaches the pool
        "state": (AB, "_update_binary_cache_paged",
                  lambda orig: lambda *a, **kw: None),
        # half of the batch left out of the decode step
        "half_batch": (R.ModelRunner, "decode_step", _half_batch_left_out),
    }


NAMES = ("half_batch", "state", "token")


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` in place, restored after."""
    mod, attr, make = _targets()[name]
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)
