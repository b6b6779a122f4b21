"""Traffic generators, one module a loop kind (``closed``, ``open``),
each defining `make(traffic, *, seed, vocab, seconds)`: an object with
`setup_prompts()`, `start(t0)`, `due(now)`, `next_due()` and
`finished(req, now)`.

Every seed gets the same sizes and the same arrival gaps, in another
order: each size is drawn as a stratified set (the distribution's
quantiles at (i + 0.5) / n) and permuted by the seed, so the work of a
run does not move with its seed. Token ids are uniform over the
vocabulary.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Req:
    """One request a loop sends: `client` (its session or user), its
    prompt, the tokens to generate, and the host time it fell due."""
    client: int
    tokens: np.ndarray
    max_new: int
    due: float = 0.0


def rng(seed: int, *tags: int) -> np.random.Generator:
    """A generator of the run seeded `seed` for the stream `tags`."""
    return np.random.default_rng([int(seed) % 2 ** 64, *tags])


def quantiles(spec: dict, n: int) -> np.ndarray:
    """n stratified integer sizes of `spec` ({"tokens": [lo, hi],
    "dist": "uniform" | "loguniform"}): its quantiles at (i + 0.5) / n."""
    lo, hi = spec["tokens"]
    u = (np.arange(n) + 0.5) / n
    if spec.get("dist", "uniform") == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif spec.get("dist", "uniform") == "uniform":
        x = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown dist {spec['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def spread(spec: dict, n: int, gen: np.random.Generator) -> np.ndarray:
    """The stratified sizes of `spec`, in the order `gen` draws."""
    return gen.permutation(quantiles(spec, n))


def tokens(gen: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    return gen.integers(0, vocab, int(n), dtype=np.int64).astype(np.int32)
