"""Synthetic datasets for training, distillation, and the paper's benchmarks
(a copy of ``repro.data.synthetic``: numpy only, the same seed gives the
same batches).

The container has no downloads; every paper experiment maps to a synthetic
proxy with the same *structure*:

* `lm_stream`          — token LM batches (markov-ish structure so models
                         can actually learn; used by pretrain paths).
* `classification_task`— GLUE-proxy: sequence classification where the
                         label depends on token co-occurrence (table 1).
* `patch_task`         — ImageNet/DeiT-proxy: "patch embeddings" whose class
                         is a linear+nonlinear function of a few patches
                         (table 2).
* `retrieval_qa_task`  — QuALITY-proxy (fig. 5): a key token placed at a
                         random position must be retrieved to answer; tests
                         exactly the long-context attention behaviour the
                         paper evaluates.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class TaskBatch:
    inputs: dict          # model input dict (tokens / frames / ...)
    labels: np.ndarray    # classification target [B] or LM labels [B, S]


def lm_stream(*, vocab: int, batch: int, seq: int, seed: int = 0
              ) -> Iterator[dict]:
    """Order-2 markov token stream (learnable structure, no files)."""
    rng = np.random.default_rng(seed)
    # sparse transition structure
    nxt = rng.integers(0, vocab, size=(vocab, 4))
    while True:
        toks = np.empty((batch, seq + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, vocab, batch)
        choice = rng.integers(0, 4, size=(batch, seq))
        noise = rng.random((batch, seq)) < 0.1
        rand_tok = rng.integers(0, vocab, size=(batch, seq))
        for t in range(seq):
            nt = nxt[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nt)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def classification_task(*, vocab: int, n_classes: int, batch: int, seq: int,
                        seed: int = 0) -> Iterator[TaskBatch]:
    """GLUE-proxy: order-sensitive indicator classification.

    Each sample contains indicator tokens of TWO classes (reserved ids,
    never colliding with noise); the label is the class whose indicator
    appears EARLIEST. Mere presence pooling (uniform attention over salient
    tokens) cannot solve it — the model needs sharply *graded* attention to
    resolve which indicator comes first. This is what separates HAD (exact
    graded weights over the top-N) from attention-matrix binarization
    (uniform weights over kept entries), mirroring the paper's table-1 gap.
    """
    rng = np.random.default_rng(seed)
    noise_hi = vocab - n_classes           # reserve top ids as indicators
    assert noise_hi > 2
    ind = noise_hi + np.arange(n_classes)
    while True:
        labels = np.empty(batch, dtype=np.int64)
        toks = rng.integers(0, noise_hi, size=(batch, seq)).astype(np.int32)
        for i in range(batch):
            c_a = rng.integers(0, n_classes)
            c_b = (c_a + 1 + rng.integers(0, n_classes - 1)) % n_classes
            pos = 1 + rng.choice(seq - 1, size=2, replace=False)
            toks[i, pos[0]] = ind[c_a]
            toks[i, pos[1]] = ind[c_b]
            labels[i] = c_a if pos[0] < pos[1] else c_b
        yield TaskBatch({"tokens": toks}, labels.astype(np.int32))


def patch_task(*, dim: int, n_patches: int, n_classes: int, batch: int,
               seed: int = 0, n_signal: int = 5, noise: float = 0.2,
               amp: float = 2.0, proto_seed: int = 7) -> Iterator[TaskBatch]:
    """DeiT-proxy: frame/patch embeddings; class = the prototype planted in
    `n_signal` of the patches (rest are unit noise).

    Prototypes come from `proto_seed` (task identity) independently of
    `seed` (sampling stream) so train/eval streams share the same task."""
    rng = np.random.default_rng(seed)
    protos = amp * np.random.default_rng(proto_seed).normal(
        size=(n_classes, dim)).astype(np.float32)
    while True:
        labels = rng.integers(0, n_classes, batch)
        frames = rng.normal(size=(batch, n_patches, dim)).astype(np.float32)
        for i, c in enumerate(labels):
            pos = rng.choice(n_patches, size=n_signal, replace=False)
            frames[i, pos] = protos[c] + noise * rng.normal(
                size=(n_signal, dim))
        yield TaskBatch({"frames": frames.astype(np.float32)},
                        labels.astype(np.int32))


def retrieval_qa_task(*, vocab: int, batch: int, seq: int, n_classes: int = 8,
                      seed: int = 0) -> Iterator[TaskBatch]:
    """QuALITY-proxy: a 'question' token at the end refers to a key token
    hidden at a random position; the answer class is derived from the key.

    Accuracy requires long-range retrieval — the capability the paper's
    fig. 5 measures across context lengths."""
    rng = np.random.default_rng(seed)
    key_tokens = np.arange(n_classes) + vocab - n_classes  # reserved ids
    marker = vocab - n_classes - 1
    while True:
        labels = rng.integers(0, n_classes, batch)
        toks = rng.integers(0, marker, size=(batch, seq)).astype(np.int32)
        for i, c in enumerate(labels):
            pos = rng.integers(0, seq - 2)
            toks[i, pos] = marker          # cue
            toks[i, pos + 1] = key_tokens[c]
            toks[i, -1] = marker           # question: find the cue'd key
        yield TaskBatch({"tokens": toks}, labels.astype(np.int32))
