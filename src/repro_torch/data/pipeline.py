"""Input pipeline (torch twin of ``repro.data.pipeline``): host numpy
batches moved to the device with a short prefetch queue, so the host
builds batch i+1 while the device runs step i."""
from __future__ import annotations

import collections
import itertools
from typing import Iterator

import numpy as np
import torch


def to_device(batch: dict, device) -> dict:
    """A dict of numpy arrays -> the same dict of tensors on `device`
    (non-blocking from pinned memory on the card)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.pin_memory().to(device, non_blocking=True)
                  if device.type == "cuda" else t.to(device))
    return out


def shard_batches(it: Iterator[dict], device="cuda", *,
                  prefetch: int = 2) -> Iterator[dict]:
    """Wrap a host iterator: move each batch to `device`, `prefetch`
    batches ahead (JAX's device_put with one device's sharding)."""
    q: collections.deque = collections.deque()
    for batch in it:
        q.append(to_device(batch, device))
        if len(q) > prefetch:
            yield q.popleft()
    while q:
        yield q.popleft()


def take(it: Iterator, n: int) -> list:
    return list(itertools.islice(it, n))


def accuracy(logits, labels) -> float:
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().float().cpu().numpy()
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    return float((np.asarray(logits).argmax(-1) == np.asarray(labels)).mean())
