"""Data layer of the port: ``ArrayDataset`` and ``StokeDataLoader``.

Counterpart of ``stoke_tpu/data.py:43-119`` (``ArrayDataset`` and the
order of its native loader) and ``:571-757`` (``StokeDataLoader``, the
prefetch window). An ``ArrayDataset`` is batched in the JAX loader's order
at equal ``seed``: ``np.random.default_rng(seed)`` shuffles the indices,
the seed goes up by one each epoch, and ``drop_last`` drops a short final
batch. Rows are gathered with numpy (the JAX package's native batcher is
ROADMAP Queue 1 item 4). Any other dataset goes through
``torch.utils.data.DataLoader``.

Batches are placed on the loader's device ``prefetch`` deep: on the card
through pinned host memory with ``non_blocking`` copies, so the copy of
the next batches overlaps the step on the current one.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np
import torch
from torch.utils._pytree import tree_map

from stoke_tpu_torch.serving.engine import resolve_device


class ArrayDataset:
    """Dataset backed by whole numpy arrays (first axis = samples).

    Args:
        *arrays: equal-length numpy arrays (e.g. token ids, labels).
    """

    def __init__(self, *arrays: np.ndarray):
        if not arrays:
            raise ValueError("ArrayDataset needs at least one array")
        self.arrays = tuple(np.ascontiguousarray(a) for a in arrays)
        n = len(self.arrays[0])
        if any(len(a) != n for a in self.arrays):
            raise ValueError("all arrays must share the sample axis length")

    def __len__(self):
        return len(self.arrays[0])

    def __getitem__(self, i):
        row = tuple(a[i] for a in self.arrays)
        return row if len(row) > 1 else row[0]


class _ArrayLoader:
    """Batches of an ``ArrayDataset`` in the JAX native loader's order."""

    def __init__(self, dataset: ArrayDataset, batch_size: int,
                 shuffle: bool = False, sampler=None, drop_last: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = sampler
        self.drop_last = drop_last
        self._epoch_seed = seed

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else math.ceil(n / self.batch_size))

    def __iter__(self):
        if self.sampler is not None:
            order = np.fromiter(iter(self.sampler), np.int64)
        else:
            order = np.arange(len(self.dataset), dtype=np.int64)
            if self.shuffle:
                rng = np.random.default_rng(self._epoch_seed)
                self._epoch_seed += 1
                rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            batch = tuple(np.take(a, idx, axis=0) for a in self.dataset.arrays)
            yield batch if len(batch) > 1 else batch[0]


def place(batch, device: torch.device):
    """``batch`` (numpy arrays or tensors, nested in tuples, lists or
    dicts) as tensors on ``device``; host tensors bound for the card are
    pinned and copied ``non_blocking``."""

    def leaf(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not isinstance(x, torch.Tensor) or x.device == device:
            return x
        if device.type == "cuda" and x.device.type == "cpu":
            return x.pin_memory().to(device, non_blocking=True)
        return x.to(device)

    return tree_map(leaf, batch)


class StokeDataLoader:
    """Loader yielding batches already on the device.

    Built by ``Stoke.DataLoader``, which passes the run's
    ``batch_size_per_device`` and device.

    Args:
        dataset: an :class:`ArrayDataset` (batched here, in the JAX
            loader's order) or any dataset ``torch.utils.data.DataLoader``
            takes.
        batch_size: rows per batch.
        device: where batches land; None or "cuda" is the card (and raises
            when there is none), "cpu" the CPU.
        prefetch: batches kept in flight on the device (default 2).
        **kwargs: ``shuffle``, ``sampler``, ``drop_last`` and ``seed`` for
            an ``ArrayDataset``; for another dataset, the arguments of
            ``torch.utils.data.DataLoader``.
    """

    def __init__(self, dataset, batch_size: int, device=None,
                 prefetch: int = 2, **kwargs):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self._prefetch = max(int(prefetch), 1)
        if isinstance(dataset, ArrayDataset):
            self._loader = _ArrayLoader(dataset, batch_size, **kwargs)
        else:
            self._loader = torch.utils.data.DataLoader(
                dataset, batch_size=batch_size, **kwargs)

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        queue: deque = deque()
        for batch in self._loader:
            queue.append(place(batch, self.device))
            if len(queue) > self._prefetch:
                yield queue.popleft()
        while queue:
            yield queue.popleft()

