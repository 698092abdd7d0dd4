"""Data layer of the port: datasets, the native loaders, the bucketed
sampler and ``StokeDataLoader``.

Counterpart of ``stoke_tpu/data.py``: ``ArrayDataset`` and
``RaggedSequenceDataset`` (``:43-161``) with their native loaders
(``:72-176``), ``BucketedDistributedSampler`` (``:799-1021``) and
``StokeDataLoader`` (``:571-757``). A dataset of either class is batched in
the JAX loader's order at equal ``seed`` (``np.random.default_rng(seed)``
shuffles the indices, the seed goes up by one each epoch, ``drop_last``
drops a short final batch) or in a sampler's order, and each batch is
assembled by :class:`~stoke_tpu_torch.native.NativeBatcher`: one GIL-free
row gather per array, or one gather + pad + mask call for ragged token
sequences. Any other dataset goes through ``torch.utils.data.DataLoader``.

The sampler's index streams equal the JAX sampler's bit for bit at equal
seed, epoch, replicas and rank. Its replicas and rank default from
``torch.distributed`` (1 and 0 without a process group).

Batches are placed on the loader's device ``prefetch`` deep: on the card
through pinned host memory with ``non_blocking`` copies, so the copy of
the next batches overlaps the step on the current one.

With a ``TelemetryConfig`` (``Stoke.DataLoader`` hands the loader the
run's pipeline) every fetch from the host loader is a ``stoke/io`` span on
the ``data`` track and its wait lands in ``data/loader_wait_s``; a wait
once the first ``prefetch`` batches are in flight also lands in
``data/starvation_s`` (the JAX loader's rule), and the real tokens
of a ragged batch (its attention mask's sum) in ``data/tokens_total``.

The JAX package's torch-free fallback loader has no counterpart (the port
always has torch), and its input rebalancer waits for ROADMAP Queue 1 item
10d's fleet monitor.
"""

from __future__ import annotations

import itertools
import math
import time
from collections import deque
from typing import Any, Iterator, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_map

from stoke_tpu_torch.native import NativeBatcher
from stoke_tpu_torch.serving.engine import resolve_device
from stoke_tpu_torch.telemetry.tracing import trace_span


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


class RaggedSequenceDataset:
    """Variable-length token sequences in one contiguous ragged buffer.

    A ``StokeDataLoader`` over it gathers the sampled sequences, pads them
    to the batch's longest (rounded up to ``pad_multiple``) and builds the
    attention mask in one native call, yielding ``({"input_ids",
    "attention_mask"}, labels)`` (int32 ``[B, L]`` each). Pairs with
    :class:`BucketedDistributedSampler` (:meth:`sorted_idx`).

    Args:
        sequences: 1-D int token arrays.
        labels: optional per-sequence labels.
        pad_multiple: the padded length's multiple (bounds the shapes the
            model sees).
    """

    def __init__(self, sequences, labels=None, pad_multiple: int = 32):
        self.lengths = np.asarray([len(s) for s in sequences], np.int32)
        self.offsets = np.concatenate(
            [[0], np.cumsum(self.lengths[:-1], dtype=np.int64)]
        ).astype(np.int64)
        self.ragged = (
            np.concatenate([np.asarray(s, np.int32) for s in sequences])
            if len(sequences) else np.zeros((0,), np.int32)
        )
        self.labels = None if labels is None else np.asarray(labels)
        self.pad_multiple = int(pad_multiple)

    def __len__(self):
        return len(self.lengths)

    def __getitem__(self, i):
        s = self.ragged[self.offsets[i]:self.offsets[i] + self.lengths[i]]
        return (s, self.labels[i]) if self.labels is not None else s

    def sorted_idx(self):
        """Indices sorted by length, for ``BucketedDistributedSampler``."""
        return list(np.argsort(self.lengths, kind="stable"))


class _NativeLoader:
    """Batches of an ``ArrayDataset`` or ``RaggedSequenceDataset`` in the
    JAX native loader's order, each assembled by one native call;
    ``native_batches`` counts the batches the C++ batcher assembled."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 sampler=None, drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = sampler
        self.drop_last = drop_last
        self._epoch_seed = seed
        self.batcher = NativeBatcher()
        self.native_batches = 0

    def __len__(self):
        n = (len(self.sampler) if self.sampler is not None
             else len(self.dataset))
        return (n // self.batch_size if self.drop_last
                else math.ceil(n / self.batch_size))

    def _assemble(self, idx: np.ndarray):
        ds, b = self.dataset, self.batcher
        if isinstance(ds, ArrayDataset):
            batch = tuple(b.gather_rows(a, idx) for a in ds.arrays)
            batch = batch if len(batch) > 1 else batch[0]
        else:
            ids, mask = b.gather_pad(ds.ragged, ds.offsets, ds.lengths, idx,
                                     pad_multiple=ds.pad_multiple)
            batch = {"input_ids": ids, "attention_mask": mask}
            if ds.labels is not None:
                batch = (batch, ds.labels[idx])
        self.native_batches += b.available
        return batch

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
            yield self._assemble(idx)


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
        dataset: an :class:`ArrayDataset` or :class:`RaggedSequenceDataset`
            (batched here by the native batcher, in the JAX loader's
            order) or any dataset ``torch.utils.data.DataLoader`` takes.
        batch_size: rows per batch.
        device: where batches land; None or "cuda" is the card (and raises
            when there is none), "cpu" the CPU.
        prefetch: batches kept in flight on the device (default 2).
        telemetry: the run's :class:`~stoke_tpu_torch.telemetry.Telemetry`
            (loader wait, starvation and token counters), or None.
        **kwargs: ``shuffle``, ``sampler`` (e.g. a
            :class:`BucketedDistributedSampler`), ``drop_last`` and ``seed``
            for the two native datasets; for another dataset, the
            arguments of ``torch.utils.data.DataLoader``.
    """

    def __init__(self, dataset, batch_size: int, device=None,
                 prefetch: int = 2, telemetry=None, **kwargs):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self._prefetch = max(int(prefetch), 1)
        self._telemetry = telemetry
        self._ragged = isinstance(dataset, RaggedSequenceDataset)
        if isinstance(dataset, (ArrayDataset, RaggedSequenceDataset)):
            self._loader = _NativeLoader(dataset, batch_size, **kwargs)
        else:
            self._loader = torch.utils.data.DataLoader(
                dataset, batch_size=batch_size, **kwargs)

    def __len__(self):
        return len(self._loader)

    @property
    def sampler(self):
        return getattr(self._loader, "sampler", None)

    @property
    def native_batches(self) -> int:
        """Batches the C++ batcher has assembled (0 for a dataset that
        ``torch.utils.data.DataLoader`` batches)."""
        return getattr(self._loader, "native_batches", 0)

    def set_epoch(self, epoch: int) -> None:
        """Forward to the sampler when it has ``set_epoch``."""
        s = self.sampler
        if s is not None and hasattr(s, "set_epoch"):
            s.set_epoch(epoch)

    def __iter__(self):
        wait = starve = tokens = None
        if self._telemetry is not None:
            reg = self._telemetry.registry
            wait = reg.counter(
                "data/loader_wait_s",
                help="host seconds blocked on the host-side loader",
            )
            starve = reg.counter(
                "data/starvation_s",
                help="post-warmup loader wait (device-starving portion)",
            )
            if self._ragged:
                tokens = reg.counter("data/tokens_total")
        queue: deque = deque()
        it = iter(self._loader)
        while True:
            # the first ``prefetch`` fetches fill the pipeline; a wait after
            # them starves the device (the JAX loader's rule)
            warm = len(queue) >= self._prefetch
            with trace_span("stoke/io", track="data"):
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                finally:
                    if wait is not None:
                        dt = time.perf_counter() - t0
                        wait.inc(dt)
                        if warm:
                            starve.inc(dt)
            if tokens is not None:
                tokens.inc(int(np.asarray(batch[0]["attention_mask"]).sum()))
            queue.append(place(batch, self.device))
            if len(queue) > self._prefetch:
                yield queue.popleft()
        while queue:
            yield queue.popleft()


class BucketedDistributedSampler:
    """A distributed sampler that draws each batch from one bucket of
    similar-length samples (``stoke_tpu/data.py:799``; its index streams
    bit for bit at equal seed, epoch, replicas and rank).

    ``sorted_idx`` lists the dataset's indices sorted by the bucketing key
    (e.g. a sequence's length). It is split into ``buckets`` contiguous
    buckets; every epoch each bucket is shuffled (seeded by ``seed +
    epoch``), carved into slices of ``batch_size x num_replicas``, and each
    replica takes a strided (``rank::num_replicas``) sub-batch of every
    slice. Short final slices borrow stride-aligned indices from the
    bucket's head; with ``drop_last`` and ``allow_bucket_overlap`` the
    dropped residuals form extra mixed batches; then the batch order is
    shuffled across buckets.

    Args:
        dataset: sized dataset (only ``len`` is used).
        buckets: number of contiguous buckets.
        batch_size: per-replica batch size.
        sorted_idx: dataset indices sorted by the bucketing key.
        num_replicas / rank: the loading processes and this one (default
            ``torch.distributed``'s world size and rank, or 1 and 0).
        allow_bucket_overlap / shuffle / seed / drop_last / info_rank: as
            in the JAX package.
        backend: kept for the signature; unused.
    """

    def __init__(self, dataset, buckets: int, batch_size: int,
                 sorted_idx: Sequence[int], allow_bucket_overlap: bool = False,
                 num_replicas: Optional[int] = None,
                 rank: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False, info_rank: int = 0,
                 backend: Any = None):
        if num_replicas is None or rank is None:
            dist = torch.distributed
            up = dist.is_available() and dist.is_initialized()
            if num_replicas is None:
                num_replicas = dist.get_world_size() if up else 1
            if rank is None:
                rank = dist.get_rank() if up else 0
        if not (0 <= rank < num_replicas):
            raise ValueError(
                f"Stoke -- sampler rank {rank} out of range for "
                f"{num_replicas} replicas"
            )
        self.num_replicas = int(num_replicas)
        self.rank = int(rank)
        self.epoch = 0
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.buckets = int(buckets)
        self.batch_size = int(batch_size)
        self.sorted_idx = list(sorted_idx)
        self.allow_bucket_overlap = allow_bucket_overlap

        self.slice_size = self.batch_size * self.num_replicas
        n = len(dataset)
        self.num_samples_per_bucket = self._split_size(n, self.buckets,
                                                       drop_last)
        self.num_slices_per_bucket = self._split_size(
            self.num_samples_per_bucket, self.slice_size, drop_last)
        if self.num_samples_per_bucket < self.slice_size:
            raise ValueError(
                f"Stoke -- samples per bucket ({self.num_samples_per_bucket}) "
                f"is smaller than one slice (batch × replicas = "
                f"{self.slice_size})"
            )
        if self.num_slices_per_bucket < 2:
            raise ValueError(
                f"Stoke -- only {self.num_slices_per_bucket} slice(s) per "
                f"bucket; need >= 2 (use fewer buckets or a smaller batch)"
            )
        if self.num_samples_per_bucket < 100:
            raise ValueError(
                f"Stoke -- {self.num_samples_per_bucket} samples per bucket "
                f"< 100 would drop excessive data (use fewer buckets)"
            )
        self.bucket_idx = [list(chunk) for chunk in np.array_split(
            np.asarray(self.sorted_idx), self.buckets)]
        self.rounded_num_samples_per_bucket = (
            self.num_slices_per_bucket * self.slice_size)
        self.rounded_num_samples_per_replica = (
            self.num_slices_per_bucket * self.batch_size * self.buckets)
        if self.allow_bucket_overlap:
            residual = n - self.rounded_num_samples_per_bucket * self.buckets
            self.rounded_num_samples_per_replica += (
                residual // self.slice_size) * self.batch_size
        if self.rank == info_rank:
            print(
                f"Stoke -- BucketedDistributedSampler -- samples/bucket: "
                f"{self.rounded_num_samples_per_bucket}, samples/replica: "
                f"{self.rounded_num_samples_per_replica}"
            )

    @staticmethod
    def _split_size(total: int, parts: int, drop_last: bool) -> int:
        return total // parts if drop_last else math.ceil(total / parts)

    def _pad_bucket(self, bucket: List[int]) -> List[int]:
        """A short bucket extended to ``num_slices x slice_size`` entries:
        its final slice borrows stride-aligned indices from the bucket's
        head, interleaved so each replica's sub-batch reaches
        ``batch_size``."""
        full = (self.num_slices_per_bucket - 1) * self.slice_size
        head, short = bucket[:full], bucket[full:]
        per_replica = [len(short[r::self.num_replicas])
                       for r in range(self.num_replicas)]
        need = [self.batch_size - c for c in per_replica]
        donors = [bucket[r:self.num_replicas * need[r]:self.num_replicas]
                  for r in range(self.num_replicas)]
        # replicas needing unequal amounts: the neediest leads, so the
        # interleave stays stride-consistent
        if len(set(need)) > 1:
            lead = need.index(max(need))
            donors = donors[lead:] + donors[:lead]
        pad = [v for v in itertools.chain(*itertools.zip_longest(*donors))
               if v is not None]
        return head + short + pad

    def _epoch_slices(self) -> List[List[int]]:
        """This epoch's slices in yielded order (the JAX sampler's rng
        calls in its order: the per-bucket shuffles, then the batch
        order)."""
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.shuffle:
            buckets = [list(np.asarray(b)[rng.permutation(len(b))])
                       for b in self.bucket_idx]
        else:
            buckets = [list(b) for b in self.bucket_idx]
        for i, b in enumerate(buckets):
            if len(b) < self.rounded_num_samples_per_bucket:
                buckets[i] = self._pad_bucket(b)
        slices: List[List[int]] = []
        for b in buckets:
            for s in range(self.num_slices_per_bucket):
                slices.append(b[s * self.slice_size:(s + 1) * self.slice_size])
        if self.drop_last and self.allow_bucket_overlap:
            residual = list(itertools.chain(
                *[b[self.rounded_num_samples_per_bucket:] for b in buckets]))
            for s in range(len(residual) // self.slice_size):
                slices.append(
                    residual[s * self.slice_size:(s + 1) * self.slice_size])
        if self.shuffle:
            order = rng.permutation(len(slices))
            slices = [slices[i] for i in order]
        return slices

    def __iter__(self) -> Iterator[int]:
        batches = [sl[self.rank:self.slice_size:self.num_replicas]
                   for sl in self._epoch_slices()]
        flat = [int(i) for i in itertools.chain(*batches)]
        if len(flat) != self.rounded_num_samples_per_replica:
            raise RuntimeError(
                f"Stoke -- sampler yielded {len(flat)} indices, expected "
                f"{self.rounded_num_samples_per_replica}")
        return iter(flat)

    def __len__(self) -> int:
        return self.rounded_num_samples_per_replica

    def set_epoch(self, epoch: int) -> None:
        """Reseed the next epoch's shuffles (every replica alike)."""
        self.epoch = epoch
