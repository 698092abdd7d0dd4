"""Port parity: the bucketed sampler, the ragged dataset and the native
loaders.

``BucketedDistributedSampler``'s index streams must equal the JAX
sampler's bit for bit at equal seed, epoch, replicas and rank (over the
grid of ``tests/test_data.py``, with and without bucket overlap, epochs
0-2); its validation gates raise the JAX messages; and
``StokeDataLoader`` over a ``RaggedSequenceDataset`` (or an
``ArrayDataset``) with a sampler yields the JAX loader's batches exactly.
"""

import numpy as np
import pytest
import torch

from stoke_tpu import data as jd
from stoke_tpu_torch import Stoke, StokeOptimizer
from stoke_tpu_torch.data import (
    ArrayDataset,
    BucketedDistributedSampler,
    RaggedSequenceDataset,
    StokeDataLoader,
)

pytestmark = pytest.mark.torch_port


class Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


def both(n=1000, buckets=4, batch=8, replicas=2, rank=0, **kw):
    args = dict(buckets=buckets, batch_size=batch,
                sorted_idx=list(range(n)), num_replicas=replicas, rank=rank,
                **kw)
    return (jd.BucketedDistributedSampler(Sized(n), **args),
            BucketedDistributedSampler(Sized(n), **args))


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("replicas", [1, 2, 4])
@pytest.mark.parametrize("buckets", [2, 5])
@pytest.mark.parametrize("n", [1000, 1024, 1111])
def test_index_streams_equal_the_jax_sampler(n, buckets, replicas, drop_last,
                                             overlap):
    for rank in range(replicas):
        theirs, ours = both(n=n, buckets=buckets, replicas=replicas,
                            rank=rank, shuffle=True, seed=7,
                            drop_last=drop_last,
                            allow_bucket_overlap=overlap)
        assert len(ours) == len(theirs)
        for epoch in range(3):
            theirs.set_epoch(epoch)
            ours.set_epoch(epoch)
            try:
                want = list(iter(theirs))
            except AssertionError:
                # bucket overlap without drop_last, with buckets rounded
                # up: the JAX sampler's count check fails; so does ours
                assert overlap and not drop_last
                with pytest.raises(RuntimeError, match="sampler yielded"):
                    iter(ours)
                continue
            stream = list(iter(ours))
            assert stream == want, (rank, epoch)
            assert all(type(i) is int for i in stream)


def test_unshuffled_and_sorted_streams_equal():
    rng = np.random.default_rng(0)
    order = list(rng.permutation(1200))
    for shuffle in (False, True):
        kw = dict(buckets=3, batch_size=16, sorted_idx=order,
                  num_replicas=2, rank=1, shuffle=shuffle, seed=5)
        theirs = jd.BucketedDistributedSampler(Sized(1200), **kw)
        ours = BucketedDistributedSampler(Sized(1200), **kw)
        assert list(iter(ours)) == list(iter(theirs))


@pytest.mark.parametrize("kw", [
    dict(n=120, buckets=8, batch=8, replicas=4),
    dict(n=200, buckets=1, batch=100, replicas=2),
    dict(n=400, buckets=5, batch=8, replicas=1),
    dict(rank=5, replicas=2),
    dict(rank=-1, replicas=2),
])
def test_validation_gates_raise_the_jax_messages(kw):
    with pytest.raises(ValueError) as theirs:
        both(**kw)
    args = dict(n=1000, buckets=4, batch=8, replicas=2, rank=0)
    args.update(kw)
    n = args.pop("n")
    with pytest.raises(ValueError) as ours:
        BucketedDistributedSampler(
            Sized(n), buckets=args["buckets"], batch_size=args["batch"],
            sorted_idx=list(range(n)), num_replicas=args["replicas"],
            rank=args["rank"])
    assert str(ours.value) == str(theirs.value)


def test_replicas_and_rank_default_to_one_process():
    s = BucketedDistributedSampler(Sized(1000), buckets=2, batch_size=8,
                                   sorted_idx=range(1000))
    assert (s.num_replicas, s.rank) == (1, 0)


def ragged(n=600, seed=0, labels=True):
    rng = np.random.default_rng(seed)
    lens = np.clip((rng.pareto(2.5, size=n) + 1.0) * 8, 8, 200).astype(int)
    seqs = [rng.integers(1, 1000, size=L).astype(np.int32) for L in lens]
    return seqs, (np.asarray([len(s) % 2 for s in seqs]) if labels else None)


def test_ragged_dataset_matches_the_jax_one():
    seqs, labels = ragged()
    theirs = jd.RaggedSequenceDataset(seqs, labels, pad_multiple=32)
    ours = RaggedSequenceDataset(seqs, labels, pad_multiple=32)
    for name in ("lengths", "offsets", "ragged", "labels"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(theirs, name))
    assert ours.sorted_idx() == theirs.sorted_idx()
    assert len(ours) == len(theirs)
    s, y = ours[7]
    np.testing.assert_array_equal(s, seqs[7])
    assert y == labels[7]


@pytest.mark.parametrize("with_labels", [True, False])
@pytest.mark.parametrize("pad_multiple", [1, 32])
def test_loader_with_sampler_yields_the_jax_batches(with_labels,
                                                    pad_multiple):
    seqs, labels = ragged(labels=with_labels)
    kw = dict(buckets=3, batch_size=16, num_replicas=2, rank=1, seed=2)
    jds = jd.RaggedSequenceDataset(seqs, labels, pad_multiple=pad_multiple)
    pds = RaggedSequenceDataset(seqs, labels, pad_multiple=pad_multiple)
    js = jd.BucketedDistributedSampler(jds, sorted_idx=jds.sorted_idx(), **kw)
    ps = BucketedDistributedSampler(pds, sorted_idx=pds.sorted_idx(), **kw)
    theirs = jd.StokeDataLoader(jds, batch_size=16, place=False, sampler=js)
    ours = StokeDataLoader(pds, batch_size=16, device="cpu", sampler=ps)
    assert len(ours) == len(theirs)
    for epoch in (0, 1):
        theirs.set_epoch(epoch)
        ours.set_epoch(epoch)
        assert ps.epoch == epoch
        got = list(ours)
        want = list(theirs)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            if with_labels:
                (g, gy), (w, wy) = g, w
                assert gy.dtype == torch.from_numpy(np.asarray(wy)).dtype
                np.testing.assert_array_equal(gy.numpy(), wy)
            for key in ("input_ids", "attention_mask"):
                assert g[key].dtype == torch.int32
                np.testing.assert_array_equal(g[key].numpy(), w[key])
            L = g["input_ids"].shape[1]
            assert L % pad_multiple == 0
    assert ours.native_batches == 2 * len(ours)


def test_array_loader_is_native_and_matches_the_jax_one():
    x = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32)
    y = np.arange(100)
    theirs = jd.StokeDataLoader(jd.ArrayDataset(x, y), batch_size=16,
                                place=False, shuffle=True, drop_last=True,
                                seed=4)
    ours = StokeDataLoader(ArrayDataset(x, y), batch_size=16, device="cpu",
                           shuffle=True, drop_last=True, seed=4)
    for _ in range(2):  # the epoch seed advances alike
        for (gx, gy), (wx, wy) in zip(ours, theirs):
            np.testing.assert_array_equal(gx.numpy(), wx)
            np.testing.assert_array_equal(gy.numpy(), wy)
    assert ours.native_batches == 2 * len(ours) == 12


def _stoke():
    return Stoke(torch.nn.Linear(2, 2), StokeOptimizer(torch.optim.SGD,
                                                      lr=0.1),
                 lambda o, y: (o - y).pow(2).mean(),
                 batch_size_per_device=4, device="cpu")


def test_facade_dataloader_takes_a_sampler_and_refuses_none_across_processes(
        monkeypatch):
    seqs, labels = ragged()
    ds = RaggedSequenceDataset(seqs, labels)
    s = _stoke()
    sampler = BucketedDistributedSampler(ds, buckets=2, batch_size=4,
                                         sorted_idx=ds.sorted_idx())
    loader = s.DataLoader(ds, sampler=sampler)
    assert loader.sampler is sampler and loader.batch_size == 4
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(ValueError) as ours:
        s.DataLoader(ds)
    assert str(ours.value) == (
        "Stoke -- multi-process runs require a distributed sampler "
        "(see BucketedDistributedSampler / DistributedSampler) — "
        "reference stoke.py:822-826")
    s.DataLoader(ds, sampler=sampler)  # with one it builds
