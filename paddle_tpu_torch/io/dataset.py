"""Datasets and samplers (``paddle_tpu/io/dataset.py``): host-side
index lists, the JAX package's classes with two differences.

* A ``RandomSampler`` (and a ``WeightedRandomSampler``) without a
  `generator` draws a fresh seed for a ``numpy`` generator from the
  port's CPU generator (``core/state.py``) on every pass: reproducible
  under ``paddle_tpu_torch.seed``, different each epoch, but not JAX's
  order (JAX derives it from its threefry stream; JAX's weighted sampler
  takes OS entropy).  With an explicit ``numpy`` generator both packages
  give the same indices.
* ``DistributedBatchSampler`` takes `num_replicas` and `rank` when given;
  otherwise it reads ``torch.distributed`` when a process group is
  initialised, else 1 replica of rank 0 (the port has no
  ``distributed/env.py`` yet: ROADMAP.md, queue 1, item 8)."""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core import state as _state

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ConcatDataset",
           "ChainDataset", "Subset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler"]


def _host_seed() -> int:
    """A seed drawn from the port's CPU generator: deterministic under
    ``paddle_tpu_torch.seed``, different on every call."""
    g = _state.generator("cpu")
    return int(torch.randint(0, np.iinfo(np.int32).max, (), generator=g))


def _world():
    """``(world size, rank)`` of the initialised process group, else
    ``(1, 0)``."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        lens = {len(t) for t in tensors}
        if len(lens) != 1:
            raise ValueError("tensors must share dim 0")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ConcatDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds - 1] if ds else 0
        return self.datasets[ds][idx - prev]

    def __len__(self):
        return self.cumulative_sizes[-1]


class ChainDataset(IterableDataset):
    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence[int], generator=None):
    if sum(lengths) != len(dataset):
        raise ValueError("lengths must sum to dataset size")
    rng = generator or np.random.default_rng()
    perm = rng.permutation(len(dataset))
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = self.generator
        if rng is None:
            # a seeded run shuffles reproducibly, differently each pass
            rng = np.random.default_rng(_host_seed())
        if self.replacement:
            return iter(rng.integers(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.default_rng(_host_seed()).choice(
            len(p), self.num_samples, replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__(dataset)
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle \
                else SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the index space across ranks (reference
    io/dataloader/batch_sampler.py DistributedBatchSampler).  Under
    single-controller SPMD each *host* loads 1/num_replicas of the global
    batch; with one host this degenerates to BatchSampler."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        world, me = _world()
        self.num_replicas = num_replicas if num_replicas is not None \
            else world
        self.rank = rank if rank is not None else me
        self.shuffle = shuffle
        self.epoch = 0
        super().__init__(dataset, None, False, batch_size, drop_last)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.data_source)
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        # pad so every rank gets the same count (reference behaviour)
        total = ((n + self.num_replicas - 1) // self.num_replicas
                 * self.num_replicas)
        indices += indices[:total - n]
        local = indices[self.rank::self.num_replicas]
        batch = []
        for idx in local:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = (len(self.data_source) + self.num_replicas - 1) \
            // self.num_replicas
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size
