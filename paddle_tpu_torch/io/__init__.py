"""Data loading of the port (``paddle_tpu.io``): datasets and samplers,
the ``DataLoader``, device prefetch; the native token feed is
``io.token_dataset.TokenFileDataset``."""

from paddle_tpu_torch.io.dataset import (  # noqa: F401
    BatchSampler, ChainDataset, ConcatDataset, Dataset,
    DistributedBatchSampler, IterableDataset, RandomSampler, Sampler,
    SequenceSampler, Subset, TensorDataset, WeightedRandomSampler,
    random_split)
from paddle_tpu_torch.io.dataloader import (  # noqa: F401
    DataLoader, default_collate_fn, get_worker_info)
from paddle_tpu_torch.io.device_prefetch import (  # noqa: F401
    DevicePrefetchIterator, device_prefetch)

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ConcatDataset",
    "ChainDataset", "Subset", "random_split", "Sampler", "SequenceSampler",
    "RandomSampler", "WeightedRandomSampler", "BatchSampler",
    "DistributedBatchSampler", "DataLoader", "default_collate_fn",
    "get_worker_info", "DevicePrefetchIterator", "device_prefetch",
]
