"""Serving of the port (``paddle_tpu.inference``): the paged KV cache and
the continuous-batching engine (slot-contiguous or paged, speculative
decoding, ``aot_warmup``'s CUDA graphs)."""

from paddle_tpu_torch.inference.kv_cache import (BlockAllocator, PagedCache,
                                                 PagedKVPool, PrefixCache,
                                                 SequenceBlocks,
                                                 paged_cache_attention)
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                QueueFullError,
                                                RequestStatus)

__all__ = ["BlockAllocator", "SequenceBlocks", "PrefixCache", "PagedKVPool",
           "PagedCache", "paged_cache_attention", "ContinuousBatchingEngine",
           "QueueFullError", "RequestStatus"]
