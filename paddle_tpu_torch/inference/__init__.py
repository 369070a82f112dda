"""Serving of the port (``paddle_tpu.inference``): the paged KV cache and
its handoff wire format, the continuous-batching engine (slot-contiguous
or paged, speculative decoding, ``aot_warmup``'s CUDA graphs, fleet
roles, the prefill/decode handoff, parkable sessions), the KV tier
manager and the serving fleet router."""

from paddle_tpu_torch.inference.kv_cache import (BlockAllocator, PagedCache,
                                                 PagedKVPool, PrefixCache,
                                                 SequenceBlocks,
                                                 deserialize_handoff,
                                                 fetch_handoff,
                                                 paged_cache_attention,
                                                 publish_handoff,
                                                 serialize_handoff)
from paddle_tpu_torch.inference.kv_tier import (KVTierManager,
                                                prefix_block_key,
                                                session_key)
from paddle_tpu_torch.inference.router import (ReplicaWorker,
                                               ServingRouter,
                                               SloAutoscaleRule,
                                               SloAutoscaler,
                                               fetch_result,
                                               submit_request)
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                QueueFullError,
                                                RequestStatus)

__all__ = ["BlockAllocator", "SequenceBlocks", "PrefixCache", "PagedKVPool",
           "PagedCache", "paged_cache_attention", "serialize_handoff",
           "deserialize_handoff", "publish_handoff", "fetch_handoff",
           "KVTierManager", "prefix_block_key", "session_key",
           "ServingRouter", "SloAutoscaler", "SloAutoscaleRule",
           "ReplicaWorker", "submit_request", "fetch_result",
           "ContinuousBatchingEngine",
           "QueueFullError", "RequestStatus"]
