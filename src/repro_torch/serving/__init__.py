"""LM serving: paged KV-cache runtime + continuous-batching scheduler."""
from repro_torch.serving.kvcache import (NULL_BLOCK, BlockAllocator,
                                         PagedKVRuntime, PrefixCache)
from repro_torch.serving.scheduler import ContinuousBatcher, Request

__all__ = [
    "NULL_BLOCK", "BlockAllocator", "PagedKVRuntime", "PrefixCache",
    "ContinuousBatcher", "Request",
]
