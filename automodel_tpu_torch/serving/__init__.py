"""Continuous-batching serving engine over a paged KV cache.

- kv_pages.py:     refcounted page pool + per-request page tables (GQA)
- prefix_cache.py: radix tree over known tokens at page granularity
- scheduler.py:    admission / chunked-prefill / preemption scheduling
- engine.py:       the step over the paged pool + serve_batch() host loop
- ops/paged_attention.py holds the ragged paged-attention op it runs on.
"""

from automodel_tpu_torch.serving.engine import ServingConfig, ServingEngine
from automodel_tpu_torch.serving.kv_pages import PageAllocator, pages_for
from automodel_tpu_torch.serving.prefix_cache import (
    PrefixCache,
    PrefixCacheConfig,
    PrefixMatch,
)
from automodel_tpu_torch.serving.scheduler import Request, Scheduler, StepPlan

__all__ = [
    "PageAllocator",
    "PrefixCache",
    "PrefixCacheConfig",
    "PrefixMatch",
    "Request",
    "Scheduler",
    "ServingConfig",
    "ServingEngine",
    "StepPlan",
    "pages_for",
]
