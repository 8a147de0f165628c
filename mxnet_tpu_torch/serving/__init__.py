"""Continuous-batching serving on a paged KV cache (the counterpart of
``mxnet_tpu/serving``, greedy decoding only)."""
from .engine import ServingAdapter, ServingEngine, TransformerAdapter
from .paged_cache import (PagedKVCache, PagedStepCache, gather_pages,
                          page_coords, paged_attend, pages_for, write_page)
from .scheduler import (ContinuousBatchingScheduler, Request, TokenStream,
                        queue_bound)

__all__ = ["ServingAdapter", "ServingEngine", "TransformerAdapter",
           "PagedKVCache", "PagedStepCache", "gather_pages", "page_coords",
           "paged_attend", "pages_for", "write_page",
           "ContinuousBatchingScheduler", "Request", "TokenStream",
           "queue_bound"]
