"""Continuous-batching serving on a paged KV cache, with the front door:
seeded sampling, speculative decoding, the copy-on-write prefix cache and
batched beam serving (the counterpart of ``mxnet_tpu/serving``)."""
from .engine import ServingAdapter, ServingEngine, TransformerAdapter
from .paged_cache import (PagedKVCache, PagedStepCache, gather_pages,
                          page_coords, paged_attend, pages_for, write_page)
from .scheduler import (ContinuousBatchingScheduler, PrefixCache, Request,
                        TokenStream, prefix_key, queue_bound)
from .speculative import DraftProposer, NGramDraft

__all__ = ["ServingAdapter", "ServingEngine", "TransformerAdapter",
           "PagedKVCache", "PagedStepCache", "gather_pages", "page_coords",
           "paged_attend", "pages_for", "write_page",
           "ContinuousBatchingScheduler", "Request", "TokenStream",
           "queue_bound", "PrefixCache", "prefix_key",
           "DraftProposer", "NGramDraft"]
