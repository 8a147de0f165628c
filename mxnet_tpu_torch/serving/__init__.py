"""Continuous-batching serving on a paged KV cache, with the front door:
seeded sampling, speculative decoding, the copy-on-write prefix cache,
batched beam serving, weight hot-swap, and the fleet's HTTP servers
(``ReplicaServer`` per engine, a ``Router`` over them).  The counterpart
of ``mxnet_tpu/serving``; its ``FullPrefixAdapter`` is not ported yet
(ROADMAP A.5)."""
from .paged_cache import (PagedKVCache, PagedStepCache, gather_pages,
                          page_coords, paged_attend, pages_for, write_page)
from .scheduler import (ContinuousBatchingScheduler, PrefixCache, Request,
                        TokenStream, prefix_key, queue_bound)
from .engine import ServingAdapter, ServingEngine, TransformerAdapter
from .speculative import DraftProposer, NGramDraft
from .router import (ReplicaServer, Router, discover_replicas,
                     serve_portfile_path)

__all__ = ["PagedKVCache", "PagedStepCache", "gather_pages", "page_coords",
           "paged_attend", "pages_for", "write_page",
           "ContinuousBatchingScheduler", "Request", "TokenStream",
           "queue_bound", "PrefixCache", "prefix_key",
           "ServingAdapter", "ServingEngine", "TransformerAdapter",
           "DraftProposer", "NGramDraft",
           "ReplicaServer", "Router", "discover_replicas",
           "serve_portfile_path"]
