"""repro_torch.paged — paged KV cache, chunked prefill, and scheduled serving.

KV storage is decoupled from decode slots the way DeMM decouples its memory
block from the compute units: a shared physical arena of fixed-size pages
addressed through per-sequence block tables (the ``col_idx`` indirection
idiom one level up).  On top of it: chunked prefill as a second program
(O(prompt_len / K) ingest dispatches) and an admission/preemption scheduler
driving the :class:`PagedServeEngine` tick.  On a CUDA engine each of the two
programs is captured once as a CUDA graph.

Layering: this package never imports ``repro_torch.models`` — the model is
handed in (by the serving program or a test), and the device-side
gather/scatter indexing lives in ``repro_torch.models.attention``.
"""

from repro_torch.paged.kv_cache import (  # noqa: F401
    NULL_PAGE,
    PageAllocator,
    PagedKVCache,
    PagedLayout,
)
from repro_torch.paged.prefill import ChunkedPrefill  # noqa: F401
from repro_torch.paged.scheduler import (  # noqa: F401
    SchedConfig,
    Scheduler,
    Stage,
)
from repro_torch.paged.engine import (  # noqa: F401
    PagedServeConfig,
    PagedServeEngine,
)

__all__ = [
    "NULL_PAGE",
    "PageAllocator",
    "PagedKVCache",
    "PagedLayout",
    "ChunkedPrefill",
    "SchedConfig",
    "Scheduler",
    "Stage",
    "PagedServeConfig",
    "PagedServeEngine",
]
