"""Formats, pruning, the sparse linear layer and the decoupled engine of the
DeMM technique."""
from repro_torch.core.sparsity import (  # noqa: F401
    PackedSparse,
    PackedWeight,
    SparsityConfig,
    pack,
    pack_block_stacked,
    prune,
    prune_mask,
    satisfies_pattern,
    unpack,
    unpack_packed,
)
from repro_torch.core.sparse_linear import (  # noqa: F401
    DEFAULT_POLICY,
    ExecPolicy,
    resolve_policy,
)
from repro_torch.core.demm import (  # noqa: F401
    DeMMConfig,
    demm_spmm,
    demm_spmm_k_passes,
)
