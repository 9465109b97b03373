"""``repro_torch.sparsetrain`` — sparsity-aware training for the DeMM formats.

The train-side pillar of the dense → prune → train/QAT → pack → serve
pipeline:

  * :mod:`repro_torch.sparsetrain.vjp`     — autograd functions of the
    ``xwT_block`` / ``xwT_q8`` / ``xwT_block_q8`` ops (``kernels/ops.py``
    dispatches through them under grad), so a packed forward is
    differentiable for every layout.
  * :mod:`repro_torch.sparsetrain.masks`   — gradual magnitude-pruning
    schedules (dense → coarse-group N:2M → N:M, k-reconfiguration phases)
    with deterministic, checkpointable mask state.
  * :mod:`repro_torch.sparsetrain.ste`     — straight-through fake
    quantization matching ``repro_torch.quant``'s serving numerics bit for
    bit.
  * :mod:`repro_torch.sparsetrain.qat`     — QAT over the masked training
    form (per-row / per-group int8 scales).
  * :mod:`repro_torch.sparsetrain.recipes` — :class:`SparseTrainer`, the
    supervisor-compatible driver (``launch/train.py --sparsify ... --qat
    int8``).
"""

from repro_torch.sparsetrain.masks import (
    SparsifyPhase,
    SparsifySchedule,
    anneal_schedule,
    apply_mask_tree,
    bake_masks,
    build_masks,
    init_mask_state,
    map_sparse_nodes,
    parse_pattern,
    parse_schedule,
    update_mask_state,
)
from repro_torch.sparsetrain.qat import fake_quant_params
from repro_torch.sparsetrain.ste import fake_quant, fake_quant_weight


def __getattr__(name):
    # Lazy: recipes pulls in the training stack (train_loop → optim), which
    # the serving side — kernels/ops.py reaches sparsetrain.vjp on the first
    # block/q8 matmul under grad — does not need.
    if name in ("SparseTrainRecipe", "SparseTrainer"):
        from repro_torch.sparsetrain import recipes

        return getattr(recipes, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "SparsifyPhase",
    "SparsifySchedule",
    "SparseTrainRecipe",
    "SparseTrainer",
    "anneal_schedule",
    "apply_mask_tree",
    "bake_masks",
    "build_masks",
    "fake_quant",
    "fake_quant_params",
    "fake_quant_weight",
    "init_mask_state",
    "map_sparse_nodes",
    "parse_pattern",
    "parse_schedule",
    "update_mask_state",
]
