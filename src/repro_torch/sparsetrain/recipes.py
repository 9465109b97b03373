"""Sparsity-aware training recipes: schedule + QAT + fault tolerance.

:class:`SparseTrainer` is the host-side driver that turns the pieces of this
package into one supervisor-compatible step function:

* it owns the **mask state** (``masks.init_mask_state``) and refreshes it
  deterministically from the integer step before every train step;
* it builds the step via ``train_loop.make_train_step`` with scheduled masks
  and optional fake-quant QAT;
* it implements the :class:`~repro_torch.train.fault_tolerance.
  TrainingSupervisor` extra-state protocol (``extra_state()`` /
  ``load_extra_state()``), so the mask tree, phase index, refresh step and
  the schedule's canonical spec ride every checkpoint — a resume
  mid-schedule continues with the exact masks it left with, and a resume
  against a *different* schedule fails loudly instead of silently training
  a different model.

After training, :meth:`finalize` bakes the final masks into the weights
(hard zeros) so the checkpointed model satisfies its N:M patterns exactly
and packs losslessly for serving (``launch.pack_tree`` → ``launch.serve``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.sparse_linear import sparse_weights
from repro_torch.core.treeutil import Static
from repro_torch.sparsetrain import masks as masks_mod
from repro_torch.sparsetrain.masks import SparsifySchedule
from repro_torch.sparsetrain.qat import validate_qat


@dataclasses.dataclass(frozen=True)
class SparseTrainRecipe:
    """What to train: the sparsification schedule and the QAT choice."""

    schedule: SparsifySchedule
    qat: Optional[str] = None           # None | "int8"
    qat_granularity: str = "per_row"    # per_row | per_group

    def __post_init__(self):
        validate_qat(self.qat, self.qat_granularity)


class SparseTrainer:
    """Drives a sparsify schedule (and optional QAT) through the supervisor.

    Usage::

        trainer = SparseTrainer(model, opt_cfg, recipe)
        trainer.init_state(params)
        sup = TrainingSupervisor(cfg, trainer.train_step, data_cfg,
                                 extra_state=trainer)
        params, opt, metrics, _ = sup.run(params, opt, steps)
        params = trainer.finalize(params)       # bake the final masks
    """

    def __init__(self, model, opt_cfg, recipe: SparseTrainRecipe, *,
                 num_microbatches: int = 1, backend: str = "reference"):
        from repro_torch.core.sparse_linear import ExecPolicy
        from repro_torch.train.train_loop import make_train_step

        self.recipe = recipe
        self.sparsity = sparse_weights(model)
        self._state = None
        self._step_fn = make_train_step(
            model, opt_cfg, num_microbatches=num_microbatches,
            policy=ExecPolicy(mode="masked", backend=backend),
            premask=True, fake_quant=recipe.qat,
            qat_granularity=recipe.qat_granularity)

    # ---- mask-state lifecycle -------------------------------------------
    @property
    def state(self):
        if self._state is None:
            raise RuntimeError("call init_state(params) (or restore a "
                               "checkpoint) before training")
        return self._state

    def init_state(self, params, step: int = 0):
        self._state = masks_mod.init_mask_state(
            params, self.sparsity, self.recipe.schedule, step)
        return self._state

    def train_step(self, params, opt_state, batch, step):
        """Supervisor-compatible step: refresh masks if due, then step."""
        self._state, _ = masks_mod.update_mask_state(
            params, self.sparsity, self.state, self.recipe.schedule,
            int(step))
        return self._step_fn(params, opt_state, batch, step,
                             self._state["masks"])

    def finalize(self, params):
        """Bake the final masks into the weights (hard zeros): the result
        satisfies each node's N:M pattern exactly and packs losslessly."""
        return masks_mod.bake_masks(params, self.state["masks"])

    # ---- TrainingSupervisor extra-state protocol ------------------------
    def extra_state(self):
        return {"sparsetrain": dict(self.state,
                                    spec=Static(self.recipe.schedule.spec()))}

    def load_extra_state(self, tree):
        st = dict(tree["sparsetrain"])
        spec = st.pop("spec", None)
        want = self.recipe.schedule.spec()
        if spec is not None:
            got = spec.value if isinstance(spec, Static) else spec
            if got != want:
                raise ValueError(
                    f"checkpoint carries sparsify schedule {got!r} but this "
                    f"run was configured with {want!r}; resuming across "
                    "schedules would silently train a different model")
        self._state = st
