"""Fault tolerance: supervised training with restart and straggler
monitoring.

* ``TrainingSupervisor`` — wraps the step loop: periodic (async) checkpoints,
  exception-driven restore + deterministic data skip-ahead.  Because the
  data pipeline is a pure function of the step index, a restart reproduces
  the uninterrupted trajectory bitwise (tested).
* ``StragglerMonitor`` — per-host step-time EWMA; hosts slower than
  ``threshold``× the fleet median are flagged for replacement / microbatch
  rebalancing (hook returns the suggested new grain distribution).

* ``elastic_restore`` — restore a checkpoint onto another mesh: every rank
  reads the whole leaves and keeps its block of each under the new mesh's
  specs.

Observability (``repro_torch.obs``): the supervisor observes a step-time
histogram, restart/failure counters, and checkpoint save/restore duration
histograms on its :class:`~repro_torch.obs.MetricsRegistry` (the process
default unless ``metrics=`` is given), with ``train_step`` /
``checkpoint_save`` / ``restart`` trace events, each with its ``step`` and
``seconds`` (a step's time runs until its loss is on the host, so it
includes the device's work); :class:`StragglerMonitor` folds its per-host EWMA
state and each :class:`StragglerReport` into the same registry (per-host
gauges + flagged count) instead of keeping the report purely bespoke.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch import obs
from repro_torch.data.pipeline import DataConfig, global_batch
from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_restarts: int = 3
    async_save: bool = False


class TrainingSupervisor:
    """Drives (params, opt_state) through ``train_step`` with restarts."""

    def __init__(self, cfg: SupervisorConfig, train_step: Callable,
                 data_cfg: DataConfig, to_batch: Optional[Callable] = None,
                 extra_state=None, metrics=None, recorder=None):
        """``extra_state`` (optional) is any object with an
        ``extra_state() -> pytree`` / ``load_extra_state(pytree)`` pair
        (e.g. ``sparsetrain.SparseTrainer``): its tree is saved under the
        checkpoint's ``extra`` key and pushed back on restore, so stateful
        schedules (pruning masks, QAT observers) survive restarts with the
        same bitwise-replay guarantee as params.

        ``recorder`` (optional :class:`~repro_torch.obs.FlightRecorder`):
        the supervisor taps its trace into the recorder's
        rings, beats a ``train_step`` stall watchdog once per step, and
        dumps flight data when the run dies (restart budget exhausted or an
        unexpected exception)."""
        self.cfg = cfg
        self.train_step = train_step
        self.data_cfg = data_cfg
        self.to_batch = to_batch or (lambda b: b)
        self.extra = extra_state
        self.restarts = 0
        self.pending_save = None
        self.metrics = metrics if metrics is not None else obs.metrics()
        m = self.metrics
        self._m_step_time = m.histogram(
            "train_step_seconds", help="wall time per training step")
        self._m_steps = m.counter(
            "train_steps_total", help="completed training steps")
        self._m_restarts = m.counter(
            "train_restarts_total", help="checkpoint-restore restarts")
        self._m_failures = m.counter(
            "train_failures_total", help="step failures caught")
        self._m_ckpt_save = m.histogram(
            "train_checkpoint_save_seconds",
            help="checkpoint save duration (submission time if async)")
        self._m_ckpt_restore = m.histogram(
            "train_checkpoint_restore_seconds",
            help="checkpoint restore duration")
        self._m_ckpt_saves = m.counter(
            "train_checkpoint_saves_total", help="checkpoints written")
        self._recorder = recorder
        self._watchdog = None
        if recorder is not None:
            recorder.attach_trace(m.trace)
            self._watchdog = recorder.watchdog("train_step")

    def _save(self, state, step):
        t0 = time.perf_counter()
        tree = {"params": state[0], "opt": state[1]}
        if self.extra is not None:
            tree["extra"] = self.extra.extra_state()
        if self.cfg.async_save:
            if self.pending_save is not None:
                self.pending_save.result()
            self.pending_save = ckpt.save_async(tree, self.cfg.ckpt_dir, step)
        else:
            ckpt.save(tree, self.cfg.ckpt_dir, step)
        dt = time.perf_counter() - t0
        self._m_ckpt_save.observe(dt)
        self._m_ckpt_saves.inc()
        self.metrics.trace.event("checkpoint_save", step=step, seconds=dt,
                                 asynchronous=self.cfg.async_save)

    def _restore(self, template_state):
        step = ckpt.latest_step(self.cfg.ckpt_dir)
        if step is None:
            return template_state, 0
        t0 = time.perf_counter()
        template = {"params": template_state[0], "opt": template_state[1]}
        if self.extra is not None:
            template["extra"] = self.extra.extra_state()
        tree = ckpt.restore(template, self.cfg.ckpt_dir, step)
        if self.extra is not None:
            self.extra.load_extra_state(tree["extra"])
        dt = time.perf_counter() - t0
        self._m_ckpt_restore.observe(dt)
        self.metrics.trace.event("checkpoint_restore", step=step, seconds=dt)
        return (tree["params"], tree["opt"]), step

    def run(self, params, opt_state, num_steps: int,
            failure_injector: Optional[Callable[[int], None]] = None):
        """Run ``num_steps`` steps with checkpoint/restart.  Returns
        (params, opt_state, metrics_of_last_step, restart_count).  A step
        may update the state in place (the port's train step does): a
        restart reads the state back from the last checkpoint, never from
        memory."""
        state = (params, opt_state)
        step = 0
        metrics = None
        while step < num_steps:
            try:
                if self._watchdog is not None:
                    self._watchdog.beat()
                if failure_injector is not None:
                    failure_injector(step)
                t0 = time.perf_counter()
                batch = self.to_batch(global_batch(self.data_cfg, step))
                p, o, metrics = self.train_step(state[0], state[1], batch,
                                                step)
                if "loss" in metrics:
                    float(metrics["loss"])      # waits for the device
                state = (p, o)
                dt = time.perf_counter() - t0
                self._m_step_time.observe(dt)
                self.metrics.trace.event("train_step", step=step, seconds=dt)
                self._m_steps.inc()
                step += 1
                if step % self.cfg.ckpt_every == 0 or step == num_steps:
                    self._save(state, step)
            except _InjectedFailure as e:
                self._m_failures.inc()
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    if self._recorder is not None:
                        self._recorder.dump("crash-restart-budget")
                    raise
                self._m_restarts.inc()
                self.metrics.trace.event("restart", step=step,
                                         reason=str(e)[:200])
                state, step = self._restore(state)
            except BaseException:
                # unexpected failure: capture the flight rings before dying
                if self._recorder is not None:
                    self._recorder.dump("crash-train")
                raise
        if self.pending_save is not None:
            self.pending_save.result()
            self.pending_save = None
        return state[0], state[1], metrics, self.restarts


class _InjectedFailure(RuntimeError):
    """Simulated node failure (tests raise this via the injector)."""


def inject_failure_once(at_step: int):
    fired = {"done": False}

    def injector(step):
        if step == at_step and not fired["done"]:
            fired["done"] = True
            raise _InjectedFailure(f"simulated node failure at step {step}")

    return injector


# ---------------------------------------------------------------------------
# Straggler mitigation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerReport:
    flagged_hosts: list
    median_time: float
    suggestion: dict  # host -> microbatch grain multiplier


class StragglerMonitor:
    """EWMA per-host step times; flags hosts slower than threshold×median.

    On a real deployment the per-host times come from the coordinator's
    heartbeats; here they are fed in directly (and by the tests).

    State is folded into the metrics registry: every ``record`` updates a
    per-host ``train_host_step_seconds`` EWMA gauge, every ``report``
    updates ``train_straggler_median_step_seconds`` /
    ``train_stragglers_flagged`` — so straggler status ships in the same
    ``--metrics-out`` snapshot as everything else instead of living only in
    ad-hoc :class:`StragglerReport` objects."""

    def __init__(self, num_hosts: int, alpha: float = 0.3,
                 threshold: float = 1.5, metrics=None):
        self.ewma = np.zeros(num_hosts)
        self.seen = np.zeros(num_hosts, bool)
        self.alpha = alpha
        self.threshold = threshold
        self.metrics = metrics if metrics is not None else obs.metrics()
        self._m_hosts = [
            self.metrics.gauge("train_host_step_seconds",
                               help="per-host step-time EWMA", host=str(i))
            for i in range(num_hosts)]

    def record(self, host_times):
        host_times = np.asarray(host_times, float)
        new = ~self.seen
        self.ewma = np.where(new, host_times,
                             self.alpha * host_times +
                             (1 - self.alpha) * self.ewma)
        self.seen[:] = True
        for g, v in zip(self._m_hosts, self.ewma):
            g.set(float(v))

    def report(self) -> StragglerReport:
        med = float(np.median(self.ewma))
        flagged = [int(i) for i in np.nonzero(
            self.ewma > self.threshold * med)[0]]
        # rebalance: slow hosts get proportionally fewer microbatches
        suggestion = {
            int(i): (round(float(med / self.ewma[i]), 2) if i in flagged
                     else 1.0)
            for i in range(len(self.ewma))}
        self.metrics.gauge("train_straggler_median_step_seconds",
                           help="fleet median of the per-host EWMA").set(med)
        self.metrics.gauge("train_stragglers_flagged",
                           help="hosts slower than threshold x median").set(
            len(flagged))
        if flagged:
            self.metrics.trace.event("stragglers_flagged", hosts=flagged,
                                     median_seconds=med)
        return StragglerReport(flagged, med, suggestion)


# ---------------------------------------------------------------------------
# Elastic re-meshing
# ---------------------------------------------------------------------------

def _spec_leaves(tree, path=()):
    """``{path string: Spec or None}`` of a spec tree (its leaves are
    ``Spec``s, which are tuples, or None)."""
    from repro_torch.core.treeutil import key_path_str, sequence_keys
    from repro_torch.sharding.partitioning import Spec

    if tree is None or isinstance(tree, Spec):
        return {key_path_str(path): tree}
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = zip(sequence_keys(tree), tree)
    for k, v in items:
        out.update(_spec_leaves(v, path + (k,)))
    return out


def elastic_restore(template, directory: str, step: int, new_mesh,
                    spec_tree):
    """Restore a checkpoint onto a different mesh: this rank keeps, of every
    leaf, its block under the leaf's spec on ``new_mesh`` (a DeviceMesh this
    rank is in) — what ``device_put`` with the JAX package's
    ``NamedSharding`` leaves on one device.  ``spec_tree`` mirrors
    ``template`` with a ``Spec`` (or None: whole) per leaf; a spec's dim
    names are ``new_mesh``'s dim names, and a ``StackSpec`` leaf comes back
    as the rank's slice of the shard stack, without the stack dim.  The
    checkpoint holds whole leaves (``checkpoint.save``, from one process or
    from a world)."""
    from repro_torch.sharding.partitioning import spec_block

    names = new_mesh.mesh_dim_names
    at = new_mesh.get_coordinate()
    if at is None:
        raise ValueError("this rank is not in the new mesh")
    coord = dict(zip(names, at))
    degree = {n: new_mesh.size(i) for i, n in enumerate(names)}
    specs = _spec_leaves(spec_tree)

    def keep(path, whole):
        return spec_block(whole, specs.get(path), coord, degree, path)

    return ckpt.restore(template, directory, step, keep=keep)
