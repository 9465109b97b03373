"""``repro_torch.serve`` — the serving engines behind one protocol + factory.

:class:`ServeEngine` (dense per-slot KV caches, continuous batching) speaks
the protocol surface ``submit`` / ``step`` / ``run_until_drained`` (aliases
``tick``/``drain`` — see :mod:`repro_torch.serve.protocol`), as do
:class:`repro_torch.paged.PagedServeEngine` (a shared paged KV arena, chunked
prefill, scheduled admission and preemption) and
:class:`~repro_torch.serve.router.ReplicaRouter` (round-robin over engine
replicas).  :func:`make_engine` is the one construction path; it folds an
optional :class:`~repro_torch.sharding.plan.ShardingPlan` into the policy, so
callers write one path for one rank, TP, PP and (``replicas=``) data
parallelism; ``spec=`` turns on self-speculative decoding in either engine
(``repro_torch.spec``).
"""

from __future__ import annotations

from repro_torch.serve.protocol import Engine, EngineBase
from repro_torch.serve.router import ReplicaRouter, make_replicas
from repro_torch.serve.serve_loop import Request, ServeConfig, ServeEngine

__all__ = ["Engine", "EngineBase", "ReplicaRouter", "Request", "ServeConfig",
           "ServeEngine", "make_engine", "make_replicas"]


def make_engine(model, config, *, policy=None, metrics=None, device="cuda",
                plan=None, replicas: int = 1, spec=None, recorder=None,
                autotune: bool = False):
    """Build a serving engine for ``config`` on ``device``.

    * ``config`` — :class:`ServeConfig` selects the dense-cache
      :class:`ServeEngine`; :class:`repro_torch.paged.PagedServeConfig` the
      paged :class:`~repro_torch.paged.PagedServeEngine`.
    * ``device`` — defaults to ``"cuda"`` and raises when no CUDA device is
      present; the CPU is used only when asked for by name.  A CUDA engine
      runs its decode step (and the paged engine its prefill chunk) as a
      captured CUDA graph, unless it is one rank of a multi-rank plan.
    * ``plan`` — a :class:`~repro_torch.sharding.plan.ShardingPlan`, folded
      onto the policy (``policy.plan``): the engine builds the mesh over the
      initialised process group, places the model on this rank (renumbered
      row-parallel packed weights, this rank's blocks, this stage's
      layers) and its decode state.  A plan that conflicts with
      ``policy.plan`` raises ``ValueError``; a plan of more ranks than the
      process group raises too.
    * ``replicas`` — N > 1 wraps N engines (each with its own metrics
      registry, decode state and captured programs, sharing ``model``'s
      tensors) in a round-robin :class:`ReplicaRouter`; ``metrics`` must
      then be None (the router merges the replicas' snapshots).
    * ``recorder`` — a :class:`~repro_torch.obs.FlightRecorder` the engine
      attaches to (event rings + a tick stall watchdog).
    * ``autotune`` — measure every packed weight's kernel tunables at
      ``config.num_slots`` rows before anything is captured
      (``repro_torch.tune.autotune_packed_tree``), so ``backend="auto"``
      resolves from measured entries.
    * ``spec`` — a :class:`repro_torch.spec.SpecConfig`: draft γ tokens per
      tick at its sparser tier of the same packed tensors and verify them in
      one full-tier program (the committed stream is the non-speculative
      one, token for token).
    """
    from repro_torch.core.sparse_linear import resolve_policy
    from repro_torch.paged import PagedServeConfig, PagedServeEngine
    from repro_torch.sharding.plan import ShardingPlan

    policy = resolve_policy(policy, None, None)
    if plan is not None:
        if not isinstance(plan, ShardingPlan):
            raise TypeError(f"make_engine(plan=...) takes a ShardingPlan, "
                            f"got {type(plan).__name__}")
        if policy.plan is not None and policy.plan != plan:
            raise ValueError(
                "make_engine(plan=...) conflicts with policy.plan; pass the "
                "plan in one place")
        policy = policy.replace(plan=plan)
    if isinstance(config, PagedServeConfig):
        engine_cls = PagedServeEngine
    elif isinstance(config, ServeConfig):
        engine_cls = ServeEngine
    else:
        raise TypeError(
            f"make_engine: unknown config type {type(config).__name__!r} "
            "(expected ServeConfig or PagedServeConfig)")

    def build(m):
        return engine_cls(model, config, policy=policy, metrics=m,
                          device=device, recorder=recorder,
                          autotune=autotune, spec=spec)

    if replicas > 1:
        if metrics is not None:
            raise ValueError(
                "make_engine(replicas=N, metrics=...) is unsupported: each "
                "replica owns a registry and the router merges snapshots")
        return make_replicas(replicas, build)
    return build(metrics)
