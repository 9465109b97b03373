"""``repro_torch.serve`` — the serving engine behind one protocol + factory.

:class:`ServeEngine` (dense per-slot KV caches, continuous batching) speaks
the protocol surface ``submit`` / ``step`` / ``run_until_drained`` (aliases
``tick``/``drain`` — see :mod:`repro_torch.serve.protocol`), as does
:class:`repro_torch.paged.PagedServeEngine` (a shared paged KV arena, chunked
prefill, scheduled admission and preemption).  :func:`make_engine` is the one
construction path; ``spec=`` turns on self-speculative decoding in either
engine (``repro_torch.spec``).  Replica routing and sharding plans are not
ported yet and are refused by name.
"""

from __future__ import annotations

from repro_torch.serve.protocol import Engine, EngineBase
from repro_torch.serve.serve_loop import Request, ServeConfig, ServeEngine

__all__ = ["Engine", "EngineBase", "Request", "ServeConfig", "ServeEngine",
           "make_engine"]


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
      captured CUDA graph.
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
    * ``plan`` / ``replicas`` > 1 name parts of the system that are not
      ported yet.
    """
    from repro_torch.core.sparse_linear import resolve_policy
    from repro_torch.paged import PagedServeConfig, PagedServeEngine

    policy = resolve_policy(policy, None, None)
    for name, given in (("plan", plan is not None),
                        ("replicas > 1", replicas > 1)):
        if given:
            raise NotImplementedError(
                f"make_engine({name}) is not ported yet; only the "
                "single-device engines are")
    if isinstance(config, PagedServeConfig):
        return PagedServeEngine(model, config, policy=policy,
                                metrics=metrics, device=device,
                                recorder=recorder, autotune=autotune,
                                spec=spec)
    if not isinstance(config, ServeConfig):
        raise TypeError(
            f"make_engine: unknown config type {type(config).__name__!r} "
            "(expected ServeConfig or PagedServeConfig)")
    return ServeEngine(model, config, policy=policy, metrics=metrics,
                       device=device, recorder=recorder, autotune=autotune,
                       spec=spec)
