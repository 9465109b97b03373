"""Public ops over the DeMM kernels.

Backend dispatch routes through the ``repro_torch.tune`` kernel registry:

  * ``reference`` — the kernel's plain PyTorch version (scatter + matmul).
  * ``cuda``      — the hand-written CUDA kernel.  For a CUDA tensor it
                    launches or raises; nothing falls back.
  * ``auto``      — resolved per problem (shapes, dtype, pattern, block
                    geometry, duplicates, the operand's device) through the
                    ``repro_torch.tune`` cache: a measured entry, else the
                    heuristic default (``cuda`` with the wrapper's own
                    heuristics on a CUDA tensor, ``reference`` on the CPU).
                    A pure host lookup — it runs where the matmul is
                    dispatched (an engine's warm-up step and capture), never
                    at a replay.  The tuned params merge with the call's own
                    (``duplicates``).

New variants registered via ``repro_torch.tune.register_variant`` become
valid backend strings here with no further changes.

Forward only: the sparse-aware gradients of the JAX package come with the
training slice of the port.  Shard-stacked weights are not ported either.
A draft-tier view (``PackedWeight.tier_ne``, ``repro_torch.spec``) is
narrowed to prefix views of its tensors before any dispatch decision, so
``auto`` keys on the narrowed problem, as the JAX package does, and the
kernels read the prefix in place.

Observability (``repro_torch.obs``): every dispatch increments a
``kernel_dispatch_total{op, backend}`` counter (the *resolved* backend under
``auto``) on the default registry and
runs the selected variant under an ``obs.annotate("demm/<op>/<backend>")``
NVTX range; the first dispatch of each (op, backend) pair on a registry also
leaves a ``kernel_dispatch`` trace event.
"""

from __future__ import annotations

import torch

from repro_torch.core.sparsity import (
    LAYOUT_BLOCK,
    LAYOUT_XWT,
    LAYOUTS,
    PackedWeight,
    SparsityConfig,
    narrow_tier,
)


def _count_dispatch(op: str, backend: str):
    """Dispatch audit: the counter moves on every call (the port dispatches
    eagerly on every matmul, not once per traced program); the
    ``kernel_dispatch`` trace event is left only by the first dispatch of an
    (op, backend) pair on a registry, so the trace is not flooded."""
    from repro_torch import obs

    m = obs.metrics()
    c = m.counter(
        "kernel_dispatch_total",
        help="DeMM matmul dispatches per (registry op, resolved backend)",
        op=op, backend=backend)
    if c.value == 0:
        m.trace.event("kernel_dispatch", op=op, backend=backend)
    c.inc()


def demm_matmul_packed(x: torch.Tensor, pw: PackedWeight,
                       backend: str = "reference") -> torch.Tensor:
    """y = x @ W^T for a first-class :class:`PackedWeight`.

    The layout tag picks the op: ``xwT`` weights run the row-packed DeMM
    matmul, ``block`` weights (two-level ahead-of-time packing from
    ``core.sparsity.pack_block``) run the block-spmm family.  A quantized
    node (``pw.qdtype`` set, see ``repro_torch.quant``) routes to the
    ``xwT_q8`` / ``xwT_block_q8`` twins, whose kernels dequantize the int8
    values in-register (w8a16).  The sparsity config (including
    k-reconfiguration), dense shape, block geometry, qdtype and whether any
    group holds duplicate indices come from the weight's static attributes,
    so call sites never re-derive them.

    A draft-tier view (``pw.tier_ne`` set) shares the full tier's tensors;
    :func:`~repro_torch.core.sparsity.narrow_tier` turns it into views of
    their first ``tier_ne`` pairs per group and the sparser config, and the
    narrowed weight is dispatched like any other (no copy).
    """
    if pw.tier_ne is not None:
        return demm_matmul_packed(x, narrow_tier(pw), backend)
    if pw.layout == LAYOUT_BLOCK:
        if pw.values.ndim != 4:
            raise ValueError(
                f"demm_matmul_packed needs an unstacked (RB, A_max, block_r, "
                f"Ne) block weight, got values of shape "
                f"{tuple(pw.values.shape)}")
        return demm_matmul_block(x, pw, backend)
    if pw.layout != LAYOUT_XWT:
        raise ValueError(
            f"unknown PackedWeight layout {pw.layout!r}; known layouts: "
            f"{LAYOUTS}")
    if pw.values.ndim != 3:
        raise ValueError(
            f"demm_matmul_packed needs an unstacked (O, G, Ne) weight, got "
            f"values of shape {tuple(pw.values.shape)}; slice the stack axis "
            f"first")
    if pw.qdtype is not None:
        return demm_matmul_xwT_q8(x, pw.values, pw.indices, pw.scales,
                                  pw.cfg, pw.dense_shape, backend,
                                  duplicates=pw.has_duplicates)
    return demm_matmul_xwT(x, pw.values, pw.indices, pw.cfg, pw.dense_shape,
                           backend, duplicates=pw.has_duplicates)


def demm_matmul_block(x: torch.Tensor, pw: PackedWeight,
                      backend: str = "reference") -> torch.Tensor:
    """y = x @ W^T for a ``block``-layout :class:`PackedWeight`.

    The two-level kernel computes the paper orientation C = A_sparse @ B, so
    the serving matmul is ``(W_block @ xᵀ)ᵀ`` with the active-group address
    stream deciding which blocks of xᵀ are read at all; the port reads x
    (B, K) in place through a transposed view and returns (B, O) float32.
    Dispatch routes through the ``xwT_block`` op of the ``repro_torch.tune``
    registry (``xwT_block_q8`` for a quantized node).
    """
    from repro_torch import obs, tune

    params = {}
    if backend == "auto":
        choice = tune.resolve_xwT_block(x.shape, pw, x.dtype,
                                        device=x.device)
        backend, params = choice.backend, choice.params
    op = "xwT_block_q8" if pw.qdtype is not None else "xwT_block"
    variant = tune.get_variant(op, backend)
    _count_dispatch(op, backend)
    args = (x, pw.values, pw.indices, pw.active_groups)
    if pw.qdtype is not None:
        args += (pw.scales,)
    with obs.annotate(f"demm/{op}/{backend}"):
        return variant.call(*args, pw.cfg, tuple(pw.dense_shape),
                            duplicates=pw.has_duplicates, **params)


def _resolve(resolver, backend, params, *shape_args, device, **kw):
    """``backend="auto"``: the tuned (backend, params), the call's own
    params laid over them; otherwise unchanged.  The key's duplicates flag
    is what the call launches (the wrappers' default: True)."""
    if backend != "auto":
        return backend, params
    choice = resolver(*shape_args, device=device,
                      duplicates=bool(params.get("duplicates", True)), **kw)
    return choice.backend, {**choice.params, **params}


def demm_matmul_xwT(x, values, indices, cfg: SparsityConfig, w_shape,
                    backend: str = "reference", **params):
    """y = x @ W_sparseᵀ; x (B, K), W packed (O, G, Ne) for dense (O, K)."""
    from repro_torch import obs, tune

    backend, params = _resolve(tune.resolve_xwT, backend, params, x.shape,
                               w_shape, cfg, x.dtype, device=x.device)
    variant = tune.get_variant("xwT", backend)
    _count_dispatch("xwT", backend)
    with obs.annotate(f"demm/xwT/{backend}"):
        return variant.call(x, values, indices, cfg, tuple(w_shape), **params)


def demm_matmul_xwT_q8(x, values, indices, scales, cfg: SparsityConfig,
                       w_shape, backend: str = "reference", **params):
    """y = x @ W_q8ᵀ; int8 values (O, G, Ne) + scales (O,) per output row or
    (O, G) per group (``repro_torch.quant`` granularities)."""
    from repro_torch import obs, tune

    backend, params = _resolve(tune.resolve_xwT_q8, backend, params,
                               x.shape, w_shape, cfg, x.dtype,
                               device=x.device)
    variant = tune.get_variant("xwT_q8", backend)
    _count_dispatch("xwT_q8", backend)
    with obs.annotate(f"demm/xwT_q8/{backend}"):
        return variant.call(x, values, indices, scales, cfg, tuple(w_shape),
                            **params)


def demm_spmm(values, indices, b, cfg: SparsityConfig, a_shape,
              backend: str = "reference", **params):
    """C = A_sparse @ B (paper orientation); A packed (R, G, Ne) for dense
    ``a_shape`` (R, K), B (K, Cd)."""
    from repro_torch import obs, tune

    backend, params = _resolve(tune.resolve_spmm, backend, params, a_shape,
                               b.shape, cfg, b.dtype, device=b.device)
    variant = tune.get_variant("spmm", backend)
    if variant.measure_only:
        raise ValueError(
            f"backend {backend!r} is measure-only (host repacking); use it "
            "through repro_torch.tune.autotune_spmm")
    _count_dispatch("spmm", backend)
    with obs.annotate(f"demm/spmm/{backend}"):
        return variant.call(values, indices, b, cfg, tuple(a_shape),
                            **params)
