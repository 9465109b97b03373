"""Kernel variant registry — the dispatch layer of ``repro_torch.tune``.

Every packed-matmul implementation is registered as a :class:`KernelVariant`
declaring

  * how to *call* it with a uniform signature per op,
  * which *tunable parameters* it exposes and their candidate values for a
    given problem,
  * on which *platforms / problems* it is supported,
  * its *default* (heuristic) parameters.

``kernels/ops.py`` dispatches through :func:`get_variant` instead of matching
raw backend strings, so a new variant plugs in with one ``register_variant``
call and is immediately a valid ``--backend``, a candidate of the autotuner
and of ``backend="auto"``.

Ops and uniform signatures
--------------------------
``xwT``          : call(x, values, indices, cfg, w_shape, **params) -> (B, O)
``xwT_q8``       : call(x, values, indices, scales, cfg, w_shape, **params)
                   -> (B, O) — int8 values + scales (O,) or (O, G).
``xwT_block``    : call(x, values, indices, active_groups, cfg, w_shape,
                   **params) -> (B, O) — the two-level block layout, served
                   as ``(W_block @ xᵀ)ᵀ``.
``xwT_block_q8`` : call(x, values, indices, active_groups, scales, cfg,
                   w_shape, **params) -> (B, O) — scales (RB, A_max, block_r).
``spmm``         : call(values, indices, b, cfg, a_shape, **params) -> (R, Cd)
                   — the paper orientation C = A_sparse @ B.

Backends: ``reference`` is the kernel's plain PyTorch version on whatever
device the tensors lie, dispatchable on a ``"cpu"`` problem only (the plain
version is never the dispatched backend for a CUDA tensor); ``cuda`` is the
hand-written kernel, dispatchable on a ``"cuda"`` problem only (on a CPU
tensor its wrapper would run the plain version).  ``block_spmm`` of op
``spmm`` is measure-only: a host repack of the row-packed operands into the
two-level block layout, then K2; the autotuner times it, dispatch never
selects it.

The ``cuda`` variants' tunables are those of the body the problem's shape
selects (:func:`cuda_body`, the wrappers' own rules): the bulk row-tile body
of K1/K3 (``rows_per_block``, ``chunks``, K3's ``lanes``), the gather bodies
of K1-K4 (``rows_per_block``), the cluster body of K2/K4 (``cluster_size``)
and K5's tiled body (``tile_n`` x ``warpgroups`` = its ``tile``, and
``stages``).  The default params ``{}`` leave every tunable to the wrapper's
own heuristic.  Every call forwards ``duplicates`` (the weight's own) and the
params to the wrapper, which picks the body itself.

A :class:`Problem` is the static description of one matmul instance —
shapes, dtype, sparsity pattern, platform — and is everything a variant
needs to decide support, defaults, and candidates (no tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.core.sparsity import SparsityConfig

OPS = ("xwT", "spmm", "xwT_block", "xwT_q8", "xwT_block_q8")


def platform_of(where) -> str:
    """``"cuda"`` for a CUDA tensor or device (or the string), ``"cpu"`` for
    anything else: the platform a problem dispatches on is its operand's
    device, not what the process could reach."""
    if where is None:
        return "cpu"
    dev = getattr(where, "device", where)
    kind = getattr(dev, "type", str(dev).split(":")[0])
    return "cuda" if kind == "cuda" else "cpu"


def dtype_name(dtype) -> str:
    """Canonical dtype name as the JAX package writes it: ``torch.float32``,
    ``"float32"`` and numpy's float32 all give ``"float32"``."""
    name = getattr(dtype, "name", None)          # numpy dtypes
    if not isinstance(name, str):
        name = str(dtype)
    return name.replace("torch.", "")


_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


@dataclasses.dataclass(frozen=True)
class Problem:
    """Static description of one sparse-matmul instance.

    ``rows``  — rows of the dense operand (batch tokens for xwT/xwT_block,
                output columns Cd for spmm's B).
    ``out``   — rows of the sparse operand (O for xwT, R for spmm).
    ``k``     — contraction dim (== groups * cfg.m).
    ``block_r``/``a_max`` — static block geometry of the two-level layout
                (``xwT_block`` only; 0 otherwise).
    ``shards`` — contraction-sharding degree of a per-shard problem (a
                renumbered row-parallel slice, ``core.sparsity.shard_slice``:
                its key ends in ``|s{shards}``).
    ``duplicates`` — the weight may hold two non-zero slots at one index, so
                the kernels launch their summing instantiation (on the bulk
                body also the widest x tile): part of what was measured, so
                part of the key (``|dup``).
    ``value_bytes`` / ``group_scales`` — operand facts the body choice and
                the shared-memory account need and the key leaves out, as
                the reference's does: bytes of a packed value (0: 1 for the
                int8 ops, 4 otherwise) and whether K3's scales are per group.
                Every body takes the tuned params of every other (the
                wrappers pick the body), so problems that differ only here
                may share a cache entry.
    """

    op: str
    rows: int
    out: int
    k: int
    dtype: str                      # canonical dtype name, e.g. "float32"
    sparsity: Tuple[int, int, int]  # (n, m, k_reconfig)
    platform: str = "cpu"
    block_r: int = 0
    a_max: int = 0
    shards: int = 1
    duplicates: bool = False
    value_bytes: int = 0
    group_scales: bool = False

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown op {self.op!r}; expected one of {OPS}")
        if self.platform not in ("cuda", "cpu"):
            raise ValueError(f"platform must be 'cuda' or 'cpu', got "
                             f"{self.platform!r}")

    @property
    def cfg(self) -> SparsityConfig:
        n, m, k = self.sparsity
        return SparsityConfig(n, m, k)

    @property
    def groups(self) -> int:
        return self.k // self.sparsity[1]

    @property
    def dense_flops(self) -> int:
        return 2 * self.rows * self.out * self.k

    @property
    def quantized(self) -> bool:
        return self.op.endswith("_q8")

    @property
    def x_bytes(self) -> int:
        """Bytes of one activation (or B) element."""
        return _DTYPE_BYTES.get(self.dtype, 4)

    @property
    def v_bytes(self) -> int:
        """Bytes of one packed value."""
        return self.value_bytes or (1 if self.quantized else 4)

    @classmethod
    def for_xwT(cls, x_shape, w_shape, cfg: SparsityConfig, dtype,
                platform=None, *, quantized: bool = False, shards: int = 1,
                duplicates: bool = False, value_bytes: int = 0,
                group_scales: bool = False) -> "Problem":
        """``dtype`` is the *activation* dtype; ``platform`` the operand's
        device (or ``"cuda"`` / ``"cpu"``; ``None`` is the CPU).  Quantized
        problems (int8 weights, w8a16 kernels) are a distinct op — and
        therefore distinct tuning-cache keys — from their float twins."""
        return cls(op="xwT_q8" if quantized else "xwT",
                   rows=int(x_shape[0]), out=int(w_shape[0]),
                   k=int(x_shape[1]), dtype=dtype_name(dtype),
                   sparsity=(cfg.n, cfg.m, cfg.k),
                   platform=platform_of(platform), shards=int(shards),
                   duplicates=bool(duplicates), value_bytes=int(value_bytes),
                   group_scales=bool(group_scales))

    @classmethod
    def for_spmm(cls, a_shape, b_shape, cfg: SparsityConfig, dtype,
                 platform=None, *, duplicates: bool = False,
                 value_bytes: int = 0) -> "Problem":
        return cls(op="spmm", rows=int(b_shape[1]), out=int(a_shape[0]),
                   k=int(b_shape[0]), dtype=dtype_name(dtype),
                   sparsity=(cfg.n, cfg.m, cfg.k),
                   platform=platform_of(platform),
                   duplicates=bool(duplicates), value_bytes=int(value_bytes))

    @classmethod
    def for_xwT_block(cls, x_shape, pw, dtype, platform=None, *,
                      duplicates: Optional[bool] = None) -> "Problem":
        """Problem for a block-layout PackedWeight serving matmul; geometry,
        pattern, quantization and duplicates (unless given) are read from
        the weight's static attributes (a quantized node is the distinct
        ``xwT_block_q8`` op)."""
        o, k = pw.dense_shape
        block_r, a_max = pw.block_geom
        cfg = pw.cfg
        op = "xwT_block_q8" if pw.qdtype is not None else "xwT_block"
        if duplicates is None:
            duplicates = pw.has_duplicates
        return cls(op=op, rows=int(x_shape[0]), out=int(o),
                   k=int(k), dtype=dtype_name(dtype),
                   sparsity=(cfg.n, cfg.m, cfg.k),
                   platform=platform_of(platform),
                   block_r=int(block_r), a_max=int(a_max),
                   shards=int(getattr(pw, "shards", 1)),
                   duplicates=bool(duplicates),
                   value_bytes=int(pw.values.element_size()))


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """One registered implementation of a DeMM op."""

    op: str
    name: str
    call: Callable
    # Problem -> {param: (candidate, ...)}; empty dict = nothing to tune.
    param_space: Callable[[Problem], Dict[str, Tuple[int, ...]]] = (
        lambda p: {})
    # Problem -> {param: value}; {} = every tunable left to the wrapper
    default_params: Callable[[Problem], Dict[str, int]] = lambda p: {}
    # Problem -> bool: dispatchable on this problem
    supported: Callable[[Problem], bool] = lambda p: True
    # Variants that repack concrete operands on the host (never dispatched,
    # never captured); the autotuner may still measure them.
    measure_only: bool = False
    description: str = ""
    # Measure-only variants: prepare(*operands, cfg, shape, **params) does
    # the host work now and returns (the device operands it made, a launch
    # taking them), so the autotuner times the launch alone over a ring of
    # those operands.
    prepare: Optional[Callable] = None


_REGISTRY: Dict[Tuple[str, str], KernelVariant] = {}


def register_variant(variant: KernelVariant, *, overwrite: bool = False):
    if variant.op not in OPS:
        raise ValueError(f"unknown op {variant.op!r}; expected one of {OPS}")
    key = (variant.op, variant.name)
    if key in _REGISTRY and not overwrite:
        raise ValueError(f"variant {key} already registered")
    _REGISTRY[key] = variant
    return variant


def get_variant(op: str, name: str) -> KernelVariant:
    try:
        return _REGISTRY[(op, name)]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r} for op {op!r}; registered: "
            f"{sorted(n for (o, n) in _REGISTRY if o == op)}") from None


def variants_for(op: str, problem: Optional[Problem] = None,
                 include_measure_only: bool = False
                 ) -> Sequence[KernelVariant]:
    """All registered variants of ``op``, sorted by name, optionally filtered
    to the ones supporting ``problem``; measure-only variants only when
    asked for."""
    out = []
    for (o, _), v in sorted(_REGISTRY.items()):
        if o != op:
            continue
        if v.measure_only and not include_measure_only:
            continue
        if problem is not None and not v.supported(problem):
            continue
        out.append(v)
    return out


def backend_names(op: str) -> Tuple[str, ...]:
    return tuple(v.name for v in variants_for(op))


# ---------------------------------------------------------------------------
# The CUDA bodies a problem selects, and their tunables
# ---------------------------------------------------------------------------

# Candidate values, the sets ``chip_smoke.py --sweep`` times.
BULK_ROWS = (8, 12, 16, 20, 24, 32, 40, 53, 64)
BULK_CHUNKS = (1, 2, 4, 16)
BULK_LANES = (8, 16)
XWT_GATHER_ROWS = (8, 16, 24, 32, 48, 64)
BLOCK_GATHER_ROWS = (8, 16, 32, 64, 128)     # must divide the 256 threads
CLUSTER_SIZES = (1, 2, 4, 8)
TC_TILE_N = (128, 256)
TC_WARPGROUPS = (1, 2)
TC_STAGES = (2, 3, 4)


def cuda_body(p: Problem) -> str:
    """The body the op's CUDA wrapper picks for this problem, by the
    wrappers' own shape rules with every operand taken 16-byte aligned (the
    port's allocations are): ``"bulk"`` / ``"gather"`` for ``xwT`` and
    ``xwT_q8``, ``"cluster"`` / ``"gather"`` for the block ops (B = xᵀ of a
    contiguous x), ``"tiled"`` / ``"gather"`` for ``spmm`` (B (K, Cd)
    contiguous)."""
    m, ne = p.sparsity[1], p.cfg.n_effective
    if p.op in ("xwT", "xwT_q8"):
        from repro_torch.kernels.demm_xwT import xwt_body_of
        scale_bytes = 4 * p.groups if p.quantized and p.group_scales else 0
        return xwt_body_of(p.rows, p.k, p.groups, ne, p.x_bytes, p.v_bytes,
                           scale_bytes, p.duplicates)
    if p.op in ("xwT_block", "xwT_block_q8"):
        from repro_torch.kernels.demm_block_spmm import cluster_fits
        return ("cluster" if cluster_fits(p.rows, m, p.block_r, ne,
                                          p.x_bytes, p.v_bytes, p.k)
                else "gather")
    from repro_torch.kernels.demm_spmm import TILED_MIN_CD, tiled_fits
    return ("tiled" if p.rows >= TILED_MIN_CD and tiled_fits(
        p.groups, ne, m, p.dtype == "bfloat16", p.rows * p.x_bytes,
        p.v_bytes) else "gather")


def cuda_param_space(p: Problem) -> Dict[str, Tuple[int, ...]]:
    """The tunables of the body :func:`cuda_body` names, with their
    candidate values."""
    body = cuda_body(p)
    if body == "bulk":
        rows = tuple(r for r in BULK_ROWS if r <= p.out) or (p.out,)
        space = {"rows_per_block": rows, "chunks": BULK_CHUNKS}
        if p.op == "xwT_q8":
            space["lanes"] = BULK_LANES
        return space
    if body == "cluster":
        return {"cluster_size": CLUSTER_SIZES}
    if body == "tiled":
        return {"tile_n": TC_TILE_N, "warpgroups": TC_WARPGROUPS,
                "stages": TC_STAGES}
    if p.op in ("xwT", "xwT_q8"):
        return {"rows_per_block": XWT_GATHER_ROWS}
    return {"rows_per_block": BLOCK_GATHER_ROWS}


def _on_cuda(p: Problem) -> bool:
    return p.platform == "cuda"


def _on_cpu(p: Problem) -> bool:
    return p.platform == "cpu"


def _register_builtin_variants():
    from repro_torch.kernels.demm_block_spmm import (demm_block_spmm,
                                                     demm_block_spmm_plain)
    from repro_torch.kernels.demm_q8 import (demm_block_spmm_q8,
                                             demm_block_spmm_q8_plain,
                                             demm_xwT_q8_on,
                                             demm_xwT_q8_plain)
    from repro_torch.kernels.demm_spmm import demm_spmm, demm_spmm_plain
    from repro_torch.kernels.demm_xwT import demm_xwT_on, demm_xwT_plain

    def tc_tile(params):
        """``tile_n`` / ``warpgroups`` -> the wrapper's ``tile``."""
        tile_n = params.pop("tile_n", None)
        wgs = params.pop("warpgroups", None)
        if tile_n is not None or wgs is not None:
            params["tile"] = (int(tile_n or 0), int(wgs or 0))
        return params

    def cuda(op, call, description):
        register_variant(KernelVariant(
            op=op, name="cuda", call=call, param_space=cuda_param_space,
            supported=_on_cuda, description=description))

    def reference(op, call, description):
        register_variant(KernelVariant(
            op=op, name="reference", call=call, supported=_on_cpu,
            description=description))

    reference("xwT", lambda x, values, indices, cfg, w_shape, **_:
              demm_xwT_plain(x, values, indices, cfg),
              "plain PyTorch scatter + float32 matmul")
    # the body left to the wrapper's chooser; ``chunks`` reaches the bulk
    # body only through the measurement hook
    cuda("xwT", lambda x, values, indices, cfg, w_shape, **params:
         demm_xwT_on(None, x, values, indices, cfg, **params),
         "hand-written CUDA kernel (csrc/demm_xwt.cu): the bulk row-tile "
         "body at serving batch, else the gather body")
    reference("xwT_q8",
              lambda x, values, indices, scales, cfg, w_shape, **_:
              demm_xwT_q8_plain(x, values, indices, scales, cfg),
              "plain PyTorch int8 scatter + scale + float32 matmul")
    cuda("xwT_q8", lambda x, values, indices, scales, cfg, w_shape, **params:
         demm_xwT_q8_on(None, x, values, indices, scales, cfg, **params),
         "hand-written CUDA kernel, int8 values dequantised in-register "
         "(csrc/demm_xwt_q8.cu) on K1's bodies")

    # The block ops serve y = (W_block @ xᵀ)ᵀ: xᵀ and the result's transpose
    # are views, so nothing is copied (demm_block_spmm.block_output).
    reference("xwT_block",
              lambda x, values, indices, ag, cfg, w_shape, **_:
              demm_block_spmm_plain(ag, values, indices, x.T, cfg,
                                    r=w_shape[0]).T,
              "plain PyTorch two-level scatter + float32 matmul")
    cuda("xwT_block", lambda x, values, indices, ag, cfg, w_shape, **params:
         demm_block_spmm(ag, values, indices, x.T, cfg, r=w_shape[0],
                         **params).T,
         "hand-written CUDA kernel reading the active-group address stream "
         "(csrc/demm_block_spmm.cu): the cluster body at serving batch, "
         "else the gather body")
    reference("xwT_block_q8",
              lambda x, values, indices, ag, scales, cfg, w_shape, **_:
              demm_block_spmm_q8_plain(ag, values, indices, scales, x.T, cfg,
                                       r=w_shape[0]).T,
              "plain PyTorch int8 two-level scatter + scale + float32 "
              "matmul")
    cuda("xwT_block_q8",
         lambda x, values, indices, ag, scales, cfg, w_shape, **params:
         demm_block_spmm_q8(ag, values, indices, scales, x.T, cfg,
                            r=w_shape[0], **params).T,
         "hand-written CUDA kernel, int8 values dequantised in-register: at "
         "serving batch a cluster of CTAs per row block with bulk copies in "
         "flight and a distributed shared-memory reduction "
         "(csrc/demm_block_cluster.cuh), else the gather body "
         "(csrc/demm_block_spmm_q8.cu)")
    reference("spmm", lambda values, indices, b, cfg, a_shape, **_:
              demm_spmm_plain(values, indices, b, cfg),
              "plain PyTorch scatter + float32 matmul")
    cuda("spmm", lambda values, indices, b, cfg, a_shape, **params:
         demm_spmm(values, indices, b, cfg, **tc_tile(dict(params))),
         "hand-written CUDA kernel: for a wide bf16 B the tiled tensor-core "
         "body, TMA-staged B tiles and wgmma on the scatter tile "
         "(csrc/demm_spmm_tc.cu); else the block-spmm gather body with the "
         "identity address stream (csrc/demm_block_spmm.cu)")

    def spmm_block_prepare(values, indices, b, cfg, a_shape, *, block_r=128,
                           duplicates=True, **params):
        """Host-side repack of the row-packed operands into the two-level
        block layout (``demm_block_spmm.pack_block_sparse``); returns the
        repacked operands (active groups, values, indices) on B's device and
        K2's launch over them."""
        import torch

        from repro_torch.core.sparsity import unpack
        from repro_torch.kernels.demm_block_spmm import pack_block_sparse

        r = int(a_shape[0])
        block_r = min(block_r, r)
        if r % block_r:
            raise ValueError(f"block_spmm needs r % block_r == 0, got "
                             f"{r} % {block_r}")
        dense = unpack(values, indices, cfg, tuple(a_shape)).cpu().numpy()
        ag, vals, idxs, _ = pack_block_sparse(dense, cfg, block_r=block_r)
        dev = b.device
        ops = (torch.from_numpy(ag).to(dev),
               torch.from_numpy(vals).to(dev, values.dtype),
               torch.from_numpy(idxs).to(dev))
        return ops, lambda a, v, i: demm_block_spmm(
            a, v, i, b, cfg, r=r, duplicates=duplicates, **params)

    def spmm_block_rows(p: Problem):
        return tuple(c for c in (8, 16, 32, 64, 128, 256)
                     if c <= p.out and p.out % c == 0) or (p.out,)

    register_variant(KernelVariant(
        op="spmm", name="block_spmm",
        call=lambda *a, **kw: (lambda ops, launch: launch(*ops))(
            *spmm_block_prepare(*a, **kw)),
        prepare=spmm_block_prepare,
        param_space=lambda p: {"block_r": spmm_block_rows(p)},
        default_params=lambda p: {"block_r": max(
            (c for c in spmm_block_rows(p) if c <= 128), default=p.out)},
        measure_only=True,
        description="two-level block kernel K2 after a host repack of the "
                    "flat spmm packing (measured, never dispatched; "
                    "ahead-of-time conversion dispatches through the "
                    "xwT_block op instead)"))


_register_builtin_variants()
