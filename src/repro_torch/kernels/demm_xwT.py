"""The packed serving matmul ``y = x @ W_sparseᵀ``: CUDA kernel wrapper and
its plain PyTorch version.

Replaces the TPU kernel ``demm_xwT_pallas`` (``kernels/demm_spmm.py`` of the
JAX package).  The CUDA source is ``csrc/demm_xwt.cu``; on an H100 the work
at decode batch sizes is one pass over the packed bytes, so device-memory
bandwidth bounds it.  Two bodies, picked by :func:`xwt_body`:

* ``bulk`` (``csrc/demm_xwt_bulk.cuh``) at serving batch (Bx <= 8): about
  one CTA per SM, each owning a tile of consecutive output rows whose values
  and indices — one contiguous span each — it requests with bulk copies at
  entry, x staged once per CTA with 16-byte loads while the copies are in
  flight;
* ``gather`` (``csrc/demm_xwt_common.cuh``) otherwise: many small blocks,
  each staging its x tile in shared memory, warps striding over a row's
  ``{value, index}`` pairs, coalesced.

Semantics shared by both bodies and :func:`demm_xwT_plain` (those of the TPU
kernel's scatter matrix):

* ``y[b, o] = Σ_g Σ_t S[o, g, t] · x[b, g·M + t]`` with ``S[o, g, t]`` the
  packed values of group ``g`` at local column ``t``, rounded to the
  activation dtype — slots that share an index summed in that dtype, in slot
  order, rounded after each add (:func:`scatter_groups`); a padded slot
  (value 0 at index 0) adds 0;
* products and sums are float32, the output is float32 whatever the inputs
  (the caller casts back);
* ragged shapes are masked inside the kernel; nothing is padded.

``pack`` never puts two non-zero slots of a group at one index, so the main
path tells the kernel (``duplicates=False``) and skips the summing search; a
call that does not say so gets the instantiation that sums, which is always
right.

A draft tier (``core.sparsity.narrow_tier``) hands the wrappers the prefix
view ``[..., :t]`` of the stored ``(O, G, Ne)`` tensors: :func:`prefix_pitch`
reads the stored pitch from its strides and the kernels read the first ``t``
slots of every group in place; nothing is copied.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sparsity import SparsityConfig

# dtype codes of the C interface (csrc/demm_xwt_common.cuh, enum DType)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_ERRORS = {-1: "unsupported dtype",
           -2: "inconsistent shapes (or more than 65535 x 8 activation rows)",
           -3: "one M-group of the activation tile exceeds the shared "
               "memory a block may use",
           -4: "cuTensorMapEncodeTiled refused a tensor map (B, values or "
               "indices)"}

def prefix_pitch(t: torch.Tensor, name: str = "operand") -> int:
    """The slots stored per group of a packed operand ``(..., Ne)``: ``Ne``
    for a contiguous tensor, else ``P`` for the prefix view ``[..., :Ne]`` of
    a contiguous ``(..., P)`` tensor — strides those of the contiguous tensor
    with the last dim ``P >= Ne``, and its storage holding all ``P`` slots of
    every row, which the bulk copies read.  Raises on any other layout: the
    wrappers never copy an operand."""
    ne = t.shape[-1]
    if t.is_contiguous():
        return ne
    pitch = t.stride(-2) if t.ndim >= 2 else 0
    ok = t.ndim >= 2 and pitch >= ne and (ne == 1 or t.stride(-1) == 1)
    want = pitch
    for d in range(t.ndim - 2, -1, -1):
        ok = ok and (t.shape[d] == 1 or t.stride(d) == want)
        want *= t.shape[d]
    rows = t.numel() // max(ne, 1)
    ok = ok and ((t.storage_offset() + rows * pitch) * t.element_size()
                 <= t.untyped_storage().nbytes())
    if not ok:
        raise ValueError(
            f"{name} {tuple(t.shape)} with strides {t.stride()} is neither "
            f"contiguous nor a prefix view [..., :n] of a contiguous tensor")
    return pitch


def check_xwT_args(x, values, indices, cfg: SparsityConfig, value_dtypes):
    """Shape/dtype/device/layout checks shared by the float and int8
    wrappers: x contiguous; values and indices contiguous, or prefix views of
    one stored pitch (a draft tier).  Returns (bx, k, o, g, ne, pitch)."""
    if x.ndim != 2 or values.ndim != 3:
        raise ValueError(f"expected x (Bx, K) and values (O, G, Ne), got "
                         f"{tuple(x.shape)} and {tuple(values.shape)}")
    bx, k = x.shape
    o, g, ne = values.shape
    if k != g * cfg.m or ne != cfg.n_effective:
        raise ValueError(
            f"x {tuple(x.shape)} / values {tuple(values.shape)} do not fit "
            f"the pattern {cfg.pattern_name()}: need K == G*M and "
            f"Ne == n_effective")
    if tuple(indices.shape) != tuple(values.shape):
        raise ValueError(f"indices {tuple(indices.shape)} do not match "
                         f"values {tuple(values.shape)}")
    if bx < 1:
        raise ValueError("x needs at least one row")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"activations must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if values.dtype not in value_dtypes:
        raise TypeError(f"packed values must be one of {value_dtypes}, got "
                        f"{values.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    for name, t in (("values", values), ("indices", indices)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    pitch = prefix_pitch(values, "values")
    if prefix_pitch(indices, "indices") != pitch:
        raise ValueError(f"values and indices are stored at different "
                         f"pitches: {values.stride()} vs {indices.stride()}")
    return bx, k, o, g, ne, pitch


class LaunchRefused(ValueError):
    """A launcher refused its arguments before launching (a negative code:
    a shape, dtype or tunable its kernel does not take).  Nothing ran; the
    CUDA context is intact."""


def raise_on_launch_error(code: int, kernel: str):
    """Raise for a launcher's return code: :class:`LaunchRefused` for its
    own refusals, ``RuntimeError`` for a CUDA error."""
    if code == 0:
        return
    if code < 0:
        raise LaunchRefused(f"{kernel}: {_ERRORS.get(code, code)}")
    raise RuntimeError(f"{kernel}: CUDA launch failed with error {code}")


def round_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round float32 ``t`` to ``dtype`` and back (no-op for float32)."""
    return t if dtype == torch.float32 else t.to(dtype).to(torch.float32)


def scatter_groups(values: torch.Tensor, indices: torch.Tensor, m: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """The scatter rows ``S (..., M)`` float32 of packed ``(..., Ne)``
    values/indices, in ``dtype``'s rounding: each value is rounded to
    ``dtype`` and slots that share an index are summed in ``dtype``, in slot
    order, rounding after each add — what the TPU kernel's scatter matrix
    holds.  Int8 values are exact in either dtype."""
    s = torch.zeros((*values.shape[:-1], m), dtype=torch.float32,
                    device=values.device)
    idx = indices.to(torch.int64)
    for n in range(values.shape[-1]):
        # one slot per group and step: no two adds meet in one element
        s.scatter_add_(-1, idx[..., n:n + 1],
                       values[..., n:n + 1].to(dtype).to(torch.float32))
        s = round_to(s, dtype)
    return s


def demm_xwT_plain(x: torch.Tensor, values: torch.Tensor,
                   indices: torch.Tensor, cfg: SparsityConfig) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the scatter rows in the
    activation dtype (:func:`scatter_groups`) form the dense (O, K) weight,
    then a float32 matmul.  Not a copy of ``ref.xwT_ref``, which keeps the
    values at full precision."""
    o, g, _ = values.shape
    w = scatter_groups(values, indices, cfg.m, x.dtype).reshape(o, g * cfg.m)
    return x.to(torch.float32) @ w.T


# The bulk body's limits (``csrc/demm_xwt_bulk.cuh``; a test holds the two
# equal): the widest activation tile, the bytes before the x tile, and the
# shared memory an H100 block may use.
BULK_MAX_BX = 8
BULK_HEAD_BYTES = 128
BULK_SMEM_BYTES = 232448


def _x_tile(bx: int) -> int:
    """The activation tile a launch of ``bx`` rows takes: the smallest of 1,
    2, 4, 8 that covers it."""
    return next(t for t in (1, 2, 4, 8) if bx <= t) if bx <= 8 else 8


def xwt_body_of(bx: int, k: int, g: int, ne: int, x_size: int,
                value_size: int, scale_bytes: int = 0,
                duplicates: bool = True) -> str:
    """:func:`xwt_body`'s rule on shapes and element sizes alone (operands
    taken 16-byte aligned): ``bx`` rows of x of ``x_size`` bytes each
    activation, ``g`` groups of ``ne`` pairs a row (the stored pitch: a
    tier view's rows are copied whole), values of
    ``value_size`` bytes, ``scale_bytes`` staged scales a row (K3's per-group
    scales, ``4·G``; 0 otherwise).  The autotuner reads a problem's body
    here, without tensors."""
    pairs = g * ne
    tile = 8 if duplicates else _x_tile(bx)
    x_bytes = -(-k // 16) * 16 * tile * x_size  # K in whole 16-column blocks
    row_bytes = pairs * (value_size + 4) + scale_bytes
    fits = BULK_HEAD_BYTES + x_bytes + 2 * row_bytes <= BULK_SMEM_BYTES
    if (bx <= BULK_MAX_BX and (k * x_size) % 16 == 0
            and (pairs * value_size) % 16 == 0 and (pairs * 4) % 16 == 0
            and scale_bytes % 16 == 0 and fits):
        return "bulk"
    return "gather"


def xwt_body(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
             m: int, *, duplicates: bool = True,
             scales: Optional[torch.Tensor] = None) -> str:
    """Which CUDA body :func:`demm_xwT` (and, given the int8 kernel's
    ``scales``, ``demm_q8.demm_xwT_q8``) runs: ``"bulk"`` at serving batch —
    at most :data:`BULK_MAX_BX` rows of x; x's rows (K activations), a row's
    values and its indices (``G·Ne`` each) and a row's per-group scales
    (``G`` float32, staged beside its pairs; per-row scales are not staged)
    16-byte multiples; every array the bulk copies read 16-byte aligned; and
    the transposed x tile (the widest tile with ``duplicates``) beside two
    rows of pairs and their staged scales within a block's shared memory —
    ``"gather"`` otherwise.  This is the one statement of the rule
    (:func:`xwt_body_of` on the shapes, a tier view's at its stored pitch):
    the CUDA launchers only refuse what the bulk body cannot take."""
    bx, k = x.shape
    g, ne = values.shape[1], prefix_pitch(values, "values")
    staged = [] if scales is None or scales.ndim == 1 else [scales]
    body = xwt_body_of(bx, k, g, ne, x.element_size(), values.element_size(),
                       4 * g if staged else 0, duplicates)
    if body == "bulk" and all(t.data_ptr() % 16 == 0
                              for t in (x, values, indices, *staged)):
        return "bulk"
    return "gather"


def demm_xwT(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
             cfg: SparsityConfig, *, duplicates: bool = True,
             rows_per_block: Optional[int] = None) -> torch.Tensor:
    """y (Bx, O) float32 = x (Bx, K) @ W_sparseᵀ, W packed (O, G, Ne).

    A CUDA tensor launches the hand-written kernel (building the library at
    first use; the body :func:`xwt_body` names) or raises; a CPU tensor takes
    :func:`demm_xwT_plain`, and only because it lies on the CPU.  ``values``
    and ``indices`` may be a draft tier's prefix view (:func:`prefix_pitch`),
    read in place.
    ``duplicates=False`` promises that no group holds two non-zero slots at
    one index (``PackedWeight.has_duplicates``) and launches the kernel
    without its summing search.  ``rows_per_block`` (output rows per thread
    block of either body) is the kernel's tunable; left open, the launcher
    sizes it to the card.
    """
    return demm_xwT_on(None, x, values, indices, cfg, duplicates=duplicates,
                       rows_per_block=rows_per_block)


def demm_xwT_on(body: Optional[str], x: torch.Tensor, values: torch.Tensor,
                indices: torch.Tensor, cfg: SparsityConfig, *,
                duplicates: bool = True,
                rows_per_block: Optional[int] = None,
                chunks: Optional[int] = None) -> torch.Tensor:
    """:func:`demm_xwT` on a named body (``"bulk"``, only where
    :func:`xwt_body` picks it, or ``"gather"``; ``None``: the chosen one) and
    the bulk body's ``chunks`` (row chunks per CTA, each with its own
    barrier; left open, the whole tile, or a ring where it does not fit) —
    a measurement hook for timing one body against the other and the chunk
    counts (``chip_smoke.py --sweep``), not a serving entry point.  A launch
    counts on ``demm_xwT.launches``."""
    bx, k, o, g, ne, pitch = check_xwT_args(x, values, indices, cfg,
                                            (torch.float32, torch.bfloat16))
    chosen = xwt_body(x, values, indices, cfg.m, duplicates=duplicates)
    if body not in (None, "bulk", "gather"):
        raise ValueError(f"body must be 'bulk' or 'gather', got {body!r}")
    if body == "bulk" and chosen != "bulk":
        raise ValueError("the bulk body does not take these arguments "
                         "(xwt_body)")
    if not x.is_cuda:
        return demm_xwT_plain(x, values, indices, cfg)
    from repro_torch.kernels._build import load_library

    lib = load_library()
    y = torch.empty((bx, o), dtype=torch.float32, device=x.device)
    code = lib.demm_xwt_launch(
        x.data_ptr(), values.data_ptr(), indices.data_ptr(), y.data_ptr(),
        bx, k, o, g, cfg.m, ne, pitch, _DTYPE_CODE[x.dtype],
        _DTYPE_CODE[values.dtype], int(bool(duplicates)),
        int(rows_per_block or 0), int((body or chosen) == "bulk"),
        int(chunks or 0),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_launch_error(code, "demm_xwt")
    demm_xwT.launches += 1
    demm_xwT.body_launches[body or chosen] += 1
    return y


demm_xwT.launches = 0     # kernel launches (not plain-version calls)
demm_xwT.body_launches = {"bulk": 0, "gather": 0}    # the same, by body
