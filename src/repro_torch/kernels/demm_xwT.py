"""The packed serving matmul ``y = x @ W_sparseᵀ``: CUDA kernel wrapper and
its plain PyTorch version.

Replaces the TPU kernel ``demm_xwT_pallas`` (``kernels/demm_spmm.py`` of the
JAX package).  The CUDA source is ``csrc/demm_xwt.cu``; on an H100 the work
at decode batch sizes is one pass over the packed bytes, so device-memory
bandwidth bounds it.  Three bodies, picked by :func:`xwt_body`:

* ``bulk`` (``csrc/demm_xwt_bulk.cuh``) at serving batch (Bx <= 8): about
  one CTA per SM, each owning a tile of consecutive output rows whose values
  and indices — one contiguous span each — it requests with bulk copies at
  entry, x staged once per CTA with 16-byte loads while the copies are in
  flight;
* ``wide`` (``csrc/demm_xwt_wide.cuh``) at wider bfloat16 x (Bx > 8: every
  prefill chunk, whole-sequence prefill, the packed training forward):
  about one CTA per SM, each decoding its rows' pairs once into shared
  memory and walking x's row tiles of 32-128 rows over them, x staged in
  chunks of groups;
* ``gather`` (``csrc/demm_xwt_common.cuh``) otherwise (float32 x, shapes
  the others refuse): many small blocks, each staging its x tile in shared
  memory, warps striding over a row's ``{value, index}`` pairs, coalesced.

Semantics shared by the bodies and :func:`demm_xwT_plain` (those of the TPU
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
# The wide body's (``csrc/demm_xwt_wide.cuh``; the same test): the fewest x
# rows, the x tile and its columns a chunk of groups may hold (one 8 x 8
# block per thread), its threads, the x rows a lane holds, the items (and
# rows) of a CTA, the most parts a row's pairs are split in, the most CTAs
# along x's tiles and along K (a cluster), the widest K an entry's 16-bit
# column reaches, the bytes before the entries (the pairs' mbarrier).
WIDE_MIN_BX = 9
WIDE_CHUNK_ELEMS = 32768
WIDE_THREADS = 512
WIDE_LANE_ROWS = 8
WIDE_MAX_ITEMS = 128
WIDE_MAX_PARTS = 8
WIDE_MAX_XSPLIT = 4
WIDE_MAX_SPLIT = 2
WIDE_MAX_K = 65536
WIDE_HEAD_BYTES = 16
WIDE_TILES = (32, 64, 128)


def _x_tile(bx: int) -> int:
    """The activation tile a launch of ``bx`` rows takes: the smallest of 1,
    2, 4, 8 that covers it."""
    return next(t for t in (1, 2, 4, 8) if bx <= t) if bx <= 8 else 8


def wide_tile(bx: int) -> int:
    """The wide body's x tile for ``bx`` rows (``wide_auto_tile``): the
    smallest of 32, 64, 128 that covers them, 128 beyond."""
    return next((t for t in WIDE_TILES if bx <= t), WIDE_TILES[-1])


def wide_slots(tile: int) -> int:
    """Item slots of a CTA at an x tile of ``tile`` rows (``wide_slots``):
    ``tile / 8`` lanes an item."""
    return WIDE_THREADS * WIDE_LANE_ROWS // tile


def wide_parts(rows: int, tile: int) -> int:
    """Items per row of a CTA of ``rows`` rows (``wide_parts``): the count
    in 1..8 whose items fill the item slots' passes best, fewer on a tie,
    at most 128 items."""
    nslots = wide_slots(tile)
    best, best_frac = 1, (0, 1)
    for p in range(1, WIDE_MAX_PARTS + 1):
        items = rows * p
        if items > WIDE_MAX_ITEMS:
            break
        slots = -(-items // nslots) * nslots
        if items * best_frac[1] > best_frac[0] * slots:
            best, best_frac = p, (items, slots)
    return best


def _window(nbytes: int) -> int:
    """The 16-byte-aligned window that holds any ``nbytes`` consecutive
    bytes (``wide_window``)."""
    return (-(-nbytes // 16) + 1) * 16


def _row_scales(scale_cols: int, groups: int) -> int:
    return 0 if scale_cols == 0 else 1 if scale_cols == 1 else groups


def wide_raw_row_bytes(lr: int, value_size: int, nscales: int) -> int:
    """One row's copied windows: ``lr`` indices, ``lr`` values of
    ``value_size`` bytes and ``nscales`` scales (``wide_raw_row_bytes``)."""
    return (_window(lr * 4) + _window(lr * value_size)
            + (_window(nscales * 4) if nscales else 0))


def _wide_fixed_bytes(tile: int, rows: int, split: int, gn: int) -> int:
    """The pairs' mbarrier, the entries (4 bytes a read slot, an odd count
    a row, rounded to 16) and the cluster's inbox (half the rows' sums,
    rounded to 16)."""
    dec = -(-rows * (gn | 1) * 4 // 16) * 16
    inbox = -(-((rows + 1) // 2) * (tile + 1) * 4 // 16) * 16 if split > 1 \
        else 0
    return WIDE_HEAD_BYTES + dec + inbox


def wide_smem_bytes(tile: int, rows: int, parts: int, split: int, gn: int,
                    cols: int, raw_row: int) -> int:
    """Dynamic shared memory of a wide launch at the least room
    (``wide_smem_bytes``): the mbarrier, the entries and the cluster's
    inbox, then a room for a round's pairs (at least one row's,
    ``raw_row``), two x stages of ``cols`` columns or the parts' sums,
    whichever is largest."""
    room = max(2 * cols * tile * 2, parts * rows * (tile + 1) * 4, raw_row)
    return _wide_fixed_bytes(tile, rows, split, gn) + room


def _wide_stage_plan(tile, rows, split, g, m, ne, pitch, value_size,
                     scale_cols, budget):
    """``wide_plan`` in the header: {parts, chunk_groups, batch_rows,
    smem}, or None."""
    if not (1 <= rows <= WIDE_MAX_ITEMS and 1 <= split <= WIDE_MAX_SPLIT
            and split <= g):
        return None
    gmax = -(-g // split)
    gn = gmax * ne
    parts = wide_parts(rows, tile)
    cg = min(WIDE_CHUNK_ELEMS // (tile * m), gmax)
    raw_row = wide_raw_row_bytes(gmax * pitch, value_size,
                                 _row_scales(scale_cols, gmax))
    while cg >= 1 and wide_smem_bytes(tile, rows, parts, split, gn, cg * m,
                                      raw_row) > budget:
        cg -= 1
    if cg < 1:
        return None
    fixed = _wide_fixed_bytes(tile, rows, split, gn)
    room = wide_smem_bytes(tile, rows, parts, split, gn, cg * m,
                           raw_row) - fixed
    if room < raw_row * rows:
        room = min(raw_row * rows, (budget - fixed) & ~15)
    return {"parts": parts, "chunk_groups": cg,
            "batch_rows": min(room // raw_row, rows), "smem": fixed + room}


def wide_plan(bx: int, o: int, g: int, m: int, ne: int, *,
              pitch: Optional[int] = None, value_size: int = 4,
              scale_cols: int = 0, tile: int = 0, rows: int = 0,
              sms: int = 132,
              budget: int = BULK_SMEM_BYTES) -> Optional[dict]:
    """The wide launcher's plan (``wide_auto_grid`` and ``wide_plan``) on a
    card of ``sms`` SMs and ``budget`` bytes of shared memory a block, for
    values of ``value_size`` bytes and K3's ``scale_cols`` (1 per row, G
    per group; 0 for K1): rows per CTA, CTAs along K (``split``, a
    cluster) and along x, parts, groups per chunk, rows per decode round
    and the shared memory; None where it refuses.  ``tile`` / ``rows``: the
    tunables (0: left open; given rows, no cluster).  The autotuner counts
    shared memory with it."""
    tile = tile or wide_tile(bx)
    pitch = pitch or ne
    xs_top = min(-(-bx // tile), WIDE_MAX_XSPLIT)
    sp_top = min(g, WIDE_MAX_SPLIT)

    def plan(r, split, xsplit):
        st = _wide_stage_plan(tile, r, split, g, m, ne, pitch, value_size,
                              scale_cols, budget)
        return st and {**st, "rows": r, "split": split, "xsplit": xsplit,
                       "tile": tile}

    rows = min(rows, o)
    if rows > 0:
        return plan(rows, 1, min(max(sms // -(-o // rows), 1), xs_top))
    for prod in range(xs_top * sp_top, 0, -1):
        for sp in range(1, sp_top + 1):
            if prod % sp or prod // sp > xs_top:
                continue
            found = plan(max(min(-(-o * prod // sms), o), 1), sp, prod // sp)
            if found:
                return found
    r = min(-(-o // sms), WIDE_MAX_ITEMS)
    while r > 1 and plan(r, 1, 1) is None:
        r = -(-r // 2)
    return plan(r, 1, 1)


def wide_fits(bx: int, k: int, g: int, ne: int, x_size: int,
              value_size: int = 4, scale_cols: int = 0) -> bool:
    """The wide body's shape rule (``wide_takes`` and ``wide_plan`` at one
    row): bfloat16 x of more than 8 rows, x's rows and each group (M
    columns) 16-byte multiples, K within an entry's 16-bit column, one
    group of the x tile within a chunk, and one row's entries, copied pairs
    and two one-group x stages within a block's shared memory."""
    m = k // g
    tile = wide_tile(bx)
    return (x_size == 2 and bx >= WIDE_MIN_BX and k % 8 == 0 and m % 8 == 0
            and k <= WIDE_MAX_K and tile * m <= WIDE_CHUNK_ELEMS
            and _wide_stage_plan(tile, 1, 1, g, m, ne, ne, value_size,
                                 scale_cols, BULK_SMEM_BYTES) is not None)


def xwt_body_of(bx: int, k: int, g: int, ne: int, x_size: int,
                value_size: int, scale_bytes: int = 0,
                duplicates: bool = True) -> str:
    """:func:`xwt_body`'s rule on shapes and element sizes alone (operands
    taken 16-byte aligned): ``bx`` rows of x of ``x_size`` bytes each
    activation, ``g`` groups of ``ne`` pairs a row (the stored pitch: a
    tier view's rows are copied whole by the bulk body; the wide body
    decodes only the read slots, so the stored pitch is the larger count),
    values of ``value_size`` bytes, ``scale_bytes`` staged scales a row
    (K3's per-group scales, ``4·G``; 0 otherwise).  The autotuner reads a
    problem's body here, without tensors."""
    pairs = g * ne
    tile = 8 if duplicates else _x_tile(bx)
    x_bytes = -(-k // 16) * 16 * tile * x_size  # K in whole 16-column blocks
    row_bytes = pairs * (value_size + 4) + scale_bytes
    fits = BULK_HEAD_BYTES + x_bytes + 2 * row_bytes <= BULK_SMEM_BYTES
    if (bx <= BULK_MAX_BX and (k * x_size) % 16 == 0
            and (pairs * value_size) % 16 == 0 and (pairs * 4) % 16 == 0
            and scale_bytes % 16 == 0 and fits):
        return "bulk"
    if wide_fits(bx, k, g, ne, x_size, value_size,
                 g if scale_bytes else 1 if value_size == 1 else 0):
        return "wide"
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
    else ``"wide"`` for bfloat16 x of more than 8 rows whose rows and groups
    are 16-byte multiples, x 16-byte aligned, where one row's decoded pairs
    fit beside two one-group x stages (:func:`wide_fits`; the pairs and
    scales are read element by element, so no rule on them) — else
    ``"gather"``.  This is the one statement of the rule
    (:func:`xwt_body_of` on the shapes, a tier view's at its stored pitch):
    the CUDA launchers only refuse what their bodies cannot take."""
    bx, k = x.shape
    g, ne = values.shape[1], prefix_pitch(values, "values")
    staged = [] if scales is None or scales.ndim == 1 else [scales]
    body = xwt_body_of(bx, k, g, ne, x.element_size(), values.element_size(),
                       4 * g if staged else 0, duplicates)
    if body == "bulk" and all(t.data_ptr() % 16 == 0
                              for t in (x, values, indices, *staged)):
        return "bulk"
    if body == "wide" and x.data_ptr() % 16 == 0:
        return "wide"
    return "gather"


# the C launchers' body codes
BODY_CODE = {"gather": 0, "bulk": 1, "wide": 2}


def check_body(body: Optional[str], chosen: str) -> None:
    """A named body (the measurement hooks' ``body``) must be one the
    launchers know, and ``bulk`` / ``wide`` only where :func:`xwt_body`
    picks them; ``gather`` takes anything."""
    if body not in (None, *BODY_CODE):
        raise ValueError(f"body must be 'bulk', 'wide' or 'gather', got "
                         f"{body!r}")
    if body in ("bulk", "wide") and chosen != body:
        raise ValueError(f"the {body} body does not take these arguments "
                         "(xwt_body)")


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
    block of any body) is the kernel's tunable; left open, the launcher
    sizes it to the card.
    """
    return demm_xwT_on(None, x, values, indices, cfg, duplicates=duplicates,
                       rows_per_block=rows_per_block)


def demm_xwT_on(body: Optional[str], x: torch.Tensor, values: torch.Tensor,
                indices: torch.Tensor, cfg: SparsityConfig, *,
                duplicates: bool = True,
                rows_per_block: Optional[int] = None,
                chunks: Optional[int] = None,
                tile: Optional[int] = None) -> torch.Tensor:
    """:func:`demm_xwT` on a named body (``"bulk"`` or ``"wide"``, only
    where :func:`xwt_body` picks it, or ``"gather"``; ``None``: the chosen
    one), the bulk body's ``chunks`` (row chunks per CTA, each with its own
    barrier; left open, the whole tile, or a ring where it does not fit) and
    the wide body's ``tile`` (x rows per tile, 32, 64 or 128; left open,
    :func:`wide_tile`) — a measurement hook for timing one body against the
    other and the tunables (``chip_smoke.py --sweep``), and the tuner's way
    to a tunable, not a serving entry point.  A launch counts on
    ``demm_xwT.launches``."""
    bx, k, o, g, ne, pitch = check_xwT_args(x, values, indices, cfg,
                                            (torch.float32, torch.bfloat16))
    chosen = xwt_body(x, values, indices, cfg.m, duplicates=duplicates)
    check_body(body, chosen)
    if tile not in (None, *WIDE_TILES):
        raise ValueError(f"tile must be one of {WIDE_TILES}, got {tile!r}")
    if not x.is_cuda:
        return demm_xwT_plain(x, values, indices, cfg)
    from repro_torch.kernels._build import load_library

    lib = load_library()
    y = torch.empty((bx, o), dtype=torch.float32, device=x.device)
    code = lib.demm_xwt_launch(
        x.data_ptr(), values.data_ptr(), indices.data_ptr(), y.data_ptr(),
        bx, k, o, g, cfg.m, ne, pitch, _DTYPE_CODE[x.dtype],
        _DTYPE_CODE[values.dtype], int(bool(duplicates)),
        int(rows_per_block or 0), BODY_CODE[body or chosen],
        int(chunks or 0), int(tile or 0),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_launch_error(code, "demm_xwt")
    demm_xwT.launches += 1
    demm_xwT.body_launches[body or chosen] += 1
    return y


demm_xwT.launches = 0     # kernel launches (not plain-version calls)
demm_xwT.body_launches = {"bulk": 0, "wide": 0, "gather": 0}  # the same, by body
