"""The census of one rank's program: FLOPs, bytes, collectives and live
bytes of an eager step, counted as it runs on the meta device.

The JAX package lowers and compiles each cell and walks the partitioned
HLO (``launch/hlo_analysis.py``: while bodies weighted by their trip
counts).  The port has no HLO: a rank's step is eager PyTorch, so the
census runs the step itself, under :class:`Census` (a
``TorchDispatchMode``), on meta tensors of the rank's shapes, and counts
every op as it is dispatched.  A Python loop is unrolled as it runs, so the
counts are exact by construction and ``unknown_trip_loops`` is always 0.

How an op is counted:

* **FLOPs.**  The matmul family (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  convolutions, the fused attentions) by ``torch.utils.flop_counter``'s
  formulas (2 x multiply-adds), kept per calling function in
  ``dot_flops_by_name``; every other op that computes counts the element
  count of its result, as the JAX package's elementwise estimate of a
  fusion does.
* **Bytes.**  Operand plus result bytes of every op that computes.  Views
  and other aliasing metadata ops count nothing; a factory or fill writes
  its result only; an indexed read (``index``, ``index_select``,
  ``gather``, ``embedding``) moves what it returns twice (read, written)
  plus its indices, and an indexed write (``index_put_``, ``index_copy_``,
  ``scatter_``, ``index_add_``) its source twice plus its indices, not the
  whole destination.  Eager PyTorch launches each op as a kernel of its
  own, so this is the eager count; the JAX package's count of a fused TPU
  program (elementwise fusions: their result only) is lower, by the
  intermediates a fusion keeps on chip.
* **A packed matmul** (``kernels.ops.demm_matmul_packed``: the ``xwT``,
  ``xwT_q8``, ``xwT_block`` and ``xwT_block_q8`` ops) counts once, under
  ``demm/<op>``: 2 x Bx x (the packed values' element count, O x G x Ne in
  ``xwT``) FLOPs, the DeMM products; its packed values, indices, scales
  and active groups, x and the float32 y as bytes; and one launch in
  ``packed_launches``.  The ops of its plain version, which is what runs
  on the meta device, are not counted.
* **Collectives** come from the census mesh (``sharding.context.
  CensusMesh``), on which the rank's ``ShardingContext`` records each
  collective instead of running it: the JAX package's five kinds, an
  all-reduce at 2x its payload (ring weighting, as ``hlo_analysis``), and
  per calling function in ``collectives_by_name`` and per model function
  that led to it in ``collectives_by_site``.
* **Live bytes.**  ``peak_bytes`` is an estimate: the arguments plus the
  peak of the bytes of the tensors the step creates and still holds
  (tracked by weak references, freed when the last Python reference and
  every view of a tensor are gone).  It knows nothing of the caching
  allocator, of its rounding or fragmentation, or of a workspace a kernel
  takes.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")

_aten = torch.ops.aten
# ops that create or alias a tensor without moving its data
_NO_WORK = {_aten.detach, _aten.alias, _aten.empty, _aten.empty_strided,
            _aten.empty_like, _aten.new_empty, _aten.new_empty_strided,
            _aten._unsafe_view, _aten.lift_fresh, _aten.set_,
            _aten.resize_, _aten.sym_size, _aten.sym_stride,
            _aten.sym_numel, _aten.sym_storage_offset, _aten.is_same_size,
            _aten._local_scalar_dense, _aten.record_stream}
_INDEXED_READS = {_aten.index, _aten.index_select, _aten.gather,
                  _aten.embedding, _aten.take_along_dim}
_INDEXED_WRITES = {_aten.index_put_, _aten._index_put_impl_,
                   _aten.index_put, _aten.index_copy_, _aten.index_copy,
                   _aten.scatter_, _aten.scatter, _aten.scatter_add_,
                   _aten.scatter_add, _aten.index_add_, _aten.index_add,
                   _aten.index_fill_, _aten.index_fill}
_FILLS = {_aten.fill_, _aten.zero_, _aten.fill, _aten.zeros, _aten.ones,
          _aten.full, _aten.arange, _aten.zeros_like, _aten.ones_like,
          _aten.full_like, _aten.new_zeros, _aten.new_ones, _aten.new_full,
          _aten.scalar_tensor, _aten.randn, _aten.rand, _aten.randint,
          _aten.normal_, _aten.uniform_}


def _tensors(tree):
    """The tensors in ``tree`` (nested lists, tuples and dicts; a module's
    parameters and buffers)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def tree_bytes(tree) -> int:
    """The bytes of the distinct tensors in ``tree`` (a module's tensors,
    dicts and lists of tensors), each storage counted once."""
    seen, total = set(), 0
    for t in _tensors(tree):
        key = id(t) if t.device.type == "meta" else (
            t.device, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
        if key in seen:
            continue
        seen.add(key)
        total += t.numel() * t.element_size()
    return total


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _caller(skip=("census.py",)) -> str:
    """The nearest calling function in the port's code, outside this
    module and torch."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if "repro_torch" in path and not path.endswith(skip):
            return f.f_code.co_qualname
        f = f.f_back
    return "?"


@dataclasses.dataclass
class Analysis:
    """The census of one step: the JAX package's ``hlo_analysis.Analysis``
    fields (``to_dict`` gives its keys) and the port's own."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: dict = dataclasses.field(
        default_factory=lambda: {k: {"count": 0, "bytes": 0}
                                 for k in COLL_KINDS})
    # eager code has no loop of unknown trip count: always 0
    unknown_trip_loops: int = 0
    dot_flops_by_name: dict = dataclasses.field(default_factory=dict)
    bytes_by_opcode: dict = dataclasses.field(default_factory=dict)
    collectives_by_name: dict = dataclasses.field(default_factory=dict)
    # by the model function that led to each (``apply_mamba2_step``, ...)
    collectives_by_site: dict = dataclasses.field(default_factory=dict)
    packed_launches: dict = dataclasses.field(default_factory=dict)
    ops: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_live_bytes: int = 0

    @property
    def collective_bytes(self) -> float:
        return sum(v["bytes"] for v in self.collectives.values())

    @property
    def matmul_flops(self) -> float:
        """FLOPs of the matmul family and the packed matmuls."""
        return sum(self.dot_flops_by_name.values())

    @property
    def peak_bytes(self) -> int:
        return self.argument_bytes + self.peak_live_bytes

    def to_dict(self):
        d = {k: {"count": v["count"], "bytes": v["bytes"]}
             for k, v in self.collectives.items()}
        d["total_bytes"] = self.collective_bytes
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "collectives": d,
                "unknown_trip_loops": self.unknown_trip_loops}


class Census(TorchDispatchMode):
    """Counts every op dispatched inside it into :attr:`analysis` (see the
    module docstring), and every packed matmul as one op.  ``mesh``: the
    census mesh whose recorded collectives the analysis takes, those
    recorded while the census is active."""

    def __init__(self, mesh=None):
        super().__init__()
        self.analysis = Analysis()
        self.mesh = mesh
        self._quiet = 0
        self._live = 0
        self._n_records = 0

    # -- the mode -----------------------------------------------------------

    def __enter__(self):
        from repro_torch.kernels import ops

        self._prev_observer = ops.MATMUL_OBSERVER
        ops.MATMUL_OBSERVER = self._packed
        if self.mesh is not None:
            self._n_records = len(self.mesh.records)
        self._t0 = time.perf_counter()
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.MATMUL_OBSERVER = self._prev_observer
        self.seconds = time.perf_counter() - self._t0
        if self.mesh is not None:
            for rec in self.mesh.records[self._n_records:]:
                self._collective(*rec)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        packet = func.overloadpacket
        if func.is_view or packet in _NO_WORK:
            return out
        a = self.analysis
        a.ops += 1
        results = list(_tensors(out))
        operands = list(_tensors(args)) + list(_tensors(kwargs))
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            key = f"{packet.__name__}@{_caller()}"
            a.dot_flops_by_name[key] = a.dot_flops_by_name.get(key, 0.0) + f
        else:
            f = float(sum(t.numel() for t in results))
        a.flops += f
        nb = self._op_bytes(func, packet, args, operands, results)
        a.bytes_accessed += nb
        name = packet.__name__
        a.bytes_by_opcode[name] = a.bytes_by_opcode.get(name, 0.0) + nb
        self._track(results, operands)
        return out

    def _op_bytes(self, func, packet, args, operands, results) -> float:
        if packet in _FILLS:
            return float(sum(_nbytes(t) for t in results))
        if packet in _INDEXED_READS:
            idx = [t for t in operands[1:]]
            return float(2 * sum(_nbytes(t) for t in results)
                         + sum(_nbytes(t) for t in idx))
        if packet in _INDEXED_WRITES:
            dst = operands[0]
            rest = [t for t in operands[1:] if t is not dst]
            return float(2 * sum(_nbytes(t) for t in rest))
        if packet is _aten.copy_:
            return float(sum(_nbytes(t) for t in operands))
        return float(sum(_nbytes(t) for t in operands)
                     + sum(_nbytes(t) for t in results))

    def _track(self, results, operands):
        """Count the fresh tensors among ``results`` as live until their
        last reference (a view's included) is gone."""
        ids = {id(t) for t in operands}
        for t in results:
            if id(t) in ids or t._is_view():
                continue
            n = _nbytes(t)
            if not n:
                continue
            self._add_live(n)
            weakref.finalize(t, self._add_live, -n)

    def _add_live(self, n: int):
        self._live += n
        if self._live > self.analysis.peak_live_bytes:
            self.analysis.peak_live_bytes = self._live

    # -- packed matmuls and collectives -------------------------------------

    def _packed(self, op: str, x, pw, run):
        """``kernels.ops.MATMUL_OBSERVER``: one op of the DeMM products and
        the packed stream's bytes; nothing of the plain version run."""
        self._quiet += 1
        try:
            y = run()
        finally:
            self._quiet -= 1
        a = self.analysis
        bx = x.numel() // x.shape[-1]
        f = 2.0 * bx * pw.values.numel()
        packed = [t for t in (pw.values, pw.indices, pw.scales,
                              pw.active_groups) if t is not None]
        nb = float(sum(_nbytes(t) for t in packed) + _nbytes(x)
                   + bx * pw.dense_shape[0] * 4)
        key = f"demm/{op}"
        a.ops += 1
        a.flops += f
        a.dot_flops_by_name[key] = a.dot_flops_by_name.get(key, 0.0) + f
        a.bytes_accessed += nb
        a.bytes_by_opcode[key] = a.bytes_by_opcode.get(key, 0.0) + nb
        a.packed_launches[op] = a.packed_launches.get(op, 0) + 1
        self._track([y], [x])
        return y

    def _collective(self, kind: str, nbytes: int, name: str, site: str):
        a = self.analysis
        w = 2 if kind == "all-reduce" else 1
        a.collectives[kind]["count"] += 1
        a.collectives[kind]["bytes"] += nbytes * w
        for by, key in ((a.collectives_by_name, name),
                        (a.collectives_by_site, site)):
            e = by.setdefault(f"{kind}:{key}", {"count": 0, "bytes": 0})
            e["count"] += 1
            e["bytes"] += nbytes * w


def run(fn, *args, mesh=None, arguments=None, **kwargs):
    """``fn(*args, **kwargs)`` under a :class:`Census`; returns (its result,
    the :class:`Analysis`, seconds).  ``arguments`` (default ``args``): the
    tree whose bytes are the step's ``argument_bytes``; the result's
    tensors are its ``output_bytes``."""
    with Census(mesh) as c:
        out = fn(*args, **kwargs)
    a = c.analysis
    a.argument_bytes = tree_bytes(args if arguments is None else arguments)
    a.output_bytes = tree_bytes(out)
    return out, a, c.seconds
