"""Counted cost of one step on fake tensors: the counterpart of
``repro/launch/hlo_cost.py``, without an HLO.

``count(cell)`` runs a cell's step (``launch/steps.py``) under its
``FakeTensorMode`` with :class:`CostMode` on top, a ``TorchDispatchMode``
that sees every operator the step dispatches, autograd's backward and the
recomputed forward under remat included, and counts:

* FLOPs: 2·M·N·K for each product of the matmul family (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``; ``matmul``, ``linear`` and ``einsum`` reach the
  dispatcher as these), split by the operands' dtype, since each dtype has
  its own peak (``launch/mesh.py``).
* Bytes: each operator that launches a kernel reads each input once and
  writes each output once; views, reshapes and metadata are free.  Eager
  PyTorch runs one kernel an operator, so this is the eager program's HBM
  traffic, the counterpart of ``hlo_cost``'s post-fusion bytes.  Gathers
  (``index``, ``index_select``, ``gather``, ``embedding``) read the rows
  they fetch, not the whole table; in-place scatters (``index_put_``,
  ``index_add_``, ``scatter_``, ...) write their values, and ``copy_``,
  ``fill_`` and ``zero_`` do not read their destination.  An expanded
  input (stride 0) counts its distinct elements.
* Flash attention, counted by the function and not by a route's design:
  the (query, key) pairs that the causal mask and the window keep, for
  each query head; 4·hd FLOPs a pair forward (QKᵀ and P·V) and 10·hd
  backward (QKᵀ recomputed, dO·Vᵀ, dV, dQ, dK); bytes by the rule above
  (q, k, v, o, and L; in the backward also dO, dq, dk and dv).
* Peak: the most live bytes over the run, the arguments (the state, the
  cache) included: each storage counts from the operator that allocates it
  to the moment it dies (a weak reference's callback), as the caching
  allocator's ``max_memory_allocated`` sees it, before its rounding.

A host read inside the step (``.item()``, a Python ``if`` on a tensor, a
shape that depends on data) has no value under fake tensors: it raises
:class:`HostRead`, and the dry run records the cell as failed.

**A sharded step** (a cell built on a ``DeviceMesh``: DTensor arguments
whose local shards are fake tensors of the cell's mode) is counted as
rank 0 runs it, not as the global program:

* ``CostMode`` defers every operator whose arguments hold a DTensor
  (``NotImplemented``): DTensor's own dispatch then runs the local
  operators on the local shards and issues its collectives, and those reach
  the mode.  A mode that counted the DTensor-level operator would count it
  at its global shape, and DTensor's collectives would not reach it.
* DTensor's sharding propagation runs an operator once on fake tensors of
  the global shapes, in a ``FakeTensorMode`` of its own, the first time it
  meets a signature (it caches the result), and its index arithmetic
  builds small tensors on the host and reads them back.  Where an
  operator has no sharding rule, the propagation traces its decomposition
  on plain meta tensors of the global shapes, once too.  The mode tells
  who issued an operator by the innermost frame on the stack that is the
  port's, DTensor's or torch's bookkeeping (:func:`_issuer`): it drops
  every operator of the propagation's modules (``_DTENSOR_PROPAGATION``,
  ``_ops``), and an operator that touches a fake tensor of another mode
  or, counting a fake step, a real tensor off the meta device where the
  index arithmetic's modules (``_DTENSOR_INDEX``) or torch's bookkeeping
  (``torch.utils.checkpoint``'s RNG state) issued it.  The local operators
  and collectives that DTensor runs are counted.  Any other operator on
  such a tensor is the step's own and raises :class:`HostRead`, as a read
  of its value would.  So two counts of one cell agree, and no operator
  of the step is dropped unseen.
* The step runs with no ambient ``FakeTensorMode``: under one, DTensor's
  index arithmetic for a dimension split over two mesh dimensions reads a
  fake tensor's value (``.tolist()``) and fails.  Tensors that the step
  makes from nothing (positions, masks) are then plain meta tensors, which
  the fake shards take as they are.
* Each functional collective is recorded (:class:`Collective`): the op
  under the reference's name, the group's size and ranks, and the operand
  bytes, those of the input (the reference's rule recovers the same number
  from the result: an all-gather's result over g, a reduce-scatter's times
  g, the others' result as it is).  ``wait_tensor`` and
  ``_wrap_tensor_autograd`` are not collectives.  A collective also counts
  its input and output bytes, as any operator.

The count is rank 0's.  DTensor splits an uneven dimension ceiling-first
(``torch.chunk``: 6 heads over 4 ranks are 2, 2, 2, 0), so rank 0 holds the
largest block of every dimension and its figures are the most loaded
rank's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import sys
import time
import weakref

import torch
from torch._subclasses.fake_tensor import (
    DataDependentOutputException,
    DynamicOutputShapeException,
    FakeTensor,
)
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.kernels.flash_attention  # noqa: F401  (registers the flash operators)

aten = torch.ops.aten
Tensor = torch.Tensor


class HostRead(RuntimeError):
    """The step reads a value or a shape back from the device."""


def attention_pairs(S: int, causal: bool = True, window: int = 0) -> int:
    """(query, key) pairs the flash function's mask keeps for one query
    head over S positions: all S² without the causal mask; with it, min(i +
    1, window) keys for query i (window 0: unbounded)."""
    if not causal:
        return S * S
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


_MM = {aten.mm.default: (0, 1), aten.addmm.default: (1, 2),
       aten.bmm.default: (0, 1), aten.baddbmm.default: (1, 2)}
_FREE = {aten.detach.default, aten._unsafe_view.default, aten.lift_fresh.default,
         aten.alias.default, aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten.sym_size.int, aten.sym_stride.int,
         aten.sym_numel.default, aten.sym_storage_offset.default,
         aten.is_same_size.default, aten.set_.source_Storage_storage_offset}
_GATHERS = {aten.index.Tensor, aten.index_select.default, aten.gather.default,
            aten.embedding.default}
_SCATTERS = {aten.index_put_.default, aten._index_put_impl_.default,
             aten.index_add_.default, aten.scatter_.src, aten.scatter_add_.default,
             aten.index_copy_.default, aten.scatter_.value}
_OVERWRITES = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
               aten.zero_.default}


# The flash operators and the FLOPs a kept pair costs in each.
_FLASH = {torch.ops.repro_torch.flash_attention.default: 4,
          torch.ops.repro_torch.flash_attention_lse.default: 4,
          torch.ops.repro_torch.flash_attention_bwd.default: 10}


def _dtype(t: Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _nbytes(t: Tensor) -> int:
    """Bytes of t's distinct elements (an expanded axis counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


# The functional collectives and the reference's names for them; the
# input is the operand.
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_out": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
    # DTensor's Shard -> Shard on a mesh that is not "cpu": one all-to-all
    "_dtensor.shard_dim_alltoall": "all-to-all",
}
_NOT_COLLECTIVES = {"_c10d_functional.wait_tensor",
                    "_c10d_functional._wrap_tensor_autograd"}

# Who issued an operator, by the innermost frame on the stack that is the
# port's, a module of DTensor's package or torch's bookkeeping.  DTensor's
# planning: its sharding propagation (on global fake tensors of its own
# mode, or, tracing a decomposition for its strategy, on plain meta tensors
# of the global shapes) and its index arithmetic and redistribution plans
# (on host tensors); the local operators that DTensor dispatches run from
# ``_dispatch.py``, its collectives from the last four modules.  torch's
# bookkeeping: the RNG state that ``torch.utils.checkpoint`` keeps for its
# recomputation (a host tensor)
_THIS = __file__
_PORT_DIR = os.path.join("repro_torch", "")
_DTENSOR_DIR = os.path.join("torch", "distributed", "tensor", "")
_DTENSOR_PROPAGATION = {"_sharding_prop.py", "_op_schema.py", "_decompositions.py"}
_DTENSOR_INDEX = {"_utils.py", "placement_types.py", "_redistribute.py",
                  "_collective_utils.py"}
_TORCH_BOOKKEEPING = (os.path.join("torch", "utils", "checkpoint.py"),
                      os.path.join("torch", "random.py"))


def _issuer() -> str | None:
    """The innermost frame on the stack, past this module's, that is the
    port's (``"step"``), a module of DTensor's package (its path in the
    package) or torch's bookkeeping (``"torch"``); None: none of them (a
    caller outside the port)."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if name != _THIS:
            i = name.rfind(_DTENSOR_DIR)
            if i >= 0:
                return name[i + len(_DTENSOR_DIR):]
            if name.endswith(_TORCH_BOOKKEEPING):
                return "torch"
            if _PORT_DIR in name:
                return "step"
        f = f.f_back
    return None


def _propagation(issuer: str | None) -> bool:
    return issuer is not None and (issuer in _DTENSOR_PROPAGATION
                                   or issuer.startswith("_ops" + os.sep))


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective a rank issued: the reference's op name, its group
    (name, size, global ranks) and the operand's bytes."""
    op: str
    group: str
    size: int
    ranks: tuple
    bytes: int


@dataclasses.dataclass
class CollectiveStats:
    """The reference's per-op sums (``repro/launch/hlo_analysis.py``)."""
    bytes_by_op: dict = dataclasses.field(default_factory=dict)
    count_by_op: dict = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


def collective_bytes(records) -> CollectiveStats:
    """Sum the operand bytes of the collectives ``records``
    (:class:`Collective`) by op, and count them: the counterpart of the
    reference's ``collective_bytes`` of an HLO text."""
    stats = CollectiveStats()
    for r in records:
        stats.bytes_by_op[r.op] = stats.bytes_by_op.get(r.op, 0) + r.bytes
        stats.count_by_op[r.op] = stats.count_by_op.get(r.op, 0) + 1
    return stats


def _collective(func, args) -> Collective | None:
    """The record of ``func`` if it is a functional collective."""
    name = f"{func.namespace}.{func._opname}"
    if name in _NOT_COLLECTIVES:
        return None
    op = _COLLECTIVES.get(name)
    if op is None:
        if func.namespace == "_c10d_functional":
            raise NotImplementedError(f"{func}: a collective the count does not know")
        return None
    import torch.distributed as dist

    group = next(a for a in reversed(args) if isinstance(a, str))
    pg = dist.distributed_c10d._resolve_process_group(group)
    src = args[0]
    tensors = list(src) if isinstance(src, (list, tuple)) else [src]
    return Collective(op, group, pg.size(), tuple(dist.get_process_group_ranks(pg)),
                      sum(t.numel() * t.element_size() for t in tensors))


class CostMode(TorchDispatchMode):
    """Counts FLOPs by dtype, bytes, flash pairs, collectives and the
    live-bytes peak of everything dispatched under it (see the module's
    docstring).  ``fake_mode`` is the mode of the step's own fake tensors
    (None: a run on real tensors, which drops only other modes' fake
    tensors)."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.collectives: list[Collective] = []
        self.flops: dict[str, float] = {}
        self.bytes = 0.0
        self.pairs = 0
        self.by_op: dict[str, list] = {}   # name -> [calls, flops, bytes]
        self._live: dict[int, tuple] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- live storages ---------------------------------------------------------
    def track(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = (n, weakref.ref(st, functools.partial(self._died, key)))
            self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _died(self, key: int, _ref) -> None:
        entry = self._live.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[0]

    # -- the count -------------------------------------------------------------
    def _foreign(self, func, tensors, issuer: str | None) -> bool:
        """Whether an operator on ``tensors`` is outside the counted step:
        another mode's fake tensors or, counting a fake step, real tensors
        off the meta device, issued by DTensor's planning or torch's
        bookkeeping (``issuer``, :func:`_issuer`).  Such tensors from any
        other issuer raise :class:`HostRead`."""
        fake = self.fake_mode is not None
        other = [t for t in tensors
                 if (isinstance(t, FakeTensor) and t.fake_mode is not self.fake_mode)
                 or (fake and not isinstance(t, FakeTensor) and t.device.type != "meta")]
        if not other:
            return False
        if issuer == "torch" or _propagation(issuer) or issuer in _DTENSOR_INDEX:
            return True
        t = other[0]
        what = ("a fake tensor of another mode" if isinstance(t, FakeTensor)
                else f"a {t.device.type} tensor")
        raise HostRead(f"{func}: the step computes on {what}, outside the count")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # DTensor runs the local ops
        if func.namespace == "prim":        # metadata (``prim.device``)
            return func(*args, **kwargs)
        issuer = _issuer()
        if _propagation(issuer):            # DTensor's sharding propagation
            return func(*args, **kwargs)
        ins = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, Tensor)]
        if self._foreign(func, ins, issuer):    # DTensor's index arithmetic, torch's
            return func(*args, **kwargs)        # bookkeeping
        if func is aten._local_scalar_dense.default and ins[0].device.type == "meta":
            raise HostRead(f"{func}: the step reads a value from the device")
        try:
            out = func(*args, **kwargs)
        except (DataDependentOutputException, DynamicOutputShapeException) as e:
            raise HostRead(f"{func}: the step reads a value or a shape from the "
                           f"device ({type(e).__name__})") from e
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, Tensor)]
        if self._foreign(func, outs, issuer):   # a factory op of the same
            return out
        coll = _collective(func, args)
        if coll is not None:
            self.collectives.append(coll)
        self.track(outs)
        if func.is_view or func in _FREE:
            return out
        flops = self._flops(func, args)
        nbytes = self._traffic(func, ins, outs)
        self.bytes += nbytes
        row = self.by_op.setdefault(str(func.overloadpacket), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        return out

    def _flops(self, func, args) -> float:
        if func in _MM:
            i, j = _MM[func]
            a, b = args[i], args[j]
            flops = 2.0 * math.prod(a.shape) * b.shape[-1]
            dt = _dtype(a)
        elif func in _FLASH:
            q = args[0]
            causal, window = args[-2], args[-1]
            B, S, H, hd = q.shape
            pairs = B * H * attention_pairs(S, causal, window)
            self.pairs += pairs
            flops = float(_FLASH[func] * hd * pairs)
            dt = _dtype(q)
        else:
            return 0.0
        self.flops[dt] = self.flops.get(dt, 0.0) + flops
        return flops

    @staticmethod
    def _traffic(func, ins: list, outs: list) -> float:
        if func in _GATHERS:
            src, rest = ins[0], ins[1:]
            fetched = min(_nbytes(src), sum(_nbytes(t) for t in outs))
            return fetched + sum(_nbytes(t) for t in rest + outs)
        if func in _SCATTERS:
            # self is written where the values go: as many bytes as they hold
            return sum(_nbytes(t) for t in ins[1:]) + _nbytes(ins[-1])
        if func in _OVERWRITES:
            ins = ins[1:]
        seen, total = set(), 0
        for t in ins:
            if id(t) not in seen:
                seen.add(id(t))
                total += _nbytes(t)
        return total + sum(_nbytes(t) for t in outs)

    def report(self, top: int = 10) -> dict:
        def table(col: int) -> list:
            rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][col])
            return [{"op": k, "calls": v[0], "flops": v[1], "bytes": v[2]}
                    for k, v in rows[:top] if v[col] > 0]

        stats = collective_bytes(self.collectives)
        return {"flops": sum(self.flops.values()), "flops_by_dtype": dict(self.flops),
                "bytes": self.bytes, "attention_pairs": self.pairs,
                "peak_bytes": self.peak_bytes, "top_by_bytes": table(2),
                "top_by_flops": table(1), "collectives": stats.bytes_by_op,
                "collective_counts": stats.count_by_op,
                "collective_bytes": stats.total_bytes}


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def count(cell, top: int = 10, mode: CostMode | None = None) -> dict:
    """Run ``cell``'s step once on its fake arguments and return what
    :class:`CostMode` counted (``report``), with ``count_s``, the host
    seconds the count took.  A one-card cell runs under its
    ``FakeTensorMode``; a sharded cell (``cell.mesh``) under none (see the
    module's docstring).  ``mode`` keeps the ``CostMode`` (its
    ``collectives``) for the caller."""
    t = time.perf_counter()
    mode = mode or CostMode(cell.mode)
    mode.track(_local(t_) for t_ in pytree.tree_leaves(cell.args)
               if isinstance(t_, Tensor))
    with contextlib.nullcontext() if cell.mesh is not None else cell.mode, mode:
        out = cell.fn(*cell.args)
    del out
    rep = mode.report(top)
    rep["count_s"] = time.perf_counter() - t
    return rep
