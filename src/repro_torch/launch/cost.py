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
"""

from __future__ import annotations

import functools
import math
import time
import weakref

import torch
from torch._subclasses.fake_tensor import (
    DataDependentOutputException,
    DynamicOutputShapeException,
)
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


class CostMode(TorchDispatchMode):
    """Counts FLOPs by dtype, bytes, flash pairs and the live-bytes peak of
    everything dispatched under it (see the module's docstring)."""

    def __init__(self):
        super().__init__()
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
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim":        # metadata (``prim.device``)
            return func(*args, **kwargs)
        try:
            out = func(*args, **kwargs)
        except (DataDependentOutputException, DynamicOutputShapeException) as e:
            raise HostRead(f"{func}: the step reads a value or a shape from the "
                           f"device ({type(e).__name__})") from e
        ins = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, Tensor)]
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, Tensor)]
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

        return {"flops": sum(self.flops.values()), "flops_by_dtype": dict(self.flops),
                "bytes": self.bytes, "attention_pairs": self.pairs,
                "peak_bytes": self.peak_bytes, "top_by_bytes": table(2),
                "top_by_flops": table(1)}


def count(cell, top: int = 10) -> dict:
    """Run ``cell``'s step once on its fake arguments and return what
    :class:`CostMode` counted (``report``), with ``count_s``, the host
    seconds the count took."""
    t = time.perf_counter()
    mode = CostMode()
    mode.track(t_ for t_ in pytree.tree_leaves(cell.args) if isinstance(t_, Tensor))
    with cell.mode, mode:
        out = cell.fn(*cell.args)
    del out
    rep = mode.report(top)
    rep["count_s"] = time.perf_counter() - t
    return rep
