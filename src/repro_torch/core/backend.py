"""Execution backends for the submodular hot paths.

SS and greedy evaluate four primitives: ``gains`` / ``gains_compact`` (the
greedy step, full width or over a compacted candidate buffer) and
``divergence`` / ``divergence_compact`` (the SS round, paper Def. 2);
sieve streaming a fifth, ``sieve_table`` (its states against a chunk of
the stream).
The batched SS and greedy of a stacked objective (B same-shape queries)
evaluate two more, ``divergence_batched`` and ``gains_batched`` (after
``prepare_batched``, the batched ``prepare_compact``): the base class maps
its single-query primitives over the rows, for both backends.
Greedy over a buffer first asks ``prepare_compact`` what its steps should
read (the objective's ``cuda_prepare`` under ``cuda``: dense facility
location gathers its candidate columns once).  This module decides how they
run:

- ``reference`` (:class:`ReferenceBackend`): plain PyTorch on whatever
  device the objective lives on; the counterpart of the JAX ``oracle``.
- ``cuda`` (:class:`CudaBackend`): the objective's CUDA kernel hooks; the
  counterpart of the JAX ``pallas`` backend.  It takes CUDA tensors only,
  and an objective without a kernel raises: nothing falls back to the plain
  path.  Its batched primitives launch the single-query kernels once per
  row, on views of the row's tensors (a kernel over the whole batch grid is
  later work).

``resolve_backend(None, device)`` picks ``cuda`` for an objective on a CUDA
device and ``reference`` for one on the CPU, never the reverse.  No
environment variable takes part in the choice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import graph
from repro_torch.core.functions import SubmodularFunction
from repro_torch.kernels.sieve_gains import (
    SieveElements,
    sieve_gains_kernel,
    sieve_gains_ref,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Backend:
    """Execution strategy for the primitives.  The base class is the plain
    PyTorch path; :class:`CudaBackend` overrides every primitive."""

    name = "reference"

    def gains(self, fn: SubmodularFunction, state: Tensor) -> Tensor:
        """f(v|S) for all v.  Shape (n,)."""
        return fn.gains(state)

    def gains_compact(
        self, fn: SubmodularFunction, state: Tensor, cand_idx: Tensor
    ) -> Tensor:
        """f(v|S) for the candidate buffer ``cand_idx`` (k,).  Shape (k,)."""
        return fn.gains_compact(state, cand_idx)

    def prepare_compact(self, fn: SubmodularFunction, cand_idx: Tensor):
        """What greedy's steps over the buffer ``cand_idx`` hand
        :meth:`gains_compact` in its place, made once before the first
        step: ``cand_idx`` itself on the plain path."""
        return cand_idx

    def divergence(
        self,
        fn: SubmodularFunction,
        probes: Tensor,
        residual: Tensor | None = None,
        state: Tensor | None = None,
    ) -> Tensor:
        """w_{U,v} = min_u [f(v|S+u) - f(u|V\\u)] for all v.  (n,)."""
        return graph.divergence(fn, probes, residual, state)

    def divergence_compact(
        self,
        fn: SubmodularFunction,
        probes: Tensor,
        cand_idx: Tensor,
        residual: Tensor | None = None,
        state: Tensor | None = None,
    ) -> Tensor:
        """w_{U,v} for the candidate buffer ``cand_idx`` (k,).  (k,)."""
        return graph.divergence_compact(fn, probes, cand_idx, residual, state)

    # The batched primitives of a stacked objective: row b's views
    # (``fn.row(b)``), then this backend's single-query primitive, so each
    # row equals its single-query call bit for bit (one kernel launch a row
    # under ``cuda``).

    def divergence_batched(
        self,
        fn: SubmodularFunction,
        probes: Tensor,
        cand_idx: Tensor | None = None,
        residual: Tensor | None = None,
        state: Tensor | None = None,
        rows: "list[int] | None" = None,
    ) -> Tensor:
        """w_{U_b,v} of a stacked objective, one position per row of
        ``rows`` (all B when None): probes (R, r), cand_idx (R, k) or None
        (all n), ``residual`` the stacked (B, n) block, ``state`` the
        per-position states or None.  (R, k); position i is
        :meth:`divergence_compact` (:meth:`divergence` when cand_idx is
        None) of ``fn.row(rows[i])``."""
        rows = range(fn.batch) if rows is None else rows
        out = []
        for i, b in enumerate(rows):
            f, st = fn.row(b), None if state is None else state[i]
            res = None if residual is None else residual[b]
            out.append(self.divergence(f, probes[i], res, st) if cand_idx is None
                       else self.divergence_compact(f, probes[i], cand_idx[i], res, st))
        return torch.stack(out)

    def gains_batched(
        self,
        fn: SubmodularFunction,
        state: Tensor,
        cand_idx,
        rows: "list[int] | None" = None,
    ) -> Tensor:
        """f(v|S_b) of a stacked objective, one position per row of
        ``rows`` (all B when None): ``state`` (R, ·), ``cand_idx`` (R, k),
        None (all n), or what :meth:`prepare_batched` made of it.  (R, k);
        position i is :meth:`gains_compact` (:meth:`gains` when None) of
        ``fn.row(rows[i])``."""
        rows = range(fn.batch) if rows is None else rows
        return torch.stack([
            self.gains(fn.row(b), state[i]) if cand_idx is None
            else self.gains_compact(fn.row(b), state[i], cand_idx[i])
            for i, b in enumerate(rows)])

    def prepare_batched(self, fn: SubmodularFunction, cand_idx: Tensor) -> list:
        """:meth:`prepare_compact` of each row's buffer of the (B, k)
        ``cand_idx``, once per batched greedy run (dense facility location's
        V' panel under ``cuda``), as a list of B."""
        return [self.prepare_compact(fn.row(b), c) for b, c in enumerate(cand_idx)]

    def sieve_table(
        self,
        fn: SubmodularFunction,
        S: Tensor,
        el: SieveElements,
        start: Tensor | None = None,
    ) -> Tensor:
        """The sieve table of the states ``S`` (R, L) against ``el``'s
        elements (``kernels/sieve_gains.py``), (R, n_cols).  Rows may skip
        the columns before ``start`` (R,); the plain path computes them."""
        return sieve_gains_ref(S, el.E, el.idx, cols=el.cols, phi=el.phi,
                               feat_w=el.feat_w, cap=el.cap)


@dataclasses.dataclass(frozen=True)
class ReferenceBackend(Backend):
    """Plain PyTorch: inherits every primitive unchanged."""

    name = "reference"


@dataclasses.dataclass(frozen=True)
class CudaBackend(Backend):
    """The hand-written CUDA kernels, through the objective's hooks."""

    name = "cuda"

    @staticmethod
    def _check(fn: SubmodularFunction) -> None:
        if fn.device.type != "cuda":
            raise ValueError(
                f"the cuda backend runs CUDA tensors only; the objective is on "
                f"{fn.device} (use backend='reference' for the plain path)"
            )

    def gains(self, fn, state):
        self._check(fn)
        return fn.cuda_gains(state)

    def gains_compact(self, fn, state, cand_idx):
        self._check(fn)
        return fn.cuda_gains(state, cand_idx)

    def prepare_compact(self, fn, cand_idx):
        self._check(fn)
        return fn.cuda_prepare(cand_idx)

    def divergence(self, fn, probes, residual=None, state=None):
        self._check(fn)
        if residual is None:
            residual = fn.residual_gains()
        return fn.cuda_divergence(probes, residual, state)

    def divergence_compact(self, fn, probes, cand_idx, residual=None, state=None):
        self._check(fn)
        if residual is None:
            residual = fn.residual_gains()
        return fn.cuda_divergence(probes, residual, state, cand_idx)

    def sieve_table(self, fn, S, el, start=None):
        self._check(fn)
        return sieve_gains_kernel(S, el, start)


_BACKENDS = {"reference": ReferenceBackend, "cuda": CudaBackend}


def resolve_backend(
    spec: "str | Backend | None" = None, device: torch.device | None = None
) -> Backend:
    """A ``backend=`` argument: a Backend (as is), a name ("reference" or
    "cuda"), or None, which picks by ``device``: cuda for a CUDA device,
    reference for the CPU."""
    if isinstance(spec, Backend):
        return spec
    if spec is None:
        if device is None:
            raise ValueError("resolve_backend(None) needs the objective's device")
        spec = "cuda" if torch.device(device).type == "cuda" else "reference"
    if isinstance(spec, str):
        if spec not in _BACKENDS:
            raise KeyError(f"unknown backend {spec!r}; available: {sorted(_BACKENDS)}")
        return _BACKENDS[spec]()
    raise TypeError(f"backend must be a name, Backend, or None; got {spec!r}")
