"""Execution backends for the submodular hot paths.

SS and greedy evaluate four primitives: ``gains`` / ``gains_compact`` (the
greedy step, full width or over a compacted candidate buffer) and
``divergence`` / ``divergence_compact`` (the SS round, paper Def. 2).
Greedy over a buffer first asks ``prepare_compact`` what its steps should
read (the objective's ``cuda_prepare`` under ``cuda``: dense facility
location gathers its candidate columns once).  This module decides how they
run:

- ``reference`` (:class:`ReferenceBackend`): plain PyTorch on whatever
  device the objective lives on; the counterpart of the JAX ``oracle``.
- ``cuda`` (:class:`CudaBackend`): the objective's CUDA kernel hooks; the
  counterpart of the JAX ``pallas`` backend.  It takes CUDA tensors only,
  and an objective without a kernel raises: nothing falls back to the plain
  path.

``resolve_backend(None, device)`` picks ``cuda`` for an objective on a CUDA
device and ``reference`` for one on the CPU, never the reverse.  No
environment variable takes part in the choice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import graph
from repro_torch.core.functions import SubmodularFunction

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
