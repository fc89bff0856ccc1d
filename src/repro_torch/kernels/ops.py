"""Public entry points of the two kernels, routed through the backend.

They follow the objective's device: on the card they run the CUDA kernels
(``CudaBackend``), on the CPU the plain path (``ReferenceBackend``).  SS and
greedy reach the same code through :mod:`repro_torch.core.backend`.
"""

from __future__ import annotations

import torch

from repro_torch.core.backend import resolve_backend

Tensor = torch.Tensor


def ss_divergence(fn, probes: Tensor, residual: Tensor,
                  state: Tensor | None = None) -> Tensor:
    """Divergence w_{U,v} (paper Def. 2) for all v.  Shape (n,).

    On the card the entry of a candidate that equals a probe is unspecified
    (the SS loop never reads it); every other entry matches
    ``repro_torch.core.graph.divergence``.
    """
    return resolve_backend(None, fn.device).divergence(
        fn, probes, residual=residual, state=state)


def ss_divergence_compact(fn, probes: Tensor, cand_idx: Tensor,
                          residual: Tensor, state: Tensor | None = None) -> Tensor:
    """Divergence over the candidates ``cand_idx`` (k,): elementwise
    ``ss_divergence(...)[cand_idx]``."""
    return resolve_backend(None, fn.device).divergence_compact(
        fn, probes, cand_idx, residual=residual, state=state)


def feature_gains(fn, state: Tensor) -> Tensor:
    """Greedy gains f(v|S) for all v.  Shape (n,)."""
    return resolve_backend(None, fn.device).gains(fn, state)
