"""Public entry points of the kernels, routed through the backend.

They follow the objective's device: on the card they run the CUDA kernels
(``CudaBackend``), on the CPU the plain path (``ReferenceBackend``).  SS and
greedy reach the same code through :mod:`repro_torch.core.backend`.  The
FeatureCoverage entries serve any objective; the ``fl_*`` entries take only
the two facility-location objectives, whose hooks run ``fl_divergence.cu``
(dense) or ``fl_stream.cu`` (matrix-free).  ``sieve_gains`` serves the three
objectives through ``sieve_gains.cu``.
"""

from __future__ import annotations

import torch

from repro_torch.core.backend import resolve_backend
from repro_torch.core.functions import FacilityLocation, StreamingFacilityLocation

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


def _fl(fn):
    if not isinstance(fn, (FacilityLocation, StreamingFacilityLocation)):
        raise TypeError(f"a facility-location objective is needed, got "
                        f"{type(fn).__name__}")
    return resolve_backend(None, fn.device)


def fl_divergence(fn, probes: Tensor, residual: Tensor,
                  state: Tensor | None = None) -> Tensor:
    """Facility-location divergence w_{U,v} for all v.  Shape (n,); the
    entry of a candidate that equals a probe is unspecified on the card."""
    return _fl(fn).divergence(fn, probes, residual=residual, state=state)


def fl_divergence_compact(fn, probes: Tensor, cand_idx: Tensor,
                          residual: Tensor, state: Tensor | None = None) -> Tensor:
    """Facility-location divergence over the candidates ``cand_idx`` (k,)."""
    return _fl(fn).divergence_compact(fn, probes, cand_idx, residual=residual,
                                      state=state)


def fl_gains(fn, state: Tensor, cand_idx: Tensor | None = None) -> Tensor:
    """Facility-location greedy gains f(v|S) for all v, or for ``cand_idx``."""
    be = _fl(fn)
    return be.gains(fn, state) if cand_idx is None else be.gains_compact(
        fn, state, cand_idx)


def sieve_gains(fn, states: Tensor, elements: Tensor) -> Tensor:
    """Sieve streaming's gains value(add(s, v)) - value(s), the reference's
    literal form, for each state row s of ``states`` (R, L) and each
    element v of ``elements`` (c,): (R, c) float32.  Both values come from
    one table of the objective's ``sieve_elements`` (the kernel on the
    card), value(s) as the zero element's entry."""
    el = fn.sieve_elements(torch.as_tensor(elements, device=fn.device).long())
    tab = resolve_backend(None, fn.device).sieve_table(
        fn, states.float().contiguous(), el)
    return tab[:, :-1] - tab[:, -1:]
