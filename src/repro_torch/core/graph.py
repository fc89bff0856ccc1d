"""The submodularity graph G(V, E, w) of Definition 1 and its divergences.

Edge weight (paper Eq. 3):        w_{u->v}   = f(v|u)   - f(u | V \\ u)
Conditional weight (paper Eq. 4): w_{u->v|S} = f(v|S+u) - f(u | V \\ u)
Divergence (Definition 2):        w_{V',v}   = min_{x in V'} w_{x->v}

Everything is computed in dense (r, n) blocks against a set of probe tail
nodes; the n(n-1) graph is never built.  These are the plain paths that
``ReferenceBackend`` runs; the CUDA kernel fuses the same arithmetic.
"""

from __future__ import annotations

import torch

from repro_torch.core.functions import SubmodularFunction

Tensor = torch.Tensor


def edge_weights(
    fn: SubmodularFunction,
    probes: Tensor,
    residual: Tensor | None = None,
    state: Tensor | None = None,
) -> Tensor:
    """Weights w_{u->v|S} for probe tails u (r,) x all heads v.  (r, n).

    ``residual`` is the precomputed f(u|V\\u) over the whole ground set (n,).
    """
    if residual is None:
        residual = fn.residual_gains()
    return fn.pairwise_gains(probes, state) - residual[probes][:, None]


def divergence(
    fn: SubmodularFunction,
    probes: Tensor,
    residual: Tensor | None = None,
    state: Tensor | None = None,
) -> Tensor:
    """w_{U,v} = min_{u in U} w_{u->v|S} for all v.  Shape (n,)."""
    return edge_weights(fn, probes, residual, state).min(dim=0).values


def edge_weights_compact(
    fn: SubmodularFunction,
    probes: Tensor,
    cand_idx: Tensor,
    residual: Tensor | None = None,
    state: Tensor | None = None,
) -> Tensor:
    """w_{u->v|S} for probe tails u (r,) x heads v = cand_idx (k,).  (r, k)."""
    if residual is None:
        residual = fn.residual_gains()
    pair = fn.pairwise_gains_compact(probes, cand_idx, state)
    return pair - residual[probes][:, None]


def divergence_compact(
    fn: SubmodularFunction,
    probes: Tensor,
    cand_idx: Tensor,
    residual: Tensor | None = None,
    state: Tensor | None = None,
) -> Tensor:
    """w_{U,v} for v = cand_idx (k,).  Shape (k,).

    Equals ``divergence(fn, probes, ...)[cand_idx]`` elementwise; padding
    entries of ``cand_idx`` compute the divergence of whatever index they
    repeat, and callers mask them.
    """
    w = edge_weights_compact(fn, probes, cand_idx, residual, state)
    return w.min(dim=0).values
