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

from repro_torch.core.functions import NEG, SubmodularFunction

Tensor = torch.Tensor
INF = -NEG  # +1e30


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


def divergence_update(
    fn: SubmodularFunction,
    current: Tensor,
    probes: Tensor,
    probe_mask: Tensor | None = None,
    residual: Tensor | None = None,
    state: Tensor | None = None,
) -> Tensor:
    """min(current, w_{U,v}): the running divergence as V' grows, one (r, n)
    block a round.  ``probe_mask`` (r,) marks the valid probe slots; the
    others never win the min."""
    w = edge_weights(fn, probes, residual, state)
    if probe_mask is not None:
        w = torch.where(probe_mask[:, None], w, INF)
    return torch.minimum(current, w.min(dim=0).values)


def full_edge_matrix(fn: SubmodularFunction, state: Tensor | None = None) -> Tensor:
    """All n x n edge weights, rows u, columns v (tests and analysis only)."""
    return edge_weights(fn, torch.arange(fn.n, device=fn.device), state=state)


def check_triangle_inequality(W: Tensor) -> Tensor:
    """Largest violation of Lemma 3, w_vx <= w_vu + w_ux, over distinct
    (v, u, x): max of w_vx - (w_vu + w_ux), at most float32 rounding for
    any submodular f (the lemma's proof needs u not in {v, x}).  O(n^3); a
    test utility."""
    n = W.shape[0]
    rhs = W[:, :, None] + W[None, :, :]        # [v, u, x] = w_vu + w_ux
    lhs = W[:, None, :]                        # [v, ., x] = w_vx
    i = torch.arange(n, device=W.device)
    distinct = ((i[:, None, None] != i[None, :, None])
                & (i[None, :, None] != i[None, None, :])
                & (i[:, None, None] != i[None, None, :]))
    return torch.where(distinct, lhs - rhs, NEG).max()
