"""Greedy maximization under a cardinality constraint, in PyTorch.

The counterpart of ``greedy`` in ``repro/core/greedy.py``.  Each step
recomputes the masked gains of all candidates with one backend call (the
CUDA kernel under ``cuda``) and takes the first argmax; nothing waits on the
host inside the loop.

Compact selection: after SS the live set is |V'| = O(log² n) ≪ n.  When
``alive`` is sparse, ``greedy`` gathers it once into a buffer of the
smallest :func:`repro_torch.core.sparsify.bucket_schedule` size that holds
it (ascending ground order, zero padding), runs every step over that buffer
and maps the picks back to ground indices.  The backend sees the buffer once
before the first step (``prepare_compact``: dense facility location on the
card copies its columns into a panel, freed when greedy returns).  Compact
and full-width runs pick the same elements, because both argmaxes take the
first maximum in ground order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.backend import Backend, resolve_backend
from repro_torch.core.functions import NEG, SubmodularFunction

Tensor = torch.Tensor


class GreedyResult(NamedTuple):
    selected: Tensor     # (k,) int64 ground indices, in selection order
    gains: Tensor        # (k,) marginal gain at each step
    value: Tensor        # () f(S)
    state: Tensor        # final summary state


def compact_indices(alive: Tensor, size: int) -> Tensor:
    """Ground indices of the live slots, ascending, zero-padded to ``size``:
    the counterpart of ``jnp.where(alive, size=size, fill_value=0)``.  Live
    slots past ``size`` are dropped.  No host synchronisation."""
    n = alive.shape[0]
    pos = torch.cumsum(alive, dim=0) - 1
    dest = torch.where(alive & (pos < size), pos, size)  # slot `size`: discard
    buf = torch.zeros((size + 1,), dtype=torch.long, device=alive.device)
    buf.scatter_(0, dest, torch.arange(n, device=alive.device))
    return buf[:size]


def selection_bucket(
    n: int, live: int, c: float = 8.0, tile: int = 128
) -> int | None:
    """The smallest SS bucket size that holds ``live`` candidates, or None
    when only the full width fits (compaction would then be pure overhead)."""
    from repro_torch.core.sparsify import bucket_schedule

    size = min(b for b in bucket_schedule(n, c, tile) if b >= live)
    return None if size >= n else size


def _compact_plan(n: int, alive: Tensor | None, compact: bool | None) -> int | None:
    """The compact buffer size, or None for the full-width path: None/True
    compact when ``alive`` is sparse enough (one host read of the live
    count), False never.  (The JAX package also takes an int bound on the
    live count, for masks it cannot read under tracing; eager PyTorch can
    always read the mask.)"""
    if compact is False or alive is None:
        return None
    return selection_bucket(n, int(alive.sum()))


def greedy(
    fn: SubmodularFunction,
    k: int,
    alive: Tensor | None = None,
    backend: "str | Backend | None" = None,
    state: Tensor | None = None,
    compact: bool | None = None,
) -> GreedyResult:
    """Standard greedy restricted to ``alive``, for exactly k steps.

    Once the alive set is exhausted, the remaining steps record index 0 with
    gain 0 and leave the state alone, so ``value`` is f of the real picks.
    ``state`` starts from an existing summary state (S ≠ ∅).  ``backend`` is
    "reference", "cuda", a Backend, or None (by ``fn``'s device).
    """
    be = resolve_backend(backend, fn.device)
    return _greedy_dense(fn, k, alive, state, compact, be)


def _greedy_dense(
    fn: SubmodularFunction,
    k: int,
    alive: Tensor | None,
    state: Tensor | None,
    compact: bool | None,
    backend: Backend,
) -> GreedyResult:
    size = _compact_plan(fn.n, alive, compact)
    if size is None:
        return _greedy(fn, k, alive, state, backend)
    return _greedy_compact(fn, k, size, alive, state, backend)


def _greedy(
    fn: SubmodularFunction, k: int, alive: Tensor | None,
    state: Tensor | None, backend: Backend,
) -> GreedyResult:
    be = backend
    dev = fn.device
    avail = (torch.ones((fn.n,), dtype=torch.bool, device=dev) if alive is None
             else alive.to(device=dev, dtype=torch.bool).clone())
    st = fn.empty_state() if state is None else state
    sel, gains = [], []
    for _ in range(k):
        g = torch.where(avail, be.gains(fn, st), NEG)
        v = torch.argmax(g)
        ok = avail[v].clone()  # a 0-d index gives a view
        st = torch.where(ok, fn.add(st, v), st)
        avail[v] = False
        sel.append(v)
        gains.append(torch.where(ok, g[v], 0.0))
    return GreedyResult(torch.stack(sel), torch.stack(gains), fn.value(st), st)


def _greedy_compact(
    fn: SubmodularFunction, k: int, size: int, alive: Tensor,
    state: Tensor | None, backend: Backend,
) -> GreedyResult:
    """Gains and argmax in (size,)-slot index space over the ascending
    buffer of live ground indices; exhausted steps record index 0 / gain 0,
    like the full-width path."""
    be = backend
    alive = alive.to(device=fn.device, dtype=torch.bool)
    cand_idx = compact_indices(alive, size)
    cands = be.prepare_compact(fn, cand_idx)  # once per run (a panel, say)
    avail = torch.arange(size, device=fn.device) < alive.sum()  # pads are dead
    st = fn.empty_state() if state is None else state
    sel, gains = [], []
    for _ in range(k):
        g = torch.where(avail, be.gains_compact(fn, st, cands), NEG)
        vc = torch.argmax(g)
        v = cand_idx[vc]
        ok = avail[vc].clone()
        st = torch.where(ok, fn.add(st, v), st)
        avail[vc] = False
        sel.append(torch.where(ok, v, 0))
        gains.append(torch.where(ok, g[vc], 0.0))
    return GreedyResult(torch.stack(sel), torch.stack(gains), fn.value(st), st)
