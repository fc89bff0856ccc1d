"""Submodular Sparsification (SS), Algorithm 1 of the paper, in PyTorch.

The counterpart of ``repro/core/sparsify.py``.  ``V`` is a static n-slot
tensor with a boolean ``alive`` mask; each round
  1. samples m = r·log2(n) probes from the live set (Gumbel top-k),
  2. moves them from ``alive`` into the retained mask ``vprime``,
  3. computes the divergence w_{U,v} (paper Def. 2) of every live v, through
     the backend (plain PyTorch, or the CUDA kernel),
  4. drops the (1 - 1/sqrt(c)) fraction of live elements with the smallest
     running divergence (min over all probes so far).

The JAX ``lax.while_loop`` is a Python loop here, with one host read of the
live count per round; its ``lax.switch`` over compact buckets is a host-side
choice of the bucket.  Randomness is explicit: each round draws Gumbel noise
from a ``torch.Generator`` on the objective's device, or takes row j of an
injected ``noise`` tensor, which lets a test replay the JAX reference's own
draws.

``eps_hat`` is max_{v pruned} w_{U,v} at prune time, the certificate of the
paper's Theorem 1: f(greedy on V') >= (1 - 1/e)(f(S*) - k * eps_hat).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.backend import Backend, resolve_backend
from repro_torch.core.functions import NEG, SubmodularFunction
from repro_torch.core.greedy import GreedyResult, compact_indices, greedy

Tensor = torch.Tensor
INF = -NEG  # +1e30


class SSResult(NamedTuple):
    vprime: Tensor       # (n,) bool: the retained set V'
    divergence: Tensor   # (n,) running divergence (INF where never computed)
    eps_hat: Tensor      # () float32 certificate: max divergence pruned
    rounds: int          # rounds executed
    alive_trace: Tensor  # (max_rounds,) int32 live count after each round (-1 pad), on the CPU


def probe_count(n: int, r: int = 8) -> int:
    """m = r * log2(n) (the paper samples r log n per round, log base 2)."""
    return max(1, int(r * math.log2(max(n, 2))))


def max_rounds(n: int, r: int = 8, c: float = 8.0) -> int:
    """log_{sqrt(c)}(n) rounds suffice (paper §3.2); +2 slack for rounding."""
    return max(1, int(math.ceil(math.log(max(n, 2)) / math.log(math.sqrt(c)))) + 2)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def ss_live_bound(n: int, r: int = 8, c: float = 8.0) -> int:
    """Static upper bound on |V'|, the paper's O(log² n): at most m probes
    per round for at most ``max_rounds`` rounds plus an m-sized tail."""
    m = min(probe_count(n, r), n)
    return min(n, m * (max_rounds(n, r, c) + 1))


def bucket_schedule(n: int, c: float = 8.0, tile: int = 128) -> tuple[int, ...]:
    """Compact-buffer sizes for the shrink-aware SS loop: ceil(n / c^{j/2})
    rounded up to ``tile``, clamped to n, deduplicated, descending."""
    if c <= 1.0:
        raise ValueError(f"bucket_schedule needs c > 1 (got c={c}): the SS "
                         "live set shrinks by 1 - 1/sqrt(c) per round")
    if tile < 1:
        raise ValueError(f"tile must be >= 1 (got {tile})")
    sizes: list[int] = []
    j = 0
    while True:
        raw = math.ceil(n / (math.sqrt(c) ** j))
        s = min(n, _round_up(raw, tile))
        if not sizes or s < sizes[-1]:
            sizes.append(s)
        if raw <= tile:
            return tuple(sizes)
        j += 1


def predicted_live_counts(
    n: int, r: int = 8, c: float = 8.0, alive0: int | None = None
) -> list[int]:
    """The live count after each round of Algorithm 1 (what
    ``SSResult.alive_trace`` records): each round removes m probes, then
    floor(live * (1 - 1/sqrt(c))) pruned elements."""
    m = min(probe_count(n, r), n)
    shrink = 1.0 - 1.0 / math.sqrt(c)
    live = n if alive0 is None else alive0
    out: list[int] = []
    for _ in range(max_rounds(n, r, c)):
        if live <= m:
            break
        live -= m
        live -= math.floor(live * shrink)
        out.append(live)
    return out


def ss_cost_model(
    n: int, r: int = 8, c: float = 8.0, alive0: int | None = None
) -> float:
    """Predicted SS divergence work: probe rows × compact candidate slots,
    summed over the round schedule of :func:`predicted_live_counts`.
    Arbitrary units; only ratios are meaningful."""
    m = min(probe_count(n, r), n)
    buckets = bucket_schedule(n, c)
    shrink = 1.0 - 1.0 / math.sqrt(c)
    live = n if alive0 is None else alive0
    total = 0.0
    for _ in range(max_rounds(n, r, c)):
        if live <= m:
            break
        live -= m
        bucket = min((b for b in buckets if b >= live), default=n)
        total += m * bucket
        live -= math.floor(live * shrink)
    return max(total, 1.0)


def gumbel(n: int, generator: torch.Generator | None, device) -> Tensor:
    """(n,) standard Gumbel draws, -log(E) with E ~ Exp(1), on ``device``."""
    e = torch.empty((n,), dtype=torch.float32, device=device)
    e.exponential_(generator=generator)
    return -torch.log(e.clamp_min_(torch.finfo(torch.float32).tiny))


def ss_sparsify(
    fn: SubmodularFunction,
    generator: torch.Generator | None = None,
    r: int = 8,
    c: float = 8.0,
    alive: Tensor | None = None,
    state: Tensor | None = None,
    importance: bool = False,
    backend: "str | Backend | None" = None,
    compact: bool = True,
    *,
    noise: Tensor | None = None,
) -> SSResult:
    """Algorithm 1 (Submodular Sparsification).

    Args:
      fn: submodular objective over n ground elements.
      generator: source of the per-round Gumbel draws, on ``fn``'s device
        (None: the device's default generator).
      r: probe multiplier (the paper uses r = 8 = c).
      c: accuracy/speed trade-off; the live set shrinks by 1/sqrt(c) a round.
      alive: optional (n,) bool initial live mask (e.g. after pre-pruning).
      state: optional summary state for conditional SS on G(V, E|S).
      importance: §3.4 improvement 2: sample probes with probability
        proportional to f(u) + f(u|V\\u) instead of uniformly.
      backend: "reference", "cuda", a Backend, or None (by ``fn``'s device).
      compact: evaluate each round's divergence over a compacted buffer of
        the live candidates, sized by :func:`bucket_schedule` (the default);
        False runs every round at full width.  Both give the same ``vprime``.
      noise: optional (max_rounds, n) float32 Gumbel draws; row j is round
        j's draw, in place of ``generator``.
    """
    be = resolve_backend(backend, fn.device)
    return _sparsify_dense(fn, generator, r, c, alive, state, importance, be,
                           compact, noise)


def _sparsify_dense(
    fn: SubmodularFunction,
    generator: torch.Generator | None,
    r: int,
    c: float,
    alive: Tensor | None,
    state: Tensor | None,
    importance: bool,
    backend: Backend,
    compact: bool,
    noise: Tensor | None,
) -> SSResult:
    """The single-process SS loop.

    With ``compact``, each round gathers the live candidates into a buffer
    of the smallest bucket that holds them (zero-padded, like the JAX
    ``jnp.where(..., size=, fill_value=0)``), computes their divergence and
    scatter-mins it back.  Entries of probe and dead slots then go stale; the
    loop never reads them, so ``vprime`` / ``eps_hat`` match the full-width
    loop.
    """
    be = backend
    n = fn.n
    dev = fn.device
    m = min(probe_count(n, r), n)  # tiny ground sets: everything is a probe
    rounds_cap = max_rounds(n, r, c)
    shrink = np.float32(1.0 - 1.0 / math.sqrt(c))
    buckets = bucket_schedule(n, c) if compact else None
    if noise is not None:
        if tuple(noise.shape) != (rounds_cap, n):
            raise ValueError(f"noise must be ({rounds_cap}, {n}), got "
                             f"{tuple(noise.shape)}")
        noise = noise.to(device=dev, dtype=torch.float32)
        # The loop relies on every probe being live (live > m, dead slots at
        # NEG): a non-finite draw could break that silently.
        if not bool(torch.isfinite(noise).all()):
            raise ValueError("noise must be finite")

    alive = (torch.ones((n,), dtype=torch.bool, device=dev) if alive is None
             else alive.to(device=dev, dtype=torch.bool).clone())
    residual = fn.residual_gains()
    if importance:
        score = fn.singleton_gains() + residual
        logits = torch.log(torch.clamp_min(score.float(), 1e-12))
    else:
        logits = torch.zeros((n,), dtype=torch.float32, device=dev)

    vprime = torch.zeros((n,), dtype=torch.bool, device=dev)
    div = torch.full((n,), INF, dtype=torch.float32, device=dev)
    eps_hat = torch.tensor(NEG, dtype=torch.float32, device=dev)
    slots = torch.arange(n, device=dev)
    trace = [-1] * rounds_cap
    live = int(alive.sum())
    rnd = 0
    while live > m and rnd < rounds_cap:
        # (1) m probes from the live set: Gumbel top-k is sampling without
        # replacement (uniform, or importance-weighted via the logits).
        g = noise[rnd] if noise is not None else gumbel(n, generator, dev)
        g = g + logits + torch.where(alive, 0.0, NEG)
        probes = torch.topk(g, m).indices

        # (2) U moves from V to V'.  Every probe is live (live > m and dead
        # slots sit at NEG), so exactly m leave the live set.
        probe_hot = torch.zeros((n,), dtype=torch.bool, device=dev)
        probe_hot[probes] = True
        probe_hot &= alive
        vprime |= probe_hot
        alive &= ~probe_hot
        live -= m

        # (3) running divergence against the union of all probes so far.
        size = min(b for b in buckets if b >= live) if compact else n
        if size >= n:
            div = torch.minimum(
                div, be.divergence(fn, probes, residual=residual, state=state)
            )
        else:
            cand_idx = compact_indices(alive, size)
            w = be.divergence_compact(fn, probes, cand_idx, residual=residual,
                                      state=state)
            # Padding slots repeat index 0; at +INF their scatter-min is a
            # no-op.
            w = torch.where(slots[:size] < live, w, INF)
            div = div.scatter_reduce(0, cand_idx, w, reduce="amin")

        # (4) drop the (1 - 1/sqrt(c)) fraction of live items with the
        # smallest divergence; a stable sort ranks them (dead at +INF last),
        # and float32 arithmetic sets the count, as in the reference.
        n_remove = int(np.floor(np.float32(live) * shrink))
        keyed = torch.where(alive, div, INF)
        order = torch.argsort(keyed, stable=True)
        pos = torch.empty((n,), dtype=torch.long, device=dev)
        pos[order] = slots
        removed = alive & (pos < n_remove)
        eps_hat = torch.maximum(eps_hat, torch.where(removed, div, NEG).max())
        alive &= ~removed
        live = int(alive.sum())
        trace[rnd] = live
        rnd += 1

    # Tail: the remaining live elements all join V' (Algorithm 1, line 13).
    vprime |= alive
    return SSResult(vprime, div, torch.clamp_min(eps_hat, 0.0), rnd,
                    torch.tensor(trace, dtype=torch.int32))


def preprune_mask(fn: SubmodularFunction, k: int) -> Tensor:
    """Pre-pruning after Wei et al. (§3.4 improvement 1): drop u whose
    singleton gain f(u) is below the k-th largest residual f(v|V\\v)."""
    kth = torch.topk(fn.residual_gains(), k).values[-1]
    return fn.singleton_gains() >= kth


def summarize(
    fn: SubmodularFunction,
    k: int,
    generator: torch.Generator | None = None,
    r: int = 8,
    c: float = 8.0,
    preprune: bool = False,
    importance: bool = False,
    backend: "str | Backend | None" = None,
    compact: bool = True,
    *,
    noise: Tensor | None = None,
) -> tuple[GreedyResult, SSResult]:
    """The paper's pipeline: (optional pre-prune) -> SS -> greedy on V'.

    ``backend`` and ``compact`` cover both stages; with ``compact`` the
    greedy stage runs over a |V'|-sized candidate buffer.
    """
    alive = preprune_mask(fn, k) if preprune else None
    ss = ss_sparsify(fn, generator, r=r, c=c, alive=alive,
                     importance=importance, backend=backend, compact=compact,
                     noise=noise)
    res = greedy(fn, k, alive=ss.vprime, backend=backend, compact=compact)
    return res, ss
