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

Telemetry: ``ss_sparsify`` and ``ss_sparsify_batched`` open an
``ss.sparsify`` / ``ss.sparsify_batched`` span only while tracing is on
(``repro_torch.core.greedy._traceable``); per-round records are derived
from ``alive_trace`` after the loop.  With tracing off they add no op and
no host read.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import graph
from repro_torch.core.backend import Backend, resolve_backend
from repro_torch.core.functions import NEG, SubmodularFunction
from repro_torch.core.greedy import (
    GreedyResult,
    _observed,
    bidirectional_greedy,
    check_noise,
    compact_indices,
    greedy,
    gumbel,
)
from repro_torch.kernels.ref import _ELEMS

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


def _round_detail(
    trace, n: int, r: int, c: float, live0: int, wall_s: float,
) -> list[dict]:
    """Per-round records derived after the loop from a row of
    ``SSResult.alive_trace``: the live count after the round, the compact
    bucket the round ran over, and a model-apportioned share of the
    measured wall (``wall_est_s``, weighted by probe rows x bucket slots;
    timing each round would take a synchronisation inside the loop)."""
    m = min(probe_count(n, r), n)
    buckets = bucket_schedule(n, c)
    lives = [int(v) for v in trace if v >= 0]
    detail, weights, live_before = [], [], live0
    for live_after in lives:
        bucket = min((b for b in buckets if b >= live_before), default=n)
        weights.append(float(m * bucket))
        detail.append({"live": live_after, "bucket": bucket})
        live_before = live_after
    total_w = sum(weights) or 1.0
    for j, d in enumerate(detail):
        d["round"] = j
        d["wall_est_s"] = wall_s * weights[j] / total_w
    return detail


def _record_ss(sp, ss: "SSResult", n: int, r: int, c: float, backend: str,
               wall_s: float, alive: Tensor | None, *, batched: bool) -> None:
    """Fill an SS span and the metrics from a finished result (its values
    read to the host here, after the loop)."""
    reg = obs.get_registry()
    trace = ss.alive_trace.numpy()
    eps_hat = ss.eps_hat.cpu().numpy()
    vp = ss.vprime.sum(dim=-1).cpu().numpy()
    if batched:
        B = trace.shape[0]
        live0 = ([n] * B if alive is None
                 else [int(x) for x in alive.sum(dim=1).tolist()])
        sp.set(
            B=int(B),
            rounds=[int(x) for x in ss.rounds],
            eps_hat=[float(x) for x in eps_hat],
            vprime_size=[int(x) for x in vp],
            rounds_detail=[
                _round_detail(row, n, r, c, int(l0), wall_s)
                for row, l0 in zip(trace, live0)
            ],
        )
        total_rounds = int(sum(ss.rounds))
    else:
        live0 = n if alive is None else int(alive.sum())
        sp.set(
            rounds=int(ss.rounds), eps_hat=float(eps_hat),
            vprime_size=int(vp),
            rounds_detail=_round_detail(trace, n, r, c, live0, wall_s),
        )
        total_rounds = int(ss.rounds)
    # wall_s is the measured compute wall (start to synchronised end), the
    # quantity the per-round estimates apportion; the span's own t0..t1
    # also covers this host-side readout.
    sp.set(n=n, r=r, c=c, backend=backend, wall_s=wall_s)
    reg.histogram(
        "repro_ss_wall_seconds", "ss_sparsify wall time per call",
        labels=("backend",),
    ).observe(wall_s, backend=backend)
    reg.counter(
        "repro_ss_rounds_total", "SS rounds executed", labels=("backend",),
    ).inc(total_rounds, backend=backend)


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
      backend: "reference", "cuda", "sharded", a Backend, or None (by
        ``fn``'s device); the backend runs the whole loop
        (:meth:`Backend.sparsify`).
      compact: evaluate each round's divergence over a compacted buffer of
        the live candidates, sized by :func:`bucket_schedule` (the default);
        False runs every round at full width.  Both give the same ``vprime``.
      noise: optional (max_rounds, n) float32 Gumbel draws; row j is round
        j's draw, in place of ``generator``.  Under ``sharded`` each rank
        passes its own (max_rounds of its pod, n_loc) draws.
    """
    be = resolve_backend(backend, fn.device)
    return _observed(
        "ss.sparsify", fn.device,
        lambda: be.sparsify(fn, generator, r=r, c=c, alive=alive, state=state,
                            importance=importance, compact=compact, noise=noise),
        lambda sp, ss, wall: _record_ss(sp, ss, fn.n, r, c, be.name, wall, alive,
                                        batched=False))


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
        # The loop relies on every probe being live (live > m, dead slots at
        # NEG), which a non-finite draw could break silently.
        noise = check_noise(noise, (rounds_cap, n), dev)

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
        # (1)-(2) m probes leave the live set for V'.
        draw = noise[rnd] if noise is not None else gumbel(n, generator, dev)
        probes = _take_probes(draw, logits, alive, vprime, m)
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
            div = _scatter_min(div, w, cand_idx, live, slots)

        # (4) drop the (1 - 1/sqrt(c)) fraction with the smallest divergence.
        eps_hat = _drop(div, alive, live, shrink, slots, eps_hat)
        live = int(alive.sum())
        trace[rnd] = live
        rnd += 1

    # Tail: the remaining live elements all join V' (Algorithm 1, line 13).
    vprime |= alive
    return SSResult(vprime, div, torch.clamp_min(eps_hat, 0.0), rnd,
                    torch.tensor(trace, dtype=torch.int32))


def _take_probes(draw: Tensor, logits: Tensor, alive: Tensor, vprime: Tensor,
                 m: int) -> Tensor:
    """(1)-(2) of one query's round: its m probes, moved from ``alive`` to
    ``vprime`` (both (n,), updated in place).  Gumbel top-k of the
    ``draw`` is sampling without replacement (uniform, or
    importance-weighted by the ``logits``); dead slots sit at NEG and the
    live set holds more than m, so every probe is live and exactly m
    leave."""
    probes = torch.topk(draw + logits + torch.where(alive, 0.0, NEG), m).indices
    hot = torch.zeros_like(alive).index_fill_(0, probes, True) & alive
    vprime |= hot
    alive &= ~hot
    return probes


def _scatter_min(div: Tensor, w: Tensor, cand_idx: Tensor, live: int,
                 slots: Tensor) -> Tensor:
    """(3) of a compact round: the buffer's divergence ``w`` scatter-mins
    into ``div``.  Padding slots (past ``live``) repeat index 0; at +INF
    their scatter-min is a no-op."""
    w = torch.where(slots[:w.shape[0]] < live, w, INF)
    return div.scatter_reduce(0, cand_idx, w, reduce="amin")


def _drop(div: Tensor, alive: Tensor, live: int, shrink, slots: Tensor,
          eps_hat: Tensor) -> Tensor:
    """(4) of one query's round: drop the (1 - 1/sqrt(c)) fraction of the
    ``live`` items with the smallest divergence from ``alive`` (in place).
    A stable sort ranks them (dead at +INF last) and float32 arithmetic
    sets the count, as in the reference.  Returns the new eps_hat."""
    n_remove = int(np.floor(np.float32(live) * shrink))
    order = torch.argsort(torch.where(alive, div, INF), stable=True)
    pos = torch.empty_like(order)
    pos[order] = slots
    removed = alive & (pos < n_remove)
    alive &= ~removed
    return torch.maximum(eps_hat, torch.where(removed, div, NEG).max())


def ss_sparsify_batched(
    fn: SubmodularFunction,
    generators: "list[torch.Generator] | None" = None,
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
    """Algorithm 1 for B same-shape queries in one loop.

    ``fn`` is a stacked objective (a leading B axis on every tensor),
    ``alive`` an optional (B, n) mask and ``state`` an optional stacked
    (B, ·) conditional state.  Returns an SSResult with a leading B axis on
    every field (``rounds`` a list of B ints).  Row b is identical to
    ``ss_sparsify(fn.row(b), generators[b], ...)``: the same ``vprime``,
    ``eps_hat``, ``rounds`` and ``alive_trace``.

    Randomness: ``generators`` holds one ``torch.Generator`` per row (None:
    the device's default generator for every row, in row order), or
    ``noise`` (B, max_rounds, n) holds the draws, ``noise[b, j]`` row b's
    draw in its round j.  A row that has finished draws nothing, so row b
    consumes its stream exactly as the single-query loop does.  As in the
    single-query compact loop, ``divergence`` entries of probe and dead
    slots are stale, and here the shared bucket may leave others than the
    single-query run's: never read them off the live set.
    """
    be = resolve_backend(backend, fn.device)
    return _observed(
        "ss.sparsify_batched", fn.device,
        lambda: be.sparsify_batched(fn, generators, r=r, c=c, alive=alive,
                                    state=state, importance=importance,
                                    compact=compact, noise=noise),
        lambda sp, ss, wall: _record_ss(sp, ss, fn.row(0).n, r, c, be.name, wall,
                                        alive, batched=True))


def _sparsify_batched(
    fn: SubmodularFunction,
    generators: "list[torch.Generator] | None",
    r: int,
    c: float,
    alive: Tensor | None,
    state: Tensor | None,
    importance: bool,
    backend: Backend,
    compact: bool,
    noise: Tensor | None,
) -> SSResult:
    """The batched SS loop: one Python loop over rounds for the whole batch.

    Each round works on the *active* rows (live > m and rounds left): one
    explicit host read gives every row's live count (``host_reads`` counts
    them), the rows that finished keep their whole carry (bit for bit what
    the single-query loop returns), and the active rows share one compact
    bucket, the smallest that holds the largest live count among them.
    Each row's results do not depend on the bucket (the compaction
    contract), so sharing it keeps row parity.  The divergence is one
    ``divergence_batched`` call over the active rows; the draws, the probes
    and the prune are each row's own, through the single-query loop's
    helpers (:func:`_take_probes`, :func:`_scatter_min`, :func:`_drop`).
    Only the shared bucket and the host read differ from
    :func:`_sparsify_dense`.
    """
    be = backend
    fn0 = fn.row(0)
    B, n, dev = fn.batch, fn0.n, fn.device
    m = min(probe_count(n, r), n)
    rounds_cap = max_rounds(n, r, c)
    shrink = np.float32(1.0 - 1.0 / math.sqrt(c))
    buckets = bucket_schedule(n, c) if compact else None
    if noise is not None:
        noise = check_noise(noise, (B, rounds_cap, n), dev)
    if generators is not None and len(generators) != B:
        raise ValueError(f"ss_sparsify_batched needs {B} generators, one a row; "
                         f"got {len(generators)}")
    if alive is not None and tuple(alive.shape) != (B, n):
        raise ValueError(f"ss_sparsify_batched needs a ({B}, {n}) alive mask; "
                         f"got {tuple(alive.shape)}")

    alive = (torch.ones((B, n), dtype=torch.bool, device=dev) if alive is None
             else alive.to(device=dev, dtype=torch.bool).clone())
    rows = [fn.row(b) for b in range(B)]
    residual = torch.stack([f.residual_gains() for f in rows])      # (B, n)
    if importance:
        score = torch.stack([f.singleton_gains() for f in rows]) + residual
        logits = torch.log(torch.clamp_min(score.float(), 1e-12))
    else:
        logits = torch.zeros((B, n), dtype=torch.float32, device=dev)

    vprime = torch.zeros((B, n), dtype=torch.bool, device=dev)
    div = torch.full((B, n), INF, dtype=torch.float32, device=dev)
    eps_hat = torch.full((B,), NEG, dtype=torch.float32, device=dev)
    slots = torch.arange(n, device=dev)
    trace = [[-1] * rounds_cap for _ in range(B)]
    rounds = [0] * B
    live = alive.sum(dim=1).tolist()                # the first host read
    _sparsify_batched.host_reads += 1
    rnd = 0
    while True:
        act = [b for b in range(B) if live[b] > m and rnd < rounds_cap]
        if not act:
            break
        # (1)-(2) each active row's m probes leave its live set (the rows'
        # views are updated in place).
        probes = []
        for b in act:
            draw = noise[b, rnd] if noise is not None else gumbel(
                n, None if generators is None else generators[b], dev)
            probes.append(_take_probes(draw, logits[b], alive[b], vprime[b], m))
            live[b] -= m
        probes = torch.stack(probes)                                  # (A, m)
        st = None if state is None else state[act]

        # (3) the running divergence over the bucket shared by the active rows
        size = min(b for b in buckets if b >= max(live[b] for b in act)) \
            if compact else n
        if size >= n:
            w = be.divergence_batched(fn, probes, None, residual, st, act)
            for i, b in enumerate(act):
                div[b] = torch.minimum(div[b], w[i])
        else:
            cand = torch.stack([compact_indices(alive[b], size) for b in act])
            w = be.divergence_batched(fn, probes, cand, residual, st, act)
            for i, b in enumerate(act):
                div[b] = _scatter_min(div[b], w[i], cand[i], live[b], slots)

        # (4) each active row drops its (1 - 1/sqrt(c)) fraction
        for b in act:
            eps_hat[b] = _drop(div[b], alive[b], live[b], shrink, slots, eps_hat[b])
        counts = alive.sum(dim=1).tolist()          # one explicit read a round
        _sparsify_batched.host_reads += 1
        for b in act:
            live[b] = counts[b]
            trace[b][rnd] = counts[b]
            rounds[b] += 1
        rnd += 1

    vprime |= alive
    return SSResult(vprime, div, torch.clamp_min(eps_hat, 0.0), rounds,
                    torch.tensor(trace, dtype=torch.int32))


_sparsify_batched.host_reads = 0


def preprune_mask(fn: SubmodularFunction, k: int) -> Tensor:
    """Pre-pruning after Wei et al. (§3.4 improvement 1): drop u whose
    singleton gain f(u) is below the k-th largest residual f(v|V\\v)."""
    kth = torch.topk(fn.residual_gains(), k).values[-1]
    return fn.singleton_gains() >= kth


def postreduce(
    fn: SubmodularFunction,
    result: SSResult,
    eps: float,
    generator: torch.Generator | None = None,
    max_members: "int | str | None" = None,
    r: int = 8,
    c: float = 8.0,
    *,
    noise: Tensor | None = None,
) -> Tensor:
    """§3.4 improvement 3: shrink V' further by solving Eq. 9 restricted to
    V' with bidirectional greedy.  Returns the new (n,) bool vprime, a
    subset of ``result.vprime``.

    h(X) = |{v in V \\ V' : min_{x in X} w_{x->v} <= eps}|, and Eq. 9 keeps
    X maximizing h(X) - |X|.  V''s members sit in a static block of
    ``slots`` (ascending ground order, padded with -1, whose rows are +INF
    and cover nothing) and the kept slots scatter back to ground indices.

    ``max_members`` sets the slot count.  None derives it from SS's
    O(log² n) bound, :func:`ss_live_bound` at ``r`` and ``c`` (pass the SS
    run's), and raises when |V'| does not fit; "exact" reads |V'|; an int
    is trusted unchecked (members past it are dropped).  ``noise`` is the
    (slots,) float32 uniforms of :func:`bidirectional_greedy`, step j's
    draw in slot j; without it they come from ``generator`` (on ``fn``'s
    device).

    The (slots, n) edge weights are computed in blocks of members (each
    element the arithmetic of :func:`graph.edge_weights`) and kept only as
    the bool matrix "member x covers pruned v": C[x, v] = (w_{x->v} <= eps).
    h's counts are then kept incrementally, exactly: a running cover of X
    for a, and per element the number of members of Y covering it for b.
    Every a and b is the float32 arithmetic of the literal form,
    h(X + v) - h(X) - 1 and h(Y - v) - h(Y) + 1 over float32 counts.
    """
    n, dev = fn.n, fn.device
    vprime = result.vprime.to(device=dev, dtype=torch.bool)
    derived = max_members is None
    if max_members == "exact":
        max_members = int(vprime.sum())  # one sizing read (opt-in)
    elif derived:
        max_members = ss_live_bound(n, r, c)
    slots = max(1, min(n, int(max_members)))
    if derived and slots < n and int(vprime.sum()) > slots:
        # the block would silently drop members of V' and the reduction
        # would return a wrong mask
        raise ValueError(
            f"postreduce slot bound {slots} < |V'|: the SS run used a "
            "different r/c than passed here; pass matching r/c, an explicit "
            "max_members, or max_members='exact'"
        )
    if noise is None:
        noise = torch.rand((slots,), generator=generator, device=dev)
    noise = check_noise(noise, (slots,), dev)
    vp_idx = torch.where(torch.arange(slots, device=dev) < vprime.sum(),
                         compact_indices(vprime, slots), -1)
    valid = vp_idx >= 0
    members = torch.where(valid, vp_idx, 0)
    pruned = ~vprime
    cover = torch.empty((slots, n), dtype=torch.bool, device=dev)
    for lo, w in member_edges(fn, members, valid):
        cover[lo:lo + w.shape[0]] = pruned & (w <= eps)

    # The literal h takes a min over X's rows with INF for the rest, so an
    # element is covered by X iff some member of X covers it, or INF <= eps
    # (then every set, the empty one too, covers every pruned element).
    base = pruned & (torch.tensor(INF, dtype=torch.float32, device=dev) <= eps)
    cov_lo = base.clone()                         # covered by X
    n_hi = cover.sum(0, dtype=torch.int32)        # members of Y covering v
    h_lo, h_hi = cov_lo.sum(), (base | (n_hi > 0)).sum()
    prev = []                                     # the last step's (v, d_lo, d_hi)

    def gain_fn(lo: Tensor, hi: Tensor, v: int):
        nonlocal cov_lo, n_hi, h_lo, h_hi
        if prev:  # fold in the last step's decision, read from X
            u, d_lo, d_hi = prev
            kept = lo[u]
            cov_lo = cov_lo | (cover[u] & kept)
            h_lo = h_lo + d_lo * kept
            n_hi = n_hi - (cover[u] & ~kept).to(torch.int32)
            h_hi = h_hi - d_hi * ~kept
        row = cover[v]
        d_lo = (row & ~cov_lo).sum()              # newly covered by X + v
        d_hi = (row & ~base & (n_hi == 1)).sum()  # covered by v alone in Y
        prev[:] = (v, d_lo, d_hi)
        a = (h_lo + d_lo).float() - h_lo.float() - 1.0
        b = ((h_hi - d_hi).float() - h_hi.float()) + 1.0
        # Padding slots cover nothing: a = -1 < 0 <= b = +1, never kept.
        return a, b

    keep = bidirectional_greedy(gain_fn, slots, noise=noise)
    out = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    out[torch.where(valid & keep, vp_idx, n)] = True  # slot n: discarded
    return out[:n]


def member_edges(fn: SubmodularFunction, members: Tensor, valid: Tensor):
    """The (slots, n) edge weights w_{x->v} of the member slots ``members``
    (ground indices; +INF rows where ``valid`` is False), as (first slot,
    block) pairs: each block a (b, n) float32 temporary of at most 256 MiB,
    the arithmetic of :func:`graph.edge_weights`."""
    residual = fn.residual_gains()
    block = max(1, _ELEMS // max(fn.n, 1))
    for lo in range(0, members.shape[0], block):
        w = graph.edge_weights(fn, members[lo:lo + block], residual=residual)
        yield lo, torch.where(valid[lo:lo + block, None], w, INF)


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
