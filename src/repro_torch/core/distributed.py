"""Sharded SS and greedy over ``torch.distributed``: the counterpart of
``repro/core/distributed.py``.

The reference is single-controller: one process calls the loop, and its
body runs per device under ``shard_map`` with ``psum`` / ``pmax`` /
``all_gather`` over named mesh axes.  Here every rank (SPMD) calls the same
function with its own *view* of the objective (``fn.shard(mesh, axes)``:
its contiguous block of the candidates), and each named axis's collectives
go through ``mesh.get_group(axis)`` of a ``DeviceMesh`` (:class:`Collectives`).
No function here opens a process group.  Every rank returns what the
reference returns: global (n,) masks and divergences, gathered once at the
end, and replicated selections.

One SS round (:func:`ss_sparsify_sharded`):

  1. every shard draws Gumbel scores for its own candidates, proposes its
     local top m_loc and all-gathers (payload, score, residual); the global
     top m are the round's probes (Gumbel top-k: uniform sampling without
     replacement, Algorithm 1's sampler), and a shard's candidate is a probe
     iff its score reaches the m-th value;
  2. each shard computes the divergence of its own candidates against the
     replicated (m, D) payload block, one call of its backend's
     ``shard_divergence`` (the objective's kernel on the card), over a
     compacted buffer of its live candidates when one fits;
  3. the prune is a histogram quantile, not a global sort: 512 bins between
     the live divergences' min and max (a max all_reduce), the counts summed
     over the shards (an int32 all_reduce), and the live candidates below
     the bin edge at floor(live * (1 - 1/sqrt(c))) leave.

The reference's loop is a ``lax.while_loop`` and reads nothing back.  Here
the loop is Python, and it reads the host once a round: an all_gather of
every shard's [live count, live count after this round's probes] gives the
loop's condition (the total) and the compact bucket (the largest count
after the probes) in one ``tolist``.  So each round draws and proposes its
probes first, and the round that fails the condition discards them.
``ss_sparsify_sharded.host_reads`` counts the reads (rounds + 1 a run).

With a ``pod_axis`` every pod's rows form a ground set of its own
(collectives over ``data`` only) and V' is the union of the pods' V'.

Selection (:func:`greedy_sharded`, :func:`stochastic_greedy_sharded`) runs
in the frame the dense loop would pick (the compact frame of the live
candidates in ground order, or the ground frame): each step every shard
computes the gains of its own candidates (``shard_gains``: the gains kernel
on the card), all-gathers its best (gain, frame position) as one int32 pair
(the gain's float32 bits), and every rank takes the same winner, the
largest gain with ties to the lowest position (the dense argmax's order);
the replicated state advances by the all_reduce sum of the winner's
``shard_add`` and zeros elsewhere, the reference's psum form (which turns a
-0.0 of the state into +0.0; a facility-location state holds -0.0 only
where a similarity is -0.0).  Stochastic greedy's draws are replicated:
every rank passes the same (k, B) ``noise`` or a generator seeded alike.

Randomness of SS is per rank: ``noise`` (max_rounds of the pod, n_loc) on
each rank, or a generator seeded ``fold_in(fold_in(seed, pod), data)``
from the caller's generator's seed (the reference folds the data index
into each round's key).

Collectives carry float32, int32 and uint8 only (a bool mask travels as
uint8).  A CUDA tensor over a group whose backend does not take it for the
op goes through the host and back, by one rule (:func:`staged`): NCCL takes
both ops used here; gloo is given host tensors for both.
"""

from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

from repro_torch.core.backend import Backend, resolve_backend
from repro_torch.core.functions import NEG, FeatureCoverage, SubmodularFunction
from repro_torch.core.greedy import (
    GreedyResult,
    auto_sample_size,
    check_noise,
    compact_indices,
    fold_in,
    gumbel,
    selection_bucket,
)
from repro_torch.core.sparsify import (
    SSResult,
    _scatter_min,
    bucket_schedule,
    max_rounds,
    probe_count,
)

Tensor = torch.Tensor
INF = -NEG
BIG = 2**30

#: the dtypes collectives carry
WIRE_DTYPES = (torch.float32, torch.int32, torch.uint8)
#: the ops each backend takes on CUDA tensors; any other (backend, op) pair
#: is staged through the host.  Gloo's CUDA support differs by op and by
#: build, so gloo gets host tensors for every op.
CUDA_OPS = {"nccl": frozenset({"all_gather", "all_reduce"})}
_REDUCE = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}
#: collectives issued and staged, over every Collectives object
COUNTS = {"all_gather": 0, "all_reduce": 0, "staged": 0}
#: the flat all_gather: ``all_gather_single`` where this torch has it (its
#: newer name), else ``all_gather_into_tensor``; the same call either way
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def staged(group, op: str, t: Tensor) -> bool:
    """Whether ``op`` on ``t`` over ``group`` goes through the host: the one
    rule of staging, a pure rule of the group's backend, the op and the
    tensor's device (never a caught error)."""
    return t.is_cuda and op not in CUDA_OPS.get(dist.get_backend(group), ())


def _wire(t: Tensor) -> None:
    if t.dtype not in WIRE_DTYPES:
        raise TypeError(f"collectives carry {WIRE_DTYPES}; got {t.dtype}")


def _gather(t: Tensor, group, size: int) -> Tensor:
    """(size, *t.shape): every rank's ``t`` over ``group``, in rank order
    (a flat gather into one tensor, which gloo and NCCL both take)."""
    _wire(t)
    host = staged(group, "all_gather", t)
    src = (t.cpu() if host else t).contiguous().reshape(-1)
    out = torch.empty((size * src.numel(),), dtype=t.dtype, device=src.device)
    _ALL_GATHER(out, src, group=group)
    COUNTS["all_gather"] += 1
    COUNTS["staged"] += host
    out = out.reshape((size,) + tuple(t.shape))
    return out.to(t.device) if host else out


def _reduce(t: Tensor, op: str, group) -> Tensor:
    """A new tensor: the all_reduce ``op`` of every rank's ``t``."""
    _wire(t)
    host = staged(group, "all_reduce", t)
    buf = t.cpu() if host else t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=_REDUCE[op], group=group)
    COUNTS["all_reduce"] += 1
    COUNTS["staged"] += host
    return buf.to(t.device) if host else buf


class Collectives:
    """The collectives of a loop over the mesh ``axes`` (outer first), as
    one flattened axis: ``index`` is this rank's position in (outer, ...,
    inner) order, ``size`` the number of shards.  Over several axes a
    gather runs inner first, so its rows come in that order; a reduction
    runs axis by axis (exact for max and min; a sum is exact when one
    shard contributes, as the selection loop's state)."""

    def __init__(self, mesh, axes: "tuple[str, ...]"):
        self.axes = tuple(axes)
        dims = [mesh.mesh_dim_names.index(a) for a in self.axes]
        self.groups = [mesh.get_group(a) for a in self.axes]
        self.sizes = [mesh.size(d) for d in dims]
        self.index = 0
        for a, s in zip(self.axes, self.sizes):
            self.index = self.index * s + mesh.get_local_rank(a)
        self.size = math.prod(self.sizes)

    def all_gather(self, t: Tensor) -> Tensor:
        """(size, *t.shape), rows in flattened rank order."""
        out = t
        for group, size in reversed(list(zip(self.groups, self.sizes))):
            out = _gather(out, group, size)
        return out.reshape((self.size,) + tuple(t.shape))

    def all_reduce(self, t: Tensor, op: str) -> Tensor:
        """``op`` ("sum", "max" or "min") over every shard."""
        for group in reversed(self.groups):
            t = _reduce(t, op, group)
        return t


def _as_objective(fn, phi: str = "sqrt") -> SubmodularFunction:
    """The legacy entry: a raw (rows, F) tensor or array is FeatureCoverage
    (to the ``*_sharded`` functions, this rank's rows)."""
    if isinstance(fn, SubmodularFunction):
        return fn
    return FeatureCoverage(W=torch.as_tensor(fn), phi=phi)


def rank_generator(generator: "torch.Generator | None", device, *coords: int
                   ) -> torch.Generator:
    """A generator on ``device`` seeded ``fold_in`` of the caller's seed
    (``generator.initial_seed()``, else ``torch.initial_seed()``) with each
    of ``coords`` in turn (the rank's pod, then data index)."""
    seed = generator.initial_seed() if generator is not None else torch.initial_seed()
    for c in coords:
        seed = fold_in(seed, c)
    return torch.Generator(device=device).manual_seed(seed)


def _local_alive(alive: Tensor | None, n: int, lo: int, n_loc: int, device) -> Tensor:
    """This rank's slice of a global (n,) ``alive`` (all live when None)."""
    if alive is None:
        return torch.ones((n_loc,), dtype=torch.bool, device=device)
    if tuple(alive.shape) != (n,):
        raise ValueError(f"alive must be the global ({n},) mask; got {tuple(alive.shape)}")
    return alive[lo:lo + n_loc].to(device=device, dtype=torch.bool).clone()


def ss_sparsify_sharded(
    view,
    mesh,
    generator: torch.Generator | None = None,
    *,
    data_axis: str = "data",
    pod_axis: str | None = None,
    r: int = 8,
    c: float = 8.0,
    phi: str = "sqrt",
    bins: int = 512,
    alive: Tensor | None = None,
    state: Tensor | None = None,
    importance: bool = False,
    compact: bool = True,
    backend: "str | Backend | None" = None,
    noise: Tensor | None = None,
) -> SSResult:
    """Algorithm 1 over the ranks of ``mesh``, each with its ``view``
    (``fn.shard(mesh, axes)``, or a raw tensor of this rank's rows).

    ``alive`` is the global (n,) mask; ``state`` a replicated conditional
    state, folded into each probe's payload (residuals stay
    unconditional); ``importance`` weights each shard's draws by
    log(f(u) + f(u|V\\u)) of its candidates (``shard_gains``).  ``compact``
    evaluates each round over a buffer of the shard's live candidates, the
    smallest of ``bucket_schedule(n_loc, c, tile=8)`` that holds every
    shard's live count.  ``backend`` runs the view (None: by its device).
    ``noise`` is this rank's (max_rounds of its pod, n_loc) draws, in place
    of a generator (:func:`rank_generator`).  Returns the global SSResult
    on every rank; with a pod axis ``alive_trace`` is all -1 (the pods run
    loops of their own) and ``rounds`` the most a pod ran.
    """
    return _sparsify_sharded(
        _as_objective(view, phi), mesh, generator, None, data_axis=data_axis,
        pod_axis=pod_axis, r=r, c=c, bins=bins, alive=alive, state=state,
        importance=importance, compact=compact, backend=backend, noise=noise)


def _sparsify_sharded(view, mesh, generator, ctx, *, data_axis, pod_axis, r, c,
                      bins, alive, state, importance, compact, backend,
                      noise) -> SSResult:
    """The loop of :func:`ss_sparsify_sharded`, with ``ctx`` the view's
    ``shard_init`` over ``data_axis`` when the caller has it (None: made
    here)."""
    if importance and not view.supports_shard_greedy:
        raise NotImplementedError(
            f"{type(view).__name__} does not implement shard_gains: sharded "
            "importance sampling needs the per-shard singleton gains")
    if pod_axis and not view.supports_pod_sharding:
        raise NotImplementedError(
            f"{type(view).__name__} does not support pod-hierarchical sharding")
    be = resolve_backend(backend, view.device)
    comm = Collectives(mesh, (data_axis,))
    pods = Collectives(mesh, (pod_axis,)) if pod_axis else None
    pidx = pods.index if pods else 0
    npods = pods.size if pods else 1
    dev = view.device
    n_loc = view.local_n()
    n_pod = n_loc * comm.size
    m = min(probe_count(n_pod, r), n_pod)      # probes a round, per pod
    m_loc = min(m, n_loc)                      # each shard proposes its top m_loc
    rounds_cap = max_rounds(n_pod, r, c)
    shrink = torch.tensor(1.0 - 1.0 / math.sqrt(c), dtype=torch.float32, device=dev)
    compact = compact and view.supports_shard_compact
    buckets = bucket_schedule(n_loc, c, tile=8) if compact else None
    if noise is not None:
        noise = check_noise(noise, (rounds_cap, n_loc), dev)
        gen = None
    else:
        gen = rank_generator(generator, dev, pidx, comm.index)

    first = (pidx * comm.size + comm.index) * n_loc
    alive = _local_alive(alive, n_pod * npods, first, n_loc, dev)
    ctx = view.shard_init(comm) if ctx is None else ctx
    resid = view.shard_residuals(ctx).float()
    if importance:
        sing = be.shard_gains(view, view.empty_state(), ctx).float()
        logits = torch.log(torch.clamp_min(sing + resid, 1e-12))
    else:
        logits = torch.zeros((n_loc,), dtype=torch.float32, device=dev)

    vprime = torch.zeros((n_loc,), dtype=torch.bool, device=dev)
    div = torch.full((n_loc,), INF, dtype=torch.float32, device=dev)
    eps = torch.tensor(NEG, dtype=torch.float32, device=dev)
    slots = torch.arange(n_loc, device=dev)
    trace = [-1] * rounds_cap
    rnd = 0
    while True:
        # (1) this round's probes, proposed before the condition is read
        if rnd < rounds_cap:
            draw = noise[rnd] if noise is not None else gumbel(n_loc, gen, dev)
            g = draw + logits + torch.where(alive, 0.0, NEG)
            probes, last, _, _ = _propose(view, comm, g, m, m_loc, resid, state)
            hot = alive & (g >= last)
            after = (alive & ~hot).sum()
        else:
            after = alive.sum()
        counts = comm.all_gather(torch.stack([alive.sum(), after]).to(torch.int32))
        live, left = zip(*counts.tolist())           # the round's one host read
        ss_sparsify_sharded.host_reads += 1
        if rnd:
            trace[rnd - 1] = sum(live)
        if sum(live) <= m or rnd >= rounds_cap:
            break
        vprime |= hot
        alive &= ~hot

        # (2) the divergence of this shard's live candidates
        payloads, resid_p = probes[:, :-2], probes[:, -1]
        size = min(b for b in buckets if b >= max(left)) if compact else n_loc
        if size >= n_loc:
            div = torch.minimum(div, be.shard_divergence(view, payloads, resid_p, ctx))
        else:
            cand_idx = compact_indices(alive, size)
            w = be.shard_divergence(view, payloads, resid_p, ctx, cand_idx)
            div = _scatter_min(div, w, cand_idx, left[comm.index], slots)

        # (3) the histogram quantile
        thresh = _cut(comm, div, alive, bins, shrink)[0]
        removed = alive & (div < thresh)
        eps = torch.maximum(eps, torch.where(removed, div, NEG).max())
        alive &= ~removed
        rnd += 1

    # the tail joins V'; eps and the masks cross the data axis (and pods)
    vprime |= alive
    eps = comm.all_reduce(eps.reshape(1), "max")
    if pods:
        eps = pods.all_reduce(eps, "max")
        rnd = int(pods.all_reduce(torch.tensor([rnd], dtype=torch.int32, device=dev),
                                  "max")[0])
        ss_sparsify_sharded.host_reads += 1
        trace = [-1] * rounds_cap
    every = Collectives(mesh, (pod_axis, data_axis) if pod_axis else (data_axis,))
    vprime = every.all_gather(vprime.to(torch.uint8)).reshape(-1).bool()
    div = every.all_gather(div).reshape(-1)
    return SSResult(vprime, div, torch.clamp_min(eps[0], 0.0), rnd,
                    torch.tensor(trace, dtype=torch.int32))


ss_sparsify_sharded.host_reads = 0


def _propose(view, comm, g: Tensor, m: int, m_loc: int, resid: Tensor,
             state: Tensor | None):
    """(1) of a round: each shard's top ``m_loc`` of its scores ``g``, their
    (payload, score, residual) rows all-gathered, and the global top m.
    Returns (the probes' rows (m, D + 2), the m-th score, this shard's
    proposals (m_loc,), the probes' positions among the gathered rows)."""
    loc_val, loc_idx = torch.topk(g, m_loc)
    wire = torch.cat([view.shard_payloads(loc_idx, state), loc_val[:, None],
                      resid[loc_idx][:, None]], dim=1)
    allw = comm.all_gather(wire).reshape(-1, wire.shape[1])
    top_val, top_pos = torch.topk(allw[:, -2], m)
    return allw[top_pos], top_val[-1], loc_idx, top_pos


def _cut(comm, div: Tensor, alive: Tensor, bins: int, shrink: Tensor):
    """(3) of a round, the histogram quantile in the reference's float32
    order: ``bins`` bins between the live divergences' min and max over the
    shards, the counts summed (int32), and the edge of the last bin whose
    cumulative count is at most floor(live * shrink).  Returns (thresh, lo,
    width, hist): the round prunes the live candidates below thresh."""
    ext = torch.stack([-torch.where(alive, div, INF).min(),
                       torch.where(alive, div, -INF).max()])
    ext = comm.all_reduce(ext, "max")              # -min and max, exact
    lo, hi = -ext[0], ext[1]
    width = torch.clamp_min(hi - lo, 1e-9)
    b = torch.where(alive, (div - lo) / width * bins, 0.0).to(torch.int32)
    b = torch.where(alive, b.clamp(0, bins - 1), bins).long()
    hist = torch.zeros((bins + 1,), dtype=torch.int32, device=div.device).scatter_add_(
        0, b, torch.ones_like(b, dtype=torch.int32))[:bins]
    hist = comm.all_reduce(hist, "sum")
    target = torch.floor(hist.sum().to(torch.float32) * shrink)
    nbin = (torch.cumsum(hist, 0) <= target).sum()
    return lo + width * nbin.to(torch.float32) / bins, lo, width, hist


def greedy_sharded(
    view,
    k: int,
    mesh,
    *,
    alive: Tensor | None = None,
    state: Tensor | None = None,
    compact: bool | None = None,
    data_axis: str = "data",
    c: float = 8.0,
    phi: str = "sqrt",
    backend: "str | Backend | None" = None,
) -> GreedyResult:
    """Exact greedy over the ranks of ``mesh`` (the frame and the argmax of
    the module's note; every available candidate competes each step), each
    rank with its ``view``.  Selection-identical to the dense ``greedy`` on
    the same inputs.  ``alive`` is the global (n,) mask; ``state`` a
    replicated start.  Requires ``supports_shard_greedy``."""
    return _select_sharded(view, k, mesh, (data_axis,), None, s=None, alive=alive,
                           state=state, compact=compact, c=c, eps=0.1, phi=phi,
                           exact=True, backend=backend, noise=None, ctx=None)


def stochastic_greedy_sharded(
    view,
    k: int,
    mesh,
    generator: torch.Generator | None = None,
    *,
    s: int | None = None,
    alive: Tensor | None = None,
    state: Tensor | None = None,
    compact: bool | None = None,
    data_axis: str = "data",
    c: float = 8.0,
    eps: float = 0.1,
    phi: str = "sqrt",
    backend: "str | Backend | None" = None,
    noise: Tensor | None = None,
) -> GreedyResult:
    """Stochastic greedy over the ranks of ``mesh``: each step's sample is
    the top ``s`` of replicated Gumbel draws over the frame (``noise`` (k,
    B), B the frame's width, the same on every rank, or ``generator``,
    seeded alike on every rank), the lower position first on ties, and the
    winner is the sample's best, as in the dense loop, so the two select
    alike under the same draws.  ``s=None`` derives it from the live
    count."""
    return _select_sharded(view, k, mesh, (data_axis,), generator, s=s, alive=alive,
                           state=state, compact=compact, c=c, eps=eps, phi=phi,
                           exact=False, backend=backend, noise=noise, ctx=None)


def _select_sharded(view, k, mesh, axes, generator, *, s, alive, state, compact,
                    c, eps, phi, exact, backend, noise, ctx) -> GreedyResult:
    """The selection loop of :func:`greedy_sharded` and
    :func:`stochastic_greedy_sharded` over the flattened ``axes``, with
    ``ctx`` the view's ``shard_init`` over them when the caller has it.
    One host read a run (the shards' live counts, from the global mask)."""
    view = _as_objective(view, phi)
    if not view.supports_shard_greedy:
        raise NotImplementedError(
            f"{type(view).__name__} does not implement the sharded selection "
            "hooks (shard_gains / shard_add)")
    be = resolve_backend(backend, view.device)
    comm = Collectives(mesh, axes)
    dev = view.device
    S, didx, n_loc = comm.size, comm.index, view.local_n()
    n = n_loc * S
    alive0 = (torch.ones((n,), dtype=torch.bool, device=dev) if alive is None
              else alive.to(device=dev, dtype=torch.bool))
    if tuple(alive0.shape) != (n,):
        raise ValueError(f"alive must be the global ({n},) mask; got "
                         f"{tuple(alive0.shape)}")
    loc_counts = alive0.reshape(S, n_loc).sum(dim=1).tolist()   # the one read
    _select_sharded.host_reads += 1
    live = sum(loc_counts)
    # the dense plan's frame: compact iff the dense loop would compact
    bucket = None if compact is False else selection_bucket(n, live, c)
    B = n if bucket is None else bucket
    if bucket is not None:
        fits = [b for b in bucket_schedule(n_loc, c, tile=8) if b >= max(loc_counts)]
        loc_size = min(fits) if fits else n_loc
    else:
        loc_size = n_loc
    if exact:
        s = B
    elif s is None:
        s = auto_sample_size(n, k, eps, live=live)
    s = max(1, int(min(s, B)))
    if noise is not None:
        noise = check_noise(noise, (k, B), dev)

    alive_loc = alive0[didx * n_loc:(didx + 1) * n_loc]
    if bucket is not None:
        # local candidates and their compact-frame positions: shards hold
        # contiguous ground ranges, so the position is the alive rank
        lidx = compact_indices(alive_loc, loc_size)
        lvalid = torch.arange(loc_size, device=dev) < loc_counts[didx]
        pos = sum(loc_counts[:didx]) + torch.arange(loc_size, device=dev)
        local = view.shard_take(lidx)
        avail = torch.arange(B, device=dev) < live
        ground = compact_indices(alive0, B)          # frame position -> index
    else:
        lidx = torch.arange(n_loc, device=dev)
        lvalid = torch.ones((n_loc,), dtype=torch.bool, device=dev)
        pos = didx * n_loc + lidx
        local = view
        avail = alive0.clone()
        ground = None
    pos_c = pos.clamp_max(B - 1)
    frame = torch.arange(B, device=dev)
    ctx = view.shard_init(comm) if ctx is None else ctx
    st = view.empty_state() if state is None else state.clone()

    sel, gains = [], []
    for i in range(k):
        if exact:
            sub = avail
        else:
            g = noise[i] if noise is not None else gumbel(B, generator, dev)
            g = g + torch.where(avail, 0.0, NEG)
            top = torch.sort(g, descending=True, stable=True).indices[:s]
            sub = torch.zeros_like(avail).index_fill_(0, top, True) & avail
        g = torch.where(sub.gather(0, pos_c) & lvalid,
                        be.shard_gains(local, st, ctx).float(), NEG)
        i_loc = torch.argmax(g, dim=0, keepdim=True)
        gbest = g.gather(0, i_loc)
        pbest = pos.gather(0, i_loc).to(torch.int32)
        both = comm.all_gather(torch.cat([gbest.view(torch.int32), pbest]))
        all_g = both[:, 0].contiguous().view(torch.float32)
        gmax = all_g.max()
        ok = gmax > NEG * 0.5
        pos_win = torch.where(all_g >= gmax, both[:, 1], BIG).min()
        win = ok & (gbest[0] >= gmax) & (pbest[0] == pos_win)
        cand = view.shard_add(st, lidx.gather(0, i_loc)[0], ctx)
        summed = comm.all_reduce(torch.where(win, cand, 0.0).float(), "sum")
        st = torch.where(ok, summed.to(st.dtype), st)
        v = pos_win.long() if ground is None else ground.gather(
            0, pos_win.long().clamp_max(B - 1).reshape(1))[0]
        avail = avail & ~((frame == pos_win) & ok)
        sel.append(torch.where(ok, v, 0).reshape(1))
        gains.append(torch.where(ok, gmax, 0.0).reshape(1))
    return GreedyResult(torch.cat(sel), torch.cat(gains), view.shard_value(st, ctx), st)


_select_sharded.host_reads = 0


def summarize_sharded(
    view,
    k: int,
    mesh,
    generator: torch.Generator | None = None,
    *,
    data_axis: str = "data",
    pod_axis: str | None = None,
    r: int = 8,
    c: float = 8.0,
    phi: str = "sqrt",
    bins: int = 512,
    backend: "str | Backend | None" = None,
    noise: Tensor | None = None,
) -> tuple[GreedyResult, SSResult]:
    """Sharded SS, then sharded exact greedy over V' (``alive`` = V').  The
    reference runs dense greedy on the whole objective; this runs
    :func:`greedy_sharded`, selection-identical to it, so that no rank
    holds the whole objective.  With a pod axis the greedy runs over the
    flattened (pod, data) mesh, whose shards hold the same rows.  Returns
    (GreedyResult, SSResult), as the dense ``summarize``."""
    view = _as_objective(view, phi)
    # one shard_init over the data axis serves both loops (with pods the
    # greedy's context spans the whole mesh, and is its own)
    ctx = view.shard_init(Collectives(mesh, (data_axis,)))
    ss = _sparsify_sharded(view, mesh, generator, ctx, data_axis=data_axis,
                           pod_axis=pod_axis, r=r, c=c, bins=bins, alive=None,
                           state=None, importance=False, compact=True,
                           backend=backend, noise=noise)
    axes = (pod_axis, data_axis) if pod_axis else (data_axis,)
    res = _select_sharded(view, k, mesh, axes, None, s=None, alive=ss.vprime,
                          state=None, compact=None, c=c, eps=0.1, phi=phi,
                          exact=True, backend=backend, noise=None,
                          ctx=None if pod_axis else ctx)
    return res, ss


# ---------------------------------------------------------------------------
# DTensor's collectives over gloo on a card
# ---------------------------------------------------------------------------

#: the functional collective (``torch.ops._c10d_functional``) that gloo
#: refuses on a CUDA tensor: run natively it ends the process
#: (``chip_dtensor_probe.py``), where it takes DTensor's all_reduce,
#: reduce_scatter_tensor, all_to_all_single and broadcast
STAGED_OP = "all_gather_into_tensor"
#: the staged calls, by op; the bytes of their inputs and the seconds they
#: took (host clock, copies included)
STAGED = {STAGED_OP: 0}
STAGED_BYTES = [0]
STAGED_SECONDS = [0.0]
_STAGING = []


def stage_functional_collectives() -> bool:
    """Route DTensor's all-gather of a CUDA tensor over gloo through the
    host.  The one rule, as :func:`staged`: a process whose default group
    is gloo stages :data:`STAGED_OP` on a CUDA tensor, the one functional
    collective that gloo refuses there; every other collective goes to
    gloo as it is, and a process on NCCL installs nothing.  The staged
    all-gather runs as the sum all-reduce of a page-locked zero buffer
    holding this rank's block: the same elements (a -0.0 gathered becomes
    +0.0).  Returns whether staging is on."""
    if _STAGING:
        return True
    if dist.get_backend() != "gloo":
        return False
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl(STAGED_OP, _host_all_gather, "CUDA")
    _STAGING.append(lib)
    return True


def _host_all_gather(x: Tensor, size: int, group_name: str) -> Tensor:
    if x.dtype == torch.bool:      # gloo sums bytes, not bools
        return _host_all_gather(x.view(torch.uint8), size, group_name).view(torch.bool)
    group = dist.distributed_c10d._resolve_process_group(group_name)
    if dist.get_backend(group) != "gloo":
        raise RuntimeError(f"{STAGED_OP}: staging serves gloo groups, not "
                           f"{dist.get_backend(group)}")
    t0 = time.perf_counter()
    n = x.shape[0]
    buf = torch.empty((size * n,) + tuple(x.shape[1:]), dtype=x.dtype, pin_memory=True)
    r = dist.get_group_rank(group, dist.get_rank())
    buf[:r * n].zero_()
    buf[(r + 1) * n:].zero_()
    buf[r * n:(r + 1) * n].copy_(x)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    out = buf.to(x.device)
    STAGED[STAGED_OP] += 1
    STAGED_BYTES[0] += x.numel() * x.element_size()
    STAGED_SECONDS[0] += time.perf_counter() - t0
    return out
