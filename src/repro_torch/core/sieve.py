"""Sieve streaming [Badanidiyuru et al., KDD 2014]: one-pass streaming
submodular maximization over T threshold sieves, on the card.

The counterpart of ``repro/core/sieve.py``, with its names and semantics.
Sieve j takes element v iff |S_j| < k and

    f(v | S_j) >= (v_j / 2 - f(S_j)) / (k - |S_j|),

with the gain in the reference's literal form value(add(S_j, v)) -
value(S_j), in float32.  The guesses v_j are the legacy grid ``ratios * m``
(m the running max singleton gain) or, with ``eps``, the absolute lattice
(1+eps)^j over the window [m, 2 k m], whose slots are recycled (reset empty)
as m grows.

The reference runs one ``lax.scan`` step per element.  Here the stream is
walked in chunks, exactly:

- the empty state's row of the gain table gives every element's singleton
  gain, and m(t) is their running max (``torch.cummax``, exact);
- the guesses and the resets of every (sieve, element) follow from m(t)
  alone (:func:`_slide_window_run`, a closed form of the reference's
  per-step recurrence, whose one-element case is :func:`_slide_window`), so
  given m(t) the sieves are independent;
- a sieve's state changes only when it takes an element or is reset, so a
  round builds the table of the live sieves against the chunk (the
  objective's ``sieve_elements``, through ``Backend.sieve_table``:
  ``csrc/sieve_gains.cu`` on the card), applies
  every sieve's first take or reset after its cursor at once, and the next
  round recomputes only the rows of the sieves that took one, from their
  cursors on.  One host read a round learns which sieves changed; rounds
  per chunk are at most 1 + the most changes of any sieve there.

Each table entry is summed in one fixed order over the feature (or served
row) axis, whatever the chunk or the launch, so ``sieve_extend`` over a
stream, repeated ``sieve_update`` and ``sieve_streaming`` give identical
bits, and the card's route is held to the plain route decision for decision
(``chip_smoke.py``).  ``sieve_extend.chunks``, ``.rounds`` and
``.host_reads`` count the walk's work.

The row sieve (:func:`stream_sieve_init`, :func:`stream_sieve_update`) is
the reference's unbounded-stream form over (F,) feature rows, one row per
call, as torch ops over the (T, F) coverage.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.backend import resolve_backend
from repro_torch.core.functions import SubmodularFunction
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import _phi

Tensor = torch.Tensor

__all__ = [
    "STREAM_PHIS", "SieveResult", "SieveState", "StreamSieveState",
    "sieve_best", "sieve_extend", "sieve_init", "sieve_streaming",
    "sieve_update", "stream_sieve_best", "stream_sieve_init",
    "stream_sieve_update", "threshold_grid",
]

#: phi transforms valid for the row-streaming sieve: phi(0) = 0 and no
#: ground-set-dependent saturation cap ("satcov" needs column sums over a
#: ground set that an unbounded stream does not have).
STREAM_PHIS = ("sqrt", "log1p", "setcover", "linear")

# The chunk walk: chunks grow from FIRST_CHUNK elements by doubling (the
# first elements change the sieves most, and a change costs a recompute of
# the rest of its chunk) up to MAX_CHUNK, or the objective's own
# ``sieve_chunk`` where that is less.
FIRST_CHUNK = 64
MAX_CHUNK = 8192


class SieveResult(NamedTuple):
    selected: Tensor    # (k,) the best sieve's picks (pad = -1)
    value: Tensor       # f(S) of the best sieve
    best_sieve: Tensor  # index of the winning threshold
    thresholds: Tensor  # (T,) the OPT guesses used


class SieveState(NamedTuple):
    """Persistent state of an incremental sieve run.

    Geometric mode (``jidx`` a tensor): sieve j's guess is (1+eps)^jidx[j]
    (``lg`` = log(1+eps)), recycled when m outgrows the window [m, 2 k m].
    Legacy mode (``jidx`` None): guesses are ``ratios * m``.  ``sel`` holds
    the stream values each sieve took (pad = -1); ``t`` counts elements."""

    ratios: Tensor   # (T,) legacy grid (initial guesses otherwise)
    states: Tensor   # (T, L) float32 per-sieve objective states
    vals: Tensor     # (T,) float32 f(S_j)
    counts: Tensor   # (T,) int32 |S_j|
    sel: Tensor      # (T, k) int32 accepted elements (pad = -1)
    m: Tensor        # () float32 running max singleton gain
    t: Tensor        # () int32 elements consumed
    jidx: Tensor | None = None   # (T,) int32 guess exponents (geometric)
    lg: Tensor | None = None     # () float32 log(1+eps) (geometric)


def _grid_size(k: int, eps: float) -> int:
    if eps <= 0:
        raise ValueError(f"eps must be positive; got {eps}")
    return max(1, math.ceil(math.log(2.0 * k) / math.log1p(eps)) + 1)


def _f32_log10(x: float) -> np.float32:
    """float32 log10 as the reference evaluates it: log(x) * (1 / ln 10),
    each rounded to float32."""
    return np.float32(np.float32(math.log(np.float32(x)))
                      * np.float32(1.0 / math.log(10.0)))


def threshold_grid(
    k: int, eps: float | None = None, num_thresholds: int | None = None,
    device="cuda",
) -> Tensor:
    """The initial OPT-guess grid, float32.

    With ``eps``: the lattice (1+eps)^j for j = 0..T-1, T = ceil(log(2k) /
    log(1+eps)) + 1, enough slots to cover the window [m, 2 k m].  Without:
    the legacy ``num_thresholds`` (default 50) log-spaced ratios over
    [1/2, 2k], relative to the running max.

    The reference's float32 evaluation: the lattice as float32 (1+eps)
    raised to j; the legacy grid as ``jnp.logspace`` computes it, 10 to the
    power of start (1 - i/d) + i (stop/d) (d = T - 1, start and stop the
    float32 log10 of 1/2 and 2k), with the last multiply-add rounded once as
    the reference's compiled form does.  Each power is rounded once from
    float64.  XLA's own float32 log and its choice of which product to fuse
    can put an entry one ulp away (tests/test_torch_sieve.py counts them)."""
    dev = resolve_device(device)
    if eps is not None:
        T = _grid_size(k, eps)
        base = np.float64(np.float32(1.0 + eps))
        vals = base ** np.arange(T, dtype=np.float64)
    else:
        T = 50 if num_thresholds is None else num_thresholds
        start, stop = _f32_log10(0.5), _f32_log10(2.0 * k)
        if T == 1:
            lin = np.array([start], np.float32)
        else:
            d = T - 1
            c = np.float32(1.0 / d)
            i = np.arange(d, dtype=np.float32)
            head = (start * (np.float32(1.0) - i * c)).astype(np.float32)
            lin = (i.astype(np.float64) * np.float64(np.float32(stop * c))
                   + head.astype(np.float64)).astype(np.float32)
            lin = np.append(lin, stop)
        vals = 10.0 ** lin.astype(np.float64)
    return torch.tensor(vals.astype(np.float32), device=dev)


def _exp_f32(x: Tensor) -> Tensor:
    """float32 exp of a float32 tensor, rounded once from float64."""
    return torch.exp(x.double()).float()


def _jmin(m: Tensor, lg: Tensor) -> Tensor:
    """The lowest guess exponent in the window of running max m:
    ceil(log(max(m, 1e-30)) / lg) where m > 0, else 0 (int64)."""
    j = torch.ceil(torch.log(torch.clamp_min(m, 1e-30)) / lg).to(torch.int32)
    return torch.where(m > 0, j, 0).long()


def _slide_window(jidx: Tensor, lg: Tensor, m_prev: Tensor, m: Tensor):
    """The reference's step: slide the absolute-guess window up to the new
    running max ``m`` (a 0-d tensor) after one element.  Returns ``(jidx',
    thresholds, reset)``, each (T,): :func:`_slide_window_run` over a run of
    one."""
    j, thr, reset = _slide_window_run(jidx, lg, m_prev, m.reshape(1))
    return j[:, 0], thr[:, 0], reset[:, 0]


def _slide_window_run(jidx: Tensor, lg: Tensor, m_prev: Tensor, m: Tensor):
    """The window over a run of elements, in closed form.

    ``m`` (C,) is the running max after each element, ``m_prev`` the one
    before the first.  Returns ``(jidx, thresholds, reset)``, each (T, C):
    slot j's guess exponent, its guess (1+eps)^jidx and whether it was reset
    at that element.  While the running max before an element is <= 0, the
    element re-anchors every slot at jmin + j and resets it; after that,
    slot j's exponent is the least value >= the highest jmin so far that is
    congruent to its anchor mod T, and the slot resets exactly where that
    value changes (any number of wraps at once), as the reference's step
    does one element at a time: slots whose guess fell below jmin are re-keyed
    a whole number of T notches up and reset."""
    T = jidx.shape[0]
    C = m.shape[0]
    dev = m.device
    jmin = _jmin(m, lg)                                       # (C,)
    prev = torch.cat([m_prev.reshape(1), m[:-1]])
    first = prev <= 0                                         # a prefix
    f = first.sum()
    ar = torch.arange(T, device=dev)
    last = jmin.index_select(0, (f - 1).clamp_min(0).reshape(1))
    anchor = torch.where(f > 0, last + ar, jidx.long())       # (T,)
    after = torch.arange(C, device=dev) >= f
    low = torch.cummax(torch.where(after, jmin, torch.iinfo(torch.int64).min),
                       0).values                              # (C,)
    gap = low[None, :] - anchor[:, None]
    wraps = torch.clamp_min(-torch.div(-gap, T, rounding_mode="floor"), 0)
    traj = torch.where(after[None, :], anchor[:, None] + T * wraps,
                       jmin[None, :] + ar[:, None])
    before = torch.cat([jidx.long()[:, None], traj[:, :-1]], dim=1)
    reset = first[None, :] | (traj != before)
    thr = _exp_f32(traj.to(torch.float32) * lg)
    return traj.to(torch.int32), thr, reset


def sieve_init(
    fn: SubmodularFunction,
    k: int,
    eps: float | None = None,
    num_thresholds: int | None = None,
) -> SieveState:
    """Fresh incremental sieve state for ``fn`` under budget ``k``, on the
    objective's device."""
    dev = fn.device
    ratios = threshold_grid(k, eps, num_thresholds, device=dev)
    T = ratios.shape[0]
    empty = fn.empty_state()
    if empty.dtype != torch.float32:
        raise TypeError(f"sieve streaming runs float32 objectives; the state is "
                        f"{empty.dtype}")
    geometric = eps is not None
    return SieveState(
        ratios=ratios,
        states=empty.expand(T, -1).clone(),
        vals=torch.zeros((T,), dtype=torch.float32, device=dev),
        counts=torch.zeros((T,), dtype=torch.int32, device=dev),
        sel=torch.full((T, k), -1, dtype=torch.int32, device=dev),
        m=torch.zeros((), dtype=torch.float32, device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev),
        jidx=torch.arange(T, dtype=torch.int32, device=dev) if geometric else None,
        lg=(torch.tensor(np.float32(math.log1p(eps)), device=dev)
            if geometric else None),
    )


# -- the walk ----------------------------------------------------------------


def _chunk_sizes(n: int, chunk: int | None, largest: int):
    """Chunk sizes covering n elements: ``chunk`` each, or FIRST_CHUNK
    doubling up to ``largest``."""
    size = chunk if chunk is not None else min(FIRST_CHUNK, largest)
    done = 0
    while done < n:
        c = min(size, n - done)
        yield c
        done += c
        if chunk is None:
            size = min(2 * size, largest)


def _walk(fn: SubmodularFunction, state: SieveState, stream, backend,
          chunk: int | None) -> SieveState:
    """The chunk walk of :func:`sieve_extend`, in chunks of ``chunk``
    elements (None: growing from FIRST_CHUNK)."""
    dev = fn.device
    be = resolve_backend(backend, dev)
    stream = torch.as_tensor(stream, device=dev).long().reshape(-1)
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be positive; got {chunk}")
    T, k = state.sel.shape
    S, vals, counts, sel = state.states, state.vals, state.counts, state.sel
    m, t, jidx = state.m, state.t, state.jidx
    geometric = jidx is not None
    empty = torch.zeros((1, S.shape[1]), dtype=torch.float32, device=dev)
    limit = fn.sieve_chunk()
    largest = MAX_CHUNK if limit is None else max(1, min(MAX_CHUNK, limit))
    counts_host = counts.tolist()
    sieve_extend.host_reads += 1
    lo = 0
    for C in _chunk_sizes(stream.shape[0], chunk, largest):
        cs = stream[lo:lo + C]
        lo += C
        sieve_extend.chunks += 1
        el = fn.sieve_elements(cs)
        # every element's singleton gain (the empty state's row) and the
        # rows of the sieves that can still take an element
        live = torch.tensor([j for j in range(T) if counts_host[j] < k],
                            dtype=torch.int64, device=dev)
        tab = be.sieve_table(fn, torch.cat([empty, S.index_select(0, live)]), el)
        g1 = tab[0, :C] - tab[0, C]
        G = torch.zeros((T, C), dtype=torch.float32, device=dev)
        G[live] = tab[1:, :C] - tab[1:, C:]
        mm = torch.maximum(torch.cummax(g1, 0).values, m)
        if geometric:
            jt, thr, reset = _slide_window_run(jidx, state.lg, m, mm)
        else:
            thr = state.ratios[:, None] * mm[None, :]
        col = torch.arange(C, device=dev)[None, :]
        cursor = torch.zeros((T,), dtype=torch.int64, device=dev)
        rdone = torch.zeros((T,), dtype=torch.bool, device=dev)
        while True:
            sieve_extend.rounds += 1
            valid = col >= cursor[:, None]
            need = (thr / 2.0 - vals[:, None]) / torch.clamp_min(k - counts, 1)[:, None]
            take = valid & (counts < k)[:, None] & (G >= need)
            if geometric:
                due = reset & valid & ~((col == cursor[:, None]) & rdone[:, None])
                event = take | due
            else:
                event = take
            has = event.any(dim=1)
            e = torch.argmax(event.to(torch.uint8), dim=1)   # the first event
            if geometric:
                is_reset = has & due.gather(1, e[:, None])[:, 0]
            else:
                is_reset = torch.zeros_like(has)
            is_take = has & ~is_reset
            # takes: S + v, f(S) + g, sel[count] = v
            g = G.gather(1, e[:, None])[:, 0]
            S = torch.where(is_take[:, None], el.add(S, e), S)
            slot = torch.clamp_max(counts.long(), k - 1)[:, None]
            picked = sel.scatter(1, slot, cs.index_select(0, e).int()[:, None])
            sel = torch.where(is_take[:, None], picked, sel)
            vals = torch.where(is_take, vals + g, vals)
            counts = counts + is_take.int()
            if geometric:   # resets: the empty state, whose row is g1
                S = torch.where(is_reset[:, None], 0.0, S)
                vals = torch.where(is_reset, 0.0, vals)
                counts = torch.where(is_reset, 0, counts)
                sel = torch.where(is_reset[:, None], -1, sel)
                G = torch.where(is_reset[:, None], g1[None, :], G)
            cursor = torch.where(is_take, e + 1, torch.where(is_reset, e, C))
            rdone = is_reset
            # the round's one host read: which sieves changed, and where
            taken, was_reset, cur = torch.stack(
                [is_take.long(), is_reset.long(), cursor]).tolist()
            sieve_extend.host_reads += 1
            if not any(taken) and not any(was_reset):
                break
            redo = []
            for j in range(T):
                if was_reset[j]:
                    counts_host[j] = 0
                if taken[j]:
                    counts_host[j] += 1
                    if counts_host[j] < k and cur[j] < C:
                        redo.append(j)
            if redo:
                rows = torch.tensor(redo, dtype=torch.int64, device=dev)
                part = be.sieve_table(fn, S.index_select(0, rows), el,
                                      start=cursor.index_select(0, rows))
                G[rows] = part[:, :C] - part[:, C:]
        m = mm[-1]
        t = t + C
        if geometric:
            jidx = jt[:, -1].contiguous()
        del el   # a matrix-free chunk's 1 GiB of columns, before the next's
    return state._replace(states=S, vals=vals, counts=counts, sel=sel, m=m,
                          t=t, jidx=jidx)


def sieve_extend(fn: SubmodularFunction, state: SieveState, stream, *,
                 backend=None) -> SieveState:
    """Consume a stream of elements (indices into ``fn``'s ground set).

    Walks the stream in chunks growing from FIRST_CHUNK; the result does not
    depend on the chunking, and equals :func:`sieve_update` per element bit
    for bit.  ``backend`` as in ``greedy``: by default the kernel on the
    card, the plain table on the CPU; "reference" runs the plain table on
    the card."""
    return _walk(fn, state, stream, backend, None)


sieve_extend.chunks = 0
sieve_extend.rounds = 0
sieve_extend.host_reads = 0


def sieve_update(fn: SubmodularFunction, state: SieveState, v, *,
                 backend=None) -> SieveState:
    """Consume one stream element (an index into ``fn``'s ground set): a
    chunk of one."""
    return _walk(fn, state, torch.as_tensor(v).reshape(1), backend, 1)


def sieve_best(state: SieveState) -> SieveResult:
    """The winning sieve's selections: the algorithm's output set."""
    best = torch.argmax(state.vals)
    if state.jidx is None:
        thr = state.ratios * state.m
    else:
        thr = _exp_f32(state.jidx.to(torch.float32) * state.lg)
    at = best.reshape(1)
    return SieveResult(state.sel.index_select(0, at)[0],
                       state.vals.index_select(0, at)[0], best, thr)


def sieve_streaming(
    fn: SubmodularFunction,
    k: int,
    stream=None,
    num_thresholds: int = 50,
    eps: float | None = None,
    *,
    backend=None,
) -> SieveResult:
    """Run sieve streaming over ``stream`` (default 0..n-1 order).

    ``eps`` selects the geometric threshold set with the (1/2 - eps)
    guarantee (``num_thresholds`` is then ignored); without it the legacy
    fixed-count log-spaced grid is used (the paper's 50 trials)."""
    if stream is None:
        stream = torch.arange(fn.n, device=fn.device)
    state = sieve_init(fn, k, eps=eps,
                       num_thresholds=None if eps is not None else num_thresholds)
    return sieve_best(sieve_extend(fn, state, stream, backend=backend))


# -- the row-streaming sieve --------------------------------------------------


class StreamSieveState(NamedTuple):
    """Persistent per-stream sieve state over (F,) feature rows of a
    concave-over-modular coverage objective; always geometric.  ``sel``
    holds the stream positions each sieve took."""

    jidx: Tensor     # (T,) int32 guess exponents
    lg: Tensor       # () float32 log(1+eps)
    cov: Tensor      # (T, F) per-sieve coverage vectors
    vals: Tensor     # (T,) float32 f(S_j)
    counts: Tensor   # (T,) int32 |S_j|
    sel: Tensor      # (T, k) int32 accepted stream positions (pad = -1)
    m: Tensor        # () float32 running max singleton gain
    t: Tensor        # () int32 elements consumed (the stream position)


def stream_sieve_init(k: int, n_features: int, eps: float = 0.2,
                      dtype=torch.float32, device="cuda") -> StreamSieveState:
    """Fresh row-streaming sieve state (the geometric lattice of ``eps``),
    on ``device``: the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    T = _grid_size(k, eps)
    return StreamSieveState(
        jidx=torch.arange(T, dtype=torch.int32, device=dev),
        lg=torch.tensor(np.float32(math.log1p(eps)), device=dev),
        cov=torch.zeros((T, n_features), dtype=dtype, device=dev),
        vals=torch.zeros((T,), dtype=torch.float32, device=dev),
        counts=torch.zeros((T,), dtype=torch.int32, device=dev),
        sel=torch.full((T, k), -1, dtype=torch.int32, device=dev),
        m=torch.zeros((), dtype=torch.float32, device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev),
    )


def stream_sieve_update(state: StreamSieveState, w, phi: str = "sqrt"
                        ) -> tuple[StreamSieveState, Tensor]:
    """Consume one stream element, its (F,) nonnegative feature row.

    Returns ``(new_state, accepted)``, ``accepted`` a 0-d bool tensor, True
    iff any sieve took the element.  The reference's arithmetic: singleton
    gain sum phi(w), gains sum [phi(c + w) - phi(c)].  Reads nothing back to
    the host."""
    if phi not in STREAM_PHIS:
        raise ValueError(f"stream sieve supports phi in {STREAM_PHIS}; got {phi!r}")
    k = state.sel.shape[1]
    w = torch.as_tensor(w, device=state.cov.device)
    if w.dtype == torch.float64:
        # jnp.asarray with x64 off: a float64 row becomes float32, and the
        # state stays float32
        w = w.float()
    g1 = _phi(phi, w, None).sum()
    m = torch.maximum(state.m, g1)
    jidx, thr, reset = _slide_window(state.jidx, state.lg, state.m, m)
    cov_b = torch.where(reset[:, None], 0.0, state.cov)
    vals_b = torch.where(reset, 0.0, state.vals)
    counts_b = torch.where(reset, 0, state.counts)
    sel_b = torch.where(reset[:, None], -1, state.sel)
    g = (_phi(phi, cov_b + w[None, :], None) - _phi(phi, cov_b, None)).sum(dim=-1)
    need = (thr / 2.0 - vals_b) / torch.clamp_min(k - counts_b, 1)
    take = (counts_b < k) & (g >= need)
    cov = torch.where(take[:, None], cov_b + w[None, :], cov_b)
    at = take[:, None] & (torch.arange(k, device=w.device)[None, :]
                          == counts_b[:, None])
    new = StreamSieveState(
        jidx=jidx,
        lg=state.lg,
        cov=cov,
        vals=torch.where(take, vals_b + g, vals_b),
        counts=counts_b + take.int(),
        sel=torch.where(at, state.t, sel_b),
        m=m,
        t=state.t + 1,
    )
    return new, take.any()


def stream_sieve_best(state: StreamSieveState) -> SieveResult:
    """The winning sieve's accepted stream positions and value."""
    best = torch.argmax(state.vals)
    at = best.reshape(1)
    return SieveResult(
        state.sel.index_select(0, at)[0], state.vals.index_select(0, at)[0], best,
        _exp_f32(state.jidx.to(torch.float32) * state.lg),
    )
