"""Greedy maximization under a cardinality constraint, in PyTorch.

The counterpart of ``repro/core/greedy.py``: ``greedy``, the paper's other
selectors (``stochastic_greedy``, "lazier than lazy greedy"; Minoux's
``lazy_greedy``) and ``bidirectional_greedy`` for the §3.4 post-reduction.
Each step of greedy and stochastic greedy recomputes the masked gains of all
candidates with one backend call (the CUDA kernel under ``cuda``) and takes
the first argmax.  No step reads a value back to the host: the pick stays a
(1,) tensor and is used through ``gather`` / ``index_fill_`` (indexing by a
0-d tensor would read it back with ``.item()``, a wait on the card).
Stochastic greedy masks the gains to a sample drawn from injected Gumbel
noise or a ``torch.Generator``, so a test can replay the JAX reference's own
draws.

``greedy_batched`` and ``stochastic_greedy_batched`` run B same-shape
queries (a stacked objective) in one loop: one ``gains_batched`` call a
step, each row's pick committed as the single-query loop commits it, so row
b selects exactly what the single-query call does.

Compact selection: after SS the live set is |V'| = O(log² n) ≪ n.  When
``alive`` is sparse, ``greedy`` gathers it once into a buffer of the
smallest :func:`repro_torch.core.sparsify.bucket_schedule` size that holds
it (ascending ground order, zero padding), runs every step over that buffer
and maps the picks back to ground indices.  The backend sees the buffer once
before the first step (``prepare_compact``: dense facility location on the
card copies its columns into a panel, freed when greedy returns).  Compact
and full-width runs pick the same elements, because both argmaxes take the
first maximum in ground order.

Telemetry (``repro_torch.obs``): ``greedy``, ``greedy_batched`` and
``stochastic_greedy_batched`` open a span (``greedy.select``,
``greedy.select_batched``, ``greedy.stochastic_batched``) only while
tracing is on and the device is not capturing a CUDA graph
(:func:`_traceable`).  Then the call synchronises the device before it
reads the wall clock and reads the gains and values to the host after the
loop; with tracing off it adds no op and no host read.
"""

from __future__ import annotations

import heapq
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.backend import Backend, resolve_backend
from repro_torch.core.functions import NEG, SubmodularFunction
from repro_torch.device import resolve_device

Tensor = torch.Tensor


def _traceable(device) -> bool:
    """Telemetry eligibility: tracing is on and ``device`` is not capturing
    a CUDA graph (a host read or a synchronisation there would break the
    capture).  The counterpart of the reference's "no tracers" gate."""
    if not obs.trace_enabled():
        return False
    dev = torch.device(device)
    return not (dev.type == "cuda" and torch.cuda.is_current_stream_capturing())


def _observed(name: str, device, run, record, **attrs):
    """``run()``, inside span ``name`` when :func:`_traceable`: the device is
    synchronised before the wall clock is read (the reference's
    ``block_until_ready``), then ``record(span, result, wall_s)`` reads the
    results on the host.  Untraced, ``run()`` alone."""
    if not _traceable(device):
        return run()
    with obs.span(name, **attrs) as sp:
        t0 = time.perf_counter()
        out = run()
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        record(sp, out, time.perf_counter() - t0)
    return out


def _record_greedy(sp, res: "GreedyResult", k: int, backend: str,
                   wall_s: float, *, selector: str, batched: bool) -> None:
    """Fill a selection span and the metrics from a finished result.  The
    gain trajectory is read from ``GreedyResult.gains`` after the loop
    returns, never inside it."""
    gains = res.gains.cpu().numpy()
    value = res.value.cpu().numpy()
    if batched:
        sp.set(
            B=int(gains.shape[0]),
            value=[float(v) for v in value],
            gains=[[float(g) for g in row] for row in gains],
        )
    else:
        sp.set(value=float(value), gains=[float(g) for g in gains])
    sp.set(k=k, backend=backend, selector=selector)
    obs.get_registry().histogram(
        "repro_greedy_wall_seconds", "greedy selection wall time per call",
        labels=("backend", "selector"),
    ).observe(wall_s, backend=backend, selector=selector)


class GreedyResult(NamedTuple):
    selected: Tensor     # (k,) int64 ground indices, in selection order
    gains: Tensor        # (k,) marginal gain at each step
    value: Tensor        # () f(S)
    state: Tensor        # final summary state


class LazyGreedyResult(NamedTuple):
    selected: Tensor     # (k,) int64 ground indices, in selection order
    gains: Tensor        # (k,) float32 marginal gain at each step
    value: Tensor        # () f(S)
    state: Tensor        # final summary state
    reevaluations: int   # stale bounds recomputed (one-slot gains calls)


def gumbel(n: int, generator: torch.Generator | None, device) -> Tensor:
    """(n,) standard Gumbel draws, -log(E) with E ~ Exp(1), on ``device``."""
    e = torch.empty((n,), dtype=torch.float32, device=device)
    e.exponential_(generator=generator)
    return -torch.log(e.clamp_min_(torch.finfo(torch.float32).tiny))


_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (splitmix64 of their
    mix): the counterpart of ``jax.random.fold_in`` for seeds.  Streams
    seeded from ``fold_in(s, 1)`` and ``s`` do not replay each other."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def check_noise(noise: Tensor, shape: tuple[int, ...], device) -> Tensor:
    """Injected draws as float32 on ``device``, after checking their shape
    and that every draw is finite (a non-finite draw could silently break a
    sampler's invariants, such as every sampled slot being live)."""
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(f"noise must be {tuple(shape)}, got {tuple(noise.shape)}")
    noise = noise.to(device=device, dtype=torch.float32)
    if not bool(torch.isfinite(noise).all()):
        raise ValueError("noise must be finite")
    return noise


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


def auto_sample_size(
    n: int, k: int, eps: float = 0.1, live: int | None = None
) -> int:
    """Stochastic greedy's sample size s = ceil((n'/k) ln(1/eps)), with n'
    the live count (|V'| after SS) when known, else the ground-set size."""
    base = (n if live is None else live) / max(k, 1)
    return max(1, int(math.ceil(base * math.log(1.0 / eps))))


def _compact_plan(
    n: int, alive: Tensor | None, compact: bool | None
) -> tuple[int | None, int | None]:
    """(bucket size, live count): the compact buffer size, or None for the
    full-width path, and |alive| as read to size the bucket (one host read).
    None/True compact when ``alive`` is sparse enough; False never, and
    reads nothing (live None, as without a mask).  (The JAX package also
    takes an int bound on the live count, for masks it cannot read under
    tracing; eager PyTorch can always read the mask.)"""
    if alive is None or compact is False:
        return None, None
    live = int(alive.sum())
    return selection_bucket(n, live), live


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
    return _observed(
        "greedy.select", fn.device,
        lambda: be.greedy(fn, k, alive=alive, state=state, compact=compact),
        lambda sp, res, wall: _record_greedy(sp, res, k, be.name, wall,
                                             selector="greedy", batched=False))


def _greedy_dense(
    fn: SubmodularFunction,
    k: int,
    alive: Tensor | None,
    state: Tensor | None,
    compact: bool | None,
    backend: Backend,
) -> GreedyResult:
    size, _ = _compact_plan(fn.n, alive, compact)
    if size is None:
        return _greedy(fn, k, alive, state, backend)
    return _greedy_compact(fn, k, size, alive, state, backend)


def _greedy(
    fn: SubmodularFunction, k: int, alive: Tensor | None,
    state: Tensor | None, backend: Backend, sample=None,
) -> GreedyResult:
    """Full-width steps.  ``sample(i, avail)`` (stochastic greedy) gives
    step i's candidate mask, else every available element competes."""
    be = backend
    dev = fn.device
    avail = (torch.ones((fn.n,), dtype=torch.bool, device=dev) if alive is None
             else alive.to(device=dev, dtype=torch.bool).clone())
    st = fn.empty_state() if state is None else state
    sel, gains = [], []
    for i in range(k):
        pool = avail if sample is None else sample(i, avail)
        g = torch.where(pool, be.gains(fn, st), NEG)
        v = torch.argmax(g, dim=0, keepdim=True)  # (1,): see the module doc
        ok = avail.gather(0, v)
        st = torch.where(ok, fn.add(st, v[0]), st)
        avail.index_fill_(0, v, False)
        sel.append(v)
        gains.append(torch.where(ok, g.gather(0, v), 0.0))
    return GreedyResult(torch.cat(sel), torch.cat(gains), fn.value(st), st)


def _greedy_compact(
    fn: SubmodularFunction, k: int, size: int, alive: Tensor,
    state: Tensor | None, backend: Backend, sample=None,
) -> GreedyResult:
    """Gains and argmax in (size,)-slot index space over the ascending
    buffer of live ground indices; exhausted steps record index 0 / gain 0,
    like the full-width path.  ``sample`` as in :func:`_greedy`, over
    slots."""
    be = backend
    alive = alive.to(device=fn.device, dtype=torch.bool)
    cand_idx = compact_indices(alive, size)
    cands = be.prepare_compact(fn, cand_idx)  # once per run (a panel, say)
    avail = torch.arange(size, device=fn.device) < alive.sum()  # pads are dead
    st = fn.empty_state() if state is None else state
    sel, gains = [], []
    for i in range(k):
        pool = avail if sample is None else sample(i, avail)
        g = torch.where(pool, be.gains_compact(fn, st, cands), NEG)
        vc = torch.argmax(g, dim=0, keepdim=True)
        v = cand_idx.gather(0, vc)
        ok = avail.gather(0, vc)
        st = torch.where(ok, fn.add(st, v[0]), st)
        avail.index_fill_(0, vc, False)
        sel.append(torch.where(ok, v, 0))
        gains.append(torch.where(ok, g.gather(0, vc), 0.0))
    return GreedyResult(torch.cat(sel), torch.cat(gains), fn.value(st), st)


# ------------------------------------------------------- stochastic greedy --

def stochastic_greedy(
    fn: SubmodularFunction,
    k: int,
    generator: torch.Generator | None = None,
    s: int | None = None,
    alive: Tensor | None = None,
    backend: "str | Backend | None" = None,
    state: Tensor | None = None,
    compact: bool | None = None,
    eps: float = 0.1,
    *,
    noise: Tensor | None = None,
) -> GreedyResult:
    """"Lazier than lazy greedy" [Mirzasoleiman et al. 2015]: each step takes
    the best element of a uniform random sample of ``s`` available ones.

    ``s=None`` derives the sample size from the live count (
    :func:`auto_sample_size`): after SS it scales with |V'|, not n.  On the
    compact path (``compact`` as in :func:`greedy`) the draws live in the
    buffer's slot space.  Each step evaluates the gains of the whole buffer
    (full width, or every slot) with one backend call and masks them to the
    sample, as the JAX reference does.

    The sample is the s largest of Gumbel draws + (0 where available, NEG
    elsewhere), ties broken toward the lower index (``jax.lax.top_k``'s
    order; a stable sort, since ``torch.topk`` keeps none).  ``noise`` is a
    (k, m) float32 tensor of such draws, m = n on the full-width path and m
    = the bucket size on the compact path, row i for step i; without it,
    each step draws from ``generator`` on ``fn``'s device.
    """
    be = resolve_backend(backend, fn.device)
    return be.stochastic_greedy(fn, k, generator, s=s, alive=alive, state=state,
                                compact=compact, eps=eps, noise=noise)


def _stochastic_greedy_dense(
    fn: SubmodularFunction,
    k: int,
    generator: torch.Generator | None,
    s: int | None,
    alive: Tensor | None,
    state: Tensor | None,
    compact: bool | None,
    eps: float,
    noise: Tensor | None,
    backend: Backend,
) -> GreedyResult:
    """The single-process stochastic greedy loop (see
    :func:`stochastic_greedy`)."""
    be = backend
    n, dev = fn.n, fn.device
    size, live = _compact_plan(n, alive, compact)
    if s is None:
        if live is None and alive is not None:  # full width by request
            live = int(alive.sum())
        s = auto_sample_size(n, k, eps, live=live)
    m = n if size is None else size
    s = int(min(s, m))
    if s < 1:
        raise ValueError(f"sample size must be >= 1; got {s}")
    if noise is not None:
        noise = check_noise(noise, (k, m), dev)

    def sample(i: int, avail: Tensor) -> Tensor:
        g = noise[i] if noise is not None else gumbel(m, generator, dev)
        g = g + torch.where(avail, 0.0, NEG)
        top = torch.sort(g, descending=True, stable=True).indices[:s]
        return torch.zeros_like(avail).index_fill_(0, top, True) & avail

    if size is None:
        return _greedy(fn, k, alive, state, be, sample)
    return _greedy_compact(fn, k, size, alive, state, be, sample)


# ---------------------------------------------------------- batched greedy --

def greedy_batched(
    fn: SubmodularFunction,
    k: int,
    alive: Tensor | None = None,
    backend: "str | Backend | None" = None,
    state: Tensor | None = None,
    compact: "bool | int | None" = None,
    on_step=None,
) -> GreedyResult:
    """Greedy for B same-shape queries in one loop.

    ``fn`` is a stacked objective, ``alive`` a (B, n) mask (None: all live)
    and ``state`` a stacked start.  Returns a GreedyResult with a leading B
    axis on every field.  Row b selects exactly as ``greedy(fn.row(b), k,
    alive=alive[b], ...)``.  ``compact``: None / True compact every row into
    one buffer whose bucket holds the batch's largest live count (one host
    read); False runs full width; an int is a bound on that count, which
    raises when a row's live count exceeds it.

    ``on_step(step, selected (B,), gains (B,), ok (B,))`` is called after
    each step commits (a row that is exhausted reports index 0, gain 0 and
    ``ok`` False), with the step's tensors; the loop is the same with and
    without it.  No step reads a value back to the host.
    """
    be = resolve_backend(backend, fn.device)
    _check_batched_alive("greedy_batched", alive)
    n = fn.row(0).n
    size, _ = _batched_compact_plan(n, alive, compact)

    def run():
        cand_idx, avail, st = _batched_frame(fn, size, alive, state)
        cands = None if cand_idx is None else be.prepare_batched(fn, cand_idx)

        def step(i, st, avail):
            g = torch.where(avail, be.gains_batched(fn, st, cands), NEG)
            return _batched_commit(fn, st, avail, cand_idx, g,
                                   torch.argmax(g, dim=1))

        return _batched_loop(fn, k, st, avail, step, on_step)

    return _observed(
        "greedy.select_batched", fn.device, run,
        lambda sp, res, wall: _record_greedy(sp, res, k, be.name, wall,
                                             selector="greedy", batched=True),
        n=n, bucket=size)


def _check_batched_alive(what: str, alive: Tensor | None) -> None:
    if alive is not None and alive.dim() != 2:
        raise ValueError(f"{what} needs a (B, n) alive mask; got shape "
                         f"{tuple(alive.shape)}")


def _batched_compact_plan(
    n: int, alive: Tensor | None, compact: "bool | int | None"
) -> tuple[int | None, int | None]:
    """(shared bucket size or None for full width, the batch's largest live
    count or None): the batched :func:`_compact_plan`, one host read.  An
    int ``compact`` is a bound on every row's live count; a row above it
    raises."""
    if alive is None or compact is False:
        return None, None
    live_max = int(alive.sum(dim=1).max())
    if not isinstance(compact, bool) and compact is not None:
        bound = int(compact)
        if not 0 <= bound <= n:
            raise ValueError(f"compact live bound must be in [0, n={n}]; got {bound}")
        if live_max > bound:
            raise ValueError(
                f"compact live bound {bound} < max row |alive| = {live_max}; pass "
                "a correct bound (or compact=True to derive it from the mask)")
    return selection_bucket(n, live_max), live_max


def _batched_frame(
    fn: SubmodularFunction, size: int | None, alive: Tensor | None,
    state: Tensor | None,
) -> tuple[Tensor | None, Tensor, Tensor]:
    """(the (B, size) buffers of live ground indices or None for full width,
    the (B, slots) availability, the stacked start state)."""
    B, dev = fn.batch, fn.device
    n = fn.row(0).n
    cand_idx = None
    if alive is None:
        avail = torch.ones((B, n), dtype=torch.bool, device=dev)
    else:
        alive = alive.to(device=dev, dtype=torch.bool)
        if size is None:
            avail = alive.clone()
        else:
            cand_idx = torch.stack([compact_indices(a, size) for a in alive])
            avail = (torch.arange(size, device=dev)[None, :]
                     < alive.sum(dim=1)[:, None])
    st = (torch.stack([fn.row(b).empty_state() for b in range(B)])
          if state is None else state.clone())
    return cand_idx, avail, st


def _batched_commit(fn, st, avail, cand_idx, g, vs, slot=None, idx=None):
    """Commit each row's pick ``vs`` (B,), a position in ``g`` (B, width):
    ``slot`` maps it to the frame slot and ``idx`` to the ground index (the
    frame itself, or ``cand_idx``, when None).  Returns (state, avail,
    selected, gains, ok), exhausted rows at index 0 / gain 0."""
    vs1 = vs[:, None]
    vc = vs1 if slot is None else slot.gather(1, vs1)
    idx = cand_idx if idx is None else idx
    v = (vc if idx is None else idx.gather(1, vs1))[:, 0]
    ok = avail.gather(1, vc)[:, 0]
    new = torch.stack([fn.row(b).add(st[b], v[b]) for b in range(st.shape[0])])
    st = torch.where(ok.reshape((-1,) + (1,) * (st.dim() - 1)), new, st)
    avail = avail.scatter(1, vc, False)
    return (st, avail, torch.where(ok, v, 0),
            torch.where(ok, g.gather(1, vs1)[:, 0], 0.0), ok)


def _batched_loop(fn, k, st, avail, step, on_step) -> GreedyResult:
    """k calls of ``step(i, state, avail)``, each streamed to ``on_step``."""
    sel, gains = [], []
    for i in range(k):
        st, avail, v, g, ok = step(i, st, avail)
        if on_step is not None:
            on_step(i, v, g, ok)
        sel.append(v)
        gains.append(g)
    value = torch.stack([fn.row(b).value(st[b]) for b in range(st.shape[0])])
    return GreedyResult(torch.stack(sel, dim=1), torch.stack(gains, dim=1), value, st)


def stochastic_greedy_batched(
    fn: SubmodularFunction,
    k: int,
    generators: "list[torch.Generator] | None" = None,
    s: int | None = None,
    alive: Tensor | None = None,
    backend: "str | Backend | None" = None,
    state: Tensor | None = None,
    compact: "bool | int | None" = None,
    eps: float = 0.1,
    on_step=None,
    *,
    noise: Tensor | None = None,
) -> GreedyResult:
    """Stochastic greedy for B same-shape queries in one loop, in the frame
    of :func:`greedy_batched` (one shared bucket).  Each step draws each
    row's sample of ``s`` available slots (Gumbel top-s, the lower slot
    first on ties), evaluates the gains of the sample only, and takes the
    first maximum over the sample sorted ascending, which is the dense
    loop's lowest-slot tie rule.

    Row b selects exactly as ``stochastic_greedy(fn.row(b), k,
    generators[b], s=s, alive=alive[b], ...)`` under the same plan: the
    bucket is the batch's, so the dense call needs the same bucket and the
    same effective ``s``.  ``s=None`` derives it from the batch's largest
    live count.  Draws come from ``generators`` (one per row; None: the
    device's default generator) or ``noise`` (k, B, slots), ``noise[i, b]``
    row b's draw at step i.  ``on_step`` as in :func:`greedy_batched`.
    """
    be = resolve_backend(backend, fn.device)
    _check_batched_alive("stochastic_greedy_batched", alive)
    B, n, dev = fn.batch, fn.row(0).n, fn.device
    size, live = _batched_compact_plan(n, alive, compact)
    if s is None:
        s = auto_sample_size(n, k, eps, live=live)
    width = n if size is None else size
    s = int(min(s, width))
    if s < 1:
        raise ValueError(f"sample size must be >= 1; got {s}")
    if noise is not None:
        noise = check_noise(noise, (k, B, width), dev)
    if generators is not None and len(generators) != B:
        raise ValueError(f"stochastic_greedy_batched needs {B} generators, one a "
                         f"row; got {len(generators)}")

    def run():
        cand_idx, avail, st = _batched_frame(fn, size, alive, state)

        def step(i, st, avail):
            g = noise[i] if noise is not None else torch.stack([
                gumbel(width, None if generators is None else generators[b], dev)
                for b in range(B)])
            g = g + torch.where(avail, 0.0, NEG)
            top = torch.sort(g, dim=1, descending=True, stable=True).indices[:, :s]
            cand = torch.sort(top, dim=1).values                      # (B, s)
            sub_avail = avail.gather(1, cand)
            sub_idx = cand if cand_idx is None else cand_idx.gather(1, cand)
            gains = torch.where(sub_avail, be.gains_batched(fn, st, sub_idx), NEG)
            return _batched_commit(fn, st, avail, cand_idx, gains,
                                   torch.argmax(gains, dim=1), slot=cand,
                                   idx=sub_idx)

        return _batched_loop(fn, k, st, avail, step, on_step)

    return _observed(
        "greedy.stochastic_batched", dev, run,
        lambda sp, res, wall: _record_greedy(sp, res, k, be.name, wall,
                                             selector="stochastic", batched=True),
        n=n, bucket=size, s=s)


# ------------------------------------------------------------- lazy greedy --

def lazy_greedy(
    fn: SubmodularFunction,
    k: int,
    alive: Tensor | None = None,
    backend: "str | Backend | None" = None,
) -> LazyGreedyResult:
    """Minoux's accelerated greedy with a priority queue on the host, the
    paper's wall-clock baseline.  The same picks as :func:`greedy`, up to
    the order of tied gains.

    The first bounds are one full-width gains call; each stale bound popped
    is recomputed by a one-slot ``gains_compact`` call (the same value as
    the full-width gain of that element) and pushed back.  Heap entries are
    (-gain, v, stamp), so equal gains pop the lower index first.  Steps past
    the live set record index 0 with gain 0.
    """
    be = resolve_backend(backend, fn.device)
    n, dev = fn.n, fn.device
    live = (np.arange(n) if alive is None
            else np.flatnonzero(alive.to(torch.bool).cpu().numpy()))
    slot = torch.arange(n, device=dev)  # views of it name one element
    st = fn.empty_state()
    ub = be.gains(fn, st).float().cpu().numpy()
    heap = list(zip((-ub[live]).tolist(), live.tolist(), [0] * live.size))
    heapq.heapify(heap)

    sel, gains, stamp, evals = [], [], 0, 0
    while heap and len(sel) < k:
        neg_g, v, s = heapq.heappop(heap)
        if s == stamp:                     # a current bound is the exact max
            sel.append(v)
            gains.append(-neg_g)
            st = fn.add(st, slot[v])
            stamp += 1
        else:                              # stale: recompute, push back
            g = float(be.gains_compact(fn, st, slot[v:v + 1])[0])
            evals += 1
            heapq.heappush(heap, (-g, v, stamp))
    pad = k - len(sel)
    return LazyGreedyResult(
        torch.tensor(sel + [0] * pad, dtype=torch.long, device=dev),
        torch.tensor(gains + [0.0] * pad, dtype=torch.float32, device=dev),
        fn.value(st), st, evals,
    )


# ----------------------------------------------------- bidirectional greedy --

def bidirectional_greedy(
    gain_fn,
    n: int,
    generator: torch.Generator | None = None,
    randomized: bool = True,
    *,
    noise: Tensor | None = None,
) -> Tensor:
    """Buchbinder et al.'s 1/2-approximation for unconstrained non-monotone
    submodular maximization, used by the §3.4 post-reduction (Eq. 9).

    ``gain_fn(lo, hi, v)`` gets the (n,) bool masks X = lo and Y = hi and
    the step's element v (an int), and returns a = h(v | X) and
    b = -h(v | Y - v).  Step v keeps v with probability
    p = a+ / (a+ + b+) (1 when both are 0), in float32; the draw is
    ``noise[v] < p``, which is ``jax.random.bernoulli`` of a uniform draw.
    ``noise`` holds n float32 uniforms in [0, 1); without it they come from
    ``generator``, on its device.  With neither, the masks and draws live on
    the card, like the port's other entry points (a CPU run passes CPU noise
    or a CPU generator).  ``randomized=False`` keeps v iff a >= b.  Returns
    the kept mask X (n,) bool, on the draws' device.
    """
    if noise is not None:
        dev = noise.device
        noise = check_noise(noise, (n,), dev)
    else:
        dev = (generator.device if generator is not None
               else resolve_device("cuda"))
        if randomized:
            noise = torch.rand((n,), generator=generator, device=dev)
    lo = torch.zeros((n,), dtype=torch.bool, device=dev)
    hi = torch.ones((n,), dtype=torch.bool, device=dev)
    for v in range(n):
        a, b = gain_fn(lo, hi, v)
        a = torch.as_tensor(a, dtype=torch.float32, device=dev)
        b = torch.as_tensor(b, dtype=torch.float32, device=dev)
        if randomized:
            ap, bp = torch.clamp_min(a, 0.0), torch.clamp_min(b, 0.0)
            tot = ap + bp
            p = torch.where(tot == 0.0, 1.0, ap / torch.where(tot == 0.0, 1.0, tot))
            take = noise[v] < p
        else:
            take = a >= b
        # v is in neither X nor Y - X yet: keeping it adds it to X, dropping
        # it removes it from Y.
        lo[v] = take
        hi[v] = take
    return lo
