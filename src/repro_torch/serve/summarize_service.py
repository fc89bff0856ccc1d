"""The micro-batched summarization service: the request-level layer over
SS and greedy, with an SLO-aware asynchronous scheduler and a fault
tolerance layer (retry, failover, isolation, degradation).  The counterpart
of ``repro/serve/summarize_service.py``, on the card through the port's
kernels.

Requests (a feature or similarity payload, a budget k, an objective
config, a seed, an optional latency deadline) are admitted into per-lane
queues.  A *lane* is the static signature of a query (objective, payload
kind and shape, k, phi, kernel, use_ss, ground-set padding); compatible
queries are micro-batched into **bucketed batch sizes**
(:func:`batch_buckets`) and run as one batched pipeline
(:func:`summarize_batch`: batched SS, then batched selection, on a stacked
objective).

Scheduling: with ``RunConfig(scheduler="async")`` a background flusher
owns execution.  A lane fires when it is **full** (``max_batch`` queued),
when a queued request's **deadline slack** runs out (absolute deadline
minus the lane's EWMA execution estimate minus ``slack_s``), or when the
oldest request has waited **max_wait_s**, whichever comes first.  Batching
is *continuous*: a firing pulls at most ``max_batch`` requests from the
head of one lane, so arrivals during a batch refill the next one.  The
default ``scheduler="sync"`` leaves admission policy to the caller:
``flush()`` drains everything queued.

Failure semantics: every chunk runs through a recovery loop: bounded
exponential-backoff **retries** on the primary backend, per-chunk
**failover** to ``failover_backend`` (default ``"reference"``, the plain
PyTorch route, the counterpart of the reference's ``"oracle"``), and last
per-query **isolation**, so one poisoned query fails alone.  A
**watchdog** (``chunk_timeout_s``) bounds a chunk's wall time: a hung
attempt is abandoned (its late results are discarded by the tickets'
first-wins settle).  Every recovered response carries a ``recovery``
record, and every failover is counted (``stats()["failovers"]``,
``repro_service_failovers_total``, the event bus).  A kernel that fails to
build, load or launch, and a CUDA error on the card, are never recovered:
they fail the chunk's tickets at once, so a broken kernel is never hidden
behind the plain route's correct answers.

Degradation ladder: when a lane's EWMA predicts that a queued deadline
will be missed at full quality, or under ``max_pending`` pressure, the
executor walks ``RunConfig.ladder`` (``"stochastic_greedy"``, ``"bump_c"``,
``"shrink_r"``), costed by :func:`repro_torch.core.sparsify.ss_cost_model`
until a per-(lane, level) EWMA takes over.  Every degraded response
carries a ``degradation`` record; the ladder is off by default.

Correctness contract: batching, scheduling and recovery are a pure
execution strategy.  Each query's ``selected`` / ``gains`` / ``value``
(and SS ``vprime_size`` / ``eps_hat`` / ``rounds``) are those of the
single-query pipeline (``ss_sparsify`` then ``greedy``) under the same
seed, whatever it was batched with, however the batch was padded, which
trigger fired it, or how many same-backend attempts it took.

Randomness: the reference reuses a query's PRNG key, a value, in every
attempt and every padding row.  Here a query carries a seed or a
``torch.Generator``, which is a stream that drawing consumes.  So the
service takes the query's *draw state* at admission (an int seed as is, a
generator's state cloned) and every attempt builds fresh per-row
generators from it, padding rows included: a retry replays the first
attempt's draws bit for bit, and a padding row never advances row 0's
stream.  Streams that the reference derives by ``fold_in`` come from
:func:`fold_in` (``repro_torch.core.greedy``), a splitmix64 mix of a seed
and a number.

Device: the service runs on ``device`` (the card by default; a host
without one raises).  ``exec_s`` is measured to a synchronised device, and
a chunk reads its results to the host in one transfer (every row's f(S),
|V'| and eps_hat, and one finiteness flag), so its host reads do not grow
with the batch; ``selected`` and ``gains`` stay on the device.

Optional ground-set padding (``RunConfig.n_buckets``): a query whose n is
not a bucket is zero-padded up to the next one with the padding dead-
masked, collapsing distinct-n signatures.  Padding changes SS's draw frame,
so a padded query matches the sequential run *on the padded ground set*;
pure-greedy queries (``use_ss=False``) are padding-invariant.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.backend import resolve_backend
from repro_torch.core.functions import FacilityLocation, FeatureCoverage
from repro_torch.core.greedy import (
    GreedyResult,
    fold_in,
    greedy_batched,
    stochastic_greedy_batched,
)
from repro_torch.core.sparsify import (
    SSResult,
    bucket_schedule,
    ss_cost_model,
    ss_live_bound,
    ss_sparsify_batched,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import KernelError
from repro_torch.serve.faults import FaultInjected, FaultPlan

Tensor = torch.Tensor

def generator(seed: "int | torch.Generator", device) -> torch.Generator:
    """A generator on ``device``: ``seed`` itself when it is one, else a new
    one seeded with it."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=resolve_device(device)).manual_seed(int(seed))


def fold_generators(generators: "list[torch.Generator]", data: int
                    ) -> list[torch.Generator]:
    """One new generator per row, seeded with ``fold_in(initial seed of
    generators[b], data)``, on its device."""
    return [torch.Generator(device=g.device).manual_seed(fold_in(g.initial_seed(), data))
            for g in generators]


def draw_state(seed: "int | torch.Generator"):
    """A query's draw state, taken at admission: an int seed as is, or a
    generator's (device, state) with the state cloned, so that drawing from
    the caller's generator later changes nothing here."""
    if isinstance(seed, torch.Generator):
        return seed.device, seed.get_state().clone()
    return int(seed)


def generator_from_state(state, device) -> torch.Generator:
    """A fresh generator at the draw state ``state`` (:func:`draw_state`):
    a seed's on ``device``, a generator's on its own device."""
    if isinstance(state, tuple):
        dev, st = state
        g = torch.Generator(device=dev)
        g.set_state(st)
        return g
    return torch.Generator(device=device).manual_seed(state)


def ewma_update(prev: float | None, sample: float, alpha: float = 0.5) -> float:
    """The service's execution-estimate EWMA: the first sample seeds the
    estimate, after which ``alpha`` weights the newest sample."""
    return sample if prev is None else (1.0 - alpha) * prev + alpha * sample


def _lane_label(lane: tuple) -> str:
    """A low-cardinality metrics label for a lane tuple: objective / ground
    size / budget (the full tuple would explode label cardinality)."""
    return f"{lane[0]}/n{lane[2][0]}/k{lane[3]}"


class DeadlineExceeded(RuntimeError):
    """The request's latency budget was already spent at admission."""


class ServiceOverloaded(RuntimeError):
    """Backpressure: the service's pending-queue cap was hit at admission."""


class ChunkTimeout(RuntimeError):
    """A chunk attempt exceeded ``RunConfig.chunk_timeout_s`` and was
    abandoned by the watchdog (the flusher moves on; the hung attempt's late
    results, if any, are discarded by the tickets' first-wins settle)."""


class MalformedResult(RuntimeError):
    """Chunk execution produced non-finite gains/values: a recoverable
    execution fault (retried, failed over), never returned."""


class TicketPending(TimeoutError):
    """A ticket wait timed out while its query is still queued or executing
    (e.g. after ``drain(timeout)`` gave up on an in-flight chunk).  A
    TimeoutError, so ``except TimeoutError`` callers still work."""


class ServiceRestarted(RuntimeError):
    """The engine died (``crash``) or restarted (``restart``) while work was
    in flight.  Every in-flight ticket settles with this error, never hangs
    in :class:`TicketPending`, and after a ``crash`` new submissions are
    rejected with it too (build a new service)."""


# ------------------------------------------------------------- run config ----

#: Valid degradation-ladder steps.
LADDER_STEPS = ("stochastic_greedy", "bump_c", "shrink_r")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """The one end-to-end execution config (the stable surface of
    ``repro_torch.api``); per-query knobs (payload, k, seed, objective,
    deadline) stay on the request.

    Execution: ``backend`` ("reference", "cuda", a Backend, or None: by the
    device); ``compact`` the compact-selection policy of
    ``greedy_batched`` (None: the static SS live bound).  SS: probe
    multiplier ``r``, accuracy/speed ``c``.  ``eps`` is the
    stochastic-greedy sample-size parameter (the ``"stochastic_greedy"``
    ladder step reads it).

    Batching: ``max_batch`` caps a micro-batch; ``batch_c`` shapes the
    batch-bucket schedule; ``n_buckets`` opts into ground-set padding.

    Scheduling: ``scheduler`` is ``"sync"`` (manual ``flush()``) or
    ``"async"`` (background deadline-driven flusher); ``max_wait_s`` bounds
    how long an admitted request may sit queued before its lane fires
    anyway; ``slack_s`` is extra margin subtracted from deadlines;
    ``max_pending`` (None: unbounded) is the admission backpressure cap;
    ``stream_steps`` streams greedy selections to tickets step by step.

    Fault tolerance: ``max_retries`` same-backend re-attempts per stage with
    ``retry_backoff_s``·2^(attempt−1) sleeps between them;
    ``failover_backend`` the per-chunk fallback backend (None disables; a
    fallback that resolves to the primary is skipped); ``isolate_on_failure``
    re-runs an exhausted multi-query chunk one query at a time;
    ``chunk_timeout_s`` arms the watchdog (None: off);
    ``validate_payloads`` rejects NaN/Inf payloads at admission.

    Degradation: ``ladder`` is the ordered tuple of quality steps (a subset
    of ``LADDER_STEPS``) the executor may walk; empty: never degrade.
    ``ladder_pressure`` is the ``max_pending`` fill fraction at which every
    chunk runs fully degraded.
    """

    backend: Any = None             # str | Backend | None (by the device)
    r: int = 8                      # SS probe multiplier
    c: float = 8.0                  # SS accuracy/speed trade-off
    eps: float = 0.1                # stochastic-greedy sample-size parameter
    compact: "bool | int | None" = None   # compact-selection policy
    max_batch: int = 8              # admission cap per micro-batch
    batch_c: float = 4.0            # batch-bucket shrink factor
    n_buckets: tuple[int, ...] | None = None  # opt-in ground-set padding
    scheduler: str = "sync"         # "sync" | "async"
    max_wait_s: float = 0.05        # max queue residency before a lane fires
    slack_s: float = 0.0            # safety margin under deadlines
    max_pending: int | None = None  # admission backpressure cap
    stream_steps: bool = False      # stream greedy steps to tickets
    # -- fault tolerance ----------------------------------------------------
    max_retries: int = 2            # same-backend re-attempts per stage
    retry_backoff_s: float = 0.02   # backoff base: base * 2^(attempt-1)
    failover_backend: Any = "reference"  # per-chunk fallback (None: off)
    isolate_on_failure: bool = True  # exhausted chunk -> per-query re-run
    chunk_timeout_s: float | None = None  # watchdog bound on chunk wall time
    validate_payloads: bool = True  # reject NaN/Inf payloads at submit()
    # -- degradation ladder -------------------------------------------------
    ladder: tuple[str, ...] = ()    # ordered quality steps (LADDER_STEPS)
    ladder_pressure: float = 0.8    # max_pending fill fraction -> full ladder

    def __post_init__(self):
        if self.scheduler not in ("sync", "async"):
            raise ValueError(
                f"scheduler must be 'sync' or 'async'; got {self.scheduler!r}"
            )
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0; got {self.max_retries}")
        if self.chunk_timeout_s is not None and self.chunk_timeout_s <= 0:
            raise ValueError(
                f"chunk_timeout_s must be positive; got {self.chunk_timeout_s}"
            )
        object.__setattr__(self, "ladder", tuple(self.ladder))
        bad = [s for s in self.ladder if s not in LADDER_STEPS]
        if bad:
            raise ValueError(
                f"unknown ladder step(s) {bad}; valid steps: {LADDER_STEPS}"
            )
        if not 0.0 < self.ladder_pressure <= 1.0:
            raise ValueError(
                f"ladder_pressure must be in (0, 1]; got {self.ladder_pressure}"
            )


def batch_buckets(max_batch: int, c: float = 4.0) -> tuple[int, ...]:
    """Batch-dimension buckets: ``bucket_schedule`` applied to B (tile 1).
    A chunk of j queries pads up to the smallest bucket >= j."""
    return bucket_schedule(max_batch, c, tile=1)


# ----------------------------------------------------------- request API ----

@dataclasses.dataclass(frozen=True)
class SummarizeRequest:
    """One summarization query.

    ``features`` is the (n, F) nonnegative payload (FeatureCoverage's W for
    ``objective="coverage"``, the similarity kernel's input for ``"fl"``);
    ``sim`` a precomputed (n, n) similarity for ``"fl"`` instead.  ``seed``
    is the query's seed or ``torch.Generator``, in place of the reference's
    PRNG key (the service takes its draw state at admission).
    ``use_ss=False`` selects on the whole ground set.  ``deadline_s`` is the
    latency budget in seconds from submission: the async flusher fires the
    lane early enough to try to make it; a budget already <= 0 at admission
    fails the ticket with :class:`DeadlineExceeded`, and a missed but
    served deadline is reported in ``SummarizeResponse.deadline_missed``.
    """

    k: int
    seed: "int | torch.Generator"
    features: Any = None
    sim: Any = None
    objective: str = "coverage"     # coverage | fl
    phi: str = "sqrt"               # FeatureCoverage's concave transform
    kernel: str = "cosine"          # FacilityLocation's feature kernel
    use_ss: bool = True
    deadline_s: float | None = None  # latency budget from submit (seconds)

    def generator(self, device) -> torch.Generator:
        """The query's generator on ``device``."""
        return generator(self.seed, device)


@dataclasses.dataclass(frozen=True)
class SummarizeResponse:
    """Per-query result and serving metadata.

    Results equal the single-query pipeline's under the same seed.
    ``selected`` and ``gains`` are row views of the batch's device tensors.
    ``queue_delay_s`` is submit → execution start; ``exec_s`` the wall time
    of the micro-batch this query rode in, to a synchronised device (shared
    by its batch mates); ``batch_size`` / ``batch_bucket`` how full that
    batch was against its padded size.  ``trigger`` names what fired the
    batch (``manual`` / ``full`` / ``deadline`` / ``max_wait`` /
    ``drain``); ``deadline_missed`` is None without a deadline, else
    whether the batch finished past it.

    ``degradation`` is None at full quality, else the audit record of the
    ladder walk: ``steps`` applied, the ``r`` / ``c`` / ``selector`` run,
    the ``level`` and the ``reason`` (``deadline`` / ``pressure`` /
    ``forced``).  ``recovery`` is None for a first-attempt success, else
    ``{"retries", "stage", "backends", "isolated"}``.
    """

    selected: Tensor                # (k,) int64 ground indices
    gains: Tensor                   # (k,) marginal gains
    value: float                    # f(S)
    vprime_size: int | None         # |V'| after SS (None when use_ss=False)
    eps_hat: float | None           # SS certificate (None when use_ss=False)
    rounds: int | None              # SS rounds executed
    lane: tuple                     # the signature this query batched under
    batch_size: int                 # real queries in the micro-batch
    batch_bucket: int               # padded batch dimension
    queue_delay_s: float
    exec_s: float
    trigger: str = "manual"         # what fired this micro-batch
    deadline_missed: bool | None = None
    degradation: dict | None = None  # ladder audit record (None: full quality)
    recovery: dict | None = None    # recovery audit record (None: 1st attempt)


# ------------------------------------------------------- functional core ----

def _as_f32(a, dev: torch.device) -> Tensor:
    """A payload on ``dev``: bfloat16 and float32 tensors keep their dtype,
    anything else becomes float32 (as ``jnp.asarray`` with x64 off)."""
    t = torch.as_tensor(np.asarray(a) if not isinstance(a, Tensor) else a)
    if t.dtype not in (torch.float32, torch.bfloat16):
        t = t.float()
    return t.to(dev)


def build_batch_objective(requests: "list[SummarizeRequest]", n_pad: int | None,
                          device="cuda"):
    """Stack one lane's payloads into a stacked objective on ``device`` (the
    card by default), and with ground-set padding to ``n_pad`` the (B,
    n_pad) mask of real elements (else None).  All requests share a lane.
    Facility location's padded rows and columns of the *similarity* are
    zero, which is inert for any kernel (the rbf similarity of a zero
    feature row is not)."""
    dev = resolve_device(device)
    req0 = requests[0]
    if req0.objective == "coverage":
        Ws = [_as_f32(r.features, dev) for r in requests]
        if n_pad is not None:
            Ws = [torch.cat([W, W.new_zeros((n_pad - W.shape[0], W.shape[1]))])
                  for W in Ws]
        fn = FeatureCoverage(W=torch.stack(Ws), phi=req0.phi)
    elif req0.objective == "fl":
        if req0.sim is not None:
            sims = []
            for r in requests:
                s = _as_f32(r.sim, dev)
                if n_pad is not None:
                    s = torch.nn.functional.pad(
                        s, (0, n_pad - s.shape[1], 0, n_pad - s.shape[0]))
                sims.append(s)
        else:
            sims = []
            for r in requests:
                X = _as_f32(r.features, dev)
                n_real = X.shape[0]
                if n_pad is not None:
                    X = torch.cat([X, X.new_zeros((n_pad - n_real, X.shape[1]))])
                s = FacilityLocation.from_features(X, kernel=req0.kernel).sim
                if n_pad is not None:
                    valid = torch.arange(n_pad, device=dev) < n_real
                    s = s * (valid[:, None] & valid[None, :]).to(s.dtype)
                sims.append(s)
        fn = FacilityLocation(sim=torch.stack(sims))
    else:
        raise ValueError(f"unknown objective {req0.objective!r}")
    if n_pad is None:
        return fn, None
    n_reals = [(r.features if r.sim is None else r.sim).shape[0] for r in requests]
    alive = torch.stack([torch.arange(n_pad, device=dev) < m for m in n_reals])
    return fn, alive


def summarize_batch(
    fn,
    k: int,
    generators: "list[torch.Generator] | None" = None,
    *,
    r: int = 8,
    c: float = 8.0,
    use_ss: bool = True,
    alive: Tensor | None = None,
    backend=None,
    compact: "bool | int | None" = None,
    on_step=None,
    selector: str = "greedy",
    eps: float = 0.1,
    s: int | None = None,
    noise: Tensor | None = None,
    selector_noise: Tensor | None = None,
) -> tuple[GreedyResult, SSResult | None]:
    """The service's execution core: batched SS, then batched selection on
    V', for the stacked objective ``fn``.  Row b is the single-query
    pipeline under ``generators[b]``.

    ``compact=None`` derives the static SS live bound (``ss_live_bound``),
    which the selection checks against each row's |V'|.  ``on_step``
    streams the selection's steps (:func:`greedy_batched`).  ``selector``
    is ``"greedy"`` (exact) or ``"stochastic"``
    (:func:`stochastic_greedy_batched`, sample size from ``eps`` / ``s``).

    Draws: SS takes ``generators[b]`` (or ``noise``, (B, max_rounds, n), as
    :func:`ss_sparsify_batched`).  The stochastic selector draws from a
    stream of its own per row, the counterpart of the reference's
    ``fold_in(keys[b], 1)``: a generator seeded with
    ``fold_in(generators[b].initial_seed(), 1)`` (:func:`fold_in`), so it
    never replays the SS stream; a sequential run that is to match derives
    it the same way.  ``selector_noise`` ((k, B, slots)) replaces those
    draws.
    """
    be = resolve_backend(backend, fn.device)
    ss = None
    sel_alive = alive
    if use_ss:
        ss = ss_sparsify_batched(fn, generators, r=r, c=c, alive=alive, backend=be,
                                 noise=noise)
        sel_alive = ss.vprime
        if compact is None:
            compact = ss_live_bound(fn.row(0).n, r, c)
    if selector == "greedy":
        res = greedy_batched(fn, k, alive=sel_alive, backend=be, compact=compact,
                             on_step=on_step)
    elif selector == "stochastic":
        sel_gens = None
        if selector_noise is None and generators is not None:
            sel_gens = fold_generators(generators, 1)
        res = stochastic_greedy_batched(
            fn, k, sel_gens, s=s, alive=sel_alive, backend=be, compact=compact,
            eps=eps, on_step=on_step, noise=selector_noise)
    else:
        raise ValueError(f"selector must be 'greedy' or 'stochastic'; got {selector!r}")
    return res, ss


def _all_finite(payload) -> bool:
    """No NaN or Inf in ``payload``, checked where it lives: a tensor on its
    own device, anything else with numpy on the host."""
    if isinstance(payload, Tensor):
        return bool(torch.isfinite(payload).all())
    return bool(np.isfinite(np.asarray(payload)).all())


def _chunk_scalars(res: GreedyResult, ss: SSResult | None, n_real: int):
    """The chunk's host reads in one transfer: the real rows' f(S), and
    with SS their |V'| and eps_hat, plus one flag that every real row's
    gains and f(S) are finite.  Returns (values, vprime sizes, eps_hats,
    finite), the middle two None without SS.  (The reference reads each
    row's scalars apart, 4·B reads a chunk; ``rounds`` is already a host
    list.)"""
    cols = [res.value[:n_real].double()]
    if ss is not None:
        cols += [ss.vprime[:n_real].sum(dim=1).double(),
                 ss.eps_hat[:n_real].double()]
    finite = (torch.isfinite(res.gains[:n_real]).all()
              & torch.isfinite(res.value[:n_real]).all())
    host = torch.cat([torch.stack(cols).flatten(),
                      finite.double().reshape(1)]).cpu().tolist()
    values = host[:n_real]
    if ss is None:
        return values, None, None, bool(host[-1])
    return (values, [int(x) for x in host[n_real:2 * n_real]],
            host[2 * n_real:3 * n_real], bool(host[-1]))


# ------------------------------------------------------------ the ticket ----

class Ticket:
    """Future-style handle returned by :meth:`SummarizeService.submit`.

    ``result(timeout=None)`` blocks until the scheduler executes the query
    and returns its :class:`SummarizeResponse` — or re-raises the error
    captured for *this* request (admission failures like
    :class:`DeadlineExceeded` / a malformed payload, or the execution error
    of the chunk it rode in after recovery was exhausted).  A wait that
    times out raises :class:`TicketPending` naming the ticket's state
    (``queued`` / ``executing``) so a caller who gave up on ``drain``
    sees *why* the ticket is unresolved instead of blocking forever.
    ``done()`` / ``exception()`` mirror ``concurrent.futures.Future``.
    With ``RunConfig.stream_steps`` the committed greedy prefix is readable
    mid-flight via :meth:`partial`.

    Settlement is first-wins and idempotent (:meth:`_settle`): when the
    watchdog abandons a hung attempt and the recovery path re-runs the
    chunk, whichever attempt finishes first owns the ticket — the loser's
    late results are discarded, so a ticket can never be resolved twice or
    flap between a response and an error.
    """

    __slots__ = (
        "index", "_submit_t", "_deadline_t", "_event", "_response", "_error",
        "_steps", "_lock", "_state",
    )

    def __init__(self, index: int, submit_t: float,
                 deadline_t: float | None = None):
        self.index = index
        self._submit_t = submit_t
        self._deadline_t = deadline_t
        self._event = threading.Event()
        self._response: SummarizeResponse | None = None
        self._error: BaseException | None = None
        self._steps: list[tuple[int, float]] = []
        self._lock = threading.Lock()
        self._state = "queued"      # queued | executing | done | failed

    def done(self) -> bool:
        """True once the ticket holds a response or a captured error."""
        return self._event.is_set()

    def state(self) -> str:
        """Lifecycle state: ``queued`` → ``executing`` → ``done``/``failed``."""
        return self._state

    def result(self, timeout: float | None = None) -> SummarizeResponse:
        """Block until resolved; returns the response or re-raises the
        captured per-request error.  Raises :class:`TicketPending` (a
        TimeoutError) if ``timeout`` elapses first — the query stays in
        flight and a later wait can still succeed."""
        if not self._event.wait(timeout):
            raise TicketPending(
                f"ticket {self.index} still {self._state} after {timeout}s "
                "(its micro-batch has not resolved; drain() or a longer "
                "timeout will settle it)"
            )
        if self._error is not None:
            raise self._error
        return self._response

    def exception(self, timeout: float | None = None) -> BaseException | None:
        """The captured error (None on success); blocks like ``result``."""
        if not self._event.wait(timeout):
            raise TicketPending(
                f"ticket {self.index} still {self._state} after {timeout}s "
                "(its micro-batch has not resolved; drain() or a longer "
                "timeout will settle it)"
            )
        return self._error

    def partial(self) -> list[tuple[int, float]]:
        """Committed (ground index, gain) greedy steps streamed so far —
        populated mid-execution when ``RunConfig.stream_steps`` is on, and
        always consistent with the final ``selected``/``gains`` prefix."""
        return list(self._steps)

    def _settle(self, response: SummarizeResponse | None = None,
                error: BaseException | None = None) -> bool:
        """Resolve the ticket exactly once (first caller wins).  Returns
        False when the ticket was already settled — the caller (a retried,
        failed-over, or watchdog-abandoned attempt) must then discard its
        results and account for nothing."""
        with self._lock:
            if self._event.is_set():
                return False
            self._response = response
            self._error = error
            self._state = "done" if error is None else "failed"
            self._event.set()
            return True

    def _fulfill(self, response: SummarizeResponse) -> None:
        self._settle(response=response)

    def _fail(self, error: BaseException) -> None:
        self._settle(error=error)


@dataclasses.dataclass
class _QueueItem:
    ticket: Ticket
    request: SummarizeRequest
    lane: tuple
    submit_t: float
    deadline_t: float | None
    draw: Any                       # the seed's draw state (draw_state)


# ------------------------------------------------------------ the service ----

def _unrecoverable(err: BaseException) -> bool:
    """Whether no retry, failover or isolation may answer ``err``: the
    engine died (:class:`ServiceRestarted`: its tickets are settled
    already), a kernel failed to build, load or launch
    (:class:`~repro_torch.kernels.KernelError`: the plain route would hide
    it behind correct answers), or the card raised a CUDA error, which is
    sticky (every later call on the card fails with it)."""
    if isinstance(err, (ServiceRestarted, KernelError)):
        return True
    return isinstance(err, RuntimeError) and str(err).startswith("CUDA error")


class SummarizeService:
    """Queue-fed micro-batching engine over :func:`summarize_batch`.

    ``submit`` admits a request and returns a :class:`Ticket` future.  With
    the default ``RunConfig(scheduler="sync")`` execution happens on
    ``flush()`` — the queue is drained, queries grouped by *lane* (the
    static signature: ground-set size, payload shape, k, objective
    config, use_ss), chunked at ``max_batch``, each chunk padded up to its
    batch bucket (padding rows repeat row 0 and are discarded) and executed
    as one batched pipeline on ``device`` (the card by default; a host
    without one raises).

    With ``scheduler="async"`` a daemon flusher thread owns execution: lanes
    fire on (full ∨ deadline-slack ∨ max-wait), continuous batching pulls at
    most ``max_batch`` from a lane's head per firing so arrivals refill the
    next bucket while a batch is in flight, and ``drain()`` force-fires the
    backlog and blocks until every outstanding ticket resolves.  ``run`` is
    submit-all + drain on either scheduler.  The service is a context
    manager: leaving the ``with`` block drains and stops the flusher.

    Every chunk executes through the recovery loop described in the module
    docstring (retry → failover → per-query isolation, watchdog-bounded)
    and, when ``RunConfig.ladder`` is set, through the degradation planner.
    ``faults`` threads a seeded :class:`repro_torch.serve.faults.FaultPlan`
    into the executor — the chaos-testing hook; production services leave
    it None (one attribute check per chunk).
    """

    def __init__(self, config: RunConfig | None = None, *,
                 faults: "FaultPlan | None" = None, device="cuda"):
        self.device = resolve_device(device)
        if config is None:
            config = RunConfig()
        if not isinstance(config, RunConfig):
            raise TypeError(
                f"SummarizeService takes a RunConfig; got {type(config)!r}"
            )
        self.config = config
        self._faults = faults
        self._buckets = batch_buckets(config.max_batch, config.batch_c)
        self._cond = threading.Condition()
        self._lanes: dict[tuple, list[_QueueItem]] = {}
        self._pending = 0               # queued, not yet executing
        self._outstanding = 0           # queued or executing
        self._exec_est: dict[tuple, float] = {}   # keyed (lane, ladder level)
        self._ladder_cache: dict[tuple, list[dict]] = {}
        self._drain_requested = False
        self._stop = False
        self._killed = False            # a drawn ``crash`` fault fired
        self._thread: threading.Thread | None = None
        self._n_submitted = 0
        self._stats = {
            "queries": 0,
            "batches": 0,
            "padded_slots": 0,
            "slots": 0,
            "queue_delay_s_sum": 0.0,
            "queue_delay_s_max": 0.0,
            "exec_s_sum": 0.0,
            "lanes": set(),
            "triggers": {},
            "deadlines_missed": 0,
            "failed": 0,
            "retries": 0,
            "failovers": 0,
            "isolated_queries": 0,
            "chunk_timeouts": 0,
            "degraded": 0,
            "restarts": 0,
        }
        if config.scheduler == "async":
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Start the background flusher (idempotent; async scheduler only)."""
        if self.config.scheduler != "async":
            raise RuntimeError("start() requires RunConfig(scheduler='async')")
        if self._thread is not None:
            return
        self._stop = False
        self._thread = threading.Thread(
            target=self._flusher, name="summarize-flusher", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Drain outstanding work, then stop the flusher thread."""
        if self._thread is None:
            return
        self.drain()
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "SummarizeService":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- admission ---------------------------------------------------------
    def submit(self, request: SummarizeRequest) -> Ticket:
        """Admit one request.  Admission failures — malformed payload (a
        missing / NaN / Inf payload, ``k < 1``), an already-spent deadline,
        queue backpressure — fail the returned ticket immediately instead
        of raising, so one bad request never blocks its batch mates (and
        never corrupts the chunk it would have ridden in)."""
        now = time.perf_counter()
        deadline_t = (
            None if request.deadline_s is None else now + request.deadline_s
        )
        with self._cond:
            ticket = Ticket(self._n_submitted, now, deadline_t)
            self._n_submitted += 1
        try:
            if self._killed:
                raise ServiceRestarted(
                    "the service crashed (injected crash fault); in-flight "
                    "tickets were settled with ServiceRestarted and new "
                    "submissions are rejected — construct a new service"
                )
            lane = self._lane(request)
            if request.k < 1:
                raise ValueError(f"k must be >= 1; got k={request.k}")
            draw = draw_state(request.seed)
            if self.config.validate_payloads:
                payload = (
                    request.sim if request.sim is not None else request.features
                )
                if not _all_finite(payload):
                    raise ValueError(
                        "payload contains non-finite values (NaN/Inf); "
                        "rejected at admission (RunConfig.validate_payloads)"
                    )
            if request.deadline_s is not None and request.deadline_s <= 0:
                raise DeadlineExceeded(
                    f"deadline_s={request.deadline_s} already spent at "
                    "admission"
                )
            with self._cond:
                if self._killed:
                    # a crash between the check above and this lock: the
                    # queues were drained, so this item must not join them
                    raise ServiceRestarted(
                        "the service crashed (injected crash fault) while "
                        "this request was being admitted"
                    )
                cap = self.config.max_pending
                if cap is not None and self._pending >= cap:
                    raise ServiceOverloaded(
                        f"{self._pending} requests pending >= "
                        f"max_pending={cap}"
                    )
                self._lanes.setdefault(lane, []).append(
                    _QueueItem(ticket, request, lane, now, deadline_t, draw)
                )
                self._pending += 1
                self._outstanding += 1
                self._cond.notify_all()
        except Exception as e:  # noqa: BLE001 - captured on the ticket
            with self._cond:
                self._stats["failed"] += 1
            ticket._settle(error=e)
            obs.get_registry().counter(
                "repro_service_requests_total", "admitted requests by outcome",
                labels=("outcome",),
            ).inc(outcome="rejected")
            tr = obs.get_tracer()
            if tr.enabled:
                tr.record(
                    "request.admit", now, time.perf_counter(),
                    trace_id=f"req-{ticket.index}", status="error",
                    error=type(e).__name__,
                )
            return ticket
        obs.get_registry().counter(
            "repro_service_requests_total", "admitted requests by outcome",
            labels=("outcome",),
        ).inc(outcome="admitted")
        tr = obs.get_tracer()
        if tr.enabled:
            tr.record(
                "request.admit", now, time.perf_counter(),
                trace_id=f"req-{ticket.index}", lane=_lane_label(lane),
            )
        return ticket

    def _lane(self, req: SummarizeRequest) -> tuple:
        payload = req.sim if req.sim is not None else req.features
        if payload is None:
            raise ValueError("request needs a features or sim payload")
        kind = "sim" if req.sim is not None else "features"
        shape = tuple(payload.shape)
        n = shape[0]
        n_pad = None
        if self.config.n_buckets is not None:
            fits = [b for b in self.config.n_buckets if b >= n]
            if not fits:
                raise ValueError(
                    f"query n={n} exceeds every configured n bucket "
                    f"{self.config.n_buckets}"
                )
            n_pad = min(fits)
            shape = (n_pad,) + shape[1:] if req.sim is None else (n_pad, n_pad)
        # ``kind`` keeps sim-payload and feature-payload queries in separate
        # lanes: a (n, n) feature matrix must not stack with a (n, n) sim.
        return (
            req.objective, kind, shape, req.k, req.phi, req.kernel,
            req.use_ss, n_pad,
        )

    # -- scheduling --------------------------------------------------------
    def _next_fire(self, now: float):
        """The flusher's policy: the most urgent (lane, fire time, trigger)
        among non-empty lanes, or (None, None, None) on an empty queue.

        A lane fires *now* when full (``max_batch`` queued) or when a drain
        was requested; otherwise at the earlier of (oldest submit +
        ``max_wait_s``) and, per queued deadline, (deadline − lane EWMA
        execution estimate − ``slack_s``).  Must be called with the lock
        held."""
        best = (None, None, None)
        for lane, items in self._lanes.items():
            if not items:
                continue
            if len(items) >= self.config.max_batch:
                return lane, now, "full"
            if self._drain_requested:
                return lane, now, "drain"
            fire_t = items[0].submit_t + self.config.max_wait_s
            trigger = "max_wait"
            est = self._exec_est.get((lane, 0), 0.0)
            for it in items:
                if it.deadline_t is None:
                    continue
                t = it.deadline_t - est - self.config.slack_s
                if t < fire_t:
                    fire_t, trigger = t, "deadline"
            if best[0] is None or fire_t < best[1]:
                best = (lane, fire_t, trigger)
        return best

    def _flusher(self) -> None:
        """Background consumer loop (async scheduler): sleep until the next
        firing time, pull ≤ max_batch from the fired lane's head, execute,
        repeat — submissions during execution land in the lane queues and
        refill the next bucket (continuous batching).  Chunk failures and
        timeouts are absorbed by the recovery loop / :meth:`_resolve_err`,
        so nothing propagates out of this thread."""
        while True:
            with self._cond:
                if self._stop:
                    return
                now = time.perf_counter()
                lane, fire_t, trigger = self._next_fire(now)
                if lane is None:
                    if self._drain_requested:
                        # Queue is empty: the drain is satisfied once
                        # in-flight work lands (tracked by _outstanding).
                        self._drain_requested = False
                        self._cond.notify_all()
                    self._cond.wait()
                    continue
                if fire_t > now:
                    self._cond.wait(timeout=fire_t - now)
                    continue
                items = self._lanes[lane][: self.config.max_batch]
                del self._lanes[lane][: self.config.max_batch]
                self._pending -= len(items)
            self._run_chunk(lane, items, trigger)

    def drain(self, timeout: float | None = None) -> None:
        """Force-fire everything queued and block until every admitted
        ticket has resolved.  On the sync scheduler this is ``flush()``.
        Raises TimeoutError when ``timeout`` elapses with tickets still in
        flight — those tickets stay live (``result`` on one raises
        :class:`TicketPending` until its chunk lands)."""
        if self._thread is None:
            self.flush(trigger="drain")
            return
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            self._drain_requested = True
            self._cond.notify_all()
            while self._outstanding > 0:
                left = (
                    None if deadline is None
                    else deadline - time.perf_counter()
                )
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"{self._outstanding} tickets unresolved after drain "
                        f"timeout {timeout}s"
                    )
                self._cond.wait(timeout=left)

    # -- execution ---------------------------------------------------------
    def flush(self, trigger: str = "manual") -> list[SummarizeResponse | None]:
        """Synchronously drain everything queued now (sync scheduler's
        execution entry; also usable while the async flusher is stopped).
        Returns responses in submission order — entries are None for
        tickets whose chunk failed (the error lives on the ticket)."""
        with self._cond:
            pending: list[_QueueItem] = []
            for items in self._lanes.values():
                pending.extend(items)
            self._lanes = {}
            self._pending -= len(pending)
        pending.sort(key=lambda it: it.ticket.index)
        lanes: dict[tuple, list[_QueueItem]] = {}
        for it in pending:
            lanes.setdefault(it.lane, []).append(it)
        for lane, items in lanes.items():
            for lo in range(0, len(items), self.config.max_batch):
                self._run_chunk(
                    lane, items[lo: lo + self.config.max_batch], trigger
                )
        return [it.ticket._response for it in pending]

    def run(
        self, requests: list[SummarizeRequest]
    ) -> list[SummarizeResponse]:
        """Convenience wrapper: submit everything, drain, and return the
        responses in request order — re-raising the first captured
        per-request error, if any (read the tickets individually via
        ``submit`` to handle partial failure)."""
        tickets = [self.submit(r) for r in requests]
        self.drain()
        return [t.result(timeout=0) for t in tickets]

    # -- recovery ----------------------------------------------------------
    def _run_chunk(
        self, lane: tuple, items: list[_QueueItem], trigger: str
    ) -> None:
        """Execute one popped chunk through the recovery loop; whatever
        happens, every ticket in ``items`` ends settled."""
        for it in items:
            it.ticket._state = "executing"
        try:
            degradation = self._degradation_plan(lane, items)
            if degradation is not None:
                obs.get_bus().emit(
                    "degradation", subsystem="service",
                    request_ids=tuple(it.ticket.index for it in items),
                    level=degradation["level"], reason=degradation["reason"],
                    steps=degradation["steps"],
                    selector=degradation["selector"],
                )
                obs.get_registry().counter(
                    "repro_service_degraded_chunks_total",
                    "chunks planned at a degraded ladder level",
                    labels=("level", "reason"),
                ).inc(level=degradation["level"],
                      reason=degradation["reason"])
            self._execute_with_recovery(lane, items, trigger, degradation)
        except Exception as e:  # noqa: BLE001 - captured on the tickets
            self._resolve_err(items, e)

    def _execute_with_recovery(
        self, lane: tuple, items: list[_QueueItem], trigger: str,
        degradation: dict | None,
    ) -> None:
        """Retry → failover → per-query isolation.

        Per stage (primary backend, then ``failover_backend`` when it
        resolves to a different backend): ``max_retries + 1`` attempts with
        ``retry_backoff_s``·2^(attempt−1) sleeps between them.  A
        :class:`ChunkTimeout` skips the remaining retries of its stage (a
        hung signature is not re-run) but still fails over.  When every
        stage is exhausted and the chunk has >1 query,
        ``isolate_on_failure`` re-runs it one query at a time on the last
        stage's backend — the poisoned query fails alone, its chunk-mates
        complete.  Attempts that already lost their tickets to a faster
        attempt are no-ops (first-wins settle).  An :func:`_unrecoverable`
        error skips every later stage and fails the chunk's tickets."""
        cfg = self.config
        primary = resolve_backend(cfg.backend, self.device)
        stages = [("primary", primary)]
        if cfg.failover_backend is not None:
            fallback = resolve_backend(cfg.failover_backend, self.device)
            if fallback.name != primary.name:
                stages.append(("failover", fallback))
        failures = 0
        tried: list[str] = []
        last_err: Exception | None = None
        idxs = tuple(it.ticket.index for it in items)
        reg = obs.get_registry()
        bus = obs.get_bus()
        for stage, be in stages:
            if be.name not in tried:
                tried.append(be.name)
            if stage == "failover":
                with self._cond:
                    self._stats["failovers"] += 1
                reg.counter(
                    "repro_service_failovers_total",
                    "chunks that reached the failover backend",
                ).inc()
                bus.emit(
                    "recovery", subsystem="service", request_ids=idxs,
                    step="failover", backend=be.name,
                    error=type(last_err).__name__ if last_err else None,
                )
            for attempt in range(cfg.max_retries + 1):
                if attempt > 0:
                    time.sleep(cfg.retry_backoff_s * (2 ** (attempt - 1)))
                recovery = None
                if failures > 0:
                    with self._cond:
                        self._stats["retries"] += 1
                    reg.counter(
                        "repro_service_retries_total",
                        "chunk attempts after a failure",
                        labels=("stage",),
                    ).inc(stage=stage)
                    bus.emit(
                        "recovery", subsystem="service", request_ids=idxs,
                        step="retry", stage=stage, backend=be.name,
                        attempt=attempt, failures=failures,
                    )
                    recovery = {
                        "retries": failures,
                        "stage": stage,
                        "backends": tuple(tried),
                        "isolated": False,
                    }
                try:
                    self._attempt_with_watchdog(
                        lambda be=be, stage=stage, recovery=recovery:
                        self._exec_chunk(
                            lane, items, trigger, backend=be, stage=stage,
                            degradation=degradation, recovery=recovery,
                        )
                    )
                    return
                except ChunkTimeout as e:
                    last_err = e
                    failures += 1
                    with self._cond:
                        self._stats["chunk_timeouts"] += 1
                    reg.counter(
                        "repro_service_chunk_timeouts_total",
                        "watchdog-abandoned chunk attempts",
                    ).inc()
                    bus.emit(
                        "recovery", subsystem="service", request_ids=idxs,
                        step="chunk_timeout", stage=stage, backend=be.name,
                    )
                    break  # hung signature: don't re-run it in this stage
                except Exception as e:  # noqa: BLE001 - recovery continues
                    if _unrecoverable(e):
                        raise
                    last_err = e
                    failures += 1
        if cfg.isolate_on_failure and len(items) > 1:
            stage_be = stages[-1][1]
            reg.counter(
                "repro_service_isolations_total",
                "chunks re-run one query at a time",
            ).inc()
            bus.emit(
                "recovery", subsystem="service", request_ids=idxs,
                step="isolate", backend=stage_be.name, failures=failures,
            )
            for it in items:
                recovery = {
                    "retries": failures,
                    "stage": "isolated",
                    "backends": tuple(tried),
                    "isolated": True,
                }
                try:
                    self._attempt_with_watchdog(
                        lambda it=it, recovery=recovery: self._exec_chunk(
                            lane, [it], trigger, backend=stage_be,
                            stage="isolated", degradation=degradation,
                            recovery=recovery,
                        )
                    )
                except Exception as e:  # noqa: BLE001 - this query fails alone
                    if _unrecoverable(e):
                        raise
                    self._resolve_err([it], e)
            return
        raise last_err

    def _attempt_with_watchdog(self, call: Callable[[], None]) -> None:
        """Run one chunk attempt, bounded by ``chunk_timeout_s``.

        With the watchdog armed the attempt runs in a daemon worker thread;
        if it outlives the budget the attempt is abandoned with
        :class:`ChunkTimeout` — the worker keeps running (a genuinely hung
        device call cannot be interrupted from Python) but its late results
        are discarded by the tickets' first-wins settle and it accounts for
        nothing."""
        timeout = self.config.chunk_timeout_s
        if timeout is None:
            call()
            return
        box: dict[str, BaseException] = {}
        done = threading.Event()

        def worker():
            try:
                call()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                box["error"] = e
            finally:
                done.set()

        t = threading.Thread(
            target=worker, name="summarize-chunk", daemon=True
        )
        t.start()
        if not done.wait(timeout):
            raise ChunkTimeout(
                f"chunk attempt exceeded chunk_timeout_s={timeout}s; "
                "abandoned (late results are discarded)"
            )
        err = box.get("error")
        if err is not None:
            raise err

    # -- degradation ladder ------------------------------------------------
    def _ladder_levels(self, lane: tuple) -> list[dict]:
        """The lane's resolved ladder: per level, the cumulative (r, c,
        selector) actually run and the predicted cost ratio vs the previous
        level (the port's ``ss_cost_model`` for SS-side steps; 1.0 — i.e. "unknown,
        keep walking" — for the selection-side stochastic step until its
        (lane, level) EWMA seeds)."""
        levels = self._ladder_cache.get(lane)
        if levels is not None:
            return levels
        cfg = self.config
        n = lane[2][0]
        use_ss = lane[6]
        r, c, selector = cfg.r, cfg.c, "greedy"
        levels = []
        for step in cfg.ladder:
            base = ss_cost_model(n, r, c) if use_ss else None
            if step == "bump_c":
                c = c * 4.0
            elif step == "shrink_r":
                r = max(1, r // 2)
            else:  # stochastic_greedy
                selector = "stochastic"
            ratio = 1.0
            if base is not None and step in ("bump_c", "shrink_r"):
                ratio = ss_cost_model(n, r, c) / base
            levels.append({
                "step": step, "r": r, "c": c, "selector": selector,
                "ratio": ratio,
            })
        self._ladder_cache[lane] = levels
        return levels

    def _degradation_plan(
        self, lane: tuple, items: list[_QueueItem]
    ) -> dict | None:
        """Decide how degraded this chunk runs (None = full quality).

        Under admission pressure (outstanding work — queued or executing —
        ≥ ``ladder_pressure`` × ``max_pending``) the chunk runs fully
        degraded: the queue is the deadline.  Otherwise the planner walks
        the ladder while the level's execution estimate (measured (lane,
        level) EWMA, else the previous level's estimate × the predicted cost
        ratio) exceeds the chunk's tightest deadline budget.  Cold lanes (no level-0 sample yet) never
        degrade on the deadline path: the first run is unpredictable
        and a served-late-but-full-quality answer is the better default."""
        cfg = self.config
        if not cfg.ladder:
            return None
        levels = self._ladder_levels(lane)
        n_steps = 0
        reason = None
        with self._cond:
            outstanding = self._outstanding
            est0 = self._exec_est.get((lane, 0))
            ests = {
                lv: self._exec_est.get((lane, lv))
                for lv in range(1, len(levels) + 1)
            }
        cap = cfg.max_pending
        if cap is not None and outstanding >= cfg.ladder_pressure * cap:
            n_steps = len(levels)
            reason = "pressure"
        elif est0 is not None:
            deadlines = [
                it.deadline_t for it in items if it.deadline_t is not None
            ]
            if deadlines:
                budget = min(deadlines) - time.perf_counter() - cfg.slack_s
                est = est0
                while n_steps < len(levels) and est > budget:
                    ratio = levels[n_steps]["ratio"]
                    n_steps += 1
                    measured = ests.get(n_steps)
                    est = measured if measured is not None else est * ratio
                reason = "deadline"
        if n_steps == 0:
            return None
        lv = levels[n_steps - 1]
        return {
            "steps": tuple(cfg.ladder[:n_steps]),
            "level": n_steps,
            "r": lv["r"],
            "c": lv["c"],
            "selector": lv["selector"],
            "reason": reason,
        }

    # -- chunk execution ---------------------------------------------------
    def _exec_chunk(
        self, lane: tuple, items: list[_QueueItem], trigger: str, *,
        backend=None, stage: str = "primary",
        degradation: dict | None = None, recovery: dict | None = None,
    ) -> None:
        cfg = self.config
        be = resolve_backend(cfg.backend if backend is None else backend,
                             self.device)
        fault = None
        if self._faults is not None:
            fault = self._faults.draw(
                tickets=tuple(it.ticket.index for it in items),
                lane=lane, backend=be.name, stage=stage,
            )
        if fault is not None and fault.kind in ("crash", "restart"):
            raise self._simulate_restart(kill=fault.kind == "crash")
        if fault is not None and fault.kind == "exec_error":
            raise FaultInjected(
                f"injected exec error on tickets "
                f"{[it.ticket.index for it in items]} ({stage}/{be.name})"
            )
        if fault is not None and fault.kind in ("latency", "hang"):
            time.sleep(fault.delay_s)

        n_real = len(items)
        bucket = min(b for b in self._buckets if b >= n_real)
        # Pad the batch dimension by repeating row 0 (results discarded), so
        # a lane runs at a few batch sizes only.  Every row, padding
        # included, draws from a fresh generator at its query's admitted
        # state: a padding row never advances row 0's stream, and a retry
        # replays the first attempt's draws.
        padded = items + [items[0]] * (bucket - n_real)
        _, _, _, k, _, _, use_ss, n_pad = lane

        on_step = None
        if cfg.stream_steps:
            for it in items:
                it.ticket._steps.clear()    # a retried attempt restarts it

            def on_step(step, v, g, ok):
                # streaming reads every step's picks to the host: three
                # reads a step (the reference reads each row's apart)
                oks, vs, gs = ok.tolist(), v.tolist(), g.tolist()
                for i, it in enumerate(items):
                    if oks[i]:
                        it.ticket._steps.append((int(vs[i]), float(gs[i])))

        deg = degradation
        t_start = time.perf_counter()
        tr = obs.get_tracer()
        if tr.enabled:
            # Queue residency is only known retroactively — record each
            # item's wait span from its admission timestamp now that
            # execution starts.
            for it in items:
                tr.record(
                    "queue.wait", it.submit_t, t_start,
                    trace_id=f"req-{it.ticket.index}",
                    lane=_lane_label(lane), trigger=trigger,
                )
        with tr.span(
            "chunk.exec", trace_id=f"req-{items[0].ticket.index}",
            request_ids=tuple(it.ticket.index for it in items),
            lane=_lane_label(lane), backend=be.name, stage=stage,
            trigger=trigger, bucket=bucket, batch=n_real,
            degraded=0 if deg is None else deg["level"],
        ):
            fn, alive = build_batch_objective(
                [it.request for it in padded], n_pad, device=self.device)
            gens = [generator_from_state(it.draw, self.device) for it in padded]
            res, ss = summarize_batch(
                fn, k, gens,
                r=cfg.r if deg is None else deg["r"],
                c=cfg.c if deg is None else deg["c"],
                use_ss=use_ss, alive=alive,
                backend=be, compact=cfg.compact, on_step=on_step,
                selector="greedy" if deg is None else deg["selector"],
                eps=cfg.eps,
            )
            if fault is not None and fault.kind == "malformed":
                res = res._replace(gains=torch.full_like(res.gains, float("nan")))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)    # exec_s times the card
            values, vp_sizes, eps_hats, finite = _chunk_scalars(res, ss, n_real)
            if not finite:
                raise MalformedResult(
                    f"non-finite gains/value in chunk results "
                    f"({stage}/{be.name})"
                )
            t_end = time.perf_counter()
            exec_s = t_end - t_start

        responses = []
        for i, it in enumerate(items):
            deadline_missed = (
                None if it.deadline_t is None else t_end > it.deadline_t
            )
            responses.append(SummarizeResponse(
                selected=res.selected[i],
                gains=res.gains[i],
                value=values[i],
                vprime_size=None if ss is None else vp_sizes[i],
                eps_hat=None if ss is None else eps_hats[i],
                rounds=None if ss is None else int(ss.rounds[i]),
                lane=lane,
                batch_size=n_real,
                batch_bucket=bucket,
                queue_delay_s=t_start - it.submit_t,
                exec_s=exec_s,
                trigger=trigger,
                deadline_missed=deadline_missed,
                degradation=deg,
                recovery=recovery,
            ))
        # Settle before accounting: first-wins — a watchdog-abandoned
        # attempt finishing late loses every ticket here and must account
        # for nothing; and drain()'s _outstanding==0 then guarantees every
        # ticket is already resolved (no settle/drain race).
        settled = [
            (it, resp) for it, resp in zip(items, responses)
            if it.ticket._settle(response=resp)
        ]
        if not settled:
            return
        missed = sum(bool(r.deadline_missed) for _, r in settled)
        with self._cond:
            st = self._stats
            st["batches"] += 1
            st["queries"] += len(settled)
            st["slots"] += bucket
            st["padded_slots"] += bucket - n_real
            st["exec_s_sum"] += exec_s
            st["lanes"].add((lane, bucket))
            st["triggers"][trigger] = st["triggers"].get(trigger, 0) + 1
            st["deadlines_missed"] += missed
            if deg is not None:
                st["degraded"] += len(settled)
            if stage == "isolated":
                st["isolated_queries"] += len(settled)
            for _, resp in settled:
                st["queue_delay_s_sum"] += resp.queue_delay_s
                st["queue_delay_s_max"] = max(
                    st["queue_delay_s_max"], resp.queue_delay_s
                )
            # EWMA execution estimate drives the deadline-slack trigger and
            # the degradation planner; keyed (lane, ladder level) so a
            # degraded sample never corrupts the full-quality estimate.
            # The first sample seeds it (before that the estimate is 0 — a
            # deadline shorter than the first run is simply served late
            # and flagged, never dropped).
            est_key = (lane, 0 if deg is None else deg["level"])
            self._exec_est[est_key] = ewma_update(
                self._exec_est.get(est_key), exec_s
            )
            self._outstanding -= len(settled)
            pending_now, outstanding_now = self._pending, self._outstanding
            self._cond.notify_all()
        lane_lbl = _lane_label(lane)
        reg = obs.get_registry()
        reg.histogram(
            "repro_service_exec_seconds", "chunk execution wall time",
            labels=("lane", "backend", "stage"),
        ).observe(exec_s, lane=lane_lbl, backend=be.name, stage=stage)
        delay_h = reg.histogram(
            "repro_service_queue_delay_seconds",
            "per-query admission-to-execution delay", labels=("lane",),
        )
        for _, resp in settled:
            delay_h.observe(resp.queue_delay_s, lane=lane_lbl)
        reg.counter(
            "repro_service_queries_total", "queries served",
        ).inc(len(settled))
        reg.counter(
            "repro_service_batches_total", "chunks executed by trigger",
            labels=("trigger",),
        ).inc(trigger=trigger)
        reg.counter(
            "repro_service_slots_total", "executed batch slots",
        ).inc(bucket)
        reg.counter(
            "repro_service_padded_slots_total",
            "slots burned padding chunks up to their batch bucket",
        ).inc(bucket - n_real)
        if missed:
            reg.counter(
                "repro_service_deadlines_missed_total",
                "settled queries past their deadline",
            ).inc(missed)
        reg.counter(
            "repro_service_degradation_level_total",
            "queries served per ladder level (level 0 = full quality)",
            labels=("level",),
        ).inc(len(settled), level=0 if deg is None else deg["level"])
        reg.gauge(
            "repro_service_pending", "requests queued, not yet executing",
        ).set(pending_now)
        reg.gauge(
            "repro_service_outstanding", "requests queued or executing",
        ).set(outstanding_now)

    def _simulate_restart(self, *, kill: bool) -> ServiceRestarted:
        """A drawn ``crash``/``restart`` fault: the in-memory engine dies.

        Every queued item is drained and — like the in-flight chunk, whose
        items settle when the caller raises the returned error — settled
        with :class:`ServiceRestarted`, so no ticket ever hangs in
        ``TicketPending`` across a restart.  ``kill=True`` (crash) also
        poisons admission: subsequent :meth:`submit` calls fail their
        tickets with the same error.  ``kill=False`` (restart) keeps the
        service serving new submissions — the restarted process comes back
        with empty queues."""
        what = "crashed" if kill else "restarted"
        err = ServiceRestarted(
            f"the service {what} while this request was in flight; "
            "in-memory state (queues, in-flight chunks) was lost"
        )
        with self._cond:
            drained: list[_QueueItem] = []
            for lane_items in self._lanes.values():
                drained.extend(lane_items)
            self._lanes.clear()
            self._pending = 0
            self._stats["restarts"] += 1
            if kill:
                self._killed = True
        obs.get_bus().emit(
            "restart", subsystem="service",
            request_ids=tuple(it.ticket.index for it in drained),
            kill=kill,
        )
        obs.get_registry().counter(
            "repro_service_restarts_total", "simulated engine restarts",
        ).inc()
        self._resolve_err(drained, err)
        return err

    def _resolve_err(
        self, items: list[_QueueItem], error: BaseException
    ) -> None:
        """Fail every not-yet-settled ticket in ``items`` with ``error`` and
        account only for the ones this call actually settled."""
        settled = [it for it in items if it.ticket._settle(error=error)]
        if not settled:
            return
        with self._cond:
            self._stats["failed"] += len(settled)
            self._outstanding -= len(settled)
            self._cond.notify_all()

    # -- accounting --------------------------------------------------------
    def stats(self) -> dict:
        """Aggregate serving counters: query/batch totals, padding waste
        (fraction of executed slots burned on bucket padding), queue-delay
        mean/max, distinct (lane, bucket) signatures (``compiled_signatures``,
        the reference's name), firing-trigger counts,
        missed deadlines, failed (admission- or execution-errored) tickets,
        and the fault-tolerance counters — retried attempts, chunks that
        reached failover, queries served from per-query isolation, watchdog
        chunk timeouts, and queries served degraded."""
        # The whole snapshot — including every derived value — is computed
        # under the ticket-settle lock, so the returned dict is one
        # consistent point in time: ``queries`` can never disagree with the
        # ``queue_delay_s_sum`` it divides (the old read-then-derive path
        # could tear between a settle and the division).
        with self._cond:
            st = self._stats
            q = max(st["queries"], 1)
            return {
                "queries": st["queries"],
                "batches": st["batches"],
                "padding_waste_frac": (
                    st["padded_slots"] / max(st["slots"], 1)
                ),
                "queue_delay_s_mean": st["queue_delay_s_sum"] / q,
                "queue_delay_s_max": st["queue_delay_s_max"],
                "exec_s_total": st["exec_s_sum"],
                "compiled_signatures": len(st["lanes"]),
                "triggers": dict(st["triggers"]),
                "deadlines_missed": st["deadlines_missed"],
                "failed": st["failed"],
                "retries": st["retries"],
                "failovers": st["failovers"],
                "isolated_queries": st["isolated_queries"],
                "chunk_timeouts": st["chunk_timeouts"],
                "degraded": st["degraded"],
                "restarts": st["restarts"],
            }
