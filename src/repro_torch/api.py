"""``repro_torch.api`` — the public facade over the port's summarization
service and streaming sessions, the counterpart of the JAX package's
``repro.api``.

- :func:`summarize` — one query, one call: build the objective from a raw
  payload, run SS → compact greedy through the service's execution core,
  and return the :class:`SummarizeResponse`.
- :func:`serve` — a :class:`SummarizeService` under a :class:`RunConfig`
  (``scheduler="async"`` for the deadline-driven background flusher; the
  service is a context manager).
- :func:`submit` — fire-and-forget onto a process-wide default *async*
  service (:func:`default_service`); returns the :class:`Ticket` future.
- :func:`sessions` — a :class:`SessionEngine`, the durable multi-session
  streaming tier (pass a ``root`` directory for the WAL + snapshot
  durability contract); :func:`open_session` / :func:`append` /
  :func:`summary` — the per-session verbs, routed to a process-wide
  default engine (:func:`default_engine`) when none is given.
- :func:`stats` — one consistent snapshot of a service's counters;
  :func:`metrics` — the process-wide metrics registry as Prometheus text or
  a JSON-serializable dict.  ``repro_torch.obs.configure(trace=True)`` (or
  ``REPRO_TRACE=1``) records request span trees
  (:func:`repro_torch.obs.trace_summary`).

Every verb that creates a service or a session engine takes ``device``
("cuda", the card, by default; a host without one raises); pass
``device="cpu"`` to run the plain PyTorch route on the host.  The session
verbs create the default engine on the card, so without a card they need
an ``engine``.  Execution knobs ride one
:class:`RunConfig`; per-query knobs (payload, ``k``, ``seed``, objective,
``deadline_s``) ride :class:`SummarizeRequest`.
"""

from __future__ import annotations

import dataclasses
import threading

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.sessions import SessionConfig, SessionEngine, SessionSummary
from repro_torch.serve.summarize_service import (
    LADDER_STEPS,
    ChunkTimeout,
    DeadlineExceeded,
    MalformedResult,
    RunConfig,
    ServiceOverloaded,
    ServiceRestarted,
    SummarizeRequest,
    SummarizeResponse,
    SummarizeService,
    Ticket,
    TicketPending,
)
from repro_torch.serve.wal import WALCorrupt, WALTruncated

__all__ = [
    "LADDER_STEPS",
    "ChunkTimeout",
    "DeadlineExceeded",
    "FaultPlan",
    "MalformedResult",
    "RunConfig",
    "ServiceOverloaded",
    "ServiceRestarted",
    "SessionConfig",
    "SessionEngine",
    "SessionSummary",
    "SummarizeRequest",
    "SummarizeResponse",
    "SummarizeService",
    "Ticket",
    "TicketPending",
    "WALCorrupt",
    "WALTruncated",
    "append",
    "default_engine",
    "default_service",
    "metrics",
    "open_session",
    "serve",
    "sessions",
    "stats",
    "submit",
    "summarize",
    "summary",
]

_default_service: SummarizeService | None = None
_default_engine: SessionEngine | None = None
_default_lock = threading.Lock()


def serve(
    config: RunConfig | None = None, *, faults: FaultPlan | None = None,
    device="cuda",
) -> SummarizeService:
    """A fresh :class:`SummarizeService` under ``config`` (default
    ``RunConfig()``: the synchronous scheduler) on ``device``.  ``faults``
    threads a seeded :class:`FaultPlan` into the executor (the chaos-testing
    hook); production callers leave it None."""
    return SummarizeService(config or RunConfig(), faults=faults, device=device)


def default_service(config: RunConfig | None = None,
                    device="cuda") -> SummarizeService:
    """The process-wide service :func:`submit` targets, created on first use
    on ``device`` (``RunConfig(scheduler="async")`` unless ``config``
    overrides at creation).  Asking for another config or another device
    once it exists is an error: use :func:`serve` for a separate
    instance."""
    global _default_service
    dev = resolve_device(device)
    with _default_lock:
        if _default_service is None:
            cfg = config or RunConfig(scheduler="async")
            if cfg.scheduler != "async":
                cfg = dataclasses.replace(cfg, scheduler="async")
            _default_service = SummarizeService(cfg, device=dev)
        elif _default_service.device != dev or (
                config is not None and config != dataclasses.replace(
                    _default_service.config, scheduler=config.scheduler)):
            raise ValueError(
                "the default service is already configured (on "
                f"{_default_service.device}); use repro_torch.api.serve(config, "
                "device=...) for a differently-configured one"
            )
        return _default_service


def submit(
    request: SummarizeRequest, service: SummarizeService | None = None
) -> Ticket:
    """Admit one request to ``service`` (default: the process-wide async
    service, created on the card if none exists yet) and return its
    :class:`Ticket` future."""
    if service is None:
        with _default_lock:
            service = _default_service
    return (service or default_service()).submit(request)


def summarize(
    features=None,
    k: int = 10,
    seed=0,
    *,
    sim=None,
    objective: str = "coverage",
    phi: str = "sqrt",
    kernel: str = "cosine",
    use_ss: bool = True,
    config: RunConfig | None = None,
    device="cuda",
) -> SummarizeResponse:
    """One-call single-query summarization through the service's execution
    core on ``device`` (the results of ``ss_sparsify`` + ``greedy`` under
    the same seed: the batching contract with B = 1).

    ``features`` is the (n, F) payload (FeatureCoverage's W, or the
    similarity kernel's input for ``objective="fl"``); ``sim`` a
    precomputed (n, n) similarity instead; ``seed`` an int or a
    ``torch.Generator``.  Everything execution-level rides ``config``.
    """
    cfg = config or RunConfig()
    if cfg.scheduler != "sync":
        cfg = dataclasses.replace(cfg, scheduler="sync")
    svc = SummarizeService(cfg, device=device)
    req = SummarizeRequest(
        k=k, seed=seed, features=features, sim=sim, objective=objective,
        phi=phi, kernel=kernel, use_ss=use_ss,
    )
    return svc.run([req])[0]


# ------------------------------------------------------------- streaming ----

def sessions(
    config: SessionConfig | None = None,
    root: str | None = None,
    *,
    faults: FaultPlan | None = None,
    device="cuda",
) -> SessionEngine:
    """A fresh :class:`SessionEngine` on ``device``: the durable
    multi-session streaming tier (docs/streaming.md).  ``root=None`` runs
    volatile; a directory arms the WAL + snapshot durability contract, and
    a new engine on the same root recovers every session bit-identically.
    ``faults`` is the chaos hook (``crash``/``restart`` kinds included)."""
    return SessionEngine(config or SessionConfig(), root, faults=faults,
                         device=device)


def default_engine(
    config: SessionConfig | None = None, root: str | None = None,
    device="cuda",
) -> SessionEngine:
    """The process-wide engine the session verbs target, created on first
    use on ``device`` (volatile unless ``root`` is given then).  A crashed
    or closed default is replaced on the next call; passing a different
    config, root or device while one is live is an error (use
    :func:`sessions` instead): silently returning the live engine on a root
    mismatch would let a caller who asked for durability believe volatile
    acks survive a crash."""
    global _default_engine
    dev = resolve_device(device)
    with _default_lock:
        eng = _default_engine
        if eng is None or eng._dead is not None or eng._closed:
            _default_engine = SessionEngine(config or SessionConfig(), root,
                                            device=dev)
        elif config is not None and config != eng.config:
            raise ValueError(
                "the default session engine is already configured; use "
                "repro_torch.api.sessions(config) for a differently-configured "
                "one"
            )
        elif root is not None and root != eng.root:
            raise ValueError(
                "the default session engine is already rooted at "
                f"{eng.root!r} (None = volatile, appends are NOT durable); "
                "use repro_torch.api.sessions(root=...) for a "
                "differently-rooted engine"
            )
        elif dev != eng.device:
            raise ValueError(
                f"the default session engine runs on {eng.device}; use "
                "repro_torch.api.sessions(device=...) for another device"
            )
        return _default_engine


def _engine(engine: SessionEngine | None) -> SessionEngine:
    """``engine``, else the live process-wide default, else a new default
    on the card."""
    if engine is not None:
        return engine
    with _default_lock:
        eng = _default_engine
    if eng is not None and eng._dead is None and not eng._closed:
        return eng
    return default_engine()


def open_session(
    sid: str | None = None, *, key: int = 0,
    engine: SessionEngine | None = None,
) -> str:
    """Create a streaming session on ``engine`` (default: the process-wide
    :func:`default_engine`, created on the card if none is live); returns
    the session id."""
    return _engine(engine).open_session(sid, key=key)


def append(sid: str, row, engine: SessionEngine | None = None) -> int:
    """Ingest one (F,) feature row into session ``sid``; returns the WAL
    sequence number: on a durable engine the element survives any crash
    from the moment this returns."""
    return _engine(engine).append(sid, row)


def summary(sid: str, engine: SessionEngine | None = None) -> SessionSummary:
    """The session's current k-element summary (flushes pending appends,
    then greedy over the SS-pruned retained buffer)."""
    return _engine(engine).summary(sid)


# --------------------------------------------------------- observability ----

def stats(service: SummarizeService | None = None) -> dict:
    """One consistent snapshot of ``service``'s serving counters
    (:meth:`SummarizeService.stats`, taken under the service's settle lock).
    Defaults to the process-wide :func:`default_service` when one exists;
    raises when there is neither an argument nor a default service."""
    if service is None:
        with _default_lock:
            service = _default_service
        if service is None:
            raise RuntimeError(
                "no default service exists yet; pass the service whose "
                "stats you want (or submit something first)"
            )
    return service.stats()


def metrics(fmt: str = "prometheus"):
    """The process-wide metrics registry: the scheduler's, recovery's and
    degradation's counters, gauges and histograms, and the core's.
    ``fmt="prometheus"`` returns the text exposition format; ``fmt="json"``
    a JSON-serializable dict."""
    reg = obs.get_registry()
    if fmt == "prometheus":
        return reg.to_prometheus()
    if fmt == "json":
        return reg.to_json()
    raise ValueError(f"fmt must be 'prometheus' or 'json'; got {fmt!r}")
