"""Seeded fault injection for the serving stack (the chaos-testing hook):
an own copy of the JAX package's ``serve/faults.py``, logging to the
port's own :mod:`repro_torch.obs`.

A :class:`FaultPlan` is a *deterministic* schedule mapping chunk execution
attempts (a global, service-wide attempt counter) to faults:

- ``exec_error``   — the attempt raises :class:`FaultInjected` before any
  work runs (a stand-in for a failed kernel launch, an out-of-memory error
  or a lost device);
- ``latency``      — the attempt sleeps ``delay_s`` before executing
  (a transient stall);
- ``hang``         — like ``latency`` but with a wall time chosen to exceed
  ``RunConfig.chunk_timeout_s``: the watchdog abandons the attempt and the
  injected sleep is what the abandoned worker burns (a wedged kernel);
- ``malformed``    — the attempt executes but its results are corrupted to
  NaN before the executor's result validation, which must catch them
  (:class:`repro_torch.serve.summarize_service.MalformedResult`) and retry;
- ``crash``        — the engine drawing the fault dies: in-memory state is
  discarded, every in-flight ticket settles with
  :class:`~repro_torch.serve.summarize_service.ServiceRestarted`, and
  further submissions are rejected (recovery is a new service);
- ``restart``      — a crash followed at once by an in-place recovery:
  in-flight tickets settle with ``ServiceRestarted`` while the service
  keeps serving new submissions.

The plan is threaded into :class:`~repro_torch.serve.summarize_service.
SummarizeService` through its ``faults=`` argument; production services
never construct one.  The flusher (async) or the caller (sync) executes
chunks one after another, so the attempt counter — and therefore the fault
sequence — is deterministic for a fixed submission order, and
:attr:`FaultPlan.log` records every draw with the ticket indices it hit.

``FaultPlan.seeded(seed, ...)`` builds a schedule from per-kind rates with
``numpy.random.default_rng(seed)``: the same seed always yields the same
schedule as the JAX package's plan, independent of execution timing.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Mapping

import numpy as np

from repro_torch import obs


class FaultInjected(RuntimeError):
    """An injected execution error (the harness's stand-in for a poisoned
    kernel launch); recoverable — the executor retries / fails over."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: ``kind`` plus the sleep it injects (``delay_s``
    is only meaningful for ``latency`` / ``hang``)."""

    kind: str        # exec_error | latency | hang | malformed | crash | restart
    delay_s: float = 0.0

    KINDS = ("exec_error", "latency", "hang", "malformed", "crash", "restart")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(
                f"fault kind must be one of {self.KINDS}; got {self.kind!r}"
            )


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault actually drawn by the executor — the attribution record."""

    attempt: int                # global execution-attempt index
    fault: Fault
    tickets: tuple[int, ...]    # Ticket.index of every request in the chunk
    lane: Any
    backend: str                # backend name the attempt ran under
    stage: str                  # primary | failover | isolated


class FaultPlan:
    """Deterministic attempt-indexed fault schedule + attribution log.

    ``schedule`` maps a global execution-attempt index (0-based, counted
    across every chunk attempt the service makes, including retries and
    per-query isolation sub-chunks) to the :class:`Fault` injected on that
    attempt.  Attempts not in the schedule run clean.
    """

    def __init__(self, schedule: Mapping[int, Fault]):
        self.schedule = {int(i): f for i, f in schedule.items()}
        for i, f in self.schedule.items():
            if i < 0:
                raise ValueError(f"attempt index must be >= 0; got {i}")
            if not isinstance(f, Fault):
                raise TypeError(f"schedule values must be Fault; got {f!r}")
        # Bounded: a long chaos run ages old draws out instead of growing
        # without limit; ``log.dropped`` counts the evicted history.
        self.log: obs.RingLog = obs.RingLog()
        self._attempts = 0
        self._lock = threading.Lock()

    @classmethod
    def seeded(
        cls,
        seed: int,
        n_attempts: int = 64,
        *,
        p_exec_error: float = 0.0,
        p_latency: float = 0.0,
        p_hang: float = 0.0,
        p_malformed: float = 0.0,
        p_crash: float = 0.0,
        p_restart: float = 0.0,
        latency_s: float = 0.05,
        hang_s: float = 5.0,
    ) -> "FaultPlan":
        """A schedule over the first ``n_attempts`` execution attempts with
        per-attempt fault probabilities, drawn once at construction from
        ``default_rng(seed)`` — fully reproducible, timing-independent."""
        probs = {
            "exec_error": p_exec_error,
            "latency": p_latency,
            "hang": p_hang,
            "malformed": p_malformed,
            "crash": p_crash,
            "restart": p_restart,
        }
        if sum(probs.values()) > 1.0:
            raise ValueError(f"fault probabilities sum past 1: {probs}")
        rng = np.random.default_rng(seed)
        kinds = list(probs) + [None]
        weights = list(probs.values())
        weights.append(1.0 - sum(weights))
        schedule: dict[int, Fault] = {}
        for i in range(n_attempts):
            kind = rng.choice(kinds, p=weights)
            if kind is None:
                continue
            delay = {"latency": latency_s, "hang": hang_s}.get(kind, 0.0)
            schedule[i] = Fault(kind=str(kind), delay_s=delay)
        return cls(schedule)

    @property
    def attempts(self) -> int:
        """Execution attempts drawn against this plan so far."""
        with self._lock:
            return self._attempts

    def draw(
        self, *, tickets: tuple[int, ...], lane: Any, backend: str, stage: str
    ) -> Fault | None:
        """Consume one attempt index; returns the scheduled fault (logged
        with full attribution) or None for a clean attempt."""
        with self._lock:
            i = self._attempts
            self._attempts += 1
            fault = self.schedule.get(i)
            if fault is not None:
                self.log.append(FaultEvent(
                    attempt=i, fault=fault, tickets=tuple(tickets),
                    lane=lane, backend=backend, stage=stage,
                ))
        if fault is not None:
            obs.get_bus().emit(
                "fault", subsystem="faults", request_ids=tuple(tickets),
                attempt=i, fault_kind=fault.kind, delay_s=fault.delay_s,
                backend=backend, stage=stage,
            )
            obs.get_registry().counter(
                "repro_faults_injected_total", "fault draws by kind",
                labels=("kind",),
            ).inc(kind=fault.kind)
        return fault

    def events(self, kind: str | None = None) -> list[FaultEvent]:
        """The attribution log, optionally filtered to one fault kind."""
        with self._lock:
            return [
                e for e in self.log
                if kind is None or e.fault.kind == kind
            ]
