"""Structured request tracing: span trees over the serving stack.  An own
copy of the JAX package's ``obs/trace.py``.

A **span** is one timed region — monotonic ``t0``/``t1`` from
``time.perf_counter()``, a ``span_id``, its ``parent_id`` (implicit: the
span that was active on this thread when it started), a ``trace_id``
grouping one request's tree, and free-form ``attrs``.  Finished spans land
in a bounded in-process ring buffer (:class:`repro_torch.obs.events.RingLog`)
with a drop counter; nothing is ever written synchronously to disk.

Tracing is **off by default** (enable with :func:`configure` or
``REPRO_TRACE=1``).  When off, :func:`span` returns a shared no-op context
manager after one attribute check, and the core's hooks add no device op
and no host read.  Results are bit-identical either way, because the
instrumentation only *observes* outputs.

Device safety: the core's hooks (``repro_torch.core.greedy._traceable``)
are active only with tracing on and outside a CUDA graph capture.  An
active hook synchronises the device before it reads the wall clock and
reads the results to the host after the loop returns, never inside it;
per-round SS records are derived after the fact from
``SSResult.alive_trace``, and per-round wall times are model-apportioned
estimates of the measured total (``wall_est_s``).

Span trees are assembled per request: a span belongs to request ``i`` when
its ``trace_id == f"req-{i}"`` or its ``request_ids`` attr contains ``i``
(a chunk span is shared by its batch mates).  :func:`format_trace` renders
one request's tree; :func:`trace_summary` renders the most recent one
(the quickstart prints this).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from typing import Any, Iterator

from repro_torch.obs.events import RingLog

DEFAULT_CAPACITY = 8192


class Span:
    """One timed region.  Mutable while open (``attrs`` may be filled as
    results become known); immutable by convention once finished."""

    __slots__ = (
        "span_id", "parent_id", "trace_id", "name", "t0", "t1", "status",
        "attrs",
    )

    def __init__(self, span_id: int, parent_id: int | None, trace_id: str,
                 name: str, t0: float, attrs: dict):
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_id = trace_id
        self.name = name
        self.t0 = t0
        self.t1: float | None = None
        self.status = "ok"
        self.attrs = attrs

    @property
    def wall_s(self) -> float:
        return (self.t1 if self.t1 is not None else time.perf_counter()) \
            - self.t0

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "trace_id": self.trace_id,
            "name": self.name,
            "t0": self.t0,
            "t1": self.t1,
            "wall_s": None if self.t1 is None else self.t1 - self.t0,
            "status": self.status,
            "attrs": self.attrs,
        }

    def __repr__(self) -> str:
        return (
            f"Span({self.name!r}, id={self.span_id}, "
            f"trace={self.trace_id!r}, wall={self.wall_s * 1e3:.2f}ms)"
        )


class _NoopSpan:
    """Shared do-nothing span handed out while tracing is disabled — every
    mutator is a cheap no-op so call sites need no ``if`` guards."""

    __slots__ = ()
    span_id = -1
    parent_id = None
    trace_id = ""
    name = ""
    status = "ok"
    attrs: dict = {}
    wall_s = 0.0

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self


_NOOP_SPAN = _NoopSpan()


@contextlib.contextmanager
def _noop_cm() -> Iterator[_NoopSpan]:
    yield _NOOP_SPAN


class Tracer:
    """Span recorder: bounded ring buffer + contextvar-based implicit
    parenting (thread- and task-local, so the async flusher's spans never
    adopt a submitter's parent)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("REPRO_TRACE", "") == "1"
        self.enabled = bool(enabled)
        self._ring = RingLog(capacity)
        self._ids = itertools.count()
        self._current: contextvars.ContextVar[Span | None] = \
            contextvars.ContextVar("repro_obs_span", default=None)
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------
    def start_span(self, name: str, *, trace_id: str | None = None,
                   parent: Span | None = None, **attrs: Any) -> Span:
        """Open a span explicitly (for lifetimes that don't nest lexically,
        e.g. a request span living from submit to settle).  The caller owns
        calling :meth:`finish`."""
        if not self.enabled:
            return _NOOP_SPAN  # type: ignore[return-value]
        if parent is None:
            parent = self._current.get()
        if trace_id is None:
            trace_id = parent.trace_id if parent is not None else "untraced"
        with self._lock:
            sid = next(self._ids)
        return Span(
            span_id=sid,
            parent_id=None if parent is None else parent.span_id,
            trace_id=trace_id, name=name, t0=time.perf_counter(),
            attrs=dict(attrs),
        )

    def finish(self, sp: Span, status: str = "ok") -> None:
        """Close and record an explicitly-started span."""
        if sp is _NOOP_SPAN or not self.enabled:
            return
        if sp.t1 is None:
            sp.t1 = time.perf_counter()
        sp.status = status
        self._ring.append(sp)

    def span(self, name: str, *, trace_id: str | None = None,
             **attrs: Any):
        """Context manager: open a child of the currently-active span, make
        it current for the body, record it on exit (``status="error"`` when
        the body raises)."""
        if not self.enabled:
            return _noop_cm()
        return self._span_cm(name, trace_id, attrs)

    @contextlib.contextmanager
    def _span_cm(self, name: str, trace_id: str | None,
                 attrs: dict) -> Iterator[Span]:
        sp = self.start_span(name, trace_id=trace_id, **attrs)
        token = self._current.set(sp)
        try:
            yield sp
        except BaseException:
            self.finish(sp, status="error")
            raise
        finally:
            self._current.reset(token)
        self.finish(sp)

    def record(self, name: str, t0: float, t1: float, *,
               trace_id: str | None = None, parent: Span | None = None,
               status: str = "ok", **attrs: Any) -> None:
        """Record a span retroactively from already-measured perf_counter
        endpoints (e.g. a queue-residency span derived at execution start
        from the admission timestamp)."""
        if not self.enabled:
            return
        sp = self.start_span(name, trace_id=trace_id, parent=parent, **attrs)
        sp.t0, sp.t1 = t0, t1
        sp.status = status
        self._ring.append(sp)

    def current_span(self) -> Span | None:
        """The span active on this thread/task (None outside any span)."""
        return self._current.get()

    # -- reading -----------------------------------------------------------
    @property
    def dropped(self) -> int:
        return self._ring.dropped

    def spans(self, trace_id: str | None = None,
              name: str | None = None) -> list[Span]:
        """Finished spans (oldest first), optionally filtered."""
        return [
            s for s in self._ring
            if (trace_id is None or s.trace_id == trace_id)
            and (name is None or s.name == name)
        ]

    def spans_for_request(self, index: int) -> list[Span]:
        """Every span belonging to request ``index``'s tree: its own
        ``req-<i>`` trace plus shared spans (chunk executions and their
        children) whose ``request_ids`` attr contains ``i``."""
        tid = f"req-{index}"
        out, shared_roots = [], set()
        for s in self._ring:
            if s.trace_id == tid:
                out.append(s)
            elif index in s.attrs.get("request_ids", ()):
                out.append(s)
                shared_roots.add(s.span_id)
        if shared_roots:
            # pull in descendants of the shared (chunk) spans: SS / greedy /
            # objective-build children recorded under the chunk's trace.
            known = {s.span_id for s in out}
            grew = True
            while grew:
                grew = False
                for s in self._ring:
                    if s.span_id not in known and s.parent_id in known:
                        out.append(s)
                        known.add(s.span_id)
                        grew = True
        return sorted(out, key=lambda s: (s.t0, s.span_id))

    def export(self) -> list[dict]:
        """JSON-serializable dump of every retained span."""
        return [s.to_dict() for s in self._ring]

    def clear(self) -> None:
        self._ring.clear()


_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer every ``span()`` hook records into."""
    return _tracer


def configure(*, trace: bool | None = None,
              capacity: int | None = None) -> Tracer:
    """Enable/disable tracing and/or resize the span ring.  Resizing drops
    recorded spans (the ring is rebuilt); the enable flag is cheap to flip
    at any time."""
    global _tracer
    if capacity is not None and capacity != _tracer._ring.capacity:
        _tracer = Tracer(capacity=capacity, enabled=_tracer.enabled)
    if trace is not None:
        _tracer.enabled = bool(trace)
    return _tracer


def trace_enabled() -> bool:
    return _tracer.enabled


def span(name: str, *, trace_id: str | None = None, **attrs: Any):
    """Module-level convenience: a span on the global tracer (no-op context
    manager when tracing is disabled)."""
    return _tracer.span(name, trace_id=trace_id, **attrs)


# ------------------------------------------------------------- rendering ----

def _render(spans: list[Span]) -> str:
    if not spans:
        return "(no spans recorded — is tracing enabled?)"
    by_parent: dict[int | None, list[Span]] = {}
    ids = {s.span_id for s in spans}
    for s in spans:
        parent = s.parent_id if s.parent_id in ids else None
        by_parent.setdefault(parent, []).append(s)
    t_base = min(s.t0 for s in spans)
    lines: list[str] = []

    def walk(parent: int | None, depth: int) -> None:
        for s in sorted(by_parent.get(parent, ()),
                        key=lambda s: (s.t0, s.span_id)):
            extra = ""
            keep = {
                k: v for k, v in s.attrs.items()
                if isinstance(v, (int, float, str, bool)) and k != "wall_s"
            }
            if keep:
                extra = "  " + ", ".join(
                    f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in sorted(keep.items())
                )
            flag = "" if s.status == "ok" else f"  [{s.status}]"
            lines.append(
                f"{'  ' * depth}{s.name:<24s} "
                f"+{(s.t0 - t_base) * 1e3:8.2f}ms "
                f"{s.wall_s * 1e3:8.2f}ms{flag}{extra}"
            )
            walk(s.span_id, depth + 1)

    walk(None, 0)
    return "\n".join(lines)


def format_trace(trace_id: str) -> str:
    """One trace's span tree as indented text (name, start offset,
    duration, scalar attrs) — offsets are relative to the tree's first
    span.  For a request id ``i`` pass ``f"req-{i}"``; shared chunk spans
    and their SS/greedy children are included."""
    if trace_id.startswith("req-"):
        spans_ = _tracer.spans_for_request(int(trace_id[4:]))
    else:
        spans_ = _tracer.spans(trace_id=trace_id)
    return _render(spans_)


def trace_summary(request: int | None = None) -> str:
    """The span tree of request ``request`` — default: the most recently
    traced request (the quickstart's one-request trace summary)."""
    if request is None:
        reqs = [
            s for s in _tracer.spans() if s.trace_id.startswith("req-")
        ]
        if not reqs:
            return "(no request spans recorded — is tracing enabled?)"
        request = int(reqs[-1].trace_id[4:])
    return f"trace req-{request}\n" + format_trace(f"req-{request}")
