"""Observability for the port: an own copy of the JAX package's ``obs``
(the port imports nothing of it), one import surface for three layers.

- :mod:`repro_torch.obs.trace` — per-request span trees (admission → lane
  queue → chunk exec → SS → greedy selection → recovery / degradation)
  recorded host-side into a bounded in-process ring buffer.  Off by default
  (``configure(trace=True)`` or ``REPRO_TRACE=1``); when off the hooks are
  no-ops that add no device op and no host read, and results are
  bit-identical either way.
- :mod:`repro_torch.obs.metrics` — process-wide counters / gauges /
  histograms with Prometheus text-format and JSON exporters
  (``repro_torch.api.metrics()``; :func:`start_metrics_server` for a pull
  endpoint).
- :mod:`repro_torch.obs.events` — the event bus every subsystem's audit
  records ride (fault draws, recovery and degradation records) with one
  global ordering and shared request ids, plus the bounded
  :class:`RingLog`.
"""

from repro_torch.obs.events import Event, EventBus, RingLog, get_bus
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    start_metrics_server,
)
from repro_torch.obs.trace import (
    Span,
    Tracer,
    configure,
    format_trace,
    get_tracer,
    span,
    trace_enabled,
    trace_summary,
)

__all__ = [
    "Counter",
    "Event",
    "EventBus",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "RingLog",
    "Span",
    "Tracer",
    "configure",
    "format_trace",
    "get_bus",
    "get_registry",
    "get_tracer",
    "reset",
    "span",
    "start_metrics_server",
    "trace_enabled",
    "trace_summary",
]


def reset() -> None:
    """Clear every global observability sink (tracer ring, metrics registry,
    event bus) — the test isolation hook.  Configuration (trace enabled or
    not, capacities) is kept; only recorded data is dropped."""
    get_tracer().clear()
    get_registry().clear()
    get_bus().clear()
