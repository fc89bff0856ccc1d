"""Process-wide metrics registry: counters, gauges, histograms, exporters.
An own copy of the JAX package's ``obs/metrics.py``: the same metric names
and the same exposition, so one sequence of metric calls renders the same
text and JSON in both packages.

The registry is always on (an observation is a locked dict update, host
side only) and purely an *observer*: nothing in the stack reads a metric
back to make a decision, so exporting can never perturb results.

Naming follows Prometheus conventions: ``repro_<subsystem>_<what>_<unit>``
(``_total`` for counters, ``_seconds`` for time histograms).

Exporters:

- :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
  format (``# HELP`` / ``# TYPE`` + one line per labeled series; histogram
  ``_bucket``/``_sum``/``_count`` series with cumulative ``le`` buckets);
- :meth:`MetricsRegistry.to_json` — the same data as one JSON-serializable
  dict (``repro_torch.api.metrics(fmt="json")``);
- :func:`start_metrics_server` — a stdlib pull endpoint serving
  ``/metrics`` (text format) and ``/metrics.json`` from a daemon thread.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Iterable

#: Default histogram bounds (seconds): 0.1ms .. ~100s, log-spaced — wide
#: enough for WAL fsyncs at the bottom and chunk executions at the top.
DEFAULT_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 100.0,
)


def _label_key(labels: tuple[str, ...], kv: dict) -> tuple[str, ...]:
    missing = set(labels) - set(kv)
    extra = set(kv) - set(labels)
    if missing or extra:
        raise ValueError(
            f"metric labels mismatch: declared {labels}, got {tuple(kv)}"
        )
    return tuple(str(kv[name]) for name in labels)


def _fmt_labels(labels: tuple[str, ...], values: tuple[str, ...],
                extra: str = "") -> str:
    parts = [f'{n}="{v}"' for n, v in zip(labels, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, labels: tuple[str, ...]):
        self.name = name
        self.help = help_
        self.labels = tuple(labels)
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonically increasing per-label-set totals."""

    kind = "counter"

    def __init__(self, name: str, help_: str, labels: tuple[str, ...] = ()):
        super().__init__(name, help_, labels)
        self._values: dict[tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up; got {amount}")
        key = _label_key(self.labels, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._values.get(_label_key(self.labels, labels), 0.0)

    def snapshot(self) -> dict[tuple[str, ...], float]:
        with self._lock:
            return dict(self._values)


class Gauge(_Metric):
    """A value that goes up and down (queue depth, occupancy)."""

    kind = "gauge"

    def __init__(self, name: str, help_: str, labels: tuple[str, ...] = ()):
        super().__init__(name, help_, labels)
        self._values: dict[tuple[str, ...], float] = {}

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._values[_label_key(self.labels, labels)] = float(value)

    def add(self, amount: float, **labels: Any) -> None:
        key = _label_key(self.labels, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._values.get(_label_key(self.labels, labels), 0.0)

    def snapshot(self) -> dict[tuple[str, ...], float]:
        with self._lock:
            return dict(self._values)


class Histogram(_Metric):
    """Fixed-bound histogram (Prometheus semantics: cumulative ``le``
    buckets plus ``_sum``/``_count``)."""

    kind = "histogram"

    def __init__(self, name: str, help_: str, labels: tuple[str, ...] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_, labels)
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        self._totals: dict[tuple[str, ...], int] = {}

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(self.labels, labels)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * len(self.bounds)
            for i, bound in enumerate(self.bounds):
                if value <= bound:
                    counts[i] += 1
                    break
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def stats(self, **labels: Any) -> dict:
        """``{count, sum, mean}`` for one label set."""
        key = _label_key(self.labels, labels)
        with self._lock:
            count = self._totals.get(key, 0)
            total = self._sums.get(key, 0.0)
        return {
            "count": count, "sum": total,
            "mean": total / count if count else 0.0,
        }

    def snapshot(self) -> dict[tuple[str, ...], dict]:
        with self._lock:
            return {
                key: {
                    "buckets": list(self._counts[key]),
                    "sum": self._sums[key],
                    "count": self._totals[key],
                }
                for key in self._counts
            }


class MetricsRegistry:
    """Create-or-get metric factory + the export surface."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help_: str, labels: tuple[str, ...],
             **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help_, labels, **kw)
                return m
        if not isinstance(m, cls) or m.labels != tuple(labels):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} with "
                f"labels {m.labels}"
            )
        return m

    def counter(self, name: str, help_: str = "",
                labels: tuple[str, ...] = ()) -> Counter:
        return self._get(Counter, name, help_, labels)

    def gauge(self, name: str, help_: str = "",
              labels: tuple[str, ...] = ()) -> Gauge:
        return self._get(Gauge, name, help_, labels)

    def histogram(self, name: str, help_: str = "",
                  labels: tuple[str, ...] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_, labels, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def clear(self) -> None:
        """Drop every registered metric (test/bench isolation hook)."""
        with self._lock:
            self._metrics.clear()

    # -- exporters ---------------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: list[str] = []
        for m in metrics:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, (Counter, Gauge)):
                snap = m.snapshot()
                if not snap and not m.labels:
                    snap = {(): 0.0}
                for key, v in sorted(snap.items()):
                    lines.append(
                        f"{m.name}{_fmt_labels(m.labels, key)} {v:g}"
                    )
            elif isinstance(m, Histogram):
                for key, s in sorted(m.snapshot().items()):
                    cum = 0
                    for bound, c in zip(m.bounds, s["buckets"]):
                        cum += c
                        le = 'le="%g"' % bound
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_fmt_labels(m.labels, key, le)} {cum}"
                        )
                    inf = 'le="+Inf"'
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels(m.labels, key, inf)} {s['count']}"
                    )
                    lines.append(
                        f"{m.name}_sum{_fmt_labels(m.labels, key)}"
                        f" {s['sum']:g}"
                    )
                    lines.append(
                        f"{m.name}_count{_fmt_labels(m.labels, key)}"
                        f" {s['count']}"
                    )
        return "\n".join(lines) + "\n"

    def to_json(self) -> dict:
        """Everything in one JSON-serializable dict keyed by metric name;
        per-metric: kind, help, labels, and a series list."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        out: dict[str, Any] = {}
        for m in metrics:
            series = []
            if isinstance(m, (Counter, Gauge)):
                for key, v in sorted(m.snapshot().items()):
                    series.append(
                        {"labels": dict(zip(m.labels, key)), "value": v}
                    )
            elif isinstance(m, Histogram):
                for key, s in sorted(m.snapshot().items()):
                    series.append({
                        "labels": dict(zip(m.labels, key)),
                        "count": s["count"], "sum": s["sum"],
                        "bounds": list(m.bounds),
                        "buckets": s["buckets"],
                    })
            out[m.name] = {
                "kind": m.kind, "help": m.help,
                "labels": list(m.labels), "series": series,
            }
        return out


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem records into."""
    return _registry


def start_metrics_server(port: int = 0, host: str = "127.0.0.1"):
    """A minimal pull endpoint: ``GET /metrics`` serves the Prometheus
    text format, ``GET /metrics.json`` the JSON dump.  Returns the
    ``http.server`` instance (``server.server_address[1]`` is the bound
    port — pass ``port=0`` for an ephemeral one); it runs in a daemon
    thread until ``server.shutdown()``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server API
            if self.path.startswith("/metrics.json"):
                body = json.dumps(_registry.to_json()).encode()
                ctype = "application/json"
            elif self.path.startswith("/metrics"):
                body = _registry.to_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # silence per-request stderr noise
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(
        target=server.serve_forever, name="repro-metrics", daemon=True
    )
    thread.start()
    return server
