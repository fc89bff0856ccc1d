"""The event bus and the bounded ring log: an own copy of the JAX
package's ``obs/events.py`` (the port imports nothing of it).

- :class:`RingLog` is a bounded, thread-safe, list-like append log with a
  drop counter.  ``FaultPlan.log`` is one, so a long chaos run cannot grow
  it without limit; iteration, indexing and ``len`` work as on a list, and
  ``dropped`` says how much history aged out.
- :class:`EventBus` is the process-wide ordered stream every subsystem
  emits onto.  Each :class:`Event` carries a global monotonic ``seq`` (one
  ordering across subsystems), a wall-clock and a monotonic timestamp, the
  emitting ``subsystem``, a ``kind``, and the shared correlation ids:
  ``request_ids`` (``Ticket.index`` values) and ``session_id``.  A seeded
  chaos run's fault draws, recovery records and degradation records all
  land here with consistent ids.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any, Iterator

DEFAULT_CAPACITY = 4096


class RingLog:
    """Bounded append-only log: the newest ``capacity`` entries, list-like
    reads, and a counter of how many older entries were dropped."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = capacity
        self._items: deque = deque(maxlen=capacity)
        self._dropped = 0
        self._lock = threading.Lock()

    def append(self, item: Any) -> None:
        with self._lock:
            if len(self._items) == self.capacity:
                self._dropped += 1
            self._items.append(item)

    @property
    def dropped(self) -> int:
        """Entries evicted off the old end since construction."""
        with self._lock:
            return self._dropped

    def list(self) -> list:
        """A consistent snapshot of the retained entries (oldest first)."""
        with self._lock:
            return list(self._items)

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
            self._dropped = 0

    def __iter__(self) -> Iterator:
        return iter(self.list())

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def __getitem__(self, i):
        return self.list()[i]

    def __bool__(self) -> bool:
        return len(self) > 0

    def __eq__(self, other) -> bool:
        """Compare by retained contents — drop-in for code (and tests)
        that held these audit trails as plain lists."""
        if isinstance(other, RingLog):
            return self.list() == other.list()
        if isinstance(other, list):
            return self.list() == other
        return NotImplemented

    def __repr__(self) -> str:
        return (
            f"RingLog(capacity={self.capacity}, len={len(self)}, "
            f"dropped={self.dropped})"
        )


@dataclasses.dataclass(frozen=True)
class Event:
    """One bus record.  ``seq`` is the global order (monotonic across every
    subsystem); ``t`` is ``time.perf_counter()`` (the same clock spans use,
    so events interleave with span timings), ``t_wall`` is epoch seconds."""

    seq: int
    t: float
    t_wall: float
    subsystem: str              # service | sessions | faults | wal | ...
    kind: str                   # fault | recovery | degradation | session ...
    request_ids: tuple[int, ...]
    session_id: str | None
    data: dict

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["request_ids"] = list(self.request_ids)
        return d


class EventBus:
    """Process-wide ordered event stream (bounded ring + drop counter)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._ring = RingLog(capacity)
        self._seq = itertools.count()
        self._lock = threading.Lock()

    def emit(
        self,
        kind: str,
        *,
        subsystem: str,
        request_ids: tuple[int, ...] = (),
        session_id: str | None = None,
        **data: Any,
    ) -> Event:
        with self._lock:
            seq = next(self._seq)
        ev = Event(
            seq=seq, t=time.perf_counter(), t_wall=time.time(),
            subsystem=subsystem, kind=kind,
            request_ids=tuple(int(i) for i in request_ids),
            session_id=session_id, data=data,
        )
        self._ring.append(ev)
        return ev

    def events(
        self,
        kind: str | None = None,
        subsystem: str | None = None,
        *,
        request_id: int | None = None,
        session_id: str | None = None,
    ) -> list[Event]:
        """Retained events in ``seq`` order, optionally filtered."""
        return [
            e for e in self._ring
            if (kind is None or e.kind == kind)
            and (subsystem is None or e.subsystem == subsystem)
            and (request_id is None or request_id in e.request_ids)
            and (session_id is None or e.session_id == session_id)
        ]

    @property
    def dropped(self) -> int:
        return self._ring.dropped

    def export(self) -> list[dict]:
        """JSON-serializable dump of the retained events."""
        return [e.to_dict() for e in self._ring]

    def clear(self) -> None:
        self._ring.clear()


_bus = EventBus()


def get_bus() -> EventBus:
    """The process-wide bus every subsystem emits onto."""
    return _bus
