"""Write-ahead-log record framing for the durable session tier: an own copy
of the JAX package's ``serve/wal.py`` (the port imports nothing of it), with
the same bytes on disk, so each package's :func:`scan_wal` reads the other's
files.  It touches no tensor.

One WAL file per session (``repro_torch.serve.sessions``), append-only.
Every record is::

    header (21 bytes, little-endian)          payload (plen bytes)
    ┌────────┬──────┬─────────┬────────┬──────────┐
    │ magic  │ type │ seq u64 │ plen   │ crc32    │ payload...
    │ u32    │ u8   │         │ u32    │ u32      │
    └────────┴──────┴─────────┴────────┴──────────┘

``crc32`` covers (type, seq, payload), so a flipped bit anywhere in a
record — header fields included, since a corrupted type/seq changes the
digest input and a corrupted plen misframes the payload — fails the check.

Durability contract (docs/streaming.md):

- A record is the unit of durability: :meth:`WalWriter.append` returns only
  after the bytes reached the OS (``flush``), optionally the device
  (``fsync=True``) — the caller acknowledges the mutation only then.
- Reads **fail loudly**: a checksum or framing violation raises
  :class:`WALCorrupt`; valid records after a corrupt one are *never*
  silently dropped (acknowledged data would vanish).  The only narrower
  failure is a **torn tail** — end-of-file in the middle of the final
  record, exactly what a crash mid-``write`` leaves behind.  That raises
  the :class:`WALTruncated` subclass, and :func:`scan_wal` can be told to
  accept it (``tolerate_torn_tail=True``): the partial trailing record was
  by definition never acknowledged, so dropping *it alone* loses nothing.
- A caller that tolerates a torn tail **must truncate the file to**
  :attr:`WalScan.valid_end` **before appending again**: :class:`WalWriter`
  opens in append mode, so a record written after leftover partial bytes
  would misframe every later read at the torn offset
  (``repro_torch.serve.sessions`` does this during recovery).
"""

from __future__ import annotations

import dataclasses
import os
import struct
import time
import zlib

from repro_torch import obs

_MAGIC = 0x314C4157                    # "WAL1", little-endian
_HEADER = struct.Struct("<IBQII")      # magic, type, seq, plen, crc32

#: Record types.
OPEN = 0      # session creation: JSON meta payload (config signature, key)
APPEND = 1    # one stream element: float32 feature-row bytes

_MAX_PLEN = 64 * 1024 * 1024           # framing sanity bound (64 MiB)


class WALCorrupt(RuntimeError):
    """A WAL record failed its checksum or framing — recovery must stop
    and surface the damage instead of replaying a silently-edited
    history."""


class WALTruncated(WALCorrupt):
    """End-of-file in the middle of the *final* record — the torn tail a
    crash mid-write leaves.  Recoverable by explicit opt-in only
    (``scan_wal(..., tolerate_torn_tail=True)``)."""


@dataclasses.dataclass(frozen=True)
class WalRecord:
    rtype: int
    seq: int
    payload: bytes


@dataclasses.dataclass(frozen=True)
class WalScan:
    """The result of :func:`scan_wal`: every verified record plus where the
    verified prefix ends on disk.  ``torn_bytes > 0`` means a torn tail was
    tolerated — the file still holds that many partial-record bytes past
    ``valid_end``, and the caller must truncate to ``valid_end`` before any
    further append."""

    records: list[WalRecord]
    valid_end: int      # byte offset of the end of the verified prefix
    torn_bytes: int     # partial-record bytes dropped past valid_end


def _crc(rtype: int, seq: int, payload: bytes) -> int:
    head = struct.pack("<BQ", rtype, seq)
    return zlib.crc32(payload, zlib.crc32(head)) & 0xFFFFFFFF


class WalWriter:
    """Append-only writer; one instance owns one session's WAL file."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._f = open(path, "ab")

    def append(self, rtype: int, seq: int, payload: bytes) -> None:
        """Write one record durably (flushed; fsync'd when configured).
        Returns only when the record is on its way to disk — the caller's
        acknowledgement point."""
        crc = _crc(rtype, seq, payload)
        t0 = time.perf_counter()
        self._f.write(_HEADER.pack(_MAGIC, rtype, seq, len(payload), crc))
        self._f.write(payload)
        self._f.flush()
        if self.fsync:
            t_sync = time.perf_counter()
            os.fsync(self._f.fileno())
            obs.get_registry().histogram(
                "repro_wal_fsync_seconds", "WAL fsync latency per append",
            ).observe(time.perf_counter() - t_sync)
        obs.get_registry().histogram(
            "repro_wal_append_seconds",
            "WAL append latency (write + flush + optional fsync)",
        ).observe(time.perf_counter() - t0)

    def tell(self) -> int:
        return self._f.tell()

    def close(self) -> None:
        self._f.close()


def scan_wal(path: str, tolerate_torn_tail: bool = False) -> WalScan:
    """Read and verify every record of a WAL file.

    Raises :class:`WALCorrupt` on any checksum/framing violation with data
    after it, and :class:`WALTruncated` on a torn final record — unless
    ``tolerate_torn_tail`` accepts the (never-acknowledged) partial tail,
    in which case the complete prefix is returned with
    :attr:`WalScan.torn_bytes` counting the dropped partial bytes (the
    caller must truncate the file to :attr:`WalScan.valid_end` before it
    appends again)."""
    records: list[WalRecord] = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    size = len(data)
    while off < size:
        if size - off < _HEADER.size:
            if tolerate_torn_tail:
                return WalScan(records, valid_end=off, torn_bytes=size - off)
            raise WALTruncated(
                f"{path}: torn tail — {size - off} trailing bytes are a "
                f"partial record header at offset {off} (crash mid-write); "
                "pass tolerate_torn_tail=True to accept losing the "
                "unacknowledged final record"
            )
        magic, rtype, seq, plen, crc = _HEADER.unpack_from(data, off)
        if magic != _MAGIC or plen > _MAX_PLEN:
            raise WALCorrupt(
                f"{path}: bad record framing at offset {off} "
                f"(magic={magic:#x}, plen={plen}) — refusing to skip; "
                "records after this point would be silently lost"
            )
        body_off = off + _HEADER.size
        if body_off + plen > size:
            if tolerate_torn_tail:
                return WalScan(records, valid_end=off, torn_bytes=size - off)
            raise WALTruncated(
                f"{path}: torn tail — record seq={seq} at offset {off} "
                f"declares {plen} payload bytes but only "
                f"{size - body_off} remain (crash mid-write); pass "
                "tolerate_torn_tail=True to accept losing the "
                "unacknowledged final record"
            )
        payload = data[body_off: body_off + plen]
        if _crc(rtype, seq, payload) != crc:
            raise WALCorrupt(
                f"{path}: checksum mismatch on record seq={seq} at offset "
                f"{off} — the log is damaged; refusing to silently drop it "
                "or anything after it"
            )
        records.append(WalRecord(rtype=rtype, seq=seq, payload=payload))
        off = body_off + plen
    return WalScan(records, valid_end=off, torn_bytes=0)
