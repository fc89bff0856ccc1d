"""Durable multi-session streaming: the crash-safe sieve × SS ingestion tier,
the counterpart of ``repro/serve/sessions.py``, on the card.

Each session owns a row-streaming sieve
(:class:`repro_torch.core.sieve.StreamSieveState`: the threshold-set
algorithm, constant memory a row) that decides online which elements
matter.  Accepted elements' raw feature rows land in a bounded retained
buffer; when it has taken ``resparsify_every`` inserts (or is full), SS
(:func:`repro_torch.core.sparsify.ss_sparsify_batched`) prunes it back:
the paper's pruning as periodic compaction of a stream's memory.
:meth:`SessionEngine.summary` runs greedy over the pruned buffer.

Waves: appends from many sessions run as waves, one pending element per
session per wave, sessions chunked at ``max_batch``.  The reference stacks
the chunk with ``jax.vmap`` and pads it to a ``batch_buckets`` size; here a
wave maps the single-row update (:func:`stream_sieve_update` and the buffer
insert) over the chunk's sessions, one session at a time, so a session's
bits cannot depend on the others in its wave or on the padding, which is
not computed (``stats()`` counts the bucket and its pad as the reference
does).  That is the batching contract crash recovery leans on: a B = 1
replay reproduces a B = 8 wave bit for bit.  The insert is the reference's
``where(ins, row, buf[pos])`` at ``pos = min(buf_len, cap - 1)``, made on
the device with no host read.  A wave uploads its rows in one copy and
reads nothing back; each due check before and after it reads the chunk's
``buf_len``, ``inserts``, ``n_ss`` and keys in one transfer
(:meth:`SessionEngine._scalars`).

Randomness: the reference keeps a threefry key per session and folds the
compaction count ``n_ss`` into it at every SS compaction.  The port cannot
rebuild that stream.  The ``key`` leaf holds the same two uint32 words as
``jax.random.PRNGKey(key)`` (64-bit types off, the JAX package's default),
so snapshots and OPEN records carry the same numbers, and every compaction
builds a fresh generator per row seeded with ``fold_in(seed, n_ss)``
(:func:`repro_torch.serve.summarize_service.fold_in`, splitmix64; ``seed``
the two words as one integer) in :func:`_ss_draws`.  No generator outlives
its compaction, so a replay draws the same numbers.  The draws differ from
the JAX package's, so the config signature names them (``"draws"``): each
package refuses to replay the other's root, whose compactions drew other
numbers.  The WAL framing is byte-compatible (:mod:`repro_torch.serve.wal`).

Durability contract (docs/streaming.md), as in the reference:

- **WAL first.**  Every ``append`` writes an APPEND record (seq, raw
  float32 row, crc32) before it acknowledges; ``open_session`` writes an
  OPEN record with the key words and the config signature.
- **Snapshots.**  After ``snapshot_every`` applied appends, on demand or at
  close, the full :class:`SessionState` is written to an atomic
  ``snap-<applied_seq>.npz`` (tmp + ``os.replace``; the two newest kept),
  with the reference's array names and dtypes.
- **Recovery = snapshot + WAL tail**, replayed through the same wave code;
  a recovered session is bit-identical to one that never crashed.  A
  snapshot that fails to *read* falls back to its predecessor (a
  ``snapshot_fallback`` event); only reading and parsing the file on the
  host is caught, never a device error.
- **Fail loudly.**  A checksum or framing violation raises
  :class:`repro_torch.serve.wal.WALCorrupt`; only a torn tail, by opt-in
  (``SessionConfig.tolerate_torn_tail``), is dropped, and recovery
  truncates it (a ``wal_truncate`` event) before the writer reopens.

Memory pressure: past ``max_live_sessions`` hydrated sessions the least
recently used idle one is snapshotted and released (``evict``), and
rehydrated on its next touch (``rehydrate``).  Chaos hook: a
:class:`repro_torch.serve.faults.FaultPlan` via ``faults=``; ``exec_error``
aborts a wave or compaction before any state changes, ``crash`` kills the
engine (every later call raises :class:`ServiceRestarted`), ``restart``
drops the in-memory state (sessions rehydrate from disk).  A volatile
engine (``root=None``) refuses plans with ``crash`` or ``restart``.

Device: the engine runs on ``device`` (the card by default; a host without
one raises).  ``SessionConfig.backend`` None resolves by that device:
``cuda`` (the kernels) on the card, ``reference`` on the CPU.  A
:class:`~repro_torch.kernels.KernelError` or a CUDA error propagates from
every path of the engine.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from collections import deque
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.backend import resolve_backend
from repro_torch.core.functions import FeatureCoverage
from repro_torch.core.greedy import greedy
from repro_torch.core.sieve import (
    STREAM_PHIS,
    StreamSieveState,
    stream_sieve_init,
    stream_sieve_update,
)
from repro_torch.core.sparsify import max_rounds, ss_sparsify_batched
from repro_torch.device import resolve_device
from repro_torch.serve import wal as _wal
from repro_torch.serve.faults import FaultInjected, FaultPlan
from repro_torch.serve.summarize_service import ServiceRestarted, batch_buckets, fold_in

Tensor = torch.Tensor

#: Snapshot / WAL-OPEN payload schema version.
SCHEMA_VERSION = 1

_SID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

#: SessionConfig fields that determine the state trajectory: two engines
#: agreeing on these replay a WAL to bit-identical states.  (``backend`` is
#: excluded: an execution strategy, held to the plain route by the tests.)
_SIG_FIELDS = (
    "k", "eps", "n_features", "phi", "buffer_cap",
    "resparsify_every", "ss_r", "ss_c",
)

#: The compactions' draw scheme, part of the signature: a root whose
#: compactions drew other numbers (the JAX package's threefry keys) replays
#: to another state, so it is refused.
DRAWS = "torch-splitmix64"


# ------------------------------------------------------------- config -------

@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Engine-wide configuration (one config governs every session).

    ``k``/``eps`` parameterize the per-session sieve (geometric threshold
    grid); ``buffer_cap``/``resparsify_every``/``ss_r``/``ss_c`` govern the
    retained buffer and its periodic SS compaction; ``max_batch``/
    ``batch_c`` shape the wave buckets (same convention as ``RunConfig``);
    ``snapshot_every``/``wal_fsync``/``tolerate_torn_tail`` set the
    durability policy and ``max_live_sessions`` arms the eviction ladder
    (both need a durable ``root``).  ``backend`` None follows the engine's
    device."""

    k: int = 8
    eps: float = 0.2
    n_features: int = 64
    phi: str = "sqrt"
    buffer_cap: int = 128
    resparsify_every: int = 32
    ss_r: int = 4
    ss_c: float = 8.0
    backend: Any = None
    max_batch: int = 8
    batch_c: float = 4.0
    flush_every: int | None = None      # pending appends per auto-flush
    snapshot_every: int | None = 64     # applied appends per snapshot
    wal_fsync: bool = False
    tolerate_torn_tail: bool = False
    max_live_sessions: int | None = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1; got {self.k}")
        if self.eps <= 0:
            raise ValueError(f"eps must be positive; got {self.eps}")
        if self.n_features < 1:
            raise ValueError(f"n_features must be >= 1; got {self.n_features}")
        if self.phi not in STREAM_PHIS:
            raise ValueError(
                f"session phi must be one of {STREAM_PHIS}; got {self.phi!r}"
            )
        if self.buffer_cap < self.k:
            raise ValueError(
                f"buffer_cap must be >= k; got {self.buffer_cap} < {self.k}"
            )
        for name in ("resparsify_every", "ss_r", "max_batch"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        for name in ("flush_every", "snapshot_every", "max_live_sessions"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"{name} must be None or >= 1")

    def signature(self) -> str:
        """The trajectory-determining config and the draw scheme,
        canonically serialized: stamped into every OPEN record and
        snapshot, checked at recovery (replaying under another config or
        other draws would silently produce a different, equally plausible
        state)."""
        sig = {f: getattr(self, f) for f in _SIG_FIELDS}
        sig["draws"] = DRAWS
        return json.dumps(sig, sort_keys=True)


# ------------------------------------------------------------- state --------

class SessionState(NamedTuple):
    """Everything one session is, as tensors on the engine's device: what a
    snapshot persists and what recovery must reproduce bit for bit."""

    sieve: StreamSieveState  # thresholds, coverage, counters
    buf: Tensor      # (cap, F) float32 retained raw feature rows
    buf_ids: Tensor  # (cap,) int32 element ids (stream positions); -1 = empty
    buf_len: Tensor  # () int32 occupied slots
    inserts: Tensor  # () int32 buffer inserts since the last SS compaction
    n_ss: Tensor     # () int32 SS compactions so far (folded into the seed)
    drops: Tensor    # () int32 sieve-accepted elements lost to a full buffer
    key: Tensor      # (2,) int64 the uint32 words of jax.random.PRNGKey(key)


def _key_words(key: int) -> list[int]:
    """The two uint32 words ``jax.random.PRNGKey(key)`` holds with 64-bit
    types off (the JAX package's default): ``[0, key mod 2^32]``."""
    return [0, int(key) & 0xFFFFFFFF]


def _fresh_state(cfg: SessionConfig, words, device) -> SessionState:
    def scalar():
        return torch.zeros((), dtype=torch.int32, device=device)

    return SessionState(
        sieve=stream_sieve_init(cfg.k, cfg.n_features, cfg.eps, device=device),
        buf=torch.zeros((cfg.buffer_cap, cfg.n_features), dtype=torch.float32,
                        device=device),
        buf_ids=torch.full((cfg.buffer_cap,), -1, dtype=torch.int32, device=device),
        buf_len=scalar(), inserts=scalar(), n_ss=scalar(), drops=scalar(),
        key=torch.tensor([int(w) for w in words], dtype=torch.int64, device=device),
    )


_STATE_KEYS = (
    "sieve_jidx", "sieve_lg", "sieve_cov", "sieve_vals", "sieve_counts",
    "sieve_sel", "sieve_m", "sieve_t",
    "buf", "buf_ids", "buf_len", "inserts", "n_ss", "drops", "key",
)


def _state_arrays(state: SessionState) -> dict[str, np.ndarray]:
    """The snapshot's arrays: the reference's names and dtypes (``key``
    uint32 (2,))."""
    sv = state.sieve
    vals = (
        sv.jidx, sv.lg, sv.cov, sv.vals, sv.counts, sv.sel, sv.m, sv.t,
        state.buf, state.buf_ids, state.buf_len, state.inserts,
        state.n_ss, state.drops,
    )
    out = {k: v.cpu().numpy() for k, v in zip(_STATE_KEYS, vals)}
    out["key"] = state.key.cpu().numpy().astype(np.uint32)
    return out


def _arrays_state(a: dict[str, np.ndarray], device) -> SessionState:
    """A state on ``device`` from a snapshot's arrays (writable copies)."""
    t = {k: torch.from_numpy(a[k]).to(device) for k in _STATE_KEYS if k != "key"}
    sieve = StreamSieveState(
        jidx=t["sieve_jidx"], lg=t["sieve_lg"], cov=t["sieve_cov"],
        vals=t["sieve_vals"], counts=t["sieve_counts"], sel=t["sieve_sel"],
        m=t["sieve_m"], t=t["sieve_t"],
    )
    return SessionState(
        sieve=sieve, buf=t["buf"], buf_ids=t["buf_ids"], buf_len=t["buf_len"],
        inserts=t["inserts"], n_ss=t["n_ss"], drops=t["drops"],
        key=torch.from_numpy(a["key"].astype(np.int64)).to(device),
    )


# ------------------------------------------------------------- waves --------

def _wave_row(st: SessionState, row: Tensor, phi: str, slots: Tensor) -> SessionState:
    """One session consumes one element: the row sieve, then the buffer
    insert ``where(ins, row, buf[pos])`` at ``pos = min(buf_len, cap - 1)``
    as a masked select over the slots.  Builds new tensors only (the caller
    commits them after the whole wave), reads nothing back."""
    cap = st.buf.shape[0]
    sieve, took = stream_sieve_update(st.sieve, row, phi)
    room = st.buf_len < cap
    ins = took & room
    at = (slots == torch.clamp_max(st.buf_len, cap - 1)) & ins
    return SessionState(
        sieve=sieve,
        buf=torch.where(at[:, None], row[None, :], st.buf),
        buf_ids=torch.where(at, st.sieve.t, st.buf_ids),
        buf_len=st.buf_len + ins.int(),
        inserts=st.inserts + ins.int(),
        n_ss=st.n_ss,
        drops=st.drops + (took & ~room).int(),
        key=st.key,
    )


def _compact(states: list[SessionState], W: Tensor, keep: Tensor,
             slots: Tensor) -> list[SessionState]:
    """Compact each stacked buffer (``W`` (B, cap, F)) to its kept rows in
    slot order; the rest become 0.0 rows with id -1 (the reference's
    ``take(..., mode="fill")``).  Resets the insert counter and bumps
    ``n_ss``.  Gathers only: the rows keep their bits."""
    cnt = keep.sum(dim=1, dtype=torch.int32)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    occ = slots[None, :] < cnt[:, None]
    buf = torch.where(occ[..., None],
                      torch.take_along_dim(W, order[..., None], dim=1), 0.0)
    ids = torch.where(occ, torch.take_along_dim(
        torch.stack([st.buf_ids for st in states]), order, dim=1), -1)
    zero = torch.zeros((), dtype=torch.int32, device=W.device)
    return [st._replace(buf=buf[b], buf_ids=ids[b], buf_len=cnt[b], inserts=zero,
                        n_ss=st.n_ss + 1) for b, st in enumerate(states)]


def _ss_draws(words: list, n_ss: list[int], n: int, rounds: int, device) -> dict:
    """The draws of one SS compaction of B buffers, as keyword arguments of
    :func:`ss_sparsify_batched`: a fresh generator per row on ``device``,
    seeded ``fold_in(seed, n_ss)`` with ``seed`` the row's two key words as
    one integer.  (``n`` and ``rounds`` give the shape, (B, rounds, n), of
    an injected ``noise`` instead.)"""
    return {"generators": [
        torch.Generator(device=device).manual_seed(fold_in((hi << 32) | lo, c))
        for (hi, lo), c in zip(words, n_ss)]}


# ------------------------------------------------------------- summary ------

@dataclasses.dataclass(frozen=True)
class SessionSummary:
    """One session's current summary: greedy over the SS-pruned buffer."""

    sid: str
    selected: np.ndarray    # (<=k,) int32 element ids (stream positions)
    gains: np.ndarray       # (<=k,) float32 greedy marginal gains
    value: float            # f(summary) over the retained buffer
    sieve_value: float      # best online sieve value (the (1/2-eps) bound)
    retained: int           # buffer occupancy after pruning
    seen: int               # elements consumed since open
    drops: int              # accepted elements lost to a full buffer
    resparsifies: int       # SS compactions so far


# ------------------------------------------------------------- engine -------

class SessionEngine:
    """Durable multi-session streaming engine (sieve × SS × WAL) on
    ``device`` (the card by default; a host without one raises).

    ``root=None`` runs volatile (no WAL, no snapshots: state dies with the
    process); pass a directory to get the full durability contract.  One
    subdirectory per session holds ``wal.log`` plus ``snap-*.npz``
    checkpoints.  Construct a new engine on the same root to recover after
    a crash: sessions rehydrate lazily on first touch.

    The engine is a context manager; exit flushes, snapshots every live
    session, and closes the WAL writers."""

    def __init__(
        self,
        config: SessionConfig | None = None,
        root: str | None = None,
        *,
        faults: FaultPlan | None = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.config = config or SessionConfig()
        if not isinstance(self.config, SessionConfig):
            raise TypeError(
                f"SessionEngine takes a SessionConfig; got {type(config)!r}"
            )
        if root is None and self.config.max_live_sessions is not None:
            raise ValueError(
                "max_live_sessions (eviction ladder) requires a durable "
                "root: eviction releases state that must be rehydratable"
            )
        if root is None and faults is not None:
            durable_kinds = sorted(
                {f.kind for f in faults.schedule.values()}
                & {"crash", "restart"}
            )
            if durable_kinds:
                raise ValueError(
                    f"FaultPlan schedules {durable_kinds} faults but the "
                    "engine is volatile (root=None): there is no WAL to "
                    "recover from, so acknowledged appends would be "
                    "silently lost — pass a durable root to inject "
                    "crash/restart"
                )
        self.root = root
        self._sig = self.config.signature()
        self._faults = faults
        self._backend = resolve_backend(self.config.backend, self.device)
        self._buckets = batch_buckets(
            self.config.max_batch, self.config.batch_c
        )
        self._slots = torch.arange(self.config.buffer_cap, device=self.device)
        self._live: dict[str, SessionState] = {}
        self._pending: dict[str, deque] = {}    # sid -> deque[(seq, row)]
        self._writers: dict[str, _wal.WalWriter] = {}
        self._next_seq: dict[str, int] = {}
        self._applied_seq: dict[str, int] = {}
        self._since_snap: dict[str, int] = {}
        self._order: dict[str, int] = {}        # LRU clock per session
        self._clock = 0
        self._n_opened = 0
        self._dead: str | None = None
        self._closed = False
        # Bounded audit log; every entry is mirrored onto the event bus
        # with its session id.
        self.events: obs.RingLog = obs.RingLog()
        self._stats = {
            "appends": 0, "waves": 0, "wave_slots": 0, "padded_slots": 0,
            "resparsifies": 0, "snapshots": 0, "snapshot_fallbacks": 0,
            "rehydrations": 0, "evictions": 0, "restarts": 0, "crashes": 0,
            "wal_truncations": 0,
        }
        self._known: set[str] = set()
        if root is not None:
            os.makedirs(root, exist_ok=True)
            for d in sorted(os.listdir(root)):
                if os.path.isfile(os.path.join(root, d, "wal.log")):
                    self._known.add(d)

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "SessionEngine":
        return self

    def __exit__(self, *exc) -> None:
        if self._dead is None and not self._closed:
            self.close()

    def close(self) -> None:
        """Flush, snapshot every hydrated session, release WAL writers."""
        self._check_alive()
        self._apply_waves(None, faults=False)
        if self.root is not None:
            for sid in sorted(self._live):
                self._snapshot(sid)
        for w in self._writers.values():
            w.close()
        self._writers.clear()
        self._closed = True

    def _check_alive(self) -> None:
        if self._dead is not None:
            raise ServiceRestarted(self._dead)
        if self._closed:
            raise RuntimeError("the session engine is closed")

    def _touch(self, sid: str) -> None:
        self._clock += 1
        self._order[sid] = self._clock

    def _event(self, step: str, *, sid: str | None = None, **data) -> None:
        """Audit one lifecycle event: append to the bounded ``events`` log
        and mirror it onto the event bus keyed by session id."""
        ev = {"step": step}
        if sid is not None:
            ev["sid"] = sid
        ev.update(data)
        self.events.append(ev)
        obs.get_bus().emit(step, subsystem="sessions", session_id=sid, **data)
        obs.get_registry().counter(
            "repro_sessions_events_total", "session audit events by step",
            labels=("step",),
        ).inc(step=step)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- session lifecycle -------------------------------------------------
    def open_session(self, sid: str | None = None, *, key: int = 0) -> str:
        """Create a session; returns its id.  Durable engines write the
        OPEN record (schema, key words, config signature) before returning:
        the session exists once this acks, even across a crash."""
        self._check_alive()
        if sid is None:
            while True:
                sid = f"s{self._n_opened:06d}"
                self._n_opened += 1
                if sid not in self._known and sid not in self._live:
                    break
        if not _SID_RE.match(sid):
            raise ValueError(
                f"session id must match {_SID_RE.pattern}; got {sid!r}"
            )
        if sid in self._known or sid in self._live:
            raise ValueError(f"session {sid!r} already exists")
        words = _key_words(key)
        state = _fresh_state(self.config, words, self.device)
        if self.root is not None:
            os.makedirs(os.path.join(self.root, sid), exist_ok=True)
            meta = {"schema": SCHEMA_VERSION, "sig": self._sig, "key": words}
            self._writer(sid).append(
                _wal.OPEN, 0, json.dumps(meta).encode()
            )
        self._known.add(sid)
        self._live[sid] = state
        self._pending[sid] = deque()
        self._next_seq[sid] = 1
        self._applied_seq[sid] = 0
        self._since_snap[sid] = 0
        self._touch(sid)
        self._enforce_memory()
        return sid

    def sessions(self) -> list[str]:
        """Every known session id (hydrated or on disk)."""
        return sorted(self._known)

    # -- ingestion ---------------------------------------------------------
    def append(self, sid: str, row) -> int:
        """Ingest one element into ``sid``; returns its WAL sequence number.

        ``row`` is an (F,) array-like on the host; it is copied and checked
        there (admission).  Durable engines acknowledge only
        after the APPEND record is in the OS page cache (``wal_fsync=True``
        for the device): from then on the element survives any crash.
        Application to the sieve is deferred to the next wave (``flush``);
        appends auto-flush once ``flush_every`` (default ``max_batch``)
        elements are pending."""
        self._check_alive()
        if sid not in self._known:
            raise KeyError(f"unknown session {sid!r}")
        row = np.array(row, np.float32)        # a copy the caller cannot change
        if row.shape != (self.config.n_features,):
            raise ValueError(
                f"row must have shape ({self.config.n_features},); "
                f"got {row.shape}"
            )
        if not np.all(np.isfinite(row)) or np.any(row < 0):
            raise ValueError(
                "rows must be finite and nonnegative (coverage objectives); "
                "rejected at admission"
            )
        self._hydrate(sid)
        seq = self._next_seq[sid]
        if self.root is not None:
            self._writer(sid).append(_wal.APPEND, seq, row.tobytes())
        self._pending[sid].append((seq, row))
        self._next_seq[sid] = seq + 1
        self._stats["appends"] += 1
        self._touch(sid)
        threshold = self.config.flush_every or self.config.max_batch
        if sum(len(q) for q in self._pending.values()) >= threshold:
            self.flush()
        return seq

    def flush(self) -> None:
        """Apply every pending element (waves), run due SS compactions,
        take due snapshots, then enforce the memory ladder."""
        self._check_alive()
        self._apply_waves(None, faults=True)
        cfg = self.config
        if self.root is not None and cfg.snapshot_every is not None:
            for sid in sorted(self._live):
                if self._since_snap.get(sid, 0) >= cfg.snapshot_every:
                    self._snapshot(sid)
        self._enforce_memory()

    # -- wave execution ----------------------------------------------------
    def _apply_waves(self, only, *, faults: bool) -> None:
        """Drain pending elements: one element per session per wave,
        sessions chunked to ``max_batch``.

        Invariant: a session that is due for SS compaction is compacted
        before its next element applies (checked before and after every
        wave).  That pins the compaction points to the state trajectory
        itself: a wave aborted by an injected fault and retried later
        still compacts at the same element count, which is what makes WAL
        replay (``faults=False``) land bit-identical."""
        cfg = self.config
        while True:
            sids = [
                s for s in sorted(self._pending)
                if self._pending[s] and (only is None or s in only)
            ]
            if not sids:
                return
            restarted = False
            for i in range(0, len(sids), cfg.max_batch):
                chunk = sids[i:i + cfg.max_batch]
                for s in chunk:
                    self._hydrate(s)
                if (
                    self._maybe_resparsify(chunk, faults) == "restarted"
                    or self._exec_wave(chunk, faults) == "restarted"
                    or self._maybe_resparsify(chunk, faults) == "restarted"
                ):
                    restarted = True
                    break
            if restarted:
                continue

    def _draw_fault(self, chunk: list[str], stage: str, faults: bool):
        """Draw (and handle the terminal kinds of) one scheduled fault.
        Returns "restarted" when a restart consumed this attempt, the
        fault for the caller to apply, or None for a clean attempt."""
        if not faults or self._faults is None:
            return None
        fault = self._faults.draw(
            tickets=(), lane=("sessions", tuple(chunk)),
            backend=self._backend.name, stage=stage,
        )
        if fault is None:
            return None
        if fault.kind in ("latency", "hang"):
            time.sleep(fault.delay_s)
            return None
        if fault.kind == "crash":
            self._die()                      # raises ServiceRestarted
        if fault.kind == "restart":
            self._restart()
            return "restarted"
        raise FaultInjected(
            f"injected {fault.kind} on session {stage} {tuple(chunk)}"
        )

    def _upload(self, rows: np.ndarray) -> Tensor:
        """The wave's rows on the device in one host-to-device copy (from
        pinned memory on the card, so the copy does not wait)."""
        t = torch.from_numpy(rows)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _exec_wave(self, chunk: list[str], faults: bool):
        if self._draw_fault(chunk, "wave", faults) == "restarted":
            return "restarted"
        cfg = self.config
        B = len(chunk)
        bucket = min(b for b in self._buckets if b >= B)
        pad = bucket - B
        t0 = time.perf_counter()
        rows = self._upload(np.stack([self._pending[s][0][1] for s in chunk]))
        new = [_wave_row(self._live[s], rows[j], cfg.phi, self._slots)
               for j, s in enumerate(chunk)]
        tr = obs.get_tracer()
        if tr.enabled:
            # Host-side timing around the wave only; the synchronise is
            # opt-in with tracing (the default path reads nothing back).
            self._sync()
            t1 = time.perf_counter()
            tr.record("sessions.wave", t0, t1, B=B, bucket=bucket, pad=pad)
            obs.get_registry().histogram(
                "repro_sessions_wave_seconds", "sieve wave execution wall",
            ).observe(t1 - t0)
        # the point of no failure: commit the whole wave
        for s, st in zip(chunk, new):
            self._live[s] = st
            seq, _ = self._pending[s].popleft()
            self._applied_seq[s] = seq
            self._since_snap[s] = self._since_snap.get(s, 0) + 1
        self._stats["waves"] += 1
        self._stats["wave_slots"] += bucket
        self._stats["padded_slots"] += pad
        return None

    def _scalars(self, chunk: list[str]) -> list[list[int]]:
        """The chunk's ``[buf_len, inserts, n_ss, key hi, key lo]`` per
        session, in one transfer (the reference reads two or three scalars
        a session)."""
        sts = [self._live[s] for s in chunk]
        ints = torch.stack([x for st in sts for x in (st.buf_len, st.inserts, st.n_ss)])
        keys = torch.stack([st.key for st in sts])
        return torch.cat([ints.view(len(sts), 3).long(), keys], dim=1).tolist()

    def _maybe_resparsify(self, chunk: list[str], faults: bool):
        """SS-compact the chunk's due sessions (buffer non-empty and
        ``resparsify_every`` inserts taken, or full) as one batch: the
        chunk holds at most ``max_batch`` sessions."""
        cfg = self.config
        host = dict(zip(chunk, self._scalars(chunk)))
        grp = [s for s in chunk if host[s][0] > 0 and (
            host[s][1] >= cfg.resparsify_every or host[s][0] >= cfg.buffer_cap)]
        if not grp:
            return None
        if self._draw_fault(grp, "resparsify", faults) == "restarted":
            return "restarted"
        t0 = time.perf_counter()
        states = [self._live[s] for s in grp]
        W = torch.stack([st.buf for st in states])
        alive = self._slots[None, :] < torch.stack([st.buf_len for st in states])[:, None]
        draws = _ss_draws([host[s][3:] for s in grp], [host[s][2] for s in grp],
                          cfg.buffer_cap, max_rounds(cfg.buffer_cap, cfg.ss_r, cfg.ss_c),
                          self.device)
        ss = ss_sparsify_batched(FeatureCoverage(W=W, phi=cfg.phi), r=cfg.ss_r,
                                 c=cfg.ss_c, alive=alive, backend=self._backend,
                                 **draws)
        new = _compact(states, W, ss.vprime & alive, self._slots)
        tr = obs.get_tracer()
        if tr.enabled:
            self._sync()
            tr.record("sessions.resparsify", t0, time.perf_counter(),
                      B=len(grp), sessions=tuple(grp))
        for s, st in zip(grp, new):
            self._live[s] = st
        self._stats["resparsifies"] += len(grp)
        return None

    # -- faults ------------------------------------------------------------
    def _drop_memory(self) -> None:
        for w in self._writers.values():
            w.close()
        self._writers.clear()
        self._live.clear()
        self._pending.clear()
        self._next_seq.clear()
        self._applied_seq.clear()
        self._since_snap.clear()

    def _die(self) -> None:
        msg = (
            "the session engine crashed (injected crash fault); all "
            "in-memory state is gone — construct a new SessionEngine on "
            "the same root to recover from snapshot + WAL"
        )
        self._drop_memory()
        self._stats["crashes"] += 1
        self._event("crash", reason="fault")
        self._dead = msg
        raise ServiceRestarted(msg)

    def _restart(self) -> None:
        """Kill + reopen in place: in-memory state dropped, sessions
        rehydrate lazily from snapshot + WAL on next touch.  Pending
        elements were WAL-acknowledged, so none are lost: they replay
        during rehydration.  (Only reachable on durable engines.)"""
        self._drop_memory()
        self._stats["restarts"] += 1
        self._event("restart", reason="fault", sessions=sorted(self._known))

    # -- durability --------------------------------------------------------
    def _writer(self, sid: str) -> _wal.WalWriter:
        w = self._writers.get(sid)
        if w is None:
            w = _wal.WalWriter(
                os.path.join(self.root, sid, "wal.log"),
                fsync=self.config.wal_fsync,
            )
            self._writers[sid] = w
        return w

    def _snapshot(self, sid: str) -> str:
        """Atomically checkpoint ``sid``'s full state (applied elements
        only: call after waves drained).  Keeps the two newest snapshots
        so a corrupt latest still recovers from its predecessor."""
        sdir = os.path.join(self.root, sid)
        seq = self._applied_seq[sid]
        meta = {
            "schema": SCHEMA_VERSION, "sig": self._sig, "applied_seq": seq,
        }
        final = os.path.join(sdir, f"snap-{seq:012d}.npz")
        tmp = final + ".tmp"
        t0 = time.perf_counter()
        arrays = _state_arrays(self._live[sid])
        with open(tmp, "wb") as f:
            np.savez(
                f,
                _meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                **arrays,
            )
        os.replace(tmp, final)
        t1 = time.perf_counter()
        obs.get_registry().histogram(
            "repro_sessions_snapshot_seconds",
            "atomic state-checkpoint wall (write + rename)",
        ).observe(t1 - t0)
        tr = obs.get_tracer()
        if tr.enabled:
            tr.record("sessions.snapshot", t0, t1, session=sid, seq=seq)
        self._since_snap[sid] = 0
        self._stats["snapshots"] += 1
        for name in sorted(self._snapshot_names(sid), reverse=True)[2:]:
            os.unlink(os.path.join(sdir, name))
        return final

    def snapshot(self, sid: str) -> str:
        """Flush ``sid`` and checkpoint it now; returns the snapshot path."""
        self._check_alive()
        if self.root is None:
            raise RuntimeError("snapshots require a durable root")
        self._hydrate(sid)
        self._apply_waves({sid}, faults=True)
        return self._snapshot(sid)

    def _snapshot_names(self, sid: str) -> list[str]:
        sdir = os.path.join(self.root, sid)
        return [
            n for n in os.listdir(sdir)
            if n.startswith("snap-") and n.endswith(".npz")
        ]

    def _load_snapshot(self, sid: str):
        """Newest loadable snapshot, or (None, 0).  A snapshot that fails
        to read on the host (bit rot, a truncated copy) falls back to its
        predecessor, loudly, via a ``snapshot_fallback`` event, at the
        price of a longer WAL replay; only reading and parsing the file is
        caught, and the arrays reach the device outside it, so a device
        error propagates.  A snapshot written under a different config (or
        draw scheme) raises: replaying on top of it would fabricate a
        plausible wrong state."""
        sdir = os.path.join(self.root, sid)
        for name in sorted(self._snapshot_names(sid), reverse=True):
            path = os.path.join(sdir, name)
            try:
                with np.load(path) as z:
                    meta = json.loads(bytes(z["_meta"]).decode())
                    arrays = {k: np.array(z[k]) for k in _STATE_KEYS}
            except Exception as e:  # noqa: BLE001 - corrupt file: fall back
                self._stats["snapshot_fallbacks"] += 1
                self._event(
                    "snapshot_fallback", sid=sid, snapshot=name,
                    error=repr(e),
                )
                continue
            if meta.get("schema") != SCHEMA_VERSION:
                raise ValueError(
                    f"{path}: snapshot schema {meta.get('schema')} != "
                    f"{SCHEMA_VERSION}"
                )
            if meta.get("sig") != self._sig:
                raise ValueError(
                    f"{path}: snapshot was written under a different "
                    "SessionConfig; refusing to replay on top of it"
                )
            return _arrays_state(arrays, self.device), int(meta["applied_seq"])
        return None, 0

    def _hydrate(self, sid: str) -> SessionState:
        """The lazy-rehydration rung of the memory ladder: return the live
        state, recovering it from snapshot + WAL tail if it was evicted,
        restarted away, or belongs to a previous process."""
        self._touch(sid)
        st = self._live.get(sid)
        if st is not None:
            return st
        if sid not in self._known:
            raise KeyError(f"unknown session {sid!r}")
        if self.root is None:
            raise RuntimeError(
                f"session {sid!r} was lost (volatile engine restarted; "
                "pass a durable root to survive restarts)"
            )
        replayed = self._recover(sid)
        self._stats["rehydrations"] += 1
        self._event("rehydrate", sid=sid, reason="access", replayed=replayed)
        return self._live[sid]

    def _recover(self, sid: str) -> int:
        """Recovery = newest loadable snapshot + WAL-tail replay through
        the same wave code (B = 1, faults off).  Verifies the OPEN record,
        the config signature, and strict seq contiguity: a gap means
        acknowledged records vanished, which must never be papered over."""
        t0 = time.perf_counter()
        with obs.span("sessions.recover", session=sid) as sp:
            replayed = self._recover_inner(sid)
            sp.set(replayed=replayed)
        obs.get_registry().histogram(
            "repro_sessions_recover_seconds",
            "snapshot-load + WAL-tail-replay wall per rehydration",
        ).observe(time.perf_counter() - t0)
        return replayed

    def _recover_inner(self, sid: str) -> int:
        cfg = self.config
        wal_path = os.path.join(self.root, sid, "wal.log")
        scan = _wal.scan_wal(
            wal_path, tolerate_torn_tail=cfg.tolerate_torn_tail
        )
        records = scan.records
        if scan.torn_bytes:
            # Physically remove the tolerated torn tail.  The writer opens
            # in append mode, so leaving the partial bytes would put the
            # next acknowledged record after garbage and every later scan
            # would misframe at this offset.
            w = self._writers.pop(sid, None)
            if w is not None:
                w.close()
            with open(wal_path, "r+b") as f:
                f.truncate(scan.valid_end)
            self._stats["wal_truncations"] += 1
            self._event(
                "wal_truncate", sid=sid, valid_end=scan.valid_end,
                dropped_bytes=scan.torn_bytes,
            )
        if not records or records[0].rtype != _wal.OPEN:
            raise _wal.WALCorrupt(
                f"{wal_path}: missing OPEN record at sequence 0"
            )
        meta = json.loads(records[0].payload.decode())
        if meta.get("schema") != SCHEMA_VERSION:
            raise ValueError(
                f"{wal_path}: WAL schema {meta.get('schema')} != "
                f"{SCHEMA_VERSION}"
            )
        if meta.get("sig") != self._sig:
            raise ValueError(
                f"{wal_path}: session was written under a different "
                "SessionConfig; replaying it here would silently produce "
                "a different state"
            )
        for i, rec in enumerate(records):
            if rec.seq != i or (i > 0 and rec.rtype != _wal.APPEND):
                raise _wal.WALCorrupt(
                    f"{wal_path}: sequence gap or bad record type at "
                    f"position {i} (seq={rec.seq}, type={rec.rtype}) — "
                    "acknowledged records are missing"
                )
        state, snap_seq = self._load_snapshot(sid)
        if state is None:
            state = _fresh_state(cfg, meta["key"], self.device)
            snap_seq = 0
        self._live[sid] = state
        self._applied_seq[sid] = snap_seq
        self._next_seq[sid] = records[-1].seq + 1
        pend = self._pending.setdefault(sid, deque())
        pend.clear()
        n_bytes = 4 * cfg.n_features
        for rec in records[1:]:
            if rec.seq <= snap_seq:
                continue
            if len(rec.payload) != n_bytes:
                raise _wal.WALCorrupt(
                    f"{wal_path}: APPEND seq={rec.seq} payload is "
                    f"{len(rec.payload)} bytes, expected {n_bytes}"
                )
            pend.append((rec.seq, np.frombuffer(rec.payload, np.float32).copy()))
        replayed = len(pend)
        self._apply_waves({sid}, faults=False)
        self._since_snap[sid] = replayed
        return replayed

    # -- memory ladder -----------------------------------------------------
    def _enforce_memory(self) -> None:
        """Eviction rung: past ``max_live_sessions``, snapshot + release
        the least-recently-used idle session (pending elements pin a
        session live: they are applied first)."""
        cap = self.config.max_live_sessions
        if cap is None or self.root is None:
            return
        while len(self._live) > cap:
            idle = [s for s in self._live if not self._pending.get(s)]
            if not idle:
                return
            victim = min(idle, key=lambda s: self._order.get(s, 0))
            self._snapshot(victim)
            del self._live[victim]
            w = self._writers.pop(victim, None)
            if w is not None:
                w.close()
            self._stats["evictions"] += 1
            self._event(
                "evict", sid=victim, reason="pressure",
                live=len(self._live),
            )

    # -- read side ---------------------------------------------------------
    def state(self, sid: str) -> SessionState:
        """The session's applied state (flushes its pending first; no
        fault draws: this is the introspection/assertion surface)."""
        self._check_alive()
        self._hydrate(sid)
        self._apply_waves({sid}, faults=False)
        st = self._live[sid]
        # Reads hydrate too: a read-heavy sweep over many sessions must
        # not grow past the cap between flushes.
        self._enforce_memory()
        return st

    def summary(self, sid: str) -> SessionSummary:
        """Current k-element summary: flush, then greedy over the
        SS-pruned retained buffer (ids are stream positions).  Reads the
        session's scalars in one transfer and greedy's picks, gains and
        value in another."""
        self._check_alive()
        self._hydrate(sid)
        self._apply_waves({sid}, faults=True)
        cfg = self.config
        st = self._live[sid]
        sieve_value, n_live, seen, drops, n_ss = torch.stack([
            st.sieve.vals.max().double(), st.buf_len.double(),
            st.sieve.t.double(), st.drops.double(), st.n_ss.double(),
        ]).tolist()
        n_live, seen, drops, n_ss = int(n_live), int(seen), int(drops), int(n_ss)
        if n_live == 0:
            out = SessionSummary(
                sid=sid, selected=np.zeros(0, np.int32),
                gains=np.zeros(0, np.float32), value=0.0,
                sieve_value=sieve_value, retained=0, seen=seen, drops=drops,
                resparsifies=n_ss,
            )
            self._enforce_memory()
            return out
        fn = FeatureCoverage(W=st.buf, phi=cfg.phi)
        res = greedy(fn, cfg.k, alive=self._slots < st.buf_len,
                     backend=self._backend)
        n_sel = min(cfg.k, n_live)
        host = torch.cat([
            st.buf_ids[res.selected[:n_sel]].double(),
            res.gains[:n_sel].double(), res.value.double().reshape(1),
        ]).tolist()
        out = SessionSummary(
            sid=sid,
            selected=np.array(host[:n_sel], np.int32),
            gains=np.array(host[n_sel:2 * n_sel], np.float32),
            value=host[-1],
            sieve_value=sieve_value,
            retained=n_live,
            seen=seen,
            drops=drops,
            resparsifies=n_ss,
        )
        self._enforce_memory()
        return out

    def stats(self) -> dict:
        """Engine counters: appends acknowledged, waves/slots/padding, SS
        compactions, snapshots (+ fallbacks), rehydrations, evictions,
        restarts, crashes — plus live/known session counts."""
        st = dict(self._stats)
        st["live_sessions"] = len(self._live)
        st["known_sessions"] = len(self._known)
        st["pending"] = sum(len(q) for q in self._pending.values())
        st["events_dropped"] = self.events.dropped
        return st
