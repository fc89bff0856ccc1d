"""The port's durable streaming sessions (``repro_torch.serve.sessions``) on
the host: held to the JAX package's engine under the JAX draws, and every
contract of ``tests/test_sessions.py`` with the port alone.

- **Parity.**  The port's engine and the JAX engine (``backend="oracle"``)
  fed the same streams, with the port's compaction draws replaced by the
  JAX engine's own (``fold_in(PRNGKey(key), n_ss)``, then the split chain
  of ``tests/test_torch_batched.py``, as ``noise=``), give states leaf for
  leaf equal: exactly for the decisions, counters, buffers and keys, within
  the row sieve's tolerances (``tests/test_torch_sieve.py``) for ``vals``,
  ``cov`` and ``m``.  Summaries pick the same ids.
- **Each package refuses the other's root**: the signature names the draw
  scheme, so neither replays a WAL or snapshot whose compactions drew
  other numbers.
- **The port's own contracts**: batched waves equal B = 1 engines bit for
  bit, and every crash point, restart, torn tail, snapshot fallback and
  eviction recovers states and summaries bit-identical to the
  uninterrupted run.  A due check reads the chunk in one transfer, a wave
  reads nothing, and a device error is never taken for a corrupt snapshot.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.serve.sessions import SessionConfig as JSessionConfig
from repro.serve.sessions import SessionEngine as JSessionEngine
from repro.serve.sessions import _state_arrays as jstate_arrays
import repro_torch.api as api
from repro_torch.core.sieve import STREAM_PHIS
from repro_torch.kernels import KernelError
from repro_torch.serve import sessions, wal
from repro_torch.serve.faults import Fault, FaultInjected, FaultPlan
from repro_torch.serve.sessions import SessionConfig, SessionEngine, _state_arrays
from repro_torch.serve.summarize_service import ServiceRestarted

CPU = "cpu"
SMALL = dict(
    k=3, eps=0.5, n_features=12, buffer_cap=12, resparsify_every=5,
    ss_r=2, ss_c=6.0, max_batch=4, snapshot_every=12,
)


def cfg_small(**kw):
    return SessionConfig(**{**SMALL, **kw})


def engine(cfg=None, root=None, **kw):
    return SessionEngine(cfg or cfg_small(), root, device=CPU, **kw)


def rows_for(seed, n=36, F=12, drift=6.0):
    """A drifting stream: magnitudes grow so the sieve window keeps
    sliding, elements keep being accepted, and SS compaction fires."""
    r = np.random.default_rng(seed)
    scale = 1.0 + drift * np.arange(n, dtype=np.float32) / n
    return r.random((n, F)).astype(np.float32) * scale[:, None]


def assert_states_equal(a, b, what=""):
    la, lb = _state_arrays(a), _state_arrays(b)
    assert list(la) == list(lb)
    for name in la:
        assert la[name].dtype == lb[name].dtype, f"{what} leaf {name}"
        np.testing.assert_array_equal(la[name], lb[name],
                                      err_msg=f"{what} state leaf {name} differs")


def assert_summaries_equal(a, b):
    np.testing.assert_array_equal(a.selected, b.selected)
    np.testing.assert_array_equal(a.gains, b.gains)
    assert a.value == b.value and a.sieve_value == b.sieve_value
    assert (a.retained, a.seen, a.drops, a.resparsifies) == (
        b.retained, b.seen, b.drops, b.resparsifies)


def run_reference(cfg, root, streams, **kw):
    """The uninterrupted run: every stream fully ingested and flushed."""
    eng = engine(cfg, root, **kw)
    for sid in streams:
        eng.open_session(sid=sid, key=int(sid[1:]))
    n = max(len(v) for v in streams.values())
    for t in range(n):
        for sid, R in streams.items():
            if t < len(R):
                eng.append(sid, R[t])
    eng.flush()
    return eng


# -- the JAX engine's draws -----------------------------------------------------


def _chain(key, n, rounds):
    rows = []
    for _ in range(rounds):
        key, k1 = jax.random.split(key)
        rows.append(np.asarray(jax.random.gumbel(k1, (n,))))
    return np.stack(rows)


def _jax_draws(words, n_ss, n, rounds, device):
    """The JAX engine's compaction draws as ``noise``: row b's split chain
    from ``fold_in(key_b, n_ss_b)``."""
    return {"noise": torch.from_numpy(np.stack([
        _chain(jax.random.fold_in(jnp.asarray(w, jnp.uint32), c), n, rounds)
        for w, c in zip(words, n_ss)])).to(device)}


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(sessions, "_ss_draws", _jax_draws)


EXACT = ("sieve_jidx", "sieve_lg", "sieve_counts", "sieve_sel", "sieve_t", "buf",
         "buf_ids", "buf_len", "inserts", "n_ss", "drops", "key")
CLOSE = {"sieve_vals": 1e-5, "sieve_cov": 1e-6, "sieve_m": 1e-6}


def assert_matches_jax(state, jstate, what=""):
    a, b = _state_arrays(state), jstate_arrays(jstate)
    assert set(a) == set(b) == set(EXACT) | set(CLOSE)
    for name in a:
        assert a[name].dtype == b[name].dtype and a[name].shape == b[name].shape, name
    for name in EXACT:
        np.testing.assert_array_equal(a[name], b[name], err_msg=f"{what} {name}")
    for name, rtol in CLOSE.items():
        np.testing.assert_allclose(a[name], b[name], rtol=rtol, err_msg=f"{what} {name}")


def _both(kw, streams, root=None, jroot=None):
    port = engine(SessionConfig(**kw), root)
    ref = JSessionEngine(JSessionConfig(backend="oracle", **kw), jroot)
    for sid in streams:
        port.open_session(sid=sid, key=int(sid[1:]))
        ref.open_session(sid=sid, key=int(sid[1:]))
    n = max(len(v) for v in streams.values())
    for t in range(n):
        for sid, R in streams.items():
            if t < len(R):
                assert port.append(sid, R[t]) == ref.append(sid, R[t])
    return port, ref


@pytest.mark.parametrize("phi", STREAM_PHIS)
def test_states_match_the_jax_engine_under_its_draws(jax_draws, phi):
    streams = {f"u{i}": rows_for(i, n=40 + 3 * i) for i in range(3)}
    port, ref = _both({**SMALL, "phi": phi}, streams)
    for s in streams:
        st = port.state(s)
        # SS compaction engaged (setcover saturates: its sieve takes few rows)
        assert int(st.n_ss) > 0 or phi == "setcover"
        assert_matches_jax(st, ref.state(s), f"{phi} {s}")
        a, b = port.summary(s), ref.summary(s)
        np.testing.assert_array_equal(a.selected, b.selected)
        np.testing.assert_allclose(a.gains, b.gains, rtol=1e-5)
        np.testing.assert_allclose(a.value, b.value, rtol=1e-5)
        np.testing.assert_allclose(a.sieve_value, b.sieve_value, rtol=1e-5)
        assert (a.retained, a.seen, a.drops, a.resparsifies) == (
            b.retained, b.seen, b.drops, b.resparsifies)
    ps, rs = port.stats(), ref.stats()
    for k in ("appends", "waves", "wave_slots", "padded_slots", "resparsifies"):
        assert ps[k] == rs[k], k


def test_full_buffer_drops_match_the_jax_engine(jax_draws):
    """A buffer that fills before its insert count is due: drops counted
    and the full-buffer compaction taken at the same elements."""
    kw = {**SMALL, "buffer_cap": 4, "k": 2, "resparsify_every": 50}
    streams = {"u0": rows_for(0, n=60, drift=20.0)}
    port, ref = _both(kw, streams)
    assert_matches_jax(port.state("u0"), ref.state("u0"), "full buffer")
    assert int(port.state("u0").n_ss) > 0


def test_wal_and_snapshots_match_the_jax_engines_files(jax_draws, tmp_path):
    """Durable engines: the APPEND records are byte-equal (the OPEN records
    differ only in the signature's draw scheme), and the snapshots hold the
    same arrays under the same names and dtypes."""
    streams = {"u1": rows_for(1, n=30)}
    port, ref = _both(SMALL, streams, str(tmp_path / "t"), str(tmp_path / "j"))
    port.close()
    ref.close()
    pw = (tmp_path / "t" / "u1" / "wal.log").read_bytes()
    jw = (tmp_path / "j" / "u1" / "wal.log").read_bytes()
    pr, jr = (wal.scan_wal(str(tmp_path / d / "u1" / "wal.log")).records
              for d in ("t", "j"))
    assert pr[1:] == jr[1:]
    open_len = 21 + len(pr[0].payload), 21 + len(jr[0].payload)
    assert pw[open_len[0]:] == jw[open_len[1]:]
    pm, jm = json.loads(pr[0].payload), json.loads(jr[0].payload)
    assert pm["key"] == jm["key"] == [0, 1] and pm["schema"] == jm["schema"]
    assert {**json.loads(pm["sig"])} == {**json.loads(jm["sig"]),
                                         "draws": "torch-splitmix64"}
    names = sorted(n for n in os.listdir(tmp_path / "t" / "u1") if n.startswith("snap-"))
    assert names == sorted(n for n in os.listdir(tmp_path / "j" / "u1")
                           if n.startswith("snap-"))
    with np.load(tmp_path / "t" / "u1" / names[-1]) as a, \
            np.load(tmp_path / "j" / "u1" / names[-1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            if f == "_meta":
                continue
            assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, f
            if f in EXACT:
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_each_package_refuses_the_others_root(tmp_path):
    """The JAX package's compactions drew other numbers, so a replay would
    give another, equally plausible state: both packages refuse the other's
    OPEN record, and the other's snapshot under an accepted OPEN record."""
    streams = {"u0": rows_for(0, n=20)}
    JSessionEngine(JSessionConfig(**SMALL), str(tmp_path / "j")).open_session(
        sid="u0", key=0)
    run_reference(cfg_small(), str(tmp_path / "t"), streams).close()
    with pytest.raises(ValueError, match="different"):
        engine(cfg_small(), str(tmp_path / "j")).state("u0")
    with pytest.raises(ValueError, match="different"):
        JSessionEngine(JSessionConfig(**SMALL), str(tmp_path / "t")).state("u0")
    # a JAX snapshot dropped into the port's session (and the reverse)
    jeng = JSessionEngine(JSessionConfig(**SMALL), str(tmp_path / "j2"))
    jeng.open_session(sid="u0", key=0)
    for r in streams["u0"]:
        jeng.append("u0", r)
    jeng.close()
    newest = {d: sorted(n for n in os.listdir(tmp_path / d / "u0")
                        if n.startswith("snap-"))[-1] for d in ("j2", "t")}
    for src, dst in (("j2", "t"), ("t", "j2")):
        shutil.copy(tmp_path / src / "u0" / newest[src],
                    tmp_path / dst / "u0" / "snap-999999999999.npz")
    with pytest.raises(ValueError, match="different SessionConfig"):
        engine(cfg_small(), str(tmp_path / "t")).state("u0")
    with pytest.raises(ValueError, match="different SessionConfig"):
        JSessionEngine(JSessionConfig(**SMALL), str(tmp_path / "j2")).state("u0")


# -- the reference's contracts, with the port alone -----------------------------


def test_volatile_round_trip_and_validation():
    eng = engine()
    sid = eng.open_session(key=1)
    R = rows_for(1)
    for t in range(len(R)):
        eng.append(sid, R[t])
    s = eng.summary(sid)
    assert s.seen == len(R)
    assert 0 < s.retained <= eng.config.buffer_cap
    assert s.value > 0 and s.sieve_value > 0
    assert len(s.selected) <= eng.config.k
    assert (s.selected >= 0).all() and (s.selected < s.seen).all()
    assert s.resparsifies > 0        # the SS tier actually engaged
    with pytest.raises(KeyError):
        eng.append("nope", R[0])
    with pytest.raises(ValueError, match="shape"):
        eng.append(sid, np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="finite"):
        eng.append(sid, np.full(12, np.nan, np.float32))
    with pytest.raises(ValueError, match="already exists"):
        eng.open_session(sid=sid)
    with pytest.raises(ValueError, match="session id"):
        eng.open_session(sid="../escape")
    with pytest.raises(ValueError, match="root"):
        engine(cfg_small(max_live_sessions=1))


def test_append_copies_the_row():
    """A caller that reuses its buffer after ``append`` changes nothing
    already acknowledged; a host tensor row is admitted like an array."""
    a, b = engine(), engine()
    for e in (a, b):
        e.open_session(sid="u0", key=0)
    R = rows_for(2, n=20)
    buf = np.empty(12, np.float32)
    for t in range(20):
        buf[:] = R[t]
        a.append("u0", buf)
        b.append("u0", torch.from_numpy(R[t].copy()))
    buf[:] = 0.0
    assert_states_equal(a.state("u0"), b.state("u0"), "copied rows")


def test_batched_waves_match_single_session_engines():
    """A 3-session engine (waves over chunks of sessions) gives states bit
    identical to three isolated B = 1 engines: the contract B = 1 recovery
    replay leans on."""
    cfg = cfg_small()
    multi = engine(cfg)
    sids = [multi.open_session(sid=f"s{i}", key=i) for i in range(3)]
    streams = {s: rows_for(i, n=30 + 2 * i) for i, s in enumerate(sids)}
    for t in range(34):
        for s in sids:
            if t < len(streams[s]):
                multi.append(s, streams[s][t])
    assert multi.stats()["padded_slots"] > 0     # 3 sessions pad to bucket 4
    for i, s in enumerate(sids):
        solo = engine(cfg)
        alone = solo.open_session(sid=s, key=i)
        for t in range(len(streams[s])):
            solo.append(alone, streams[s][t])
        assert_states_equal(multi.state(s), solo.state(alone), f"session {s}")
        assert_summaries_equal(multi.summary(s), solo.summary(alone))


@pytest.mark.parametrize("snapshot_every", [6, None])
def test_durable_recovery_bit_identical(tmp_path, snapshot_every):
    """Reopening a root recovers every session bit-identically: via
    snapshot + WAL tail, or (snapshot_every=None) by full WAL replay."""
    cfg = cfg_small(snapshot_every=snapshot_every)
    root = str(tmp_path / "eng")
    streams = {f"u{i}": rows_for(i) for i in range(2)}
    ref = run_reference(cfg, root, streams)
    states = {s: ref.state(s) for s in streams}
    summaries = {s: ref.summary(s) for s in streams}

    rec = engine(cfg, root)
    assert rec.sessions() == sorted(streams)       # zero lost sessions
    for s in streams:
        assert_states_equal(states[s], rec.state(s), f"recovered {s}")
        assert_summaries_equal(summaries[s], rec.summary(s))
    ev = [e for e in rec.events if e["step"] == "rehydrate"]
    assert len(ev) == len(streams)
    if snapshot_every is None:
        assert all(e["replayed"] == len(rows_for(0)) for e in ev)


def test_recovery_can_continue_ingesting(tmp_path):
    cfg = cfg_small()
    root = str(tmp_path / "eng")
    R = rows_for(4, n=40)
    ref = run_reference(cfg, str(tmp_path / "ref"), {"u4": R})
    half = engine(cfg, root)
    half.open_session(sid="u4", key=4)
    for t in range(20):
        half.append("u4", R[t])
    half.flush()
    del half
    rec = engine(cfg, root)
    for t in range(20, 40):
        rec.append("u4", R[t])
    assert_states_equal(ref.state("u4"), rec.state("u4"), "continued")
    assert_summaries_equal(ref.summary("u4"), rec.summary("u4"))


def test_snapshot_fallback_on_corrupt_latest(tmp_path):
    cfg = cfg_small(snapshot_every=6)
    root = str(tmp_path / "eng")
    ref = run_reference(cfg, root, {"u0": rows_for(0)})
    want_state, want_sum = ref.state("u0"), ref.summary("u0")
    sdir = os.path.join(root, "u0")
    snaps = sorted(n for n in os.listdir(sdir) if n.startswith("snap-"))
    assert len(snaps) == 2                      # engine keeps the newest two
    with open(os.path.join(sdir, snaps[-1]), "r+b") as f:
        f.seek(100)
        f.write(b"\xff" * 50)
    rec = engine(cfg, root)
    assert_states_equal(want_state, rec.state("u0"), "fallback")
    assert_summaries_equal(want_sum, rec.summary("u0"))
    assert rec.stats()["snapshot_fallbacks"] == 1
    (ev,) = [e for e in rec.events if e["step"] == "snapshot_fallback"]
    assert ev["snapshot"] == snaps[-1]


@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    KernelError("ss_divergence: launch failed"),
], ids=["cuda_error", "kernel_error"])
def test_load_snapshot_lets_a_device_error_through(tmp_path, monkeypatch, error):
    """Only reading the snapshot file on the host falls back; an error
    moving its arrays to the device propagates, no fallback recorded."""
    cfg = cfg_small(snapshot_every=6)
    root = str(tmp_path / "eng")
    run_reference(cfg, root, {"u0": rows_for(0)})

    def broken(arrays, device):
        raise error

    monkeypatch.setattr(sessions, "_arrays_state", broken)
    rec = engine(cfg, root)
    with pytest.raises(type(error), match=str(error).split(":")[0]):
        rec.state("u0")
    assert rec.stats()["snapshot_fallbacks"] == 0
    assert not [e for e in rec.events if e["step"] == "snapshot_fallback"]


def test_a_kernel_error_in_a_compaction_propagates(monkeypatch):
    """No fault path swallows a kernel failure: the flush raises it and the
    wave's elements stay pending."""
    def broken(*args, **kw):
        raise KernelError("ss_divergence: launch failed")

    monkeypatch.setattr(sessions, "ss_sparsify_batched", broken)
    eng = engine(cfg_small(max_batch=8, flush_every=100))
    eng.open_session(sid="u0", key=0)
    with pytest.raises(KernelError):
        for r in rows_for(0, n=36):
            eng.append("u0", r)
        eng.flush()


def test_corrupt_wal_tail_handling(tmp_path):
    cfg = cfg_small(snapshot_every=None)
    root = str(tmp_path / "eng")
    ref = run_reference(cfg, root, {"u0": rows_for(0, n=20)})
    del ref
    p = os.path.join(root, "u0", "wal.log")
    full = open(p, "rb").read()
    open(p, "wb").write(full[:-7])
    with pytest.raises(wal.WALTruncated):
        engine(cfg, root).state("u0")
    tol = engine(dataclasses.replace(cfg, tolerate_torn_tail=True), root)
    st = tol.state("u0")
    assert int(st.sieve.t) == 19               # only the torn record lost
    data = bytearray(full)
    data[len(data) - 69 - 10] ^= 0xFF
    open(p, "wb").write(bytes(data))
    for cfg_try in (cfg, dataclasses.replace(cfg, tolerate_torn_tail=True)):
        with pytest.raises(wal.WALCorrupt):
            engine(cfg_try, root).state("u0")


def test_torn_tail_recovery_truncates_wal_and_appends_survive(tmp_path):
    cfg = cfg_small(snapshot_every=None, tolerate_torn_tail=True)
    root = str(tmp_path / "eng")
    R = rows_for(7, n=30)
    ref = run_reference(cfg, str(tmp_path / "ref"), {"u7": R})
    half = engine(cfg, root)
    half.open_session(sid="u7", key=7)
    for t in range(20):
        half.append("u7", R[t])
    half.flush()
    del half
    p = os.path.join(root, "u7", "wal.log")
    os.truncate(p, os.path.getsize(p) - 7)      # crash mid-write of seq 20
    rec = engine(cfg, root)
    assert int(rec.state("u7").sieve.t) == 19   # only the torn record lost
    assert rec.stats()["wal_truncations"] == 1
    (ev,) = [e for e in rec.events if e["step"] == "wal_truncate"]
    assert ev["sid"] == "u7" and ev["dropped_bytes"] == 69 - 7
    assert os.path.getsize(p) == ev["valid_end"]    # partial bytes are gone
    for t in range(19, 30):
        rec.append("u7", R[t])
    rec.flush()
    del rec
    strict = engine(dataclasses.replace(cfg, tolerate_torn_tail=False), root)
    assert_states_equal(ref.state("u7"), strict.state("u7"), "post-torn")
    assert_summaries_equal(ref.summary("u7"), strict.summary("u7"))


def test_volatile_engine_rejects_crash_restart_faults():
    for kind in ("crash", "restart"):
        with pytest.raises(ValueError, match="volatile"):
            engine(faults=FaultPlan({0: Fault(kind)}))
    engine(faults=FaultPlan({0: Fault("exec_error")}))
    engine(None, None, faults=FaultPlan({1: Fault("latency")}))


def test_config_signature_mismatch_refuses_replay(tmp_path):
    cfg = cfg_small()
    root = str(tmp_path / "eng")
    run_reference(cfg, root, {"u0": rows_for(0, n=10)})
    other = engine(dataclasses.replace(cfg, k=4), root)
    with pytest.raises(ValueError, match="different"):
        other.state("u0")
    assert json.loads(cfg.signature())["draws"] == sessions.DRAWS
    assert cfg.signature() == dataclasses.replace(cfg, backend="cuda").signature()


@pytest.mark.parametrize("seed", [0, 1])
def test_crash_point_matrix_replay_exactness(tmp_path, seed):
    """Crash the engine at every fault-attempt index that fires mid-stream;
    after recovery and finishing the stream, state and summary are bit
    identical to the uninterrupted run, with zero lost sessions."""
    cfg = cfg_small(snapshot_every=8)
    streams = {f"u{i}": rows_for(100 * seed + i, n=28) for i in range(2)}
    ref = run_reference(cfg, str(tmp_path / f"ref{seed}"), streams)
    want = {s: ref.state(s) for s in streams}
    want_sum = {s: ref.summary(s) for s in streams}

    for cp in (0, 2, 5, 9):
        root = str(tmp_path / f"c{seed}-{cp}")
        eng = engine(cfg, root, faults=FaultPlan({cp: Fault("crash")}))
        crashed = False
        try:
            for s in streams:
                eng.open_session(sid=s, key=int(s[1:]))
            for t in range(28):
                for s in streams:
                    eng.append(s, streams[s][t])
            eng.flush()
        except ServiceRestarted:
            crashed = True
        assert crashed, f"crash point {cp} was never reached"
        rec = engine(cfg, root)
        assert rec.sessions() == sorted(streams)   # zero lost sessions
        for s in streams:
            done = int(rec.state(s).sieve.t)
            for t in range(done, 28):
                rec.append(s, streams[s][t])
        rec.flush()
        for s in streams:
            assert_states_equal(want[s], rec.state(s), f"crash@{cp} session {s}")
            assert_summaries_equal(want_sum[s], rec.summary(s))


def test_restart_fault_is_transparent(tmp_path):
    cfg = cfg_small(snapshot_every=8)
    R = rows_for(9, n=32)
    ref = run_reference(cfg, str(tmp_path / "ref"), {"u9": R})
    plan = FaultPlan({2: Fault("restart"), 6: Fault("restart")})
    eng = engine(cfg, str(tmp_path / "eng"), faults=plan)
    eng.open_session(sid="u9", key=9)
    for t in range(32):
        eng.append("u9", R[t])
    eng.flush()
    assert eng.stats()["restarts"] == 2
    assert [e["step"] for e in eng.events].count("restart") == 2
    assert_states_equal(ref.state("u9"), eng.state("u9"), "restart")
    assert_summaries_equal(ref.summary("u9"), eng.summary("u9"))


def _draw_stages(cfg, R) -> list[str]:
    """The stage of every fault draw in a fault-free run of ``R`` on one
    session, in attempt order."""
    eng = engine(cfg, faults=FaultPlan({}))
    stages, real = [], eng._draw_fault

    def spy(chunk, stage, faults):
        stages.append(stage) if faults else None
        return real(chunk, stage, faults)

    eng._draw_fault = spy
    eng.open_session(sid="u3", key=3)
    for r in R:
        eng.append("u3", r)
    eng.flush()
    return stages


@pytest.mark.parametrize("stage", ["wave", "resparsify"])
def test_exec_error_loses_nothing(tmp_path, stage):
    """An injected execution error, in a wave or in a compaction, aborts
    the flush before any state changes (the pending queue and every tensor
    as they were); the retried flush lands the identical state."""
    cfg = cfg_small()
    R = rows_for(3, n=12)
    ref = run_reference(cfg, str(tmp_path / "ref"), {"u3": R})
    first = _draw_stages(cfg, R).index(stage)
    eng = engine(cfg, str(tmp_path / "eng"),
                 faults=FaultPlan({first: Fault("exec_error")}))
    seen, real = [], eng._draw_fault

    def spy(chunk, stage_, faults):
        seen.append((_state_arrays(eng._live["u3"]), eng.stats()["pending"]))
        return real(chunk, stage_, faults)

    eng._draw_fault = spy
    eng.open_session(sid="u3", key=3)
    with pytest.raises(FaultInjected):
        for t in range(12):
            eng.append("u3", R[t])
    assert len(seen) == first + 1
    before, pending = seen[-1]
    assert eng.stats()["pending"] == pending > 0
    after = _state_arrays(eng._live["u3"])
    for name in after:
        np.testing.assert_array_equal(after[name], before[name], err_msg=name)
    done = int(eng.state("u3").sieve.t)
    for t in range(done, 12):
        eng.append("u3", R[t])
    assert_states_equal(ref.state("u3"), eng.state("u3"), "exec_error")


def test_eviction_ladder_preserves_state(tmp_path):
    cfg = cfg_small(max_live_sessions=2, snapshot_every=8)
    free = dataclasses.replace(cfg, max_live_sessions=None)
    streams = {f"e{i}": rows_for(i, n=20) for i in range(4)}
    ref = run_reference(free, str(tmp_path / "ref"), streams)
    eng = run_reference(cfg, str(tmp_path / "eng"), streams)
    st = eng.stats()
    assert st["live_sessions"] <= 2
    assert st["evictions"] > 0 and st["rehydrations"] > 0
    steps = [e["step"] for e in eng.events]
    assert "evict" in steps and "rehydrate" in steps
    ev = next(e for e in eng.events if e["step"] == "evict")
    assert ev["reason"] == "pressure" and "sid" in ev and "live" in ev
    for s in streams:
        assert_states_equal(ref.state(s), eng.state(s), f"ladder {s}")
        assert_summaries_equal(ref.summary(s), eng.summary(s))


def test_read_path_enforces_memory_cap(tmp_path):
    cfg = cfg_small(max_live_sessions=2, snapshot_every=8)
    streams = {f"r{i}": rows_for(i, n=12) for i in range(5)}
    eng = run_reference(cfg, str(tmp_path / "eng"), streams)
    assert eng.stats()["live_sessions"] <= 2
    for s in streams:           # hydrate every session through reads only
        eng.summary(s)
        assert eng.stats()["live_sessions"] <= 2
    for s in streams:
        eng.state(s)
        assert eng.stats()["live_sessions"] <= 2


def test_close_snapshots_for_fast_reopen(tmp_path):
    cfg = cfg_small(snapshot_every=1000)   # interval policy never fires
    root = str(tmp_path / "eng")
    with engine(cfg, root) as eng:
        eng.open_session(sid="u0", key=0)
        for r in rows_for(0, n=9):
            eng.append("u0", r)
        want = eng.state("u0")
    with pytest.raises(RuntimeError, match="closed"):
        eng.summary("u0")
    rec = engine(cfg, root)
    assert_states_equal(want, rec.state("u0"), "reopen")
    (ev,) = [e for e in rec.events if e["step"] == "rehydrate"]
    assert ev["replayed"] == 0             # close() snapshotted everything


# -- host reads -----------------------------------------------------------------


class _HostReads(TorchFunctionMode):
    """Counts the tensor calls that read values back to the host (on the
    card each is a wait): ``item``, ``tolist``, ``numpy`` and the Python
    conversions ``bool`` / ``int`` / ``float`` / ``index``."""

    READS = {"item", "tolist", "numpy", "__bool__", "__int__", "__float__",
             "__index__"}

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.count += getattr(func, "__name__", "") in self.READS
        return func(*args, **(kwargs or {}))


def _reads(call) -> int:
    with _HostReads() as mode:
        call()
    return mode.count


@pytest.mark.parametrize("B", [1, 2, 4])
def test_one_host_read_per_due_check_and_none_per_wave(B):
    """A flush of one wave over B sessions reads the host twice (the due
    checks before and after the wave, each one transfer for the whole
    chunk), at every B; the wave itself reads nothing.  (The reference
    reads two or three scalars a session a check.)"""
    eng = engine(cfg_small(max_batch=4, flush_every=100, snapshot_every=None))
    sids = [eng.open_session(sid=f"u{i}", key=i) for i in range(B)]
    for s in sids:
        eng.append(s, rows_for(int(s[1:]), n=1)[0])
    assert eng.stats()["pending"] == B
    assert _reads(eng.flush) == 2
    for s in sids:
        eng.append(s, rows_for(int(s[1:]), n=2)[1])
    assert _reads(lambda: eng._exec_wave(sids, False)) == 0
    assert _reads(lambda: eng._maybe_resparsify(sids, False)) == 1


def test_a_compaction_adds_only_batched_ss_reads():
    """A flush whose check compacts adds to its two reads only batched SS's
    own: the live counts, one transfer a round."""
    from repro_torch.core.sparsify import _sparsify_batched

    eng = engine(cfg_small(max_batch=4, flush_every=100, snapshot_every=None))
    sids = [eng.open_session(sid=f"u{i}", key=i) for i in range(3)]
    streams = {s: rows_for(int(s[1:])) for s in sids}
    compacted = 0
    for t in range(36):
        for s in sids:
            eng.append(s, streams[s][t])
        n_ss, ss_reads = eng.stats()["resparsifies"], _sparsify_batched.host_reads
        reads = _reads(eng.flush)
        extra = _sparsify_batched.host_reads - ss_reads
        assert reads == 2 + extra
        assert (extra > 0) == (eng.stats()["resparsifies"] > n_ss)
        compacted += extra > 0
    assert compacted > 0


@pytest.mark.parametrize("k", [2, 3])
def test_summary_reads_do_not_grow_with_k(tmp_path, k):
    """``summary`` reads the session's scalars in one transfer, greedy's
    live count once, and its picks, gains and value in one more."""
    eng = engine(cfg_small(k=k))
    eng.open_session(sid="u0", key=0)
    for r in rows_for(0, n=20):
        eng.append("u0", r)
    eng.flush()
    assert _reads(lambda: eng.summary("u0")) == 3


# -- the api facade ---------------------------------------------------------------


def test_api_sessions_facade(tmp_path):
    root = str(tmp_path / "api")
    eng = api.sessions(SessionConfig(k=3, eps=0.5, n_features=12,
                                     buffer_cap=12), root, device=CPU)
    sid = api.open_session(key=1, engine=eng)
    R = rows_for(1, n=15)
    seqs = [api.append(sid, R[t], engine=eng) for t in range(15)]
    assert seqs == list(range(1, 16))      # contiguous durable acks
    s = api.summary(sid, engine=eng)
    assert s.sid == sid and s.seen == 15 and s.value > 0
    eng2 = api.sessions(eng.config, root, device=CPU)
    assert_summaries_equal(s, api.summary(sid, engine=eng2))


def test_api_default_engine_rejects_mismatched_root(tmp_path):
    saved = api._default_engine
    api._default_engine = None
    try:
        eng = api.default_engine(device=CPU)        # volatile first use
        assert api.default_engine(device=CPU) is eng
        with pytest.raises(ValueError, match="rooted"):
            api.default_engine(root=str(tmp_path / "durable"), device=CPU)
        with pytest.raises(ValueError, match="configured"):
            api.default_engine(SessionConfig(k=5), device=CPU)
        # the verbs use the live default, whatever its device
        sid = api.open_session(key=2)
        assert api.append(sid, np.ones(64, np.float32)) == 1
        assert api.summary(sid).seen == 1
        api._default_engine = None
        rooted = api.default_engine(root=str(tmp_path / "a"), device=CPU)
        assert api.default_engine(root=str(tmp_path / "a"), device=CPU) is rooted
        with pytest.raises(ValueError, match="rooted"):
            api.default_engine(root=str(tmp_path / "b"), device=CPU)
    finally:
        api._default_engine = saved
