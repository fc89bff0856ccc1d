"""Durable streaming sessions on the card: waves of 8 sessions equal B = 1
replays bit for bit, each SS compaction's kernel route agrees with the plain
route on the same buffers and draws, and a wave adds no host sync beyond
its two due checks.  These tests need a CUDA card (marker ``cuda``) and skip
without one; they import nothing of JAX:

    python -m pytest -m cuda tests/test_torch_sessions_card.py
"""

import numpy as np
import pytest
import torch

from repro_torch import FeatureCoverage
from repro_torch.core.sparsify import ss_sparsify_batched
from repro_torch.data import news_day
from repro_torch.kernels import feature_gains_kernel, ss_divergence_kernel
from repro_torch.serve import sessions
from repro_torch.serve.sessions import SessionConfig, SessionEngine, _state_arrays

CFG = dict(k=32, eps=0.2, n_features=128, buffer_cap=64, resparsify_every=30,
           ss_r=4, ss_c=8.0, snapshot_every=None)
N_SESSIONS, ROWS = 8, 256


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the session tier's kernels are CUDA kernels")
    return torch.device("cuda")


def _streams():
    W = news_day(0, N_SESSIONS * ROWS, CFG["n_features"])
    return {f"u{i:03d}": W[i * ROWS:(i + 1) * ROWS] for i in range(N_SESSIONS)}


def _run(streams, card, **kw):
    eng = SessionEngine(SessionConfig(**{**CFG, **kw}), device=card)
    for sid in streams:
        eng.open_session(sid=sid, key=int(sid[1:]))
    for t in range(ROWS):
        for sid, R in streams.items():
            eng.append(sid, R[t])
    eng.flush()
    return eng


def _same_state(a, b, what):
    la, lb = _state_arrays(a), _state_arrays(b)
    for name in la:
        np.testing.assert_array_equal(la[name], lb[name], err_msg=f"{what} {name}")


@pytest.mark.cuda
def test_waves_of_eight_equal_single_session_replays(card):
    streams = _streams()
    multi = _run(streams, card, max_batch=8)
    assert multi.stats()["resparsifies"] > N_SESSIONS     # every session compacts
    for sid in list(streams)[:3]:
        solo = _run({sid: streams[sid]}, card, max_batch=1)
        _same_state(multi.state(sid), solo.state(sid), f"B=8 vs B=1 {sid}")
        a, b = multi.summary(sid), solo.summary(sid)
        assert np.array_equal(a.selected, b.selected) and a.value == b.value


@pytest.mark.cuda
def test_compactions_kernel_route_agrees_with_the_plain_route(card, monkeypatch):
    """Every compaction of a B = 8 run, replayed on the same buffers and
    draws through the plain route on the card: the same kept set, eps_hat
    within 1e-4 of the divergences' size; ``ss_divergence`` launched once a
    row a round and ``feature_gains`` k times a summary."""
    calls = []

    def recording(fn, generators=None, **kw):
        states = [g.get_state() for g in generators]
        ss = ss_sparsify_batched(fn, generators, **kw)
        calls.append((fn.W.clone(), kw["alive"].clone(), states, ss))
        return ss

    monkeypatch.setattr(sessions, "ss_sparsify_batched", recording)
    ss_divergence_kernel.launches = feature_gains_kernel.launches = 0
    eng = _run(_streams(), card, max_batch=8)
    launches = ss_divergence_kernel.launches
    summaries = [eng.summary(s) for s in eng.sessions()]
    assert feature_gains_kernel.launches == CFG["k"] * len(summaries)
    assert launches == sum(sum(ss.rounds) for *_, ss in calls) > 0
    for W, alive, states, ss in calls:
        gens = []
        for st in states:
            g = torch.Generator(device=card)
            g.set_state(st)
            gens.append(g)
        plain = ss_sparsify_batched(FeatureCoverage(W=W), gens, r=CFG["ss_r"],
                                    c=CFG["ss_c"], alive=alive, backend="reference")
        assert torch.equal(plain.vprime, ss.vprime)
        size = float(torch.sqrt(W).sum(dim=-1).max())
        assert float((plain.eps_hat - ss.eps_hat).abs().max()) <= 1e-4 * max(1.0, size)


def _syncs(call) -> int:
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


@pytest.mark.cuda
def test_a_wave_syncs_only_at_its_due_checks(card):
    """A flush of one wave over 8 sessions synchronises twice, once for
    each due check's transfer; the wave itself (the pinned upload and the
    row map) not at all."""
    eng = SessionEngine(SessionConfig(**{**CFG, "max_batch": 8, "flush_every": 100}),
                        device=card)
    streams = _streams()
    for sid in streams:
        eng.open_session(sid=sid, key=int(sid[1:]))

    def append_all(t):
        for sid, R in streams.items():
            eng.append(sid, R[t])

    append_all(0)
    eng.flush()                      # first use of each operation
    append_all(1)
    assert _syncs(eng.flush) == 2
    append_all(2)
    assert _syncs(lambda: eng._exec_wave(list(streams), False)) == 0
