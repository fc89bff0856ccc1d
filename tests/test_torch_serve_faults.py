"""The port's fault-tolerant serving on the host: the seeded chaos suite over
the recovery loop (retry → failover → per-query isolation), the watchdog,
the degradation ladder, and the drain / TicketPending semantics.

Invariants pinned here:

- **no ticket is ever lost**: every admitted ticket settles, with a
  response or a correctly attributed error, whatever faults its chunk's
  attempts drew, and ``drain()`` returns mid-fault;
- **attribution**: every injected fault lands in ``FaultPlan.log`` with the
  ticket indices of the attempt that drew it; ``FaultPlan.seeded`` draws
  the JAX package's schedules exactly;
- **recovery is invisible in the results**: a same-backend retry serves the
  fault-free run's bits (the service rebuilds each row's generator from
  the query's admitted draw state, so a ``torch.Generator`` seed replays
  too); a failed-over or isolated query gives the same bits on the host,
  where both backends are the plain route;
- **the ladder degrades audibly**: a ladder that never triggers changes no
  bit, every degraded response carries its record, and the planner's walk
  under a deadline is checked deterministically from a seeded execution
  estimate (no wall-clock comparison) and equals the JAX package's levels.

On the host the failover target is ``OtherBackend``, the plain backend
under another name (the reference's tests pick ``_other_backend()`` the
same way); ``failover_backend="reference"`` resolves to the primary here
and is skipped.  The card's ``cuda`` → ``reference`` failover is checked by
``chip_smoke.py``.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.data.synthetic import news_day
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import RunConfig as JRunConfig
from repro.serve import SummarizeService as JSummarizeService
from repro_torch import obs
from repro_torch.core import ReferenceBackend
from repro_torch.kernels import KernelError, _build
from repro_torch.serve import (
    ChunkTimeout,
    Fault,
    FaultInjected,
    FaultPlan,
    MalformedResult,
    RunConfig,
    ServiceRestarted,
    SummarizeRequest,
    SummarizeService,
    TicketPending,
    build_batch_objective,
    summarize_batch,
)

CPU = "cpu"


@dataclasses.dataclass(frozen=True)
class OtherBackend(ReferenceBackend):
    """The plain backend under another name: a failover target that differs
    from the host's primary."""

    name = "other"


def req(i, n=64, F=16, k=4, **kw):
    return SummarizeRequest(k=k, seed=i, features=news_day(i, n, F), **kw)


def svc(cfg=None, faults=None, **kw):
    return SummarizeService(cfg or RunConfig(**kw), faults=faults, device=CPU)


def assert_same_results(a, b):
    """Bit-identical payload; serving metadata is not compared."""
    assert torch.equal(a.selected, b.selected)
    assert torch.equal(a.gains, b.gains)
    assert a.value == b.value
    assert a.vprime_size == b.vprime_size
    assert a.eps_hat == b.eps_hat
    assert a.rounds == b.rounds


# ------------------------------------------------------------- the harness --
def test_fault_plan_seeded_deterministic():
    kw = dict(n_attempts=64, p_exec_error=0.3, p_latency=0.2)
    a, b = FaultPlan.seeded(7, **kw), FaultPlan.seeded(7, **kw)
    assert a.schedule == b.schedule and a.schedule
    assert a.schedule != FaultPlan.seeded(8, **kw).schedule
    assert a.log == [] and a.attempts == 0
    with pytest.raises(ValueError, match="probabilities"):
        FaultPlan.seeded(0, p_exec_error=0.9, p_latency=0.9)
    with pytest.raises(ValueError, match="kind"):
        Fault("nope")


@pytest.mark.parametrize("seed", range(10))
def test_fault_plan_seeded_equals_the_jax_packages(seed):
    kw = dict(n_attempts=64, p_exec_error=0.2, p_latency=0.1, p_hang=0.05,
              p_malformed=0.1, p_crash=0.02, p_restart=0.03, latency_s=0.01,
              hang_s=3.0)
    ours = FaultPlan.seeded(seed, **kw).schedule
    theirs = JFaultPlan.seeded(seed, **kw).schedule
    assert sorted(ours) == sorted(theirs)
    for i, f in ours.items():
        assert (f.kind, f.delay_s) == (theirs[i].kind, theirs[i].delay_s)


def test_fault_plan_draw_consumes_and_logs():
    plan = FaultPlan({1: Fault("exec_error")})
    assert plan.draw(tickets=(0,), lane=("l",), backend="reference",
                     stage="primary") is None
    f = plan.draw(tickets=(1, 2), lane=("l",), backend="reference", stage="primary")
    assert f.kind == "exec_error" and plan.attempts == 2
    (ev,) = plan.events()
    assert ev.attempt == 1 and ev.tickets == (1, 2)
    assert plan.events("latency") == []
    (bus_ev,) = obs.get_bus().events(kind="fault", request_id=2)
    assert bus_ev.data["attempt"] == 1


# ------------------------------------------------------ retry and failover --
@pytest.mark.parametrize("kind", ["exec_error", "malformed"])
def test_fault_retried_with_identical_results(kind):
    reqs = [req(i) for i in range(4)]
    ref = svc(max_batch=4).run(reqs)
    plan = FaultPlan({0: Fault(kind)})
    s = svc(max_batch=4, retry_backoff_s=0.002, faults=plan)
    out = s.run(reqs)
    for a, b in zip(out, ref):
        assert_same_results(a, b)
        assert a.recovery == {"retries": 1, "stage": "primary",
                              "backends": ("reference",), "isolated": False}
    assert all(r.recovery is None for r in ref)
    (ev,) = plan.events(kind)
    assert ev.tickets == (0, 1, 2, 3) and ev.stage == "primary"
    st = s.stats()
    assert st["retries"] == 1 and st["failed"] == 0 and st["queries"] == 4
    assert st["failovers"] == 0


def test_generator_seed_retry_is_bit_identical():
    """A ``torch.Generator`` seed: the retried attempt replays the first
    attempt's draws (fresh generators from the admitted state), so the
    response equals the fault-free run's."""
    def reqs():
        return [SummarizeRequest(k=4, seed=torch.Generator().manual_seed(80 + i),
                                 features=news_day(80 + i, 64, 16)) for i in range(3)]

    ref = svc(max_batch=4).run(reqs())
    plan = FaultPlan({0: Fault("malformed"), 1: Fault("exec_error")})
    out = svc(max_batch=4, retry_backoff_s=0.002, faults=plan).run(reqs())
    for a, b in zip(out, ref):
        assert_same_results(a, b)
        assert a.recovery["retries"] == 2


def test_failover_after_retry_exhaustion():
    reqs = [req(i) for i in range(4)]
    ref = svc(max_batch=4).run(reqs)
    plan = FaultPlan({0: Fault("exec_error"), 1: Fault("exec_error")})
    s = svc(max_batch=4, max_retries=1, retry_backoff_s=0.002,
            failover_backend=OtherBackend(), faults=plan)
    out = s.run(reqs)
    for a, b in zip(out, ref):
        assert_same_results(a, b)          # both stages run the plain route
        assert a.recovery["stage"] == "failover"
        assert a.recovery["backends"] == ("reference", "other")
    assert [e.stage for e in plan.log] == ["primary", "primary"]
    st = s.stats()
    assert st["failovers"] == 1 and st["failed"] == 0 and st["queries"] == 4
    assert obs.get_registry().get("repro_service_failovers_total").value() == 1
    (ev,) = [e for e in obs.get_bus().events(kind="recovery", subsystem="service")
             if e.data["step"] == "failover"]
    assert ev.data["backend"] == "other" and ev.request_ids == (0, 1, 2, 3)


def test_failover_to_the_primary_is_skipped():
    """The default ``failover_backend="reference"`` resolves to the host's
    primary, so the stage is skipped: an exhausted chunk goes straight to
    per-query isolation and no failover is counted."""
    reqs = [req(i) for i in range(2)]
    ref = svc(max_batch=2).run(reqs)
    plan = FaultPlan({0: Fault("exec_error")})
    s = svc(max_batch=2, max_retries=0, faults=plan)
    out = s.run(reqs)
    for a, b in zip(out, ref):
        assert_same_results(a, b)
        assert a.recovery == {"retries": 1, "stage": "isolated",
                              "backends": ("reference",), "isolated": True}
    st = s.stats()
    assert st["failovers"] == 0 and st["isolated_queries"] == 2
    assert [e.stage for e in plan.log] == ["primary"]


class _CountingOther(OtherBackend):
    """The failover target, counting the primitives it runs."""

    calls = 0

    def divergence(self, *a, **kw):
        type(self).calls += 1
        return super().divergence(*a, **kw)

    def gains(self, *a, **kw):
        type(self).calls += 1
        return super().gains(*a, **kw)


def _build_fails():
    _build._run_all([[sys.executable, "-c", "raise SystemExit(1)"]])


def _launch_fails():
    _build.raise_on_error("ss_divergence", 700)


def _sticky_cuda_error():
    raise RuntimeError("CUDA error: an illegal memory access was encountered")


@pytest.mark.parametrize("fail", [_build_fails, _launch_fails, _sticky_cuda_error],
                         ids=["build", "launch", "cuda_error"])
def test_kernel_failure_is_never_recovered(fail):
    """A kernel that fails to build or launch, or a sticky CUDA error, fails
    the chunk's tickets at once: no retry, no failover (the plain route
    would serve correct answers over a broken kernel), no isolation."""

    @dataclasses.dataclass(frozen=True)
    class Broken(ReferenceBackend):
        name = "broken"

        def divergence(self, *a, **kw):
            fail()

    _CountingOther.calls = 0
    s = svc(backend=Broken(), max_batch=2, failover_backend=_CountingOther())
    tickets = [s.submit(req(i)) for i in range(2)]
    s.flush()
    for t in tickets:
        err = t.exception(timeout=0)
        assert isinstance(err, RuntimeError)
        if fail is not _sticky_cuda_error:
            assert isinstance(err, KernelError)
    assert _CountingOther.calls == 0
    st = s.stats()
    assert st["failed"] == 2 and st["queries"] == 0
    assert st["retries"] == st["failovers"] == st["isolated_queries"] == 0
    assert not obs.get_bus().events(kind="recovery")


def test_poisoned_query_fails_alone_via_isolation():
    """A NaN payload smuggled past admission poisons every whole-chunk
    attempt with non-finite results; isolation serves its three chunk
    mates and fails only the poisoned ticket."""
    bad_W = np.array(news_day(99, 64, 16), dtype=np.float32)
    bad_W[3, 5] = np.nan
    good = [req(i) for i in range(3)]
    ref = svc(max_batch=4).run(good)
    s = svc(max_batch=4, max_retries=0, retry_backoff_s=0.002,
            failover_backend=None, validate_payloads=False)
    tickets = [s.submit(good[0]),
               s.submit(SummarizeRequest(k=4, seed=99, features=bad_W)),
               s.submit(good[1]), s.submit(good[2])]
    s.flush()
    for t, r in zip([tickets[0], tickets[2], tickets[3]], ref):
        resp = t.result(timeout=0)
        assert resp.recovery["isolated"] is True
        assert resp.recovery["stage"] == "isolated"
        assert_same_results(resp, r)
    with pytest.raises(MalformedResult):
        tickets[1].result(timeout=0)
    st = s.stats()
    assert st["isolated_queries"] == 3 and st["failed"] == 1


# ------------------------------------------------- admission + drain ------
@pytest.mark.parametrize("as_tensor", [False, True])
def test_admission_rejects_nonfinite_payload_and_bad_k(as_tensor):
    s = svc(max_batch=4)
    W = np.array(news_day(0, 32, 8), dtype=np.float32)
    W[0, 0] = np.inf
    t_inf = s.submit(SummarizeRequest(
        k=4, seed=0, features=torch.from_numpy(W) if as_tensor else W))
    assert t_inf.done()
    with pytest.raises(ValueError, match="non-finite"):
        t_inf.result()
    t_k = s.submit(req(1, k=0))
    with pytest.raises(ValueError, match="k must be"):
        t_k.result()
    t_seed = s.submit(SummarizeRequest(k=4, seed="seven", features=W[1:]))
    assert t_seed.done() and t_seed.exception() is not None
    good = s.submit(req(2))
    s.flush()
    assert good.result().value > 0
    assert s.stats()["failed"] == 3 and s.stats()["queries"] == 1


@pytest.mark.timeout(120)
def test_drain_timeout_leaves_ticket_pending_not_blocked():
    plan = FaultPlan({0: Fault("latency", delay_s=1.5)})
    cfg = RunConfig(scheduler="async", max_batch=2, max_wait_s=0.01)
    with svc(cfg, faults=plan) as s:
        t = s.submit(req(0))
        with pytest.raises(TimeoutError, match="drain timeout"):
            s.drain(timeout=0.3)
        assert t.state() == "executing" and not t.done()
        with pytest.raises(TicketPending, match="executing"):
            t.result(timeout=0.05)
        s.drain(timeout=60)
        assert t.done() and t.result().value > 0


# --------------------------------------------------------- the chaos pins --
@pytest.mark.timeout(240)
def test_chaos_async_hang_and_errors():
    """A seeded plan injects an exec error and one hung chunk into a
    16-query async trace: zero lost tickets, drain() returns, and every
    query is served, bit-identical to the fault-free run (on the host both
    backends are the plain route)."""
    N, B = 16, 4
    cfg = RunConfig(scheduler="async", max_batch=B, max_wait_s=0.02,
                    retry_backoff_s=0.005, chunk_timeout_s=3.0,
                    failover_backend=OtherBackend())
    reqs = [req(i) for i in range(N)]
    ref = svc(max_batch=B).run(reqs)
    # all 16 submitted at once: full-trigger chunks of 4; chunk 1 errors
    # once then retries clean; chunk 2 hangs (abandoned at 3 s, the worker's
    # 6 s sleep ends after the failover served its tickets)
    plan = FaultPlan({1: Fault("exec_error"), 3: Fault("hang", delay_s=6.0)})
    with svc(cfg, faults=plan) as s:
        tickets = [s.submit(r) for r in reqs]
        s.drain(timeout=200)
        assert all(t.done() for t in tickets)
        out = [t.result(timeout=0) for t in tickets]
    faulted = set()
    for ev in plan.log:
        faulted |= set(ev.tickets)
    assert faulted and faulted <= set(range(N))
    for i, (a, b) in enumerate(zip(out, ref)):
        assert_same_results(a, b)
        assert (a.recovery is not None) == (i in faulted)
    st = s.stats()
    assert st["failed"] == 0 and st["queries"] == N
    assert st["chunk_timeouts"] == 1 and st["retries"] >= 1
    assert st["failovers"] == 1
    (hang_ev,) = plan.events("hang")
    assert len(hang_ev.tickets) == B and hang_ev.stage == "primary"
    # the abandoned attempt wakes, loses every ticket and accounts nothing
    for th in threading.enumerate():
        if th.name == "summarize-chunk":
            th.join(timeout=60)
            assert not th.is_alive()
    assert s.stats()["queries"] == N and s.stats()["batches"] == st["batches"]


@pytest.mark.timeout(240)
@pytest.mark.parametrize("scheduler", ["sync", "async"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_matrix(seed, scheduler):
    """Seeded fault soup across schedulers: no ticket lost, every fault
    attributed to admitted tickets, every served response the fault-free
    one, every failed ticket failed by an injected fault, the books
    balanced."""
    Q = 8
    reqs = [req(i) for i in range(Q)]
    ref = svc(max_batch=4).run(reqs)
    plan = FaultPlan.seeded(seed, n_attempts=64, p_exec_error=0.25,
                            p_latency=0.15, p_malformed=0.1, latency_s=0.01)
    s = svc(max_batch=4, scheduler=scheduler, max_wait_s=0.05,
            retry_backoff_s=0.002, failover_backend=OtherBackend(), faults=plan)
    tickets = [s.submit(r) for r in reqs]
    if scheduler == "sync":
        s.flush()
    else:
        s.drain(timeout=200)
        s.stop()
    assert all(t.done() for t in tickets)
    served = failed = 0
    for t, r in zip(tickets, ref):
        err = t.exception(timeout=0)
        if err is None:
            assert_same_results(t.result(timeout=0), r)
            served += 1
        else:
            assert isinstance(err, (FaultInjected, MalformedResult, ChunkTimeout))
            failed += 1
    st = s.stats()
    assert served + failed == Q
    assert st["queries"] == served and st["failed"] == failed
    for ev in plan.log:
        assert set(ev.tickets) <= set(range(Q))
    if scheduler == "sync":
        assert failed == 0


# ------------------------------------------------------- degradation ladder --
def test_ladder_never_triggered_is_bit_identical():
    reqs = [req(i) for i in range(4)]
    base = svc(max_batch=4).run(reqs)
    lad = svc(max_batch=4, ladder=("stochastic_greedy", "bump_c")).run(reqs)
    for a, b in zip(lad, base):
        assert_same_results(a, b)
        assert a.degradation is None


def test_ladder_force_records_and_is_reproducible():
    """The full ladder, forced by a seeded full-quality estimate far past
    the deadline: the record says what ran, a second service gives the
    same bits, and the bits are ``summarize_batch``'s at the degraded
    config (stochastic selection drawn from ``fold_in(seed, 1)``)."""
    cfg = RunConfig(max_batch=4, ladder=("stochastic_greedy", "bump_c", "shrink_r"))
    reqs = [req(i, n=96, F=16, deadline_s=100.0) for i in range(4)]

    def forced():
        s = svc(cfg)
        s._exec_est[(s._lane(reqs[0]), 0)] = 1e9
        return s

    s = forced()
    out1 = s.run(reqs)
    out2 = forced().run(reqs)
    fn, _ = build_batch_objective(reqs, None, device=CPU)
    res, ss = summarize_batch(fn, 4, [torch.Generator().manual_seed(r.seed) for r in reqs],
                              r=4, c=32.0, selector="stochastic", eps=cfg.eps)
    for b, (a, a2) in enumerate(zip(out1, out2)):
        assert_same_results(a, a2)
        assert torch.equal(a.selected, res.selected[b])
        assert torch.equal(a.gains, res.gains[b])
        assert a.eps_hat == float(ss.eps_hat[b])
    for resp in out1:
        d = resp.degradation
        assert d["steps"] == ("stochastic_greedy", "bump_c", "shrink_r")
        assert d["level"] == 3 and d["reason"] == "deadline"
        assert d["selector"] == "stochastic" and d["r"] == 4 and d["c"] == 32.0
        assert len(resp.selected) == 4 and resp.value > 0
    assert s.stats()["degraded"] == 4


def test_ladder_pressure_degrades_under_load():
    s = svc(max_batch=2, max_pending=4, ladder=("bump_c",), ladder_pressure=0.5)
    tickets = [s.submit(req(i)) for i in range(4)]
    s.flush()
    for t in tickets:
        d = t.result(timeout=0).degradation
        assert d is not None and d["reason"] == "pressure"
        assert d["steps"] == ("bump_c",) and d["c"] == 32.0
    assert s.stats()["degraded"] == 4


def test_ladder_deadline_walk_is_deterministic():
    """The deadline planner, without the wall clock: seed the lane's
    full-quality execution estimate between the deadline and the deadline
    over the first step's predicted ratio, so the walk takes exactly one
    step; the response carries the audit record, the event bus and the
    metrics have it, and the bits are those of the degraded config.  A
    cold lane (no estimate) never degrades."""
    ladder = ("shrink_r", "bump_c")
    s = svc(max_batch=2, ladder=ladder)
    reqs = [req(140 + i, n=96, F=16, deadline_s=100.0) for i in range(2)]
    cold = s.run([req(150, n=96, F=16, deadline_s=100.0)])[0]
    assert cold.degradation is None
    lane = s._lane(reqs[0])
    s._exec_est.pop((lane, 0), None)
    levels = s._ladder_levels(lane)
    ratio = levels[0]["ratio"]
    assert 0.0 < ratio < 1.0
    s._exec_est[(lane, 0)] = 0.5 * (100.0 + 100.0 / ratio)
    out = s.run(reqs)
    for resp in out:
        assert resp.degradation == {"steps": ("shrink_r",), "level": 1, "r": 4,
                                    "c": 8.0, "selector": "greedy",
                                    "reason": "deadline"}
        assert resp.deadline_missed is False
    fn, _ = build_batch_objective(reqs, None, device=CPU)
    res, _ = summarize_batch(fn, 4, [torch.Generator().manual_seed(r.seed)
                                     for r in reqs], r=4)
    for b, resp in enumerate(out):
        assert torch.equal(resp.selected, res.selected[b])
    (ev,) = obs.get_bus().events(kind="degradation")
    assert ev.data["level"] == 1 and ev.data["reason"] == "deadline"
    assert ev.request_ids == (1, 2)
    deg = obs.get_registry().get("repro_service_degraded_chunks_total")
    assert deg.value(level=1, reason="deadline") == 1
    assert s.stats()["degraded"] == 2
    # the degraded chunk seeded the level-1 estimate, which takes over from
    # the predicted ratio: measured far under the budget, the walk stops
    assert s._exec_est[(lane, 1)] < 100.0
    s._exec_est[(lane, 0)] = 1e6
    assert s.run([req(155, n=96, F=16, deadline_s=100.0)])[0].degradation["level"] == 1
    # past the budget, it walks on to the end of the ladder
    s._exec_est[(lane, 1)] = 1e6
    full = s.run([req(160, n=96, F=16, deadline_s=100.0)])[0]
    assert full.degradation["level"] == 2
    assert full.degradation["steps"] == ladder
    assert (full.degradation["r"], full.degradation["c"]) == (4, 32.0)


@pytest.mark.parametrize("ladder", [("bump_c", "shrink_r"),
                                    ("stochastic_greedy", "bump_c", "shrink_r"),
                                    ("shrink_r", "stochastic_greedy")])
@pytest.mark.parametrize("n", [96, 4096])
def test_ladder_levels_equal_the_jax_packages(ladder, n):
    lane = ("coverage", "features", (n, 32), 16, "sqrt", "cosine", True, None)
    ours = SummarizeService(RunConfig(ladder=ladder), device=CPU)._ladder_levels(lane)
    theirs = JSummarizeService(JRunConfig(ladder=ladder))._ladder_levels(lane)
    assert ours == theirs


def test_invalid_config_rejected():
    with pytest.raises(ValueError, match="ladder step"):
        RunConfig(ladder=("warp_speed",))
    with pytest.raises(ValueError, match="ladder_pressure"):
        RunConfig(ladder_pressure=0.0)
    with pytest.raises(ValueError, match="max_retries"):
        RunConfig(max_retries=-1)
    with pytest.raises(ValueError, match="chunk_timeout_s"):
        RunConfig(chunk_timeout_s=0.0)


# ------------------------------------------------------------- crash/restart -
def test_crash_settles_every_ticket_and_poisons_admission():
    s = svc(max_batch=4, faults=FaultPlan({0: Fault("crash")}))
    tickets = [s.submit(req(i)) for i in range(4)]
    s.flush()
    for t in tickets:
        assert t.done()
        assert isinstance(t.exception(timeout=0), ServiceRestarted)
        with pytest.raises(ServiceRestarted):
            t.result(timeout=0)
    st = s.stats()
    assert st["restarts"] == 1 and st["failed"] == 4
    late = s.submit(req(9))
    assert isinstance(late.exception(timeout=0), ServiceRestarted)


@pytest.mark.timeout(120)
def test_crash_async_tickets_never_hang():
    plan = FaultPlan({0: Fault("crash")})
    cfg = RunConfig(scheduler="async", max_batch=2, max_wait_s=0.01)
    with svc(cfg, faults=plan) as s:
        tickets = [s.submit(req(i)) for i in range(2)]
        tickets += [s.submit(req(10 + i, n=32)) for i in range(2)]  # 2nd lane
        s.drain(timeout=60)
        for t in tickets:
            assert t.done()
            assert isinstance(t.exception(timeout=30), ServiceRestarted)


@pytest.mark.timeout(120)
def test_crash_under_concurrent_admission_serves_nothing_after_it():
    """Stress: eight threads submit while the first chunk crashes, with a
    short switch interval.  Every ticket settles with ServiceRestarted:
    none is admitted into the drained queues and served after the crash
    (admission re-checks the crash under the service's lock)."""
    import sys

    cfg = RunConfig(scheduler="async", max_batch=2, max_wait_s=0.001)
    s = svc(cfg, faults=FaultPlan({0: Fault("crash")}))
    tickets, lock = [], threading.Lock()
    W = news_day(0, 32, 8)

    def client(c):
        for i in range(12):
            t = s.submit(SummarizeRequest(k=2, seed=100 * c + i, features=W))
            with lock:
                tickets.append(t)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        s.drain(timeout=60)
    finally:
        sys.setswitchinterval(old)
        s.stop()
    assert len(tickets) == 96
    # concurrent admission numbers every ticket once
    assert sorted(t.index for t in tickets) == list(range(96))
    for t in tickets:
        assert isinstance(t.exception(timeout=30), ServiceRestarted)
    st = s.stats()
    assert st["queries"] == 0 and st["failed"] == 96 and st["restarts"] == 1


def test_restart_settles_in_flight_but_keeps_serving():
    s = svc(max_batch=2, faults=FaultPlan({0: Fault("restart")}))
    first = [s.submit(req(i)) for i in range(2)]
    s.flush()
    for t in first:
        assert isinstance(t.exception(timeout=0), ServiceRestarted)
    out = s.run([req(10 + i) for i in range(2)])
    want = svc(max_batch=2).run([req(10 + i) for i in range(2)])
    for a, b in zip(out, want):
        assert_same_results(a, b)
    assert s.stats()["restarts"] == 1


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()
