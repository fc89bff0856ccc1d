"""The port's SLO-aware async scheduler, Ticket futures, streamed selection
and the ``repro_torch.api`` facade, on the host (``device="cpu"``).

The contracts: scheduling is a pure execution strategy (async responses
equal the sync scheduler's and the single-query pipeline's under the same
seeds, bit for bit, whatever trigger fired the batch); a request whose
budget is already spent fails its own ticket at admission; a deadline
shorter than the first run is served late and flagged; an empty-queue tick
is a no-op; continuous batching refills buckets mid-flight; Ticket is a
real future with per-request error capture; the facade threads RunConfig
end to end and the old spellings warn.  No assertion rests on a wall-clock
comparison: the deadline trigger test's deadline is far below its max_wait.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.data.synthetic import news_day
from repro_torch import FeatureCoverage, api, greedy, ss_sparsify
from repro_torch.serve import (
    DeadlineExceeded,
    RunConfig,
    ServiceOverloaded,
    SummarizeRequest,
    SummarizeService,
)

CPU = "cpu"


def req(i, n=96, F=16, k=4, **kw):
    return SummarizeRequest(k=k, seed=i, features=news_day(i, n, F), **kw)


def serve(**kw):
    return api.serve(RunConfig(**kw), device=CPU)


def assert_matches_sequential(request, resp):
    fn = FeatureCoverage(W=torch.from_numpy(request.features), phi="sqrt")
    ss = ss_sparsify(fn, torch.Generator().manual_seed(request.seed))
    ref = greedy(fn, request.k, alive=ss.vprime)
    assert torch.equal(resp.selected, ref.selected)
    assert torch.equal(resp.gains, ref.gains)
    assert resp.value == float(ref.value)
    assert resp.eps_hat == float(ss.eps_hat) and resp.rounds == ss.rounds


# ------------------------------------------------------------ ticket future --
def test_ticket_future_api():
    s = serve(max_batch=2)
    t = s.submit(req(0))
    assert not t.done() and t.state() == "queued"
    with pytest.raises(TimeoutError):
        t.result(timeout=0)
    s.flush()
    assert t.done() and t.exception() is None and t.state() == "done"
    assert_matches_sequential(req(0), t.result(timeout=0))


def test_malformed_request_fails_own_ticket():
    s = serve(max_batch=4)
    good = s.submit(req(1))
    bad = s.submit(SummarizeRequest(k=4, seed=2))          # no payload
    assert bad.done() and not good.done()
    out = s.flush()
    assert len(out) == 1 and out[0] is not None
    with pytest.raises(ValueError, match="payload"):
        bad.result()
    assert isinstance(bad.exception(), ValueError)
    assert_matches_sequential(req(1), good.result())
    assert s.stats()["failed"] == 1


def test_expired_at_admission():
    s = serve(max_batch=4)
    dead = s.submit(req(3, deadline_s=0.0))
    live = s.submit(req(4, deadline_s=300.0))
    assert dead.done()
    with pytest.raises(DeadlineExceeded):
        dead.result()
    s.flush()
    assert live.result().deadline_missed is False
    assert s.stats()["queries"] == 1


def test_backpressure_max_pending():
    s = serve(max_batch=8, max_pending=2)
    t1, t2, t3 = (s.submit(req(i)) for i in range(3))
    assert not t1.done() and not t2.done() and t3.done()
    with pytest.raises(ServiceOverloaded):
        t3.result()
    s.flush()
    assert t1.result() is not None and t2.result() is not None


def test_execution_error_fails_only_its_chunk():
    s = serve(max_batch=4, failover_backend=None)
    bad = s.submit(SummarizeRequest(k=4, seed=0, features=np.ones((32, 8), np.float32),
                                    objective="nope"))
    good = s.submit(req(5))
    s.flush()
    with pytest.raises(ValueError, match="objective"):
        bad.result()
    assert_matches_sequential(req(5), good.result())


# --------------------------------------------------------- async scheduler --
@pytest.mark.timeout(120)
def test_async_matches_sync_and_sequential():
    """The headline pin: async responses equal the sync scheduler's and
    the single-query pipeline's under the same seeds, bit for bit."""
    reqs = [req(10 + i) for i in range(6)]
    sync = serve(max_batch=4).run(reqs)
    with serve(scheduler="async", max_batch=4, max_wait_s=0.01) as s:
        tickets = [s.submit(r) for r in reqs]
        out = [t.result(timeout=60) for t in tickets]
    for r, a, b in zip(reqs, out, sync):
        assert_matches_sequential(r, a)
        assert torch.equal(a.selected, b.selected) and torch.equal(a.gains, b.gains)
    st = s.stats()
    assert st["queries"] == 6 and st["failed"] == 0


@pytest.mark.timeout(120)
def test_async_flush_on_full_trigger():
    with serve(scheduler="async", max_batch=2, max_wait_s=60.0) as s:
        t1, t2 = s.submit(req(20)), s.submit(req(21))
        r1, r2 = t1.result(timeout=60), t2.result(timeout=60)
    assert r1.trigger == "full" and r2.trigger == "full"
    assert r1.batch_size == 2
    assert_matches_sequential(req(21), r2)


@pytest.mark.timeout(120)
def test_async_max_wait_trigger():
    with serve(scheduler="async", max_batch=8, max_wait_s=0.02) as s:
        resp = s.submit(req(22)).result(timeout=60)
    assert resp.trigger == "max_wait" and resp.batch_size == 1
    assert_matches_sequential(req(22), resp)


@pytest.mark.timeout(120)
def test_async_deadline_trigger_preempts_max_wait():
    with serve(scheduler="async", max_batch=8, max_wait_s=600.0) as s:
        resp = s.submit(req(23, deadline_s=0.1)).result(timeout=60)
    assert resp.trigger == "deadline"
    assert_matches_sequential(req(23), resp)


@pytest.mark.timeout(120)
def test_deadline_shorter_than_first_run_is_flagged_not_dropped():
    with serve(scheduler="async", max_batch=4, max_wait_s=600.0) as s:
        r = req(24, n=80, deadline_s=1e-4)
        resp = s.submit(r).result(timeout=60)
    assert resp.deadline_missed is True and resp.trigger == "deadline"
    assert_matches_sequential(r, resp)
    assert s.stats()["deadlines_missed"] == 1


@pytest.mark.timeout(120)
def test_flusher_tick_with_empty_queue():
    with serve(scheduler="async", max_batch=4, max_wait_s=0.01) as s:
        with s._cond:
            lane, fire_t, trigger = s._next_fire(time.perf_counter())
        assert lane is None and fire_t is None and trigger is None
        s.drain()                          # a drain of an empty queue returns
        time.sleep(0.05)
        assert s.submit(req(25)).result(timeout=60) is not None
    assert s.stats()["batches"] == 1


@pytest.mark.timeout(120)
def test_continuous_batching_refills_mid_flight():
    with serve(scheduler="async", max_batch=2, max_wait_s=0.005) as s:
        reqs = [req(30 + i) for i in range(5)]
        tickets = []
        for r in reqs:
            tickets.append(s.submit(r))
            time.sleep(0.002)
        responses = [t.result(timeout=60) for t in tickets]
    for r, resp in zip(reqs, responses):
        assert_matches_sequential(r, resp)
    st = s.stats()
    assert st["queries"] == 5
    assert all(resp.batch_size <= 2 for resp in responses)
    assert st["batches"] >= 3


@pytest.mark.timeout(120)
def test_async_run_and_stats_triggers():
    with serve(scheduler="async", max_batch=4, max_wait_s=600.0) as s:
        out = s.run([req(40 + i) for i in range(3)])
    assert len(out) == 3
    assert out[0].trigger in ("drain", "full")
    assert sum(s.stats()["triggers"].values()) == s.stats()["batches"]


# ------------------------------------------------------- streamed selection --
def test_stream_steps_tickets_accumulate_partials():
    """stream_steps=True: the ticket's committed prefix is the response's
    selection, and the response is that of the unstreamed service."""
    r = req(60, k=5)
    plain = serve(max_batch=2).run([r])[0]
    s = serve(max_batch=2, stream_steps=True)
    t = s.submit(r)
    assert t.partial() == []
    s.flush()
    resp = t.result()
    assert torch.equal(resp.selected, plain.selected)
    assert torch.equal(resp.gains, plain.gains)
    steps = t.partial()
    assert [v for v, _ in steps] == resp.selected.tolist()
    assert [g for _, g in steps] == resp.gains.tolist()


def test_stream_steps_observed_incrementally():
    done_event = threading.Event()
    s = serve(max_batch=2, stream_steps=True)
    t = s.submit(req(61, k=4))
    prefix_lengths = []

    def poll():
        while not done_event.is_set():
            prefix_lengths.append(len(t.partial()))
            time.sleep(0.0005)

    th = threading.Thread(target=poll)
    th.start()
    s.flush()
    done_event.set()
    th.join()
    assert len(t.partial()) == 4
    assert prefix_lengths == sorted(prefix_lengths)
    assert prefix_lengths[0] < 4


# ------------------------------------------------------------ api facade ----
def test_api_summarize_matches_core():
    W = news_day(70, 96, 16)
    resp = api.summarize(W, k=4, seed=70, device=CPU)
    assert_matches_sequential(SummarizeRequest(k=4, seed=70, features=W), resp)
    resp2 = api.summarize(W, k=4, seed=70, use_ss=False, device=CPU)
    ref2 = greedy(FeatureCoverage(W=torch.from_numpy(W), phi="sqrt"), 4)
    assert torch.equal(resp2.selected, ref2.selected)
    assert resp2.vprime_size is None


@pytest.mark.timeout(120)
def test_api_serve_and_submit_default_service():
    s = api.serve(RunConfig(max_batch=2), device=CPU)
    assert isinstance(s, SummarizeService) and s.config.max_batch == 2
    assert s.device == torch.device(CPU)
    default = api.default_service(device=CPU)
    assert default is api.default_service(device=CPU)
    assert default.config.scheduler == "async"
    t = api.submit(req(71))                    # the process default (async)
    assert_matches_sequential(req(71), t.result(timeout=60))
    assert api.stats()["queries"] >= 1
    with pytest.raises(ValueError, match="already configured"):
        api.default_service(RunConfig(max_batch=3), device=CPU)


def test_service_takes_only_a_runconfig():
    """One config path: a RunConfig, or None for the defaults."""
    assert SummarizeService(device=CPU).config == RunConfig()
    assert SummarizeService(RunConfig(max_batch=2), device=CPU).config.max_batch == 2
    with pytest.raises(TypeError, match="RunConfig"):
        SummarizeService({"max_batch": 2}, device=CPU)
    with pytest.raises(TypeError):
        SummarizeService(RunConfig(), device=CPU, max_batch=2)


def test_runconfig_validates_scheduler():
    with pytest.raises(ValueError, match="scheduler"):
        RunConfig(scheduler="later")
