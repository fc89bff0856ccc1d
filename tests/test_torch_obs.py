"""The port's observability (``repro_torch.obs``), an own copy of the JAX
package's ``repro.obs``, and the telemetry hooks in the port's core and
service.

The pins:

1. **Same plumbing** — the ring log, event bus, tracer and registry unit
   assertions run over both packages' modules, and one sequence of metric
   calls renders the same Prometheus text and JSON in both.
2. **Purity** — SS and greedy results (and the service's responses) are
   bit-identical with tracing on and off; with tracing off no hook runs and
   no telemetry read happens; under a CUDA graph capture the hooks stand
   down.
3. **Fidelity** — the spans' per-round SS records agree with
   ``alive_trace``, the greedy gains with ``GreedyResult.gains``, the
   service's histograms with its own ``stats()``.
4. **One bus** — a seeded chaos run's fault draws and recovery steps land
   on the port's bus with consistent request ids under one ordering.
"""

import importlib
import json
import threading
import time
import urllib.request

import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro import obs as jobs
from repro.data.synthetic import news_day
from repro_torch import (
    FeatureCoverage,
    api,
    greedy,
    greedy_batched,
    obs,
    ss_sparsify,
    ss_sparsify_batched,
)
from repro_torch.serve import (
    FaultPlan,
    RunConfig,
    SummarizeRequest,
    SummarizeService,
)
from repro_torch.serve.summarize_service import ewma_update

# the modules themselves (``repro_torch.core.greedy`` is also a function name)
tgreedy_mod = importlib.import_module("repro_torch.core.greedy")
tsparsify_mod = importlib.import_module("repro_torch.core.sparsify")
CPU = "cpu"
MODULES = {"repro": jobs, "repro_torch": obs}


@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts from empty sinks with tracing off, in both
    packages."""
    for m in MODULES.values():
        m.reset()
        m.configure(trace=False)
    yield
    for m in MODULES.values():
        m.reset()
        m.configure(trace=False)


@pytest.fixture(params=list(MODULES))
def mod(request):
    return MODULES[request.param]


def make_fn(n=128, F=24, seed=0):
    return FeatureCoverage(W=torch.from_numpy(news_day(seed, n, F)), phi="sqrt")


def make_queries(num, n=96, F=16, k=4, seed=0):
    return [SummarizeRequest(k=k, seed=seed * 1000 + i,
                             features=news_day(seed * 1000 + i, n, F))
            for i in range(num)]


def svc(**kw):
    return SummarizeService(RunConfig(**kw), device=CPU)


# ------------------------------------------------------------- ring log ----

def test_ring_log_bounded_with_drop_counter(mod):
    log = mod.RingLog(capacity=4)
    for i in range(10):
        log.append(i)
    assert log.list() == [6, 7, 8, 9]
    assert log.dropped == 6 and len(log) == 4


def test_ring_log_list_compat(mod):
    log = mod.RingLog(capacity=8)
    assert not log and log == []
    for i in range(3):
        log.append(i)
    assert log == [0, 1, 2] and log[1] == 1 and log[-1] == 2
    assert list(log) == [0, 1, 2]
    other = mod.RingLog(capacity=5)
    for i in range(3):
        other.append(i)
    assert log == other
    log.clear()
    assert log == [] and log.dropped == 0
    with pytest.raises(ValueError):
        mod.RingLog(capacity=0)


# ------------------------------------------------------------ event bus ----

def test_bus_ordering_and_filters(mod):
    bus = mod.get_bus()
    bus.emit("fault", subsystem="faults", request_ids=(1, 2), kind_x=1)
    bus.emit("recovery", subsystem="service", request_ids=(2,))
    bus.emit("rehydrate", subsystem="sessions", session_id="u1", n=3)
    seqs = [e.seq for e in bus.events()]
    assert seqs == sorted(seqs) and len(seqs) == 3
    assert [e.kind for e in bus.events(subsystem="service")] == ["recovery"]
    assert [e.kind for e in bus.events(request_id=2)] == ["fault", "recovery"]
    assert bus.events(session_id="u1")[0].data == {"n": 3}
    dump = json.loads(json.dumps(bus.export()))
    assert dump[0]["request_ids"] == [1, 2] and dump[0]["subsystem"] == "faults"


# --------------------------------------------------------------- tracer ----

def test_disabled_spans_are_noops(mod):
    assert not mod.trace_enabled()
    with mod.span("anything", x=1) as sp:
        sp.set(y=2)
    assert mod.get_tracer().spans() == []


def test_span_tree_parenting(mod):
    mod.configure(trace=True)
    tr = mod.get_tracer()
    with tr.span("outer", trace_id="req-0") as outer:
        with tr.span("inner") as inner:
            pass
    spans = tr.spans(trace_id="req-0")
    assert [s.name for s in spans] == ["inner", "outer"]
    assert inner.parent_id == outer.span_id and inner.trace_id == "req-0"
    assert outer.t0 <= inner.t0 and inner.t1 <= outer.t1


def test_error_status_and_retroactive_record(mod):
    mod.configure(trace=True)
    tr = mod.get_tracer()
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("x")
    assert tr.spans(name="boom")[0].status == "error"
    t0 = time.perf_counter() - 0.5
    tr.record("queue.wait", t0, t0 + 0.25, trace_id="req-3", lane="a")
    (sp,) = tr.spans(name="queue.wait")
    assert abs(sp.wall_s - 0.25) < 1e-9 and sp.trace_id == "req-3"


def test_spans_for_request_and_rendering(mod):
    mod.configure(trace=True)
    tr = mod.get_tracer()
    tr.record("request.admit", 0.0, 0.1, trace_id="req-1")
    with tr.span("chunk.exec", trace_id="batch", request_ids=(0, 1)):
        with tr.span("greedy.select", k=5):
            pass
    assert {s.name for s in tr.spans_for_request(1)} == {
        "request.admit", "chunk.exec", "greedy.select"}
    assert tr.spans_for_request(2) == []
    txt = mod.format_trace("req-1")
    assert "chunk.exec" in txt and "greedy.select" in txt and "k=5" in txt
    assert mod.trace_summary().startswith("trace req-1")


def test_tracer_ring_is_bounded(mod):
    mod.configure(trace=True, capacity=8)
    try:
        tr = mod.get_tracer()
        for i in range(20):
            with tr.span(f"s{i}"):
                pass
        assert len(tr.spans()) == 8 and tr.dropped == 12
    finally:
        mod.configure(capacity=mod.trace.DEFAULT_CAPACITY)


# -------------------------------------------------------------- metrics ----

def test_counter_gauge_histogram(mod):
    reg = mod.get_registry()
    c = reg.counter("t_total", "a counter", labels=("kind",))
    c.inc(kind="x")
    c.inc(2, kind="x")
    c.inc(kind="y")
    assert c.value(kind="x") == 3 and c.value(kind="y") == 1
    g = reg.gauge("t_gauge", "a gauge")
    g.set(5)
    g.add(-2)
    assert g.value() == 3
    h = reg.histogram("t_seconds", "a histogram")
    for v in (0.01, 0.02, 0.03):
        h.observe(v)
    st = h.stats()
    assert st["count"] == 3 and abs(st["sum"] - 0.06) < 1e-12
    with pytest.raises(ValueError):
        c.inc(-1, kind="x")


def test_create_or_get_rejects_mismatch(mod):
    reg = mod.get_registry()
    reg.counter("t_total", "c", labels=("a",))
    assert reg.counter("t_total", "c", labels=("a",)) is reg.get("t_total")
    with pytest.raises(ValueError):
        reg.gauge("t_total", "now a gauge?")
    with pytest.raises(ValueError):
        reg.counter("t_total", "c", labels=("b",))


def _metric_calls(reg):
    reg.counter("t_total", "hits", labels=("kind",)).inc(3, kind="x")
    reg.counter("t_total", "hits", labels=("kind",)).inc(kind="y")
    reg.counter("u_total", "unlabelled")
    reg.gauge("t_pending", "queue").set(7)
    h = reg.histogram("t_seconds", "lat", labels=("lane",))
    for v in (0.5, 0.0002, 3.0, 250.0):
        h.observe(v, lane="a")
    h.observe(0.02, lane="b")
    reg.histogram("v_seconds", "custom", buckets=(0.1, 1.0)).observe(0.5)


def test_exposition_equals_the_jax_packages():
    """The same metric calls render the same Prometheus text and JSON."""
    _metric_calls(obs.get_registry())
    _metric_calls(jobs.get_registry())
    text = obs.get_registry().to_prometheus()
    assert text == jobs.get_registry().to_prometheus()
    assert obs.get_registry().to_json() == jobs.get_registry().to_json()
    assert 't_total{kind="x"} 3' in text and 'le="+Inf"' in text
    assert "u_total 0" in text


def test_prometheus_buckets_are_cumulative(mod):
    reg = mod.get_registry()
    reg.histogram("t_seconds", "lat").observe(0.5)
    lines = [ln for ln in reg.to_prometheus().splitlines()
             if "t_seconds_bucket" in ln]
    counts = [int(float(ln.rsplit(" ", 1)[1])) for ln in lines]
    assert counts == sorted(counts) and counts[-1] == 1


def test_pull_endpoint():
    obs.get_registry().counter("t_total", "hits").inc(4)
    try:
        srv = obs.start_metrics_server(port=0)
    except OSError:
        pytest.skip("cannot bind a local port in this sandbox")
    try:
        host, port = srv.server_address[:2]
        text = urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                      timeout=5).read().decode()
        assert "t_total 4" in text
        blob = urllib.request.urlopen(f"http://{host}:{port}/metrics.json",
                                      timeout=5).read().decode()
        assert "t_total" in json.loads(blob)
    finally:
        srv.shutdown()


# ------------------------------------------------- purity and fidelity ----

def _pipeline(fn, seed):
    ss = ss_sparsify(fn, torch.Generator().manual_seed(seed), r=3)
    return ss, greedy(fn, 5, alive=ss.vprime)


def test_results_bit_identical_traced_vs_untraced():
    fn = make_fn()
    ss0, res0 = _pipeline(fn, 0)
    obs.configure(trace=True)
    ss1, res1 = _pipeline(fn, 0)
    assert torch.equal(ss0.vprime, ss1.vprime)
    assert torch.equal(ss0.eps_hat, ss1.eps_hat) and ss0.rounds == ss1.rounds
    assert torch.equal(ss0.alive_trace, ss1.alive_trace)
    assert torch.equal(res0.selected, res1.selected)
    assert torch.equal(res0.gains, res1.gains)
    assert torch.equal(res0.value, res1.value)


def test_span_telemetry_matches_results():
    fn = make_fn()
    obs.configure(trace=True)
    ss, res = _pipeline(fn, 1)
    (sp,) = obs.get_tracer().spans(name="ss.sparsify")
    assert sp.attrs["rounds"] == ss.rounds
    assert sp.attrs["eps_hat"] == float(ss.eps_hat)
    assert sp.attrs["vprime_size"] == int(ss.vprime.sum())
    lives = [int(v) for v in ss.alive_trace if v >= 0]
    detail = sp.attrs["rounds_detail"]
    assert [d["live"] for d in detail] == lives and len(detail) == ss.rounds
    wall = sp.attrs["wall_s"]
    assert sum(d["wall_est_s"] for d in detail) == pytest.approx(wall)
    assert 0.0 < wall <= sp.wall_s
    (gp,) = obs.get_tracer().spans(name="greedy.select")
    assert gp.attrs["gains"] == res.gains.tolist()
    assert gp.attrs["value"] == float(res.value)
    assert gp.attrs["selector"] == "greedy"
    reg = obs.get_registry()
    assert reg.get("repro_ss_wall_seconds").stats(backend="reference")["count"] == 1
    assert reg.get("repro_ss_rounds_total").value(backend="reference") == ss.rounds


def test_batched_spans_match_results():
    Ws = torch.stack([torch.from_numpy(news_day(i, 96, 16)) for i in range(2)])
    fnb = FeatureCoverage(W=Ws, phi="sqrt")
    alive = torch.stack([torch.arange(96) < 70, torch.ones(96, dtype=torch.bool)])
    gens = [torch.Generator().manual_seed(i) for i in range(2)]
    obs.configure(trace=True)
    ss = ss_sparsify_batched(fnb, gens, alive=alive)
    res = greedy_batched(fnb, 4, alive=ss.vprime)
    (sp,) = obs.get_tracer().spans(name="ss.sparsify_batched")
    assert sp.attrs["B"] == 2 and sp.attrs["rounds"] == ss.rounds
    assert sp.attrs["vprime_size"] == ss.vprime.sum(1).tolist()
    assert [d[0]["live"] for d in sp.attrs["rounds_detail"]] == [
        int(ss.alive_trace[b, 0]) for b in range(2)]
    (gp,) = obs.get_tracer().spans(name="greedy.select_batched")
    assert gp.attrs["gains"] == res.gains.tolist()
    assert gp.attrs["value"] == res.value.tolist()


class _Reads(TorchFunctionMode):
    READS = {"item", "tolist", "numpy", "__bool__", "__int__", "__float__",
             "__index__", "cpu"}

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.count += getattr(func, "__name__", "") in self.READS
        return func(*args, **(kwargs or {}))


def test_tracing_off_adds_no_telemetry_read(monkeypatch):
    """Untraced, no hook runs (the recorders would raise) and the pipeline
    makes the same host reads as with the recorders gone; traced, the
    recorders read the results after the loops."""
    fn = make_fn()

    def reads():
        with _Reads() as mode:
            _pipeline(fn, 2)
        return mode.count

    traced_off = reads()
    obs.configure(trace=True)
    traced_on = reads()
    obs.configure(trace=False)
    assert traced_on > traced_off

    def boom(*a, **k):
        raise AssertionError("a telemetry hook ran with tracing off")

    monkeypatch.setattr(tgreedy_mod, "_record_greedy", boom)
    monkeypatch.setattr(tsparsify_mod, "_record_ss", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    assert reads() == traced_off
    res = svc(max_batch=2).run(make_queries(2))
    assert len(res) == 2


def test_hooks_stand_down_under_a_cuda_graph_capture(monkeypatch):
    obs.configure(trace=True)
    assert tgreedy_mod._traceable(torch.device(CPU))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert tgreedy_mod._traceable(torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert not tgreedy_mod._traceable(torch.device("cuda"))
    assert tgreedy_mod._traceable(torch.device(CPU))
    obs.configure(trace=False)
    assert not tgreedy_mod._traceable(torch.device(CPU))


def test_service_results_bit_identical_traced_vs_untraced():
    queries = make_queries(3)
    plain = svc(max_batch=4).run(queries)
    obs.configure(trace=True)
    traced = svc(max_batch=4).run(queries)
    for a, b in zip(plain, traced):
        assert torch.equal(a.selected, b.selected) and torch.equal(a.gains, b.gains)
        assert (a.value, a.eps_hat, a.rounds) == (b.value, b.eps_hat, b.rounds)


# ----------------------------------------------- service-layer metrics ----

def test_histograms_agree_with_stats():
    s = svc(max_batch=4)
    s.run(make_queries(6))
    st = s.stats()
    reg = obs.get_registry()
    assert reg.get("repro_service_queries_total").value() == st["queries"]
    assert sum(reg.get("repro_service_batches_total").value(trigger=t)
               for t in st["triggers"]) == st["batches"]
    ex = reg.get("repro_service_exec_seconds")
    assert abs(sum(v["sum"] for v in ex.snapshot().values())
               - st["exec_s_total"]) < 1e-9
    qd = reg.get("repro_service_queue_delay_seconds")
    assert sum(v["count"] for v in qd.snapshot().values()) == st["queries"]
    slots = reg.get("repro_service_slots_total").value()
    padded = reg.get("repro_service_padded_slots_total").value()
    assert st["padding_waste_frac"] == padded / slots
    assert reg.get("repro_service_requests_total").value(
        outcome="admitted") == st["queries"]
    assert reg.get("repro_service_degradation_level_total").value(level=0) == 6


def test_request_spans_cover_the_request():
    obs.configure(trace=True)
    responses = svc(max_batch=4).run(make_queries(3))
    for i, resp in enumerate(responses):
        spans = obs.get_tracer().spans_for_request(i)
        names = [s.name for s in spans]
        for want in ("request.admit", "queue.wait", "chunk.exec",
                     "ss.sparsify_batched", "greedy.select_batched"):
            assert want in names, want
        (wait,) = [s for s in spans if s.name == "queue.wait"]
        assert abs(wait.wall_s - resp.queue_delay_s) < 0.05


def test_api_stats_and_metrics():
    s = svc(max_batch=2)
    s.run(make_queries(2))
    assert api.stats(s) == s.stats()
    text = api.metrics()
    assert isinstance(text, str) and "repro_service_queries_total" in text
    assert "repro_service_queries_total" in api.metrics(fmt="json")
    with pytest.raises(ValueError):
        api.metrics(fmt="yaml")


@pytest.mark.timeout(120)
def test_stats_snapshot_is_consistent_under_load():
    queries = make_queries(8)
    s = svc(max_batch=4, scheduler="async", max_wait_s=0.01)
    snaps = []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            snaps.append(s.stats())

    t = threading.Thread(target=hammer)
    t.start()
    try:
        with s:
            for q in queries:
                s.submit(q)
            s.drain(timeout=60)
    finally:
        stop.set()
        t.join()
    snaps.append(s.stats())
    seen = 0
    for st in snaps:
        assert st["queries"] >= seen
        seen = st["queries"]
        if st["queries"]:
            assert st["queue_delay_s_mean"] <= st["queue_delay_s_max"] + 1e-12
    assert snaps[-1]["queries"] == len(queries)


# ----------------------------------------------------------------- ewma ----

def test_ewma_helper():
    assert ewma_update(None, 0.25) == 0.25
    est = None
    for _ in range(20):
        est = ewma_update(est, 0.05)
    assert abs(est - 0.05) < 1e-9
    est = None
    for v in [0.5, 0.4] + [0.1] * 18:
        est = ewma_update(est, v)
    assert abs(est - 0.1) < 1e-3
    assert ewma_update(0.2, 0.1) == pytest.approx(0.15)


def test_service_estimate_matches_replayed_ewma():
    s = svc(max_batch=4)
    responses = s.run(make_queries(8))
    exec_by_chunk: list[float] = []
    for r in responses:
        if not exec_by_chunk or exec_by_chunk[-1] != r.exec_s:
            exec_by_chunk.append(r.exec_s)
    assert len(exec_by_chunk) == s.stats()["batches"]
    expected = None
    for e in exec_by_chunk:
        expected = ewma_update(expected, e)
    (key,) = [k for k in s._exec_est if k[1] == 0]
    assert s._exec_est[key] == pytest.approx(expected)


# ---------------------------------------------------------- unified bus ----

def test_chaos_run_lands_on_one_bus_with_consistent_ids():
    queries = make_queries(8)
    plan = FaultPlan.seeded(0, n_attempts=64, p_exec_error=0.3, p_latency=0.2,
                            latency_s=0.005)
    s = SummarizeService(RunConfig(max_batch=4), faults=plan, device=CPU)
    assert len(s.run(queries)) == len(queries)
    bus = obs.get_bus()
    faults = bus.events(kind="fault", subsystem="faults")
    recoveries = bus.events(kind="recovery", subsystem="service")
    assert faults and recoveries
    assert len(faults) == len(plan.log)
    for ev, legacy in zip(faults, plan.log):
        assert ev.data["fault_kind"] == legacy.fault.kind
        assert ev.data["attempt"] == legacy.attempt
        assert tuple(legacy.tickets) == ev.request_ids
    valid = set(range(len(queries)))
    for ev in faults + recoveries:
        assert set(ev.request_ids) <= valid
    for rec in recoveries:
        assert [f for f in faults
                if f.seq < rec.seq and set(f.request_ids) & set(rec.request_ids)]
    seqs = [e.seq for e in bus.events()]
    assert seqs == sorted(seqs)
    reg = obs.get_registry()
    assert sum(reg.get("repro_faults_injected_total").value(kind=k)
               for k in {e.data["fault_kind"] for e in faults}) == len(faults)
    retr = reg.get("repro_service_retries_total")
    assert sum(retr.snapshot().values()) == s.stats()["retries"]
    assert jobs.get_bus().events() == []          # the JAX package's bus is apart
