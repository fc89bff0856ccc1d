"""The port's summarization service held to the port's own batched core and
single-query runs, and to the JAX package's service where no draw is
involved.

The contract: batching is a pure execution strategy.  Each response's
``selected``, ``gains``, ``value``, ``vprime_size``, ``eps_hat`` and
``rounds`` equal the single-query pipeline (``ss_sparsify`` then ``greedy``)
under the same seed, bit for bit (``torch.equal``), whatever the batch held,
however it was padded.  Queries carry int seeds or ``torch.Generator``s; the
service takes a seed's draw state at admission, so padding rows never
advance row 0's stream.  ``use_ss=False`` lanes draw nothing and select the
JAX service's elements.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro.data.synthetic import news_day
from repro.serve import RunConfig as JRunConfig
from repro.serve import SummarizeRequest as JSummarizeRequest
from repro.serve import SummarizeService as JSummarizeService
from repro.serve import batch_buckets as jbatch_buckets
from repro_torch import (
    FacilityLocation,
    FeatureCoverage,
    greedy,
    ss_sparsify,
)
from repro_torch.serve import (
    RunConfig,
    SummarizeRequest,
    SummarizeService,
    batch_buckets,
    build_batch_objective,
    summarize_batch,
)

CPU = "cpu"


def svc(**kw):
    return SummarizeService(RunConfig(**kw), device=CPU)


def creq(i, n=128, F=24, k=4, **kw):
    return SummarizeRequest(k=k, seed=i, features=news_day(i, n, F), **kw)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def single(fn, k, seed, alive=None, use_ss=True):
    """The single-query pipeline on the host under ``seed``."""
    if not use_ss:
        return greedy(fn, k, alive=alive), None
    ss = ss_sparsify(fn, seed if isinstance(seed, torch.Generator) else _gen(seed),
                     alive=alive)
    return greedy(fn, k, alive=ss.vprime), ss


def assert_equal_single(resp, res, ss):
    assert torch.equal(resp.selected, res.selected)
    assert torch.equal(resp.gains, res.gains)
    assert resp.value == float(res.value)
    if ss is None:
        assert resp.vprime_size is None and resp.eps_hat is None
        assert resp.rounds is None
    else:
        assert resp.vprime_size == int(ss.vprime.sum())
        assert resp.eps_hat == float(ss.eps_hat)
        assert resp.rounds == ss.rounds


def coverage(req):
    return FeatureCoverage(W=torch.from_numpy(np.asarray(req.features)), phi="sqrt")


def test_service_mixed_lanes_match_sequential():
    """One flush with two lanes (mixed n and k) and a batch that pads 5 up
    to 8: every response equals its single-query run bit for bit."""
    s = svc(max_batch=8)
    reqs = ([creq(i) for i in range(5)]
            + [SummarizeRequest(k=3, seed=100 + i, features=news_day(50 + i, 96, 16))
               for i in range(3)])
    out = s.run(reqs)
    for req, resp in zip(reqs, out):
        assert_equal_single(resp, *single(coverage(req), req.k, req.seed))
    st = s.stats()
    assert st["queries"] == 8 and st["batches"] == 2
    assert st["compiled_signatures"] == 2
    # lane 1 pads 5 -> 8, lane 2 pads 3 -> 4: 4 of 12 slots
    assert st["padding_waste_frac"] == pytest.approx(4 / 12)
    assert st["queue_delay_s_max"] >= st["queue_delay_s_mean"] >= 0.0
    assert all(r.batch_bucket >= r.batch_size for r in out)
    assert all(r.recovery is None and r.degradation is None for r in out)


def test_service_rows_equal_summarize_batch():
    """The service's responses are the rows of the port's ``summarize_batch``
    on the same stacked objective under the same seeds."""
    reqs = [creq(10 + i) for i in range(4)]
    out = svc(max_batch=4).run(reqs)
    fn, alive = build_batch_objective(reqs, None, device=CPU)
    res, ss = summarize_batch(fn, 4, [_gen(r.seed) for r in reqs])
    for b, resp in enumerate(out):
        assert torch.equal(resp.selected, res.selected[b])
        assert torch.equal(resp.gains, res.gains[b])
        assert resp.value == float(res.value[b])
        assert resp.eps_hat == float(ss.eps_hat[b]) and resp.rounds == ss.rounds[b]
        assert resp.vprime_size == int(ss.vprime[b].sum())


def test_service_fl_and_no_ss_lanes():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((120, 12)).astype(np.float32)
    s = svc()
    out = s.run([
        SummarizeRequest(k=5, seed=7, features=X, objective="fl"),
        SummarizeRequest(k=5, seed=8, features=np.abs(X), use_ss=False),
    ])
    fl = FacilityLocation.from_features(torch.from_numpy(X), kernel="cosine")
    assert_equal_single(out[0], *single(fl, 5, 7))
    fc = FeatureCoverage(W=torch.from_numpy(np.abs(X)), phi="sqrt")
    assert_equal_single(out[1], *single(fc, 5, 8, use_ss=False))
    # a precomputed-sim payload lane
    out2 = s.run([SummarizeRequest(k=4, seed=9, sim=fl.sim.numpy(), objective="fl")])
    assert_equal_single(out2[0], *single(fl, 4, 9))


def test_service_fl_sim_and_feature_payloads_do_not_collide():
    """A (n, n) sim payload and a (n, n) *feature* payload are two lanes."""
    rng = np.random.default_rng(4)
    X = np.abs(rng.standard_normal((48, 48))).astype(np.float32)
    fl = FacilityLocation.from_features(torch.from_numpy(X), kernel="cosine")
    s = svc()
    out = s.run([
        SummarizeRequest(k=4, seed=1, features=X, objective="fl"),
        SummarizeRequest(k=4, seed=2, sim=fl.sim.numpy(), objective="fl"),
    ])
    assert s.stats()["batches"] == 2
    assert_equal_single(out[0], *single(fl, 4, 1))
    assert_equal_single(out[1], *single(fl, 4, 2))


def test_service_n_padding_fl_padding_is_inert():
    """Padded fl queries: the sim's padded rows and columns are zero.  The
    response equals the single run on the sim the service builds (the rbf
    bandwidth reads the padded rows too) bit for bit, and selects what the
    reference's test pins, the run on the zero-padded unpadded sim."""
    rng = np.random.default_rng(6)
    X = np.abs(rng.standard_normal((50, 8))).astype(np.float32)
    out = svc(n_buckets=(64,), max_batch=4).run(
        [SummarizeRequest(k=4, seed=5, features=X, objective="fl", kernel="rbf")])[0]
    live = torch.arange(64) < 50
    Xp = torch.from_numpy(np.pad(X, ((0, 14), (0, 0))))
    built = FacilityLocation.from_features(Xp, kernel="rbf").sim
    built = built * (live[:, None] & live[None, :]).float()
    assert_equal_single(out, *single(FacilityLocation(sim=built), 4, 5, alive=live))
    sim = FacilityLocation.from_features(torch.from_numpy(X), kernel="rbf").sim
    fnp = FacilityLocation(sim=torch.nn.functional.pad(sim, (0, 14, 0, 14)))
    assert torch.equal(out.selected, single(fnp, 4, 5, alive=live)[0].selected)
    assert bool((out.selected < 50).all())


def test_service_tickets_and_submission_order():
    s = svc(max_batch=2)
    reqs = [creq(i, n=96, F=16) for i in range(3)]
    tickets = [s.submit(r) for r in reqs]
    assert not any(t.done() for t in tickets)
    out = s.flush()
    assert all(t.done() for t in tickets)
    assert [t.result() for t in tickets] == out      # submission order
    assert s.flush() == []                           # queue drained


def test_service_n_padding_collapses_lanes():
    """Ground-set padding: distinct n share one signature; pure-greedy
    queries are padding-invariant; an n above every bucket is refused."""
    s = svc(n_buckets=(128,), max_batch=4)
    reqs = [SummarizeRequest(k=4, seed=i, features=news_day(i, n, 16), use_ss=False)
            for i, n in enumerate((100, 111, 128))]
    out = s.run(reqs)
    assert s.stats()["compiled_signatures"] == 1
    for req, resp in zip(reqs, out):
        res, _ = single(coverage(req), 4, 0, use_ss=False)
        assert torch.equal(resp.selected, res.selected)
        assert torch.equal(resp.gains, res.gains)
    with pytest.raises(ValueError, match="n bucket"):
        s.run([SummarizeRequest(k=4, seed=9, features=np.zeros((300, 16), np.float32))])


def test_service_n_padding_ss_matches_padded_sequential():
    W = news_day(0, 100, 16)
    out = svc(n_buckets=(128,)).run([SummarizeRequest(k=5, seed=3, features=W)])[0]
    fnp = FeatureCoverage(W=torch.from_numpy(np.pad(W, ((0, 28), (0, 0)))), phi="sqrt")
    assert_equal_single(out, *single(fnp, 5, 3, alive=torch.arange(128) < 100))
    assert bool((out.selected < 100).all())


def test_batch_buckets_match_the_jax_package():
    for mb in (1, 3, 8, 16):
        assert batch_buckets(mb) == jbatch_buckets(mb)
        bks = batch_buckets(mb)
        assert bks[0] == mb and bks[-1] == 1


def test_use_ss_false_lanes_select_the_jax_services_elements():
    """No draw is involved without SS: the port's service selects the JAX
    service's elements, with gains to rtol 1e-4."""
    reqs = [(i, news_day(i, 96, 16)) for i in range(3)]
    out = svc(max_batch=4).run(
        [SummarizeRequest(k=5, seed=i, features=W, use_ss=False) for i, W in reqs])
    jout = JSummarizeService(JRunConfig(backend="oracle", max_batch=4)).run(
        [JSummarizeRequest(k=5, key=i, features=jnp.asarray(W), use_ss=False)
         for i, W in reqs])
    for a, b in zip(out, jout):
        np.testing.assert_array_equal(a.selected.numpy(), np.asarray(b.selected))
        np.testing.assert_allclose(a.gains.numpy(), np.asarray(b.gains), rtol=1e-4)
        np.testing.assert_allclose(a.value, b.value, rtol=1e-4)
        assert a.vprime_size is None and b.vprime_size is None


def test_generator_seed_is_taken_at_admission():
    """A ``torch.Generator`` seed: the response equals the single run from
    that generator's state at submission, and drawing from the caller's
    generator after submission changes nothing."""
    req_g = _gen(21)
    torch.rand(5, generator=req_g)                 # a stream already in use
    want_g = torch.Generator()
    want_g.set_state(req_g.get_state())
    s = svc()
    t = s.submit(SummarizeRequest(k=4, seed=req_g, features=news_day(21, 96, 16)))
    torch.rand(7, generator=req_g)                 # the caller draws on
    s.flush()
    fn = FeatureCoverage(W=torch.from_numpy(news_day(21, 96, 16)), phi="sqrt")
    assert_equal_single(t.result(), *single(fn, 4, want_g))


@pytest.mark.parametrize("seed_kind", ["int", "generator"])
def test_pad_rows_leave_row_zero_unchanged(seed_kind):
    """3 queries pad to bucket 4 by repeating row 0: row 0's bits equal its
    run alone (bucket 1), with an int seed and with a generator."""
    def seed(i):
        return 30 + i if seed_kind == "int" else _gen(30 + i)

    reqs = [SummarizeRequest(k=4, seed=seed(i), features=news_day(30 + i, 96, 16))
            for i in range(3)]
    out = svc(max_batch=4).run(reqs)
    assert out[0].batch_bucket == 4 and out[0].batch_size == 3
    alone = svc(max_batch=4).run([SummarizeRequest(
        k=4, seed=seed(0), features=news_day(30, 96, 16))])[0]
    assert alone.batch_bucket == 1
    a, b = out[0], alone
    assert torch.equal(a.selected, b.selected) and torch.equal(a.gains, b.gains)
    assert (a.value, a.eps_hat, a.rounds, a.vprime_size) == (
        b.value, b.eps_hat, b.rounds, b.vprime_size)


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


class _Nonzero(TorchDispatchMode):
    """Counts ``nonzero`` (its output size depends on the data)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func is torch.ops.aten.nonzero.default
        return func(*args, **(kwargs or {}))


def _reads(call) -> int:
    with _HostReads() as fmode, _Nonzero() as dmode:
        call()
    return fmode.count + dmode.count


@pytest.mark.parametrize("B", [1, 2, 4])
def test_a_chunks_host_reads_do_not_grow_with_the_batch(B):
    """A chunk reads its results in one transfer: a flush makes exactly one
    host read more than ``summarize_batch`` on the same batch, for every B
    (the reference reads 4 values a row)."""
    reqs = [creq(40 + i, n=96, F=16) for i in range(B)]
    s = svc(max_batch=4)
    for r in reqs:
        s.submit(r)
    flush_reads = _reads(s.flush)
    bucket = min(b for b in batch_buckets(4) if b >= B)
    padded = reqs + [reqs[0]] * (bucket - B)

    def core():
        fn, alive = build_batch_objective(padded, None, device=CPU)
        summarize_batch(fn, 4, [_gen(r.seed) for r in padded])

    assert flush_reads - _reads(core) == 1
