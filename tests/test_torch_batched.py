"""The port's batched SS and greedy held against the JAX package's batched
oracle and against the port's own single-query runs.

The JAX batched loop draws row b's round-j Gumbel noise from the j-th split
of ``keys[b]``, exactly as its single-query loop does (a frozen row does not
split), and stochastic greedy's step-i draw from the i-th key of
``split(key_b, k)``.  ``_ss_noise`` / ``_sg_noise`` rebuild those draws with
JAX and hand them to the port as ``noise``.  Against JAX: ``vprime``,
``rounds``, ``alive_trace`` and ``selected`` identical, ``eps_hat`` to rtol
1e-5, gains to rtol 1e-5 / atol 1e-6 (the port's SS tests' tolerances).
Against the port's single-query runs on ``fn.row(b)`` under the same draws:
``torch.equal`` on every field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FacilityLocation as JFacilityLocation
from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import StreamingFacilityLocation as JStreamingFacilityLocation
from repro.core import greedy_batched as jgreedy_batched
from repro.core import graph as jgraph
from repro.core import ss_sparsify_batched as jss_sparsify_batched
from repro.core import stochastic_greedy_batched as jstochastic_greedy_batched
from repro.data.synthetic import news_day
from repro.serve import SummarizeRequest as JSummarizeRequest
from repro.serve import summarize_batch as jsummarize_batch
from repro.serve.summarize_service import build_batch_objective as jbuild_batch_objective
from repro_torch import (
    FacilityLocation,
    FeatureCoverage,
    StreamingFacilityLocation,
    greedy,
    greedy_batched,
    ss_sparsify,
    ss_sparsify_batched,
    stochastic_greedy,
    stochastic_greedy_batched,
)
from repro_torch.core import (
    CudaBackend,
    ReferenceBackend,
    divergence_compact,
    max_rounds,
    ss_live_bound,
)
from repro_torch.core.greedy import _batched_compact_plan
from repro_torch.serve import (
    RunConfig,
    SummarizeRequest,
    batch_buckets,
    build_batch_objective,
    summarize_batch,
)
from repro_torch.serve.summarize_service import fold_generators, fold_in


def _chain(key, n, rounds):
    rows = []
    for _ in range(rounds):
        key, k1 = jax.random.split(key)
        rows.append(np.asarray(jax.random.gumbel(k1, (n,))))
    return np.stack(rows)


def _ss_noise(keys, n, rounds):
    """(B, rounds, n): row b's draws, round by round, from keys[b]."""
    return torch.from_numpy(np.stack([_chain(kk, n, rounds) for kk in keys]))


def _sg_noise(keys, k, width):
    """(k, B, width): row b's step-i draw from split(keys[b], k)[i]."""
    rows = [np.stack([np.asarray(jax.random.gumbel(kk, (width,)))
                      for kk in jax.random.split(key, k)]) for key in keys]
    return torch.from_numpy(np.stack(rows, axis=1))


def _fc_batch(B=3, n=256, F=64, seed=0):
    Ws = np.stack([news_day(seed + i, n, F) for i in range(B)])
    return JFeatureCoverage(W=jnp.asarray(Ws), phi="sqrt"), FeatureCoverage(
        W=torch.from_numpy(Ws), phi="sqrt")


def _fl_batch(B=3, n=200):
    Xs = jnp.stack([jax.random.normal(jax.random.PRNGKey(10 + i), (n, 12))
                    for i in range(B)])
    sims = jax.vmap(lambda X: JFacilityLocation.from_features(X, kernel="cosine").sim)(Xs)
    return JFacilityLocation(sim=sims), FacilityLocation(
        sim=torch.from_numpy(np.array(sims)))


def _same_ss_jax(jss, tss):
    np.testing.assert_array_equal(tss.vprime.numpy(), np.asarray(jss.vprime))
    assert tss.rounds == [int(x) for x in np.asarray(jss.rounds)]
    np.testing.assert_array_equal(tss.alive_trace.numpy(), np.asarray(jss.alive_trace))
    np.testing.assert_allclose(tss.eps_hat.numpy(), np.asarray(jss.eps_hat), rtol=1e-5)


def _same_greedy_jax(jres, tres):
    np.testing.assert_array_equal(tres.selected.numpy(), np.asarray(jres.selected))
    np.testing.assert_allclose(tres.gains.numpy(), np.asarray(jres.gains),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tres.value.numpy(), np.asarray(jres.value), rtol=1e-5)


def _equal_rows(batched, singles):
    """Row b of a batched result equals the b-th single-query result."""
    for b, one in enumerate(singles):
        for field in one._fields:
            got, want = getattr(batched, field), getattr(one, field)
            if field == "rounds":
                assert got[b] == want, (b, field)
            elif field != "divergence":   # stale off the live set by design
                assert torch.equal(got[b], want), (b, field)


def _seq_ss(fnb, noise, **kw):
    return [ss_sparsify(fnb.row(b), noise=noise[b],
                        **{k: (v[b] if k in ("alive", "state") else v)
                           for k, v in kw.items()})
            for b in range(fnb.batch)]


@pytest.mark.parametrize("objective", ["coverage", "fl"])
def test_batched_ss_and_greedy_match_jax_and_sequential(objective):
    jfnb, tfnb = _fc_batch() if objective == "coverage" else _fl_batch()
    k = 8 if objective == "coverage" else 6
    n = tfnb.row(0).n
    keys = jax.random.split(jax.random.PRNGKey(0 if objective == "coverage" else 1), 3)
    jss = jss_sparsify_batched(jfnb, keys, backend="oracle")
    jgb = jgreedy_batched(jfnb, k, alive=jss.vprime, backend="oracle")
    noise = _ss_noise(keys, n, max_rounds(n))
    tss = ss_sparsify_batched(tfnb, noise=noise)
    tgb = greedy_batched(tfnb, k, alive=tss.vprime)
    _same_ss_jax(jss, tss)
    _same_greedy_jax(jgb, tgb)
    assert max(tss.rounds) > 0
    seq = _seq_ss(tfnb, noise)
    _equal_rows(tss, seq)
    _equal_rows(tgb, [greedy(tfnb.row(b), k, alive=seq[b].vprime) for b in range(3)])


def test_batched_ss_rows_freeze_independently():
    """Row 0 starts nearly empty and finishes at once; row 1 runs on.  The
    frozen row draws nothing, so row 1 reads its own rounds 0, 1, ... ."""
    jfnb, tfnb = _fc_batch(B=2, n=256, F=32, seed=7)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    alive = np.stack([np.arange(256) < 20, np.ones(256, bool)])
    jss = jss_sparsify_batched(jfnb, keys, alive=jnp.asarray(alive))
    noise = _ss_noise(keys, 256, max_rounds(256))
    tss = ss_sparsify_batched(tfnb, noise=noise, alive=torch.from_numpy(alive))
    _same_ss_jax(jss, tss)
    assert tss.rounds[0] == 0 < tss.rounds[1]
    _equal_rows(tss, _seq_ss(tfnb, noise, alive=torch.from_numpy(alive)))


def test_batched_ss_rows_that_freeze_at_different_rounds_draw_their_own_streams():
    """Rows of different live counts finish at different rounds: each row
    under a generator consumes it exactly as the single-query loop does."""
    _, tfnb = _fc_batch(B=3, n=512, F=32, seed=13)
    alive = torch.stack([torch.arange(512) < m for m in (512, 180, 300)])
    gens = [torch.Generator().manual_seed(40 + b) for b in range(3)]
    tss = ss_sparsify_batched(tfnb, gens, alive=alive)
    assert len(set(tss.rounds)) > 1
    seq = [ss_sparsify(tfnb.row(b), torch.Generator().manual_seed(40 + b),
                       alive=alive[b]) for b in range(3)]
    _equal_rows(tss, seq)
    # and each generator stands where the single-query run left its own
    for b in range(3):
        again = torch.Generator().manual_seed(40 + b)
        ss_sparsify(tfnb.row(b), again, alive=alive[b])
        assert torch.equal(torch.rand(4, generator=gens[b]), torch.rand(4, generator=again))


def test_batched_ss_importance_and_state():
    jfnb, tfnb = _fc_batch(B=2, n=200, F=32, seed=11)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    mask = np.arange(200) < 3
    jst = jnp.stack([jfnb.W[i][:3].sum(0) for i in range(2)])
    tst = torch.stack([tfnb.row(b).add_many(tfnb.row(b).empty_state(),
                                            torch.from_numpy(mask)) for b in range(2)])
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=1e-6)
    jss = jss_sparsify_batched(jfnb, keys, state=jst, importance=True)
    noise = _ss_noise(keys, 200, max_rounds(200))
    tss = ss_sparsify_batched(tfnb, noise=noise, state=torch.from_numpy(np.array(jst)),
                              importance=True)
    _same_ss_jax(jss, tss)
    _equal_rows(tss, _seq_ss(tfnb, noise, state=torch.from_numpy(np.array(jst)),
                             importance=True))


@pytest.mark.parametrize("compact", [True, False])
def test_divergence_batched_rows_equal_the_single_query_divergence(compact):
    jfnb, tfnb = _fc_batch(B=2, n=300, F=48, seed=19)
    rng = np.random.default_rng(0)
    probes = np.stack([rng.choice(300, 24, replace=False) for _ in range(2)])
    cand = np.stack([np.sort(rng.choice(300, 100, replace=False)) for _ in range(2)])
    tp, tc = torch.from_numpy(probes), torch.from_numpy(cand) if compact else None
    got = ReferenceBackend().divergence_batched(tfnb, tp, tc)
    want = jgraph.divergence_batched(jfnb, jnp.asarray(probes),
                                     jnp.asarray(cand) if compact else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for b in range(2):
        f = tfnb.row(b)
        one = (divergence_compact(f, tp[b], tc[b]) if compact
               else ReferenceBackend().divergence(f, tp[b]))
        assert torch.equal(got[b], one)
    # only some rows: positions follow ``rows``
    part = ReferenceBackend().divergence_batched(tfnb, tp[1:],
                                                 None if tc is None else tc[1:], rows=[1])
    assert torch.equal(part[0], got[1])


def test_greedy_batched_edge_cases():
    jfnb, tfnb = _fc_batch(B=2, n=128, F=24, seed=21)
    alive = np.stack([np.arange(128) < 3, np.arange(128) < 60])
    ta = torch.from_numpy(alive)
    jgb = jgreedy_batched(jfnb, 6, alive=jnp.asarray(alive))
    tgb = greedy_batched(tfnb, 6, alive=ta)
    _same_greedy_jax(jgb, tgb)
    _equal_rows(tgb, [greedy(tfnb.row(b), 6, alive=ta[b]) for b in range(2)])
    assert (tgb.selected[0, 3:] == 0).all() and (tgb.gains[0, 3:] == 0).all()

    states = torch.stack([tfnb.row(b).add_many(tfnb.row(b).empty_state(),
                                               torch.arange(128) < 2) for b in range(2)])
    jst = jnp.asarray(states.numpy())
    _same_greedy_jax(jgreedy_batched(jfnb, 4, alive=jnp.asarray(alive), state=jst),
                     greedy_batched(tfnb, 4, alive=ta, state=states))
    _equal_rows(greedy_batched(tfnb, 4, alive=ta, state=states),
                [greedy(tfnb.row(b), 4, alive=ta[b], state=states[b]) for b in range(2)])

    with pytest.raises(ValueError, match="live bound"):
        greedy_batched(tfnb, 4, alive=ta, compact=10)
    with pytest.raises(ValueError, match="alive mask"):
        greedy_batched(tfnb, 4, alive=ta[0])


def test_greedy_batched_full_width_and_bound():
    jfnb, tfnb = _fc_batch(B=2, n=128, F=24, seed=31)
    _same_greedy_jax(jgreedy_batched(jfnb, 5), greedy_batched(tfnb, 5))
    _equal_rows(greedy_batched(tfnb, 5), [greedy(tfnb.row(b), 5) for b in range(2)])
    alive = torch.stack([torch.arange(128) < 40, torch.arange(128) < 25])
    auto = greedy_batched(tfnb, 5, alive=alive)
    bound = greedy_batched(tfnb, 5, alive=alive, compact=ss_live_bound(128))
    full = greedy_batched(tfnb, 5, alive=alive, compact=False)
    assert torch.equal(auto.selected, bound.selected)
    assert torch.equal(auto.selected, full.selected)


def test_greedy_batched_compacts_into_the_batch_bucket():
    """Rows of different live counts share the bucket of the largest; each
    row still selects what its own bucket gives."""
    _, tfnb = _fc_batch(B=3, n=1024, F=32, seed=33)
    alive = torch.stack([torch.arange(1024) % m == 0 for m in (3, 9, 40)])
    size, live = _batched_compact_plan(1024, alive, None)
    assert (size, live) == (384, 342)
    res = greedy_batched(tfnb, 7, alive=alive)
    _equal_rows(res, [greedy(tfnb.row(b), 7, alive=alive[b]) for b in range(3)])


def test_greedy_batched_on_step_matches_the_unstreamed_call():
    Ws = np.stack([news_day(50 + i, 96, 16) for i in range(2)])
    fnb = FeatureCoverage(W=torch.from_numpy(Ws))
    alive = torch.stack([torch.arange(96) < 80, torch.arange(96) < 3])
    ref = greedy_batched(fnb, 5, alive=alive)
    seen = []
    res = greedy_batched(fnb, 5, alive=alive,
                         on_step=lambda i, v, g, ok: seen.append((i, v, g, ok)))
    for field in ("selected", "gains", "value", "state"):
        assert torch.equal(getattr(res, field), getattr(ref, field))
    assert [s[0] for s in seen] == list(range(5))
    for i, v, g, ok in seen:
        assert torch.equal(v, ref.selected[:, i]) and torch.equal(g, ref.gains[:, i])
    assert [bool(s[3][1]) for s in seen] == [True] * 3 + [False] * 2
    # the reference streams the same steps
    jseen = []
    jgreedy_batched(JFeatureCoverage(W=jnp.asarray(Ws)), 5,
                    alive=jnp.asarray(alive.numpy()),
                    on_step=lambda i, v, g, ok: jseen.append(np.asarray(v)))
    np.testing.assert_array_equal(np.stack(jseen, 1), ref.selected.numpy())


@pytest.mark.parametrize("where", ["V", "alive"])
def test_stochastic_greedy_batched_matches_jax_and_the_dense_call(where):
    """Under the same plan (one bucket for every row: live counts 100, 120
    and 90 of 1024 all take the 128 bucket) and the same draws."""
    jfnb, tfnb = _fc_batch(B=3, n=1024, F=32, seed=17)
    k, s = 6, 20
    alive = None
    if where == "alive":
        alive = torch.stack([torch.arange(1024) % (1024 // m) == 0 for m in (100, 120, 90)])
        alive &= torch.arange(1024) < torch.tensor([[1000], [1020], [990]])
    size, _ = _batched_compact_plan(1024, alive, None)
    width = 1024 if size is None else size
    assert width == (1024 if alive is None else 128)
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    noise = _sg_noise(keys, k, width)
    jres = jstochastic_greedy_batched(
        jfnb, k, keys, s=s, alive=None if alive is None else jnp.asarray(alive.numpy()))
    tres = stochastic_greedy_batched(tfnb, k, s=s, alive=alive, noise=noise)
    _same_greedy_jax(jres, tres)
    _equal_rows(tres, [stochastic_greedy(tfnb.row(b), k, s=s, noise=noise[:, b],
                                         alive=None if alive is None else alive[b])
                       for b in range(3)])
    # generators: row b's draws are the dense call's under the same generator
    gens = [torch.Generator().manual_seed(60 + b) for b in range(3)]
    tg = stochastic_greedy_batched(tfnb, k, gens, s=s, alive=alive)
    _equal_rows(tg, [stochastic_greedy(tfnb.row(b), k, torch.Generator().manual_seed(60 + b),
                                       s=s, alive=None if alive is None else alive[b])
                     for b in range(3)])
    seen = []
    streamed = stochastic_greedy_batched(tfnb, k, s=s, alive=alive, noise=noise,
                                         on_step=lambda *a: seen.append(a[1]))
    assert torch.equal(streamed.selected, tres.selected)
    assert torch.equal(torch.stack(seen, 1), tres.selected)


@pytest.mark.parametrize("selector", ["greedy", "stochastic"])
@pytest.mark.parametrize("objective", ["coverage", "fl"])
def test_batched_steps_read_nothing_back_to_the_host(selector, objective):
    """The batched step loops read no value back to the host: 6 steps make
    as many host reads as 1 (the reads before the loop size the bucket)."""
    from test_torch_selectors import _HostReads

    _, tfnb = _fc_batch(B=2, n=200, F=16) if objective == "coverage" else _fl_batch(2)
    alive = torch.stack([torch.arange(200) % 3 == 0, torch.arange(200) % 5 == 0])

    def reads(k):
        with _HostReads() as mode:
            if selector == "greedy":
                greedy_batched(tfnb, k, alive=alive)
            else:
                stochastic_greedy_batched(tfnb, k, [torch.Generator()] * 2, alive=alive)
        return mode.count

    assert reads(6) == reads(1)


def test_stochastic_greedy_batched_checks_its_draws():
    _, tfnb = _fc_batch(B=2, n=128, F=8)
    with pytest.raises(ValueError, match="noise"):
        stochastic_greedy_batched(tfnb, 3, noise=torch.zeros(3, 2, 127))
    with pytest.raises(ValueError, match="generators"):
        stochastic_greedy_batched(tfnb, 3, [torch.Generator()])


def test_stacked_streaming_facility_location_runs_the_base_row_map():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((2, 150, 6)).astype(np.float32)
    X /= np.linalg.norm(X, axis=2, keepdims=True)
    tfnb = StreamingFacilityLocation(X=torch.from_numpy(X))
    jfnb = JStreamingFacilityLocation(X=jnp.asarray(X))
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    noise = _ss_noise(keys, 150, max_rounds(150))
    jss = jss_sparsify_batched(jfnb, keys)
    tss = ss_sparsify_batched(tfnb, noise=noise)
    _same_ss_jax(jss, tss)
    _equal_rows(tss, _seq_ss(tfnb, noise))
    tgb = greedy_batched(tfnb, 5, alive=tss.vprime)
    _same_greedy_jax(jgreedy_batched(jfnb, 5, alive=jss.vprime), tgb)
    _equal_rows(tgb, [greedy(tfnb.row(b), 5, alive=tss.vprime[b]) for b in range(2)])
    assert tfnb.row(1).X.data_ptr() == tfnb.X[1].data_ptr()   # a view


@pytest.mark.parametrize("selector", ["greedy", "stochastic"])
def test_summarize_batch_matches_jax(selector):
    jfnb, tfnb = _fc_batch(B=2, n=256, F=32, seed=41)
    keys = jax.random.split(jax.random.PRNGKey(8), 2)
    jres, jss = jsummarize_batch(jfnb, 6, keys, selector=selector)
    noise = _ss_noise(keys, 256, max_rounds(256))
    sel_noise = None
    if selector == "stochastic":
        size, _ = _batched_compact_plan(256, torch.from_numpy(np.array(jss.vprime)),
                                        ss_live_bound(256))
        sel_keys = jax.vmap(lambda kk: jax.random.fold_in(kk, 1))(keys)
        sel_noise = _sg_noise(sel_keys, 6, 256 if size is None else size)
    tres, tss = summarize_batch(tfnb, 6, noise=noise, selector=selector,
                                selector_noise=sel_noise)
    _same_ss_jax(jss, tss)
    _same_greedy_jax(jres, tres)


def test_summarize_batch_equals_the_sequential_pipeline_under_generators():
    _, tfnb = _fc_batch(B=3, n=300, F=32, seed=43)
    gens = lambda: [torch.Generator().manual_seed(70 + b) for b in range(3)]
    res, ss = summarize_batch(tfnb, 6, gens())
    g = gens()
    singles = [ss_sparsify(tfnb.row(b), g[b]) for b in range(3)]
    _equal_rows(ss, singles)
    _equal_rows(res, [greedy(tfnb.row(b), 6, alive=singles[b].vprime) for b in range(3)])
    # the stochastic selector draws from fold_in(seed, 1), not the SS stream
    sres, _ = summarize_batch(tfnb, 6, gens(), selector="stochastic", s=12)
    sel = fold_generators(gens(), 1)
    assert [x.initial_seed() for x in sel] == [fold_in(70 + b, 1) for b in range(3)]
    _equal_rows(sres, [stochastic_greedy(tfnb.row(b), 6, sel[b], s=12,
                                         alive=singles[b].vprime) for b in range(3)])
    seen = []
    streamed, _ = summarize_batch(tfnb, 6, gens(), on_step=lambda *a: seen.append(a))
    assert torch.equal(streamed.selected, res.selected) and len(seen) == 6
    with pytest.raises(ValueError, match="selector"):
        summarize_batch(tfnb, 6, gens(), selector="lazy")


def test_summarize_batch_without_ss_is_batched_greedy():
    _, tfnb = _fc_batch(B=2, n=128, F=16, seed=3)
    res, ss = summarize_batch(tfnb, 4, use_ss=False)
    assert ss is None
    assert torch.equal(res.selected, greedy_batched(tfnb, 4).selected)


@pytest.mark.parametrize("objective,kernel", [("coverage", None), ("fl", "rbf"),
                                              ("fl", "cosine")])
def test_build_batch_objective_pads_inertly(objective, kernel):
    """Padding to n_pad: the mask marks each request's real elements, and
    FL's padded similarity is zero, so a padded query selects only real
    elements, as the JAX package's does."""
    rng = np.random.default_rng(6)
    feats = [np.abs(rng.standard_normal((m, 8))).astype(np.float32) for m in (50, 37)]
    kw = {} if kernel is None else {"kernel": kernel}
    treqs = [SummarizeRequest(k=4, seed=i, features=f, objective=objective, **kw)
             for i, f in enumerate(feats)]
    jreqs = [JSummarizeRequest(k=4, key=i, features=jnp.asarray(f), objective=objective,
                               **kw) for i, f in enumerate(feats)]
    tfn, talive = build_batch_objective(treqs, 64, device="cpu")
    jfn, jalive = jbuild_batch_objective(jreqs, 64)
    np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
    leaf = "W" if objective == "coverage" else "sim"
    np.testing.assert_allclose(getattr(tfn, leaf).numpy(), np.asarray(getattr(jfn, leaf)),
                               rtol=1e-5, atol=1e-6)
    if objective == "fl":
        assert float(tfn.sim[:, 50:].abs().sum() + tfn.sim[1, 37:].abs().sum()) == 0.0
    res = greedy_batched(tfn, 4, alive=talive)
    assert bool((res.selected[0] < 50).all()) and bool((res.selected[1] < 37).all())
    jres = jgreedy_batched(jfn, 4, alive=jalive)
    np.testing.assert_array_equal(res.selected.numpy(), np.asarray(jres.selected))
    unpadded, none = build_batch_objective(treqs[:1], None, device="cpu")
    assert none is None and unpadded.row(0).n == 50


def test_run_config_batch_buckets_and_requests():
    assert batch_buckets(8) == (8, 4, 2, 1) and batch_buckets(1) == (1,)
    cfg = RunConfig()
    assert (cfg.backend, cfg.r, cfg.c, cfg.compact) == (None, 8, 8.0, None)
    assert RunConfig(max_retries=1).max_retries == 1   # the service's fields
    assert RunConfig().failover_backend == "reference"
    with pytest.raises(TypeError):
        RunConfig(no_such_field=1)
    g = SummarizeRequest(k=2, seed=5).generator("cpu")
    assert torch.equal(torch.rand(3, generator=g),
                       torch.rand(3, generator=torch.Generator().manual_seed(5)))
    own = torch.Generator().manual_seed(1)
    assert SummarizeRequest(k=2, seed=own).generator("cpu") is own


def test_cuda_backend_refuses_cpu_batches():
    _, tfnb = _fc_batch(B=2, n=64, F=8)
    be = CudaBackend()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        be.divergence_batched(tfnb, torch.zeros(2, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        be.gains_batched(tfnb, torch.zeros(2, 8), None)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ss_sparsify_batched(tfnb, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        greedy_batched(tfnb, 2, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        summarize_batch(tfnb, 2, backend="cuda")
