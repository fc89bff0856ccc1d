"""The port's FeatureCoverage primitives, submodularity-graph divergences,
SS schedule arithmetic, synthetic data and conversion, held against the JAX
package on the same numpy inputs (float32 on the CPU, rtol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import graph as jgraph
from repro.core import sparsify as jsparsify
from repro.core.greedy import selection_bucket as jselection_bucket
from repro.data.synthetic import news_day as jnews_day
from repro_torch import feature_coverage_from_numpy
from repro_torch.core import graph, sparsify
from repro_torch.core.greedy import selection_bucket
from repro_torch.data import news_day
from repro_torch.kernels import ops

PHIS = ["sqrt", "log1p", "setcover", "satcov", "linear"]
RTOL, ATOL = 1e-5, 1e-5


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        port.detach().cpu().float().numpy(), np.asarray(ref, np.float32),
        rtol=rtol, atol=atol,
    )


def _pair(phi, weighted, n=300, F=48, seed=0):
    W = jnews_day(seed, n, F)
    fw = np.linspace(0.5, 1.5, F).astype(np.float32) if weighted else None
    jfn = JFeatureCoverage(W=jnp.asarray(W),
                           feat_w=None if fw is None else jnp.asarray(fw),
                           phi=phi)
    tfn = feature_coverage_from_numpy(W, fw, phi=phi, device="cpu")
    return jfn, tfn


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("phi", PHIS)
def test_feature_coverage_primitives_match_jax(phi, weighted):
    jfn, tfn = _pair(phi, weighted)
    n = tfn.n
    mask = np.arange(n) % 11 == 0
    jstate = jfn.add_many(jfn.empty_state(), jnp.asarray(mask))
    tstate = tfn.add_many(tfn.empty_state(), torch.from_numpy(mask))
    _close(tstate, jstate)
    _close(tfn.empty_state(), jfn.empty_state())
    _close(tfn.add(tstate, torch.tensor(7)), jfn.add(jstate, 7))
    _close(tfn.value(tstate), jfn.value(jstate))
    _close(tfn.gains(tstate), jfn.gains(jstate))
    _close(tfn.residual_gains(), jfn.residual_gains())
    _close(tfn.singleton_gains(), jfn.singleton_gains())
    if phi == "satcov":
        _close(tfn._cap(), jfn._cap())
    else:
        assert tfn._cap() is None and jfn._cap() is None
    x = np.random.default_rng(1).random((5, 48), np.float32)
    _close(tfn._wsum(torch.from_numpy(x)), jfn._wsum(jnp.asarray(x)))

    probes = np.array([3, 77, 150, 299])
    cand = np.array([0, 3, 5, 150, 151, 298, 0, 0])
    for js, ts in ((None, None), (jstate, tstate)):
        _close(tfn.pairwise_gains(torch.from_numpy(probes), ts),
               jfn.pairwise_gains(jnp.asarray(probes), js))
        _close(tfn.pairwise_gains_compact(torch.from_numpy(probes),
                                          torch.from_numpy(cand), ts),
               jfn.pairwise_gains_compact(jnp.asarray(probes),
                                          jnp.asarray(cand), js))
    _close(tfn.gains_compact(tstate, torch.from_numpy(cand)),
           jfn.gains_compact(jstate, jnp.asarray(cand)))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("phi", PHIS)
def test_graph_divergence_matches_jax(phi, weighted):
    jfn, tfn = _pair(phi, weighted, seed=2)
    probes = np.array([1, 40, 41, 200, 250])
    cand = np.array([0, 2, 40, 99, 298, 0])
    mask = np.arange(tfn.n) < 4
    jstate = jfn.add_many(jfn.empty_state(), jnp.asarray(mask))
    tstate = tfn.add_many(tfn.empty_state(), torch.from_numpy(mask))
    jres, tres = jfn.residual_gains(), tfn.residual_gains()
    for js, ts in ((None, None), (jstate, tstate)):
        jp, tp = jnp.asarray(probes), torch.from_numpy(probes)
        _close(graph.edge_weights(tfn, tp, tres, ts),
               jgraph.edge_weights(jfn, jp, jres, js))
        _close(graph.divergence(tfn, tp, residual=tres, state=ts),
               jgraph.divergence(jfn, jp, residual=jres, state=js))
        _close(graph.divergence_compact(tfn, tp, torch.from_numpy(cand),
                                        residual=tres, state=ts),
               jgraph.divergence_compact(jfn, jp, jnp.asarray(cand),
                                         residual=jres, state=js))
        # the public entry points follow the device: plain path on the CPU
        _close(ops.ss_divergence(tfn, tp, tres, ts),
               jgraph.divergence(jfn, jp, residual=jres, state=js))
        _close(ops.ss_divergence_compact(tfn, tp, torch.from_numpy(cand), tres, ts),
               jgraph.divergence_compact(jfn, jp, jnp.asarray(cand),
                                         residual=jres, state=js))
    _close(ops.feature_gains(tfn, tstate), jfn.gains(jstate))
    # residual recomputed when not given
    _close(graph.divergence(tfn, torch.from_numpy(probes)),
           jgraph.divergence(jfn, jnp.asarray(probes)))


@pytest.mark.parametrize("n", [1, 2, 100, 300, 1500, 2048, 65536, 1 << 20])
@pytest.mark.parametrize("r,c", [(8, 8.0), (4, 4.0), (6, 16.0)])
def test_schedule_arithmetic_matches_jax(n, r, c):
    assert sparsify.probe_count(n, r) == jsparsify.probe_count(n, r)
    assert sparsify.max_rounds(n, r, c) == jsparsify.max_rounds(n, r, c)
    assert sparsify.ss_live_bound(n, r, c) == jsparsify.ss_live_bound(n, r, c)
    assert sparsify.bucket_schedule(n, c) == jsparsify.bucket_schedule(n, c)
    assert (sparsify.predicted_live_counts(n, r, c)
            == jsparsify.predicted_live_counts(n, r, c))
    assert sparsify.ss_cost_model(n, r, c) == jsparsify.ss_cost_model(n, r, c)
    alive0 = max(1, n // 3)
    assert (sparsify.predicted_live_counts(n, r, c, alive0)
            == jsparsify.predicted_live_counts(n, r, c, alive0))
    assert (sparsify.ss_cost_model(n, r, c, alive0)
            == jsparsify.ss_cost_model(n, r, c, alive0))
    for live in {0, 1, n // 7, n // 2, n}:
        assert selection_bucket(n, live, c) == jselection_bucket(n, live, c)


def test_bucket_schedule_rejects_degenerate_params():
    with pytest.raises(ValueError):
        sparsify.bucket_schedule(1024, c=1.0)
    with pytest.raises(ValueError):
        sparsify.bucket_schedule(1024, tile=0)


@pytest.mark.parametrize("seed,n,F", [(0, 257, 64), (3, 1000, 128), (7, 64, 1024)])
def test_news_day_copy_gives_the_reference_arrays(seed, n, F):
    ours, ref = news_day(seed, n, F), jnews_day(seed, n, F)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_feature_coverage_from_numpy_round_trips():
    W = jnews_day(1, 50, 16)
    fw = np.linspace(0.1, 2.0, 16).astype(np.float32)
    fn = feature_coverage_from_numpy(W, fw, phi="satcov", alpha=0.3, device="cpu")
    np.testing.assert_array_equal(fn.W.numpy(), W)
    np.testing.assert_array_equal(fn.feat_w.numpy(), fw)
    assert (fn.phi, fn.alpha, fn.n, fn.W.dtype) == ("satcov", 0.3, 50, torch.float32)
    bf = feature_coverage_from_numpy(W, device="cpu", dtype=torch.bfloat16)
    assert bf.W.dtype == torch.bfloat16 and bf.feat_w is None
    np.testing.assert_array_equal(
        bf.W.float().numpy(), np.asarray(jnp.asarray(W).astype(jnp.bfloat16)
                                         .astype(jnp.float32)))
