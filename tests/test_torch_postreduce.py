"""The port's §3.4 post-reduction and the rest of the submodularity graph,
held against the JAX package.

``postreduce`` in JAX draws step j of its bidirectional greedy as
``bernoulli(kk, p)`` for the j-th ``kk`` of ``split(key, slots)``, which is
``uniform(kk, ()) < p`` (pinned in ``tests/test_torch_selectors.py``);
``_uniforms`` rebuilds those uniforms and hands them to the port as
``noise``.  The keep masks must be identical: the port keeps h's counts
incrementally, and its a and b must be the literal form's float32 values.
Graph functions are compared at rtol 1e-5 / atol 1e-5 (float32 sums over
F features or n served rows), and Lemma 3's triangle check holds to 1e-3,
the reference's bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st  # skips @given tests only

from repro.core import FacilityLocation as JFacilityLocation
from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import StreamingFacilityLocation as JStreamingFacilityLocation
from repro.core import graph as jgraph
from repro.core import ss_sparsify as jss_sparsify
from repro.core.sparsify import postreduce as jpostreduce
from repro.data.synthetic import clustered_embeddings, video
from repro_torch import (
    SSResult,
    check_triangle_inequality,
    divergence_update,
    facility_location_from_numpy,
    feature_coverage_from_numpy,
    full_edge_matrix,
    postreduce,
    ss_sparsify,
    streaming_facility_location_from_numpy,
)
from repro_torch.core import graph, ss_live_bound
from repro_torch.core import functions as tfunctions
from repro_torch.core import sparsify as tsparsify

TOL = dict(rtol=1e-5, atol=1e-5)


def _uniforms(seed, n):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(kk, ()))
                                      for kk in keys]))


def _fc_w(seed, n, F, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((n, F)) * (rng.random((n, F)) < density)).astype(np.float32)


def _pair(kind, n, seed=0):
    """The same objective in both packages, from the JAX side's own arrays."""
    if kind == "fc":
        W = _fc_w(seed, n, 24)
        return JFeatureCoverage(W=jnp.asarray(W)), feature_coverage_from_numpy(
            W, device="cpu")
    if kind == "fl":
        jfn = JFacilityLocation.from_features(jnp.asarray(video(seed, n, 16)),
                                              kernel="rbf")
        return jfn, facility_location_from_numpy(np.asarray(jfn.sim), device="cpu")
    jfn = JStreamingFacilityLocation.from_features(
        jnp.asarray(clustered_embeddings(seed, n, 8)), kernel="cosine")
    return jfn, streaming_facility_location_from_numpy(np.asarray(jfn.X),
                                                       device="cpu")


def _ss_pair(jss):
    """The JAX SS result as the port's (postreduce reads only vprime)."""
    return SSResult(torch.from_numpy(np.array(jss.vprime)), None, None, 0, None)


# -------------------------------------------------------------- postreduce --
# (objective, n, r, eps offset, max_members)
CASES = [
    ("fc", 120, 6, 1e-3, None),
    ("fc", 300, 8, 1e-3, None),
    ("fc", 1024, 6, 1e-3, None),     # the derived bound (600 slots) < n
    ("fc", 200, 6, 0.5, "exact"),
    ("fl", 150, 6, 1e-3, None),
    ("fl", 150, 6, 0.3, 64),
    ("sfl", 180, 6, 1e-3, None),
    ("sfl", 180, 6, 0.05, "exact"),
]


@pytest.mark.parametrize("kind,n,r,offset,max_members", CASES)
def test_postreduce_matches_jax_under_the_same_draws(kind, n, r, offset,
                                                     max_members):
    jfn, tfn = _pair(kind, n)
    jss = jss_sparsify(jfn, jax.random.PRNGKey(0), r=r, c=8.0)
    eps = float(jss.eps_hat) + offset
    jmask = jpostreduce(jfn, jss, eps, jax.random.PRNGKey(1), r=r, c=8.0,
                        max_members=max_members)
    nv = int(jnp.sum(jss.vprime))
    slots = {None: min(n, ss_live_bound(n, r, 8.0)), "exact": nv}.get(
        max_members, max_members)
    tmask = postreduce(tfn, _ss_pair(jss), eps, r=r, c=8.0,
                       max_members=max_members, noise=_uniforms(1, slots))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert bool((~tmask | _ss_pair(jss).vprime).all())
    assert 0 < int(tmask.sum()) <= nv


@pytest.mark.parametrize("eps", [-1e9, 2e30])
def test_postreduce_matches_jax_at_extreme_eps(eps):
    """eps below every edge (nothing covered) and at or above the +INF of
    padding rows (everything covered by any set, even the empty one)."""
    jfn, tfn = _pair("fc", 120, seed=3)
    jss = jss_sparsify(jfn, jax.random.PRNGKey(0), r=6, c=8.0)
    jmask = jpostreduce(jfn, jss, eps, jax.random.PRNGKey(2), r=6, c=8.0)
    slots = min(120, ss_live_bound(120, 6, 8.0))
    tmask = postreduce(tfn, _ss_pair(jss), eps, r=6, c=8.0,
                       noise=_uniforms(2, slots))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_postreduce_exact_matches_the_derived_default():
    """The "exact" block is the default's first |V'| slots: under the same
    draws for those slots the masks are the same (padding slots cover
    nothing, so a = -1, p = 0, and they are never kept)."""
    _, tfn = _pair("fc", 200, seed=11)
    ss = ss_sparsify(tfn, torch.Generator().manual_seed(0), r=6, c=8.0)
    eps = float(ss.eps_hat) + 1e-3
    slots = min(200, ss_live_bound(200, 6, 8.0))
    u = torch.rand(slots, generator=torch.Generator().manual_seed(2))
    nv = int(ss.vprime.sum())
    assert nv < slots
    default = postreduce(tfn, ss, eps, r=6, c=8.0, noise=u)
    exact = postreduce(tfn, ss, eps, max_members="exact", noise=u[:nv])
    assert torch.equal(default, exact)
    assert bool((~default | ss.vprime).all()) and int(default.sum()) > 0


def test_postreduce_static_bound_fits_vprime():
    for n, r in ((300, 8), (1024, 6)):
        _, tfn = _pair("fc", n, seed=10)
        ss = ss_sparsify(tfn, torch.Generator().manual_seed(0), r=r, c=8.0)
        assert int(ss.vprime.sum()) <= ss_live_bound(n, r, 8.0)
        new_vp = postreduce(tfn, ss, float(ss.eps_hat) + 1e-3,
                            torch.Generator().manual_seed(1), r=r, c=8.0)
        assert bool((~new_vp | ss.vprime).all())
        assert 0 < int(new_vp.sum()) <= int(ss.vprime.sum())


def test_postreduce_raises_on_truncating_derived_bound():
    """A V' larger than the derived bound (an SS run at larger r) raises; an
    explicit int bound is trusted unchecked."""
    n = 32768
    tfn = feature_coverage_from_numpy(_fc_w(12, n, 4), device="cpu")
    bound = ss_live_bound(n, 8, 8.0)
    assert bound < n
    big = SSResult(torch.arange(n) < bound + 7, None, None, 1, None)
    with pytest.raises(ValueError, match="slot bound"):
        postreduce(tfn, big, 0.1)
    with pytest.raises(ValueError, match="noise must be"):
        postreduce(tfn, SSResult(torch.arange(n) < 5, None, None, 1, None), 0.1,
                   max_members=8, noise=torch.rand(7))


def test_postreduce_edge_blocks_give_the_same_mask(monkeypatch):
    """The edge pass in blocks of members (and FeatureCoverage's pairwise
    block in chunks of candidates) gives the mask of one block."""
    _, tfn = _pair("fc", 300, seed=4)
    ss = ss_sparsify(tfn, torch.Generator().manual_seed(0), r=8, c=8.0)
    eps = float(ss.eps_hat) + 1e-3
    slots = min(300, ss_live_bound(300, 8, 8.0))
    u = torch.rand(slots, generator=torch.Generator().manual_seed(3))
    whole = postreduce(tfn, ss, eps, noise=u)
    monkeypatch.setattr(tsparsify, "_ELEMS", 3 * 300 + 7)      # 3 members a block
    monkeypatch.setattr(tfunctions, "_ELEMS", 5 * 24 * 3 + 1)   # 5 rows a chunk
    assert torch.equal(postreduce(tfn, ss, eps, noise=u), whole)


def test_feature_coverage_pairwise_chunks_are_exact(monkeypatch):
    _, tfn = _pair("fc", 90, seed=5)
    probes = torch.tensor([0, 7, 33, 89])
    whole = tfn.pairwise_gains(probes)
    monkeypatch.setattr(tfunctions, "_ELEMS", 4 * 24 * 4)      # 4 rows a chunk
    assert torch.equal(tfn.pairwise_gains(probes), whole)


# ------------------------------------------------------------------- graph --
GRAPH_KINDS = ["fc", "fl", "sfl"]


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_full_edge_matrix_matches_jax(kind):
    jfn, tfn = _pair(kind, 16, seed=7)
    mask = np.arange(16) % 5 == 0
    for jst, tst in ((None, None),
                     (jfn.add_many(jfn.empty_state(), jnp.asarray(mask)),
                      tfn.add_many(tfn.empty_state(), torch.from_numpy(mask)))):
        np.testing.assert_allclose(full_edge_matrix(tfn, tst).numpy(),
                                   np.asarray(jgraph.full_edge_matrix(jfn, jst)),
                                   **TOL)


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_triangle_inequality_lemma3(kind):
    """Lemma 3: w_vx <= w_vu + w_ux over distinct triples, and the port's
    check gives the JAX check's value."""
    for seed in range(4):
        jfn, tfn = _pair(kind, 14, seed=seed)
        W = full_edge_matrix(tfn)
        viol = float(check_triangle_inequality(W))
        assert viol <= 1e-3, f"triangle inequality violated by {viol}"
        np.testing.assert_allclose(
            viol, float(jgraph.check_triangle_inequality(jnp.asarray(W.numpy()))),
            **TOL)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(4, 12), F=st.integers(2, 8))
def test_triangle_inequality_property(seed, n, F):
    tfn = feature_coverage_from_numpy(_fc_w(seed, n, F, 0.5), device="cpu")
    assert float(check_triangle_inequality(full_edge_matrix(tfn))) <= 1e-3


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_divergence_update_matches_jax_and_the_running_min(kind):
    jfn, tfn = _pair(kind, 40, seed=6)
    t0, t1 = torch.tensor([0, 1]), torch.tensor([2, 3, 9])
    d1 = graph.divergence(tfn, t0)
    d2 = divergence_update(tfn, d1, t1)
    np.testing.assert_allclose(
        d2.numpy(), graph.divergence(tfn, torch.tensor([0, 1, 2, 3, 9])).numpy(),
        **TOL)
    j2 = jgraph.divergence_update(jfn, jgraph.divergence(jfn, jnp.asarray([0, 1])),
                                  jnp.asarray([2, 3, 9]))
    np.testing.assert_allclose(d2.numpy(), np.asarray(j2), **TOL)
    # a masked probe slot never wins the min
    mask = torch.tensor([True, False, True])
    np.testing.assert_allclose(
        divergence_update(tfn, d1, t1, probe_mask=mask).numpy(),
        divergence_update(tfn, d1, torch.tensor([2, 9])).numpy(), **TOL)
    np.testing.assert_allclose(
        divergence_update(tfn, d1, t1, probe_mask=mask).numpy(),
        np.asarray(jgraph.divergence_update(
            jfn, jgraph.divergence(jfn, jnp.asarray([0, 1])), jnp.asarray([2, 3, 9]),
            probe_mask=jnp.asarray(mask.numpy()))), **TOL)


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_self_edges_are_nonpositive_and_edges_follow_eq3(kind):
    """w_uu = -f(u|V\\u) <= 0, and w_uv = f(v|u) - f(u|V\\u) (Eq. 3)."""
    _, tfn = _pair(kind, 16, seed=8)
    W = full_edge_matrix(tfn)
    assert bool((torch.diagonal(W) <= 1e-5).all())
    probes = torch.tensor([3, 8])
    np.testing.assert_allclose(
        graph.edge_weights(tfn, probes).numpy(),
        (tfn.pairwise_gains(probes) - tfn.residual_gains()[probes][:, None]).numpy(),
        **TOL)
