"""The port's facility-location objectives, dense and matrix-free, held
against the JAX package on the same numpy inputs (float32 on the CPU, rtol
and atol 1e-5 unless stated), plus the synthetic data copies and the
conversions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FacilityLocation as JFacilityLocation
from repro.core import StreamingFacilityLocation as JStreamingFacilityLocation
from repro.data.synthetic import clustered_embeddings as jclustered_embeddings
from repro.data.synthetic import video as jvideo
from repro_torch import (
    FacilityLocation,
    StreamingFacilityLocation,
    facility_location_from_features,
    facility_location_from_numpy,
    streaming_facility_location_from_numpy,
)
from repro_torch.data import clustered_embeddings, video
from repro_torch.kernels import ops

RTOL, ATOL = 1e-5, 1e-5


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=rtol, atol=atol)


def _dense(kernel="cosine", n=240, seed=0):
    X = jvideo(seed, n, 24)
    jfn = JFacilityLocation.from_features(jnp.asarray(X), kernel=kernel)
    return jfn, facility_location_from_numpy(np.asarray(jfn.sim), device="cpu")


def _stream(kernel="dot", n=240, seed=0, served=False):
    E = jclustered_embeddings(seed, n, 12)
    jfn = JStreamingFacilityLocation.from_features(jnp.asarray(E), kernel=kernel)
    if served:  # a compacted view: fewer candidates, all rows still served
        keep = np.arange(0, n, 3)
        jfn = JStreamingFacilityLocation(X=jfn.X[keep], Xs=jfn.X)
        return jfn, streaming_facility_location_from_numpy(
            np.asarray(jfn.X), np.asarray(jfn.Xs), device="cpu")
    return jfn, streaming_facility_location_from_numpy(np.asarray(jfn.X),
                                                       device="cpu")


OBJECTIVES = {
    "dense-cosine": lambda: _dense("cosine"),
    "dense-rbf": lambda: _dense("rbf"),
    "dense-dot": lambda: _dense("dot"),
    "stream-dot": lambda: _stream("dot"),
    "stream-cosine": lambda: _stream("cosine"),
    "stream-served": lambda: _stream("dot", served=True),
}


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_primitives_match_jax(name):
    jfn, tfn = OBJECTIVES[name]()
    n = tfn.n
    assert n == jfn.n
    _close(tfn.empty_state(), jfn.empty_state())
    mask = np.arange(n) % 11 == 0
    jstate = jfn.add_many(jfn.empty_state(), jnp.asarray(mask))
    tstate = tfn.add_many(tfn.empty_state(), torch.from_numpy(mask))
    _close(tstate, jstate)
    _close(tfn.add(tstate, torch.tensor(7)), jfn.add(jstate, 7))
    _close(tfn.value(tstate), jfn.value(jstate))
    _close(tfn.gains(tstate), jfn.gains(jstate))
    _close(tfn.singleton_gains(), jfn.singleton_gains())
    _close(tfn.residual_gains(), jfn.residual_gains())
    none = np.zeros(n, bool)
    _close(tfn.add_many(tstate, torch.from_numpy(none)),
           jfn.add_many(jstate, jnp.asarray(none)))

    probes = np.array([3, 40, 41, n - 1])
    cand = np.array([0, 3, 5, 40, 41, n - 2, 0, 0])
    for js, ts in ((None, None), (jstate, tstate)):
        _close(tfn.pairwise_gains(torch.from_numpy(probes), ts),
               jfn.pairwise_gains(jnp.asarray(probes), js))
        _close(tfn.pairwise_gains_compact(torch.from_numpy(probes),
                                          torch.from_numpy(cand), ts),
               jfn.pairwise_gains_compact(jnp.asarray(probes), jnp.asarray(cand),
                                          js))
    _close(tfn.gains_compact(tstate, torch.from_numpy(cand)),
           jfn.gains_compact(jstate, jnp.asarray(cand)))


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_kernel_hooks_match_pallas_hooks(name):
    """cuda_divergence / cuda_gains build the kernels' inputs (MU, resid) as
    the JAX pallas hooks do; on the CPU the wrappers run the plain versions."""
    jfn, tfn = OBJECTIVES[name]()
    n = tfn.n
    probes = np.array([5, 60, 61, n - 3])
    cand = np.array([0, 1, 5, 60, n - 1, 0, 0])
    mask = np.arange(n) % 9 == 0
    jstate = jfn.add_many(jfn.empty_state(), jnp.asarray(mask))
    tstate = tfn.add_many(tfn.empty_state(), torch.from_numpy(mask))
    jres, tres = jfn.residual_gains(), tfn.residual_gains()
    for jc, tc in ((None, None), (jnp.asarray(cand), torch.from_numpy(cand))):
        ref = jfn.pallas_divergence(jnp.asarray(probes), jres, jstate,
                                    interpret=True, cand_idx=jc)
        out = tfn.cuda_divergence(torch.from_numpy(probes), tres, tstate, tc)
        _close(out, ref, 1e-4, 1e-4)
        ref = jfn.pallas_gains(jstate, interpret=True, cand_idx=jc)
        _close(tfn.cuda_gains(tstate, tc), ref, 1e-4, 1e-4)
    # the public FL entry points follow the device: the plain path here
    jp, tp = jnp.asarray(probes), torch.from_numpy(probes)
    from repro.core import graph as jgraph
    _close(ops.fl_divergence(tfn, tp, tres, tstate),
           jgraph.divergence(jfn, jp, residual=jres, state=jstate))
    _close(ops.fl_divergence_compact(tfn, tp, torch.from_numpy(cand), tres, tstate),
           jgraph.divergence_compact(jfn, jp, jnp.asarray(cand), residual=jres,
                                     state=jstate))
    _close(ops.fl_gains(tfn, tstate), jfn.gains(jstate))
    _close(ops.fl_gains(tfn, tstate, torch.from_numpy(cand)),
           jfn.gains_compact(jstate, jnp.asarray(cand)))


def test_fl_entry_points_take_only_facility_location():
    from repro_torch import feature_coverage_from_numpy

    fc = feature_coverage_from_numpy(np.ones((8, 4), np.float32), device="cpu")
    with pytest.raises(TypeError):
        ops.fl_gains(fc, fc.empty_state())


@pytest.mark.parametrize("kernel", ["dot", "rbf", "cosine"])
def test_from_features_matches_jax(kernel):
    X = jvideo(2, 200, 16) - 0.03   # a few negative dot products to clip
    jfn = JFacilityLocation.from_features(jnp.asarray(X), kernel=kernel)
    tfn = facility_location_from_features(X, kernel, device="cpu")
    assert tfn.sim.dtype == torch.float32 and tfn.sim.shape == (200, 200)
    _close(tfn.sim, jfn.sim, 1e-5, 1e-6)
    tsf = FacilityLocation.from_features(torch.from_numpy(X), kernel)
    _close(tsf.sim, jfn.sim, 1e-5, 1e-6)


def test_from_features_guards_the_dense_matrix():
    X = np.random.default_rng(0).normal(size=(40, 4)).astype(np.float32)
    with pytest.raises(ValueError, match="StreamingFacilityLocation") as port:
        facility_location_from_features(X, "cosine", device="cpu", n_threshold=39)
    with pytest.raises(ValueError, match="StreamingFacilityLocation") as ref:
        JFacilityLocation.from_features(jnp.asarray(X), "cosine", n_threshold=39)
    assert str(port.value) == str(ref.value)
    assert facility_location_from_features(X, "cosine", device="cpu",
                                           n_threshold=None).n == 40
    assert FacilityLocation.N_THRESHOLD == JFacilityLocation.N_THRESHOLD
    with pytest.raises(ValueError):
        FacilityLocation.from_features(torch.from_numpy(X), "manhattan")


@pytest.mark.parametrize("kernel", ["dot", "cosine"])
def test_streaming_from_features_matches_jax(kernel):
    E = jclustered_embeddings(3, 100, 6) * 3.0
    jfn = JStreamingFacilityLocation.from_features(jnp.asarray(E), kernel)
    tfn = StreamingFacilityLocation.from_features(torch.from_numpy(E), kernel)
    _close(tfn.X, jfn.X, 1e-6, 1e-7)
    assert tfn.Xs is None
    with pytest.raises(ValueError, match="dot"):
        StreamingFacilityLocation.from_features(torch.from_numpy(E), "rbf")


def test_residual_gains_tie_rule_on_duplicated_columns():
    """Rows whose best is reached by two columns lose nothing when one of
    them leaves (functions.py top-2 rule); duplicated frames make such ties."""
    X = jvideo(4, 120, 8)
    X = np.concatenate([X, X[:15], X[50:52]])
    jfn = JFacilityLocation.from_features(jnp.asarray(X), "cosine")
    tfn = facility_location_from_numpy(np.asarray(jfn.sim), device="cpu")
    res = tfn.residual_gains()
    _close(res, jfn.residual_gains())
    assert float(res[:15].abs().max()) == 0.0     # every copy is tied
    assert float(res[15:50].min()) > 0.0          # unique frames are not
    sfl = streaming_facility_location_from_numpy(np.asarray(
        JStreamingFacilityLocation.from_features(jnp.asarray(X), "cosine").X),
        device="cpu")
    _close(sfl.residual_gains(), jfn.residual_gains(), 1e-4, 1e-4)


@pytest.mark.parametrize("kernel", ["dot", "cosine"])
def test_streaming_matches_dense_in_the_port(kernel):
    """The counterpart of tests/test_fl_stream.py for the port: the same
    features give the same state protocol and the same four primitives."""
    X = np.array(jax.random.normal(jax.random.PRNGKey(0), (200, 12)))
    dense = facility_location_from_features(X, kernel, device="cpu")
    sfl = StreamingFacilityLocation.from_features(torch.from_numpy(X), kernel)
    tol = dict(rtol=1e-4, atol=1e-4)
    s_d, s_s = dense.empty_state(), sfl.empty_state()
    _close(s_s, s_d.numpy())
    s_d, s_s = dense.add(s_d, torch.tensor(7)), sfl.add(s_s, torch.tensor(7))
    _close(s_s, s_d.numpy(), **tol)
    mask = torch.arange(200) % 5 == 0
    s_d, s_s = dense.add_many(s_d, mask), sfl.add_many(s_s, mask)
    _close(s_s, s_d.numpy(), **tol)
    _close(sfl.value(s_s), dense.value(s_d).numpy(), **tol)
    _close(sfl.residual_gains(), dense.residual_gains().numpy(), **tol)
    probes = torch.tensor([3, 50, 111, 166])
    ci = torch.tensor([0, 5, 9, 100, 150, 199])
    _close(sfl.pairwise_gains(probes), dense.pairwise_gains(probes).numpy(), **tol)
    _close(sfl.pairwise_gains(probes, s_d), dense.pairwise_gains(probes, s_d)
           .numpy(), **tol)
    _close(sfl.gains(s_d), dense.gains(s_d).numpy(), **tol)
    _close(sfl.pairwise_gains_compact(probes, ci, s_d),
           dense.pairwise_gains_compact(probes, ci, s_d).numpy(), **tol)
    _close(sfl.gains_compact(s_d, ci), dense.gains_compact(s_d, ci).numpy(), **tol)
    res = dense.residual_gains()
    _close(sfl.cuda_divergence(probes, res, s_d, ci),
           dense.cuda_divergence(probes, res, s_d, ci).numpy(), **tol)
    _close(sfl.cuda_gains(s_d), dense.cuda_gains(s_d).numpy(), **tol)


@pytest.mark.parametrize("seed,n,F", [(0, 257, 64), (3, 1000, 32), (7, 1200, 16)])
def test_video_copy_gives_the_reference_arrays(seed, n, F):
    ours, ref = video(seed, n, F), jvideo(seed, n, F)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("seed,n,d", [(0, 300, 16), (5, 4096, 8), (9, 50, 33)])
def test_clustered_embeddings_copy_gives_the_reference_arrays(seed, n, d):
    ours, ref = clustered_embeddings(seed, n, d), jclustered_embeddings(seed, n, d)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_conversions_round_trip_the_jax_objectives():
    jfn, tfn = _dense("rbf", n=64)
    np.testing.assert_array_equal(tfn.sim.numpy(), np.asarray(jfn.sim))
    assert tfn.sim.dtype == torch.float32 and tfn.device.type == "cpu"
    jsf, tsf = _stream(n=90, served=True)
    np.testing.assert_array_equal(tsf.X.numpy(), np.asarray(jsf.X))
    np.testing.assert_array_equal(tsf.Xs.numpy(), np.asarray(jsf.Xs))
    assert (tsf.n, tsf.empty_state().shape) == (jsf.n, jsf.empty_state().shape)
    tsf.X[0, 0] = 5.0   # the port owns its copy
    assert float(jsf.X[0, 0]) != 5.0
