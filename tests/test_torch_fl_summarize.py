"""The port's SS, greedy and summarize over facility location, dense and
matrix-free, held against the JAX package under the same random draws.

``_replay`` rebuilds the JAX loop's per-round Gumbel draws and hands them to
the port as ``noise`` (the pattern of ``tests/test_torch_summarize.py``), so
both sides sample the same probes: ``vprime``, ``rounds``, ``alive_trace``
and ``selected`` must be identical and ``eps_hat`` equal to rtol 1e-5.  The
JAX side runs on ``oracle`` and on ``pallas`` (interpret mode); the port on
its plain path, the only one on the CPU.  Both objectives are built from the
JAX objective's own arrays, so the inputs are the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FacilityLocation as JFacilityLocation
from repro.core import StreamingFacilityLocation as JStreamingFacilityLocation
from repro.core import greedy as jgreedy
from repro.core import ss_sparsify as jss_sparsify
from repro.core.sparsify import max_rounds
from repro.core.sparsify import summarize as jsummarize
from repro.data.synthetic import clustered_embeddings, video
from repro_torch import (
    facility_location_from_numpy,
    greedy,
    ss_sparsify,
    streaming_facility_location_from_numpy,
    summarize,
)


def _replay(seed, n, rounds):
    key, rows = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, k1 = jax.random.split(key)
        rows.append(np.asarray(jax.random.gumbel(k1, (n,))))
    return torch.from_numpy(np.stack(rows))


def _pair(kind, n, seed=0):
    if kind == "dense":
        jfn = JFacilityLocation.from_features(jnp.asarray(video(seed, n, 32)),
                                              kernel="cosine")
        return jfn, facility_location_from_numpy(np.asarray(jfn.sim), device="cpu")
    jfn = JStreamingFacilityLocation.from_features(
        jnp.asarray(clustered_embeddings(seed, n, 16)), kernel="dot")
    return jfn, streaming_facility_location_from_numpy(np.asarray(jfn.X),
                                                       device="cpu")


def _state(jfn, tfn, n):
    mask = np.arange(n) % 97 == 0
    return (jfn.add_many(jfn.empty_state(), jnp.asarray(mask)),
            tfn.add_many(tfn.empty_state(), torch.from_numpy(mask)))


def _same_ss(jss, tss):
    np.testing.assert_array_equal(tss.vprime.numpy(), np.asarray(jss.vprime))
    assert tss.rounds == int(jss.rounds)
    np.testing.assert_array_equal(tss.alive_trace.numpy(), np.asarray(jss.alive_trace))
    np.testing.assert_allclose(float(tss.eps_hat), float(jss.eps_hat), rtol=1e-5)


def _same_greedy(jres, tres):
    np.testing.assert_array_equal(tres.selected.numpy(), np.asarray(jres.selected))
    np.testing.assert_allclose(tres.gains.numpy(), np.asarray(jres.gains),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tres.value), float(jres.value), rtol=1e-5)


# (objective, jax backend, compact, conditional state)
SS_CASES = [
    ("dense", "oracle", True, False),
    ("dense", "oracle", False, False),
    ("dense", "pallas", True, False),
    ("dense", "oracle", True, True),
    ("stream", "oracle", True, False),
    ("stream", "oracle", False, False),
    ("stream", "pallas", True, False),
    ("stream", "pallas", True, True),
]


@pytest.mark.parametrize("kind,backend,compact,with_state", SS_CASES)
def test_ss_sparsify_matches_jax_under_the_same_draws(kind, backend, compact,
                                                      with_state):
    n = 560
    jfn, tfn = _pair(kind, n)
    kw_j, kw_t = {}, {}
    if with_state:
        kw_j["state"], kw_t["state"] = _state(jfn, tfn, n)
    jss = jss_sparsify(jfn, jax.random.PRNGKey(1), r=8, c=8.0, backend=backend,
                       compact=compact, **kw_j)
    tss = ss_sparsify(tfn, r=8, c=8.0, compact=compact,
                      noise=_replay(1, n, max_rounds(n, 8, 8.0)), **kw_t)
    assert tss.rounds > 1
    _same_ss(jss, tss)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("kind,case", [("dense", "alive"), ("dense", "state"),
                                       ("stream", "alive"), ("stream", "full")])
def test_greedy_matches_jax(kind, case, compact):
    n, k = 400, 10
    jfn, tfn = _pair(kind, n, seed=2)
    kw_j, kw_t = {}, {}
    if case in ("alive", "state"):
        keep = np.random.default_rng(2).random(n) < 0.2
        kw_j["alive"], kw_t["alive"] = jnp.asarray(keep), torch.from_numpy(keep)
    if case == "state":
        kw_j["state"], kw_t["state"] = _state(jfn, tfn, n)
    jres = jgreedy(jfn, k, backend="oracle", compact=compact, **kw_j)
    tres = greedy(tfn, k, compact=compact, **kw_t)
    _same_greedy(jres, tres)


@pytest.mark.parametrize("kind,backend", [("dense", "oracle"), ("dense", "pallas"),
                                          ("stream", "oracle")])
def test_summarize_matches_jax(kind, backend):
    n, k = 600, 10
    jfn, tfn = _pair(kind, n, seed=5)
    jres, jss = jsummarize(jfn, k, jax.random.PRNGKey(7), backend=backend)
    tres, tss = summarize(tfn, k, noise=_replay(7, n, max_rounds(n)))
    _same_ss(jss, tss)
    _same_greedy(jres, tres)
    assert float(tres.value / greedy(tfn, k).value) > 0.95


def test_dense_and_streaming_prune_and_pick_the_same_in_the_port():
    """The port's counterpart of tests/test_fl_stream.py's pipeline parity:
    the same features and the same draws give the same V' and picks."""
    n = 300
    X = np.array(jax.random.normal(jax.random.PRNGKey(0), (n, 12)))
    from repro_torch import StreamingFacilityLocation, facility_location_from_features

    dense = facility_location_from_features(X, "cosine", device="cpu")
    sfl = StreamingFacilityLocation.from_features(torch.from_numpy(X), "cosine")
    noise = _replay(4, n, max_rounds(n, 6, 8.0))
    ss_d = ss_sparsify(dense, r=6, c=8.0, noise=noise)
    ss_s = ss_sparsify(sfl, r=6, c=8.0, noise=noise)
    assert 0 < int(ss_s.vprime.sum()) < n
    np.testing.assert_array_equal(ss_d.vprime.numpy(), ss_s.vprime.numpy())
    r_d = greedy(dense, 8, alive=ss_d.vprime)
    r_s = greedy(sfl, 8, alive=ss_s.vprime)
    np.testing.assert_array_equal(r_d.selected.numpy(), r_s.selected.numpy())
    np.testing.assert_allclose(float(r_s.value), float(r_d.value), rtol=1e-5)
