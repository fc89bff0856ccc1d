"""The port's SS, greedy and summarize held against the JAX package under the
same random draws.

The JAX loop draws round j's Gumbel noise as ``key, k1 = split(key);
gumbel(k1, (n,))`` (``repro/core/sparsify.py``).  ``_replay`` rebuilds those
draws with JAX and hands them to the port as ``noise``, so both sides sample
the same probes: ``vprime``, ``rounds`` and ``alive_trace`` must be identical
and ``eps_hat`` equal to rtol 1e-5.  The JAX side runs on ``oracle`` and on
``pallas`` (interpret mode); the port on its plain path, the only one on the
CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import greedy as jgreedy
from repro.core import ss_sparsify as jss_sparsify
from repro.core.sparsify import max_rounds
from repro.core.sparsify import preprune_mask as jpreprune_mask
from repro.core.sparsify import summarize as jsummarize
from repro.data.synthetic import news_day
from repro_torch import feature_coverage_from_numpy, greedy, ss_sparsify, summarize
from repro_torch.core.sparsify import preprune_mask


def _replay(seed, n, rounds):
    key, rows = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, k1 = jax.random.split(key)
        rows.append(np.asarray(jax.random.gumbel(k1, (n,))))
    return torch.from_numpy(np.stack(rows))


def _pair(n, F, phi="sqrt", weighted=False, seed=3):
    W = news_day(seed, n, F)
    fw = np.linspace(0.5, 1.5, F).astype(np.float32) if weighted else None
    jfn = JFeatureCoverage(W=jnp.asarray(W),
                           feat_w=None if fw is None else jnp.asarray(fw),
                           phi=phi)
    return jfn, feature_coverage_from_numpy(W, fw, phi=phi, device="cpu")


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


# (jax backend, compact, n, F, phi, weighted, start)
SS_CASES = [
    ("oracle", True, 1500, 128, "sqrt", False, None),
    ("oracle", False, 1500, 128, "sqrt", False, None),
    ("pallas", True, 1500, 128, "sqrt", False, None),
    ("pallas", False, 1024, 128, "sqrt", False, None),
    ("oracle", True, 2048, 256, "log1p", True, None),
    ("pallas", True, 1000, 96, "satcov", False, None),
    ("oracle", True, 1500, 128, "sqrt", False, "importance"),
    ("oracle", True, 1500, 128, "setcover", True, "state"),
    ("oracle", True, 1500, 128, "sqrt", False, "preprune"),
]


@pytest.mark.parametrize("backend,compact,n,F,phi,weighted,start", SS_CASES)
def test_ss_sparsify_matches_jax_under_the_same_draws(
    backend, compact, n, F, phi, weighted, start
):
    jfn, tfn = _pair(n, F, phi, weighted)
    kw_j, kw_t = {}, {}
    if start == "importance":
        kw_j["importance"] = kw_t["importance"] = True
    elif start == "state":
        mask = np.arange(n) % 97 == 0
        kw_j["state"] = jfn.add_many(jfn.empty_state(), jnp.asarray(mask))
        kw_t["state"] = tfn.add_many(tfn.empty_state(), torch.from_numpy(mask))
    elif start == "preprune":
        jalive, talive = jpreprune_mask(jfn, 10), preprune_mask(tfn, 10)
        np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
        # pre-pruning keeps all of this corpus; thin the start further so the
        # initial mask really differs from V
        keep = np.random.default_rng(4).random(n) < 0.7
        kw_j["alive"] = jalive & jnp.asarray(keep)
        kw_t["alive"] = talive & torch.from_numpy(keep)
    jss = jss_sparsify(jfn, jax.random.PRNGKey(1), r=8, c=8.0,
                       backend=backend, compact=compact, **kw_j)
    tss = ss_sparsify(tfn, r=8, c=8.0, compact=compact,
                      noise=_replay(1, n, max_rounds(n, 8, 8.0)), **kw_t)
    _same_ss(jss, tss)


def test_ss_compact_and_full_width_agree_under_a_generator():
    _, tfn = _pair(1500, 64)
    a = ss_sparsify(tfn, torch.Generator().manual_seed(5), compact=True)
    b = ss_sparsify(tfn, torch.Generator().manual_seed(5), compact=False)
    np.testing.assert_array_equal(a.vprime.numpy(), b.vprime.numpy())
    assert a.rounds == b.rounds > 1
    assert float(a.eps_hat) == float(b.eps_hat)


def test_ss_noise_shape_is_checked():
    _, tfn = _pair(300, 32)
    with pytest.raises(ValueError):
        ss_sparsify(tfn, noise=torch.zeros(2, 300))
    bad = torch.zeros(max_rounds(300), 300)
    bad[0, 7] = float("inf")
    with pytest.raises(ValueError):
        ss_sparsify(tfn, noise=bad)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("case", ["full", "alive", "exhausted", "state"])
def test_greedy_matches_jax(case, compact):
    n, F = 1200, 96
    jfn, tfn = _pair(n, F, "sqrt", weighted=case == "state")
    k, kw_j, kw_t = 12, {}, {}
    if case in ("alive", "exhausted", "state"):
        keep = np.random.default_rng(2).random(n) < (0.004 if case == "exhausted"
                                                     else 0.2)
        kw_j["alive"], kw_t["alive"] = jnp.asarray(keep), torch.from_numpy(keep)
        if case == "exhausted":
            assert int(keep.sum()) < k  # k > |alive|
    if case == "state":
        mask = np.arange(n) % 50 == 0
        kw_j["state"] = jfn.add_many(jfn.empty_state(), jnp.asarray(mask))
        kw_t["state"] = tfn.add_many(tfn.empty_state(), torch.from_numpy(mask))
    jres = jgreedy(jfn, k, backend="oracle", compact=compact, **kw_j)
    tres = greedy(tfn, k, compact=compact, **kw_t)
    _same_greedy(jres, tres)
    if case == "exhausted":
        live = int(kw_t["alive"].sum())
        assert (tres.selected[live:] == 0).all() and (tres.gains[live:] == 0).all()


def test_greedy_compact_and_full_width_pick_the_same():
    _, tfn = _pair(600, 32)
    alive = torch.arange(600) % 3 == 0
    same = greedy(tfn, 5, alive=alive)
    ref = greedy(tfn, 5, alive=alive, compact=False)
    np.testing.assert_array_equal(same.selected.numpy(), ref.selected.numpy())
    np.testing.assert_array_equal(same.gains.numpy(), ref.gains.numpy())


@pytest.mark.parametrize("backend,compact", [("oracle", True), ("pallas", True),
                                             ("oracle", False)])
def test_summarize_matches_jax(backend, compact):
    n, F, k = 2048, 128, 10
    jfn, tfn = _pair(n, F, seed=5)
    jres, jss = jsummarize(jfn, k, jax.random.PRNGKey(7), backend=backend,
                           compact=compact)
    tres, tss = summarize(tfn, k, noise=_replay(7, n, max_rounds(n)),
                          compact=compact)
    _same_ss(jss, tss)
    _same_greedy(jres, tres)
    full = greedy(tfn, k)
    assert float(tres.value / full.value) > 0.95
