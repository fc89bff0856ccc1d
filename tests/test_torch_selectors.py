"""The port's other selectors held against the JAX package under the same
random draws: stochastic greedy (full width and compact), lazy greedy and
bidirectional greedy, over FeatureCoverage and facility location (dense and
matrix-free), plus the CPU run of ``examples/quickstart_torch.py``.

Stochastic greedy in JAX draws step i's Gumbel noise as
``gumbel(kk, (m,))`` for the i-th ``kk`` of ``split(key, k)``, with m = n
on the full-width path and m = the compact bucket on the compact path.
``_gumbel_rows`` rebuilds those draws and hands them to the port as
``noise``: ``selected`` must be identical, gains and values equal to rtol
1e-4 (the repository's float32 kernel tolerance; the per-step gains are
float32 sums over F features or n served rows).  Bidirectional greedy in
JAX draws ``bernoulli(kk, p)`` for the v-th ``kk`` of ``split(key, n)``,
which is ``uniform(kk, ()) < p`` (pinned below); ``_uniforms`` rebuilds
those uniforms.
"""

import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import FacilityLocation as JFacilityLocation
from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import StreamingFacilityLocation as JStreamingFacilityLocation
from repro.core import auto_sample_size as jauto_sample_size
from repro.core import lazy_greedy as jlazy_greedy
from repro.core import selection_bucket as jselection_bucket
from repro.core import stochastic_greedy as jstochastic_greedy
from repro.core.greedy import bidirectional_greedy as jbidirectional_greedy
from repro.data.synthetic import clustered_embeddings, news_day, video
from repro_torch import (
    auto_sample_size,
    bidirectional_greedy,
    facility_location_from_numpy,
    feature_coverage_from_numpy,
    greedy,
    lazy_greedy,
    stochastic_greedy,
    streaming_facility_location_from_numpy,
)
from repro_torch.core import selection_bucket

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-4


def _gumbel_rows(seed, k, m):
    keys = jax.random.split(jax.random.PRNGKey(seed), k)
    return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(kk, (m,)))
                                      for kk in keys]))


def _uniforms(seed, n):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(kk, ()))
                                      for kk in keys]))


def _pair(kind, n, seed=0):
    """The same objective in both packages, from the JAX side's own arrays."""
    if kind == "fc":
        W = news_day(seed, n, 96)
        return (JFeatureCoverage(W=jnp.asarray(W)),
                feature_coverage_from_numpy(W, device="cpu"))
    if kind == "fc_weighted":
        W = news_day(seed, n, 64)
        fw = np.linspace(0.5, 1.5, 64).astype(np.float32)
        return (JFeatureCoverage(W=jnp.asarray(W), feat_w=jnp.asarray(fw),
                                 phi="log1p"),
                feature_coverage_from_numpy(W, fw, phi="log1p", device="cpu"))
    if kind == "fl":
        jfn = JFacilityLocation.from_features(jnp.asarray(video(seed, n, 32)),
                                              kernel="cosine")
        return jfn, facility_location_from_numpy(np.asarray(jfn.sim), device="cpu")
    jfn = JStreamingFacilityLocation.from_features(
        jnp.asarray(clustered_embeddings(seed, n, 16)), kernel="dot")
    return jfn, streaming_facility_location_from_numpy(np.asarray(jfn.X),
                                                       device="cpu")


def _sparse_alive(n, seed=11, p=0.15):
    keep = np.random.default_rng(seed).random(n) < p
    return jnp.asarray(keep), torch.from_numpy(keep)


def _same(jres, tres):
    np.testing.assert_array_equal(tres.selected.numpy(), np.asarray(jres.selected))
    np.testing.assert_allclose(tres.gains.numpy(), np.asarray(jres.gains),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(float(tres.value), float(jres.value), rtol=RTOL)


OBJECTIVES = ["fc", "fc_weighted", "fl", "sfl"]


# ------------------------------------------------------- stochastic greedy --
# (path, s): "compact" runs over the V'-like sparse mask's bucket, "full" over
# all of V, "full_masked" over the sparse mask at full width (compact=False),
# "state" over the bucket from a conditional start.
@pytest.mark.parametrize("path,s", [("compact", None), ("full", None),
                                    ("full_masked", 12), ("full_masked", None),
                                    ("state", 5)])
@pytest.mark.parametrize("kind", OBJECTIVES)
def test_stochastic_greedy_matches_jax_under_the_same_draws(kind, path, s):
    n, k = 400, 8
    jfn, tfn = _pair(kind, n)
    ja, ta = _sparse_alive(n)
    kw_j, kw_t = {}, {}
    if path != "full":
        kw_j["alive"], kw_t["alive"] = ja, ta
    if path == "full_masked":
        kw_j["compact"] = kw_t["compact"] = False
    if path == "state":
        mask = np.arange(n) % 41 == 0
        kw_j["state"] = jfn.add_many(jfn.empty_state(), jnp.asarray(mask))
        kw_t["state"] = tfn.add_many(tfn.empty_state(), torch.from_numpy(mask))
    size = (selection_bucket(n, int(ta.sum())) if path in ("compact", "state")
            else None)
    assert size is None or size < n            # the compact path really runs
    m = n if size is None else size
    jres = jstochastic_greedy(jfn, k, jax.random.PRNGKey(3), s=s,
                              backend="oracle", **kw_j)
    tres = stochastic_greedy(tfn, k, s=s, noise=_gumbel_rows(3, k, m), **kw_t)
    _same(jres, tres)
    if "alive" in kw_t:
        assert bool(ta[tres.selected].all())


class _HostReads(TorchDispatchMode):
    """Counts the operators that read a tensor's value back to the host (on
    the card, each is a wait for the device): ``.item()`` and what calls it,
    such as ``int()``, ``bool()`` and indexing by a 0-d tensor, and
    ``nonzero``, whose output size depends on the data."""

    READS = (torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.nonzero.default)

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in self.READS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("where", ["V", "compact"])
@pytest.mark.parametrize("selector", ["greedy", "stochastic_greedy"])
@pytest.mark.parametrize("kind", ["fc", "fl", "sfl"])
def test_selection_steps_read_nothing_back_to_the_host(kind, selector, where):
    """The step loop of greedy and stochastic greedy reads no value back to
    the host: a run of 6 steps makes as many host reads as a run of 1 (the
    reads before the loop, such as the live count that sizes the bucket)."""
    n = 300
    _, tfn = _pair(kind, n, seed=3)
    alive = None if where == "V" else _sparse_alive(n)[1]

    def reads(k):
        with _HostReads() as mode:
            if selector == "greedy":
                greedy(tfn, k, alive=alive)
            else:
                stochastic_greedy(tfn, k, torch.Generator().manual_seed(1),
                                  alive=alive)
        return mode.count

    assert reads(6) == reads(1)


def test_stochastic_greedy_pallas_reference_draws_match_too():
    """The JAX pallas backend (interpret mode) under the same key picks what
    the port picks under the replayed draws."""
    from repro.core import PallasBackend

    n, k = 384, 6
    jfn, tfn = _pair("fc", n, seed=2)
    ja, ta = _sparse_alive(n, seed=5)
    size = selection_bucket(n, int(ta.sum()))
    jres = jstochastic_greedy(jfn, k, jax.random.PRNGKey(9), alive=ja,
                              backend=PallasBackend(interpret=True))
    tres = stochastic_greedy(tfn, k, alive=ta, noise=_gumbel_rows(9, k, size))
    _same(jres, tres)


def test_stochastic_greedy_exhausts_and_starts_from_a_state():
    """k > |alive|: the live elements first, then index 0 with gain 0; a
    conditional start adds value on top of the state's."""
    n = 256
    _, tfn = _pair("fc", n, seed=12)
    alive = torch.arange(n) < 4
    g = torch.Generator().manual_seed(6)
    res = stochastic_greedy(tfn, 7, g, alive=alive)
    assert set(res.selected[:4].tolist()) == {0, 1, 2, 3}
    assert (res.selected[4:] == 0).all() and (res.gains[4:] == 0).all()
    state = tfn.add_many(tfn.empty_state(), alive)
    _, ta = _sparse_alive(n)
    res2 = stochastic_greedy(tfn, 5, g, alive=ta, state=state)
    assert float(res2.value) > float(tfn.value(state))


def test_stochastic_greedy_samples_in_compact_space_and_stays_alive():
    n, k = 512, 8
    _, tfn = _pair("fc", n, seed=11)
    _, ta = _sparse_alive(n)
    live = int(ta.sum())
    assert auto_sample_size(n, k, eps=0.1, live=live) < auto_sample_size(n, k)
    res = stochastic_greedy(tfn, k, torch.Generator().manual_seed(5), alive=ta)
    assert len(set(res.selected.tolist())) == k
    assert bool(ta[res.selected].all()) and float(res.value) > 0


def test_stochastic_greedy_quality_close_to_greedy():
    """Post-SS-like stochastic greedy at eps = 0.05 stays within 10% of
    greedy on the same live set (the reference's bound)."""
    n, k = 400, 8
    _, tfn = _pair("fc", n, seed=13)
    _, ta = _sparse_alive(n)
    g = greedy(tfn, k, alive=ta)
    sg = stochastic_greedy(tfn, k, torch.Generator().manual_seed(8), alive=ta,
                           eps=0.05)
    assert float(sg.value) >= 0.9 * float(g.value)


@pytest.mark.parametrize("s", [1, 3])
def test_stochastic_sample_breaks_ties_toward_the_lower_index(s):
    """Equal draws at the s-th place: the lower index joins the sample, as
    ``jax.lax.top_k`` orders them (``torch.topk`` keeps no order).  The tied
    element of higher index has the larger gain, so a wrong tie rule would
    pick it."""
    n = 12
    W = np.full((n, 4), 0.01, np.float32)
    W[3], W[7] = 0.2, 0.9
    tfn = feature_coverage_from_numpy(W, device="cpu")
    row = np.zeros(n, np.float32)
    row[:s - 1] = 9.0            # the s - 1 largest, ahead of the tie
    row[[3, 7]] = 5.0            # tied for the s-th place
    top = np.asarray(jax.lax.top_k(jnp.asarray(row), s)[1])
    assert 3 in top and 7 not in top
    res = stochastic_greedy(tfn, 1, s=s, noise=torch.from_numpy(row[None]))
    assert int(res.selected[0]) == 3


def test_stochastic_greedy_noise_is_checked():
    _, tfn = _pair("fc", 300)
    with pytest.raises(ValueError, match="noise must be"):
        stochastic_greedy(tfn, 4, noise=torch.zeros(4, 299))
    bad = torch.zeros(4, 300)
    bad[2, 5] = float("nan")
    with pytest.raises(ValueError, match="finite"):
        stochastic_greedy(tfn, 4, noise=bad)


def test_auto_sample_size_matches_jax_and_its_bounds():
    assert auto_sample_size(1000, 10, eps=0.1, live=100) == 24  # 10 ln 10
    assert auto_sample_size(1000, 10, eps=0.1) >= 230
    assert auto_sample_size(16, 64, eps=0.5) == 1               # floor at 1
    for n, k, eps, live in ((2**20, 32, 0.1, None), (2**20, 32, 0.1, 1444),
                            (300, 7, 0.05, 31), (5, 0, 0.3, None)):
        assert auto_sample_size(n, k, eps, live) == jauto_sample_size(n, k, eps, live)
    for n in (256, 300, 2048):
        for live in (1, 17, n // 4, n - 1, n):
            assert selection_bucket(n, live) == jselection_bucket(n, live)


# ------------------------------------------------------------- lazy greedy --
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", OBJECTIVES)
def test_lazy_greedy_matches_jax_and_greedy(kind, masked):
    n, k = 240, 7
    jfn, tfn = _pair(kind, n, seed=4)
    ja, ta = _sparse_alive(n, p=0.3) if masked else (None, None)
    jres = jlazy_greedy(jfn, k, None if ja is None else np.asarray(ja))
    tres = lazy_greedy(tfn, k, alive=ta)
    _same(jres, tres)
    g = greedy(tfn, k, alive=ta)
    np.testing.assert_array_equal(tres.selected.numpy(), g.selected.numpy())
    np.testing.assert_allclose(float(tres.value), float(g.value), rtol=RTOL)
    assert tres.reevaluations >= 0


def test_lazy_greedy_pads_past_the_live_set():
    n = 64
    jfn, tfn = _pair("fc", n, seed=1)
    alive = np.arange(n) < 3
    jres = jlazy_greedy(jfn, 5, alive)
    tres = lazy_greedy(tfn, 5, alive=torch.from_numpy(alive))
    _same(jres, tres)
    assert (tres.selected[3:] == 0).all() and (tres.gains[3:] == 0).all()


# ----------------------------------------------------- bidirectional greedy --
def test_bernoulli_is_a_uniform_draw_below_p():
    """What the port's replay rests on: in this jax, bernoulli(kk, p) is
    uniform(kk, ()) < p, draw for draw."""
    keys = jax.random.split(jax.random.PRNGKey(0), 64)
    for i, kk in enumerate(keys):
        p = jnp.float32((i % 9) / 8.0 * 0.999 + 1e-3)
        assert bool(jax.random.bernoulli(kk, p)) == bool(
            jax.random.uniform(kk, ()) < p)


def _cut_gain_fns(n, seed):
    """A weighted cut function h(X) = sum of A[i, j] over i in X, j not in X
    (non-monotone submodular), as gain functions of both packages."""
    A = np.random.default_rng(seed).random((n, n)).astype(np.float32)
    A = np.triu(A, 1) + np.triu(A, 1).T
    jA, tA = jnp.asarray(A), torch.from_numpy(A)

    def h_j(mask):
        return jnp.sum(jnp.where(mask[:, None] & ~mask[None, :], jA, 0.0))

    def h_t(mask):
        return torch.where(mask[:, None] & ~mask[None, :], tA, 0.0).sum()

    def jgain(lo, hi, v):
        return (h_j(lo.at[v].set(True)) - h_j(lo),
                h_j(hi.at[v].set(False)) - h_j(hi))

    def tgain(lo, hi, v):
        lo2, hi2 = lo.clone(), hi.clone()
        lo2[v], hi2[v] = True, False
        return h_t(lo2) - h_t(lo), h_t(hi2) - h_t(hi)

    return jgain, tgain


@pytest.mark.parametrize("randomized", [True, False])
def test_bidirectional_greedy_matches_jax(randomized):
    n = 40
    jgain, tgain = _cut_gain_fns(n, seed=2)
    jmask = jbidirectional_greedy(jgain, n, jax.random.PRNGKey(5),
                                  randomized=randomized)
    tmask = bidirectional_greedy(tgain, n, randomized=randomized,
                                 noise=_uniforms(5, n))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert 0 < int(tmask.sum()) < n


def test_bidirectional_greedy_defaults_to_the_card(monkeypatch):
    """With no noise and no generator the masks and draws live on the card,
    as the port's other entry points default to it; the host is asked for."""
    n = 6
    _, tgain = _cut_gain_fns(n, seed=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bidirectional_greedy(tgain, n)
    cpu = bidirectional_greedy(tgain, n, torch.Generator())
    assert cpu.device.type == "cpu"


def test_bidirectional_greedy_draws_from_a_generator():
    n = 30
    _, tgain = _cut_gain_fns(n, seed=3)
    a = bidirectional_greedy(tgain, n, torch.Generator().manual_seed(1))
    b = bidirectional_greedy(tgain, n, noise=torch.rand(
        n, generator=torch.Generator().manual_seed(1)))
    assert torch.equal(a, b)


# -------------------------------------------------------------- quickstart --
def test_quickstart_torch_runs_on_the_cpu(monkeypatch, capsys):
    """The example at a small N on the host, asserts included."""
    path = ROOT / "examples" / "quickstart_torch.py"
    monkeypatch.setattr("sys.argv", [str(path), "--device", "cpu", "--n", "2048"])
    runpy.run_path(str(path), run_name="__main__")
    out = capsys.readouterr().out
    assert "OK: SS matches greedy" in out
    for line in ("stochastic greedy on V", "lazy greedy on V", "api.sessions",
                 "streaming FL"):
        assert line in out
