"""Batched SS and greedy on the card: each batched primitive launches the
single-query kernel once per row, so row b of a batched run equals the
card's own single-query run bit for bit.  These tests need a CUDA card
(marker ``cuda``) and skip without one; they import nothing of JAX:

    python -m pytest -m cuda tests/test_torch_batched_card.py
"""

import pytest
import torch

from repro_torch import (
    FacilityLocation,
    FeatureCoverage,
    greedy,
    greedy_batched,
    ss_sparsify,
    ss_sparsify_batched,
    stochastic_greedy,
    stochastic_greedy_batched,
)
from repro_torch.core.greedy import _batched_compact_plan
from repro_torch.data import news_day, video
from repro_torch.kernels import (
    feature_gains_kernel,
    fl_divergence_kernel,
    fl_gains_kernel,
    ss_divergence_kernel,
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the batched route launches CUDA kernels")
    return torch.device("cuda")


def _objective(kind, B, n, dev):
    if kind == "coverage":
        W = torch.stack([torch.from_numpy(news_day(b, n, 128)) for b in range(B)])
        return FeatureCoverage(W=W.to(dev))
    sims = [FacilityLocation.from_features(torch.from_numpy(video(b, n, 32)).to(dev),
                                           "cosine").sim for b in range(B)]
    return FacilityLocation(sim=torch.stack(sims))


def _gens(B, dev, base=0):
    return [torch.Generator(device=dev).manual_seed(base + b) for b in range(B)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["coverage", "fl"])
def test_batched_rows_equal_the_cards_sequential_rows(card, kind):
    B, n, k = 3, 4096, 12
    fn = _objective(kind, B, n, card)
    div_k, gains_k = ((ss_divergence_kernel, feature_gains_kernel) if kind == "coverage"
                      else (fl_divergence_kernel, fl_gains_kernel))
    div_k.launches = gains_k.launches = 0
    ss = ss_sparsify_batched(fn, _gens(B, card))
    res = greedy_batched(fn, k, alive=ss.vprime)
    assert div_k.launches == sum(ss.rounds)          # one launch a row a round
    assert gains_k.launches == B * k                 # one launch a row a step
    g = _gens(B, card)
    for b in range(B):
        one = ss_sparsify(fn.row(b), g[b])
        assert torch.equal(one.vprime, ss.vprime[b]) and one.rounds == ss.rounds[b]
        assert torch.equal(one.eps_hat, ss.eps_hat[b])
        assert torch.equal(one.alive_trace, ss.alive_trace[b])
        sel = greedy(fn.row(b), k, alive=one.vprime)
        assert torch.equal(sel.selected, res.selected[b])
        assert torch.equal(sel.gains, res.gains[b])


@pytest.mark.cuda
def test_stochastic_batched_rows_equal_the_cards_dense_rows(card):
    B, n, k = 3, 4096, 8
    fn = _objective("coverage", B, n, card)
    alive = torch.stack([torch.arange(n, device=card) % m == 0 for m in (40, 45, 50)])
    size, live = _batched_compact_plan(n, alive, None)
    res = stochastic_greedy_batched(fn, k, _gens(B, card, 9), s=30, alive=alive)
    g = _gens(B, card, 9)
    for b in range(B):
        one = stochastic_greedy(fn.row(b), k, g[b], s=30, alive=alive[b])
        assert torch.equal(one.selected, res.selected[b])
        assert torch.equal(one.gains, res.gains[b])
    assert size is not None and live == int(alive.sum(1).max())
