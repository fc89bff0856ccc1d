"""The sieve's gain-table kernel (``csrc/sieve_gains.cu``) against its plain
version, on the card.  These tests need a CUDA card (marker ``cuda``) and
skip without one; they import nothing of JAX, so they run where the card
is:

    python -m pytest -m cuda tests/test_torch_sieve_card.py

Facility location's table is the plain one bit for bit (one summation
order, exact max and add); FeatureCoverage's too for every phi but sqrt,
whose kernel uses ``sqrt.approx`` (within 1e-5 relative of the table's
size, a few ulps of the sum), over one slab of leaves and over three (the
kernel's scratch and its finishing sum).
"""

import pytest
import torch

from repro_torch import (
    StreamingFacilityLocation,
    facility_location_from_features,
    feature_coverage_from_numpy,
    sieve_extend,
    sieve_init,
)
from repro_torch.data import clustered_embeddings, news_day, video
from repro_torch.kernels import SieveElements, sieve_gains_kernel, sieve_gains_ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sieve kernel has no CPU route")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [300, 2 * 4096 + 77], ids=["one_slab", "three_slabs"])
@pytest.mark.parametrize("cols", [False, True], ids=["rows", "cols"])
@pytest.mark.parametrize("phi", [None, "sqrt", "log1p", "setcover", "satcov",
                                 "linear"])
def test_sieve_gains_matches_its_plain_version(card, phi, cols, L):
    g = card
    R, n_e = 11, 500
    S = torch.rand((R, L), generator=g, device="cuda")
    W = torch.rand((n_e, L), generator=g, device="cuda")
    W = W * (torch.rand((n_e, L), generator=g, device="cuda") < 0.2)
    E = W.T.contiguous() if cols else W
    idx = torch.randint(0, n_e, (601,), generator=g, device="cuda")
    idx[[0, 300, 600]] = -1                               # zero elements
    fw = torch.rand((L,), generator=g, device="cuda") if phi == "log1p" else None
    cap = torch.full((L,), 0.7, device="cuda") if phi == "satcov" else None
    el = SieveElements(E, idx, cols, phi, fw, cap)
    before = sieve_gains_kernel.launches
    got = sieve_gains_kernel(S, el)
    torch.cuda.synchronize()
    assert sieve_gains_kernel.launches == before + 1
    want = sieve_gains_ref(S, E, idx, cols=cols, phi=phi, feat_w=fw, cap=cap)
    if phi == "sqrt":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    else:
        assert torch.equal(got, want)
    # a start skips a row's earlier columns; the zero element is always due
    start = torch.randint(0, 601, (R,), generator=g, device="cuda")
    part = sieve_gains_kernel(S, el, start)
    due = (torch.arange(601, device="cuda")[None, :] >= start[:, None]) | (idx == -1)
    assert torch.equal(torch.where(due, part, 0.0), torch.where(due, got, 0.0))
    bad = idx.clone()
    bad[5] = n_e
    assert torch.isnan(sieve_gains_kernel(S, el._replace(idx=bad))[:, 5]).all()


@pytest.mark.cuda
def test_sieve_on_the_card_decides_as_the_plain_table(card):
    n = 1024
    objectives = [
        feature_coverage_from_numpy(news_day(0, n, 256)),
        facility_location_from_features(video(0, n, 64), "cosine"),
        StreamingFacilityLocation.from_features(
            torch.from_numpy(clustered_embeddings(0, n, 16)).cuda(), "dot"),
    ]
    stream = torch.arange(n, device="cuda")
    for fn in objectives:
        for eps in (None, 0.2):
            a = sieve_extend(fn, sieve_init(fn, 8, eps=eps), stream)
            b = sieve_extend(fn, sieve_init(fn, 8, eps=eps), stream,
                             backend="reference")
            assert torch.equal(a.sel, b.sel) and torch.equal(a.counts, b.counts)
