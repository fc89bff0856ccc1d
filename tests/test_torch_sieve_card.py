"""The sieve's gain-table kernel (``csrc/sieve_gains.cu``) against its plain
version, on the card.  These tests need a CUDA card (marker ``cuda``) and
skip without one; they import nothing of JAX, so they run where the card
is:

    python -m pytest -m cuda tests/test_torch_sieve_card.py

Facility location's table is the plain one bit for bit (one summation
order, exact max and add); FeatureCoverage's too for every phi but sqrt,
whose kernel uses ``sqrt.approx`` (within 1e-5 relative of the table's
size, a few ulps of the sum), over one slab of leaves and over three (the
kernel's scratch and its finishing sum), at densities where the sparse
route's blocks walk the nonzeros (1 %) and where they go dense (20 % over
three slabs), for 11 sieves and for a re-launch's 1 and 4.  The sparse
route's two loops give the same bits for the same rows.
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
from repro_torch.kernels import sieve_gains as sg


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sieve kernel has no CPU route")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [11, 1, 4])
@pytest.mark.parametrize("density", [0.2, 0.01])
@pytest.mark.parametrize("L", [300, 2 * 4096 + 77], ids=["one_slab", "three_slabs"])
@pytest.mark.parametrize("cols", [False, True], ids=["rows", "cols"])
@pytest.mark.parametrize("phi", [None, "sqrt", "log1p", "setcover", "satcov",
                                 "linear"])
def test_sieve_gains_matches_its_plain_version(card, phi, cols, L, density, R):
    g = card
    n_e = 500
    S = torch.rand((R, L), generator=g, device="cuda")
    W = torch.rand((n_e, L), generator=g, device="cuda")
    W = W * (torch.rand((n_e, L), generator=g, device="cuda") < density)
    E = W.T.contiguous() if cols else W
    idx = torch.randint(0, n_e, (601,), generator=g, device="cuda")
    idx[[0, 300, 600]] = -1                               # zero elements
    fw = torch.rand((L,), generator=g, device="cuda") if phi == "log1p" else None
    cap = torch.full((L,), 0.7, device="cuda") if phi == "satcov" else None
    el = SieveElements(E, idx, cols, phi, fw, cap)
    route = "sparse" if phi is not None and not cols else "tile"
    assert sg.sieve_route(el) == route
    before = (sieve_gains_kernel.launches, sieve_gains_kernel.launches_sparse,
              sieve_gains_kernel.launches_tile)
    got = sieve_gains_kernel(S, el)
    torch.cuda.synchronize()
    assert (sieve_gains_kernel.launches, sieve_gains_kernel.launches_sparse,
            sieve_gains_kernel.launches_tile) == (
        before[0] + 1, before[1] + (route == "sparse"), before[2] + (route == "tile"))
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
@pytest.mark.parametrize("phi", ["sqrt", "log1p", "satcov"])
@pytest.mark.parametrize("L", [1024, 2 * 4096 + 77], ids=["one_slab", "three_slabs"])
def test_sparse_and_dense_blocks_give_the_same_bits(card, phi, L):
    """Block 0 of the columns holds a sparse block's rows at 1 % density
    (the sparse loop), block 1 the same rows with row 7 made dense (the
    tile): the kernel's own flags say so, and the other rows' entries are
    equal bit for bit, also with a start."""
    g = card
    B, R = sg.SIEVE_SPARSE_BLOCK, 13
    S = torch.rand((R, L), generator=g, device="cuda")
    S *= torch.rand((R, L), generator=g, device="cuda") < 0.3
    W = torch.rand((B + 1, L), generator=g, device="cuda")
    W[:B] *= torch.rand((B, L), generator=g, device="cuda") < 0.01
    idx = torch.cat([torch.arange(B), torch.arange(B)]).cuda()
    idx[B + 7] = B                                        # the dense row
    cap = 0.2 * W.sum(0) + 0.01 if phi == "satcov" else None
    el = SieveElements(W, idx, False, phi, None, cap)
    keep = torch.arange(B, device="cuda") != 7
    start = torch.randint(0, 2 * B, (R,), generator=g, device="cuda")
    for st in (None, start):
        out, flags = sg._launch(S, el, st)
        torch.cuda.synchronize()
        assert flags.tolist() == [0, 1]
        a, b = out[:, :B][:, keep], out[:, B:][:, keep]
        if st is None:
            assert torch.equal(a, b)
        else:
            due = (torch.arange(B, device="cuda")[keep][None, :] >= st[:, None])
            assert torch.equal(torch.where(due, a, 0.0), torch.where(due, b, 0.0))


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
