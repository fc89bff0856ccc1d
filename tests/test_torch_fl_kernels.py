"""The port's facility-location kernel wrappers and their plain versions, held
against the JAX package's Pallas kernels in interpret mode, and the plain
matrix-free passes against their JAX counterparts, on shared numpy inputs.

On the CPU a wrapper runs its kernel's plain version, so this checks the
arithmetic the CUDA kernels (``csrc/fl_divergence.cu``, ``csrc/fl_stream.cu``)
are held to on the card by ``chip_smoke.py``.  Tolerances are those of
``tests/test_kernels.py``: 1e-4 for float32 and 3e-2 for bfloat16 sim,
relative to the size of the sums (max |output| + max |resid| of the live
probes, at least 1).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FacilityLocation as JFacilityLocation
from repro.kernels import fl_stream as jfs
from repro.kernels.fl_divergence import fl_divergence_kernel as j_fl_divergence
from repro.kernels.fl_divergence import fl_gains_kernel as j_fl_gains
from repro_torch.kernels import (
    fl_divergence_kernel,
    fl_divergence_ref,
    fl_gains_kernel,
    fl_stream_divergence_kernel,
    fl_stream_divergence_ref,
    fl_stream_gains_kernel,
)
from repro_torch.kernels import fl_stream as tfs

NEG = -1e30
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
# non-multiple-of-tile candidate/served dims; r < 8 exercises probe padding
# (the shapes of tests/test_kernels.py)
FL_SHAPES = [(64, 3), (130, 5), (256, 16), (313, 9), (520, 24)]


def _close(out, ref, resid, tol):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    live = np.asarray(resid, np.float32)
    live = live[live > NEG / 2]
    scale = max(1.0, float(np.abs(ref).max()) + float(np.abs(live).max(initial=0)))
    assert out.shape == ref.shape
    assert float(np.abs(out - ref).max()) <= tol * scale


def _t(x, dtype=torch.float32):
    t = torch.from_numpy(np.array(x))
    return t.long() if t.dtype in (torch.int32, torch.int64) else t.to(dtype)


def _fl_sim(seed, n, kernel):
    X = jax.random.normal(jax.random.PRNGKey(seed), (n, 12))
    return np.asarray(JFacilityLocation.from_features(X, kernel=kernel).sim)


def _probe_inputs(rng, sim, r, with_state):
    ni, n = sim.shape
    probes = rng.choice(n, r, replace=False)
    state = (sim[:, rng.choice(n, 3, replace=False)].max(axis=1).clip(0)
             if with_state else np.zeros(ni, np.float32))
    MU = np.maximum(state[None, :], sim[:, probes].T).astype(np.float32)
    resid = rng.random(r).astype(np.float32) * 0.1
    resid[-1] = NEG   # a pad probe: never wins the min
    return MU, resid, state.astype(np.float32)


def _cand(rng, n):
    # compact buffers repeat indices and pad with 0, like the SS loop's
    return np.concatenate([np.sort(rng.choice(n, n // 3, replace=False)), [0, 0]])


DENSE = [(*case, i % 2 == 1, i % 4 >= 2) for i, case in enumerate(
    itertools.product(FL_SHAPES, ["cosine", "rbf"], DTYPES))]


@pytest.mark.parametrize("shape,kernel,dtype,compact,with_state", DENSE)
def test_fl_divergence_matches_pallas_interpret(shape, kernel, dtype, compact,
                                                with_state):
    n, r = shape
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(n + r)
    sim = _fl_sim(n, n, kernel)
    MU, resid, state = _probe_inputs(rng, sim, r, with_state)
    cand = _cand(rng, n) if compact else None
    jcand = None if cand is None else jnp.asarray(cand)
    jsim = jnp.asarray(sim).astype(jdt)
    tsim, tcand = _t(sim, tdt), None if cand is None else _t(cand)

    ref = j_fl_divergence(jsim, jnp.asarray(MU), jnp.asarray(resid), jcand,
                          interpret=True)
    before = fl_divergence_kernel.launches
    out = fl_divergence_kernel(tsim, _t(MU), _t(resid), tcand)
    assert fl_divergence_kernel.launches == before  # the CPU never launches
    assert out.dtype == torch.float32
    _close(out, ref, resid, tol)
    np.testing.assert_array_equal(
        out.numpy(), fl_divergence_ref(tsim, _t(MU), _t(resid), tcand).numpy())

    ref = j_fl_gains(jsim, jnp.asarray(state), jcand, interpret=True)
    before = fl_gains_kernel.launches
    out = fl_gains_kernel(tsim, _t(state), tcand)
    assert fl_gains_kernel.launches == before
    _close(out, ref, [0.0], tol)


@pytest.mark.parametrize("ni,compact", [(120, False), (120, True), (150, True)])
def test_fl_divergence_reads_an_asymmetric_sim_by_columns(ni, compact):
    """Candidates are columns and the sum runs down the rows: a kernel that
    read sim[v, i] would pass every symmetric input and fail here."""
    rng = np.random.default_rng(5)
    n, r = 120, 6
    sim = rng.random((ni, n), np.float32)
    sim[:, :10] *= 3.0   # columns of clearly different scale than rows
    probes = rng.choice(n, r, replace=False)
    MU = sim[:, probes].T.copy()
    resid = rng.random(r).astype(np.float32)
    cand = _cand(rng, n) if compact else None
    jcand = None if cand is None else jnp.asarray(cand)
    tcand = None if cand is None else _t(cand)
    ref = j_fl_divergence(jnp.asarray(sim), jnp.asarray(MU), jnp.asarray(resid),
                          jcand, interpret=True)
    out = fl_divergence_kernel(_t(sim), _t(MU), _t(resid), tcand)
    _close(out, ref, resid, 1e-4)
    if ni == n:   # the transposed reading gives another answer
        wrong = (np.maximum(sim[None, :, :] - MU[:, None, :], 0).sum(-1)
                 - resid[:, None]).min(0)
        wrong = wrong if cand is None else wrong[cand]
        assert np.abs(wrong - np.asarray(ref)).max() > 1.0
    state = sim[:, 3].copy()
    _close(fl_gains_kernel(_t(sim), _t(state), tcand),
           j_fl_gains(jnp.asarray(sim), jnp.asarray(state), jcand, interpret=True),
           [0.0], 1e-4)


STREAM = [(*case, i % 2 == 1) for i, case in enumerate(
    itertools.product([(64, 3), (313, 9)], [5, 12, 130], [False, True]))]


@pytest.mark.parametrize("shape,d,separate,compact", STREAM)
def test_fl_stream_divergence_matches_pallas_interpret(shape, d, separate, compact):
    n, r = shape
    rng = np.random.default_rng(n * d + r)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Xc = X
    if separate:   # candidate rows apart from the served rows (Xc != X)
        Xc = rng.normal(size=(n + 17, d)).astype(np.float32)
        Xc /= np.linalg.norm(Xc, axis=1, keepdims=True)
    sim = np.maximum(X @ Xc.T, 0.0)
    MU, resid, state = _probe_inputs(rng, sim, r, with_state=compact)
    cand = _cand(rng, Xc.shape[0]) if compact else None
    jcand = None if cand is None else jnp.asarray(cand)
    tcand = None if cand is None else _t(cand)
    jXc = jnp.asarray(Xc) if separate else None
    tXc = _t(Xc) if separate else None

    ref = jfs.fl_stream_divergence_kernel(jnp.asarray(X), jnp.asarray(MU),
                                          jnp.asarray(resid), jcand, jXc,
                                          interpret=True)
    before = fl_stream_divergence_kernel.launches
    out = fl_stream_divergence_kernel(_t(X), _t(MU), _t(resid), tcand, tXc)
    assert fl_stream_divergence_kernel.launches == before
    _close(out, ref, resid, 1e-4)
    np.testing.assert_array_equal(
        out.numpy(),
        fl_stream_divergence_ref(_t(X), _t(MU), _t(resid), tcand, tXc).numpy())
    # and the JAX block reference, with its own accumulation order
    _close(out, jfs.fl_stream_divergence_ref(jnp.asarray(X), jnp.asarray(MU),
                                             jnp.asarray(resid), jcand, jXc),
           resid, 1e-4)

    ref = jfs.fl_stream_gains_kernel(jnp.asarray(X), jnp.asarray(state), jcand,
                                     jXc, interpret=True)
    before = fl_stream_gains_kernel.launches
    out = fl_stream_gains_kernel(_t(X), _t(state), tcand, tXc)
    assert fl_stream_gains_kernel.launches == before
    _close(out, ref, [0.0], 1e-4)


def _tied_rows(seed, n=160, d=8, dup=12):
    rng = np.random.default_rng(seed)
    E = rng.normal(size=(n, d)).astype(np.float32)
    E /= np.linalg.norm(E, axis=1, keepdims=True)
    # duplicated candidates: the rows they serve best have tied maxima
    return E, np.concatenate([E, E[:dup]]).astype(np.float32)


@pytest.mark.parametrize("separate", [False, True])
def test_matrix_free_passes_match_jax(separate):
    X, Xc = _tied_rows(3)
    if not separate:
        X = Xc
    jX, jXc, tX, tXc = jnp.asarray(X), jnp.asarray(Xc), _t(X), _t(Xc)
    top = tfs.fl_stream_top2(tX, tXc)
    jtop = jfs.fl_stream_top2(jX, jXc)
    np.testing.assert_allclose(top.numpy(), np.asarray(jtop), rtol=1e-6, atol=1e-6)
    assert bool((top[:, 0] == top[:, 1]).any())   # some rows do tie
    best, jbest = top[:, 0], jtop[:, 0]
    cnt = tfs.fl_stream_count_best(tX, tXc, best)
    assert cnt.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(),
                                  np.asarray(jfs.fl_stream_count_best(jX, jXc, jbest)))
    loss = np.where(np.asarray(cnt) > 1, 0.0,
                    np.maximum(top[:, 0].numpy(), 0) - np.maximum(top[:, 1].numpy(), 0))
    loss = loss.astype(np.float32)
    np.testing.assert_allclose(
        tfs.fl_stream_best_loss_sum(tX, tXc, best, _t(loss)).numpy(),
        np.asarray(jfs.fl_stream_best_loss_sum(jX, jXc, jbest, jnp.asarray(loss))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tfs.fl_stream_residuals(tX, tXc).numpy(),
                               np.asarray(jfs.fl_stream_residuals(jX, jXc)),
                               rtol=1e-5, atol=1e-5)
    mask = np.arange(Xc.shape[0]) % 5 == 0
    for m in (None, mask, np.zeros_like(mask)):
        np.testing.assert_allclose(
            tfs.fl_stream_col_max(tX, tXc, None if m is None else torch.from_numpy(m))
            .numpy(),
            np.asarray(jfs.fl_stream_col_max(jX, jXc, None if m is None
                                             else jnp.asarray(m))),
            rtol=1e-6, atol=1e-6)


def test_matrix_free_top2_of_a_single_candidate():
    X, _ = _tied_rows(4, n=20)
    top = tfs.fl_stream_top2(_t(X), _t(X[:1]))
    np.testing.assert_allclose(top.numpy(),
                               np.asarray(jfs.fl_stream_top2(jnp.asarray(X),
                                                             jnp.asarray(X[:1]))),
                               rtol=1e-6, atol=1e-6)


def _dense_good():
    return torch.rand(20, 20), torch.rand(3, 20), torch.rand(3)


@pytest.mark.parametrize("case", [
    "sim_float64", "MU_float64", "sim_noncontig", "MU_shape", "resid_shape",
    "cand_int32", "sim_1d", "no_probes",
])
def test_fl_wrappers_reject_bad_inputs(case):
    sim, MU, resid = _dense_good()
    X = torch.rand(20, 6)
    kw = {}
    if case == "sim_float64":
        sim, X = sim.double(), X.double()
    elif case == "MU_float64":
        MU = MU.double()
    elif case == "sim_noncontig":
        sim, X = torch.rand(20, 20).t(), torch.rand(6, 20).t()
    elif case == "MU_shape":
        MU = torch.rand(3, 19)
    elif case == "resid_shape":
        resid = torch.rand(4)
    elif case == "cand_int32":
        kw["cand_idx"] = torch.arange(4, dtype=torch.int32)
    elif case == "sim_1d":
        sim, X = torch.rand(20), torch.rand(20)
    elif case == "no_probes":
        MU, resid = torch.rand(0, 20), torch.rand(0)
    with pytest.raises((ValueError, TypeError)):
        fl_divergence_kernel(sim, MU, resid, **kw)
    with pytest.raises((ValueError, TypeError)):
        fl_stream_divergence_kernel(X, MU, resid, **kw)
    if case not in ("MU_float64", "MU_shape", "resid_shape", "no_probes"):
        with pytest.raises((ValueError, TypeError)):
            fl_gains_kernel(sim, MU[0] if MU.shape[0] else torch.rand(20), **kw)
        with pytest.raises((ValueError, TypeError)):
            fl_stream_gains_kernel(X, torch.rand(20), **kw)


def test_fl_stream_wrapper_rejects_mismatched_widths():
    X, MU, resid = torch.rand(20, 6), torch.rand(3, 20), torch.rand(3)
    with pytest.raises(ValueError):
        fl_stream_divergence_kernel(X, MU, resid, Xc=torch.rand(30, 5))


# -- the many-probe tile (csrc/fl_common.cuh) --------------------------------


def test_fl_probe_tile_rule():
    """fl_probe_tile covers every r with fewer than FL_PROBE_THREADS pad
    slots a pass (on average), fills one pass exactly at the SS paths' probe
    counts, and picks a template instance the launchers have."""
    from repro_torch.kernels import _build

    for r in range(1, 513):
        tile = _build.fl_probe_tile(r)
        assert tile == _build.fl_probe_tile(r)   # a pure rule of r
        assert 1 <= tile.ppt <= _build.FL_MAX_PPT and tile.passes >= 1
        assert tile.slots >= r
        assert tile.slots - r < _build.FL_PROBE_THREADS * tile.passes
        # no fewer passes would do
        assert r > _build.FL_PROBE_THREADS * _build.FL_MAX_PPT * (tile.passes - 1)
    for r in (128, 144, 160):
        tile = _build.fl_probe_tile(r)
        assert tile.passes == 1 and tile.slots == r
    with pytest.raises(ValueError):
        _build.fl_probe_tile(0)


def test_fl_probe_tile_matches_the_cuda_header():
    """The rule's constants are those the kernels are compiled with."""
    import re

    from repro_torch.kernels import _build

    text = (_build.CSRC / "fl_common.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (kProbeThreads|kMaxPPT) = (\d+);", text))
    assert int(consts["kProbeThreads"]) == _build.FL_PROBE_THREADS
    assert int(consts["kMaxPPT"]) == _build.FL_MAX_PPT


@pytest.mark.parametrize("n,r,dtype,compact", [
    (200, 65, "float32", False), (200, 65, "bfloat16", True),
    (320, 144, "float32", True), (320, 144, "bfloat16", False),
    (180, 161, "float32", False),
])
def test_fl_divergence_across_probe_tiles(n, r, dtype, compact):
    """Probe counts past one 64-probe pass (65), path B's one pass of 144,
    and two passes of the probe tile (161), against the Pallas kernel in
    interpret mode."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(n * r)
    sim = _fl_sim(r, n, "cosine")
    MU, resid, _ = _probe_inputs(rng, sim, r, with_state=compact)
    cand = _cand(rng, n) if compact else None
    jcand = None if cand is None else jnp.asarray(cand)
    tcand = None if cand is None else _t(cand)
    ref = j_fl_divergence(jnp.asarray(sim).astype(jdt), jnp.asarray(MU),
                          jnp.asarray(resid), jcand, interpret=True)
    out = fl_divergence_kernel(_t(sim, tdt), _t(MU), _t(resid), tcand)
    _close(out, ref, resid, tol)


@pytest.mark.parametrize("n,r,d,compact", [
    (200, 65, 16, False), (200, 65, 5, True), (320, 144, 16, True),
    (320, 144, 130, False), (180, 161, 16, True),
])
def test_fl_stream_divergence_across_probe_tiles(n, r, d, compact):
    rng = np.random.default_rng(n * r + d)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    sim = np.maximum(X @ X.T, 0.0)
    MU, resid, _ = _probe_inputs(rng, sim, r, with_state=compact)
    cand = _cand(rng, n) if compact else None
    jcand = None if cand is None else jnp.asarray(cand)
    tcand = None if cand is None else _t(cand)
    ref = jfs.fl_stream_divergence_kernel(jnp.asarray(X), jnp.asarray(MU),
                                          jnp.asarray(resid), jcand,
                                          interpret=True)
    out = fl_stream_divergence_kernel(_t(X), _t(MU), _t(resid), tcand)
    _close(out, ref, resid, 1e-4)
