"""The V' panel of dense facility location's greedy gains, held against the
JAX package on shared numpy inputs.

Greedy over a small candidate buffer on the card copies sim's candidate
columns once into a contiguous panel (``FacilityLocation.cuda_prepare``, by
the rule ``takes_panel``) and reads that in every step.  On the CPU the
wrapper runs its plain version over the panel, so this checks that the
panel route computes what the gathered route computes, bitwise, and what
the Pallas kernel computes (interpret mode) to its tolerance: 1e-4 for
float32 and 3e-2 for bfloat16 sim, relative to the size of the sums.  A
test-only backend drives the prepare hook through the port's compact greedy
loop, whose picks must be those of the JAX greedy.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FacilityLocation as JFacilityLocation
from repro.core import greedy as jgreedy
from repro.data.synthetic import clustered_embeddings, news_day, video
from repro.kernels.fl_divergence import fl_gains_kernel as j_fl_gains
from repro_torch import (
    facility_location_from_numpy,
    feature_coverage_from_numpy,
    greedy,
    streaming_facility_location_from_numpy,
)
from repro_torch.core.backend import CudaBackend, ReferenceBackend
from repro_torch.core.greedy import selection_bucket
from repro_torch.kernels import GainsPanel, fl_gains_kernel, fl_gains_panel, takes_panel
from repro_torch.kernels.fl_divergence import PANEL_SHARE

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


@pytest.mark.parametrize("k,n,taken", [
    (1024, 65536, True),     # path A's V': 1/64 of sim
    (8192, 65536, True),     # the boundary: 1/8 of sim
    (8193, 65536, False),
    (23296, 65536, False),   # a near-full SS bucket
    (0, 65536, False),
    (1, 8, True),
    (2, 8, False),
    (1, 7, False),
])
def test_takes_panel_rule_at_its_boundary(k, n, taken):
    assert PANEL_SHARE == 8
    assert takes_panel(k, n) is taken
    assert takes_panel(k, n) == takes_panel(k, n)   # a pure rule of shapes


def _sim(kind, rng):
    if kind == "cosine":      # symmetric, as from_features builds it
        X = rng.normal(size=(96, 12)).astype(np.float32)
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        return np.maximum(X @ X.T, 0.0).astype(np.float32)
    if kind == "asymmetric":  # candidates are columns, the sum runs down rows
        sim = rng.random((96, 96), np.float32)
        sim[:, :10] *= 3.0
        return sim
    return rng.random((131, 96), np.float32)   # rectangular: ni != n


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("kind", ["cosine", "asymmetric", "rectangular"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_panel_gains_equal_gathered_gains(dtype, kind, padded):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(len(kind) + 7 * padded)
    sim = _sim(kind, rng)
    ni, n = sim.shape
    cand = np.sort(rng.choice(n, 30, replace=False))
    if padded:   # compact buffers pad with index 0
        cand = np.concatenate([cand, [0, 0, 0]])
    state = sim[:, rng.choice(n, 3, replace=False)].max(axis=1).clip(0)
    tsim = torch.from_numpy(sim).to(tdt)
    tcand, tstate = torch.from_numpy(cand).long(), torch.from_numpy(state)

    before = fl_gains_panel.gathers
    panel = fl_gains_panel(tsim, tcand)
    assert fl_gains_panel.gathers == before + 1
    assert isinstance(panel, GainsPanel)
    assert panel.cols.dtype == tdt and panel.cols.is_contiguous()
    assert tuple(panel.cols.shape) == (ni, cand.shape[0])
    np.testing.assert_array_equal(panel.cols.float().numpy(),
                                  tsim[:, tcand].float().numpy())

    launches = fl_gains_kernel.launches
    out = fl_gains_kernel(panel.cols, tstate)
    assert fl_gains_kernel.launches == launches   # the CPU never launches
    np.testing.assert_array_equal(out.numpy(),
                                  fl_gains_kernel(tsim, tstate, tcand).numpy())
    ref = np.asarray(j_fl_gains(jnp.asarray(sim).astype(jdt), jnp.asarray(state),
                                jnp.asarray(cand), interpret=True), np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(out.numpy() - ref).max()) <= tol * scale


@pytest.mark.parametrize("k,taken", [(12, True), (13, False)])
def test_facility_location_prepares_a_panel_by_the_rule(k, taken):
    """cuda_prepare takes the panel exactly when takes_panel says so, and
    cuda_gains gives the same gains over either."""
    rng = np.random.default_rng(k)
    fn = facility_location_from_numpy(rng.random((100, 100), np.float32),
                                      device="cpu")
    cand = torch.from_numpy(np.sort(rng.choice(100, k, replace=False))).long()
    state = fn.add(fn.empty_state(), torch.tensor(4))
    prepared = fn.cuda_prepare(cand)
    assert isinstance(prepared, GainsPanel) is taken
    if not taken:
        assert prepared is cand
    np.testing.assert_array_equal(fn.cuda_gains(state, prepared).numpy(),
                                  fn.cuda_gains(state, cand).numpy())


def _objectives():
    return {
        "feature_coverage": feature_coverage_from_numpy(news_day(0, 64, 16),
                                                        device="cpu"),
        "streaming_fl": streaming_facility_location_from_numpy(
            clustered_embeddings(0, 64, 8), device="cpu"),
        "dense_fl": facility_location_from_numpy(
            np.random.default_rng(0).random((64, 64), np.float32), device="cpu"),
    }


@pytest.mark.parametrize("name", ["feature_coverage", "streaming_fl", "dense_fl"])
def test_the_plain_backend_keeps_the_buffer(name):
    """The reference backend hands greedy the buffer itself for every
    objective; only dense FL has a layout of its own for the kernel, and the
    CUDA backend refuses CPU objectives here as everywhere."""
    fn = _objectives()[name]
    cand = torch.tensor([1, 3, 5, 0])
    assert ReferenceBackend().prepare_compact(fn, cand) is cand
    if name != "dense_fl":
        assert fn.cuda_prepare(cand) is cand
    with pytest.raises(ValueError):
        CudaBackend().prepare_compact(fn, cand)


@dataclasses.dataclass(frozen=True)
class PanelBackend(ReferenceBackend):
    """The CUDA backend's compact-greedy wiring on the CPU: the hook asks the
    objective for its kernel layout (cuda_prepare builds the panel) and
    every step reads it through cuda_gains, whose wrapper runs the plain
    route on CPU tensors.  ``prepared`` keeps what the hook returned."""

    prepared: list = dataclasses.field(default_factory=list)

    def prepare_compact(self, fn, cand_idx):
        out = fn.cuda_prepare(cand_idx)
        self.prepared.append(out)
        return out

    def gains_compact(self, fn, state, cand_idx):
        return fn.cuda_gains(state, cand_idx)


# (live elements, k, conditional state, panel taken): n = 1024, whose compact
# buckets are 384 and 128 slots; a 128-slot buffer is 1/8 of sim.
GREEDY_CASES = [
    (100, 10, False, True),
    (100, 10, True, True),
    (6, 10, False, True),      # alive exhausted before k steps
    (200, 10, False, False),   # a 384-slot buffer: gathered in place
]


@pytest.mark.parametrize("live,k,with_state,taken", GREEDY_CASES)
def test_compact_greedy_with_the_panel_hook_matches_jax(live, k, with_state, taken):
    n = 1024
    jfn = JFacilityLocation.from_features(jnp.asarray(video(3, n, 32)),
                                          kernel="cosine")
    tfn = facility_location_from_numpy(np.asarray(jfn.sim), device="cpu")
    rng = np.random.default_rng(live)
    keep = np.zeros(n, bool)
    keep[rng.choice(n, live, replace=False)] = True
    assert takes_panel(selection_bucket(n, live), n) is taken
    kw_j, kw_t = {}, {}
    if with_state:
        mask = np.arange(n) % 97 == 0
        kw_j["state"] = jfn.add_many(jfn.empty_state(), jnp.asarray(mask))
        kw_t["state"] = tfn.add_many(tfn.empty_state(), torch.from_numpy(mask))
    be = PanelBackend()
    before = fl_gains_panel.gathers
    tres = greedy(tfn, k, alive=torch.from_numpy(keep), backend=be, **kw_t)
    assert len(be.prepared) == 1   # once per greedy run
    assert isinstance(be.prepared[0], GainsPanel) is taken
    assert fl_gains_panel.gathers == before + int(taken)
    jres = jgreedy(jfn, k, alive=jnp.asarray(keep), backend="oracle",
                   compact=True, **kw_j)
    np.testing.assert_array_equal(tres.selected.numpy(), np.asarray(jres.selected))
    np.testing.assert_allclose(tres.gains.numpy(), np.asarray(jres.gains),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tres.value), float(jres.value), rtol=1e-5)
    # and bitwise what the port's plain backend picks and gains
    plain = greedy(tfn, k, alive=torch.from_numpy(keep), backend="reference", **kw_t)
    np.testing.assert_array_equal(tres.selected.numpy(), plain.selected.numpy())
    np.testing.assert_array_equal(tres.gains.numpy(), plain.gains.numpy())
