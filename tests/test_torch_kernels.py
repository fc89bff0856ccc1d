"""The port's two kernel wrappers and their plain versions, held against the
JAX package's Pallas kernels in interpret mode, on shared numpy inputs.

On the CPU a wrapper runs its kernel's plain version, so this checks the
arithmetic the CUDA kernels are held to on the card (``chip_smoke.py``).
The grid is that of ``tests/test_kernels.py``, shapes x dtype x phi, with the
feature-weight and compact-candidate variants cycled through it; the
tolerances are its own: 1e-4 for float32 and 3e-2 for bfloat16 W.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FeatureCoverage as JFeatureCoverage
from repro.data.synthetic import news_day
from repro.kernels.feature_gains import feature_gains_kernel as j_feature_gains
from repro.kernels.ss_weights import ss_divergence_kernel as j_ss_divergence
from repro_torch import feature_coverage_from_numpy
from repro_torch.kernels import (
    feature_gains_kernel,
    feature_gains_ref,
    ss_divergence_kernel,
    ss_divergence_ref,
)

PHIS = ["sqrt", "log1p", "setcover", "satcov", "linear"]
NP_PHI = {
    "sqrt": np.sqrt,
    "log1p": np.log1p,
    "setcover": lambda c: np.minimum(c, 1.0),
    "linear": lambda c: c,
}
# (feat_w, cand_idx) variants, cycled through the shape x dtype x phi grid
VARIANTS = list(itertools.product([False, True], [False, True]))
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _grid(shapes):
    cases = itertools.product(shapes, DTYPES, PHIS)
    return [(*case, *VARIANTS[i % len(VARIANTS)]) for i, case in enumerate(cases)]


def _inputs(seed, n, F, r, weighted, compact, phi):
    rng = np.random.default_rng(seed)
    W = rng.random((n, F), np.float32)
    CU = rng.random((r, F), np.float32)
    resid = rng.random(r, np.float32)
    fw = np.linspace(0.5, 1.5, F, dtype=np.float32) if weighted else None
    cap = (0.2 * W.sum(axis=0)).astype(np.float32) if phi == "satcov" else None
    if phi == "satcov":
        phi_vals = np.minimum(CU, cap)
    else:
        phi_vals = NP_PHI[phi](CU)
    phi_cu = (phi_vals * (1.0 if fw is None else fw)).sum(-1).astype(np.float32)
    # compact buffers repeat indices and pad with 0, like the SS loop's
    cand = (np.concatenate([rng.integers(0, n, n // 3 + 1), [0, 0]])
            if compact else None)
    return W, CU, phi_cu, resid, cap, fw, cand


def _j(x, dtype=jnp.float32):
    return None if x is None else jnp.asarray(x).astype(dtype)


def _t(x, dtype=torch.float32):
    if x is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.long() if t.dtype in (torch.int32, torch.int64) else t.to(dtype)


@pytest.mark.parametrize(
    "shape,dtype,phi,weighted,compact",
    _grid([(64, 32, 4), (130, 70, 9), (256, 128, 16), (513, 257, 33),
           (1024, 64, 40)]),
)
def test_ss_divergence_matches_pallas_interpret(shape, dtype, phi, weighted,
                                                compact):
    n, F, r = shape
    jdt, tdt, tol = DTYPES[dtype]
    W, CU, phi_cu, resid, cap, fw, cand = _inputs(0, n, F, r, weighted, compact, phi)
    ref = j_ss_divergence(_j(W, jdt), _j(CU), _j(phi_cu), _j(resid), _j(cap),
                          _j(fw), None if cand is None else jnp.asarray(cand),
                          phi=phi, interpret=True)
    args = (_t(W, tdt), _t(CU), _t(phi_cu), _t(resid), _t(cap), _t(fw), _t(cand))
    before = ss_divergence_kernel.launches
    out = ss_divergence_kernel(*args, phi=phi)
    plain = ss_divergence_ref(*args[:5], phi, args[5], args[6])
    assert ss_divergence_kernel.launches == before  # the CPU never launches
    assert out.shape == ((n,) if cand is None else cand.shape)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)
    np.testing.assert_array_equal(out.numpy(), plain.numpy())


@pytest.mark.parametrize(
    "shape,dtype,phi,weighted,compact",
    _grid([(64, 32), (130, 70), (512, 256), (1000, 100)]),
)
def test_feature_gains_matches_pallas_interpret(shape, dtype, phi, weighted,
                                                compact):
    n, F = shape
    jdt, tdt, tol = DTYPES[dtype]
    W, CU, phi_cu, _, cap, fw, cand = _inputs(1, n, F, 1, weighted, compact, phi)
    c, phi_c = CU[0], phi_cu[0]
    ref = j_feature_gains(_j(W, jdt), _j(c), _j(phi_c), _j(cap), _j(fw),
                          None if cand is None else jnp.asarray(cand),
                          phi=phi, interpret=True)
    args = (_t(W, tdt), _t(c), torch.tensor(phi_c), _t(cap), _t(fw), _t(cand))
    before = feature_gains_kernel.launches
    out = feature_gains_kernel(*args, phi=phi)
    plain = feature_gains_ref(*args[:4], phi, args[4], args[5])
    assert feature_gains_kernel.launches == before
    assert out.shape == ((n,) if cand is None else cand.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)
    np.testing.assert_array_equal(out.numpy(), plain.numpy())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("phi", PHIS)
def test_kernel_hooks_match_pallas_hooks(phi, weighted):
    """FeatureCoverage.cuda_divergence / cuda_gains build the kernels'
    inputs (CU, phi_cu, resid, cap, phi_c) as the JAX pallas hooks do."""
    n, F = 300, 96
    W = news_day(4, n, F)
    fw = np.linspace(0.5, 1.5, F).astype(np.float32) if weighted else None
    jfn = JFeatureCoverage(W=jnp.asarray(W), feat_w=_j(fw), phi=phi)
    tfn = feature_coverage_from_numpy(W, fw, phi=phi, device="cpu")
    probes = np.array([5, 60, 61, 290])
    cand = np.array([0, 1, 5, 100, 299, 0, 0])
    mask = np.arange(n) % 9 == 0
    jstate = jfn.add_many(jfn.empty_state(), jnp.asarray(mask))
    tstate = tfn.add_many(tfn.empty_state(), torch.from_numpy(mask))
    jres, tres = jfn.residual_gains(), tfn.residual_gains()
    ref = jfn.pallas_divergence(jnp.asarray(probes), jres, jstate,
                                interpret=True, cand_idx=jnp.asarray(cand))
    out = tfn.cuda_divergence(torch.from_numpy(probes), tres, tstate,
                              torch.from_numpy(cand))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    ref = jfn.pallas_gains(jstate, interpret=True)
    out = tfn.cuda_gains(tstate)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def _good():
    W = torch.rand(20, 8)
    CU, phi_cu, resid = torch.rand(3, 8), torch.rand(3), torch.rand(3)
    return W, CU, phi_cu, resid


@pytest.mark.parametrize("case", [
    "W_float64", "CU_float64", "W_noncontig", "CU_shape", "phi_cu_shape",
    "feat_w_shape", "satcov_no_cap", "unknown_phi", "cand_int32", "W_1d",
    "no_probes",
])
def test_wrappers_reject_bad_inputs(case):
    W, CU, phi_cu, resid = _good()
    kw, phi = {}, "sqrt"
    if case == "W_float64":
        W = W.double()
    elif case == "CU_float64":
        CU = CU.double()
    elif case == "W_noncontig":
        W = torch.rand(8, 20).t()
    elif case == "CU_shape":
        CU = torch.rand(3, 9)
    elif case == "phi_cu_shape":
        phi_cu = torch.rand(4)
    elif case == "feat_w_shape":
        kw["feat_w"] = torch.rand(9)
    elif case == "satcov_no_cap":
        phi = "satcov"
    elif case == "unknown_phi":
        phi = "cube"
    elif case == "cand_int32":
        kw["cand_idx"] = torch.arange(4, dtype=torch.int32)
    elif case == "W_1d":
        W = torch.rand(20)
    elif case == "no_probes":
        CU, phi_cu, resid = torch.rand(0, 8), torch.rand(0), torch.rand(0)
    with pytest.raises((ValueError, TypeError)):
        ss_divergence_kernel(W, CU, phi_cu, resid, phi=phi, **kw)
    if case not in ("CU_float64", "CU_shape", "phi_cu_shape", "no_probes"):
        with pytest.raises((ValueError, TypeError)):
            feature_gains_kernel(W, CU[0] if CU.shape[0] else torch.rand(8),
                                 torch.tensor(1.0), phi=phi, **kw)
