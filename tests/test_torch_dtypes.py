"""float64 inputs become float32, as ``jnp.asarray`` makes them with x64 off:
the row sieve's state and ``feature_coverage_from_numpy``'s objective stay
float32 and agree with the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import greedy as jgreedy
from repro.core import sieve as R
from repro_torch import (
    STREAM_PHIS,
    feature_coverage_from_numpy,
    greedy,
    stream_sieve_best,
    stream_sieve_init,
    stream_sieve_update,
)
from repro_torch.data import news_day


@pytest.mark.parametrize("phi", STREAM_PHIS)
def test_row_sieve_keeps_float32_state_for_float64_rows(phi):
    rng = np.random.default_rng(8)
    W = rng.random((60, 16)) * (1.0 + 4.0 * np.arange(60) / 60)[:, None]  # float64
    assert W.dtype == np.float64
    k, eps = 4, 0.3
    jst = R.stream_sieve_init(k, 16, eps=eps)
    st = stream_sieve_init(k, 16, eps=eps, device="cpu")
    for t in range(W.shape[0]):
        jst, _ = R.stream_sieve_update(jst, W[t], phi=phi)
        st, _ = stream_sieve_update(st, W[t], phi=phi)
        assert st.cov.dtype == st.vals.dtype == st.m.dtype == torch.float32, t
        np.testing.assert_array_equal(st.sel.numpy(), np.asarray(jst.sel))
    np.testing.assert_allclose(st.vals.numpy(), np.asarray(jst.vals), rtol=1e-5)
    a, b = stream_sieve_best(st), R.stream_sieve_best(jst)
    np.testing.assert_array_equal(a.selected.numpy(), np.asarray(b.selected))


def test_feature_coverage_from_float64_numpy_is_float32():
    W = news_day(2, 400, 48).astype(np.float64)
    fn = feature_coverage_from_numpy(W, device="cpu")
    assert fn.W.dtype == torch.float32
    assert fn.empty_state().dtype == torch.float32
    res = greedy(fn, 6)
    jres = jgreedy(JFeatureCoverage(W=jnp.asarray(W)), 6)
    assert res.value.dtype == res.gains.dtype == torch.float32
    np.testing.assert_array_equal(res.selected.numpy(), np.asarray(jres.selected))
    assert float(res.value) == float(jres.value)
    # float32 stays as it is; dtype= still casts (bfloat16 for the kernels)
    assert feature_coverage_from_numpy(W.astype(np.float32), device="cpu").W.dtype \
        == torch.float32
    assert feature_coverage_from_numpy(W, device="cpu", dtype=torch.bfloat16).W.dtype \
        == torch.bfloat16
