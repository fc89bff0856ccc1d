"""The FeatureCoverage kernels on sparse W, the shape of TF-IDF rows.

The CUDA kernels (``csrc/ss_divergence.cu``, ``csrc/feature_gains.cu``) sum
only the terms that W's nonzeros make nonzero, in the difference form

    divergence[v] = min_u [ sum_{W[v,f] != 0} w_f (phi(CU[u,f] + W[v,f]) - phi(CU[u,f]))
                            + (sum_f w_f phi(CU[u,f]) - phi_cu[u]) - resid[u] ]
    gains[v]      = sum_{W[v,f] != 0} w_f (phi(c[f] + W[v,f]) - phi(c[f]))
                    + (sum_f w_f phi(c[f]) - phi_c)

for any phi_cu and phi_c.  Here, on the CPU:

- the port's plain versions (what a wrapper runs on a CPU tensor) are held
  to the JAX package's Pallas kernels in interpret mode on sparse rows:
  news_day rows, an empty row, a row of one nonzero, a dense row, satcov
  caps and a pad probe;
- a float32 numpy model of the difference form, kept here, is held to the
  Pallas kernels at 1e-4 of the sums' size, including a phi_cu / phi_c that
  is not the sum of phi;
- the pure rule by which a block of the divergence kernel picks its loop
  lives in the CUDA source only; a model of it here (``block_loop``), read
  off that source's constants, is unit-tested at its edges and on news_day
  rows.  On the card, ``chip_smoke.py`` reads the kernel's own choice.

The tolerances are ``tests/test_kernels.py``'s: 1e-4 for float32 and 3e-2
for bfloat16 W.
"""

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import news_day
from repro.kernels.feature_gains import feature_gains_kernel as j_feature_gains
from repro.kernels.ss_weights import ss_divergence_kernel as j_ss_divergence
from repro_torch.kernels import _build, feature_gains_kernel, ss_divergence_kernel

PHIS = ["sqrt", "log1p", "setcover", "satcov", "linear"]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
SOURCES = ["news_day", "density_0.01", "density_0.1"]
# (feat_w, cand_idx, phi_cu / phi_c is the sum of phi), cycled through the grid
VARIANTS = list(itertools.product([False, True], repeat=3))
N, F, R = 300, 128, 33


def _grid():
    cases = itertools.product(SOURCES, PHIS, DTYPES)
    return [(*case, *VARIANTS[i % len(VARIANTS)]) for i, case in enumerate(cases)]


def _np_phi(kind, c, cap):
    if kind == "sqrt":
        return np.sqrt(np.maximum(c, np.float32(0)))
    if kind == "log1p":
        return np.log1p(np.maximum(c, np.float32(0)))
    if kind == "setcover":
        return np.minimum(c, np.float32(1))
    if kind == "satcov":
        return np.minimum(c, cap)
    return c


def _sparse_w(source, seed):
    """(N, F) float32 rows of the source, with row 0 empty, row 1 one
    nonzero and row N - 1 dense."""
    rng = np.random.default_rng(seed)
    if source == "news_day":
        W = news_day(seed, N, F)
    else:
        density = float(source.split("_")[1])
        W = (rng.random((N, F), np.float32) * (rng.random((N, F)) < density))
    W = W.astype(np.float32)
    W[0] = 0.0
    W[1] = 0.0
    W[1, F // 3] = 0.7
    W[N - 1] = rng.random(F, np.float32) + np.float32(0.05)
    return W


def _inputs(source, phi, dtype, weighted, compact, summed, seed=0):
    rng = np.random.default_rng(seed + 1)
    W = _sparse_w(source, seed)
    if dtype == "bfloat16":  # what the kernels read: W rounded to bf16
        W = np.array(jnp.asarray(W).astype(jnp.bfloat16).astype(jnp.float32))
    state = W[2:6].sum(0)
    CU = (state[None, :] + W[rng.integers(0, N, R)]).astype(np.float32)
    resid = rng.random(R, np.float32)
    fw = np.linspace(0.5, 1.5, F, dtype=np.float32) if weighted else None
    cap = ((0.2 * W.sum(0)) + 0.01).astype(np.float32) if phi == "satcov" else None
    phi_cu = (_np_phi(phi, CU, cap) * (1.0 if fw is None else fw)).sum(-1)
    if not summed:  # any phi_cu: the kernels take its offset as given
        phi_cu = phi_cu + rng.standard_normal(R)
    phi_cu = phi_cu.astype(np.float32)
    phi_cu[-1] = -1e30  # a pad probe: never wins the min
    cand = (np.concatenate([rng.integers(0, N, N // 3), [N - 1, 0, 1, 0, 0]])
            if compact else None)
    return W, CU, phi_cu, resid, cap, fw, cand


def _j(x, dtype=jnp.float32):
    return None if x is None else jnp.asarray(x).astype(dtype)


def _t(x, dtype=torch.float32):
    if x is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.long() if t.dtype in (torch.int32, torch.int64) else t.to(dtype)


def _pallas_divergence(W, CU, phi_cu, resid, cap, fw, cand, phi, jdt):
    return np.asarray(j_ss_divergence(
        _j(W, jdt), _j(CU), _j(phi_cu), _j(resid), _j(cap), _j(fw),
        None if cand is None else jnp.asarray(cand), phi=phi, interpret=True))


def _pallas_gains(W, c, phi_c, cap, fw, cand, phi, jdt):
    return np.asarray(j_feature_gains(
        _j(W, jdt), _j(c), _j(phi_c), _j(cap), _j(fw),
        None if cand is None else jnp.asarray(cand), phi=phi, interpret=True))


# -- the plain versions against the Pallas kernels ----------------------------


@pytest.mark.parametrize("source,phi,dtype,weighted,compact,summed", _grid())
def test_plain_divergence_matches_pallas_on_sparse_rows(source, phi, dtype, weighted,
                                                        compact, summed):
    jdt, tdt, tol = DTYPES[dtype]
    W, CU, phi_cu, resid, cap, fw, cand = _inputs(source, phi, dtype, weighted,
                                                  compact, summed)
    ref = _pallas_divergence(W, CU, phi_cu, resid, cap, fw, cand, phi, jdt)
    before = ss_divergence_kernel.launches
    out = ss_divergence_kernel(_t(W, tdt), _t(CU), _t(phi_cu), _t(resid), _t(cap),
                               _t(fw), _t(cand), phi=phi)
    assert ss_divergence_kernel.launches == before  # the CPU never launches
    assert out.shape == ((N,) if cand is None else cand.shape)
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("source,phi,dtype,weighted,compact,summed", _grid())
def test_plain_gains_match_pallas_on_sparse_rows(source, phi, dtype, weighted,
                                                 compact, summed):
    jdt, tdt, tol = DTYPES[dtype]
    W, CU, _, _, cap, fw, cand = _inputs(source, phi, dtype, weighted, compact,
                                         summed, seed=2)
    c = CU[0]
    phi_c = np.float32((_np_phi(phi, c, cap) * (1.0 if fw is None else fw)).sum()
                       + (0.0 if summed else 0.3))
    ref = _pallas_gains(W, c, phi_c, cap, fw, cand, phi, jdt)
    before = feature_gains_kernel.launches
    out = feature_gains_kernel(_t(W, tdt), _t(c), torch.tensor(phi_c), _t(cap),
                               _t(fw), _t(cand), phi=phi)
    assert feature_gains_kernel.launches == before
    assert out.shape == ((N,) if cand is None else cand.shape)
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)


# -- the difference form, in float32 numpy, against the Pallas kernels --------


def model_divergence(W, CU, phi_cu, resid, cap, fw, cand, phi):
    """The divergence as the CUDA kernel computes it: per candidate the sum
    over its nonzeros of w_f (phi(CU + W) - phi(CU)), plus the per-probe
    offset Q = (sum_f w_f phi(CU) - phi_cu) - resid, min over probes."""
    f32 = np.float32
    rows = (W if cand is None else W[cand]).astype(f32)
    w = np.ones(W.shape[1], f32) if fw is None else fw
    phic = _np_phi(phi, CU, cap)                                   # (r, F)
    Q = ((w * phic).sum(-1, dtype=f32) - phi_cu) - resid            # (r,)
    out = np.empty(rows.shape[0], f32)
    for v, row in enumerate(rows):
        nz = np.flatnonzero(row)
        capnz = None if cap is None else cap[nz]
        D = (w[nz] * (_np_phi(phi, CU[:, nz] + row[nz], capnz) - phic[:, nz])).sum(
            -1, dtype=f32)
        out[v] = (D + Q).min()
    return out


def model_gains(W, c, phi_c, cap, fw, cand, phi):
    """The gains as the CUDA kernel computes them: the sum over a row's
    nonzeros of w_f (phi(c + W) - phi(c)), plus T = sum_f w_f phi(c) - phi_c."""
    f32 = np.float32
    rows = (W if cand is None else W[cand]).astype(f32)
    w = np.ones(W.shape[1], f32) if fw is None else fw
    phic = _np_phi(phi, c, cap)
    T = (w * phic).sum(dtype=f32) - phi_c
    out = np.empty(rows.shape[0], f32)
    for v, row in enumerate(rows):
        nz = np.flatnonzero(row)
        capnz = None if cap is None else cap[nz]
        out[v] = (w[nz] * (_np_phi(phi, c[nz] + row[nz], capnz) - phic[nz])).sum(
            dtype=f32) + T
    return out


@pytest.mark.parametrize("source,phi,dtype,weighted,compact,summed", _grid())
def test_difference_form_divergence_matches_pallas(source, phi, dtype, weighted,
                                                   compact, summed):
    jdt = DTYPES[dtype][0]
    W, CU, phi_cu, resid, cap, fw, cand = _inputs(source, phi, dtype, weighted,
                                                  compact, summed, seed=3)
    ref = _pallas_divergence(W, CU, phi_cu, resid, cap, fw, cand, phi, jdt)
    model = model_divergence(W, CU, phi_cu, resid, cap, fw, cand, phi)
    scale = max(1.0, float(np.abs(phi_cu[:-1]).max()) + float(np.abs(resid).max()))
    assert np.abs(model - ref).max() <= 1e-4 * scale


@pytest.mark.parametrize("source,phi,dtype,weighted,compact,summed", _grid())
def test_difference_form_gains_match_pallas(source, phi, dtype, weighted, compact,
                                            summed):
    jdt = DTYPES[dtype][0]
    W, CU, _, _, cap, fw, cand = _inputs(source, phi, dtype, weighted, compact,
                                         summed, seed=4)
    c = CU[1]
    phi_c = np.float32((_np_phi(phi, c, cap) * (1.0 if fw is None else fw)).sum()
                       + (0.0 if summed else 0.3))
    ref = _pallas_gains(W, c, phi_c, cap, fw, cand, phi, jdt)
    model = model_gains(W, c, phi_c, cap, fw, cand, phi)
    scale = max(1.0, abs(float(phi_c)), float(np.abs(ref).max()))
    assert np.abs(model - ref).max() <= 1e-4 * scale


def test_difference_form_is_exact_at_a_zero_of_w():
    """A zero of W adds exactly 0: the model's divergence of an empty row is
    min_u Q[u], and its gains T, with no rounding of any term."""
    W, CU, phi_cu, resid, cap, fw, _ = _inputs("density_0.01", "sqrt", "float32",
                                               True, False, True)
    phic = _np_phi("sqrt", CU, None)
    Q = ((fw * phic).sum(-1, dtype=np.float32) - phi_cu) - resid
    assert model_divergence(W, CU, phi_cu, resid, None, fw, None, "sqrt")[0] == Q.min()
    c = CU[0]
    T = (fw * _np_phi("sqrt", c, None)).sum(dtype=np.float32) - np.float32(2.5)
    assert model_gains(W, c, np.float32(2.5), None, fw, None, "sqrt")[0] == T


# -- the pure rules that pick the kernels' loops ------------------------------


RULE = ["kBlockCands", "kWarpRows", "kWarpPool", "kMaxSparseF", "kProbePass"]


def _cuda_constants():
    text = (_build.CSRC / "ss_divergence.cu").read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (" + "|".join(RULE) + r") = (\d+);", text)}


def block_loop(row_nnz, F):
    """The loop a block of ``csrc/ss_divergence.cu`` runs, from its rows'
    nonzero counts (at most kBlockCands, in slot order) and F, as that
    source's note states the rule: "dense" when F > kMaxSparseF or the rows
    of some warp (kWarpRows consecutive rows) hold more than kWarpPool
    nonzeros, else "sparse"."""
    k = _cuda_constants()
    counts = list(row_nnz)
    if len(counts) > k["kBlockCands"]:
        raise ValueError(f"a block holds at most {k['kBlockCands']} rows")
    if F > k["kMaxSparseF"]:
        return "dense"
    rows = k["kWarpRows"]
    shares = (sum(counts[w:w + rows]) for w in range(0, len(counts), rows))
    return "dense" if any(n > k["kWarpPool"] for n in shares) else "sparse"


def test_ss_rule_matches_the_cuda_header():
    """The source states the rule with these constants, and the wrapper
    sizes the kernel's scratch with the two it shares."""
    consts = _cuda_constants()
    assert consts == {"kBlockCands": 128, "kWarpRows": 16, "kWarpPool": 768,
                      "kMaxSparseF": 8192, "kProbePass": 32}
    assert (consts["kBlockCands"], consts["kProbePass"]) == (
        _build.SS_BLOCK_CANDS, _build.SS_PROBE_PASS)


@pytest.mark.parametrize("counts,F,loop", [
    ([], 1024, "sparse"),                           # a block past the end
    ([0] * 128, 1024, "sparse"),                     # all rows empty
    ([10] * 128, 1024, "sparse"),                    # news_day-like rows
    ([48] * 16 + [0] * 112, 1024, "sparse"),         # one warp at its share
    ([48] * 15 + [49] + [0] * 112, 1024, "dense"),   # one past it
    ([0] * 16 + [769] + [0] * 111, 1024, "dense"),   # one row over the share
    ([1024] + [0] * 127, 1024, "dense"),             # one dense row
    ([47] * 128, 1024, "sparse"),                    # 4.6% everywhere
    ([102] * 128, 1024, "dense"),                    # 10%
    ([1] * 7, 8192, "sparse"),                       # the widest sparse W
    ([1] * 7, 8193, "dense"),                        # past it
])
def test_ss_block_loop_rule(counts, F, loop):
    assert block_loop(counts, F) == loop


def test_ss_block_loop_rule_takes_one_block():
    with pytest.raises(ValueError):
        block_loop([0] * 129, 1024)


def test_news_day_blocks_take_the_sparse_loop():
    """The main path's W: every block of news_day rows (1024 features) runs
    the sparse loop, with room to spare in every warp's share."""
    W = news_day(0, 4096, 1024)
    counts = (W != 0).sum(1)
    k = _cuda_constants()
    B, R_ = k["kBlockCands"], k["kWarpRows"]
    assert all(block_loop(counts[b:b + B], 1024) == "sparse"
               for b in range(0, len(counts), B))
    assert counts.reshape(-1, R_).sum(1).max() <= k["kWarpPool"] // 2


def test_ss_scratch_floats():
    # CT (F x RP pairs), Q (RP), one flag per block of 128 outputs
    assert _build.ss_scratch_floats(160, 1024, 1 << 20) == 2 * 1024 * 160 + 160 + 8192
    assert _build.ss_scratch_floats(33, 70, 129) == 2 * 70 * 64 + 64 + 2
    assert _build.ss_scratch_floats(1, 1, 1) == 2 * 32 + 32 + 1

