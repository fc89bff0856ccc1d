"""Sieve streaming in the port, held against ``repro.core.sieve``.

Each case builds the same numpy inputs from a seed and runs them through
the JAX package and through the port on the CPU (the plain table, which sums
each entry in the CUDA kernel's order).  What is held, and why:

- ``selected`` and ``best_sieve`` equal, ``value`` within 1e-5 relative.
  The two packages sum each gain over the F features (or n served rows) in
  different orders, so a comparison g >= need that lies within float32
  rounding of the literal form may fall either way: where the decisions
  differ, ``_explain_divergence`` steps both packages one element at a time
  to the first differing (t, j) and shows, in float64, that it lies within
  the rounding bound of a float32 sum in any order (the data is not
  changed to avoid it).
- ``thresholds`` to a few ulps: the legacy grid is ``ratios * m``, and m is
  a float32 sum (a singleton gain) summed in another order; XLA's float32
  ``exp``, ``log`` and its fused multiply-adds in ``jnp.logspace`` put an
  entry of the grid itself up to one ulp away (counted below).  The
  geometric exponents ``jidx`` are equal.
- Within the port, bits: chunk size, the incremental API and per-element
  updates change nothing.

The CUDA kernel itself is held to the plain table on the card by
``tests/test_torch_sieve_card.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FacilityLocation as JFacilityLocation
from repro.core import FeatureCoverage as JFeatureCoverage
from repro.core import StreamingFacilityLocation as JStreamingFacilityLocation
from repro.core import sieve as R
from repro.data.synthetic import clustered_embeddings, news_day, video
from repro_torch import (
    STREAM_PHIS,
    StreamingFacilityLocation,
    feature_coverage_from_numpy,
    facility_location_from_numpy,
    greedy,
    sieve_best,
    sieve_extend,
    sieve_init,
    sieve_streaming,
    sieve_update,
    stream_sieve_best,
    stream_sieve_init,
    stream_sieve_update,
    threshold_grid,
)
from repro_torch.core import sieve as P
from repro_torch.kernels import SieveElements, ops, sieve_gains_kernel, sieve_gains_ref
from repro_torch.kernels.ref import SIEVE_SEG, sieve_tree_sum

N = 160
U32 = np.finfo(np.float32).eps / 2          # unit roundoff of float32


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


# -- objectives ---------------------------------------------------------------

OBJECTIVES = ("fc_sqrt", "fc_log1p", "fc_satcov", "fc_sqrt_featw", "fl_dense",
              "fl_matrix_free")


def _pair(kind, n=N, seed=0, zero_first=0):
    """The same objective in both packages, the first ``zero_first``
    elements made zero (rows of W, embedding rows)."""
    if kind.startswith("fc"):
        W = news_day(seed, n, 64).copy()
        W[:zero_first] = 0.0
        phi = kind.split("_")[1]
        fw = (np.linspace(0.5, 1.5, 64).astype(np.float32)
              if kind.endswith("featw") else None)
        jfn = JFeatureCoverage(W=jnp.asarray(W), phi=phi,
                               feat_w=None if fw is None else jnp.asarray(fw))
        return jfn, feature_coverage_from_numpy(W, fw, phi=phi, device="cpu")
    if kind == "fl_dense":
        X = video(seed, n, 32).copy()
        X[:zero_first] = 0.0
        jfn = JFacilityLocation.from_features(jnp.asarray(X), kernel="cosine")
        return jfn, facility_location_from_numpy(np.asarray(jfn.sim), device="cpu")
    E = clustered_embeddings(seed, n, 16).copy()
    E[:zero_first] = 0.0
    jfn = JStreamingFacilityLocation.from_features(jnp.asarray(E), kernel="dot")
    return jfn, StreamingFacilityLocation.from_features(torch.from_numpy(E), "dot")


def _stream(kind, n=N, seed=0):
    r = np.random.default_rng(seed + 11)
    if kind in ("identity", "zeros_first"):
        return np.arange(n)
    if kind == "permutation":
        return r.permutation(n)
    return r.integers(0, n, n)                 # duplicates


# -- float64 account of a differing decision ---------------------------------


def _terms(jfn, s, v):
    """The float32 terms of value(add(s, v)) and of value(s) for the JAX
    objective ``jfn`` and state s (numpy), as float64."""
    s = np.asarray(s, np.float32)
    if isinstance(jfn, JFeatureCoverage):
        e = np.asarray(jfn.W[v], np.float32)
        cap = None if jfn._cap() is None else np.asarray(jfn._cap(), np.float32)
        fw = None if jfn.feat_w is None else np.asarray(jfn.feat_w, np.float32)

        def h(x):
            y = np.asarray(R._phi(jfn.phi, jnp.asarray(x),
                                  None if cap is None else jnp.asarray(cap)))
            return (y if fw is None else y * fw).astype(np.float64)

        return h((s + e).astype(np.float32)), h(s)
    if isinstance(jfn, JFacilityLocation):
        e = np.asarray(jfn.sim[:, v], np.float32)
    else:
        e = np.maximum(np.asarray(jfn.X, np.float32) @ np.asarray(jfn.X[v],
                                                                  np.float32), 0)
    return np.maximum(s, e).astype(np.float64), s.astype(np.float64)


def _explain_divergence(jfn, fn, stream, k, eps):
    """Step both packages to the first element where their sieves differ
    and show the differing decision lies within float32 rounding: for a
    take, |g - need| within the bound of float32 sums in any order
    (gamma_L over the terms' magnitudes, and the operands' own roundings);
    for a window, log(m) / lg within rounding of an integer."""
    sr, sp = R.sieve_init(jfn, k, eps=eps), sieve_init(fn, k, eps=eps)
    for t, v in enumerate(stream):
        pre = sr
        sr, sp = R.sieve_update(jfn, sr, int(v)), sieve_update(fn, sp, int(v))
        same = (np.array_equal(np.asarray(sr.counts), sp.counts.numpy())
                and np.array_equal(np.asarray(sr.sel), sp.sel.numpy())
                and (sr.jidx is None or np.array_equal(np.asarray(sr.jidx),
                                                       sp.jidx.numpy())))
        if same:
            continue
        a1, _ = _terms(jfn, np.zeros_like(np.asarray(pre.states[0])), int(v))
        g1 = a1.sum()
        m = max(float(pre.m), g1)
        if sr.jidx is not None and not np.array_equal(np.asarray(sr.jidx),
                                                      sp.jidx.numpy()):
            x = np.log(m) / float(pre.lg)
            bound = 4 * a1.size * U32 * np.abs(a1).sum() / m / float(pre.lg) + 1e-5
            assert abs(x - round(x)) <= bound, (t, x)
            return t
        j = int(np.flatnonzero((np.asarray(sr.counts) != sp.counts.numpy())
                               | (np.asarray(sr.sel) != sp.sel.numpy()).any(1))[0])
        s, val, cnt = np.asarray(pre.states[j]), float(pre.vals[j]), int(pre.counts[j])
        if sr.jidx is None:
            thr = float(pre.ratios[j]) * m
        else:
            thr = float(np.exp(float(sr.jidx[j]) * float(pre.lg)))
            if float(pre.m) <= 0 or int(sr.jidx[j]) != int(pre.jidx[j]):
                s, val, cnt = np.zeros_like(s), 0.0, 0     # reset at this step
        a, b = _terms(jfn, s, int(v))
        g = a.sum() - b.sum()
        need = (thr / 2 - val) / max(k - cnt, 1)
        L = a.size
        bound = (4 * L * U32 * (np.abs(a).sum() + np.abs(b).sum())
                 + 8 * U32 * (abs(thr) + abs(val)))
        assert abs(g - need) <= bound, (t, j, g, need, bound)
        return t
    raise AssertionError("final results differ but no step does")


def _hold(jres, res, jfn, fn, stream, k, eps):
    """The port's SieveResult against the reference's."""
    sel, jsel = res.selected.numpy(), np.asarray(jres.selected)
    if not (np.array_equal(sel, jsel) and int(res.best_sieve) == int(jres.best_sieve)):
        _explain_divergence(jfn, fn, stream, k, eps)
        return False
    np.testing.assert_allclose(float(res.value), float(jres.value), rtol=1e-5)
    assert _ulps(res.thresholds.numpy(), jres.thresholds) <= (1 if eps else 8)
    return True


def test_divergence_account_steps_both_packages():
    """The account above steps both packages element by element; on a run
    where no decision differs it finds no step to explain."""
    jfn, fn = _pair("fl_dense", n=48)
    with pytest.raises(AssertionError, match="no step does"):
        _explain_divergence(jfn, fn, np.arange(48), 4, 0.2)


# -- the threshold grid and the window ----------------------------------------


@pytest.mark.parametrize("k", [1, 6, 8, 32])
@pytest.mark.parametrize("eps", [0.1, 0.2, 0.5])
def test_threshold_grid_geometric_is_the_reference_bitwise(k, eps):
    got = threshold_grid(k, eps, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(R.threshold_grid(k, eps)))


@pytest.mark.parametrize("k", [1, 6, 8, 32])
@pytest.mark.parametrize("T", [10, 50])
def test_threshold_grid_legacy_matches_the_reference(k, T):
    """Equal, or one ulp where XLA fused the other product of the linspace's
    multiply-add (its compiled form depends on the unrolling) or its own
    float32 log rounded otherwise."""
    got = threshold_grid(k, None, T, device="cpu").numpy()
    ref = np.asarray(R.threshold_grid(k, None, T))
    assert got.shape == ref.shape == (T,)
    assert _ulps(got, ref) <= 1
    assert (got != ref).sum() <= 1


def test_threshold_grid_refuses_bad_eps_and_defaults_to_the_card(monkeypatch):
    with pytest.raises(ValueError, match="eps"):
        threshold_grid(4, eps=-0.1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        threshold_grid(4, eps=0.2)


def _m_trajectory():
    """Running maxima with leading zeros, repeats, small steps and jumps
    that wrap a slot more than once."""
    steps = [0, 0, 0, 0.3, 0.3, 0.31, 0.5, 0.5, 2.0, 2.0, 2.1, 40.0, 40.0,
             41.0, 900.0, 901.0, 1e4, 1e4, 3e6]
    return np.maximum.accumulate(np.array(steps, np.float32))


@pytest.mark.parametrize("eps", [0.2, 0.5])
@pytest.mark.parametrize("k", [2, 8])
def test_slide_window_closed_form_is_the_reference_stepped(eps, k):
    ms = _m_trajectory()
    T = R.threshold_grid(k, eps).shape[0]
    lg = jnp.float32(np.log1p(eps))
    jidx, m_prev = jnp.arange(T, dtype=jnp.int32), jnp.float32(0.0)
    want_j, want_r, want_t = [], [], []
    for m in ms:
        jidx, thr, reset = R._slide_window(jidx, lg, m_prev, jnp.float32(m))
        m_prev = jnp.float32(m)
        want_j.append(np.asarray(jidx))
        want_r.append(np.asarray(reset))
        want_t.append(np.asarray(thr))
    want_j, want_r = np.stack(want_j, 1), np.stack(want_r, 1)
    assert want_j.max() - want_j.min() > 2 * T           # wraps more than once
    lg_t = torch.tensor(np.float32(np.log1p(eps)))
    j0 = torch.arange(T, dtype=torch.int32)
    # the port's own step, element by element
    jc, mp = j0, torch.tensor(0.0)
    for i, m in enumerate(torch.from_numpy(ms)):
        jc, t_, r_ = P._slide_window(jc, lg_t, mp, m)
        mp = m
        np.testing.assert_array_equal(jc.numpy(), want_j[:, i])
        np.testing.assert_array_equal(r_.numpy(), want_r[:, i])
        assert _ulps(t_.numpy(), want_t[i]) <= 1
    # the closed form: the whole run at once, and in pieces carried across
    jt, thr, reset = P._slide_window_run(j0, lg_t, torch.tensor(0.0),
                                         torch.from_numpy(ms))
    np.testing.assert_array_equal(jt.numpy(), want_j)
    np.testing.assert_array_equal(reset.numpy(), want_r)
    assert _ulps(thr.numpy(), np.stack(want_t, 1)) <= 1
    pieces, jc, mp = [], j0, torch.tensor(0.0)
    for lo, hi in ((0, 1), (1, 5), (5, 12), (12, len(ms))):
        part = torch.from_numpy(ms[lo:hi])
        j_, t_, r_ = P._slide_window_run(jc, lg_t, mp, part)
        pieces.append((j_, t_, r_))
        jc, mp = j_[:, -1], part[-1]
    for got, want in zip(zip(*pieces), (jt, thr, reset)):
        assert torch.equal(torch.cat(got, 1), want)


# -- sieve_streaming against the reference ------------------------------------


STREAMS = ("identity", "permutation", "duplicates", "zeros_first")


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("eps", [None, 0.2], ids=["legacy", "geometric"])
@pytest.mark.parametrize("kind", OBJECTIVES)
def test_sieve_streaming_matches_the_reference(kind, eps, stream):
    jfn, fn = _pair(kind, zero_first=24 if stream == "zeros_first" else 0)
    s = _stream(stream)
    held = 0
    for k in (1, 6, 8):
        jres = R.sieve_streaming(jfn, k, stream=jnp.asarray(s), eps=eps)
        res = sieve_streaming(fn, k, stream=torch.from_numpy(s), eps=eps)
        assert res.selected.dtype == torch.int32 and res.thresholds.dtype == torch.float32
        held += _hold(jres, res, jfn, fn, s, k, eps)
    assert held >= 2            # a divergence is the exception, and explained


def test_a_stream_opening_with_zero_rows_resets_on_each():
    """While m stays 0 every element re-anchors and resets every slot; a
    zero row gains exactly 0 and is taken by no sieve."""
    jfn, fn = _pair("fc_sqrt", zero_first=24)
    st = sieve_extend(fn, sieve_init(fn, 6, eps=0.2), torch.arange(24))
    assert float(st.m) == 0.0 and int(st.counts.sum()) == 0
    np.testing.assert_array_equal(st.jidx.numpy(), np.arange(st.jidx.shape[0]))
    tab = ops.sieve_gains(fn, st.states, torch.arange(24))
    assert torch.equal(tab, torch.zeros_like(tab))


@pytest.mark.parametrize("eps", [None, 0.2], ids=["legacy", "geometric"])
@pytest.mark.parametrize("kind", OBJECTIVES)
def test_sieve_state_after_two_halves_matches_the_reference(kind, eps):
    jfn, fn = _pair(kind)
    s = _stream("permutation")
    k = 6
    jst = R.sieve_init(jfn, k, eps=eps)
    st = sieve_init(fn, k, eps=eps)
    for half in (s[: N // 2], s[N // 2:]):
        jst = R.sieve_extend(jfn, jst, jnp.asarray(half))
        st = sieve_extend(fn, st, torch.from_numpy(half))
    if not (np.array_equal(st.sel.numpy(), np.asarray(jst.sel))
            and np.array_equal(st.counts.numpy(), np.asarray(jst.counts))):
        _explain_divergence(jfn, fn, s, k, eps)
        return
    assert int(st.t) == int(jst.t) == N
    assert st.counts.dtype == torch.int32 and st.t.dtype == torch.int32
    np.testing.assert_allclose(st.vals.numpy(), np.asarray(jst.vals), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(st.states.numpy(), np.asarray(jst.states),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(st.m), float(jst.m), rtol=1e-5)
    assert _ulps(st.ratios.numpy(), jst.ratios) <= 1
    if eps is None:
        assert st.jidx is None and jst.jidx is None
    else:
        np.testing.assert_array_equal(st.jidx.numpy(), np.asarray(jst.jidx))
        assert float(st.lg) == float(jst.lg)


# -- bits within the port ----------------------------------------------------


def _fields(st):
    return [x for x in st if x is not None]


@pytest.mark.parametrize("eps", [None, 0.2], ids=["legacy", "geometric"])
@pytest.mark.parametrize("kind", OBJECTIVES)
def test_chunking_and_the_incremental_api_change_no_bit(kind, eps):
    """One-shot in chunks of 1, 3, 64 and n, two halves, and sieve_update
    per element: identical states, field for field."""
    _, fn = _pair(kind, n=96)
    s = torch.from_numpy(_stream("duplicates", n=96))
    k = 6
    runs = [P._walk(fn, sieve_init(fn, k, eps=eps), s, None, C)
            for C in (1, 3, 64, 96, None)]
    st = sieve_init(fn, k, eps=eps)
    for half in (s[:40], s[40:]):
        st = sieve_extend(fn, st, half)
    runs.append(st)
    st = sieve_init(fn, k, eps=eps)
    for v in s:
        st = sieve_update(fn, st, v)
    runs.append(st)
    for other in runs[1:]:
        for a, b in zip(_fields(runs[0]), _fields(other)):
            assert torch.equal(a, b)
    one = sieve_streaming(fn, k, stream=s, eps=eps)
    best = sieve_best(runs[0])
    for a, b in zip(one, best):
        assert torch.equal(a, b)


def test_the_walk_counts_its_chunks_rounds_and_host_reads():
    _, fn = _pair("fc_sqrt")
    for name in ("chunks", "rounds", "host_reads"):
        setattr(sieve_extend, name, 0)
    P._walk(fn, sieve_init(fn, 6), torch.arange(N), None, 32)
    assert sieve_extend.chunks == N // 32
    assert sieve_extend.rounds >= sieve_extend.chunks
    assert sieve_extend.host_reads == 1 + sieve_extend.rounds


@pytest.mark.parametrize("kind", ("fc_sqrt", "fl_dense", "fl_matrix_free"))
def test_each_objective_gives_its_table_elements(kind):
    """``sieve_elements``: the stream values, then the zero element; its
    ``add`` is the objective's add, row by row; a matrix-free column has the
    same bits wherever it sits in its block of columns."""
    _, fn = _pair(kind)
    el = fn.sieve_elements(torch.tensor([5, 2, 9]))
    assert el.idx.dtype == torch.int64 and int(el.idx[-1]) == -1
    assert el.idx.shape == (4,)
    e0 = fn.empty_state()
    S = torch.stack([e0, fn.add(e0, torch.tensor(7))])
    got = el.add(S, torch.tensor([0, 2]))
    want = torch.stack([fn.add(S[0], torch.tensor(5)), fn.add(S[1], torch.tensor(9))])
    if kind != "fl_matrix_free":
        assert torch.equal(got, want)
        assert fn.sieve_chunk() is None
    else:
        # a product of 128 columns against add's one: another float32 order
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        a = fn.sieve_elements(torch.arange(0, 128)).E
        b = fn.sieve_elements(torch.arange(64, N)).E
        assert torch.equal(a[:, 64:128], b[:, :64])
        assert fn.sieve_chunk() == (1 << 28) // N


# -- the gain table and its plain version -------------------------------------


@pytest.mark.parametrize("kind", OBJECTIVES)
def test_gain_table_is_the_literal_value_difference(kind):
    """value(add(s, v)) - value(s) of the port's objective, entry by entry
    (both float32 sums, in other orders: rtol 1e-5 of the values), with
    exactly 0 for a zero row and for an element the state dominates."""
    _, fn = _pair(kind, n=64, zero_first=3)
    r = np.random.default_rng(5)
    states = [fn.empty_state()]
    for size in (1, 3, 6):
        st = fn.empty_state()
        for v in r.choice(64, size, replace=False):
            st = fn.add(st, torch.tensor(int(v)))
        states.append(st)
    S = torch.stack(states)
    elems = torch.arange(64)
    tab = ops.sieve_gains(fn, S, elems)
    for i, s in enumerate(states):
        for v in range(64):
            lit = float(fn.value(fn.add(s, torch.tensor(v))) - fn.value(s))
            scale = float(fn.value(fn.add(s, torch.tensor(v))))
            assert abs(float(tab[i, v]) - lit) <= 1e-5 * max(scale, 1.0)
    assert torch.equal(tab[:, :3], torch.zeros_like(tab[:, :3]))   # zero rows
    if not kind.startswith("fc"):
        # the last state took element 3's column once more: dominated
        top = states[-1]
        picked = [v for v in range(64)
                  if torch.equal(fn.add(top, torch.tensor(v)), top)]
        assert picked and all(float(tab[-1, v]) == 0.0 for v in picked)


def _kernel_order(H):
    """The kernel's loops, literally: per entry and slab of 4096 leaves,
    segments of 32 leaves, each ((p0 + p1) + (p2 + p3)) per 8-leaf group,
    groups as ((g0 + g1) + (g2 + g3)), added to a running float32 sum from 0
    (leaves past L are 0); then the slabs' sums in order from 0
    (sieve_gains_finish)."""
    f = np.float32
    R_, C_, L = H.shape
    out = np.zeros((R_, C_), np.float32)
    for r in range(R_):
        for c in range(C_):
            total = f(0)
            for s0 in range(0, L, 4096):
                acc = f(0)
                for l0 in range(s0, min(L, s0 + 4096), 32):
                    x = np.zeros(32, np.float32)
                    x[: min(32, L - l0)] = H[r, c, l0:l0 + 32]
                    g = []
                    for q in range(4):
                        p = [f(x[8 * q + 2 * i] + x[8 * q + 2 * i + 1])
                             for i in range(4)]
                        g.append(f(f(p[0] + p[1]) + f(p[2] + p[3])))
                    acc = f(acc + f(f(g[0] + g[1]) + f(g[2] + g[3])))
                total = f(total + acc)
            out[r, c] = total
    return out


@pytest.mark.parametrize("L", [1, 31, 32, 77, 128, 2 * 4096 + 45])
def test_tree_sum_is_the_kernels_order(L):
    shape = (3, 4, L) if L <= 128 else (1, 2, L)
    H = np.random.default_rng(L).random(shape, dtype=np.float32) * 7.0
    np.testing.assert_array_equal(sieve_tree_sum(torch.from_numpy(H)).numpy(),
                                  _kernel_order(H))


def test_plain_table_keeps_its_order_across_slabs_and_launches():
    """Across slabs the plain table keeps the order of the whole sum, and an
    entry's bits do not depend on the other rows and columns."""
    L = 128 * SIEVE_SEG + 45
    g = torch.Generator().manual_seed(0)
    S = torch.rand((5, L), generator=g)
    W = torch.rand((9, L), generator=g) * (torch.rand((9, L), generator=g) < 0.1)
    idx = torch.tensor([3, -1, 0, 8, 3])
    whole = sieve_gains_ref(S, W, idx, cols=False, phi="sqrt")
    H = torch.sqrt(S[:, None, :] + torch.where((idx == -1)[:, None], 0.0,
                                                W[idx.clamp_min(0)])[None])
    assert torch.equal(whole, sieve_tree_sum(H))
    assert torch.equal(whole[2:3, 3:4],
                       sieve_gains_ref(S[2:3], W, idx[3:4], cols=False, phi="sqrt"))
    assert torch.equal(whole[:, 0], whole[:, 4])
    sim = torch.rand((L, 6), generator=g)
    fl = sieve_gains_ref(S, sim, torch.tensor([5, -1, 2]), cols=True)
    assert torch.equal(fl[:, 1], sieve_tree_sum(S))
    assert torch.equal(fl[:, 0], sieve_tree_sum(torch.maximum(S, sim[:, 5])))


def _zero_tree_levels(Z):
    """The fixed tree over the zero terms Z (R, L), leaves past L 0: level t
    as numpy (R, segments, 32 >> t); level 5 holds each segment's total G."""
    x = torch.nn.functional.pad(Z, (0, -Z.shape[1] % SIEVE_SEG))
    x = x.reshape(Z.shape[0], -1, SIEVE_SEG)
    levels = [x.numpy()]
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
        levels.append(x.numpy())
    return levels


def _closed_form(levels, j, k, mask, term):
    """Segment k of entry j when it holds one or two nonzeros, by the
    sparse route's closed form (``csrc/sieve_gains.cu``: ``path_sum``): the
    nonzero at p climbs its path adding the zero tree's sibling at each
    level; with a second at q > p, whose path meets p's at level d + 1 (d
    the highest bit where p and q differ), each climbs to level d, the two
    are added, and the sum climbs on with p's siblings above d."""
    f = np.float32
    ps = [i for i in range(SIEVE_SEG) if mask >> i & 1]
    p, q = ps[0], ps[-1]
    d = (p ^ q).bit_length() - 1 if len(ps) == 2 else 5

    def climb(v, x, levels_):
        for t in levels_:
            v = f(v + levels[t][j, k, (x >> t) ^ 1])
        return v

    vp = climb(term(SIEVE_SEG * k + p), p, range(d))
    if len(ps) == 2:
        vq = climb(term(SIEVE_SEG * k + q), q, range(d))
        vp = climb(f(vp + vq), p, range(d + 1, 5))
    return vp


def _reuse_walk(levels, j, nonzeros, term):
    """Entry j of one element by the sparse route's walk
    (``csrc/sieve_gains.cu``: ``sparse_entry``, ``node``): the chain of
    segment totals, G where the element has no nonzero; in a segment that
    holds some, node (t, q) is the zero tree's where none of its leaves is
    a nonzero, else the sum of its children, a nonzero leaf l being
    ``term(l)``.  No other term of the element is read.  A segment with one
    or two nonzeros gives the node walk's bits by the closed form too."""
    f = np.float32

    def node(k, t, q, mask):
        width = 1 << t
        if t < 5 and not mask & (((1 << width) - 1) << (q * width)):
            return levels[t][j, k, q]
        if t == 0:
            return term(SIEVE_SEG * k + q)
        return f(node(k, t - 1, 2 * q, mask) + node(k, t - 1, 2 * q + 1, mask))

    masks = {}
    for l in nonzeros:
        masks[l // SIEVE_SEG] = masks.get(l // SIEVE_SEG, 0) | 1 << (l % SIEVE_SEG)
    nseg = levels[0].shape[1]
    acc = total = f(0)
    for k in range(nseg):
        if k and k % 128 == 0:            # a slab ends: chain its sum
            total, acc = f(total + acc), f(0)
        seg = node(k, 5, 0, masks[k]) if k in masks else levels[5][j, k, 0]
        if k in masks and bin(masks[k]).count("1") <= 2:
            closed = _closed_form(levels, j, k, masks[k], term)
            assert f(closed).view(np.int32) == f(seg).view(np.int32), (j, k, closed, seg)
        acc = f(acc + seg)
    return f(total + acc) if nseg > 128 else acc


@pytest.mark.parametrize("density", [0.0, 0.01, 0.3])
@pytest.mark.parametrize("phi", ["sqrt", "log1p", "setcover", "satcov", "linear"])
@pytest.mark.parametrize("L", [1, 31, 32, 77, 1024, 2 * 4096 + 45])
def test_sparse_route_reuses_the_zero_tree_bit_for_bit(L, phi, density):
    """The identity of the sparse route, where no card is present: for one
    sieve, a node whose leaves are all zero in the element's row has the
    zero tree's value (Z = w phi(s + 0)), so the walk over the nonzeros'
    paths, with G for empty segments, gives ``sieve_tree_sum`` of the dense
    terms bit for bit.  W holds -0.0 at half its zeros (s + -0.0 = s), the
    last element is the zero element, and the element's terms at its zero
    leaves are NaN in the model: reading one would show."""
    from repro_torch.kernels.ref import _phi

    r = np.random.default_rng(L * 7 + int(density * 100))
    R_, C_ = 3, 3
    S = r.random((R_, L), dtype=np.float32) * (r.random((R_, L)) < 0.5)
    S[0] = 0.0                                            # the empty state
    W = r.random((C_, L), dtype=np.float32) * 2.0
    W *= r.random((C_, L)) < density
    W.flat[np.flatnonzero(W == 0)[::2]] = -0.0
    E = torch.from_numpy(np.concatenate([W, np.zeros((1, L), np.float32)]))
    idx = torch.tensor([0, 1, 2, -1])
    St = torch.from_numpy(S)
    fw = (torch.from_numpy(r.random(L, dtype=np.float32) + 0.5)
          if phi in ("log1p", "linear") else None)
    cap = torch.full((L,), 0.7) if phi == "satcov" else None

    def terms(e):
        H = _phi(phi, St[:, None, :] + e[None], cap)
        return H if fw is None else H * fw

    levels = _zero_tree_levels(terms(torch.zeros((1, L)))[:, 0])
    H = terms(E).numpy()
    want = sieve_gains_ref(St, E, idx, cols=False, phi=phi, feat_w=fw, cap=cap)
    for c in range(E.shape[0]):
        nz = np.flatnonzero(E[c].numpy() != 0)
        poisoned = np.full((R_, L), np.nan, np.float32)
        poisoned[:, nz] = H[:, c, nz]
        for j in range(R_):
            got = _reuse_walk(levels, j, nz, lambda l, j=j: poisoned[j, l])
            assert np.float32(got).view(np.int32) == np.float32(
                want[j, c]).view(np.int32), (j, c, got, float(want[j, c]))


def test_kernel_wrapper_takes_the_plain_route_on_the_cpu_only():
    S = torch.rand((3, 40))
    W = torch.rand((7, 40))
    el = SieveElements(W, torch.tensor([0, 6, -1]), False, "log1p")
    before = sieve_gains_kernel.launches
    out = sieve_gains_kernel(S, el)
    assert sieve_gains_kernel.launches == before      # CPU calls do not count
    assert torch.equal(out, sieve_gains_ref(S, W, el.idx, cols=False, phi="log1p"))
    with pytest.raises(TypeError):
        sieve_gains_kernel(S.double(), el)
    with pytest.raises(ValueError, match="does not match"):
        sieve_gains_kernel(torch.rand((3, 41)), el)
    with pytest.raises(ValueError, match="satcov"):
        sieve_gains_kernel(S, el._replace(phi="satcov"))


# -- the row sieve ------------------------------------------------------------


def _stream_rows(seed, n=80, F=24, drift=8.0):
    r = np.random.default_rng(seed)
    scale = 1.0 + drift * np.arange(n, dtype=np.float32) / n
    return r.random((n, F)).astype(np.float32) * scale[:, None]


@pytest.mark.parametrize("phi", STREAM_PHIS)
def test_row_sieve_matches_the_reference_update_by_update(phi):
    W = _stream_rows(3)
    k, eps = 5, 0.3
    jst = R.stream_sieve_init(k, W.shape[1], eps=eps)
    st = stream_sieve_init(k, W.shape[1], eps=eps, device="cpu")
    for t in range(W.shape[0]):
        jst, jtook = R.stream_sieve_update(jst, jnp.asarray(W[t]), phi=phi)
        st, took = stream_sieve_update(st, torch.from_numpy(W[t]), phi=phi)
        assert took.dtype == torch.bool and bool(took) == bool(jtook), t
        np.testing.assert_array_equal(st.sel.numpy(), np.asarray(jst.sel))
        np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
        np.testing.assert_array_equal(st.jidx.numpy(), np.asarray(jst.jidx))
        np.testing.assert_allclose(st.vals.numpy(), np.asarray(jst.vals), rtol=1e-5)
        np.testing.assert_allclose(st.cov.numpy(), np.asarray(jst.cov), rtol=1e-6)
        np.testing.assert_allclose(float(st.m), float(jst.m), rtol=1e-6)
        assert int(st.t) == int(jst.t) == t + 1
    a, b = stream_sieve_best(st), R.stream_sieve_best(jst)
    np.testing.assert_array_equal(a.selected.numpy(), np.asarray(b.selected))
    assert _ulps(a.thresholds.numpy(), b.thresholds) <= 1


@pytest.mark.parametrize("phi", STREAM_PHIS)
def test_row_sieve_matches_the_index_sieve(phi):
    W = _stream_rows(3)
    fn = feature_coverage_from_numpy(W, phi=phi, device="cpu")
    k, eps = 5, 0.3
    st_i = sieve_extend(fn, sieve_init(fn, k, eps=eps), torch.arange(W.shape[0]))
    st_r = stream_sieve_init(k, W.shape[1], eps=eps, device="cpu")
    for t in range(W.shape[0]):
        st_r, _ = stream_sieve_update(st_r, torch.from_numpy(W[t]), phi=phi)
    a, b = sieve_best(st_i), stream_sieve_best(st_r)
    np.testing.assert_array_equal(a.selected.numpy(), b.selected.numpy())
    np.testing.assert_allclose(float(a.value), float(b.value), rtol=1e-5)
    with pytest.raises(ValueError, match="phi"):
        stream_sieve_update(st_r, torch.from_numpy(W[0]), phi="satcov")


def test_row_sieve_guarantee_and_constant_memory():
    W = _stream_rows(5, n=120)
    k, eps = 6, 0.5
    st = stream_sieve_init(k, W.shape[1], eps=eps, device="cpu")
    shapes0 = [x.shape for x in st]
    accepted = 0
    for t in range(W.shape[0]):
        st, took = stream_sieve_update(st, torch.from_numpy(W[t]))
        accepted += int(took)
    assert [x.shape for x in st] == shapes0
    assert 0 < accepted < W.shape[0]
    fn = feature_coverage_from_numpy(W, device="cpu")
    g = float(greedy(fn, k).value)
    assert float(stream_sieve_best(st).value) >= (0.5 - eps) * g
    assert int(st.t) == W.shape[0]


def test_row_sieve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_sieve_init(4, 8)
    assert stream_sieve_init(4, 8, device="cpu").cov.device.type == "cpu"


# -- the reference's guarantees, on the port ---------------------------------


def _fc(seed=0, n=400, F=128):
    return feature_coverage_from_numpy(news_day(seed, n, F), device="cpu")


def _fl(seed=1, n=300, d=16):
    X = jax.random.normal(jax.random.PRNGKey(seed), (n, d))
    jfn = JFacilityLocation.from_features(X, kernel="cosine")
    return facility_location_from_numpy(np.asarray(jfn.sim), device="cpu")


@pytest.mark.parametrize("mk,floor", [(_fc, 0.6), (_fl, 0.75)])
def test_sieve_quality_vs_greedy(mk, floor):
    fn = mk()
    k = 8
    g = greedy(fn, k)
    sv = sieve_streaming(fn, k)
    assert float(sv.value / g.value) >= floor
    assert float(sv.value) <= float(g.value) * (1.0 + 1e-5)


def test_sieve_deterministic_and_structured():
    fn = _fc(seed=5, n=150, F=48)
    k = 7
    a, b = sieve_streaming(fn, k), sieve_streaming(fn, k)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    real = a.selected[a.selected >= 0]
    assert len(real) <= k and len(set(real.tolist())) == len(real)
    mask = torch.zeros(fn.n, dtype=torch.bool)
    mask[real.long()] = True
    f_sel = float(fn.value(fn.add_many(fn.empty_state(), mask)))
    np.testing.assert_allclose(float(a.value), f_sel, rtol=1e-4)
    assert a.thresholds.shape == (50,)


def test_sieve_small_k_and_small_stream():
    fn = _fc(seed=9, n=40, F=16)
    sv = sieve_streaming(fn, 1)
    assert float(sv.value) >= 0.45 * float(fn.singleton_gains().max())
    sv2 = sieve_streaming(fn, 5, stream=torch.arange(10))
    assert (sv2.selected[sv2.selected >= 0] < 10).all()


@pytest.mark.parametrize("eps", [0.2, 0.5])
@pytest.mark.parametrize("mk", [_fc, _fl])
def test_sieve_geometric_guarantee_over_orderings(mk, eps):
    fn = mk()
    k = 8
    g = float(greedy(fn, k).value)
    for seed in range(5):
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(fn.n))
        sv = sieve_streaming(fn, k, stream=perm, eps=eps)
        assert float(sv.value) / g >= 0.5 - eps, seed


def test_sieve_geometric_window_slides_and_recycles():
    fn = _fc(seed=13, n=100, F=32)
    st = sieve_init(fn, 5, eps=0.3)
    order = torch.argsort(fn.singleton_gains(), stable=True)
    j_prev = None
    for v in order:
        st = sieve_update(fn, st, v)
        j = st.jidx.numpy()
        assert len(set(j.tolist())) == len(j)
        if j_prev is not None:
            assert j.min() >= j_prev.min()
        j_prev = j
    assert j_prev.min() > 0


def test_sieve_refuses_other_objectives_and_dtypes():
    fn = feature_coverage_from_numpy(news_day(0, 20, 8), device="cpu",
                                     dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        sieve_streaming(fn, 3)
