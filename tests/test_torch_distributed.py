"""The sharded loops (``repro_torch.core.distributed``, the objectives' shard
hooks, ``ShardedBackend``) against the JAX package's ``repro.core.distributed``
on the CPU: four gloo ranks against four forced host devices.

One JAX subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
as ``tests/test_distributed.py`` runs its cases) computes every reference
result and every draw the reference made (each shard's Gumbel row a round,
``fold_in(k1, data index)`` after ``split(key, npods)``; each stochastic
step's replicated row, ``split(key, k)``), then four rank subprocesses of
the port meet through a ``file://`` store under the test's temporary
directory and replay them as ``noise``.  Both run this file as a script
(``python tests/test_torch_distributed.py jax|rank ...``), so a spawned
process finds its code by path.  Each rank writes its results; the tests
below compare them.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_sharded_ranks import (
    D,
    EPS32,
    F,
    GREEDY_CASES,
    INIT_CASES,
    K,
    N,
    NEWS,
    RANKS,
    ROOT,
    SAT_ROWS,
    SS_CASES,
    STOCH_CASES,
    inputs as _inputs,
)

RANKS_SCRIPT = Path(__file__).resolve().parent / "torch_sharded_ranks.py"


# -- the JAX side ---------------------------------------------------------------


def _jax_side(inp_path: str, out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import make_mesh, shard_map
    from repro.core import (
        FacilityLocation,
        FeatureCoverage,
        StreamingFacilityLocation,
        greedy,
    )
    from repro.core import distributed as dd
    from repro.core.greedy import selection_bucket
    from repro.core.sparsify import max_rounds

    a = dict(np.load(inp_path))
    W = jnp.asarray(a["W"])
    fns = {
        "fc": FeatureCoverage(W=W),
        "sat": FeatureCoverage(W=W, phi="satcov", alpha=0.3),
        "fw": FeatureCoverage(W=W, feat_w=jnp.asarray(a["feat_w"])),
        "fl": FacilityLocation.from_features(jnp.asarray(a["X"]), kernel="cosine"),
        "sfl": StreamingFacilityLocation.from_features(jnp.asarray(a["X"]),
                                                       kernel="cosine"),
    }
    out = {"fl_sim": np.asarray(fns["fl"].sim), "sfl_X": np.asarray(fns["sfl"].X)}
    mesh4 = make_mesh((4,), ("data",))
    mesh22 = make_mesh((2, 2), ("pod", "data"))
    key = jax.random.PRNGKey(0)

    def ss_draws(key, n, npods, r=8, c=8.0):
        ndata = RANKS // npods
        n_pod = n // npods
        cap = max_rounds(n_pod, r, c)
        draws = np.zeros((RANKS, cap, n_pod // ndata), np.float32)
        for p, kp in enumerate(jax.random.split(key, npods)):
            k = kp
            for rnd in range(cap):
                k, k1 = jax.random.split(k)
                for d in range(ndata):
                    draws[p * ndata + d, rnd] = np.asarray(jax.random.gumbel(
                        jax.random.fold_in(k1, d), (n_pod // ndata,)))
        return draws

    def put_ss(name, ss, draws):
        out[f"ss_{name}_vprime"] = np.asarray(ss.vprime)
        out[f"ss_{name}_rounds"] = np.asarray(ss.rounds)
        out[f"ss_{name}_trace"] = np.asarray(ss.alive_trace)
        out[f"ss_{name}_eps"] = np.asarray(ss.eps_hat)
        out[f"ss_{name}_noise"] = draws

    def put_greedy(name, res):
        out[f"{name}_sel"] = np.asarray(res.selected)
        out[f"{name}_gains"] = np.asarray(res.gains)
        out[f"{name}_value"] = np.asarray(res.value)

    # 1. shard_init's first quantity (C, or each row's best) and the residuals
    for case in INIT_CASES:
        o, pod = case.split("_")[0], case.endswith("_pod")
        fn, mesh = fns[o], mesh22 if pod else mesh4
        axes = ("pod", "data") if pod else ("data",)
        arrays, specs, rebuild = fn.shard_pack(axes)
        spec = P(axes if pod else axes[0])

        def body(*arrs, rebuild=rebuild):
            loc = rebuild(*arrs)
            ctx = loc.shard_init("data")
            return loc.shard_residuals(ctx), ctx[0][None]

        resid, ctx0 = jax.jit(shard_map(body, mesh=mesh, in_specs=specs,
                                        out_specs=(spec, spec)))(*arrays)
        out[f"init_{case}_resid"] = np.asarray(resid)
        out[f"init_{case}_ctx0"] = np.asarray(ctx0)

    # 2. sharded SS under the draws it made
    for case in SS_CASES:
        o = case.split("_")[0]
        fn, kw, npods = fns[o], {}, 1
        if case.endswith("_pod"):
            kw, npods = {"pod_axis": "pod"}, 2
        elif case.endswith("_state"):
            kw = {"state": fn.add_many(fn.empty_state(), jnp.arange(N) < 4)}
            out[f"ss_{case}_state"] = np.asarray(kw["state"])
        elif case.endswith("_imp"):
            kw = {"importance": True}
        ss = jax.jit(lambda fn, kw=kw, m=mesh22 if npods > 1 else mesh4:
                     dd.ss_sparsify_sharded(fn, key, m, **kw))(fn)
        put_ss(case, ss, ss_draws(key, N, npods))

    # 3. exact and stochastic greedy over the mesh
    for case in GREEDY_CASES:
        o = case.split("_")[0]
        fn, kw = fns[o], {"alive": jnp.asarray(out[f"ss_{o}_vprime"])}
        k = K
        if case == "fc_full":
            kw = {"alive": jnp.ones((N,), bool)}       # the port passes None
        elif case == "fc_exhausted":
            kw, k = {"alive": jnp.arange(N) < 4}, 7
        elif case == "fc_state":
            kw["state"] = fn.add_many(fn.empty_state(), jnp.arange(N) < 3)
            out["greedy_fc_state_start"] = np.asarray(kw["state"])
        # jit with the mask a constant: the reference reads it on the host
        put_greedy(f"greedy_{case}", jax.jit(
            lambda fn, k=k, kw=kw: dd.greedy_sharded(fn, k, mesh4, **kw))(fn))
    for i, case in enumerate(STOCH_CASES):
        o = case.split("_")[0]
        fn, k, alive = fns[o], K, out[f"ss_{o}_vprime"]
        if case == "fc_exhausted":
            k, alive = 9, np.arange(N) < 6
        elif case == "fc_ground":
            alive = a["big"]
        k2 = jax.random.PRNGKey(7 + i)
        bucket = selection_bucket(N, int(alive.sum()), 8.0)
        B = N if bucket is None else bucket
        out[f"stoch_{case}_noise"] = np.stack([
            np.asarray(jax.random.gumbel(kk, (B,))) for kk in jax.random.split(k2, k)])
        out[f"stoch_{case}_alive"] = alive
        put_greedy(f"stoch_{case}", jax.jit(
            lambda fn, k=k, k2=k2, alive=jnp.asarray(alive): dd.stochastic_greedy_sharded(
                fn, k, k2, mesh4, alive=alive))(fn))

    # 4. the pipeline on a news day, with and without pods
    news = FeatureCoverage(W=jnp.asarray(a["news"]))
    out["news_dense_value"] = np.asarray(greedy(news, 8).value)
    for case, mesh, pod in (("data", mesh4, None), ("pod", mesh22, "pod")):
        sel, val, vp, eps = dd.summarize_sharded(news, 8, key, mesh, pod_axis=pod)
        # (its SS runs eagerly here: its greedy needs V' on the host)
        out[f"sum_{case}_sel"] = np.asarray(sel)
        out[f"sum_{case}_value"] = np.asarray(val)
        out[f"sum_{case}_vprime"] = np.asarray(vp)
        out[f"sum_{case}_noise"] = ss_draws(key, NEWS[0], 2 if pod else 1)
    np.savez(out_path, **out)


# -- the runs -------------------------------------------------------------------


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    inp, ref = tmp / "inputs.npz", tmp / "ref.npz"
    np.savez(inp, **_inputs())
    me = str(Path(__file__).resolve())
    jax_run = subprocess.run(
        [sys.executable, me, "jax", str(inp), str(ref)], capture_output=True, text=True,
        timeout=400, env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                              JAX_PLATFORMS="cpu"))
    assert jax_run.returncode == 0, jax_run.stderr[-4000:]
    procs = [subprocess.Popen(
        [sys.executable, str(RANKS_SCRIPT), str(r), str(tmp / "store"), str(inp), str(ref),
         str(tmp / f"port{r}.npz")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_env(OMP_NUM_THREADS="1")) for r in range(RANKS)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=400)
        errs.append((p.returncode, err[-4000:]))
    assert all(rc == 0 for rc, _ in errs), errs
    ports = [dict(np.load(tmp / f"port{r}.npz")) for r in range(RANKS)]
    return dict(np.load(ref)), ports, _inputs()


def test_every_rank_returns_the_same_results(runs):
    _, ports, _ = runs
    for other in ports[1:]:
        assert other.keys() == ports[0].keys()
        for key, val in ports[0].items():
            if key.startswith("init_") and key.endswith(("_ctx0", "_rank_order",
                                                         "_value")):
                continue                 # a rank's own pod's or rows' figures
            np.testing.assert_array_equal(other[key], val, err_msg=key)


def _fc_truth(rows: np.ndarray, C32: np.ndarray, phi: str, fw: np.ndarray | None):
    """f(v | V \\ v) of FeatureCoverage rows in float64 from a float32 C, and
    the bound of its float32 evaluation: each phi term rounds once, the two
    sums over F features round at most log2(F) + 2 times each, and the
    result is their difference (phi(C) and phi(C - W_v) are of the same
    size, so it cancels), so the error is a few float32 spacings of the
    terms' total."""
    C = C32.astype(np.float64)
    W = rows.astype(np.float64)
    w = np.ones(C.shape) if fw is None else fw.astype(np.float64)
    if phi == "sqrt":
        tc, tv = np.sqrt(C), np.sqrt(np.maximum(C - W, 0.0))
    else:
        tc, tv = np.minimum(C, 0.3 * C), np.minimum(C - W, 0.3 * C)
    truth = (w * tc).sum() - (w * tv).sum(axis=1)
    bound = (math.log2(C.shape[0]) + 3) * EPS32 * ((w * tc).sum() + (w * tv).sum(axis=1))
    return truth, bound


def _fl_truth(sim: np.ndarray):
    """Facility location's residuals in float64 from a similarity, and the
    bound of a float32 sum of the same terms in any order."""
    s = sim.astype(np.float64)
    srt = np.sort(s, axis=1)
    best, second = srt[:, -1], srt[:, -2]
    is_best = s >= best[:, None]
    loss = np.where(is_best.sum(1) > 1, 0.0,
                    np.maximum(best, 0) - np.maximum(second, 0))
    terms = np.where(is_best, loss[:, None], 0.0)
    return terms.sum(0), (math.log2(s.shape[0]) + 3) * EPS32 * np.abs(terms).sum(0) + 1e-7


@pytest.mark.parametrize("case", INIT_CASES)
def test_shard_init_and_residuals_hold_to_float64(runs, case):
    ref, ports, inp = runs
    port = ports[0]
    o, pod = case.split("_")[0], case.endswith("_pod")
    got, want = port[f"init_{case}_resid"], ref[f"init_{case}_resid"]
    if o in ("fl", "sfl"):
        sim = ref["fl_sim"] if o == "fl" else np.maximum(
            ref["sfl_X"].astype(np.float64) @ ref["sfl_X"].T.astype(np.float64), 0.0)
        truth, bound = _fl_truth(sim)
        if o == "sfl":
            bound = bound + 4 * (D + 2) * EPS32     # the tiles' own products
        for name, r in (("port", got), ("reference", want)):
            assert (np.abs(r - truth) <= bound).all(), (name, np.abs(r - truth).max())
        # every rank's ctx[0], each row's best, is the exact global max
        for p in ports:
            np.testing.assert_array_equal(p[f"init_{case}_ctx0"][0], port[f"init_{case}_ctx0"][0])
        return
    phi = "sqrt" if o in ("fc", "fw") else "satcov"
    fw = inp["feat_w"] if o == "fw" else None
    rows_a = N // 2 if pod else N
    for name, r, ctx0 in (("port", got, port[f"init_{case}_ctx0"]),
                          ("reference", want, ref[f"init_{case}_ctx0"])):
        for s in range(RANKS):
            lo = s * (N // RANKS)
            blk = slice(lo, lo + N // RANKS)
            truth, bound = _fc_truth(inp["W"][blk], ctx0[s], phi, fw)
            err = np.abs(r[blk].astype(np.float64) - truth)
            assert (err <= bound).all(), (name, s, err.max(), bound.min())
    # C: the same bits on every rank of a pod, the shards' column sums added
    # in rank order, and within float32 summation of the float64 total
    for r_, p in enumerate(ports):
        C = p[f"init_{case}_ctx0"][r_]
        np.testing.assert_array_equal(C, p[f"init_{case}_rank_order"])
        pod_rows = inp["W"][(r_ // 2) * rows_a:(r_ // 2 + 1) * rows_a] if pod else inp["W"]
        C64 = pod_rows.astype(np.float64).sum(0)
        assert (np.abs(C - C64) <= rows_a * EPS32 * C64).all()
        assert (np.abs(ref[f"init_{case}_ctx0"][r_] - C64) <= rows_a * EPS32 * C64).all()


@pytest.mark.parametrize("case", INIT_CASES)
def test_fused_divergence_hook_is_the_min_over_payload_gains(runs, case):
    """Each objective's ``shard_divergence`` (a blocked walk) against the
    base class's min over ``shard_payload_gains`` less the residuals, over
    the view and over a buffer (``shard_take``)."""
    _, ports, _ = runs
    for tag in ("all", "cand"):
        fused = ports[0][f"init_{case}_hook_{tag}_fused"]
        pair = ports[0][f"init_{case}_hook_{tag}_pair"]
        np.testing.assert_allclose(fused, pair, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", ("fc", "sat", "fw", "fc_pod", "sat_pod"))
def test_coverage_view_takes_the_cap_and_value_from_the_context(runs, case):
    """The view's gains and value with ctx's cap are the whole objective's
    (within float32 rounding); satcov's cap from the view's own rows would
    give another value."""
    from repro_torch.core import FeatureCoverage

    ref, ports, inp = runs
    o, pod = case.split("_")[0], case.endswith("_pod")
    rows = N // 2 if pod else N
    for r_, p in enumerate(ports):
        lo = (r_ // 2) * rows if pod else 0
        W = torch.from_numpy(inp["W"][lo:lo + rows])
        fn = FeatureCoverage(W=W, phi="satcov" if o == "sat" else "sqrt", alpha=0.3,
                             feat_w=torch.from_numpy(inp["feat_w"]) if o == "fw" else None)
        st = FeatureCoverage(W=torch.from_numpy(inp["W"])).add_many(
            torch.zeros(F), torch.arange(N) < SAT_ROWS)
        sharded, local = p[f"init_{case}_value"]
        np.testing.assert_allclose(sharded, float(fn.value(st)), rtol=1e-6)
        gains = p[f"init_{case}_gains"][lo:lo + rows] if pod else p[f"init_{case}_gains"]
        np.testing.assert_allclose(gains, fn.gains(st).numpy(), rtol=1e-5, atol=1e-5)
        if o == "sat":
            assert abs(local - sharded) > 1.0   # the local cap under-saturates


@pytest.mark.parametrize("case", SS_CASES)
def test_ss_sparsify_sharded_replays_the_reference(runs, case):
    ref, ports, _ = runs
    port = ports[0]
    # eps_hat is a divergence, a gain minus a probe's residual, and the
    # residual carries the float32 cancellation of phi(C) - phi(C - W_u)
    # (C differs in its last bits between the two packages' sums): so its
    # tolerance adds the largest residual difference of the same objective
    init = case if case.endswith("_pod") else case.split("_")[0]
    dresid = np.abs(port[f"init_{init}_resid"] - ref[f"init_{init}_resid"]).max()
    for tag in (f"ss_{case}", f"ss_{case}_full"):          # compact, full width
        np.testing.assert_array_equal(port[f"{tag}_vprime"], ref[f"ss_{case}_vprime"])
        assert int(port[f"{tag}_rounds"]) == int(ref[f"ss_{case}_rounds"])
        np.testing.assert_array_equal(port[f"{tag}_trace"], ref[f"ss_{case}_trace"])
        np.testing.assert_allclose(port[f"{tag}_eps"], ref[f"ss_{case}_eps"], rtol=1e-5,
                                   atol=float(dresid))
    assert 0 < port[f"ss_{case}_vprime"].sum() < N


def _same_greedy(port, ref, name):
    np.testing.assert_array_equal(port[f"{name}_sel"], ref[f"{name}_sel"])
    np.testing.assert_allclose(port[f"{name}_gains"], ref[f"{name}_gains"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port[f"{name}_value"], ref[f"{name}_value"], rtol=1e-4)


@pytest.mark.parametrize("case", GREEDY_CASES)
def test_greedy_sharded_selects_as_the_reference_and_dense_greedy(runs, case):
    ref, ports, _ = runs
    port = ports[0]
    _same_greedy(port, ref, f"greedy_{case}")
    np.testing.assert_array_equal(port[f"greedy_{case}_sel"], port[f"dense_{case}_sel"])
    np.testing.assert_allclose(port[f"greedy_{case}_gains"], port[f"dense_{case}_gains"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port[f"greedy_{case}_value"], port[f"dense_{case}_value"],
                               rtol=1e-4)


@pytest.mark.parametrize("case", STOCH_CASES)
def test_stochastic_greedy_sharded_replays_the_reference(runs, case):
    ref, ports, _ = runs
    _same_greedy(ports[0], ref, f"stoch_{case}")


@pytest.mark.parametrize("case", ("data", "pod"))
def test_summarize_sharded_beats_095_and_replays_the_reference(runs, case):
    ref, ports, _ = runs
    port = ports[0]
    ratio = float(port[f"sum_{case}_value"] / port["news_dense_value"])
    assert ratio > 0.95, ratio
    np.testing.assert_array_equal(port[f"sum_{case}_vprime"], ref[f"sum_{case}_vprime"])
    np.testing.assert_array_equal(port[f"sum_{case}_sel"], ref[f"sum_{case}_sel"])
    np.testing.assert_allclose(port[f"sum_{case}_value"], ref[f"sum_{case}_value"],
                               rtol=1e-4)
    assert port[f"sum_{case}_vprime"].sum() < NEWS[0]


def test_sharded_backend_runs_the_whole_loops(runs):
    ref, ports, _ = runs
    port = ports[0]
    np.testing.assert_array_equal(port["be_ss_vprime"], ref["ss_fc_vprime"])
    np.testing.assert_array_equal(port["be_default_vprime"], ref["ss_fc_vprime"])
    np.testing.assert_array_equal(port["be_greedy_sel"], ref["greedy_fc_sel"])
    _same_greedy(port, ref, "stoch_fc")
    np.testing.assert_array_equal(port["be_stoch_sel"], ref["stoch_fc_sel"])


def test_sharded_backend_runs_dense_greedy_on_an_indivisible_ground_set(runs):
    _, ports, _ = runs
    port = ports[0]
    assert int(port["be_odd_dense_runs"]) == 1
    np.testing.assert_array_equal(port["be_odd_sel"], port["dense_odd_sel"])


def test_sharded_backend_refuses_batches_and_pod_stochastic_greedy(runs):
    _, ports, _ = runs
    assert ports[0]["be_raises"].tolist() == [1, 1]


def test_sharded_backend_needs_a_process_group():
    import torch.distributed as dist

    from repro_torch.core import ShardedBackend, resolve_backend

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torch.distributed.init_process_group"):
        ShardedBackend()
    with pytest.raises(RuntimeError, match="torch.distributed.init_process_group"):
        resolve_backend("sharded", "cpu")
    assert resolve_backend(None, "cpu").name == "reference"


if __name__ == "__main__":
    _jax_side(*sys.argv[2:4])
