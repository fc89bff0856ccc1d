"""The port's side of ``tests/test_torch_distributed.py``: one process a
rank of four, on the CPU over gloo.

    PYTHONPATH=src python tests/torch_sharded_ranks.py RANK STORE INPUTS REF OUT

Each rank joins the group through the ``file://`` store STORE, reads the
shared inputs and the JAX package's results and draws (REF, written by the
test's JAX subprocess), runs the port's sharded loops on the (4,) and
(2, 2) meshes, and writes its results to OUT.  It imports nothing of JAX.
The constants and the inputs are the test's.
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
N, F, D, K = 512, 64, 16, 10
NEWS = (1024, 128)
RANKS = 4
OBJ = ("fc", "sat", "fw", "fl", "sfl")
INIT_CASES = OBJ + ("fc_pod", "sat_pod")
SS_CASES = OBJ + ("fc_pod", "sat_pod", "fc_state", "fl_state", "fc_imp", "fl_imp")
GREEDY_CASES = OBJ + ("fc_full", "fc_exhausted", "fc_state")
STOCH_CASES = ("fc", "fl", "fc_exhausted", "fc_ground")
EPS32 = float(np.finfo(np.float32).eps)
# rows in the state of the cap checks: coverage about 40 a feature, past a
# rank's own satcov cap (0.3 x 128 rows x 0.5), under the whole set's
SAT_ROWS = 80


def inputs() -> dict:
    from repro_torch.data import news_day

    rng = np.random.default_rng(0)
    return {
        "W": rng.uniform(size=(N, F)).astype(np.float32),
        "X": rng.normal(size=(N, D)).astype(np.float32),
        "feat_w": np.linspace(0.5, 1.5, F, dtype=np.float32),
        "news": news_day(0, *NEWS).astype(np.float32),
        "big": rng.permutation(np.arange(N) < 400),
    }


def rank_side(rank: int, store: str, inp_path: str, ref_path: str,
              out_path: str) -> None:
    import torch.distributed as dist

    from repro_torch.core import (
        FacilityLocation,
        FeatureCoverage,
        ShardedBackend,
        StreamingFacilityLocation,
        SubmodularFunction,
        greedy,
        greedy_sharded,
        ss_sparsify,
        ss_sparsify_batched,
        ss_sparsify_sharded,
        stochastic_greedy,
        stochastic_greedy_sharded,
        summarize_sharded,
    )
    from repro_torch.core.distributed import Collectives
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=RANKS)
    a = {k: torch.from_numpy(v) for k, v in np.load(inp_path).items()}
    ref = dict(np.load(ref_path))
    W = a["W"]
    fns = {
        "fc": FeatureCoverage(W=W),
        "sat": FeatureCoverage(W=W, phi="satcov", alpha=0.3),
        "fw": FeatureCoverage(W=W, feat_w=a["feat_w"]),
        "fl": FacilityLocation(sim=torch.from_numpy(ref["fl_sim"])),
        "sfl": StreamingFacilityLocation(X=torch.from_numpy(ref["sfl_X"])),
    }
    mesh4 = make_mesh((4,), ("data",), "cpu")
    mesh22 = make_mesh((2, 2), ("pod", "data"), "cpu")
    out = {}

    def tens(x):
        return torch.as_tensor(np.asarray(x))

    def put_greedy(name, res):
        out[f"{name}_sel"] = res.selected.numpy()
        out[f"{name}_gains"] = res.gains.numpy()
        out[f"{name}_value"] = res.value.numpy()

    # 1. shard_init and the residuals; C against its rank-order sum
    for case in INIT_CASES:
        o, pod = case.split("_")[0], case.endswith("_pod")
        mesh = mesh22 if pod else mesh4
        axes = ("pod", "data") if pod else ("data",)
        view = fns[o].shard(mesh, axes)
        ctx = view.shard_init(Collectives(mesh, ("data",)))
        every = Collectives(mesh, axes)
        out[f"init_{case}_resid"] = every.all_gather(view.shard_residuals(ctx)).reshape(-1).numpy()
        out[f"init_{case}_ctx0"] = every.all_gather(ctx[0]).numpy()
        # the fused divergence hook against the base class's form over
        # shard_payload_gains (and shard_take for a buffer), on 5 probes
        probes = torch.arange(0, view.local_n(), 37)[:5]
        pay, rp = view.shard_payloads(probes), view.shard_residuals(ctx)[probes]
        cand = torch.arange(0, view.local_n(), 3)
        for tag, ci in (("all", None), ("cand", cand)):
            for form, hook in (("fused", type(view).shard_divergence),
                               ("pair", SubmodularFunction.shard_divergence)):
                out[f"init_{case}_hook_{tag}_{form}"] = every.all_gather(
                    hook(view, pay, rp, ctx, ci)).numpy()
        if o in ("fc", "sat", "fw"):
            rows = N // 2 if pod else N
            first = (rank // 2) * rows if pod else 0
            parts = [W[first + s * 128:first + (s + 1) * 128].sum(dim=0)
                     for s in range(rows // 128)]
            seq = parts[0].clone()
            for p in parts[1:]:
                seq += p
            out[f"init_{case}_rank_order"] = seq.numpy()
            # the pod-global cap: the view's value and gains with ctx's cap
            st = fns[o].add_many(fns[o].empty_state(), torch.arange(N) < SAT_ROWS)
            out[f"init_{case}_value"] = np.array([float(view.shard_value(st, ctx)),
                                                  float(view.value(st))])
            out[f"init_{case}_gains"] = every.all_gather(
                view.shard_gains(st, ctx)).reshape(-1).numpy()

    # 2. sharded SS under the reference's draws
    for case in SS_CASES:
        o = case.split("_")[0]
        kw, pod = {}, None
        if case.endswith("_pod"):
            pod = "pod"
        elif case.endswith("_state"):
            kw = {"state": tens(ref[f"ss_{case}_state"])}
        elif case.endswith("_imp"):
            kw = {"importance": True}
        mesh = mesh22 if pod else mesh4
        view = fns[o].shard(mesh, ("pod", "data") if pod else ("data",))
        noise = tens(ref[f"ss_{case}_noise"][rank])
        for compact in (True, False):
            ss = ss_sparsify_sharded(view, mesh, pod_axis=pod, noise=noise,
                                     compact=compact, **kw)
            tag = f"ss_{case}" + ("" if compact else "_full")
            out[f"{tag}_vprime"] = ss.vprime.numpy()
            out[f"{tag}_rounds"] = np.asarray(ss.rounds)
            out[f"{tag}_trace"] = ss.alive_trace.numpy()
            out[f"{tag}_eps"] = ss.eps_hat.numpy()

    # 3. exact and stochastic greedy, and the port's dense greedy
    for case in GREEDY_CASES:
        o = case.split("_")[0]
        fn, k, kw = fns[o], K, {"alive": tens(ref[f"ss_{o}_vprime"])}
        if case == "fc_full":
            kw = {}
        elif case == "fc_exhausted":
            kw, k = {"alive": torch.arange(N) < 4}, 7
        elif case == "fc_state":
            kw["state"] = tens(ref["greedy_fc_state_start"])
        put_greedy(f"greedy_{case}", greedy_sharded(fn.shard(mesh4, ("data",)), k,
                                                    mesh4, **kw))
        put_greedy(f"dense_{case}", greedy(fn, k, **kw))
    for case in STOCH_CASES:
        o = case.split("_")[0]
        k = 9 if case == "fc_exhausted" else K
        put_greedy(f"stoch_{case}", stochastic_greedy_sharded(
            fns[o].shard(mesh4, ("data",)), k, mesh4,
            alive=tens(ref[f"stoch_{case}_alive"]),
            noise=tens(ref[f"stoch_{case}_noise"])))

    # 4. the pipeline on the news day
    news = FeatureCoverage(W=a["news"])
    out["news_dense_value"] = greedy(news, 8).value.numpy()
    for case, mesh, pod in (("data", mesh4, None), ("pod", mesh22, "pod")):
        view = news.shard(mesh, ("pod", "data") if pod else ("data",))
        res, ss = summarize_sharded(view, 8, mesh, pod_axis=pod,
                                    noise=tens(ref[f"sum_{case}_noise"][rank]))
        put_greedy(f"sum_{case}", res)
        out[f"sum_{case}_vprime"] = ss.vprime.numpy()

    # 5. ShardedBackend through the entry points
    be = ShardedBackend(mesh=mesh4)
    fc = fns["fc"]
    ss = ss_sparsify(fc, backend=be, noise=tens(ref["ss_fc_noise"][rank]))
    out["be_ss_vprime"] = ss.vprime.numpy()
    put_greedy("be_greedy", greedy(fc, K, alive=ss.vprime, backend=be))
    put_greedy("be_stoch", stochastic_greedy(
        fc, K, alive=tens(ref["stoch_fc_alive"]), backend=be,
        noise=tens(ref["stoch_fc_noise"])))
    before = ShardedBackend.dense_greedy_runs
    odd = FeatureCoverage(W=W[:N - 2])
    put_greedy("be_odd", greedy(odd, K, backend=be))
    put_greedy("dense_odd", greedy(odd, K))
    out["be_odd_dense_runs"] = np.asarray(ShardedBackend.dense_greedy_runs - before)
    raised = []
    for call in (lambda: ss_sparsify_batched(
                     FeatureCoverage(W=W[None]), backend=be),
                 lambda: stochastic_greedy(
                     fc, K, backend=ShardedBackend(mesh=mesh22, pod_axis="pod"))):
        try:
            call()
            raised.append(0)
        except NotImplementedError:
            raised.append(1)
    out["be_raises"] = np.asarray(raised)
    be_default = ShardedBackend()            # the default group's world
    out["be_default_vprime"] = ss_sparsify(
        fc, backend=be_default, noise=tens(ref["ss_fc_noise"][rank])).vprime.numpy()
    np.savez(out_path, **out)
    dist.destroy_process_group()



if __name__ == "__main__":
    rank_side(int(sys.argv[1]), *sys.argv[2:6])
