"""The dry run's pod cells and sharded prefill and decode against the JAX
package on the CPU: ``launch/mesh.py`` (``make_production_mesh``,
``fake_group``), ``launch/cost.py``'s collectives, the roofline's
collective term, ``launch/steps.py`` and ``launch/dryrun.py`` on a mesh,
and the models' sharded caches.

The module fixture starts one JAX subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, each function
compiled once: the reference's ``prefill`` and ``decode_step`` jitted with
its cell's shardings on (2, 2), and its 2-layer llama3.2-3b prefill cell
compiled for ``hlo_cost``) beside four rank processes of the port
(``tests/torch_dryrun_sharded_ranks.py``, gloo over a ``file://`` store),
both from the same numpy draws; the tests that need no subprocess run in
this process meanwhile, over fake process groups.  Tolerance: 1e-4 of
max|want| for the sharded calls (float32 through a few layers in other
summation orders), bit for bit where the arithmetic is the same.
"""

import dataclasses
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_dryrun_sharded_ranks import (
    B,
    DECODE,
    MAX_LEN,
    RANKS,
    S,
    SERVE_CASES,
    inputs as _inputs,
    unflat,
)

ROOT = Path(__file__).resolve().parents[1]
RANKS_SCRIPT = Path(__file__).resolve().parent / "torch_dryrun_sharded_ranks.py"
#: (vii): llama3.2-3b at full width cut to 2 layers, prefill of 4 x 128
FLOPS_LAYERS, FLOPS_B, FLOPS_S = 2, 4, 128
SHAPE_ARCHS = ("llama3.2-3b", "mamba2-780m", "llama4-maverick-400b-a17b")


def _named_leaves(tree, is_leaf=None) -> dict:
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in leaves}


# -- the JAX side ---------------------------------------------------------------


def _jax_side(inp_path: str, out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import configs as jconfigs
    from repro.compat import make_mesh, set_mesh
    from repro.launch import hlo_cost
    from repro.models import decoder as jdec
    from repro.models.sharding import cache_spec_tree, data_spec, param_spec_tree

    arrays = dict(np.load(inp_path))
    mesh = make_mesh((2, 2), ("data", "model"))

    def named(tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                            is_leaf=lambda x: isinstance(x, P))

    def sharded(shape):
        return NamedSharding(mesh, data_spec(mesh, shape))

    def jitted(jcfg, params_shape, batch):
        """The reference's prefill and decode cells (``launch/steps.py``)."""
        p_sh = named(param_spec_tree(jcfg, params_shape, mesh))
        c_sh = named(cache_spec_tree(
            jcfg, jax.eval_shape(lambda: jdec.init_cache(jcfg, batch, MAX_LEN)), mesh))
        logit_sh = sharded((batch, 1, jcfg.vocab_size))
        pre = jax.jit(lambda p, t: jdec.prefill(jcfg, p, t, max_len=MAX_LEN),
                      in_shardings=(p_sh, sharded((batch, S))), out_shardings=(logit_sh, c_sh))
        dec = jax.jit(lambda p, t, c, n: jdec.decode_step(jcfg, p, t, c, n),
                      in_shardings=(p_sh, sharded((batch, 1)), c_sh, NamedSharding(mesh, P())),
                      out_shardings=(logit_sh, c_sh), donate_argnums=(2,))
        return p_sh, pre, dec

    out = {}
    with set_mesh(mesh):
        for case, (arch, over) in SERVE_CASES.items():
            jcfg = dataclasses.replace(jconfigs.smoke(arch), **over)
            params = jax.tree.map(jnp.asarray, unflat(arrays, f"{case}/params"))
            p_sh, pre, dec = jitted(jcfg, jax.eval_shape(lambda: params), B)
            params = jax.device_put(params, p_sh)
            logits, cache = pre(params, jnp.asarray(arrays[f"{case}/tokens"]))
            out[f"{case}/prefill/logits"] = np.asarray(logits)
            for k, v in _named_leaves(cache).items():
                out[f"{case}/prefill/cache/{k}"] = np.asarray(v)
            for i in range(DECODE):
                logits, cache = dec(params, jnp.asarray(arrays[f"{case}/next"][i]), cache,
                                    jnp.int32(S + i))
                out[f"{case}/decode{i}/logits"] = np.asarray(logits)
            for k, v in _named_leaves(cache).items():
                out[f"{case}/decode/cache/{k}"] = np.asarray(v)

        # (vii) the reference's prefill cell of a 2-layer llama3.2-3b, compiled
        jcfg = dataclasses.replace(jconfigs.get("llama3.2-3b"), num_layers=FLOPS_LAYERS)
        shapes = jax.eval_shape(lambda: jdec.init_params(jax.random.PRNGKey(0), jcfg))
        p_sh = named(param_spec_tree(jcfg, shapes, mesh))
        c_sh = named(cache_spec_tree(jcfg, jax.eval_shape(
            lambda: jdec.init_cache(jcfg, FLOPS_B, FLOPS_S)), mesh))
        fn = jax.jit(lambda p, t: jdec.prefill(jcfg, p, t, max_len=FLOPS_S),
                     in_shardings=(p_sh, sharded((FLOPS_B, FLOPS_S))),
                     out_shardings=(sharded((FLOPS_B, 1, jcfg.vocab_size)), c_sh))
        hlo = fn.lower(shapes, jax.ShapeDtypeStruct((FLOPS_B, FLOPS_S), jnp.int32)) \
            .compile().as_text()
        out["vii/flops"] = np.asarray(hlo_cost.analyze(hlo)["flops"], np.float64)
    np.savez(out_path, **out)


# -- the runs -------------------------------------------------------------------


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(extra)
    return env


class _Runs:
    """The JAX subprocess and the four ranks, started at once; ``get``
    waits for them and returns (the reference's results, each rank's)."""

    def __init__(self, tmp):
        self.tmp = tmp
        inp = tmp / "inputs.npz"
        np.savez(inp, **_inputs())
        self.jax = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "jax", str(inp), str(tmp / "ref.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                     JAX_PLATFORMS="cpu"))
        self.ranks = [subprocess.Popen(
            [sys.executable, str(RANKS_SCRIPT), str(r), str(tmp / "store"), str(inp),
             str(tmp / f"port{r}.npz")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=_env(OMP_NUM_THREADS="1")) for r in range(RANKS)]
        self.result = None

    def get(self):
        if self.result is None:
            _, jerr = self.jax.communicate(timeout=600)
            assert self.jax.returncode == 0, jerr[-4000:]
            errs = [(p.returncode, p.communicate(timeout=600)[1][-4000:]) for p in self.ranks]
            assert all(p.returncode == 0 for p in self.ranks), errs
            self.result = (dict(np.load(self.tmp / "ref.npz")),
                           [dict(np.load(self.tmp / f"port{r}.npz")) for r in range(RANKS)])
        return self.result


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = _Runs(tmp_path_factory.mktemp("dryrun_sharded"))
    yield r
    for p in [r.jax, *r.ranks]:
        if p.poll() is None:
            p.kill()
            p.wait()


def _close(got, want, rel=1e-4, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = rel * max(1.0, float(np.abs(want).max())) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol, f"{what}: {err} > {tol}"


def _smoke32(arch):
    """The SMOKE config at head_dim 32, the flash kernels' narrowest (the
    count follows the card's route)."""
    from repro_torch import configs

    return dataclasses.replace(configs.smoke(arch), head_dim=32)


# -- (i) the production meshes --------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_have_the_reference_shapes(runs, multi_pod):
    """Over a fake group of 256 and 512 ranks; rank 0's local shard of every
    parameter of three archs at full size is the reference's spec tree on
    an ``AbstractMesh`` of the shape: each dimension over the product of
    its axes' sizes, with ``fit_spec``'s fallbacks."""
    from jax.sharding import AbstractMesh, PartitionSpec as P
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro import configs as jconfigs
    from repro.models import decoder as jdec
    from repro.models import sharding as jsh
    from repro_torch import configs
    from repro_torch.launch.mesh import fake_group, make_production_mesh
    from repro_torch.models import abstract_params
    from repro_torch.models.sharding import param_spec_tree, placements
    from torch_lm_sharded_ranks import flat

    import jax

    world = 512 if multi_pod else 256
    with fake_group(world):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert mesh.size() == world and mesh.device_type == "cuda"
        want_shape = (2, 16, 16) if multi_pod else (16, 16)
        want_axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        assert tuple(mesh.shape) == want_shape and mesh.mesh_dim_names == want_axes
        assert all(mesh.get_group(a).size() == s for a, s in zip(want_axes, want_shape))
        amesh = AbstractMesh(want_shape, want_axes)
        sizes = dict(zip(want_axes, want_shape))
        for arch in SHAPE_ARCHS:
            jcfg, cfg = jconfigs.get(arch), configs.get(arch)
            jshapes = jax.eval_shape(lambda: jdec.init_params(jax.random.PRNGKey(0), jcfg))
            specs = _named_leaves(jsh.param_spec_tree(jcfg, jshapes, amesh),
                                  lambda x: isinstance(x, P))
            tshapes = abstract_params(cfg)
            ours = flat(param_spec_tree(cfg, tshapes, mesh))
            for name, leaf in _named_leaves(jshapes).items():
                want = [d // int(np.prod([sizes[a] for a in
                                          ((e,) if isinstance(e, str) else (e or ()))]))
                        for d, e in zip(leaf.shape, tuple(specs[name])
                                        + (None,) * (len(leaf.shape) - len(specs[name])))]
                got, _ = compute_local_shape_and_global_offset(
                    tuple(flat(tshapes)[name].shape), mesh, placements(mesh, ours[name]))
                assert list(got) == want, (arch, name)


def test_fake_group_needs_no_open_group_and_closes():
    import torch.distributed as dist

    from repro_torch.launch.mesh import fake_group, make_production_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_production_mesh()
    with fake_group(256):
        with pytest.raises(RuntimeError, match="already open"):
            with fake_group(4):
                pass
    assert not dist.is_initialized()


# -- (ii) the operand rule ------------------------------------------------------

_HLO = {
    "all-gather": "%o = bf16[{r}]{{1,0}} all-gather{ph}(bf16[{i}]{{1,0}} %x), "
                  "replica_groups={{{{{g}}}}}, dimensions={{0}}",
    "all-reduce": "%o = f32[{r}]{{1,0}} all-reduce{ph}(f32[{i}]{{1,0}} %x), "
                  "replica_groups={{{{{g}}}}}, to_apply=%add",
    "reduce-scatter": "%o = f32[{r}]{{1,0}} reduce-scatter{ph}(f32[{i}]{{1,0}} %x), "
                      "replica_groups={{{{{g}}}}}, dimensions={{0}}, to_apply=%add",
    "all-to-all": "%o = bf16[{r}]{{1,0}} all-to-all{ph}(bf16[{i}]{{1,0}} %x), "
                  "replica_groups={{{{{g}}}}}, dimensions={{0}}",
    "collective-permute": "%o = f32[{r}]{{1,0}} collective-permute{ph}(f32[{i}]{{1,0}} %x), "
                          "source_target_pairs={{{{0,1}},{{1,0}}}}",
}


def _issue(op: str, group, x):
    """The port's functional collective of ``op`` on ``x`` over ``group``."""
    import torch.distributed._functional_collectives as funcol

    if op == "all-gather":
        return funcol.all_gather_single(x, 0, group)
    if op == "all-reduce":
        return funcol.all_reduce(x, "sum", group)
    if op == "reduce-scatter":
        return funcol.reduce_scatter_single(x, "sum", 0, group)
    return funcol.all_to_all_single(x, None, None, group)


@pytest.mark.parametrize("phase", ["", "-start/-done"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("op", list(_HLO))
def test_collective_operand_rule_matches_the_reference(op, g, phase):
    """The port records each collective's input; the reference recovers the
    operand from the result and the group's size.  Both sums agree for
    every op, a group of one and an async pair (the port's functional
    collective and its ``wait_tensor``; the reference's ``-start`` and
    ``-done``).  No functional collective permutes: that record is built."""
    import torch.distributed as dist

    from repro.launch import hlo_analysis
    from repro_torch.launch import cost
    from repro_torch.launch.mesh import fake_group, make_mesh

    rows, cols = 8 if op != "reduce-scatter" else 8 * g, 16
    dt = torch.bfloat16 if op in ("all-gather", "all-to-all") else torch.float32
    with fake_group(4):
        mesh = make_mesh((4 // g, g), ("data", "model"), "cuda")
        group = mesh.get_group("model")
        x = torch.empty((rows, cols), dtype=dt, device="meta")
        if op == "collective-permute":
            recs = [cost.Collective(op, group.group_name, g,
                                    tuple(dist.get_process_group_ranks(group)),
                                    x.numel() * x.element_size())]
            result = (rows, cols)
        else:
            mode = cost.CostMode()
            with mode:
                y = _issue(op, group, x)
                y = y.wait() if hasattr(y, "wait") else y
            recs = mode.collectives
            result = tuple(y.shape)
        assert [r.op for r in recs] == [op] and recs[0].size == g
    got = cost.collective_bytes(recs)
    members = ",".join(str(i) for i in range(g))
    text = "\n".join(
        _HLO[op].format(r=",".join(map(str, result)), i=f"{rows},{cols}", g=members, ph=ph)
        for ph in (("-start", "-done") if phase else ("",)))
    want = hlo_analysis.collective_bytes(text)
    assert got.bytes_by_op == want.bytes_by_op and got.count_by_op == want.count_by_op
    assert got.total_bytes == want.total_bytes == x.numel() * x.element_size()


# -- (iii) the roofline's collective term ----------------------------------------


def test_roofline_collective_term_matches_the_reference_formula():
    """The reference's formula with the card's link rates passed in under
    its names: NVLink for the bytes inside a node, the inter-node link for
    the rest."""
    from repro.launch import hlo_analysis
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import HW

    assert (HW["nvlink_bw"], HW["internode_bw"], HW["gpus_per_node"]) == (450e9, 50e9, 8)
    grid = itertools.product((0.0, 3.7e12, 2.2e15), (0.0, 5.1e9, 8.8e12),
                             (0.0, 1.3e9, 4.4e11, 7.0e12), (0.0, 0.25, 1.0))
    ref_hw = dict(HW, ici_bw=HW["nvlink_bw"], dcn_bw=HW["internode_bw"])
    for flops, nbytes, coll, pod in grid:
        got = roofline.roofline(flops, nbytes, coll, HW, pod_fraction=pod)
        want = hlo_analysis.roofline(flops, nbytes, coll, ref_hw, pod_fraction=pod)
        assert got == want, (flops, nbytes, coll, pod)
    rl = roofline.roofline(0.0, 0.0, 450e9, HW, pod_fraction=0.5)
    assert rl["collective_s"] == pytest.approx(0.5 + 450e9 * 0.5 / 50e9)


def test_collective_split_prices_groups_by_node():
    """A group inside one node of 8 stays on NVLink; on (16, 16) every
    model group is 16 consecutive ranks, two nodes, and every data group
    sixteen."""
    from repro_torch.launch import cost, dryrun
    from repro_torch.launch.mesh import fake_group, make_mesh, make_production_mesh

    with fake_group(256):
        mesh = make_production_mesh()
        recs = []
        for axis in ("data", "model"):
            grp = mesh.get_group(axis)
            import torch.distributed as dist

            ranks = tuple(dist.get_process_group_ranks(grp))
            assert len({r // 8 for r in ranks}) == (16 if axis == "data" else 2)
            recs.append(cost.Collective("all-reduce", grp.group_name, 16, ranks, 100))
        split = dryrun.collective_split(mesh, recs)
        assert split["bytes_by_axis"] == {"data": 100, "model": 100}
        assert split["internode_fraction"] == 1.0
    with fake_group(16):
        mesh = make_mesh((2, 8), ("data", "model"), "cuda")
        import torch.distributed as dist

        grp = mesh.get_group("model")
        recs = [cost.Collective("all-gather", grp.group_name, 8,
                                tuple(dist.get_process_group_ranks(grp)), 300)]
        assert dryrun.collective_split(mesh, recs)["internode_fraction"] == 0.0


def test_roofline_table_prints_the_collective_columns():
    """A pod record's row carries its collective bytes by op, the
    inter-node share and the count's seconds; a one-card record's row
    shows none."""
    from repro_torch.launch import roofline

    pod = {"arch": "a", "shape": "s", "status": "ok", "chips": 256, "count_s": 12.34,
           "cost": {"flops_per_chip": 1e12, "bytes_per_chip": 2e9,
                    "collective_bytes_per_chip": 3e9, "internode_fraction": 1.0,
                    "collectives": {"all-reduce": 2e9, "all-gather": 1e9}},
           "roofline": roofline.roofline(1e12, 2e9, 3e9, roofline.HW, pod_fraction=1.0),
           "memory": {"analytic_state_bytes": 1e9, "peak_bytes": 4e9, "fits_80gb": True},
           "model_flops_per_chip": 5e11, "useful_flops_ratio": 0.5}
    one = dict(pod, cost={k: v for k, v in pod["cost"].items()
                          if k not in ("collectives", "internode_fraction")})
    lines = roofline.table([pod, one]).splitlines()
    assert "coll GB by op" in lines[0] and "inter-node" in lines[0]
    assert "ag 1 ar 2" in lines[1] and "1.00" in lines[1] and "12.3" in lines[1]
    assert lines[1].split()[-7] == "collective"
    assert " — " in lines[2] and "0.00" in lines[2]


# -- (iv) local counts, not global ----------------------------------------------


#: (arch, kind) -> the operators whose rows differ between the (1, 1) count
#: and the one-card count, each difference the sharded path's own: olmoe's
#: decode on DTensors is the capacity dispatch of ``moe._sharded`` (one
#: device gathers each token's experts, ``_decode_path``)
_ONE_RANK_PATHS = {
    ("olmoe-1b-7b", "decode"): {
        "aten._to_copy", "aten.add", "aten.arange", "aten.bmm", "aten.cat", "aten.clone",
        "aten.cumsum", "aten.eq", "aten.floor_divide", "aten.full", "aten.gather",
        "aten.index", "aten.lt", "aten.mul", "aten.new_zeros", "aten.scalar_tensor",
        "aten.scatter_reduce_", "aten.silu", "aten.sub", "aten.where"},
    # one einsum's batched product taken as a plain product: the same FLOPs
    ("recurrentgemma-2b", "decode"): {"aten.bmm", "aten.mm"},
}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "olmoe-1b-7b", "mamba2-780m",
                                  "recurrentgemma-2b"])
def test_one_by_one_mesh_count_equals_the_one_card_count(arch, kind):
    """Hazard 1: on (1, 1) over a fake group of one rank a sharded cell's
    FLOPs, bytes and peak are the one-card count's exactly, operator by
    operator, with no collective; a second count of the same cell gives
    the same numbers (DTensor's propagation, which runs only the first
    time, is dropped; llama's cells, counted twice).  Each family's mixer (attention, experts, SSD,
    RG-LRU): an operator dropped from the sharded count shows here.  Where
    the sharded path runs other local arithmetic (``_ONE_RANK_PATHS``),
    exactly the named operators differ, and the FLOPs only where the path
    multiplies other shapes."""
    from repro_torch.launch import cost, steps
    from repro_torch.launch.mesh import fake_group, single_device_mesh
    from repro_torch.models import ShapeConfig

    cfg = _smoke32(arch)
    shp = ShapeConfig(kind, 48, 4, kind)
    want = cost.count(steps.build_cell(arch, shp, cfg), top=10**4)
    with fake_group(1):
        mesh = single_device_mesh()
        got = [cost.count(steps.build_cell(arch, shp, cfg, mesh), top=10**4)
               for _ in range(2 if arch == "llama3.2-3b" else 1)]
    rows = {r["op"]: r for r in want["top_by_bytes"]}
    named = _ONE_RANK_PATHS.get((arch, kind), set())
    for g in got:
        assert g["collectives"] == {} and g["collective_bytes"] == 0
        grows = {r["op"]: r for r in g["top_by_bytes"]}
        differ = {op for op in set(rows) | set(grows) if rows.get(op) != grows.get(op)}
        assert differ == named, differ ^ named
        keys = ["attention_pairs"] + ([] if named else ["bytes", "peak_bytes"])
        if (arch, kind) != ("olmoe-1b-7b", "decode"):       # the one other product
            keys += ["flops", "flops_by_dtype"]
        for k in keys:
            assert g[k] == want[k], k
    assert got[0] == {**got[-1], "count_s": got[0]["count_s"]}
    assert want["flops"] > 0


@pytest.mark.parametrize("fault", ["read", "host tensor"])
def test_a_host_read_inside_a_sharded_step_fails_the_count(fault):
    """No ambient mode on a mesh: a read of a local shard's value still
    raises ``HostRead``, and so does an operator of the step on a host
    tensor (only DTensor's own planning may compute on one)."""
    from repro_torch.launch import cost, steps
    from repro_torch.launch.mesh import fake_group, make_mesh
    from repro_torch.models import ShapeConfig

    with fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cuda")
        cell = steps.build_cell("llama3.2-3b", ShapeConfig("d", 16, 4, "decode"),
                                _smoke32("llama3.2-3b"), mesh)
        fn = cell.fn
        if fault == "read":
            cell.fn = lambda p, t, c: fn(p, t, c)[0].to_local().sum().item()
            match = "_local_scalar_dense"
        else:
            cell.fn = lambda p, t, c: (fn(p, t, c), torch.arange(4) * 2)
            match = "a cpu tensor"
        with pytest.raises(cost.HostRead, match=match):
            cost.count(cell)


# -- (v) sharded prefill and decode against the reference ------------------------


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_sharded_prefill_and_decode_match_the_reference(runs, case):
    """Four gloo ranks on (2, 2) against the reference jitted with its
    cell's shardings on four host devices: the logits of the prefill and
    of each decode step, and every cache leaf after the prefill and after
    the decode steps, at 1e-4 of max|want|."""
    ref, ports = runs.get()
    names = [k for k in ref if k.startswith(f"{case}/")]
    assert any("/cache/" in k for k in names) and len(names) > 6
    for port in ports:
        assert sorted(k for k in port if k.startswith(f"{case}/")) == sorted(names)
        for k in names:
            _close(port[k], ref[k], what=k)


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_one_rank_mesh_serves_the_unsharded_bits(runs, case):
    _, ports = runs.get()
    port = ports[0]
    names = [k for k in port if k.startswith(f"one/{case}/plain/")]
    assert len(names) > 6
    for k in names:
        np.testing.assert_array_equal(port[k.replace("/plain/", "/mesh/")], port[k], err_msg=k)


@pytest.mark.parametrize("write", ["decode", "prefill", "window"])
def test_cache_writes_touch_only_the_local_shard(write):
    """Hazard 5: on (2, 2) (a fake group of 4, real tensors) decode writes
    the new token's k at its one slot of rank 0's shard, prefill the first
    S, a window's prefill the ring rolled; nothing else changes and no
    collective runs (the token's k arrives whole over model and is
    narrowed on the rank)."""
    from repro_torch.launch import cost
    from repro_torch.launch.mesh import fake_group, make_mesh
    from repro_torch.models.sharding import local_range, local_write, zeros_on

    L, T = 6, {"decode": 1, "prefill": 4, "window": 9}[write]
    gen = torch.Generator().manual_seed(0)
    new = torch.randn((4, T, 2, 8), generator=gen)

    def fn(c, t):
        if write == "decode":
            c[:, 3:4] = t
        elif write == "prefill":
            c[:, :T] = t
        else:
            c.copy_(torch.roll(t[:, -L:], T % L, dims=1))

    want = torch.zeros((4, L, 2, 8))
    fn(want, new)
    with fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        cache = zeros_on(mesh, ("data", None, "model", None), (4, L, 2, 8), torch.float32, "cpu")
        mode = cost.CostMode()
        with mode:
            local_write(cache, new, fn)
        assert mode.collectives == []
        (b0, b1), (k0, k1) = local_range(cache, 0), local_range(cache, 2)
        assert (b0, b1, k0, k1) == (0, 2, 0, 1)
        torch.testing.assert_close(cache.to_local(), want[b0:b1, :, k0:k1], rtol=0, atol=0)


# -- (vii) the per-chip FLOPs against the reference's partitioned program ----------


def test_sharded_prefill_flops_match_hlo_cost(runs):
    """A 2-layer llama3.2-3b prefill cell on (2, 2), per chip, against
    ``hlo_cost`` of the reference's cell compiled on four host devices,
    after the flash correction: the reference's blockwise attention
    computes every padded tile (``_blockwise_flops``), the flash operator
    the causal pairs."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_group, make_mesh
    from repro_torch.models import ShapeConfig

    cfg = dataclasses.replace(configs.get("llama3.2-3b"), num_layers=FLOPS_LAYERS)
    with fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cuda")
        rec = dryrun.run_cell("llama3.2-3b", ShapeConfig("p", FLOPS_S, FLOPS_B, "prefill"),
                              cfg, mesh=mesh, mesh_name="2x2")
    flash = sum(r["flops"] for r in rec["cost"]["top_by_flops"]
                if r["op"] == "repro_torch.flash_attention")
    b, h = FLOPS_B // 2, cfg.num_heads // 2        # rank 0's rows and heads
    assert flash == FLOPS_LAYERS * 4 * cfg.head_dim * b * h * FLOPS_S * (FLOPS_S + 1) // 2
    blockwise = FLOPS_LAYERS * 4.0 * b * h * FLOPS_S * FLOPS_S * cfg.head_dim
    ref, _ = runs.get()
    assert rec["cost"]["flops_per_chip"] - flash + blockwise == float(ref["vii/flops"])


# -- (viii) run_cell on a small pod mesh --------------------------------------------


@pytest.mark.parametrize("arch,kind,S,B,layers", [
    ("recurrentgemma-2b", "decode", 512, 8, 3),
    ("qwen3-4b", "train", 128, 8, 2),
])
def test_run_cell_on_a_small_pod_mesh(arch, kind, S, B, layers):
    """The counterpart of ``test_distributed.py``'s small-mesh dry-run
    cell: (2, 2, 2) over a fake group of 8, full width, reduced depth."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_group, make_mesh
    from repro_torch.models import ShapeConfig

    cfg = dataclasses.replace(configs.get(arch), num_layers=layers)
    with fake_group(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cuda")
        rec = dryrun.run_cell(arch, ShapeConfig(kind, S, B, kind), cfg, mesh=mesh,
                              mesh_name="2x2x2")
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert rec["cost"]["flops_per_chip"] > 0
    assert rec["cost"]["collective_bytes_per_chip"] > 0
    assert sum(rec["cost"]["collective_counts"].values()) > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["roofline"]["collective_s"] > 0
    assert set(rec["cost"]["collective_bytes_by_axis"]) <= {"pod", "data", "model"}
    assert rec["memory"]["analytic_state_bytes"] > 0


if __name__ == "__main__":
    _jax_side(*sys.argv[2:4])
