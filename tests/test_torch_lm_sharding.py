"""The LM sharding (``repro_torch.models.sharding``, the model's constraint
points, ``shard_train_step``, ``train/compress.py``, sharded checkpoints,
``launch/train.py --mesh``) against the JAX package on the CPU: four gloo
ranks against four forced host devices.

The spec trees of every arch at full size are compared in this process, on
abstract meshes (shapes and names only).  The module fixture then runs one
JAX subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
each function compiled once) beside four rank processes of the port
(``tests/torch_lm_sharded_ranks.py``, over a ``file://`` store), both from
the same numpy draws; each writes its results, and the tests compare them.
Tolerance: 1e-4 of max|want| for the sharded steps (float32 through a few
layers in other summation orders), bit for bit where the arithmetic is the
same.  Parity must run three steps: the learning rate of step 0 is 0.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_lm_sharded_ranks import (
    ARCHS,
    CACHE_BATCH,
    CACHE_LEN,
    COMPRESS,
    MESHES,
    ONE_RANK_CASES,
    RANKS,
    ROOT,
    SHAPE_MESHES,
    STEP_CASES,
    STEPS,
    config,
    flat,
    inputs as _inputs,
    train_kw,
    unflat,
)

RANKS_SCRIPT = Path(__file__).resolve().parent / "torch_lm_sharded_ranks.py"
SPEC_MESHES = {"16x16": ((16, 16), ("data", "model")),
               "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
               **{m: MESHES[m] for m in SHAPE_MESHES}}


def _named_leaves(tree, is_leaf=None) -> dict:
    """{"a/b/c": leaf} of a JAX pytree of dicts."""
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in leaves}


# -- the JAX side ---------------------------------------------------------------


def _jax_side(inp_path: str, out_path: str, ckpt_dir: str) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import configs as jconfigs
    from repro.compat import make_mesh, set_mesh
    from repro.models import decoder as jdec
    from repro.models.sharding import cache_spec_tree, param_spec_tree
    from repro.train import optimizer as jopt
    from repro.train import trainer as jtr
    from repro.train.checkpoint import Checkpointer
    from repro.train.compress import (
        CompressConfig,
        init_error_state,
        make_compressed_train_step,
    )

    arrays = dict(np.load(inp_path))
    out = {}
    meshes = {m: make_mesh(shape, axes) for m, (shape, axes) in MESHES.items()}
    is_p = lambda x: isinstance(x, P)
    for arch in ARCHS:
        jcfg = jconfigs.get(arch)
        trees = {
            "params": (jax.eval_shape(lambda: jdec.init_params(jax.random.PRNGKey(0), jcfg)),
                       param_spec_tree),
            "cache": (jax.eval_shape(lambda: jdec.init_cache(jcfg, CACHE_BATCH, CACHE_LEN)),
                      cache_spec_tree)}
        for kind, (shapes, rule) in trees.items():
            for m in SHAPE_MESHES:
                specs = _named_leaves(rule(jcfg, shapes, meshes[m]), is_p)
                for name, leaf in _named_leaves(shapes).items():
                    out[f"shape/{arch}/{kind}/{m}/{name}"] = np.asarray(
                        NamedSharding(meshes[m], specs[name]).shard_shape(leaf.shape))

    def start(case):
        arch, _, opt, mu, over = STEP_CASES[case]
        jcfg = dataclasses.replace(jconfigs.smoke(arch), **over)
        tc = jtr.TrainConfig(**train_kw(opt, mu))
        params = jax.tree.map(jnp.asarray, unflat(arrays, f"{case}/params"))
        o = jopt.make_optimizer(opt, **({"weight_decay": tc.weight_decay}
                                        if opt == "adamw" else {}))
        return jcfg, tc, {"params": params, "opt": o.init(params),
                          "step": jnp.zeros((), jnp.int32)}

    def batch(case, s):
        return {k: jnp.asarray(v) for k, v in unflat(arrays, f"{case}/batch{s}").items()}

    def record(tag, state, metrics):
        for s, m in enumerate(metrics):
            for k, v in m.items():
                out[f"{tag}/m{s}/{k}"] = np.asarray(v, np.float32)
        for k, v in _named_leaves(state).items():
            out[f"{tag}/state/{k}"] = np.asarray(v)

    for case, (_, m, _, _, _) in STEP_CASES.items():
        jcfg, tc, state = start(case)
        mesh, metrics = meshes[m], []
        with set_mesh(mesh):
            fn, state_sh, batch_sh = jtr.shard_train_step(
                mesh, jcfg, tc, jax.eval_shape(lambda: state))
            state = jax.device_put(state, state_sh)
            for s in range(STEPS):
                b = {k: jax.device_put(v, batch_sh(v)) for k, v in batch(case, s).items()}
                state, mt = fn(state, b)
                metrics.append(mt)
        record(case, state, metrics)
        if case == "llama":
            Checkpointer(ckpt_dir).save(STEPS, state)

    jcfg, tc, state = start("llama")
    state["error"] = init_error_state(state["params"])
    mesh, metrics = meshes["2x1x2"], []
    with set_mesh(mesh):
        step = jax.jit(make_compressed_train_step(mesh, jcfg, tc, CompressConfig(**COMPRESS)))
        for s in range(STEPS):
            state, mt = step(state, batch("llama", s))
            metrics.append(mt)
    record("compress", state, metrics)
    np.savez(out_path, **out)


# -- the runs -------------------------------------------------------------------


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_sharded")
    inp, ref, ckpt = tmp / "inputs.npz", tmp / "ref.npz", tmp / "ckpt_ref"
    np.savez(inp, **_inputs())
    jax_run = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "jax", str(inp), str(ref), str(ckpt)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu"))
    procs = [subprocess.Popen(
        [sys.executable, str(RANKS_SCRIPT), str(r), str(tmp / "store"), str(inp), str(ckpt),
         str(tmp / f"port{r}.npz")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_env(OMP_NUM_THREADS="1")) for r in range(RANKS)]
    _, jerr = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, jerr[-4000:]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=600)
        errs.append((p.returncode, err[-4000:]))
    assert all(rc == 0 for rc, _ in errs), errs
    ports = [dict(np.load(tmp / f"port{r}.npz")) for r in range(RANKS)]
    return dict(np.load(ref)), ports


def _close(got, want, rel=1e-4, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = rel * max(1.0, float(np.abs(want).max())) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol, f"{what}: {err} > {tol}"


# -- (i) spec trees and shard shapes ------------------------------------------------

_SHAPES = {}


def _shapes(arch):
    """(the reference's param and cache shapes, the port's) at full size."""
    if arch not in _SHAPES:
        import jax

        from repro import configs as jconfigs
        from repro.models import decoder as jdec
        from repro_torch import configs
        from repro_torch.models import abstract_cache, abstract_params

        jcfg, cfg = jconfigs.get(arch), configs.get(arch)
        _SHAPES[arch] = (
            jax.eval_shape(lambda: jdec.init_params(jax.random.PRNGKey(0), jcfg)),
            jax.eval_shape(lambda: jdec.init_cache(jcfg, CACHE_BATCH, CACHE_LEN)),
            abstract_params(cfg), abstract_cache(cfg, CACHE_BATCH, CACHE_LEN), jcfg, cfg)
    return _SHAPES[arch]


@pytest.mark.parametrize("mesh", list(SPEC_MESHES))
@pytest.mark.parametrize("kind", ["params", "cache"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_the_reference(arch, kind, mesh):
    """Leaf for leaf, on abstract meshes of the production and the test
    shapes (no devices, no process group)."""
    from jax.sharding import AbstractMesh, PartitionSpec as P

    from repro.models import sharding as jsh
    from repro_torch.models import sharding as tsh

    jp, jc, tp, tcache, jcfg, cfg = _shapes(arch)
    shape, axes = SPEC_MESHES[mesh]
    if kind == "params":
        want = jsh.param_spec_tree(jcfg, jp, AbstractMesh(shape, axes))
        got = tsh.param_spec_tree(cfg, tp, tsh.MeshShape(shape, axes))
    else:
        want = jsh.cache_spec_tree(jcfg, jc, AbstractMesh(shape, axes))
        got = tsh.cache_spec_tree(cfg, tcache, tsh.MeshShape(shape, axes))
    want = {k: tuple(v) for k, v in
            _named_leaves(want, lambda x: isinstance(x, P)).items()}
    got = flat(got)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_every_arch_has_its_specs_pinned():
    assert len(ARCHS) == 10 and set(SPEC_MESHES) == {"16x16", "2x16x16", "2x2", "1x4", "2x1x2"}


@pytest.mark.parametrize("arch", ARCHS)
def test_local_shard_shapes_match_named_sharding(runs, arch):
    """Every rank's DTensor shard of every full-size leaf, on (2, 2), (1, 4)
    and (2, 1, 2), has ``NamedSharding.shard_shape`` over four host
    devices (fitted specs shard evenly)."""
    ref, ports = runs
    keys = [k for k in ref if k.startswith(f"shape/{arch}/")]
    assert len(keys) > 10
    for port in ports:
        for k in keys:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


def test_placements_split_tuple_entries_pod_major():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.sharding import data_spec, placements

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 1, 2)

    spec = data_spec(Mesh(), (4, 16))
    assert spec == (("pod", "data"), None)
    assert placements(Mesh(), spec) == (Shard(0), Shard(0), Replicate())
    assert placements(Mesh(), (None, "model")) == (Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="mesh's order"):
        placements(Mesh(), (("data", "pod"),))


# -- (ii) three sharded steps against the reference -------------------------------


def test_every_rank_reports_the_same_metrics(runs):
    _, ports = runs
    keys = [k for k in ports[0] if re.search(r"/m\d+/", k) and not k.startswith("one/")]
    assert keys
    for other in ports[1:]:
        for k in keys:
            np.testing.assert_array_equal(other[k], ports[0][k], err_msg=k)


@pytest.mark.parametrize("case", [c for c in STEP_CASES if c != "uneven"])
def test_sharded_steps_match_the_reference(runs, case):
    """Three steps of ``shard_train_step``: the loss, aux, gradient norm and
    learning rate each step, and every state leaf, at 1e-4 of max|want|."""
    ref, ports = runs
    port = ports[0]
    for s in range(STEPS):
        for k in ("loss", "aux", "grad_norm", "lr"):
            _close(port[f"{case}/m{s}/{k}"], ref[f"{case}/m{s}/{k}"], what=f"step {s} {k}")
    names = [k for k in ref if k.startswith(f"{case}/state/")]
    assert len(names) > 10 and sorted(names) == sorted(
        k for k in port if k.startswith(f"{case}/state/"))
    for k in names:
        _close(port[k], ref[k], what=k)
    assert int(port[f"{case}/state/step"]) == STEPS


@pytest.mark.parametrize("case", ["llama", "olmoe", "rgemma", "mamba"])
def test_no_leaf_loses_an_axis_its_rule_names(case):
    """The parity cases shard every dimension their rules name: on (2, 2)
    their fitted specs are those of a mesh that every dimension divides."""
    from repro_torch.models import abstract_params
    from repro_torch.models.sharding import MeshShape, param_spec_tree

    cfg = config(case)
    shapes = abstract_params(cfg)
    on = param_spec_tree(cfg, shapes, MeshShape((2, 2), ("data", "model")))
    ones = param_spec_tree(cfg, shapes, MeshShape((1, 1), ("data", "model")))
    assert flat(on) == flat(ones)
    assert any("model" in str(s) for s in flat(on).values())


def test_an_indivisible_vocab_falls_back_to_replication(runs):
    """The smoke vocab of 161 does not divide 2: the embedding keeps its
    data axis and replicates its vocab, and the steps still match."""
    from repro_torch.models import abstract_params
    from repro_torch.models.sharding import MeshShape, param_spec_tree

    cfg = config("llama161")
    assert cfg.vocab_size == 161
    specs = flat(param_spec_tree(cfg, abstract_params(cfg),
                                 MeshShape((2, 2), ("data", "model"))))
    assert specs["embed/tok"] == (None, None, "data")
    ref, ports = runs
    _close(ports[0]["llama161/m2/loss"], ref["llama161/m2/loss"])


# -- (iii) one rank against the unsharded step ------------------------------------


@pytest.mark.parametrize("case", ONE_RANK_CASES)
def test_one_rank_mesh_equals_the_unsharded_step_bit_for_bit(runs, case):
    _, ports = runs
    port = ports[0]
    names = [k for k in port if k.startswith(f"one/{case}/plain/")]
    assert names
    for k in names:
        got = port[k.replace("/plain/", "/state/")]
        np.testing.assert_array_equal(got, port[k], err_msg=k)


# -- (iv) uneven heads -------------------------------------------------------------


def test_uneven_heads_match_the_reference(runs):
    """6 query heads and 2 KV heads over model = 4: heads 2, 2, 2, 0 a
    rank (rank 1's heads 2 and 3 read KV heads 0 and 1; rank 3 launches
    nothing), against GSPMD's padded split."""
    cfg = config("uneven")
    assert (cfg.num_heads, cfg.num_kv_heads) == (6, 2)
    ref, ports = runs
    for s in range(STEPS):
        _close(ports[0][f"uneven/m{s}/loss"], ref[f"uneven/m{s}/loss"])
    for k in (k for k in ref if k.startswith("uneven/state/")):
        _close(ports[0][k], ref[k], what=k)


def test_uneven_head_blocks_are_ceiling_first():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.models import attention

    seen = []

    def fn(q, k, v):
        seen.append((q.shape[2], k.shape[2]))
        return q

    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        q = distribute_tensor(torch.randn(1, 2, 6, 4), mesh, [Shard(2)])
        k = distribute_tensor(torch.randn(1, 2, 2, 4), mesh, [Replicate()])
        out = attention._local_heads(q, k, k, fn)
        assert isinstance(out, DTensor) and seen == [(6, 2)]
        assert torch.equal(out.full_tensor(), q.full_tensor())
    finally:
        dist.destroy_process_group()
    # ceiling-first blocks of 6 over 4, as GSPMD and torch.chunk split
    chunk = -(-6 // 4)
    assert [min(chunk, max(0, 6 - chunk * r)) for r in range(4)] == [2, 2, 2, 0]


# -- (v) the compressed pod step -----------------------------------------------------


def test_compressed_step_matches_the_reference(runs):
    """(pod, data, model) = (2, 1, 2): the loss, gradient norm and density
    each step, the state and the carried error, at 1e-4 of max|want|."""
    ref, ports = runs
    port = ports[0]
    for s in range(STEPS):
        for k in ("loss", "aux", "grad_norm", "lr", "compress_density"):
            _close(port[f"compress/m{s}/{k}"], ref[f"compress/m{s}/{k}"],
                   what=f"step {s} {k}")
    names = [k for k in ref if k.startswith("compress/state/")]
    assert any("/error/" in k for k in names)
    for k in names:
        _close(port[k], ref[k], what=k)
    d = float(port["compress/m2/compress_density"])
    assert 0.0 < d <= 0.075


@pytest.mark.parametrize("case", ["seed0", "seed1", "ties", "tail", "small", "tiny"])
def test_topk_block_sparsify_matches_the_reference(case):
    """Ties past k are kept, the tail block is zero-padded, n <= block takes
    max(1, int(ratio n)) of the whole: the reference's result exactly."""
    import jax.numpy as jnp

    from repro.train.compress import topk_block_sparsify as want_fn
    from repro_torch.train import topk_block_sparsify

    rng = np.random.default_rng(int(case[-1]) if case.startswith("seed") else 7)
    ratio, block = 0.05, 256
    if case.startswith("seed"):
        x = rng.standard_normal((12, 64)).astype(np.float32)
    elif case == "ties":
        x = np.round(rng.standard_normal((4, 256)), 1).astype(np.float32)
    elif case == "tail":
        x = rng.standard_normal((3, 300)).astype(np.float32)
    elif case == "small":
        x = rng.standard_normal((100,)).astype(np.float32)
    else:
        x, ratio = rng.standard_normal((10,)).astype(np.float32), 0.01
    want = np.asarray(want_fn(jnp.asarray(x), ratio, block))
    got = topk_block_sparsify(torch.from_numpy(x), ratio, block).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "ties":
        assert (got != 0).sum() > int(ratio * block) * 4


# -- (vi) checkpoints -------------------------------------------------------------


@pytest.mark.parametrize("where", ["4x1", "none", "1x1"])
def test_a_state_saved_on_2x2_restores_bit_for_bit(runs, where):
    _, ports = runs
    assert bool(ports[0][f"ckpt/{where}"])
    if where != "1x1":
        assert all(bool(p[f"ckpt/{where}"]) for p in ports)


def test_the_reference_checkpoint_restores_on_2x2(runs):
    ref, ports = runs
    names = [k for k in ports[0] if k.startswith("ckpt/ref/")]
    assert len(names) > 10
    for k in names:
        np.testing.assert_array_equal(ports[0][k], ref[k.replace("ckpt/ref/", "llama/state/")],
                                      err_msg=k)


# -- the dry run's count against the ranks' collectives ------------------------------


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_fake_group_count_equals_what_the_gloo_ranks_issue(runs, kind):
    """One (2, 2) llama step and its prefill: the collectives each gloo rank
    issued, recorded by the dry run's mode, equal the dry run's count on a
    fake group of four, op for op, in count and in operand bytes."""
    _, ports = runs
    real = {k.removeprefix(f"coll/{kind}/"): v for k, v in ports[0].items()
            if k.startswith(f"coll/{kind}/")}
    fake = {k.removeprefix(f"fakecoll/{kind}/"): v for k, v in ports[0].items()
            if k.startswith(f"fakecoll/{kind}/")}
    assert real and sorted(real) == sorted(fake)
    for k in real:
        assert int(real[k]) == int(fake[k]), k
    assert int(real["all-gather/count"]) > 0
    for other in ports[1:]:
        for k in real:
            assert int(other[f"coll/{kind}/{k}"]) == int(real[k]), k


# -- (vii) the launcher -------------------------------------------------------------


def test_launcher_trains_on_four_ranks(runs):
    _, ports = runs
    for p in ports:
        assert int(p["launch/rc"]) == 0 and bool(p["launch/done"])


def test_launcher_needs_a_group_or_torchrun_for_more_than_one_rank(monkeypatch, tmp_path):
    import torch.distributed as dist

    from repro_torch.launch import train as launch_train

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        launch_train.main(["--arch", "llama3.2-3b", "--smoke", "--mesh", "2x2",
                           "--device", "cpu", "--ckpt-dir", str(tmp_path)])


def test_group_backend_is_a_rule_of_cards_and_ranks(monkeypatch):
    from repro_torch.launch.train import group_backend

    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert group_backend(torch.device("cuda")) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert group_backend(torch.device("cuda")) == "nccl"
    assert group_backend(torch.device("cpu")) == "gloo"


if __name__ == "__main__":
    _jax_side(*sys.argv[2:5])
