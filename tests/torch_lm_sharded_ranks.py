"""The port's side of ``tests/test_torch_lm_sharding.py``: one process a
rank of four, on the CPU over gloo.

    PYTHONPATH=src python tests/torch_lm_sharded_ranks.py RANK STORE INPUTS REF_CKPT OUT

Each rank joins the group through the ``file://`` store STORE, reads the
shared inputs (parameters and batches drawn by numpy), and runs the port's
sharded train step: local shard shapes of every arch's full-size
parameters, three steps of each case of ``STEP_CASES`` on its mesh, the
compressed pod step, a checkpoint saved on (2, 2) and restored elsewhere,
the JAX package's checkpoint restored on (2, 2) (REF_CKPT, written by the
test's JAX subprocess while the ranks run), and ``launch/train.py --mesh
2x2``, and records the collectives that one more (2, 2) step of the
llama case and its prefill issue (``launch.cost.CostMode``, the dry run's
mode).  Rank 0 then runs the (1, 1) cases in a group of its own, and
counts the same step and prefill on a fake group of four (the dry run's
count).  Writes its results to OUT.  It imports nothing of JAX.
"""

import contextlib
import dataclasses
import io
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4
B, S, STEPS = 4, 16, 3
ARCHS = ("llama3.2-3b", "olmoe-1b-7b", "mamba2-780m", "recurrentgemma-2b",
         "musicgen-large", "qwen3-4b", "starcoder2-3b", "qwen2-7b",
         "llama4-maverick-400b-a17b", "internvl2-76b")
#: the small meshes, their shapes and axis names
MESHES = {"2x2": ((2, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model")),
          "4x1": ((4, 1), ("data", "model"))}
#: the full-size shard shapes are checked on these meshes
SHAPE_MESHES = ("2x2", "1x4", "2x1x2")
CACHE_BATCH, CACHE_LEN = 32, 64
#: case -> (arch, mesh, optimizer, microbatches, config overrides): smoke
#: variants whose sharded dimensions divide 2 ("llama161" keeps the smoke
#: vocab of 161, which does not, and "uneven" has 6 query heads over 4)
STEP_CASES = {
    "llama": ("llama3.2-3b", "2x2", "adamw", 1, {"vocab_size": 160}),
    "olmoe": ("olmoe-1b-7b", "2x2", "adafactor", 2, {}),
    "rgemma": ("recurrentgemma-2b", "2x2", "adamw", 1, {"vocab_size": 212}),
    "mamba": ("mamba2-780m", "2x2", "adamw", 1, {"vocab_size": 212, "num_layers": 2}),
    "llama161": ("llama3.2-3b", "2x2", "adamw", 1, {}),
    "uneven": ("llama3.2-3b", "1x4", "adamw", 1, {"vocab_size": 160}),
}
#: (1, 1) at one rank against the unsharded step
ONE_RANK_CASES = ("llama", "olmoe")
#: the compressed pod step: the llama case on (pod, data, model) = (2, 1, 2)
COMPRESS = {"ratio": 0.05, "block": 256}


def train_kw(opt: str, mu: int) -> dict:
    return dict(optimizer=opt, warmup_steps=1, total_steps=6, num_microbatches=mu)


def config(case: str):
    from repro_torch import configs

    arch, _, _, _, over = STEP_CASES[case]
    return dataclasses.replace(configs.smoke(arch), **over)


def flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def unflat(arrays: dict, prefix: str) -> dict:
    """The nested tree of the arrays whose names start ``prefix/``."""
    tree: dict = {}
    for name, v in arrays.items():
        if not name.startswith(prefix + "/"):
            continue
        keys = name[len(prefix) + 1:].split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def inputs() -> dict:
    """Parameters (the reference's init scales: weights at fan-in scale,
    embeddings at unit scale, norm scales near 1) and three batches of each
    case, from numpy draws."""
    from repro_torch.models import abstract_params

    out = {}
    for i, case in enumerate(STEP_CASES):
        cfg = config(case)
        rng = np.random.default_rng(i)
        for name, t in flat(abstract_params(cfg)).items():
            shape = tuple(t.shape)
            if "tok" in name:
                a = rng.standard_normal(shape)
            elif "scale" in name or "_norm" in name:
                a = 1.0 + 0.2 * rng.standard_normal(shape)
            else:
                a = rng.standard_normal(shape) / np.sqrt(shape[-2] if len(shape) >= 2 else 1)
            out[f"{case}/params/{name}"] = a.astype(np.float32)
        for s in range(STEPS):
            toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            labels[0, :2] = -1                       # masked positions
            out[f"{case}/batch{s}/tokens"] = toks
            out[f"{case}/batch{s}/labels"] = labels
    return out


def _state(case: str, arrays: dict, tc):
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.train.trainer import _optimizer

    params = model_params_from_numpy(unflat(arrays, f"{case}/params"), config(case),
                                     device="cpu")
    return {"params": params, "opt": _optimizer(tc).init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _batches(case: str, arrays: dict) -> list:
    return [{k: torch.from_numpy(v) for k, v in unflat(arrays, f"{case}/batch{s}").items()}
            for s in range(STEPS)]


def _whole(tree: dict) -> dict:
    """{name: the full tensor} of a state of DTensors (every rank calls)."""
    from torch.distributed.tensor import DTensor

    return {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach().clone()
            for k, v in flat(tree).items()}


def _shard_shapes(meshes: dict, out: dict) -> None:
    """Each rank's local shape of every leaf of every arch's full-size
    parameters and cache on the three small meshes."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch import configs
    from repro_torch.models import abstract_cache, abstract_params
    from repro_torch.models.sharding import cache_spec_tree, param_spec_tree, placements

    for arch in ARCHS:
        cfg = configs.get(arch)
        trees = {"params": (abstract_params(cfg), param_spec_tree),
                 "cache": (abstract_cache(cfg, CACHE_BATCH, CACHE_LEN), cache_spec_tree)}
        for kind, (shapes, rule) in trees.items():
            for m in SHAPE_MESHES:
                mesh = meshes[m]
                specs = flat(rule(cfg, shapes, mesh))
                for name, t in flat(shapes).items():
                    local, _ = compute_local_shape_and_global_offset(
                        tuple(t.shape), mesh, placements(mesh, specs[name]))
                    out[f"shape/{arch}/{kind}/{m}/{name}"] = np.asarray(local, np.int64)


def _steps(case: str, mesh, arrays: dict, out: dict, rank: int, tag: str = ""):
    from repro_torch.models.sharding import distribute
    from repro_torch.train import TrainConfig, shard_train_step

    _, _, opt, mu, _ = STEP_CASES[case]
    tc = TrainConfig(**train_kw(opt, mu))
    state = _state(case, arrays, tc)
    step, shardings, _ = shard_train_step(mesh, config(case), tc, state)
    state = distribute(state, shardings)
    tag = tag or case
    t0 = time.perf_counter()
    for s, b in enumerate(_batches(case, arrays)):
        state, m = step(state, b)
        for k, v in m.items():
            out[f"{tag}/m{s}/{k}"] = np.asarray(float(v), np.float32)
    out[f"{tag}/seconds"] = np.asarray(time.perf_counter() - t0)
    whole = _whole(state)
    if rank == 0:
        out.update({f"{tag}/state/{k}": v.numpy() for k, v in whole.items()})
    return state, shardings


def _compressed(mesh, arrays: dict, out: dict, rank: int) -> None:
    from repro_torch.models.sharding import distribute
    from repro_torch.train import (
        CompressConfig,
        TrainConfig,
        compressed_state_shardings,
        init_error_state,
        make_compressed_train_step,
    )

    tc = TrainConfig(**train_kw("adamw", 1))
    cfg = config("llama")
    state = _state("llama", arrays, tc)
    state["error"] = init_error_state(state["params"])
    step = make_compressed_train_step(mesh, cfg, tc, CompressConfig(**COMPRESS))
    state = distribute(state, compressed_state_shardings(mesh, cfg, tc, state))
    for s, b in enumerate(_batches("llama", arrays)):
        state, m = step(state, b)
        for k, v in m.items():
            out[f"compress/m{s}/{k}"] = np.asarray(float(v), np.float32)
    whole = _whole(state)
    if rank == 0:
        out.update({f"compress/state/{k}": v.numpy() for k, v in whole.items()})


def _bits_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _checkpoints(state, shardings, meshes, ckpt_dir: str, ref_ckpt: str,
                 out: dict) -> dict:
    """Save the (2, 2) state, restore it on (4, 1) and with no mesh; restore
    the JAX package's checkpoint on (2, 2).  Returns the saved whole."""
    from repro_torch.models.sharding import named
    from repro_torch.train import Checkpointer, TrainConfig, state_spec_tree
    from repro_torch.train.trainer import abstract_train_state

    cfg, tc = config("llama"), TrainConfig(**train_kw("adamw", 1))
    saved = _whole(state)
    Checkpointer(ckpt_dir).save(STEPS, state)
    shape = abstract_train_state(cfg, tc)
    other = named(meshes["4x1"], state_spec_tree(cfg, tc, shape, meshes["4x1"]))
    got, step = Checkpointer(ckpt_dir).restore(shape, device="cpu", shardings=other)
    out["ckpt/4x1"] = np.asarray(_bits_equal(_whole(got), saved) and step == STEPS)
    plain, _ = Checkpointer(ckpt_dir).restore(shape, device="cpu")
    out["ckpt/none"] = np.asarray(_bits_equal(flat(plain), saved))
    # the JAX package's checkpoint of the same case, once it has committed
    deadline = time.monotonic() + 400
    while Checkpointer(ref_ckpt).latest_step() is None:
        if time.monotonic() > deadline:
            raise TimeoutError(f"no reference checkpoint in {ref_ckpt}")
        time.sleep(0.5)
    ref, _ = Checkpointer(ref_ckpt).restore(shape, device="cpu", shardings=shardings)
    for k, v in _whole(ref).items():
        out[f"ckpt/ref/{k}"] = v.numpy()
    return saved


def _launch(out: dict) -> None:
    from repro_torch.launch import train as launch_train

    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(buf):
        rc = launch_train.main(["--arch", "llama3.2-3b", "--smoke", "--mesh", "2x2",
                                "--steps", "2", "--batch", "4", "--seq", "16",
                                "--device", "cpu", "--ckpt-dir", tmp, "--ckpt-every", "0",
                                "--selection", "none"])
    out["launch/rc"] = np.asarray(rc)
    out["launch/done"] = np.asarray("done: 2 steps" in buf.getvalue())


def _record(out: dict, tag: str, records) -> None:
    from repro_torch.launch.cost import collective_bytes

    stats = collective_bytes(records)
    for op, n in stats.count_by_op.items():
        out[f"{tag}/{op}/count"] = np.asarray(n)
        out[f"{tag}/{op}/bytes"] = np.asarray(stats.bytes_by_op[op])


def _count_config():
    """The llama case at head_dim 32: the dry run's count takes the card's
    route, whose flash kernels start at 32 (the collectives do not depend
    on the route)."""
    return dataclasses.replace(config("llama"), head_dim=32)


def _collectives(mesh, arrays: dict, out: dict) -> None:
    """The collectives one (2, 2) step of the llama case (at head_dim 32,
    parameters from a seeded generator) and a prefill of its first batch's
    tokens issue on this rank, recorded as the dry run records them."""
    from repro_torch.launch.cost import CostMode
    from repro_torch.models import init_params, prefill
    from repro_torch.models.sharding import (
        data_spec,
        distribute,
        named,
        param_spec_tree,
        use_mesh,
    )
    from repro_torch.train import TrainConfig, shard_train_step
    from repro_torch.train.trainer import _optimizer

    cfg, tc = _count_config(), TrainConfig(**train_kw("adamw", 1))
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    state = {"params": params, "opt": _optimizer(tc).init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step, shardings, _ = shard_train_step(mesh, cfg, tc, state)
    state = distribute(state, shardings)
    batch = _batches("llama", arrays)[0]
    mode = CostMode()
    with mode:
        step(state, batch)
    _record(out, "coll/train", mode.collectives)
    params = distribute(state["params"], named(mesh, param_spec_tree(cfg, state["params"],
                                                                   mesh)))
    toks = distribute(batch["tokens"], named(mesh, data_spec(mesh, (B, S))))
    mode = CostMode()
    with mode, torch.no_grad(), use_mesh(mesh):
        prefill(cfg, params, toks, max_len=S)
    _record(out, "coll/prefill", mode.collectives)


def _fake_counts(out: dict) -> None:
    """The dry run's count of the same step and prefill on a fake group of
    four, the same mesh and device type ("cpu", as these ranks')."""
    from repro_torch.launch import cost, steps
    from repro_torch.launch.mesh import fake_group, make_test_mesh
    from repro_torch.models import ShapeConfig
    from repro_torch.train import TrainConfig

    with fake_group(RANKS):
        mesh = make_test_mesh(*MESHES["2x2"], "cpu")
        for kind in ("train", "prefill"):
            cell = steps.build_cell("llama3.2-3b", ShapeConfig(kind, S, B, kind),
                                    _count_config(), mesh,
                                    tc=TrainConfig(**train_kw("adamw", 1)))
            mode = cost.CostMode(cell.mode)
            cost.count(cell, mode=mode)
            _record(out, f"fakecoll/{kind}", mode.collectives)


def _one_rank(arrays: dict, ckpt_dir: str, saved: dict, out: dict) -> None:
    """(1, 1) at one rank against the unsharded step, and the (2, 2)
    checkpoint restored on (1, 1)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.models.sharding import named
    from repro_torch.train import Checkpointer, TrainConfig, make_train_step, state_spec_tree
    from repro_torch.train.trainer import abstract_train_state

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    mesh = single_device_mesh("cpu")
    for case in ONE_RANK_CASES:
        _steps(case, mesh, arrays, out, 0, tag=f"one/{case}")
        _, _, opt, mu, _ = STEP_CASES[case]
        tc = TrainConfig(**train_kw(opt, mu))
        state, step = _state(case, arrays, tc), make_train_step(config(case), tc)
        for b in _batches(case, arrays):
            state, _ = step(state, b)
        for k, v in flat(state).items():
            out[f"one/{case}/plain/{k}"] = v.numpy()
    cfg, tc = config("llama"), TrainConfig(**train_kw("adamw", 1))
    shape = abstract_train_state(cfg, tc)
    got, _ = Checkpointer(ckpt_dir).restore(
        shape, device="cpu", shardings=named(mesh, state_spec_tree(cfg, tc, shape, mesh)))
    out["ckpt/1x1"] = np.asarray(_bits_equal(_whole(got), saved))
    dist.destroy_process_group()


def rank_side(rank: int, store: str, inp_path: str, ref_ckpt: str, out_path: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    torch.use_deterministic_algorithms(True)
    arrays = dict(np.load(inp_path))
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=RANKS)
    meshes = {m: make_test_mesh(shape, axes, "cpu") for m, (shape, axes) in MESHES.items()}
    out: dict = {}
    _shard_shapes(meshes, out)
    kept = None
    for case, (_, m, _, _, _) in STEP_CASES.items():
        res = _steps(case, meshes[m], arrays, out, rank)
        if case == "llama":
            kept = res
    _compressed(meshes["2x1x2"], arrays, out, rank)
    ckpt_dir = str(Path(out_path).parent / "ckpt_port")
    saved = _checkpoints(*kept, meshes, ckpt_dir, ref_ckpt, out)
    _launch(out)
    _collectives(meshes["2x2"], arrays, out)
    dist.destroy_process_group()
    if rank == 0:
        _one_rank(arrays, ckpt_dir, saved, out)
        _fake_counts(out)
    np.savez(out_path, **out)


if __name__ == "__main__":
    rank_side(int(sys.argv[1]), *sys.argv[2:6])
