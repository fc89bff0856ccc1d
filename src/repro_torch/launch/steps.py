"""Builders of the counted step of every dry-run cell: the counterpart of
``repro/launch/steps.py``, on one card or on a mesh.

One place defines, for each (arch, shape) cell:
  * the step callable (``train_step`` / ``prefill`` / ``decode_step``),
  * its abstract arguments: fake tensors on the meta device, made under the
    cell's own ``FakeTensorMode`` (nothing allocated, nothing drawn),
  * on a ``DeviceMesh``, their placements: the arguments are DTensors whose
    local shards are rank 0's fake shards, placed without a collective.

A meta tensor takes the card's branches of the port: every test of
``device.type == "cpu"`` is false, so attention goes through the flash
operators, whose fake versions launch nothing.  Fake CUDA tensors would say
"cuda" outright, but a CPU build of torch cannot record autograd on them
(its engine asks for a CUDA stream and aborts), and the dry run runs on the
host.  On a mesh the placements are the reference's: a train step takes
``shard_train_step``'s state and batch placements (``state_spec_tree``,
the batch over pod x data), prefill and decode take ``param_spec_tree``,
``cache_spec_tree`` and ``data_spec``'s.  Decode writes its cache in place
and the train step its state (the reference donates both).  The dry run
(``launch/dryrun.py``) and ``chip_smoke.py``'s roofline phase consume these.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.launch.mesh import HW
from repro_torch.models import (
    ModelConfig,
    ShapeConfig,
    abstract_cache,
    abstract_params,
    decode_step,
    prefill,
)
from repro_torch.models.sharding import (
    axis_sizes,
    batch_axes,
    cache_spec_tree,
    data_spec,
    param_spec_tree,
    placements,
    shard_on,
    use_mesh,
)
from repro_torch.train.trainer import (
    TrainConfig,
    abstract_train_state,
    make_train_step,
    shard_train_step,
    state_spec_tree,
)


def train_config_for(cfg: ModelConfig, shp: ShapeConfig, batch_shards: int = 1,
                     hbm_bytes: float = HW["hbm_per_chip"]) -> TrainConfig:
    """Per-cell training hyperparameters, the reference's rule with the
    memory budget as parameters: Adafactor above 10 B parameters; µ
    microbatches (a power of 2, at most B / batch_shards) until the remat
    stash, num_layers saved bf16 layer inputs a device, fits 3/32 of a
    device's HBM; two-level remat ("nested") when it is still above 5/32.
    At the reference's 16 GB v5e (``hbm_bytes=16e9``, 1.5 GB and 2.5 GB)
    and its batch shards this is the reference's ``TrainConfig``; the
    default is one 80 GB card, the whole batch on it."""
    big = cfg.param_count() > 10e9
    per_dev_tokens = shp.global_batch * shp.seq_len / batch_shards
    stash = cfg.num_layers * per_dev_tokens * cfg.d_model * 2
    mu = 1
    while mu < shp.global_batch // batch_shards and stash / mu > hbm_bytes * 3 / 32:
        mu *= 2
    remat = "nested" if stash / mu > hbm_bytes * 5 / 32 else "nothing"
    return TrainConfig(
        optimizer="adafactor" if big else "adamw",
        num_microbatches=mu,
        remat=remat,
    )


@dataclasses.dataclass
class Cell:
    arch: str
    shape_name: str
    fn: Callable           # the step
    args: tuple            # its fake arguments (DTensors on a mesh)
    mode: FakeTensorMode   # the arguments' mode (one card: the step runs under it)
    meta: dict = dataclasses.field(default_factory=dict)
    mesh: object = None    # the DeviceMesh of a sharded cell


def _shape(shape: str | ShapeConfig) -> ShapeConfig:
    return configs.shape(shape) if isinstance(shape, str) else shape


def _fake(mode: FakeTensorMode, tree):
    """The tree's meta tensors as fake tensors of ``mode``."""
    if isinstance(tree, dict):
        return {k: _fake(mode, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_fake(mode, v) for v in tree)
    with mode:
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _placed(mode: FakeTensorMode, mesh, tree, specs):
    """The tree's meta tensors as DTensors with ``specs``' placements on
    ``mesh``, each local shard a fake tensor of ``mode`` of rank 0's shape
    (``distribute``'s result, with no global tensor and no collective)."""
    if isinstance(tree, dict):
        return {k: _placed(mode, mesh, v, specs[k]) for k, v in tree.items()}

    def shard(local):
        with mode:
            return torch.empty(local, dtype=tree.dtype, device="meta")

    return shard_on(shard, mesh, placements(mesh, specs), tree.shape)


def _sharded_cell(arch: str, cfg: ModelConfig, shp: ShapeConfig, mesh,
                  tc: TrainConfig | None) -> Cell:
    """The cell on ``mesh``: the reference's ``build_cell`` shardings."""
    specs = configs.input_specs(cfg, shp)
    # the step runs outside the mode: what it makes from nothing (positions,
    # masks, the cache's shards) is plain meta, which the fake shards take
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    B, S = shp.global_batch, shp.seq_len
    sizes = axis_sizes(mesh)
    shards = math.prod(sizes[a] for a in batch_axes(mesh))
    batch = {k: _placed(mode, mesh, v, data_spec(mesh, tuple(v.shape)))
             for k, v in specs.items()}
    if shp.kind == "train":
        tc = tc or train_config_for(cfg, shp, batch_shards=shards,
                                    hbm_bytes=HW["hbm_per_chip"])
        state = abstract_train_state(cfg, tc)
        step, _, _ = shard_train_step(mesh, cfg, tc, state)
        args = (_placed(mode, mesh, state, state_spec_tree(cfg, tc, state, mesh)), batch)
        return Cell(arch, shp.name, step, args, mode,
                    {"kind": "train", "microbatches": tc.num_microbatches,
                     "optimizer": tc.optimizer, "remat": tc.remat, "tokens": B * S,
                     "batch_shards": shards, "donates": "state"}, mesh)

    shapes = abstract_params(cfg)
    params = _placed(mode, mesh, shapes, param_spec_tree(cfg, shapes, mesh))
    if shp.kind == "prefill":
        def fn(p, toks, patches=None):
            with use_mesh(mesh):
                return prefill(cfg, p, toks, patches, max_len=S)

        args = (params, batch["tokens"]) + ((batch["patches"],) if "patches" in batch
                                            else ())
        return Cell(arch, shp.name, fn, args, mode, {"kind": "prefill", "tokens": B * S},
                    mesh)

    def fn(p, toks, cache):
        with use_mesh(mesh):
            return decode_step(cfg, p, toks, cache, S - 1)

    cache = abstract_cache(cfg, B, S)
    args = (params, batch["tokens"],
            _placed(mode, mesh, cache, cache_spec_tree(cfg, cache, mesh)))
    return Cell(arch, shp.name, fn, args, mode,
                {"kind": "decode", "tokens": B, "donates": "cache"}, mesh)


def build_cell(arch: str, shape: str | ShapeConfig,
               cfg: ModelConfig | None = None, mesh=None,
               tc: TrainConfig | None = None) -> Cell:
    """The cell's step and fake arguments.  ``shape`` is a ``SHAPES`` name or
    a ``ShapeConfig`` (a path's own shape); ``cfg`` replaces the arch's
    published config (a reduced one, in the tests); ``mesh``, a
    ``DeviceMesh`` over an open group (``launch/mesh.py``), shards the
    cell as the reference's does; ``tc`` replaces a train cell's
    ``train_config_for`` (a run's own)."""
    cfg = cfg or configs.get(arch)
    shp = _shape(shape)
    if mesh is not None:
        return _sharded_cell(arch, cfg, shp, mesh, tc)
    specs = configs.input_specs(cfg, shp)
    mode = FakeTensorMode()
    B, S = shp.global_batch, shp.seq_len

    if shp.kind == "train":
        tc = tc or train_config_for(cfg, shp)
        args = (abstract_train_state(cfg, tc), specs)
        return Cell(arch, shp.name, make_train_step(cfg, tc), _fake(mode, args), mode,
                    {"kind": "train", "microbatches": tc.num_microbatches,
                     "optimizer": tc.optimizer, "remat": tc.remat, "tokens": B * S})

    params = abstract_params(cfg)
    if shp.kind == "prefill":
        def fn(p, toks, patches=None):
            return prefill(cfg, p, toks, patches, max_len=S)

        args = (params, specs["tokens"]) + ((specs["patches"],) if "patches" in specs
                                            else ())
        return Cell(arch, shp.name, fn, _fake(mode, args), mode,
                    {"kind": "prefill", "tokens": B * S})

    # decode: one new token against a seq_len-deep cache, written to its
    # last slot
    def fn(p, toks, cache):
        return decode_step(cfg, p, toks, cache, S - 1)

    args = (params, specs["tokens"], abstract_cache(cfg, B, S))
    return Cell(arch, shp.name, fn, _fake(mode, args), mode,
                {"kind": "decode", "tokens": B})


def model_flops(arch: str, shape: str | ShapeConfig,
                cfg: ModelConfig | None = None) -> float:
    """6·N_active·tokens (train) / 2·N_active·tokens (inference): the
    "useful" FLOPs yardstick of the roofline and of ``mfu``."""
    cfg = cfg or configs.get(arch)
    shp = _shape(shape)
    n_active = cfg.active_param_count()
    if shp.kind == "train":
        return 6.0 * n_active * shp.global_batch * shp.seq_len
    if shp.kind == "prefill":
        return 2.0 * n_active * shp.global_batch * shp.seq_len
    return 2.0 * n_active * shp.global_batch  # decode: one token per row
