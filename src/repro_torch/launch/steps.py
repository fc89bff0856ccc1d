"""Builders of the counted step of every dry-run cell: the counterpart of
``repro/launch/steps.py`` on one card.

One place defines, for each (arch, shape) cell:
  * the step callable (``train_step`` / ``prefill`` / ``decode_step``),
  * its abstract arguments: fake tensors on the meta device, made under the
    cell's own ``FakeTensorMode`` (nothing allocated, nothing drawn).

A meta tensor takes the card's branches of the port: every test of
``device.type == "cpu"`` is false, so attention goes through the flash
operators, whose fake versions launch nothing.  Fake CUDA tensors would say
"cuda" outright, but a CPU build of torch cannot record autograd on them
(its engine asks for a CUDA stream and aborts), and the dry run runs on the
host.  One card has no shardings.  The dry run (``launch/dryrun.py``) and
``chip_smoke.py``'s roofline phase consume these.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.train.trainer import TrainConfig, abstract_train_state, make_train_step


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
    args: tuple            # its fake arguments
    mode: FakeTensorMode   # the arguments' mode: the step runs under it
    meta: dict = dataclasses.field(default_factory=dict)


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


def build_cell(arch: str, shape: str | ShapeConfig,
               cfg: ModelConfig | None = None) -> Cell:
    """The cell's step and fake arguments.  ``shape`` is a ``SHAPES`` name or
    a ``ShapeConfig`` (a path's own shape); ``cfg`` replaces the arch's
    published config (a reduced one, in the tests)."""
    cfg = cfg or configs.get(arch)
    shp = _shape(shape)
    specs = configs.input_specs(cfg, shp)
    mode = FakeTensorMode()
    B, S = shp.global_batch, shp.seq_len

    if shp.kind == "train":
        tc = train_config_for(cfg, shp)
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
