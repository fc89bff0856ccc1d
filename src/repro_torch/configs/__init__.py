"""Architecture registry: ``get(arch_id)`` / ``smoke(arch_id)`` /
``input_specs(cfg, shape)`` / ``all_cells()``.

Every assigned architecture is a module in this package exposing ``CONFIG``
(the exact published dims) and ``SMOKE`` (a reduced same-family variant for
CPU tests).  The modules are the port's own copies of ``repro/configs``,
with identical dims.  ``input_specs`` builds the meta tensors that stand
for a step's inputs in the dry run (``launch/dryrun.py``): shapes and
dtypes, never allocated.
"""

from __future__ import annotations

import importlib

import torch

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig, cell_supported

_MODULES = {
    "internvl2-76b": "internvl2_76b",
    "mamba2-780m": "mamba2_780m",
    "musicgen-large": "musicgen_large",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama3.2-3b": "llama3_2_3b",
    "qwen3-4b": "qwen3_4b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen2-7b": "qwen2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def input_specs(cfg: ModelConfig, shp: ShapeConfig) -> dict:
    """Meta tensors for every input of the step, the reference's
    ShapeDtypeStructs: int32 tokens, bfloat16 patches.

    train  -> {tokens, labels[, patches]}
    prefill-> {tokens[, patches]}
    decode -> {tokens}  (the cache comes from ``models.abstract_cache``)
    """
    B, S = shp.global_batch, shp.seq_len
    K = () if cfg.num_codebooks == 1 else (cfg.num_codebooks,)

    def meta(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if shp.kind == "decode":
        return {"tokens": meta((B, 1, *K))}
    if shp.kind not in ("train", "prefill"):
        raise ValueError(shp.kind)
    specs = {"tokens": meta((B, S, *K))}
    if shp.kind == "train":
        specs["labels"] = meta((B, S, *K))
    if cfg.input_mode == "tokens+patches":
        specs["patches"] = meta((B, cfg.num_patches, cfg.d_model), torch.bfloat16)
    return specs


def all_cells():
    """Every (arch, shape) pair with its supported/skip status."""
    for arch in ARCHS:
        cfg = get(arch)
        for sname, shp in SHAPES.items():
            ok, why = cell_supported(cfg, shp)
            yield arch, sname, ok, why


__all__ = ["ARCHS", "SHAPES", "get", "smoke", "shape", "input_specs", "all_cells"]
