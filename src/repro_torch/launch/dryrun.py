"""Dry run of every (architecture x input shape) cell: each cell's step is
run once on fake tensors (``launch/steps.py``) and counted
(``launch/cost.py``): FLOPs by dtype, bytes, flash pairs, the peak of live
bytes and, on a mesh, the collectives the step issues; then bounded by the
card's published peaks and link rates (``launch/roofline.py``).  The
counterpart of ``repro/launch/dryrun.py``, which compiles each cell on its
256- and 512-chip meshes.  It needs no card and allocates nothing:

    PYTHONPATH=src python -m repro_torch.launch.dryrun                   # one card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single     # 16 x 16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multipod   # 2 x 16 x 16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --arch qwen2-7b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --force           # recount

``--mesh single`` and ``multipod`` count each cell on the reference's
production mesh (``make_production_mesh``: 256 or 512 ranks) over a fake
process group in this one process: the step runs as rank 0 runs it, on
DTensors whose local shards are rank 0's fake shards, and its collectives
are recorded, not run.  Results are cached a cell as JSON under
``results/dryrun_torch/<mesh>/`` (``h100``, ``single_16x16``,
``multipod_2x16x16``), so the sweep is resumable; ``python -m
repro_torch.launch.roofline --mesh ...`` prints their table.  Cells that
``cell_supported`` rules out are written as skipped with its reason; a
cell that fails is written with its error and counted, and the exit code
is then 1.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

from repro_torch import configs
from repro_torch.launch.cost import CostMode, count
from repro_torch.launch.mesh import HW, fake_group, make_production_mesh, node_of
from repro_torch.launch.roofline import MESH_DIRS, ROOT, roofline
from repro_torch.launch.steps import build_cell, model_flops
from repro_torch.models import ModelConfig, ShapeConfig

#: --mesh -> [(the mesh's name in the records, ranks, multi_pod)]
MESHES = {"single": [("single_16x16", 256, False)],
          "multipod": [("multipod_2x16x16", 512, True)]}
MESHES["both"] = MESHES["single"] + MESHES["multipod"]


def _analytic_state_bytes(cell) -> int:
    """Bytes of the step's arguments (parameters, optimizer state, cache,
    the batch) on the rank: its shards, on a mesh.  What stays on the card
    between steps."""
    total = 0
    for t in pytree.tree_leaves(cell.args):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor) and t.dim() > 0:
            total += t.numel() * t.element_size()
    return total


def _axis_of(mesh, group: str) -> str:
    """The mesh dimension whose group is ``group`` (DTensor issues each
    collective over one mesh dimension)."""
    for name in mesh.mesh_dim_names:
        if mesh.get_group(name).group_name == group:
            return name
    return "other"


def collective_split(mesh, records, hw: dict = HW) -> dict:
    """The operand bytes of ``records`` by mesh dimension, and the share
    that crosses nodes: a collective goes between nodes when its group's
    ranks sit in more than one node of ``hw["gpus_per_node"]``."""
    by_axis: dict[str, float] = {}
    inter = total = 0
    for r in records:
        axis = _axis_of(mesh, r.group)
        by_axis[axis] = by_axis.get(axis, 0) + r.bytes
        total += r.bytes
        if len({node_of(k, hw) for k in r.ranks}) > 1:
            inter += r.bytes
    return {"bytes_by_axis": by_axis, "internode_bytes": inter,
            "internode_fraction": inter / total if total else 0.0}


def run_cell(arch: str, shape: str | ShapeConfig, cfg: ModelConfig | None = None,
             mesh=None, mesh_name: str = "1x1") -> dict:
    """Build, count and bound one cell; the reference's record keys, per
    chip (``count_s`` in place of ``compile_s``).  On a ``DeviceMesh`` the
    per-chip figures are rank 0's: DTensor splits an uneven dimension
    ceiling-first, so rank 0 holds the largest block of each and its
    figures are the most loaded rank's.  The collective term takes its
    operand bytes from the collectives the step issued and its inter-node
    share from their groups (:func:`collective_split`)."""
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, cfg, mesh)
    mode = CostMode(cell.mode)
    cost = count(cell, mode=mode)
    count_s = time.perf_counter() - t0
    chips = mesh.size() if mesh is not None else 1
    coll = float(cost["collective_bytes"])
    split = collective_split(mesh, mode.collectives) if mesh is not None else \
        {"bytes_by_axis": {}, "internode_bytes": 0, "internode_fraction": 0.0}
    rl = roofline(cost["flops_by_dtype"], cost["bytes"], coll, HW,
                  pod_fraction=split["internode_fraction"])
    mflops = model_flops(arch, shape, cfg)
    flops = cost["flops"]
    return {
        "arch": arch,
        "shape": cell.shape_name,
        "mesh": mesh_name,
        "chips": int(chips),
        "status": "ok",
        "count_s": round(count_s, 2),
        "kind": cell.meta["kind"],
        "meta": cell.meta,
        "memory": {
            "analytic_state_bytes": _analytic_state_bytes(cell),
            "peak_bytes": cost["peak_bytes"],
            "fits_80gb": bool(cost["peak_bytes"] < HW["hbm_per_chip"]),
        },
        "cost": {
            "flops_per_chip": flops,
            "flops_by_dtype": cost["flops_by_dtype"],
            "bytes_per_chip": cost["bytes"],
            "collective_bytes_per_chip": coll,
            "collectives": cost["collectives"],
            "collective_counts": cost["collective_counts"],
            "collective_bytes_by_axis": split["bytes_by_axis"],
            "internode_bytes": split["internode_bytes"],
            "internode_fraction": split["internode_fraction"],
            "attention_pairs": cost["attention_pairs"],
            "top_by_bytes": cost["top_by_bytes"],
            "top_by_flops": cost["top_by_flops"],
        },
        "roofline": rl,
        "model_flops_total": mflops,
        "model_flops_per_chip": mflops / chips,
        "useful_flops_ratio": mflops / chips / flops if flops else 0.0,
    }


def _sweep(args, outdir: str, mesh, mesh_name: str) -> int:
    """Every selected cell on ``mesh`` (None: one card); returns the
    failures."""
    os.makedirs(outdir, exist_ok=True)
    failures = 0
    for arch, shape_name, ok, why in configs.all_cells():
        if args.arch and arch != args.arch:
            continue
        if args.shape and shape_name != args.shape:
            continue
        path = os.path.join(outdir, f"{arch}__{shape_name}.json")
        tag = f"[{mesh_name}] {arch:28s} {shape_name:12s}"
        if not ok:
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                   "status": "skipped", "reason": why}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"{tag} SKIP ({why[:60]})")
            continue
        if os.path.exists(path) and not args.force:
            with open(path) as f:
                if json.load(f).get("status") == "ok":
                    print(f"{tag} cached")
                    continue
        try:
            rec = run_cell(arch, shape_name, mesh=mesh, mesh_name=mesh_name)
            rl = rec["roofline"]
            print(f"{tag} OK count={rec['count_s']:6.1f}s "
                  f"peak={rec['memory']['peak_bytes'] / 1e9:8.2f}GB "
                  f"coll={rec['cost']['collective_bytes_per_chip'] / 1e9:8.3f}GB "
                  f"dominant={rl['dominant']:10s} "
                  f"bound={rl['step_time_lower_bound_s']:.3e}s", flush=True)
        except Exception as e:  # a failing cell is a fault of the port: record + count
            failures += 1
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                   "status": "error", "error": str(e)[:2000],
                   "traceback": traceback.format_exc()[-4000:]}
            print(f"{tag} FAIL {str(e)[:120]}", flush=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="1x1", choices=["1x1", "single", "multipod", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=ROOT, help="the root of the caches of each mesh")
    args = ap.parse_args(argv)

    if args.mesh == "1x1":
        return 1 if _sweep(args, os.path.join(args.out, MESH_DIRS["1x1"]), None, "1x1") \
            else 0
    failures = 0
    for mesh_name, ranks, multi_pod in MESHES[args.mesh]:
        with fake_group(ranks):
            mesh = make_production_mesh(multi_pod=multi_pod)
            failures += _sweep(args, os.path.join(args.out, mesh_name), mesh, mesh_name)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
