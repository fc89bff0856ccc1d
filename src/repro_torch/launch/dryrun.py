"""Dry run of every (architecture x input shape) cell on one H100: each
cell's step is run once on fake tensors (``launch/steps.py``) and counted
(``launch/cost.py``): FLOPs by dtype, bytes, flash pairs, the peak of live
bytes; then bounded by the card's published peaks (``launch/roofline.py``).
The counterpart of ``repro/launch/dryrun.py``, which compiles each cell on
256- and 512-chip meshes.  It needs no card and allocates nothing:

    PYTHONPATH=src python -m repro_torch.launch.dryrun                  # every cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b  # one arch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --force          # recount

Results are cached a cell as JSON under ``results/dryrun_torch/h100/``, so
the sweep is resumable; ``python -m repro_torch.launch.roofline`` prints
their table.  Cells that ``cell_supported`` rules out are written as
skipped with its reason; a cell that fails is written with its error and
counted, and the exit code is then 1.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils import _pytree as pytree

from repro_torch import configs
from repro_torch.launch.cost import count
from repro_torch.launch.mesh import HW
from repro_torch.launch.roofline import RESULTS, roofline
from repro_torch.launch.steps import build_cell, model_flops
from repro_torch.models import ModelConfig, ShapeConfig


def _analytic_state_bytes(cell) -> int:
    """Bytes of the step's arguments (parameters, optimizer state, cache,
    the batch): what stays on the card between steps."""
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(cell.args)
               if isinstance(t, torch.Tensor) and t.dim() > 0)


def run_cell(arch: str, shape: str | ShapeConfig,
             cfg: ModelConfig | None = None) -> dict:
    """Build, count and bound one cell; the reference's record keys where
    they apply (one card: ``chips`` 1, no collectives; ``count_s`` in place
    of ``compile_s``)."""
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, cfg)
    cost = count(cell)
    count_s = time.perf_counter() - t0
    rl = roofline(cost["flops_by_dtype"], cost["bytes"], 0.0, HW)
    mflops = model_flops(arch, shape, cfg)
    flops = cost["flops"]
    return {
        "arch": arch,
        "shape": cell.shape_name,
        "mesh": "1x1",
        "chips": 1,
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
            "collective_bytes_per_chip": 0.0,
            "attention_pairs": cost["attention_pairs"],
            "top_by_bytes": cost["top_by_bytes"],
            "top_by_flops": cost["top_by_flops"],
        },
        "roofline": rl,
        "model_flops_total": mflops,
        "model_flops_per_chip": mflops,
        "useful_flops_ratio": mflops / flops if flops else 0.0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape_name, ok, why in configs.all_cells():
        if args.arch and arch != args.arch:
            continue
        if args.shape and shape_name != args.shape:
            continue
        path = os.path.join(args.out, f"{arch}__{shape_name}.json")
        if not ok:
            rec = {"arch": arch, "shape": shape_name, "mesh": "1x1",
                   "status": "skipped", "reason": why}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"{arch:28s} {shape_name:12s} SKIP ({why[:60]})")
            continue
        if os.path.exists(path) and not args.force:
            with open(path) as f:
                if json.load(f).get("status") == "ok":
                    print(f"{arch:28s} {shape_name:12s} cached")
                    continue
        try:
            rec = run_cell(arch, shape_name)
            rl = rec["roofline"]
            print(f"{arch:28s} {shape_name:12s} OK count={rec['count_s']:6.1f}s "
                  f"peak={rec['memory']['peak_bytes'] / 1e9:8.2f}GB "
                  f"dominant={rl['dominant']:8s} "
                  f"bound={rl['step_time_lower_bound_s']:.3e}s", flush=True)
        except Exception as e:  # a failing cell is a fault of the port: record + count
            failures += 1
            rec = {"arch": arch, "shape": shape_name, "mesh": "1x1",
                   "status": "error", "error": str(e)[:2000],
                   "traceback": traceback.format_exc()[-4000:]}
            print(f"{arch:28s} {shape_name:12s} FAIL {str(e)[:120]}", flush=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
