"""Which of DTensor's collectives gloo takes on CUDA tensors, and whether
``repro_torch.core.distributed.stage_functional_collectives`` carries the
rest: four ranks on ``cuda:0`` over gloo on a (2, 2) mesh, then one rank
over NCCL on a (1, 1) mesh.

    python3 chip_dtensor_probe.py          # needs one card

Each functional collective runs native in four processes of its own (a
refused op may end its process: the exit code is recorded), then every
redistribution and a sharded product's gradient with staging on.  Prints
one JSON line per rank and run, and a summary of the native runs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))


def _try(fn):
    try:
        return fn()
    except Exception as e:  # the probe's purpose: record what gloo refuses
        return f"error: {type(e).__name__}: {str(e).splitlines()[0][:160]}"


def rank_main(rank: int, world: int, store: str, backend: str, only: str) -> None:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.core import distributed as dd

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world)
    shape = (2, 2) if world == 4 else (1, 1)
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
    g = mesh.get_group("model")
    x = torch.arange(8.0, device="cuda") + rank
    res = {"rank": rank, "backend": backend}
    native = {
        "all_reduce": lambda: fc.all_reduce(x, "sum", g).sum().item(),
        "all_gather_into_tensor": lambda: fc.all_gather_tensor(x, 0, g).sum().item(),
        "reduce_scatter_tensor": lambda: fc.reduce_scatter_tensor(x, "sum", 0, g).sum().item(),
        "all_to_all_single": lambda: fc.all_to_all_single(x, None, None, g).sum().item(),
        "broadcast": lambda: fc.broadcast(x, 0, g).sum().item(),
    }
    if only != "staged":
        res["native"] = {only: _try(native[only])}
        print(json.dumps(res), flush=True)
        dist.destroy_process_group()
        return
    res["staging"] = dd.stage_functional_collectives()
    torch.manual_seed(0)
    a = torch.randn(8, 6, device="cuda")
    w = torch.randn(6, 4, device="cuda")
    da = distribute_tensor(a, mesh, [Shard(0), Replicate()], src_data_rank=None)
    dw = distribute_tensor(w, mesh, [Replicate(), Shard(1)], src_data_rank=None)

    def grad():
        dw.requires_grad_(True)
        loss = (da @ dw).sum()
        loss.backward()
        gw = dw.grad.full_tensor()
        want = a.sum(0)[:, None].expand(6, 4)
        return float((gw - want).abs().max())

    p = DTensor.from_local(a, mesh, [Partial(), Replicate()])
    staged = {
        "shard_to_replicate": lambda: torch.equal(
            da.redistribute(mesh, [Replicate(), Replicate()]).to_local(), a),
        "partial_to_shard": lambda: float((p.redistribute(mesh, [Shard(0), Replicate()])
                                           .full_tensor() - a * shape[0]).abs().max()),
        "shard0_to_shard1": lambda: torch.equal(
            da.redistribute(mesh, [Shard(1), Replicate()]).full_tensor(), a),
        "matmul_grad_err": grad,
    }
    res["dtensor"] = {k: _try(f) for k, f in staged.items()}
    res["staged"] = {k: v for k, v in dd.STAGED.items() if v}
    print(json.dumps(res), flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch

    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": torch.cuda.get_device_name(0),
                      "local_map": _try(lambda: bool(__import__(
                          "torch.distributed.tensor.experimental",
                          fromlist=["local_map"]).local_map))}), flush=True)
    ops = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
           "all_to_all_single", "broadcast")
    summary, rc = {}, 0
    for world, backend, only in ([(4, "gloo", op) for op in ops]
                                 + [(4, "gloo", "staged"), (1, "nccl", "staged")]):
        with tempfile.TemporaryDirectory() as tmp:
            store = os.path.join(tmp, "store")
            procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                                       str(world), store, backend, only])
                     for r in range(world)]
            codes = [p.wait(timeout=120) for p in procs]
        summary[f"{backend} {only}"] = codes
        if only == "staged":
            rc |= max(codes)
    print(json.dumps({"exit_codes": summary}), flush=True)
    return rc


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
                  sys.argv[6])
    else:
        sys.exit(main())
