"""End-to-end training driver, the counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --smoke --device cpu --steps 50 --batch 8 --seq 128 --selection ss

Wires the port together: config registry -> SS-selected data pipeline (on
the device: ``ss_divergence`` and ``feature_gains`` on the card) -> train
step (attention through the flash kernels, forward and backward) ->
checkpointed, preemption-safe loop.  The card is the default device; at
full size, e.g. llama3.2-3b at 4 x 2048 tokens:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --steps 8 --batch 4 --seq 2048 --ckpt-every 0

``--mesh DxM`` runs the sharded step (``shard_train_step``) over a
(data, model) mesh of D·M ranks: in the process group already open, else
in one opened from the torchrun environment (``env://``: NCCL when every
rank has a card of its own, gloo when ranks share one), each rank running
the pipeline from the same seed and taking its shards of the same global
batch.  Four ranks on one card, say:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama3.2-3b --smoke --mesh 2x2 --steps 4

``1x1`` with no group and no torchrun environment is the one-device step.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data import DataConfig, Pipeline
from repro_torch.device import resolve_device
from repro_torch.models.decoder import REMAT_POLICIES
from repro_torch.train import (
    Checkpointer,
    StragglerGuard,
    TrainConfig,
    abstract_train_state,
    make_train_state,
    make_train_step,
    resume_or_init,
    run,
    shard_train_step,
)
from repro_torch.models.sharding import distribute

_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def group_backend(device: torch.device) -> str:
    """The backend of a group opened here, a pure rule: NCCL when every
    rank of this host has a card of its own, gloo otherwise (ranks that
    share a card, or ranks on the host)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    if device.type == "cuda" and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _open_group(ranks: int, device: torch.device) -> tuple[bool, torch.device]:
    """Use the open process group, or open one from the torchrun
    environment.  Returns (whether this opened it, this rank's device);
    raises where ``ranks`` > 1 finds neither."""
    if dist.is_initialized():
        return False, device
    if not all(k in os.environ for k in _TORCHRUN):
        # the launcher starts no ranks of its own
        raise NotImplementedError(
            f"--mesh of {ranks} ranks needs a process group: open one "
            "(torch.distributed.init_process_group) or start the ranks with "
            f"torchrun, which sets {', '.join(_TORCHRUN)}; without either the "
            "launcher trains on one device, --mesh 1x1")
    backend = group_backend(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    print(f"process group: {backend} over {os.environ['WORLD_SIZE']} ranks "
          f"(env://), {device}")
    dist.init_process_group(backend, init_method="env://")
    return True, device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default=None, choices=[None, "adamw", "adafactor"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--selection", default="ss",
                    choices=["none", "uniform", "greedy", "ss"])
    ap.add_argument("--pool-factor", type=int, default=4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--mesh", default="1x1",
                    help="data x model ranks (1x1 without a group: one device)")
    ap.add_argument("--straggler-deadline", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", default="nothing", choices=list(REMAT_POLICIES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dshape = tuple(int(x) for x in args.mesh.split("x"))
    ranks = dshape[0] * dshape[1]
    dev = resolve_device(args.device)
    sharded = ranks > 1 or dist.is_initialized() or all(k in os.environ for k in _TORCHRUN)
    opened = False
    if sharded:
        opened, dev = _open_group(ranks, dev)
        if dist.get_world_size() != ranks:
            raise ValueError(f"--mesh {args.mesh} needs {ranks} ranks; the group "
                             f"has {dist.get_world_size()}")
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    tc = TrainConfig(
        optimizer=args.optimizer
        or ("adafactor" if cfg.param_count() > 10e9 else "adamw"),
        lr=args.lr,
        warmup_steps=max(2, args.steps // 10),
        total_steps=args.steps,
        num_microbatches=args.microbatches,
        remat=args.remat,
    )
    dc = DataConfig(
        batch_size=args.batch,
        seq_len=args.seq,
        vocab_size=cfg.vocab_size,
        selection=args.selection,
        pool_factor=args.pool_factor,
        num_codebooks=cfg.num_codebooks,
        patch_count=cfg.num_patches if cfg.input_mode == "tokens+patches" else 0,
        d_model=cfg.d_model,
    )
    pipe = Pipeline(dc, seed=args.seed, device=dev)

    state_shape = abstract_train_state(cfg, tc)
    init = lambda: make_train_state(torch.Generator(dev).manual_seed(args.seed), cfg,
                                    tc, device=dev)
    ckpt = Checkpointer(os.path.join(args.ckpt_dir, cfg.name))
    if sharded:
        from repro_torch.core.distributed import stage_functional_collectives
        from repro_torch.launch.mesh import make_mesh

        if stage_functional_collectives() and dev.type == "cuda":
            print("gloo on the card: DTensor's all-gathers staged through the host")
        mesh = make_mesh(dshape, ("data", "model"), dev.type)
        step_fn, state_sh, _ = shard_train_step(mesh, cfg, tc, state_shape)
        state, start, resumed = resume_or_init(
            ckpt, state_shape, lambda: distribute(init(), state_sh),
            device=dev, shardings=state_sh)
    else:
        step_fn = make_train_step(cfg, tc)
        state, start, resumed = resume_or_init(ckpt, state_shape, init, device=dev)
    if resumed:
        print(f"resumed from step {start}")

    next_batch = pipe
    if args.straggler_deadline > 0:
        next_batch = StragglerGuard(
            pipe, lambda: None, deadline_s=args.straggler_deadline
        )
    state, report = run(
        state, step_fn, next_batch, ckpt,
        num_steps=args.steps, start_step=start,
        ckpt_every=args.ckpt_every, log_every=max(1, args.steps // 20),
    )
    print(
        f"done: {report.steps_done} steps"
        + (" (preempted)" if report.preempted else "")
        + (f", {report.straggler_skips} straggler skips"
           if report.straggler_skips else "")
    )
    if opened:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
