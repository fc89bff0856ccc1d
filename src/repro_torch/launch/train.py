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

One device only: ``--mesh`` takes ``1x1``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

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
)


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
                    help="data x model; the port runs on one device: 1x1")
    ap.add_argument("--straggler-deadline", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", default="nothing", choices=list(REMAT_POLICIES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device (1x1); "
            "sharded training is still to port (ROADMAP §1 item 7)")
    dev = resolve_device(args.device)
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

    step_fn = make_train_step(cfg, tc)
    ckpt = Checkpointer(os.path.join(args.ckpt_dir, cfg.name))
    state, start, resumed = resume_or_init(
        ckpt, abstract_train_state(cfg, tc),
        lambda: make_train_state(torch.Generator(dev).manual_seed(args.seed), cfg,
                                 tc, device=dev),
        device=dev,
    )
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
