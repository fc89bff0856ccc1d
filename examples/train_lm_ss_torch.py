"""End-to-end driver on the card: train a small LM with the SS
coreset-selection data pipeline, checkpointing and restart, and compare the
loss of SS-selected batches against uniform selection on the same redundant
synthetic stream.  The counterpart of ``examples/train_lm_ss.py``.

    PYTHONPATH=src python examples/train_lm_ss_torch.py [--steps 200] [--selection ss]
    PYTHONPATH=src python examples/train_lm_ss_torch.py --device cpu --steps 20

The model is llama3.2-3b's reduced config.  Its head_dim 8 has no flash
kernel, so on the card it trains at head_dim 32, in float32: attention's
forward and backward run on the FFMA flash kernels.  Each batch of 8 is
picked from a pool of 32 candidates (pool factor 4): that pool is not above
SS's probe count (8 log2 32 = 40), so SS keeps it whole and greedy on the
pool (the ``feature_gains`` kernel on the card) picks the batch; the
example prints this, so that the result is not read as SS's.  A resumed run
replays the data stream to its step, so it ends in the uninterrupted run's
state.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile

import torch

from repro_torch import configs
from repro_torch.core.sparsify import probe_count
from repro_torch.data import DataConfig, Pipeline
from repro_torch.data.synthetic import lm_documents
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, forward, lm_loss
from repro_torch.train import (
    Checkpointer,
    TrainConfig,
    abstract_train_state,
    make_train_state,
    make_train_step,
    resume_or_init,
    run,
)


ARCH = "llama3.2-3b"


def example_config(device) -> ModelConfig:
    """llama3.2-3b's reduced config; on the card at head_dim 32, the flash
    kernels' narrowest."""
    cfg = configs.smoke(ARCH)
    if resolve_device(device).type == "cuda":
        cfg = dataclasses.replace(cfg, head_dim=32)
    return cfg


def data_config(cfg: ModelConfig, selection: str) -> DataConfig:
    return DataConfig(batch_size=8, seq_len=96, vocab_size=cfg.vocab_size,
                      selection=selection, pool_factor=4, feature_dim=256,
                      dup_frac=0.5)


def train(selection: str, steps: int, seed: int = 0, ckpt_dir: str | None = None,
          *, device="cuda",
          state: dict | None = None) -> dict:
    """``steps`` steps of AdamW (lr 1e-3, 10 warmup steps) on batches the
    pipeline selects by ``selection``, checkpointed in ``ckpt_dir`` (resumed
    from its newest checkpoint where it has one), then the loss on held-out,
    duplicate-free documents.  ``state`` is the initial train state (None:
    ``make_train_state`` from ``seed``).  Returns the last logged train
    loss, the held-out loss, the logged metrics and the final state."""
    dev = resolve_device(device)
    cfg = example_config(dev)
    tc = TrainConfig(optimizer="adamw", lr=1e-3, warmup_steps=10,
                     total_steps=steps)
    dc = data_config(cfg, selection)
    pipe = Pipeline(dc, seed=seed, device=dev)
    step = make_train_step(cfg, tc)
    ckpt = Checkpointer(ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                 f"repro_example_{selection}"), keep=2)
    state, start, resumed = resume_or_init(
        ckpt, abstract_train_state(cfg, tc),
        lambda: state if state is not None else make_train_state(
            torch.Generator(device=dev).manual_seed(seed), cfg, tc, device=dev),
        device=dev)
    if resumed:
        print(f"  resumed from step {start}")
        for _ in range(start):      # the batches the checkpointed steps took
            pipe()
    state, rep = run(state, step, pipe, ckpt, num_steps=steps,
                     start_step=start, ckpt_every=max(50, steps // 4),
                     log_every=max(1, steps // 8),
                     log_fn=lambda s: print("  " + s))

    # held-out eval: FRESH, duplicate-free documents.  (Train loss is the
    # wrong yardstick on a redundant stream: uniform batches contain
    # near-duplicates that are easy to memorize.)
    docs = torch.from_numpy(lm_documents(999_999, 32, dc.seq_len + 1,
                                         cfg.vocab_size, dup_frac=0.0)).to(dev)
    with torch.no_grad():
        logits, _ = forward(cfg, state["params"], docs[:, :-1])
        eval_loss = float(lm_loss(cfg, logits, docs[:, 1:]))
    return {"train": rep.metrics_history[-1]["loss"], "eval": eval_loss,
            "history": rep.metrics_history, "state": state,
            "steps_done": rep.steps_done, "config": cfg}


def main(argv=None, results: dict | None = None) -> int:
    """The example's command line; ``results``, where given, receives each
    selection's :func:`train` dictionary."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--selection", default="both",
                    choices=["ss", "uniform", "both"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt-root", default=tempfile.gettempdir(),
                    help="checkpoints go to <root>/repro_example_<selection>")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    out = {}
    sels = ["uniform", "ss"] if args.selection == "both" else [args.selection]
    for sel in sels:
        d = os.path.join(args.ckpt_root, f"repro_example_{sel}")
        shutil.rmtree(d, ignore_errors=True)
        print(f"[{sel}] training {args.steps} steps on {dev}...")
        if sel == "ss":
            dc = data_config(example_config(dev), sel)
            pool = dc.batch_size * dc.pool_factor
            m = probe_count(pool, dc.ss_r)
            print(f"  SS over a pool of {pool} candidates, {m} probes a round: "
                  + ("SS prunes the pool" if pool > m else
                     f"SS keeps the pool whole (|V'| = {pool} of {pool}); "
                     "greedy on the pool picks the batch"))
        out[sel] = train(sel, args.steps, ckpt_dir=d, device=dev)
    print("\nloss by selection policy (eval = held-out, duplicate-free):")
    for k, v in out.items():
        print(f"  {k:8s} train {v['train']:.4f}   eval {v['eval']:.4f}")
    if results is not None:
        results.update(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
