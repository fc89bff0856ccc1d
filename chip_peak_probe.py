"""The counted peak of a train step against the card's allocator.

    python3 chip_peak_probe.py

From the root of a checkout, on a machine with a CUDA card.  For
recurrentgemma-2b (2 x 4096 tokens) and llama3.2-3b (4 x 2048), AdamW,
remat "nothing", µ = 1 (the steps ``chip_smoke.py`` trains), it runs one
step after a warm-up and prints ``max_memory_allocated`` of the step run
plainly, then of the same step run under ``repro_torch.launch.cost.CostMode``
on the real tensors, with the mode's own live-bytes peak and FLOPs, beside
the count on fake tensors (``launch/cost.py`` ``count``).  It tells a
difference in the count's model of storage lifetimes from one the mode
itself makes.  Random weights and tokens from a seed; the card needs about
70 GB.
"""

import subprocess
import sys
from pathlib import Path

import torch

STEPS = (("recurrentgemma-2b", 2, 4096), ("llama3.2-3b", 4, 2048))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_peak_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from torch.utils import _pytree as pytree

    from repro_torch import configs
    from repro_torch.launch import cost
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import ShapeConfig
    from repro_torch.train import TrainConfig, make_train_state, make_train_step

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    G = 2 ** 30
    for arch, B, S in STEPS:
        cfg = configs.get(arch)
        tc = TrainConfig()
        state = make_train_state(torch.Generator("cuda").manual_seed(0), cfg, tc)
        step = make_train_step(cfg, tc)
        toks = torch.randint(0, cfg.vocab_size, (B, S + 1), device="cuda",
                             generator=torch.Generator("cuda").manual_seed(1))
        batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
        state, _ = step(state, batch)                         # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        plain = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mode = cost.CostMode()
        mode.track(t for t in pytree.tree_leaves((state, batch))
                   if isinstance(t, torch.Tensor))
        with mode:
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        under_mode = torch.cuda.max_memory_allocated()
        fake = cost.count(build_cell(arch, ShapeConfig("train", S, B, "train")))
        print(f"{arch} {B} x {S}: allocator peak {plain / G:.4f} GiB plainly, "
              f"{under_mode / G:.4f} GiB under CostMode; the mode's tracker "
              f"{mode.peak_bytes / G:.4f} GiB; the fake count {fake['peak_bytes'] / G:.4f} "
              f"GiB; FLOPs on the real tensors {mode.report()['flops']:.6g}, fake "
              f"{fake['flops']:.6g}", flush=True)
        del state, batch, toks, step, mode
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
