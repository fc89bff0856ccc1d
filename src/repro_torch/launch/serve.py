"""Serving driver: batched generation from random prompts on synthetic
weights, the counterpart of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --smoke \\
        --device cpu --batch 4 --prompt-len 64 --gen 32

On the card (the default device) the prefill's attention runs the flash
kernel.  There is no ``--kv-budget`` yet: KV-cache pruning waits for the
port of ``serve/kv_select.py``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import Engine, ServeConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    dev = resolve_device(args.device)
    gen = torch.Generator(dev).manual_seed(args.seed)
    params = init_params(gen, cfg, device=dev)
    sc = ServeConfig(max_len=args.prompt_len + args.gen + 8,
                     temperature=args.temperature)
    eng = Engine(cfg, params, sc, device=dev)

    B, S = args.batch, args.prompt_len
    shape = (B, S) if cfg.num_codebooks == 1 else (B, S, cfg.num_codebooks)
    toks = torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev)
    patches = None
    if cfg.input_mode == "tokens+patches":
        patches = torch.randn((B, cfg.num_patches, cfg.d_model), generator=gen,
                              device=dev)

    t0 = time.perf_counter()
    out, _ = eng.generate(toks, args.gen, patches,
                          generator=gen if args.temperature else None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({out.numel() / dt:.1f} tok/s on {dev.type})")
    print("first row:", out[0].reshape(-1)[:16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
