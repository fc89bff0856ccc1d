"""Serving with SS KV-cache pruning on the card: prefill a prompt, prune the
KV cache to a budget with submodular selection of representative positions,
keep decoding, and compare fidelity against random pruning.  The
counterpart of ``examples/serve_kv_pruning.py``.

The selection runs through the summarization service's batched core
(``repro_torch.serve.summarize_batch``): ``Engine.prune_kv`` prunes the
decode batch as one lane, and the explicit round trip through the service
(``repro_torch.api.serve``), one request per decode row under the same
per-row seeds, must keep the same positions.  The backend follows the
device: on the card both run the ``ss_divergence`` and ``feature_gains``
kernels, and the prefill's attention the flash kernel.

``--config smoke`` is qwen2-7b's reduced config (on the card at head_dim 32,
the flash kernels' narrowest: float32 through the FFMA kernel); ``--config
full`` is qwen2-7b at its published widths and depth (28 layers, GQA 28:4
at head_dim 128, QKV bias), float32 parameters from a seed and bfloat16
compute (the tensor-core flash kernel).

    PYTHONPATH=src python examples/serve_kv_pruning_torch.py --device cpu
    PYTHONPATH=src python examples/serve_kv_pruning_torch.py \\
        --config full --prompt-len 2048 --budget 512
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import api, configs
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, init_params
from repro_torch.serve import Engine, KVSelectConfig, ServeConfig, SummarizeRequest
from repro_torch.serve.kv_select import compact_cache, pooled_keys, row_generators

ARCH = "qwen2-7b"
BATCH = 2
SEED = 0        # the parameters', the prompts' and the row generators' seed


def example_config(config: str, device) -> ModelConfig:
    """qwen2-7b's ``full`` or ``smoke`` config; the smoke config's head_dim
    16 has no flash kernel, so on the card it runs at head_dim 32."""
    if config == "full":
        return configs.get(ARCH)
    cfg = configs.smoke(ARCH)
    if resolve_device(device).type == "cuda":
        cfg = dataclasses.replace(cfg, head_dim=32)
    return cfg


def random_kept(S: int, budget: int, B: int, device) -> torch.Tensor:
    """The random baseline's kept positions: ``budget`` of ``S`` drawn by
    ``np.random.default_rng(0)``, sorted, the same for every row (B,
    budget)."""
    rng = np.random.default_rng(0)
    kept = torch.from_numpy(np.sort(rng.choice(S, budget, replace=False)))
    return kept.to(device)[None].repeat(B, 1)


def serve_and_prune(cfg, params, tokens: torch.Tensor, budget: int, *,
                    noise: torch.Tensor | None = None, device="cuda") -> dict:
    """Prefill ``tokens`` (B, S), decode one step from the full cache, prune
    the cache to ``budget`` positions with ``Engine.prune_kv`` (row b's SS
    draws from ``row_generators(SEED, B)``, or ``noise`` (B, max_rounds, S)
    in their place) and by the random baseline, and decode the same step
    from each pruned cache at the true position S.

    The same selection through the service, one request per row under the
    row generators, must keep the positions ``prune_kv`` keeps under them
    (asserted; with ``noise``, against a second ``prune_kv`` under the
    generators)."""
    dev = resolve_device(device)
    B, S = tokens.shape
    kv = KVSelectConfig(budget=budget)
    engine = Engine(cfg, params, ServeConfig(max_len=S + 16), device=dev)
    logits, cache = engine.prefill(tokens)
    nxt = torch.argmax(logits, -1)
    # decode writes position S of ``cache`` in place; pruning reads only
    # positions below S
    ref, _ = engine.decode_with_cache(nxt, cache, S)

    pruned, clen, kept = engine.prune_kv(cache, S, SEED, kv, noise=noise)
    out_ss, _ = engine.decode_with_cache(nxt, pruned, clen, pos=S)

    # the same selection as an explicit service round trip: one request per
    # decode row, the same row generators; the service micro-batches them
    # into one lane and must pick the same positions
    svc = api.serve(api.RunConfig(max_batch=8), device=dev)
    feats = pooled_keys(cache, S)
    responses = svc.run([
        SummarizeRequest(k=budget, seed=g, features=feats[b])
        for b, g in enumerate(row_generators(SEED, B, dev))])
    kept_svc = torch.stack([torch.sort(r.selected).values for r in responses])
    kept_gen = kept if noise is None else engine.prune_kv(cache, S, SEED, kv)[2]
    assert torch.equal(kept_svc, kept_gen), "service/prune_cache must agree"

    kept_r = random_kept(S, budget, B, dev)
    out_r, _ = engine.decode_with_cache(nxt, compact_cache(cache, kept_r), budget,
                                        pos=S)

    top = torch.argmax(ref, -1)
    return {"cache": cache, "ref": ref,
            "kept": kept, "kept_service": kept_svc, "out_ss": out_ss,
            "kept_random": kept_r, "out_random": out_r,
            "service_stats": svc.stats(), "responses": responses,
            "mse_ss": float(torch.mean((out_ss - ref) ** 2)),
            "mse_random": float(torch.mean((out_r - ref) ** 2)),
            "agree_ss": float(torch.mean((torch.argmax(out_ss, -1) == top).float())),
            "agree_random": float(torch.mean((torch.argmax(out_r, -1) == top).float()))}


def main(argv=None, results: dict | None = None) -> int:
    """The example's command line; ``results``, where given, receives
    :func:`serve_and_prune`'s dictionary and the config, parameters and
    tokens."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--config", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--budget", type=int, default=16)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = example_config(args.config, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(gen, cfg, device=dev)
    B, S, budget = BATCH, args.prompt_len, args.budget
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    print(f"{cfg.name}: {cfg.num_layers} layers, {cfg.num_heads} heads / "
          f"{cfg.num_kv_heads} KV heads x {cfg.head_dim} ({cfg.compute_dtype} "
          f"compute) on {dev}; {B} prompts of {S} tokens")

    out = serve_and_prune(cfg, params, tokens, budget, device=dev)
    st, first = out["service_stats"], out["responses"][0]
    print(f"service round-trip: {st['queries']} queries in {st['batches']} "
          f"micro-batch(es), padding waste {st['padding_waste_frac']:.0%}, "
          f"|V'|={first.vprime_size}, eps^={first.eps_hat:.4f}")
    print(f"KV cache {S} -> {budget} positions ({100 * budget / S:.0f}% kept)")
    print(f"  SS pruning:     logit MSE {out['mse_ss']:.4f}, "
          f"next-token agreement {out['agree_ss']:.2f}")
    print(f"  random pruning: logit MSE {out['mse_random']:.4f}, "
          f"next-token agreement {out['agree_random']:.2f}")
    nv, distinct = first.vprime_size, len(set(out["kept"][0].tolist()))
    if nv < budget:
        print(f"  |V'| = {nv} is below the budget: greedy runs out of V' and "
              f"pads the kept set with position 0 ({distinct} distinct of "
              f"{budget} in row 0)")
    print("kept positions (row 0):", out["kept"][0].tolist())
    if results is not None:
        results.update(out, cfg=cfg, params=params, tokens=tokens)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
