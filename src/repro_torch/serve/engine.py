"""Batched serving engine: prefill + decode with a static KV cache.  The
counterpart of ``repro/serve/engine.py``.

PyTorch runs eagerly, so there is nothing to compile: ``prefill`` is the
full-sequence forward that emits the first sampled token and the populated
cache (its attention is the flash kernel on the card), ``decode_step`` one
token against the cache.  Sampling is greedy (argmax, the first maximum) or
temperature / top-k from a ``torch.Generator``.  Requests are a fixed batch
of equal-length prompts.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import ModelConfig, decode_step, prefill
from repro_torch.device import resolve_device
from repro_torch.models.layers import tree_leaves

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0      # 0 => greedy argmax
    top_k: int = 0                # 0 => no truncation


def _sample(logits: Tensor, gen: torch.Generator | None, sc: ServeConfig) -> Tensor:
    """logits (B, 1, V) or (B, 1, K, V) -> next tokens (B, 1[, K]), int64."""
    if sc.temperature <= 0.0 or gen is None:
        return torch.argmax(logits, dim=-1)
    scaled = logits.float() / sc.temperature
    if sc.top_k > 0:
        kth = torch.topk(scaled, sc.top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, -1e30, scaled)
    flat = torch.softmax(scaled.reshape(-1, scaled.shape[-1]), dim=-1)
    toks = torch.multinomial(flat, 1, generator=gen)
    return toks.reshape(scaled.shape[:-1])


class Engine:
    """Serves ``params`` (on ``device``, the card by default) under ``sc``."""

    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig = ServeConfig(),
                 *, device="cuda"):
        self.device = resolve_device(device)
        wrong = [t.device for t in tree_leaves(params) if t.device != self.device]
        if wrong:
            raise ValueError(f"Engine: parameters lie on {wrong[0]}, not on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.sc = sc

    def generate(
        self,
        tokens: Tensor,                  # (B, S[, K]) prompt
        num_new: int,
        patches: Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> tuple[Tensor, dict]:
        """Returns (generated tokens (B, num_new[, K]), final cache)."""
        S = tokens.shape[1]
        if S + num_new > self.sc.max_len:
            raise ValueError(f"{S} prompt + {num_new} new tokens exceed "
                             f"ServeConfig.max_len = {self.sc.max_len}")
        logits, cache = self.prefill(tokens, patches)
        tok = _sample(logits, generator, self.sc)
        outs = [tok]
        for n in range(S, S + num_new - 1):
            logits, cache = self.decode_with_cache(tok, cache, n)
            tok = _sample(logits, generator, self.sc)
            outs.append(tok)
        return torch.cat(outs, dim=1), cache

    def prefill(self, tokens: Tensor, patches: Tensor | None = None):
        """The prefill forward pass: (first-token logits, the populated KV
        cache)."""
        return prefill(self.cfg, self.params, tokens, patches,
                       max_len=self.sc.max_len)

    def decode_with_cache(self, tok, cache, cache_len: int, pos: int | None = None):
        """One raw decode step; the cache is updated in place."""
        return decode_step(self.cfg, self.params, tok, cache, cache_len,
                           cache_len if pos is None else pos)

