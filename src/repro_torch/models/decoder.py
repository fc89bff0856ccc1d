"""Decoder-only LM assembly: the counterpart of ``repro/models/decoder.py``
for the attention-only block types (``attn``, ``local``).

Params layout (plain nested dicts of tensors), the reference's own:

    {"embed":  {...},
     "blocks": {"p0": <stacked over groups>, "p1": ..., ...},
     "rem":    {"r0": ..., ...},                # the unstacked tail
     "final_norm": {...}}

``blocks.p<i>`` holds the i-th entry of ``cfg.block_pattern`` stacked over
the ``cfg.num_groups`` pattern repetitions.  The reference scans over the
groups; here a Python loop walks them, taking group g's parameters as views
(``[g]``) of the stacked tensors.  The decode cache keeps the same layout,
``{"blocks": {"p0": {"k": (G, B, L, KV, hd), ...}}, "rem": {...}}``.

Entry points: ``forward``, ``prefill``, ``init_cache``, ``decode_step``.
The block types ``attn_moe``, ``mamba2`` and ``rglru`` raise
``NotImplementedError``: they are ROADMAP §1 item 12's next modules.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Params,
    dtype_of,
    embed_tokens,
    embedding_init,
    ffn,
    ffn_init,
    rmsnorm,
    rmsnorm_init,
    unembed,
)

Tensor = torch.Tensor

_PORTED = ("attn", "local")


def _require_ported(cfg: ModelConfig) -> None:
    for btype in cfg.block_pattern:
        if btype not in _PORTED:
            raise NotImplementedError(
                f"{cfg.name}: block type {btype!r} is not ported yet (ROADMAP "
                "§1 item 12: experts, SSM and RG-LRU mixers come later); the "
                f"port runs {_PORTED}")


def _group(tree: Params, g: int) -> Params:
    """Group g's slice (views) of a tree stacked over groups."""
    return {k: _group(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_init(gen: torch.Generator, cfg: ModelConfig, btype: str,
                lead: tuple[int, ...] = ()) -> Params:
    pdt = dtype_of(cfg.param_dtype)
    d, dev = cfg.d_model, gen.device
    p: Params = {"ln1": rmsnorm_init(d, pdt, dev, lead)}
    p["attn"] = attn.attention_init(gen, cfg, lead)
    p["ln2"] = rmsnorm_init(d, pdt, dev, lead)
    p["ffn"] = ffn_init(gen, d, cfg.d_ff, pdt, gated=cfg.mlp_gated, lead=lead)
    return p


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device="cuda") -> Params:
    """Synthetic parameters in ``cfg.param_dtype`` on ``device`` (the card by
    default), drawn from ``generator`` (on that device), with the reference's
    shapes and standard deviations.  The draws differ from ``jax.random``'s:
    tests that compare the two packages carry the JAX parameters across with
    ``convert.model_params_from_numpy``."""
    _require_ported(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"init_params: the generator is on {generator.device}, "
                         f"not {dev}")
    pdt = dtype_of(cfg.param_dtype)
    params: Params = {"embed": embedding_init(generator, cfg)}
    params["blocks"] = {
        f"p{i}": _block_init(generator, cfg, btype, (cfg.num_groups,))
        for i, btype in enumerate(cfg.block_pattern)
    }
    params["rem"] = {f"r{i}": _block_init(generator, cfg, btype)
                     for i, btype in enumerate(cfg.remainder_blocks)}
    params["final_norm"] = rmsnorm_init(cfg.d_model, pdt, dev)
    return params


# ---------------------------------------------------------------------------
# forward (prefill without a cache)
# ---------------------------------------------------------------------------

def _layers(cfg: ModelConfig, params: Params, cache: Params | None = None):
    """(btype, params, cache or None) of every layer in order: group by
    group through the pattern, then the tail."""
    for g in range(cfg.num_groups):
        for i, btype in enumerate(cfg.block_pattern):
            key = f"p{i}"
            yield (btype, _group(params["blocks"][key], g),
                   None if cache is None else _group(cache["blocks"][key], g))
    for i, btype in enumerate(cfg.remainder_blocks):
        key = f"r{i}"
        yield (btype, params["rem"][key],
               None if cache is None else cache["rem"][key])


def _window(cfg: ModelConfig, btype: str) -> int:
    return cfg.local_window if btype == "local" else 0


def _ffn_half(cfg: ModelConfig, p: Params, x: Tensor) -> Tensor:
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + ffn(p["ffn"], h2, dtype_of(cfg.compute_dtype), cfg.mlp_act)


def _embed(cfg: ModelConfig, params: Params, tokens: Tensor,
           patches: Tensor | None) -> Tensor:
    x = embed_tokens(params["embed"], cfg, tokens)
    if cfg.input_mode == "tokens+patches":
        if patches is None:
            raise ValueError(f"{cfg.name} takes patches (B, P, d_model)")
        P = patches.shape[1]
        x = torch.cat([patches.to(x.dtype), x[:, P:]], dim=1)
    return x


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: Tensor,                 # (B, S) or (B, S, K) codebooks
    patches: Tensor | None = None,  # (B, P, D) for tokens+patches mode
    *,
    logits_slice: int = 0,          # >0: only last N positions get logits
) -> tuple[Tensor, Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss); aux_loss is 0
    for the ported (dense) blocks."""
    _require_ported(cfg)
    x = _embed(cfg, params, tokens, patches)
    positions = torch.arange(x.shape[1], device=x.device)
    for btype, p, _ in _layers(cfg, params):
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        x = x + attn.attention_forward(p["attn"], cfg, h, positions,
                                       window=_window(cfg, btype))
        x = _ffn_half(cfg, p, x)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_slice > 0:
        x = x[:, -logits_slice:]
    return unembed(params["embed"], cfg, x), torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# prefill (forward + populated decode cache)
# ---------------------------------------------------------------------------

def _block_prefill(cfg: ModelConfig, btype: str, p: Params, x: Tensor,
                   positions: Tensor, cache: Params):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, cache = attn.attention_prefill(p["attn"], cfg, h, positions, cache,
                                      window=_window(cfg, btype))
    return _ffn_half(cfg, p, x + y), cache


def prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: Tensor,
    patches: Tensor | None = None,
    *,
    max_len: int,
) -> tuple[Tensor, Params]:
    """Full-sequence forward that also populates the decode cache.

    Returns (last-position logits (B, 1, V...), cache)."""
    _require_ported(cfg)
    x = _embed(cfg, params, tokens, patches)
    positions = torch.arange(x.shape[1], device=x.device)
    cache = init_cache(cfg, x.shape[0], max_len, device=x.device)
    for btype, p, c in _layers(cfg, params, cache):
        x, _ = _block_prefill(cfg, btype, p, x, positions, c)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], cfg, x[:, -1:]), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> Params:
    """Decode cache, stacked over groups like the params."""
    _require_ported(cfg)
    dev = resolve_device(device)
    return {
        "blocks": {
            f"p{i}": attn.kv_cache_init(cfg, batch, max_len, _window(cfg, btype),
                                        device=dev, lead=(cfg.num_groups,))
            for i, btype in enumerate(cfg.block_pattern)
        },
        "rem": {
            f"r{i}": attn.kv_cache_init(cfg, batch, max_len, _window(cfg, btype),
                                        device=dev)
            for i, btype in enumerate(cfg.remainder_blocks)
        },
    }


def _block_decode(cfg: ModelConfig, btype: str, p: Params, x: Tensor, cache,
                  cache_len: int, pos: int | None = None):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, cache = attn.attention_decode(p["attn"], cfg, h, cache, cache_len,
                                     window=_window(cfg, btype), pos=pos)
    return _ffn_half(cfg, p, x + y), cache


def decode_step(
    cfg: ModelConfig,
    params: Params,
    tokens: Tensor,      # (B, 1) or (B, 1, K)
    cache: Params,
    cache_len: int,      # tokens already in the cache
    pos: int | None = None,  # true sequence position (after KV pruning)
) -> tuple[Tensor, Params]:
    """One-token decode.  Returns (logits (B, 1, V...), the cache), which
    is updated in place (the reference returns a new one)."""
    _require_ported(cfg)
    x = embed_tokens(params["embed"], cfg, tokens)
    for btype, p, c in _layers(cfg, params, cache):
        x, _ = _block_decode(cfg, btype, p, x, c, cache_len, pos)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], cfg, x), cache
