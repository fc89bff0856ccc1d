"""Shared neural building blocks: init helpers, RMSNorm, RoPE, embeddings,
SwiGLU FFN.  The counterpart of ``repro/models/layers.py``: parameters are
plain nested dicts of tensors, every function is pure.

Dtype policy: parameters are stored in ``cfg.param_dtype``; matmuls run in
``cfg.compute_dtype``; normalization statistics, RoPE phases, softmax and the
final logits are computed in float32.  Each function keeps the reference's
cast order, so the two packages round at the same places.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = dict


def tree_leaves(tree: Params):
    """The tensors (or arrays) of a nested dict, depth first."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype named like a numpy / JAX dtype ("float32", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None, lead: tuple[int, ...] = ()) -> Tensor:
    """Variance-scaling (fan-in) normal init, the LLaMA / Gemma default:
    std 1/sqrt(d_in) unless ``scale`` is given.  ``lead`` prepends stacked
    axes (groups).  Drawn in float32 on the generator's device."""
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> Tensor:
    return torch.randn((vocab, d), generator=gen, device=gen.device,
                       dtype=torch.float32).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device, lead: tuple[int, ...] = ()) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: Tensor, eps: float) -> Tensor:
    """Normalise in float32, cast to x's dtype, then scale in that dtype."""
    return rmsnorm_headwise(p["scale"], x, eps)


def rmsnorm_headwise(scale: Tensor, x: Tensor, eps: float) -> Tensor:
    """qk-norm: normalize the trailing head_dim of (..., H, hd)."""
    dt = x.dtype
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms).to(dt) * scale.to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    """(head_dim/2,) inverse frequencies, float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotate (..., S, H, hd) by per-position phases (half-split rotation).
    ``positions`` is (S,) or broadcastable (B, S).  Computed in f32, cast
    back."""
    dt = x.dtype
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    ang = positions[..., None].float() * inv                 # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------

def ffn_init(gen: torch.Generator, d: int, f: int, dtype, gated: bool = True,
             lead: tuple[int, ...] = ()) -> Params:
    p = {
        "w_up": dense_init(gen, d, f, dtype, lead=lead),
        "w_down": dense_init(gen, f, d, dtype, scale=1.0 / math.sqrt(f),
                             lead=lead),
    }
    if gated:
        p["w_gate"] = dense_init(gen, d, f, dtype, lead=lead)
    return p


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation.
    if name == "silu":
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")


def ffn(p: Params, x: Tensor, compute_dtype, act: str = "silu") -> Tensor:
    xc = x.to(compute_dtype)
    a = _act(act)
    u = xc @ p["w_up"].to(compute_dtype)
    if "w_gate" in p:
        g = xc @ p["w_gate"].to(compute_dtype)
        return (a(g) * u) @ p["w_down"].to(compute_dtype)
    return a(u) @ p["w_down"].to(compute_dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, cfg) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    p: Params = {
        "tok": torch.stack(
            [embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
             for _ in range(cfg.num_codebooks)]
        )  # (K, V, D)
    }
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype,
                                  lead=(cfg.num_codebooks,))  # (K, D, V)
    return p


def embed_tokens(p: Params, cfg, tokens: Tensor) -> Tensor:
    """tokens: (B, S) for K=1, (B, S, K) for codebooks.  Returns (B, S, D)
    in the compute dtype."""
    cdt = dtype_of(cfg.compute_dtype)
    tok = p["tok"]                                 # (K, V, D)
    if cfg.num_codebooks == 1:
        t = tokens if tokens.dim() == 2 else tokens[..., 0]
        return tok[0][t].to(cdt)
    # sum of codebook embeddings (musicgen-style parallel streams), in the
    # compute dtype, codebook 0 first
    out = tok[0][tokens[..., 0]].to(cdt)
    for k in range(1, cfg.num_codebooks):
        out = out + tok[k][tokens[..., k]].to(cdt)
    return out


def unembed(p: Params, cfg, x: Tensor) -> Tensor:
    """x: (B, S, D) -> logits (B, S, V) or (B, S, K, V), float32.  The
    product is taken in the compute dtype, then upcast."""
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    if cfg.tie_embeddings:
        w = p["tok"].to(cdt)                            # (K, V, D)
        logits = torch.einsum("bsd,kvd->bskv", xc, w)
    else:
        w = p["unembed"].to(cdt)                        # (K, D, V)
        logits = torch.einsum("bsd,kdv->bskv", xc, w)
    logits = logits.float()
    if cfg.num_codebooks == 1:
        return logits[..., 0, :]
    return logits
