"""GQA attention: full-causal and sliding-window, prefill through the fused
flash kernel, decode against a static KV cache.  The counterpart of
``repro/models/attention.py``, on one device (no sharding constraints).

Supports: RoPE, qk-norm (qwen3), QKV bias (qwen2), GQA with any
heads/kv-heads ratio, logit soft-capping (CPU only in prefill: the flash
kernel, like the TPU kernel, has none), decode with a static KV cache.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.ref import NEG, _softcap, attention_ref
from repro_torch.models.layers import (
    Params,
    apply_rope,
    dense_init,
    dtype_of,
    rmsnorm_headwise,
)

Tensor = torch.Tensor

NEG_INF = NEG  # finite: avoids NaN from all-masked softmax rows


def attention_init(gen: torch.Generator, cfg, lead: tuple[int, ...] = ()) -> Params:
    """Projections (and qk-norm scales, QKV biases) of one attention layer;
    ``lead`` prepends stacked axes (groups)."""
    dtype = dtype_of(cfg.param_dtype)
    dev = gen.device
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p: Params = {
        "w_q": dense_init(gen, d, qd, dtype, lead=lead),
        "w_k": dense_init(gen, d, kvd, dtype, lead=lead),
        "w_v": dense_init(gen, d, kvd, dtype, lead=lead),
        "w_o": dense_init(gen, qd, d, dtype, scale=1.0 / math.sqrt(qd), lead=lead),
    }
    if cfg.qkv_bias:
        for name, width in (("b_q", qd), ("b_k", kvd), ("b_v", kvd)):
            p[name] = torch.zeros((*lead, width), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, cfg.head_dim), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((*lead, cfg.head_dim), dtype=dtype, device=dev)
    return p


def _project_qkv(p: Params, cfg, x: Tensor, positions: Tensor):
    """x (B, S, D) -> q (B, S, H, hd), k/v (B, S, KV, hd), roped + normed."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    xc = x.to(cdt)
    q = xc @ p["w_q"].to(cdt)
    k = xc @ p["w_k"].to(cdt)
    v = xc @ p["w_v"].to(cdt)
    if cfg.qkv_bias:
        q = q + p["b_q"].to(cdt)
        k = k + p["b_k"].to(cdt)
        v = v + p["b_v"].to(cdt)
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm_headwise(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm_headwise(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# Blockwise causal attention (prefill)
# ---------------------------------------------------------------------------

def blockwise_attention(
    q: Tensor,           # (B, S, H, hd)
    k: Tensor,           # (B, S, KV, hd)
    v: Tensor,           # (B, S, KV, hd)
    *,
    causal: bool = True,
    window: int = 0,     # 0 = unbounded; else sliding window (causal)
    softcap: float = 0.0,
) -> Tensor:
    """Online-softmax attention; (B, S, H, hd) in q's dtype.

    On the card it is the flash kernel (``kernels/flash_attention.py``),
    which reads KV head h // (H / KV) in place of the reference's expanded
    copy (``head_map``) and computes in float32 throughout.  On the CPU it
    is the same function's plain version.  The reference's tiles
    (``block_q``, ``block_k``) are the kernel's own business here.  One
    difference from the reference in bfloat16: it rounds the probabilities
    to bfloat16 before P·V, the flash function does not.
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal, window, softcap)
    if softcap > 0.0:
        raise NotImplementedError(
            "blockwise_attention: the flash kernel has no logit softcap (nor "
            "has the TPU kernel); no config of the repository sets one")
    return flash_attention_kernel(q, k, v, causal=causal, window=window)


def attention_forward(
    p: Params, cfg, x: Tensor, positions: Tensor, *, window: int = 0
) -> Tensor:
    """Full training/prefill attention sublayer (no cache). x: (B, S, D)."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = blockwise_attention(
        q, k, v, causal=True, window=window, softcap=cfg.attn_logit_softcap
    )
    return out.reshape(B, S, cfg.q_dim) @ p["w_o"].to(cdt)


def attention_prefill(
    p: Params, cfg, x: Tensor, positions: Tensor, cache: dict, *, window: int = 0
) -> tuple[Tensor, dict]:
    """Prefill: full attention over (B, S, D) AND the populated KV cache.

    Writes k/v into ``cache`` (this layer's ``kv_cache_init`` buffers,
    (B, L, KV, hd), zeroed) in place and returns it; the reference takes
    ``max_len`` and returns a new cache.  Full attention caches all S
    positions (L = max_len); local attention caches only the trailing
    ``window`` positions as a ring buffer laid out exactly as
    ``attention_decode`` expects (slot = pos % window).
    """
    cdt = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = blockwise_attention(
        q, k, v, causal=True, window=window, softcap=cfg.attn_logit_softcap
    )
    out = out.reshape(B, S, cfg.q_dim) @ p["w_o"].to(cdt)

    ck, cv = cache["k"], cache["v"]
    L = ck.shape[1]
    if window > 0 and S >= L:
        # position S-L+j lives at slot (S-L+j) % L = (S+j) % L
        ck.copy_(torch.roll(k[:, -L:], S % L, dims=1))
        cv.copy_(torch.roll(v[:, -L:], S % L, dims=1))
    else:
        ck[:, :S] = k
        cv[:, :S] = v
    return out, cache


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------

def kv_cache_init(cfg, batch: int, max_len: int, window: int = 0, *,
                  device="cuda", lead: tuple[int, ...] = ()) -> dict:
    """Static cache for one attention layer.  ``window > 0`` allocates only a
    ring buffer of ``window`` slots (local attention / recurrentgemma)."""
    L = min(window, max_len) if window > 0 else max_len
    cdt = dtype_of(cfg.compute_dtype)
    shape = (*lead, batch, L, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


def attention_decode(
    p: Params,
    cfg,
    x: Tensor,         # (B, 1, D)
    cache: dict,       # {"k","v"}: (B, L, KV, hd)
    cache_len: int,    # tokens already in the cache
    *,
    window: int = 0,
    pos: int | None = None,  # RoPE position override (defaults to cache_len)
) -> tuple[Tensor, dict]:
    """One decode step.  Writes the new k/v at position ``cache_len`` (ring
    slot ``cache_len % window`` for local attention), attends to the valid
    prefix, returns (output (B, 1, D), the cache).

    The reference returns a new cache; this writes the new slot into
    ``cache`` in place (no copy of the whole cache per step) and returns it.
    ``pos`` decouples the rotary position of the new token from the cache
    slot (after KV-cache pruning)."""
    cdt = dtype_of(cfg.compute_dtype)
    B = x.shape[0]
    L = cache["k"].shape[1]
    cache_len = int(cache_len)
    rope_pos = cache_len if pos is None else int(pos)
    posb = torch.full((B, 1), rope_pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, posb)

    slot = cache_len % L if window > 0 else cache_len
    k, v = cache["k"], cache["v"]
    k[:, slot:slot + 1] = k_new.to(k.dtype)
    v[:, slot:slot + 1] = v_new.to(v.dtype)

    KV, H, hd = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    G = H // KV
    # grouped heads: query head h reads KV head h // G, as the reference's
    # head_map gather does, without the expanded copy
    qg = q.float().reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) / math.sqrt(hd)
    s = _softcap(s, cfg.attn_logit_softcap)                  # (B, KV, G, L)

    idx = torch.arange(L, device=x.device)
    if window > 0:
        # ring buffer: valid slots are the last min(cache_len+1, L) writes
        n_valid = min(cache_len + 1, L)
        valid = (slot - idx) % L < n_valid                   # age 0 = newest
    else:
        valid = idx <= cache_len
    s = torch.where(valid, s, NEG_INF)

    w = torch.softmax(s, dim=-1).to(cdt)
    out = torch.einsum("bkgs,bskd->bkgd", w, v)
    out = out.reshape(B, 1, cfg.q_dim) @ p["w_o"].to(cdt)
    return out, {"k": k, "v": v}
