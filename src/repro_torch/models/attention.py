"""GQA attention: full-causal and sliding-window, prefill through the fused
flash kernel, decode against a static KV cache.  The counterpart of
``repro/models/attention.py``.  Under a mesh (``models/sharding.py``) the
query heads are pinned over ``model`` (unevenly where the count does not
divide), k and v over the batch axes only, and each rank runs the flash
kernel on its own query heads (:func:`_local_heads`).

Supports: RoPE, qk-norm (qwen3), QKV bias (qwen2), GQA with any
heads/kv-heads ratio, logit soft-capping (CPU only in prefill: the flash
kernel, like the TPU kernel, has none), decode with a static KV cache.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.ref import NEG, _softcap, attention_ref
from repro_torch.models.layers import (
    Params,
    apply_rope,
    dense_init,
    dtype_of,
    rmsnorm_headwise,
)
from repro_torch.models.sharding import (
    DATA,
    MODEL,
    POD,
    axis_sizes,
    constrain,
    current_mesh,
    local_range,
    local_region,
    local_write,
    placements,
    redistribute,
)

Tensor = torch.Tensor

NEG_INF = NEG  # finite: avoids NaN from all-masked softmax rows


def _constrain_heads(x: Tensor) -> Tensor:
    """(B, S, H, hd): heads over model, better than sharding head_dim
    (which puts the QK and PV contractions on the model axis).  Uneven
    head counts are legal (6 heads on 4 ranks split 2, 2, 2, 0, as GSPMD
    pads and as ``torch.chunk`` splits); DTensor's collectives fail on such
    a split in the backward, so an uneven count is pinned over the batch
    only and split inside the attention's region (:func:`_local_heads`)."""
    mesh = current_mesh()
    sizes = axis_sizes(mesh) if mesh is not None else {}
    if not isinstance(x, DTensor) or MODEL not in sizes:
        return x
    batch = tuple(a for a in (POD, DATA) if a in sizes)
    if not batch or x.shape[0] % math.prod(sizes[a] for a in batch):
        entry = None
    else:
        entry = batch if len(batch) > 1 else batch[0]
    # deliberately not fit_spec'd: an uneven head split is the point
    heads = MODEL if x.shape[2] % sizes[MODEL] == 0 else None
    return redistribute(x, placements(x.device_mesh, (entry, None, heads, None)))


def _local_heads(q: DTensor, k: DTensor, v: DTensor, fn) -> DTensor:
    """``fn(q, k, v)`` on each rank's own query heads (a local region:
    the flash kernels see local tensors).  The heads are split over model
    in ceiling-first blocks: q arrives split so (an even count), or whole
    (an uneven count: each rank takes its block, and its output, zero
    outside the block, is Partial over model).  k and v are replicated over
    model; query head h reads KV head h // G, so a rank slices its KV heads
    where its block is whole groups, and gathers one KV head per query head
    where it is not (rank 1 of 6 heads over 4 ranks, with G = 3, holds
    heads 2 and 3, which read KV heads 0 and 1).  A rank with no heads
    launches nothing (a zero-size grid is an invalid launch)."""
    mesh = q.device_mesh
    for d, p in enumerate(k.placements):
        if p != v.placements[d] or not (isinstance(p, Replicate) or p == q.placements[d]):
            raise ValueError(f"_local_heads: k, v {k.placements} must be q's "
                             f"{q.placements} over the batch and replicated elsewhere")
    H, G = q.shape[2], q.shape[2] // k.shape[2]
    split = [d for d, p in enumerate(q.placements) if isinstance(p, Shard) and p.dim == 2]
    if split or MODEL not in mesh.mesh_dim_names:
        h0, h1 = local_range(q, 2)
        whole, heads = False, split
    else:                             # an uneven count, split here
        m = mesh.mesh_dim_names.index(MODEL)
        chunk = -(-H // mesh.size(m))
        h0 = min(chunk * mesh.get_local_rank(m), H)
        h1 = min(h0 + chunk, H)
        whole, heads = True, [m]

    def body(ql, kl, vl):
        if whole:
            ql = ql[:, :, h0:h1]
        if h1 == h0:                  # no heads: nothing to launch (the
            # empty output still reads q, k and v, so that every rank's
            # backward runs the same collectives)
            out = torch.cat([ql, kl[:, :, :0], vl[:, :, :0]], dim=2)
        else:
            if h0 % G == 0 and h1 % G == 0:
                kl, vl = kl[:, :, h0 // G:h1 // G], vl[:, :, h0 // G:h1 // G]
            else:
                idx = torch.arange(h0, h1, device=kl.device) // G
                kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
            out = fn(ql, kl, vl)
        if whole:
            B, S, _, hd = out.shape
            out = torch.cat([out.new_zeros((B, S, h0, hd)), out,
                             out.new_zeros((B, S, H - h1, hd))], dim=2)
        return out

    # each rank's heads read their own KV heads (and, split here, their
    # own query heads): those gradients are each rank's share, Partial
    # over the head axis's mesh dimensions
    part = tuple(Partial() if d in heads else p for d, p in enumerate(k.placements))
    out_pl = tuple(Partial() if d in heads else p for d, p in enumerate(q.placements)) \
        if whole else q.placements
    return local_region(body, (q, k, v), (out_pl, tuple(q.shape)),
                        grads=(part if whole else None, part, part))


def _whole_heads(x, heads: int):
    """``x`` (B, S, heads x head_dim) with its last dimension gathered
    over the mesh dimensions that split it where their shards are not whole
    heads (a 48-wide projection over 4 ranks, 6 heads of 8): DTensor
    reshapes only a split that the heads divide.  Unchanged otherwise, and
    on a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    split = [d for d, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim == x.ndim - 1]
    if not split or heads % math.prod(x.device_mesh.size(d) for d in split) == 0:
        return x
    return redistribute(x, tuple(Replicate() if d in split else p
                                 for d, p in enumerate(x.placements)))


def _decode_split(q: DTensor, cache_k: DTensor) -> DTensor:
    """q (B, 1, H, hd) split by heads only where the cache splits its KV
    heads (``cache_spec_tree``), so that each rank's query heads are whole
    groups of its own KV heads; gathered elsewhere (one token's q moves,
    never the cache)."""
    if not isinstance(cache_k, DTensor):
        return q
    return redistribute(q, tuple(Replicate() if qp == Shard(2) and kp != Shard(2) else qp
                                 for qp, kp in zip(q.placements, cache_k.placements)))


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
    q = _whole_heads(q, cfg.num_heads).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = _whole_heads(k, cfg.num_kv_heads).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = _whole_heads(v, cfg.num_kv_heads).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm_headwise(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm_headwise(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # q: heads over model (uneven where they do not divide).  k, v:
    # replicated over model (a KV head is small, and each rank's query
    # heads read their own KV heads locally)
    return (_constrain_heads(q),
            constrain(k, (POD, DATA), None, None, None),
            constrain(v, (POD, DATA), None, None, None))


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
    copy (``head_map``) and computes in float32 throughout; under autograd
    it goes through ``FlashAttentionFn``, whose backward is the flash
    backward kernel (the reference takes this gradient by autodiff of its
    blockwise loop).  On the CPU it is the same function's plain version,
    differentiated by autograd.  The reference's tiles
    (``block_q``, ``block_k``) are the kernel's own business here.  One
    difference from the reference in bfloat16: it rounds the probabilities
    to bfloat16 before P·V, the flash function does not.  On DTensors each
    rank runs this on its own query heads (:func:`_local_heads`).
    """
    if isinstance(q, DTensor):
        return _local_heads(q, k, v, lambda a, b, c: blockwise_attention(
            a, b, c, causal=causal, window=window, softcap=softcap))
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

    L = cache["k"].shape[1]
    if window > 0 and S >= L:
        def write(c, t):
            # position S-L+j lives at slot (S-L+j) % L = (S+j) % L
            c.copy_(torch.roll(t[:, -L:], S % L, dims=1))
    else:
        def write(c, t):
            c[:, :S] = t
    # on DTensors each rank writes its own shard (``local_write``)
    local_write(cache["k"], k, write)
    local_write(cache["v"], v, write)
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

    def write(c, t):
        c[:, slot:slot + 1] = t

    local_write(k, k_new.to(k.dtype), write)
    local_write(v, v_new.to(v.dtype), write)

    KV, H, hd = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    G = H // KV
    if isinstance(q, DTensor):
        q = _decode_split(q, k)
    # grouped heads: query head h reads KV head h // G, as the reference's
    # head_map gather does, without the expanded copy
    qg = q.float().reshape(B, KV, G, hd)
    s = _decode_scores(qg, k, hd)
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
    out = _decode_values(w, v) @ p["w_o"].to(cdt)
    return out, {"k": k, "v": v}


def _decode_scores(qg: Tensor, k: Tensor, hd: int) -> Tensor:
    """The new token's scores against the cache, (B, KV, G, L): QKᵀ / √hd.
    On DTensors a local region on each rank's block of the cache (DTensor's
    einsum rule searches placements for minutes on a 3-D mesh), split over
    KV heads as the cache is, or summed over the mesh dimensions that split
    head_dim (the softmax is not linear: the sum is taken here)."""
    if not isinstance(k, DTensor):
        return torch.einsum("bkgd,bskd->bkgs", qg, k.float()) / math.sqrt(hd)
    qg = redistribute(qg, tuple(Shard(1) if kp == Shard(2) else kp for kp in k.placements))
    pl = tuple(Shard(1) if kp == Shard(2) else Partial() if kp == Shard(3) else kp
               for kp in k.placements)
    B, KV, G, _ = qg.shape
    s = local_region(lambda a, b: torch.einsum("bkgd,bskd->bkgs", a, b.float())
                     / math.sqrt(hd), (qg, k), (pl, (B, KV, G, k.shape[1])))
    return redistribute(s, tuple(Replicate() if isinstance(p, Partial) else p
                                 for p in s.placements))


def _decode_values(w: Tensor, v: Tensor) -> Tensor:
    """The weights' sum of the cached values, (B, 1, H x hd).  On DTensors
    a local region on each rank's block of the cache (see
    :func:`_decode_scores`): split over heads where the cache splits KV
    heads (a rank's KV heads hold a contiguous block of query heads); an
    output split over head_dim is gathered (one token's)."""
    B, KV, G, _ = w.shape
    hd = v.shape[-1]
    if not isinstance(v, DTensor):
        return torch.einsum("bkgs,bskd->bkgd", w, v).reshape(B, 1, KV * G * hd)
    w = redistribute(w, tuple(Shard(1) if vp == Shard(2) else vp if vp == Shard(0)
                              else Replicate() for vp in v.placements))
    if Shard(3) not in v.placements:
        return local_region(
            lambda a, b: torch.einsum("bkgs,bskd->bkgd", a, b).reshape(a.shape[0], 1, -1),
            (w, v), (tuple(v.placements), (B, 1, KV * G * hd)))
    pl = tuple(Shard(1) if vp == Shard(2) else vp for vp in v.placements)
    out = local_region(lambda a, b: torch.einsum("bkgs,bskd->bkgd", a, b), (w, v),
                       (pl, (B, KV, G, hd)))
    out = redistribute(out, tuple(Replicate() if p == Shard(3) else p for p in pl))
    return out.reshape(B, 1, KV * G * hd)
