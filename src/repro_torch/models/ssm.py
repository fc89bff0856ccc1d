"""Mamba2 (SSD, state-space duality) mixer block, arXiv:2405.21060: the
counterpart of ``repro/models/ssm.py``.  Under a mesh the SSD runs on each
rank's heads (d_inner and the heads over model).

Prefill runs the chunked SSD: the sequence splits into chunks of Q
positions; inside a chunk the output is a decay-masked quadratic
contraction, and across chunks one (B, H, P, N) state is carried, one chunk
at a time, so the quadratic tensors are O(B Q² H).  Decode keeps that state
and applies the exact recurrence ``h = a h + dt x ⊗ B;  y = h C + D x`` a
token, O(1) in the context length.

Layout: d_inner = expand * d_model, H = d_inner / headdim heads, G groups of
B and C (G = 1 for mamba2-780m), state size N.  A short causal depthwise
conv runs over the (x, B, C) channels.  ``jnp.repeat`` of the groups over
the heads is ``repeat_interleave`` (head h reads group h // (H / G)).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.layers import (Params, causal_conv, dense_init, dtype_of,
                                      rmsnorm)
from repro_torch.models.sharding import (
    DATA,
    MODEL,
    POD,
    constrain,
    local_range,
    local_region,
    redistribute,
)

Tensor = torch.Tensor


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return u.mul_(hi - lo).add_(lo)


def mamba2_init(gen: torch.Generator, cfg, lead: tuple[int, ...] = ()) -> Params:
    """The reference's shapes and draws' laws; ``lead`` prepends stacked
    axes (groups)."""
    dtype = dtype_of(cfg.param_dtype)
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * g * n
    dev = gen.device
    conv_w = torch.randn((*lead, cfg.conv_width, conv_dim), generator=gen,
                         device=dev, dtype=torch.float32)
    # A in [1, 16) as in the reference init; dt bias = softplus^-1 of
    # dt ~ logU[1e-3, 1e-1]
    a_init = torch.exp(_uniform(gen, (*lead, h), math.log(1.0), math.log(16.0)))
    dt = torch.exp(_uniform(gen, (*lead, h), math.log(1e-3), math.log(1e-1)))
    return {
        "w_in_zx": dense_init(gen, d, 2 * di, dtype, lead=lead),
        "w_in_bc": dense_init(gen, d, 2 * g * n, dtype, lead=lead),
        "w_in_dt": dense_init(gen, d, h, dtype, lead=lead),
        "conv_w": (conv_w / math.sqrt(cfg.conv_width)).to(dtype),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dtype, device=dev),
        "A_log": torch.log(a_init),                        # (H,) float32
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),       # (H,) float32
        "D": torch.ones((*lead, h), dtype=torch.float32, device=dev),
        "norm": torch.ones((*lead, di), dtype=dtype, device=dev),
        "w_out": dense_init(gen, di, d, dtype, scale=1.0 / math.sqrt(di),
                            lead=lead),
    }


def _split_proj(p: Params, cfg, u: Tensor):
    """u (B, S, D) -> z, x, bc, dt_raw, all in the compute dtype."""
    cdt = dtype_of(cfg.compute_dtype)
    uc = u.to(cdt)
    w = p["w_in_zx"].to(cdt)
    if isinstance(w, DTensor) and any(
            isinstance(q, Shard) and q.dim == 1 and w.device_mesh.size(d) > 1
            for d, q in enumerate(w.placements)):
        # split the weight, not the product: a split of the product's
        # sharded last dimension would gather the (B, S, 2 di) activation
        z, x = (uc @ redistribute(h, w.placements) for h in w.chunk(2, dim=-1))
    else:
        z, x = (uc @ w).chunk(2, dim=-1)                    # (B, S, di) each
    bc = uc @ p["w_in_bc"].to(cdt)                          # (B, S, 2 g n)
    dt_raw = uc @ p["w_in_dt"].to(cdt)                      # (B, S, H)
    return z, x, bc, dt_raw


def _gated_out(p: Params, cfg, y: Tensor, z: Tensor) -> Tensor:
    """y, z (B, S, di) -> (B, S, D): gated RMSNorm (eps 1e-6, not
    ``cfg.norm_eps``; SiLU in float32, cast to y's dtype), then the out
    projection."""
    cdt = dtype_of(cfg.compute_dtype)
    y = y * F.silu(z.float()).to(y.dtype)
    y = rmsnorm({"scale": p["norm"]}, y, 1e-6)
    return y.to(cdt) @ p["w_out"].to(cdt)


def chunk_len(cfg, S: int) -> int:
    """The largest chunk <= ``cfg.ssm_chunk`` that divides S."""
    Q = min(cfg.ssm_chunk, S)
    while S % Q:
        Q -= 1
    return Q


def _ssd(cfg, x: Tensor, bc: Tensor, dt_raw: Tensor, conv_w: Tensor, conv_b: Tensor,
         A_log: Tensor, dt_bias: Tensor, Dp: Tensor, h0: int, h1: int, dtype):
    """The conv and the chunked SSD of heads [h0, h1): x (B, S, their
    (h1 - h0) headdim channels), bc (B, S, 2 g n) every group's B and C,
    dt_raw (B, S, h1 - h0); the parameters whole.  Returns (y (B, S,
    channels) in ``dtype``, the conv's carry-out, the final state).  Each
    head's arithmetic is the whole layer's: the conv is depthwise, and a
    head reads its group h // (H / G)."""
    B, S, _ = x.shape
    g, n, h, pd = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    di, hl = cfg.d_inner, h1 - h0
    Q = chunk_len(cfg, S)
    nc = S // Q
    xbc_raw = torch.cat([x, bc], dim=-1)
    cw, cb = conv_w, conv_b
    if hl < h:                                              # this rank's channels
        cw = torch.cat([conv_w[:, h0 * pd:h1 * pd], conv_w[:, di:]], dim=-1)
        cb = torch.cat([conv_b[h0 * pd:h1 * pd], conv_b[di:]], dim=-1)
    # the conv's carry-out is the decode cache's conv state, left-padded
    # with zeros when S < W - 1
    conv_out, tail = causal_conv(xbc_raw, cw.to(xbc_raw.dtype), cb.to(xbc_raw.dtype))
    xbc = F.silu(conv_out.float())
    x = xbc[..., :hl * pd]
    Bm = xbc[..., hl * pd:hl * pd + g * n]
    Cm = xbc[..., hl * pd + g * n:]

    # per-head decay: a_t = exp(-dt_t A_h), dt = softplus(raw + bias).
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x itself above
    # its threshold of 20, where the two differ by less than a float32 ulp.
    dt = F.softplus(dt_raw.float() + dt_bias[h0:h1])        # (B, S, Hl)
    log_a = -dt * torch.exp(A_log[h0:h1])                   # (B, S, Hl) <= 0

    xh = x.reshape(B, nc, Q, hl, pd)
    Bc = Bm.reshape(B, nc, Q, g, n)
    Cc = Cm.reshape(B, nc, Q, g, n)
    dtc = dt.reshape(B, nc, Q, hl)
    lac = log_a.reshape(B, nc, Q, hl)

    rep = h // g                                            # heads per group
    if h0 % rep == 0 and h1 % rep == 0:                     # whole groups
        g0, g1 = h0 // rep, h1 // rep

        def heads(t, dim):
            return t.narrow(dim % t.dim(), g0, g1 - g0).repeat_interleave(rep, dim=dim)
    else:
        gmap = torch.arange(h0, h1, device=x.device) // rep

        def heads(t, dim):
            return t.index_select(dim % t.dim(), gmap)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    state = torch.zeros((B, hl, pd, n), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xh_c, B_c, C_c = xh[:, c], Bc[:, c], Cc[:, c]       # (B,Q,Hl,P) (B,Q,G,N)
        cum = torch.cumsum(lac[:, c], dim=1)                # (B, Q, Hl)
        total = cum[:, -1]                                  # (B, Hl)
        xdt = xh_c * dtc[:, c, :, :, None]                  # (B, Q, Hl, P)

        # intra-chunk: the decay-masked quadratic term
        seg = cum[:, :, None, :] - cum[:, None, :, :]       # (B, Q, Q, Hl)
        decay = torch.where(causal[None, :, :, None], torch.exp(seg), 0.0)
        scores = torch.einsum("bqgn,bsgn->bqsg", C_c, B_c)  # (B, Q, Q, G)
        scores = heads(scores, -1)                          # -> Hl
        y_c = torch.einsum("bqsh,bshp->bqhp", scores * decay, xdt)

        # inter-chunk: the carried state's contribution
        Ch = heads(C_c, 2)                                  # (B, Q, Hl, N)
        y_c = y_c + torch.einsum("bqhn,bhpn->bqhp", Ch, state) \
            * torch.exp(cum)[..., None]

        # carry update
        Bh = heads(B_c, 2)                                  # (B, Q, Hl, N)
        decay_to_end = torch.exp(total[:, None, :] - cum)   # (B, Q, Hl)
        st = torch.einsum("bqhn,bqhp->bhpn", Bh * decay_to_end[..., None], xdt)
        state = state * torch.exp(total)[:, :, None, None] + st
        ys.append(y_c)

    y = torch.stack(ys, dim=1).reshape(B, S, hl, pd)
    y = y + xh.reshape(B, S, hl, pd) * Dp[h0:h1, None]
    return y.reshape(B, S, hl * pd).to(dtype), tail, state


def _ssd_sharded(p: Params, cfg, x, bc, dt_raw, dtype, with_state: bool = False):
    """The SSD on DTensors, a local region over each rank's heads: x and
    dt_raw split over model on whole heads (else gathered whole), every
    group's B and C on every rank.  The gradients of B, C and of the
    replicated parameters are each rank's share (Partial over the heads'
    and the batch's mesh dimensions).  ``with_state`` also returns the
    final state (B, H, P, N), split as the heads and rows are, and the
    conv's tail where no rank splits the heads (else None)."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = x.device_mesh
    split = [d for d, q in enumerate(x.placements) if isinstance(q, Shard) and q.dim == 2]
    whole = math.prod(mesh.size(d) for d in split)
    if split and (cfg.ssm_heads % whole or tuple(dt_raw.placements) != tuple(x.placements)):
        x, dt_raw = (redistribute(t, tuple(Replicate() if d in split else q
                                           for d, q in enumerate(x.placements)))
                     for t in (x, dt_raw))
        split = []
    rows = [d for d, q in enumerate(x.placements) if isinstance(q, Shard) and q.dim == 0]
    bc = redistribute(bc, tuple(Shard(0) if d in rows else Replicate()
                                for d in range(mesh.ndim)))
    params = [redistribute(p[k], (Replicate(),) * mesh.ndim) if isinstance(p[k], DTensor)
              else p[k] for k in ("conv_w", "conv_b", "A_log", "dt_bias", "D")]
    h0, h1 = local_range(dt_raw, 2)
    share = tuple(Partial() if d in split or d in rows else Replicate()
                  for d in range(mesh.ndim))
    bc_grad = tuple(Partial() if d in split else q for d, q in enumerate(bc.placements))
    grads = (None, bc_grad, None) + (share,) * 5
    if not with_state:
        return local_region(
            lambda *a: _ssd(cfg, *a, h0, h1, dtype)[0], (x, bc, dt_raw, *params),
            (x.placements, tuple(x.shape)), grads=grads)
    state_pl = tuple(Shard(0) if d in rows else Shard(1) if d in split else Replicate()
                     for d in range(mesh.ndim))
    state_shape = (x.shape[0], cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    outs = [(x.placements, tuple(x.shape)), (state_pl, state_shape)]
    # the conv's tail holds every channel where no rank splits the heads
    whole_heads = all(mesh.size(d) == 1 for d in split)
    if whole_heads:
        outs.append((tuple(Shard(0) if d in rows else Replicate() for d in range(mesh.ndim)),
                     (x.shape[0], cfg.conv_width - 1, x.shape[2] + bc.shape[2])))

    def body(*a):
        y, tail, state = _ssd(cfg, *a, h0, h1, dtype)
        return (y, state, tail) if whole_heads else (y, state)

    res = local_region(body, (x, bc, dt_raw, *params), outs, grads=grads)
    return res if whole_heads else (*res, None)


def _conv_tail(x, bc, W: int):
    """The conv's carry-out of (x, bc) on DTensors, as ``causal_conv``
    gives it: the last W - 1 inputs, left-padded with zeros when S < W -
    1; only those positions are gathered whole."""
    S = x.shape[1]
    tail = torch.cat([x[:, max(S - (W - 1), 0):], bc[:, max(S - (W - 1), 0):]], dim=-1)
    return F.pad(tail, (0, 0, W - 1 - S, 0)) if S < W - 1 else tail


def mamba2_forward(p: Params, cfg, u: Tensor, return_cache: bool = False):
    """Chunked SSD over the full sequence.  u: (B, S, D) -> (B, S, D).

    With ``return_cache`` also returns the decode cache (the final state
    ``ssm`` in float32, the conv tail ``conv`` in the compute dtype), so
    prefill seeds O(1) decoding.  On DTensors (under a mesh) the SSD runs
    on each rank's heads (:func:`_ssd_sharded`), and the cache's state
    comes out split as the heads are."""
    z, x, bc, dt_raw = _split_proj(p, cfg, u)
    x = constrain(x, (POD, DATA), None, MODEL)              # d_inner over model
    dt_raw = constrain(dt_raw, (POD, DATA), None, MODEL)    # heads over model
    if isinstance(x, DTensor):
        if not return_cache:
            return _gated_out(p, cfg, _ssd_sharded(p, cfg, x, bc, dt_raw, u.dtype), z)
        y, state, tail = _ssd_sharded(p, cfg, x, bc, dt_raw, u.dtype, with_state=True)
        if tail is None:
            tail = _conv_tail(x, bc, cfg.conv_width)
        return _gated_out(p, cfg, y, z), {"conv": tail.to(dtype_of(cfg.compute_dtype)),
                                          "ssm": state}
    y, tail, state = _ssd(cfg, x, bc, dt_raw, p["conv_w"], p["conv_b"], p["A_log"],
                          p["dt_bias"], p["D"], 0, cfg.ssm_heads, u.dtype)
    out = _gated_out(p, cfg, y, z)
    if not return_cache:
        return out
    cdt = dtype_of(cfg.compute_dtype)
    return out, {"conv": tail.to(cdt), "ssm": state}


# ---------------------------------------------------------------------------
# Decode (recurrent) path
# ---------------------------------------------------------------------------

def mamba2_cache_init(cfg, batch: int, *, device="cuda",
                      lead: tuple[int, ...] = ()) -> dict:
    """Zero decode cache of one layer (``lead``: stacked groups): the conv
    state in the compute dtype, the SSM state in float32."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": torch.zeros((*lead, batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype_of(cfg.compute_dtype), device=device),
        "ssm": torch.zeros((*lead, batch, cfg.ssm_heads, cfg.ssm_headdim,
                            cfg.ssm_state), dtype=torch.float32, device=device),
    }


def _decode_heads(cfg, x, bc, dt_raw, conv, conv_w, conv_b, dt_bias, A_log, Dp, state,
                  h0: int, h1: int, dtype):
    """One token's recurrence on heads [h0, h1): x (B, 1, their channels),
    bc (B, 1, 2 g n), dt_raw (B, 1, h1 - h0), the conv state (B, W - 1,
    conv_dim) and the parameters whole, ``state`` (B, h1 - h0, P, N).
    Returns (y (B, 1, channels) in ``dtype``, the new conv state of these
    channels and B, C, the new state)."""
    B = x.shape[0]
    g, n, h, pd = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    di, hl = cfg.d_inner, h1 - h0
    cw, cb = conv_w, conv_b
    if hl < h:                                              # this rank's channels
        conv = torch.cat([conv[..., h0 * pd:h1 * pd], conv[..., di:]], dim=-1)
        cw = torch.cat([conv_w[:, h0 * pd:h1 * pd], conv_w[:, di:]], dim=-1)
        cb = torch.cat([conv_b[h0 * pd:h1 * pd], conv_b[di:]], dim=-1)
    xbc = torch.cat([x, bc], dim=-1)                        # (B, 1, conv channels)
    window = torch.cat([conv, xbc], dim=1)                  # (B, W, conv channels)
    conv_out = (window * cw.to(window.dtype)).sum(1) + cb.to(window.dtype)
    xbc1 = F.silu(conv_out.float())

    rep = h // g
    xt = xbc1[:, :hl * pd].reshape(B, hl, pd)
    Bt = xbc1[:, hl * pd:hl * pd + g * n].reshape(B, g, n).repeat_interleave(rep, dim=1)
    Ct = xbc1[:, hl * pd + g * n:].reshape(B, g, n).repeat_interleave(rep, dim=1)
    if hl < h:
        Bt, Ct = Bt[:, h0:h1], Ct[:, h0:h1]

    dt = F.softplus(dt_raw[:, 0].float() + dt_bias[h0:h1])  # (B, Hl)
    a = torch.exp(-dt * torch.exp(A_log[h0:h1]))            # (B, Hl)
    hs = state * a[:, :, None, None] + torch.einsum(
        "bhp,bhn->bhpn", xt * dt[..., None], Bt)
    y = torch.einsum("bhpn,bhn->bhp", hs, Ct) + xt * Dp[h0:h1, None]
    return y.reshape(B, 1, hl * pd).to(dtype), window[:, 1:], hs


def mamba2_decode(p: Params, cfg, u: Tensor, cache: dict) -> tuple[Tensor, dict]:
    """One token.  u: (B, 1, D).  Exact recurrence, O(1) in context.
    Returns (output, a new cache); ``cache`` is not written.  On DTensors
    a local region on each rank's heads, as the cache's state splits them
    (DTensor's einsum rules search placements for minutes on a 3-D mesh)."""
    z, x, bc, dt_raw = _split_proj(p, cfg, u)
    if isinstance(cache["ssm"], DTensor):
        y, new = _decode_sharded(p, cfg, x, bc, dt_raw, cache, u.dtype)
        return _gated_out(p, cfg, y, z), new
    y, new_conv, hs = _decode_heads(cfg, x, bc, dt_raw, cache["conv"], p["conv_w"],
                                    p["conv_b"], p["dt_bias"], p["A_log"], p["D"],
                                    cache["ssm"], 0, cfg.ssm_heads, u.dtype)
    return _gated_out(p, cfg, y, z), {"conv": new_conv, "ssm": hs}


def _decode_sharded(p: Params, cfg, x, bc, dt_raw, cache: dict, dtype):
    """:func:`mamba2_decode`'s recurrence on DTensors: x and dt_raw split
    over the mesh dimensions that split the cache's heads, B, C and the
    conv state whole there.  The new conv state is the region's where the
    heads are whole on every rank (each rank's window then holds every
    channel), else the old one shifted by the token's channels, gathered
    (one token's)."""
    ssm = cache["ssm"]
    mesh = ssm.device_mesh
    rows = [d for d, q in enumerate(ssm.placements) if q == Shard(0)]
    heads = [d for d, q in enumerate(ssm.placements) if q == Shard(1) and mesh.size(d) > 1]
    whole = tuple(Shard(0) if d in rows else Replicate() for d in range(mesh.ndim))
    split = tuple(Shard(2) if d in heads else q for d, q in enumerate(whole))
    x, dt_raw = redistribute(x, split), redistribute(dt_raw, split)
    bc, conv = redistribute(bc, whole), redistribute(cache["conv"], whole)
    params = [redistribute(p[k], (Replicate(),) * mesh.ndim) if isinstance(p[k], DTensor)
              else p[k] for k in ("conv_w", "conv_b", "dt_bias", "A_log", "D")]
    h0, h1 = local_range(ssm, 1)
    outs = [(split, tuple(x.shape)), (ssm.placements, tuple(ssm.shape))]
    if not heads:
        outs.append((whole, tuple(conv.shape)))

    def body(*a):
        y, window, hs = _decode_heads(cfg, *a, h0, h1, dtype)
        return (y, hs) if heads else (y, hs, window)

    res = local_region(body, (x, bc, dt_raw, conv, *params, ssm), outs)
    if heads:
        (y, hs), window = res, torch.cat(
            [conv[:, 1:], torch.cat([x, bc], dim=-1).to(conv.dtype)], dim=1)
    else:
        y, hs, window = res
    return y, {"conv": window, "ssm": hs}
