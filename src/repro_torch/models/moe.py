"""Mixture-of-Experts FFN with top-k routing: the counterpart of
``repro/models/moe.py``, on one device.

Two paths, as in the reference:

* **prefill** (S > 1): capacity-bounded slot dispatch.  Within each batch
  row every (token, k) pair gets the slot ``expert * C + position within
  the expert``, the position from a cumsum over the row's pairs in (t, k)
  order; pairs at a position >= C go to the trash slot E * C, which is cut
  off.  The tokens move with one scatter and one gather, the experts run as
  three batched products over the (B, E, C, D) buffer, and the combine sums
  gate x expert output over the K picks.
* **decode** (S == 1): no capacity; the K chosen experts' matrices are
  gathered for each token, so a step reads only the active parameters.

Routing: top-1 with a sigmoid gate and an always-on shared expert
(llama4), or top-k softmax probabilities renormalised over the picks
(olmoe).  A Switch-style load-balancing loss comes back beside the output.

Under a mesh (DTensor inputs, ``models/sharding.py``) the routing and the
dispatch run per rank on its own batch rows (a local region: the stable
sort, the one-hot cumsum and the ``scatter_reduce`` have no DTensor
sharding rule, and each row's slots are its own), the buffer is pinned
with the experts over model for the three expert products, and each rank
combines the picks its own experts served (the sum over the experts'
ranks is the combine).  The load
and probability means behind the aux loss are averaged over the batch's
ranks, which gives the global means (equal rows a rank).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.layers import Params, dense_init, dtype_of, ffn, ffn_init
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


def moe_init(gen: torch.Generator, cfg, lead: tuple[int, ...] = ()) -> Params:
    """Router, the three expert banks (E, d, f) / (E, f, d) and, for llama4,
    the shared expert; ``lead`` prepends stacked axes (groups)."""
    dtype = dtype_of(cfg.param_dtype)
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.num_experts
    std = 1.0 / math.sqrt(d)

    def bank(shape, scale):
        w = torch.randn((*lead, *shape), generator=gen, device=gen.device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    p: Params = {
        "router": dense_init(gen, d, e, dtype, scale=std, lead=lead),
        "w_gate": bank((e, d, f), std),
        "w_up": bank((e, d, f), std),
        "w_down": bank((e, f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.shared_expert:
        p["shared"] = ffn_init(gen, d, f, dtype, lead=lead)
    return p


def top_k(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest in descending
    order, the lower index first on ties (``torch.topk`` gives no tie
    order, and the order of the picks sets the slot order and the combine's
    sum order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: Params, cfg, xt: Tensor):
    """xt (T, D) -> (top_idx (T, K) int64, gates (T, K) float32, aux scalar)."""
    top_idx, gates, load, prob = _route_stats(p["router"], cfg, xt)
    return top_idx, gates, _aux(cfg, load, prob)


def _route_stats(router: Tensor, cfg, xt: Tensor):
    """xt (T, D) -> (top_idx (T, K) int64, gates (T, K) float32, the mean
    dispatch and the mean probability of each expert (E,) float32)."""
    cdt = dtype_of(cfg.compute_dtype)
    E, K = cfg.num_experts, cfg.top_k
    logits = (xt.to(cdt) @ router.to(cdt)).float()
    probs = torch.softmax(logits, dim=-1)
    if K == 1:
        gate_vals, top_idx = top_k(logits, 1)
        gates = torch.sigmoid(gate_vals)              # llama4's sigmoid gate
    else:
        gate_vals, top_idx = top_k(probs, K)
        gates = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    load = F.one_hot(top_idx, E).float().sum(1).mean(0)
    return top_idx, gates, load, probs.mean(0)


def _aux(cfg, load: Tensor, prob: Tensor) -> Tensor:
    """The Switch aux loss: E * sum_e mean(dispatch_e) * mean(prob_e)."""
    return cfg.num_experts * (load * prob).sum()


def capacity(cfg, S: int, capacity_factor: float | None = None) -> int:
    """Slots per expert in a batch row of S tokens: ceil(cf K S / E)."""
    cf = cfg.capacity_factor if capacity_factor is None else capacity_factor
    return max(1, math.ceil(cf * cfg.top_k * S / cfg.num_experts))


def dispatch_keys(top_idx: Tensor, E: int, C: int) -> Tensor:
    """(B, S, K) expert choices -> (B, S*K) slot of each (t, k) pair: its
    expert's C slots, at its position among the row's pairs of that expert
    in (t, k) order; pairs at a position >= C get the trash slot E * C."""
    B = top_idx.shape[0]
    flat_e = top_idx.reshape(B, -1)                           # (B, S*K)
    eo = F.one_hot(flat_e, E)                                 # (B, S*K, E)
    pos = (eo.cumsum(1) - eo).gather(2, flat_e[..., None])[..., 0]
    return torch.where(pos < C, flat_e * C + pos, E * C)


def _dispatch(router: Tensor, cfg, x: Tensor, C: int):
    """Routing and dispatch of x (B, S, D) into the (B, E, C, D) buffer in
    the compute dtype: returns (buf, the slot of each (t, k) pair (B, S*K),
    gates (B, S, K), load (E,), prob (E,))."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    top_idx, gates, load, prob = _route_stats(router, cfg, x.reshape(B * S, D))
    key = dispatch_keys(top_idx.reshape(B, S, K), E, C)      # (B, S*K)
    rows = torch.arange(B, device=x.device)[:, None]
    # slot -> source pair.  Only the trash slot E*C takes more than one
    # pair, and amin picks the same one in any order (a plain scatter
    # with duplicate indices is nondeterministic on CUDA); every kept
    # slot has exactly one writer.  Unfilled slots keep S*K, which
    # points at the zero row.
    pairs = torch.arange(S * K, device=x.device).expand(B, -1)
    slot_pair = torch.full((B, E * C + 1), S * K, device=x.device,
                           dtype=torch.long)
    slot_pair.scatter_reduce_(1, key, pairs, reduce="amin")
    src = torch.where(slot_pair[:, :E * C] < S * K,
                      slot_pair[:, :E * C] // K, S)           # pair -> token
    xpad = torch.cat([x.to(cdt), x.new_zeros((B, 1, D), dtype=cdt)], 1)
    buf = xpad[rows, src].reshape(B, E, C, D)
    return buf, key, gates.reshape(B, S, K), load, prob


def _combine(y: Tensor, key: Tensor, gates: Tensor) -> Tensor:
    """Sum gate x expert output over each token's K picks: y (B, E, C, D),
    key (B, S*K), gates (B, S, K) -> (B, S, D)."""
    B, E, C, D = y.shape
    S, K = gates.shape[1], gates.shape[2]
    rows = torch.arange(B, device=y.device)[:, None]
    ypad = torch.cat([y.reshape(B, E * C, D), y.new_zeros((B, 1, D))], 1)
    contrib = ypad[rows, key] * gates.reshape(B, S * K, 1).to(y.dtype)
    return contrib.reshape(B, S, K, D).sum(2)


_BANKS = ("w_gate", "w_up", "w_down")


def _experts(buf: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    """The three batched expert products over (B, E, C, D)."""
    g = torch.einsum("becd,edf->becf", buf, w_gate)
    u = torch.einsum("becd,edf->becf", buf, w_up)
    return torch.einsum("becf,efd->becd", F.silu(g) * u, w_down)


def moe_forward(
    p: Params,
    cfg,
    x: Tensor,                 # (B, S, D)
    *,
    capacity_factor: float | None = None,
) -> tuple[Tensor, Tensor]:
    """Returns (output (B, S, D) in x's dtype, aux load-balance loss)."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k

    if isinstance(x, DTensor):
        out, aux = _sharded(p, cfg, x, capacity(cfg, S, capacity_factor))
    elif S == 1:
        top_idx, gates, aux = _route(p, cfg, x.reshape(B * S, D))
        out = _decode_path(p, cfg, x, top_idx.reshape(B, S, K), gates.reshape(B, S, K))
    else:
        buf, key, gates, load, prob = _dispatch(
            p["router"], cfg, x, capacity(cfg, S, capacity_factor))
        aux = _aux(cfg, load, prob)
        y = _experts(buf, *(p[n].to(cdt) for n in _BANKS))
        out = _combine(y, key, gates)                         # (B, S, D)

    if cfg.shared_expert:
        out = out + ffn(p["shared"], x, cdt, cfg.mlp_act)
    return out.to(x.dtype), aux


def _sharded(p: Params, cfg, x: DTensor, C: int) -> tuple[DTensor, DTensor]:
    """The prefill path on DTensors: the dispatch on each rank's rows, the
    experts over model, the combine of each rank's experts' picks."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    rows = tuple(d for d, q in enumerate(x.placements) if isinstance(q, Shard) and q.dim == 0)
    lead = tuple(Shard(0) if d in rows else Replicate() for d in range(x.device_mesh.ndim))
    x = redistribute(x, lead)
    router = redistribute(p["router"], (Replicate(),) * len(lead))
    # each rank's means over its own rows over the number of such ranks:
    # their sum is the global mean (a Partial "avg" would pass each rank
    # the whole gradient of the mean in the backward, not its share)
    share = tuple(Partial() if d in rows else Replicate() for d in range(len(lead)))
    n = math.prod(x.device_mesh.size(d) for d in rows)

    def dispatch(xl, rl):
        buf, key, gates, load, prob = _dispatch(rl, cfg, xl, C)
        if n > 1:                       # one rank's rows: the plain means
            load, prob = load / n, prob / n
        return buf, key, gates, load, prob

    buf, key, gates, load, prob = local_region(
        dispatch, (x, router),
        [(lead, (B, E, C, D)), (lead, (B, S * K)), (lead, (B, S, K)),
         (share, (E,)), (share, (E,))], grads=(None, share))
    aux = _aux(cfg, load, prob)
    # expert parallelism: E over model, the batch over pod x data; each
    # rank's experts' banks gathered over the batch axes (FSDP's unshard),
    # the products local to each rank (a region: DTensor's einsum
    # decomposition reshapes a strided shard on the card)
    buf = constrain(buf, (POD, DATA), MODEL, None, None)
    ep = tuple(Shard(0) if isinstance(q, Shard) and q.dim == 1 else Replicate()
               for q in buf.placements)
    banks = [redistribute(p[name].to(cdt), ep) for name in _BANKS]
    wgrad = tuple(Partial() if d in rows else q for d, q in enumerate(ep))
    y = local_region(_experts, (buf, *banks), (buf.placements, tuple(buf.shape)),
                     grads=(None, wgrad, wgrad, wgrad))
    y = constrain(y, (POD, DATA), MODEL, None, None)
    # each rank combines the picks its own experts served: the sum over
    # the experts' ranks is the combine (Partial there), and the expert
    # outputs never cross ranks
    experts = tuple(d for d, q in enumerate(y.placements) if isinstance(q, Shard) and q.dim == 1)
    e0, e1 = local_range(y, 1)
    part = tuple(Partial() if d in experts else q for d, q in enumerate(lead))

    def combine(yl, kl, gl):
        if (e0, e1) == (0, E):          # every expert on this rank: the plain combine
            return _combine(yl, kl, gl)
        inside = (kl >= e0 * C) & (kl < e1 * C)
        return _combine(yl, torch.where(inside, kl - e0 * C, (e1 - e0) * C), gl)

    out = local_region(combine, (y, key, gates), (part, (B, S, D)),
                       grads=(None, None, part))
    return out, aux


def _decode_path(p: Params, cfg, x: Tensor, top_idx: Tensor,
                 gates: Tensor) -> Tensor:
    """Decode-step MoE: gather the chosen experts' weights per token.  The
    reference casts the bank, then gathers; gathering first and casting the
    K picks gives the same values without reading and casting all E."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S, D = x.shape           # S == 1
    xt = x.reshape(B, D).to(cdt)
    idx = top_idx.reshape(B, -1)                              # (B, K)
    wg = p["w_gate"][idx].to(cdt)                             # (B, K, D, F)
    wu = p["w_up"][idx].to(cdt)
    wd = p["w_down"][idx].to(cdt)                             # (B, K, F, D)
    g = torch.einsum("bd,bkdf->bkf", xt, wg)
    u = torch.einsum("bd,bkdf->bkf", xt, wu)
    y = torch.einsum("bkf,bkfd->bkd", F.silu(g) * u, wd)      # (B, K, D)
    out = (y * gates.reshape(B, -1, 1).to(cdt)).sum(1)
    return out.reshape(B, S, D)
