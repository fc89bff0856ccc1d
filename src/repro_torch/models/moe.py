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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init, dtype_of, ffn, ffn_init

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
    cdt = dtype_of(cfg.compute_dtype)
    E, K = cfg.num_experts, cfg.top_k
    logits = (xt.to(cdt) @ p["router"].to(cdt)).float()
    probs = torch.softmax(logits, dim=-1)
    if K == 1:
        gate_vals, top_idx = top_k(logits, 1)
        gates = torch.sigmoid(gate_vals)              # llama4's sigmoid gate
    else:
        gate_vals, top_idx = top_k(probs, K)
        gates = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch aux: E * sum_e mean(dispatch_e) * mean(prob_e)
    load = F.one_hot(top_idx, E).float().sum(1).mean(0)
    aux = E * (load * probs.mean(0)).sum()
    return top_idx, gates, aux


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

    top_idx, gates, aux = _route(p, cfg, x.reshape(B * S, D))
    top_idx = top_idx.reshape(B, S, K)
    gates = gates.reshape(B, S, K)

    if S == 1:
        out = _decode_path(p, cfg, x, top_idx, gates)
    else:
        C = capacity(cfg, S, capacity_factor)
        key = dispatch_keys(top_idx, E, C)                    # (B, S*K)
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
                          slot_pair[:, :E * C] // K, S)       # pair -> token
        xpad = torch.cat([x.to(cdt), x.new_zeros((B, 1, D), dtype=cdt)], 1)
        buf = xpad[rows, src].reshape(B, E, C, D)

        g = torch.einsum("becd,edf->becf", buf, p["w_gate"].to(cdt))
        u = torch.einsum("becd,edf->becf", buf, p["w_up"].to(cdt))
        y = torch.einsum("becf,efd->becd", F.silu(g) * u,
                         p["w_down"].to(cdt))                 # (B, E, C, D)

        ypad = torch.cat([y.reshape(B, E * C, D), y.new_zeros((B, 1, D))], 1)
        contrib = ypad[rows, key] * gates.reshape(B, S * K, 1).to(y.dtype)
        out = contrib.reshape(B, S, K, D).sum(2)              # (B, S, D)

    if cfg.shared_expert:
        out = out + ffn(p["shared"], x, cdt, cfg.mlp_act)
    return out.to(x.dtype), aux


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
