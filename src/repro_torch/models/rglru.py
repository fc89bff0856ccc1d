"""RG-LRU recurrent mixer (Griffin / RecurrentGemma, arXiv:2402.19427): the
counterpart of ``repro/models/rglru.py``, on one device.

Block structure (the paper's "recurrent block"):

    x ──> W_y ──> GeLU ─────────────────────────┐
    x ──> W_x ──> causal conv1d(4) ──> RG-LRU ──┤⊙──> W_out ──> out

RG-LRU recurrence (per channel, diagonal):

    r_t = sigmoid(w_a ⊙ u_t + b_a)        recurrence gate
    i_t = sigmoid(w_i ⊙ u_t + b_i)        input gate
    a_t = exp(-c * softplus(Λ) * r_t)     decay in (0, 1),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t)

Prefill scans the (a_t, b_t) pairs of the linear recurrence in log depth
(a doubling scan: 12 steps at S = 4096, not one launch a position); the
reference's ``associative_scan`` combines in another order, so the float32
results agree to rounding, not bit for bit.  Decode is the exact O(1)
recurrence a token.  The gate projections are diagonal (per channel), as
in the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, causal_conv, dense_init, dtype_of
from repro_torch.models.sharding import DATA, MODEL, POD, constrain

Tensor = torch.Tensor

_C = 8.0  # Griffin's fixed decay sharpness


def rglru_init(gen: torch.Generator, cfg, lead: tuple[int, ...] = ()) -> Params:
    """The reference's shapes and draws' laws (the gates start at zero);
    ``lead`` prepends stacked axes (groups)."""
    dtype = dtype_of(cfg.param_dtype)
    d, dr = cfg.d_model, cfg.d_rnn
    dev = gen.device
    conv_w = torch.randn((*lead, cfg.conv_width, dr), generator=gen, device=dev,
                         dtype=torch.float32)
    # Λ so that a^c = exp(-c softplus(Λ)) is uniform in [0.9, 0.999]
    u = torch.rand((*lead, dr), generator=gen, device=dev, dtype=torch.float32)
    u = u.mul_(0.999 - 0.9).add_(0.9)
    zero = torch.zeros((*lead, dr), dtype=torch.float32, device=dev)
    return {
        "w_y": dense_init(gen, d, dr, dtype, lead=lead),
        "w_x": dense_init(gen, d, dr, dtype, lead=lead),
        "conv_w": (conv_w / math.sqrt(cfg.conv_width)).to(dtype),
        "conv_b": torch.zeros((*lead, dr), dtype=dtype, device=dev),
        "gate_a_w": zero.clone(),
        "gate_a_b": zero.clone(),
        "gate_i_w": zero.clone(),
        "gate_i_b": zero.clone(),
        "lam": torch.log(torch.expm1(-torch.log(u) / _C)),  # (dr,) float32
        "w_out": dense_init(gen, dr, d, dtype, scale=1.0 / math.sqrt(dr),
                            lead=lead),
    }


def _gates(p: Params, u: Tensor):
    """u (..., dr) float32 -> (a, b) of the linear recurrence h = a h + b."""
    r = torch.sigmoid(p["gate_a_w"] * u + p["gate_a_b"])
    i = torch.sigmoid(p["gate_i_w"] * u + p["gate_i_b"])
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x itself above
    # its threshold of 20, where the two differ by less than a float32 ulp.
    log_a = -_C * F.softplus(p["lam"]) * r                # (..., dr) <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (i * u)
    return a, b


def linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, by doubling:
    after the step of stride d each position holds the composition of its
    last 2d pairs, (a1, b1) then (a2, b2) composing to (a1 a2, b1 a2 + b2),
    so ceil(log2 S) steps of whole-tensor ops."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_forward(p: Params, cfg, x: Tensor, return_cache: bool = False):
    """Full-sequence recurrent block.  x: (B, S, D) -> (B, S, D).

    With ``return_cache`` also returns the decode cache (the conv tail of
    the W_x projection in the compute dtype, the final hidden state ``h`` in
    float32) so prefill seeds O(1) decoding."""
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    # jax.nn.gelu's default is the tanh approximation (models/layers.py)
    y = F.gelu(constrain(xc @ p["w_y"].to(cdt), (POD, DATA), None, MODEL),
               approximate="tanh")
    x_in = constrain(xc @ p["w_x"].to(cdt), (POD, DATA), None, MODEL)
    # the conv's carry-out is the decode cache's conv state, left-padded
    # with zeros when S < W - 1
    u, tail = causal_conv(x_in, p["conv_w"].to(cdt), p["conv_b"].to(cdt))
    a, b = _gates(p, u.float())                           # (B, S, dr)
    h = linear_scan(a, b)
    out = ((h.to(cdt) * y) @ p["w_out"].to(cdt)).to(x.dtype)
    if not return_cache:
        return out
    return out, {"conv": tail, "h": h[:, -1].float()}


def rglru_cache_init(cfg, batch: int, *, device="cuda",
                     lead: tuple[int, ...] = ()) -> dict:
    """Zero decode cache of one layer (``lead``: stacked groups)."""
    return {
        "conv": torch.zeros((*lead, batch, cfg.conv_width - 1, cfg.d_rnn),
                            dtype=dtype_of(cfg.compute_dtype), device=device),
        "h": torch.zeros((*lead, batch, cfg.d_rnn), dtype=torch.float32,
                         device=device),
    }


def rglru_decode(p: Params, cfg, x: Tensor, cache: dict) -> tuple[Tensor, dict]:
    """One token.  x: (B, 1, D).  Returns (output, a new cache); ``cache``
    is not written."""
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    y = F.gelu(xc @ p["w_y"].to(cdt), approximate="tanh")  # (B, 1, dr)
    u, new_conv = causal_conv(xc @ p["w_x"].to(cdt), p["conv_w"].to(cdt),
                              p["conv_b"].to(cdt), state=cache["conv"])
    a, b = _gates(p, u[:, 0].float())                     # (B, dr)
    h = a * cache["h"] + b
    out = (h[:, None, :].to(cdt) * y) @ p["w_out"].to(cdt)
    return out.to(x.dtype), {"conv": new_conv, "h": h}
