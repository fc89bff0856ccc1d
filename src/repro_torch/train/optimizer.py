"""Hand-rolled optimizers, AdamW and Adafactor: the counterpart of
``repro/train/optimizer.py``.

Both are ``init(params) -> state`` and ``update(grads, state, params, lr,
step)``.  The states are nested dicts of float32 tensors with the
reference's keys (AdamW ``{"mu", "nu"}``; Adafactor ``{"v"}`` of per-leaf
``{"vr", "vc"}`` for factored leaves or ``{"v"}``), in the parameters'
tree.  Where the reference returns new parameters and state, ``update``
writes both in place, leaf by leaf under ``torch.no_grad()``, with the
reference's arithmetic (a leaf's temporaries are the only extra memory),
and returns them.  A checkpoint taken of a state must therefore be copied
to the host before the next update (``Checkpointer.save_async`` does).

Adafactor (Shazeer & Stern 2018) stores the second moments of every large
leaf of two or more axes as a row and a column factor, keeps no first
moment, and clips the update's RMS at ``clip_threshold``.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


def _zip_leaves(*trees):
    """(leaf of each tree) for parallel nested dicts, walking the first
    tree; the others may hold a dict where the first holds a tensor (a
    factored Adafactor state)."""
    first = trees[0]
    for key in first:
        if isinstance(first[key], dict):
            yield from _zip_leaves(*(t[key] for t in trees))
        else:
            yield tuple(t[key] for t in trees)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _write(p: Tensor, new: Tensor) -> None:
    """p <- new, rounded to p's dtype (the reference's ``.astype(p.dtype)``)."""
    p.copy_(new)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params) -> dict:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"mu": _map(zeros, params), "nu": _map(zeros, params)}

    @torch.no_grad()
    def update(self, grads, state, params, lr: Tensor, step: Tensor):
        b1, b2 = self.b1, self.b2
        t = step.float() + 1.0
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)
        for g, m, v, p in _zip_leaves(grads, state["mu"], state["nu"], params):
            gf = g.float()
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * gf * gf)
            delta = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            if p.dim() >= 2:  # no decay on norms/biases
                delta.add_(self.weight_decay * p.float())
            _write(p, p.float() - lr * delta)
        return params, state

    def state_spec_tree(self, param_specs: dict, params_shape: dict) -> dict:
        """The moments shard as their parameters."""
        return {"mu": param_specs, "nu": param_specs}


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Adafactor:
    decay: float = 0.8           # \hat{beta2}_t = 1 - t^{-decay}
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    min_dim_factored: int = 128  # only factor axes at least this large

    def _factored(self, p) -> bool:
        return (
            p.dim() >= 2
            and p.shape[-1] >= self.min_dim_factored
            and p.shape[-2] >= self.min_dim_factored
        )

    def init(self, params) -> dict:
        def leaf_state(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
            if self._factored(p):
                return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        return {"v": _map(leaf_state, params)}

    @torch.no_grad()
    def update(self, grads, state, params, lr: Tensor, step: Tensor):
        t = step.float() + 1.0
        beta2 = 1.0 - t ** (-self.decay)
        for g, s, p in _zip_leaves(grads, state["v"], params):
            gf = g.float()
            g2 = gf * gf + self.eps
            if "vr" in s:
                vr, vc = s["vr"], s["vc"]
                vr.copy_(beta2 * vr + (1 - beta2) * g2.mean(dim=-1))
                vc.copy_(beta2 * vc + (1 - beta2) * g2.mean(dim=-2))
                denom = torch.clamp_min(vr.mean(dim=-1, keepdim=True), self.eps)
                u = gf * torch.rsqrt((vr / denom)[..., None] * vc[..., None, :]
                                     + self.eps)
            else:
                v = s["v"]
                v.copy_(beta2 * v + (1 - beta2) * g2)
                u = gf * torch.rsqrt(v + self.eps)
            del g2
            rms = torch.sqrt((u * u).mean() + self.eps)
            u.div_(torch.clamp_min(rms / self.clip_threshold, 1.0))
            pf = p.float()
            if self.weight_decay > 0.0 and p.dim() >= 2:
                u.add_(self.weight_decay * pf)
            _write(p, pf - lr * u)
        return params, state

    def state_spec_tree(self, param_specs: dict, params_shape: dict) -> dict:
        """Specs of the factored state: ``vr`` drops the parameter's last
        axis, ``vc`` its second to last (the row and column means reduce
        over a sharded axis across its ranks); decided per leaf from the
        shapes, as ``init`` decides."""

        def leaf(spec, p):
            if self._factored(p):
                return {"vr": tuple(spec[:-1]), "vc": (*spec[:-2], spec[-1])}
            return {"v": spec}

        def walk(specs, shapes):
            return {k: walk(specs[k], v) if isinstance(v, dict) else leaf(specs[k], v)
                    for k, v in shapes.items()}

        return {"v": walk(param_specs, params_shape)}


def make_optimizer(name: str, **kw):
    if name == "adamw":
        return AdamW(**kw)
    if name == "adafactor":
        return Adafactor(**kw)
    raise ValueError(name)
