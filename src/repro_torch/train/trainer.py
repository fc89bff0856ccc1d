"""The training step: loss and gradients with microbatch accumulation, the
global-norm clip, the learning-rate schedule and the optimizer update; the
counterpart of ``repro/train/trainer.py`` on one device.

The step reads nothing back to the host: its metrics are 0-d tensors
(``loss``, ``aux``, ``grad_norm``, ``lr``) until a caller logs them.  The
optimizer updates the parameters and its state in place, so the state the
step returns holds the same tensors as the one it was given (with a new
``step``).  Microbatching is a Python loop over ``num_microbatches`` slices
of the batch, each through its own backward, with the gradients summed as
g/µ in float32 (in the parameter dtype for bfloat16-parameter models).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, forward, init_params, lm_loss
from repro_torch.models.layers import dtype_of, tree_leaves
from repro_torch.train.optimizer import _map, make_optimizer

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0
    num_microbatches: int = 1
    remat: str = "nothing"
    aux_coef: float = 0.01       # MoE load-balance weight
    weight_decay: float = 0.1


def lr_schedule(tc: TrainConfig, step: Tensor) -> Tensor:
    """Linear warmup -> cosine decay to min_lr_frac (float32, on step's
    device)."""
    s = step.float()
    warm = s / max(1.0, tc.warmup_steps)
    prog = torch.clamp(
        (s - tc.warmup_steps) / max(1.0, tc.total_steps - tc.warmup_steps),
        0.0, 1.0,
    )
    cos = tc.min_lr_frac + (1 - tc.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return tc.lr * torch.clamp_max(warm, 1.0) * torch.where(
        s < tc.warmup_steps, 1.0, cos)


def _optimizer(tc: TrainConfig):
    return make_optimizer(
        tc.optimizer,
        **({"weight_decay": tc.weight_decay} if tc.optimizer == "adamw" else {}),
    )


def make_train_state(generator: torch.Generator, cfg: ModelConfig,
                     tc: TrainConfig, device="cuda") -> dict:
    """{"params", "opt", "step"} on ``device`` (the card by default), the
    parameters drawn from ``generator`` (on that device)."""
    dev = resolve_device(device)
    params = init_params(generator, cfg, device=dev)
    return {"params": params, "opt": _optimizer(tc).init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_train_state(cfg: ModelConfig, tc: TrainConfig) -> dict:
    """The train state's tree on the ``meta`` device: shapes and dtypes, no
    memory (what ``Checkpointer.restore`` fills)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():     # shapes and dtypes only: nothing is drawn
        fake = make_train_state(torch.Generator(), cfg, tc, device="cpu")

    return _map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)


def _loss_fn(cfg: ModelConfig, tc: TrainConfig, params, batch) -> tuple[Tensor, dict]:
    logits, aux = forward(
        cfg, params, batch["tokens"], batch.get("patches"), remat=tc.remat
    )
    labels = batch["labels"]
    if cfg.input_mode == "tokens+patches":
        # patch positions carry no next-token target
        pmask = torch.arange(labels.shape[1], device=labels.device) < cfg.num_patches
        labels = torch.where(pmask[None, :], -1, labels)
    loss = lm_loss(cfg, logits, labels)
    total = loss + tc.aux_coef * aux
    return total, {"loss": loss, "aux": aux}


def _global_norm(tree) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _grads(cfg, tc, params: dict, leaves: list, batch: dict):
    """(flat gradients, metrics) of one batch: the float32 gradient of the
    loss plus aux_coef x aux with respect to each parameter leaf."""
    for p in leaves:
        p.requires_grad_(True)
    try:
        total, metrics = _loss_fn(cfg, tc, params, batch)
        grads = torch.autograd.grad(total, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return list(grads), {k: v.detach() for k, v in metrics.items()}


def _unflatten(tree: dict, flat: list) -> dict:
    it = iter(flat)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}

    return walk(tree)


def make_train_step(cfg: ModelConfig, tc: TrainConfig) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics)."""
    opt = _optimizer(tc)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        leaves = list(tree_leaves(params))
        mu = tc.num_microbatches
        # The gradient buffers: float32 for float32-parameter models, the
        # parameter dtype for bf16 ones (the reference's production trade);
        # scaled by 1/µ before the sum.
        acc_dt = (torch.float32 if cfg.param_dtype == "float32"
                  else dtype_of(cfg.param_dtype))
        if mu == 1:
            grads, metrics = _grads(cfg, tc, params, leaves, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                     for p in leaves]
            msum = None
            for i in range(mu):
                mb = {k: v[i * (v.shape[0] // mu):(i + 1) * (v.shape[0] // mu)]
                      for k, v in batch.items()}
                g, m = _grads(cfg, tc, params, leaves, mb)
                for a, gg in zip(grads, g):
                    a.add_((gg.float() / mu).to(acc_dt))
                del g
                msum = m if msum is None else {k: msum[k] + m[k] for k in msum}
            metrics = {k: v / mu for k, v in msum.items()}

        with torch.no_grad():
            gnorm = _global_norm(_unflatten(params, grads))
            scale = torch.clamp_max(tc.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
            for i, g in enumerate(grads):
                if g.dtype == torch.float32:
                    g.mul_(scale)
                else:
                    grads[i] = (g.float() * scale).to(acc_dt)
            lr = lr_schedule(tc, state["step"])
            new_params, new_opt = opt.update(
                _unflatten(params, grads), state["opt"], params, lr, state["step"]
            )
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return (
            {"params": new_params, "opt": new_opt, "step": state["step"] + 1},
            metrics,
        )

    return train_step
