"""The training step: loss and gradients with microbatch accumulation, the
global-norm clip, the learning-rate schedule and the optimizer update; the
counterpart of ``repro/train/trainer.py``.  :func:`make_train_step` runs on
one device, or on a mesh through :func:`shard_train_step`: the same step
over DTensors, each rank holding its shards of the state by the rules of
``models/sharding.py``.

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
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, forward, init_params, lm_loss
from repro_torch.models.layers import dtype_of, tree_leaves
from repro_torch.models.sharding import (
    data_spec,
    distribute,
    named,
    param_spec_tree,
    redistribute,
    use_mesh,
)
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


def state_spec_tree(cfg: ModelConfig, tc: TrainConfig, state_shape: dict,
                    mesh) -> dict:
    """The train state's spec tree: the parameters' rules, the optimizer
    state's (AdamW's moments as their parameters, Adafactor's factors with
    one axis dropped), the step replicated."""
    pspecs = param_spec_tree(cfg, state_shape["params"], mesh)
    return {"params": pspecs,
            "opt": _optimizer(tc).state_spec_tree(pspecs, state_shape["params"]),
            "step": ()}


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
    # a DTensor gradient comes back as autograd left it (Partial over the
    # batch axes where its parameter is replicated): reduce it onto its
    # parameter's placements
    grads = [redistribute(g, p.placements) if isinstance(g, DTensor) else g
             for g, p in zip(grads, leaves)]
    return grads, {k: v.detach() for k, v in metrics.items()}


def _rows(x: Tensor, lo: int, hi: int) -> Tensor:
    """Rows [lo, hi) of the global batch: microbatch i is the global rows
    [i b, (i + 1) b), as the reference slices its sharded batch, not each
    rank's local rows cut µ ways.  A DTensor batch (small: token ids) is
    gathered and the rows redistributed over the batch axes."""
    if not isinstance(x, DTensor):
        return x[lo:hi]
    mesh = x.device_mesh
    rows = x.full_tensor()[lo:hi]
    return distribute(rows, named(mesh, data_spec(mesh, tuple(rows.shape))))


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
            grads = [torch.zeros_like(p, dtype=acc_dt) for p in leaves]
            msum = None
            for i in range(mu):
                mb = {k: _rows(v, i * (v.shape[0] // mu), (i + 1) * (v.shape[0] // mu))
                      for k, v in batch.items()}
                g, m = _grads(cfg, tc, params, leaves, mb)
                for a, gg in zip(grads, g):
                    a.add_((gg.float() / mu).to(acc_dt))
                del g
                msum = m if msum is None else {k: msum[k] + m[k] for k in msum}
            metrics = {k: v / mu for k, v in msum.items()}

        new, extra = _clip_and_update(opt, tc, state, grads, acc_dt)
        return new, dict(metrics, **extra)

    return train_step


@torch.no_grad()
def _clip_and_update(opt, tc: TrainConfig, state: dict, grads: list, acc_dt):
    """The global-norm clip of the flat ``grads`` (scaled in place where
    float32), the learning rate and the optimizer's in-place update:
    returns ({"params", "opt", "step"}, {"grad_norm", "lr"})."""
    params = state["params"]
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
    return ({"params": new_params, "opt": new_opt, "step": state["step"] + 1},
            {"grad_norm": gnorm, "lr": lr})


def shard_train_step(mesh, cfg: ModelConfig, tc: TrainConfig, state_shape: dict):
    """The train step over the ``DeviceMesh`` ``mesh`` (axes ``data`` and
    ``model``, and ``pod``), the counterpart of the reference's jitted step
    with explicit shardings.

    Returns (step, state shardings, batch sharding): ``state_shape`` is
    the state's tree (tensors or meta tensors); ``distribute(state,
    state_shardings)`` puts a state on the mesh (each rank its shards), and
    ``batch_sharding(leaf)`` is a batch leaf's ``NamedSharding`` (batch
    over pod x data).  ``step(state, batch)`` takes the distributed state
    and a batch of global tensors (the same on every rank) or DTensors, and
    updates the state in place (the reference donates it); its metrics are
    replicated 0-d tensors, local to each rank."""
    state_sh = named(mesh, state_spec_tree(cfg, tc, state_shape, mesh))
    inner = make_train_step(cfg, tc)

    def batch_sharding(leaf):
        return named(mesh, data_spec(mesh, tuple(leaf.shape)))

    def step(state: dict, batch: dict):
        batch = {k: v if isinstance(v, DTensor) else distribute(v, batch_sharding(v))
                 for k, v in batch.items()}
        with use_mesh(mesh):
            new, metrics = inner(state, batch)
        return new, {k: v.full_tensor() if isinstance(v, DTensor) else v
                     for k, v in metrics.items()}

    return step, state_sh, batch_sharding
