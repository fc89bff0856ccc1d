"""Error-feedback gradient compression over the pod axis: the counterpart
of ``repro/train/compress.py``.

Between pods the links are the slow ones, so the pod all-reduce of the
gradients is the collective worth compressing, with **error feedback and
per-block top-k sparsification**:

    m_t   = g_t + e_t                (add the carried compression error)
    c_t   = topk_blocks(m_t)         (keep the largest-|.| fraction per block)
    e_t+1 = m_t - c_t                (carry what was dropped)
    g~_t  = all_reduce(c_t, pod) / n_pods

The reference runs its step in a ``shard_map`` manual over ``pod`` only,
with GSPMD over (data, model) inside.  Here each rank runs the step on its
pod's (data, model) sub-mesh (``mesh["data", "model"]``): the state is
replicated over pods (each pod holds its shards of one copy), the batch's
rows are split over pods, the gradient is that of **the pod's own mean
loss** (not 1/n_pods of the global mean; the error state carries that
scale from step to step), and the compressed gradients and the metrics
cross the pod group explicitly.  Every pod then runs the same update.

Top-k is per fixed-size block of each leaf's flattened (global, row-major)
elements: a static selected count, a dense-with-zeros buffer.  The blocks
are the reference's: a shard made of whole blocks (the embedding with its
vocab over model, a weight whose split rows or columns are multiples of
the block) is compressed where it lies, any other sharded leaf is
gathered within its pod.  The density (nonzeros over size, summed over every leaf)
comes back as a metric.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.core.distributed import Collectives
from repro_torch.models.layers import tree_leaves
from repro_torch.models.sharding import (
    DATA,
    MODEL,
    POD,
    NamedSharding,
    data_spec,
    distribute,
    local_range,
    named,
    use_mesh,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    ratio: float = 0.05      # fraction of entries kept per block
    block: int = 1024


def topk_block_sparsify(x: Tensor, ratio: float, block: int) -> Tensor:
    """Keep the entries of every ``block`` chunk of the flattened tensor
    whose |value| reaches the chunk's k-th largest, k = max(1,
    int(ratio·block)) (ties past k are kept; the tail chunk is zero-padded),
    or, at n <= block, the whole tensor's k = max(1, int(ratio·n)); zero the
    rest.  Shape-preserving."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    if n <= block:
        k = max(1, int(ratio * n))
        thresh = torch.topk(flat.abs(), k).values[-1]
        return torch.where(flat.abs() >= thresh, flat, 0.0).reshape(x.shape)
    return _blocks(flat, ratio, block).reshape(x.shape)


def _blocks(flat: Tensor, ratio: float, block: int) -> Tensor:
    """The per-block rule over a flat run of whole blocks (the last one
    zero-padded)."""
    n = flat.shape[0]
    fp = F.pad(flat, (0, (-n) % block)).reshape(-1, block)
    k = max(1, int(ratio * block))
    kth = torch.topk(fp.abs(), k, dim=-1).values[:, -1:]
    return torch.where(fp.abs() >= kth, fp, 0.0).reshape(-1)[:n]


def init_error_state(params: dict) -> dict:
    """Zeros in float32, shaped and sharded as the parameters."""
    return {k: init_error_state(v) if isinstance(v, dict)
            else torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}


def _whole_blocks(m: DTensor, block: int) -> bool:
    """Whether this rank's shard, flattened, is a run of the leaf's own
    blocks: one dimension d split, and each rank's rows of d start and end
    on a block boundary of the flattened leaf (of each run of d's rows,
    when a dimension before d exceeds 1; then those runs are whole blocks
    too, else only the last shard may end on the padded tail)."""
    split = {q.dim for q in m.placements if isinstance(q, Shard)}
    if len(split) != 1 or m.numel() <= block:
        return False
    d = split.pop()
    lo, hi = local_range(m, d)
    inner = math.prod(m.shape[d + 1:])
    if math.prod(m.shape[:d]) == 1:
        return lo * inner % block == 0 and (hi * inner % block == 0
                                            or hi * inner == m.numel())
    return (m.shape[d] * inner % block == 0 and lo * inner % block == 0
            and hi * inner % block == 0)


def _pod_blocks(m: Tensor, cc: CompressConfig) -> tuple[Tensor, int, int]:
    """(the compressed leaf, its nonzeros, its size).  A DTensor leaf whose
    shard is a run of its whole blocks (:func:`_whole_blocks`) is
    compressed in place; any other is gathered in its pod, compressed whole
    and this rank's shard kept."""
    if not isinstance(m, DTensor):
        c = topk_block_sparsify(m, cc.ratio, cc.block)
        return c, int((c != 0).sum()), c.numel()
    if _whole_blocks(m, cc.block):
        local = m.to_local()
        c = DTensor.from_local(_blocks(local.reshape(-1), cc.ratio, cc.block)
                               .reshape(local.shape), m.device_mesh, m.placements,
                               run_check=False, shape=m.shape, stride=m.stride())
        return c, int((c != 0).sum().full_tensor()), m.numel()
    whole = topk_block_sparsify(m.full_tensor(), cc.ratio, cc.block)
    c = distribute(whole, NamedSharding(m.device_mesh, tuple(m.placements)))
    return c, int((whole != 0).sum()), whole.numel()


def compress_and_reduce(grads: list, error: list, cc: CompressConfig,
                        pods: Collectives) -> tuple[list, list, float]:
    """EF top-k and the mean all-reduce over the pod group of ``pods``:
    returns (reduced gradients, new errors, density), leaf by leaf over
    the flat lists."""
    reduced, new_err, nnz, tot = [], [], 0, 0
    for g, e in zip(grads, error):
        m = g.float() + e
        c, nz, size = _pod_blocks(m, cc)
        local = c.to_local() if isinstance(c, DTensor) else c
        summed = pods.all_reduce(local.contiguous(), "sum") / pods.size
        if isinstance(c, DTensor):
            summed = DTensor.from_local(summed, c.device_mesh, c.placements,
                                        run_check=False, shape=c.shape, stride=c.stride())
        reduced.append(summed)
        new_err.append(m - c)
        nnz, tot = nnz + nz, tot + size
    return reduced, new_err, nnz / tot


def compressed_state_shardings(mesh, cfg, tc, state_shape: dict) -> dict:
    """The compressed step's state shardings on this rank's pod sub-mesh:
    the train state's rules (no pod axis: replicated over pods) and the
    error state sharded as the parameters."""
    from repro_torch.train.trainer import state_spec_tree

    sub = mesh[DATA, MODEL]
    specs = state_spec_tree(cfg, tc, state_shape, sub)
    specs["error"] = specs["params"]
    return named(sub, specs)


def make_compressed_train_step(mesh, cfg, tc, cc: CompressConfig):
    """The pod-compressed counterpart of ``trainer.make_train_step`` over the
    (pod, data, model) ``DeviceMesh`` ``mesh``.

    The step takes and returns a state with an ``error`` field
    (``init_error_state``), distributed by ``compressed_state_shardings``
    (``distribute(state, shardings)``), and a batch of global tensors (the
    same on every rank): pod i takes rows [i b, (i + 1) b), b = B / n_pods.
    The gradient of the pod's mean loss is EF-compressed and reduced over
    pods, the metrics averaged over pods, and every pod applies the same
    clip and update, in place.  Metrics: ``loss``, ``aux``, ``grad_norm``,
    ``lr`` and ``compress_density`` (this pod's), 0-d tensors."""
    from repro_torch.train.trainer import _clip_and_update, _grads, _optimizer

    if POD not in mesh.mesh_dim_names:
        raise ValueError("the compressed step needs a pod axis")
    sub = mesh[DATA, MODEL]
    pods = Collectives(mesh, (POD,))
    opt = _optimizer(tc)

    def step(state: dict, batch: dict):
        params = state["params"]
        leaves = list(tree_leaves(params))
        rows = {k: v.shape[0] // pods.size for k, v in batch.items()}
        mine = {k: v[pods.index * rows[k]:(pods.index + 1) * rows[k]]
                for k, v in batch.items()}
        mine = {k: distribute(v, named(sub, data_spec(sub, tuple(v.shape))))
                for k, v in mine.items()}
        with use_mesh(sub):
            grads, metrics = _grads(cfg, tc, params, leaves, mine)
            with torch.no_grad():
                grads, err, density = compress_and_reduce(
                    grads, list(tree_leaves(state["error"])), cc, pods)
                metrics = {k: _pod_mean(v, pods) for k, v in metrics.items()}
                new, extra = _clip_and_update(opt, tc, state, grads, torch.float32)
        for e, ne in zip(tree_leaves(state["error"]), err):
            e.copy_(ne)
        new["error"] = state["error"]
        dev = new["step"].device
        out = dict(metrics, **extra, compress_density=torch.tensor(
            density, dtype=torch.float32, device=dev))
        return new, {k: v.full_tensor() if isinstance(v, DTensor) else v
                     for k, v in out.items()}

    step.mesh = sub
    return step


def _pod_mean(v: Tensor, pods: Collectives) -> Tensor:
    """A replicated 0-d metric averaged over the pods."""
    local = v.full_tensor() if isinstance(v, DTensor) else v
    return pods.all_reduce(local.reshape(1).float(), "sum")[0] / pods.size
