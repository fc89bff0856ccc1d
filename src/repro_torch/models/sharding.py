"""Partition-spec rules for the LM layouts, and their DTensor placements:
the counterpart of ``repro/models/sharding.py``.

A *spec* is a tuple with one entry per tensor dimension, as a JAX
``PartitionSpec`` is: ``None`` (replicated), a mesh axis name, or a tuple of
names (one dimension sharded over several mesh axes, the first the major).
Specs are computed from a mesh's axis names and sizes alone: ``mesh`` is a
``torch.distributed`` ``DeviceMesh`` or a :class:`MeshShape`, which needs
no process group (the production meshes, 16 x 16 and 2 x 16 x 16, are
pinned that way).  :func:`placements` turns a spec into DTensor placements
on a ``DeviceMesh``: a tuple entry ``(pod, data)`` puts ``Shard(i)`` on
both mesh dimensions, split pod-major, as GSPMD splits it.

2-D sharding, as in the reference: ``model`` carries tensor parallelism
(attention heads, FFN hidden, experts, vocab), ``data`` carries FSDP (the
other matrix dimension of every weight and the batch of every
activation), and ``pod`` is pure data parallelism (weights replicated over
pods, gradients reduced over them, with optional compression:
``repro_torch.train.compress``).

The model code pins activations with :func:`constrain` at the reference's
points.  It reads the ambient mesh that :func:`use_mesh` sets; with none,
or on a tensor that is not a DTensor, it is a no-op, so the one-device
paths are unchanged.  On a DTensor it is a ``redistribute`` to the fitted
spec's placements (the counterpart of ``with_sharding_constraint``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor

DATA, MODEL, POD = "data", "model", "pod"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis sizes and names, without devices or a process group
    (the reference's ``AbstractMesh``)."""
    shape: tuple
    axis_names: tuple


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshShape`."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _spec_axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(_axis_size(mesh, a) for a in axes)


def fit_spec(spec: tuple, shape: tuple, mesh) -> tuple:
    """Drop spec axes whose mesh size does not divide the dimension (the
    dimension is then replicated: parameters never shard unevenly), and
    axes absent from the mesh (single pod against multi-pod)."""
    names = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = tuple(a for a in (entry if isinstance(entry, tuple) else (entry,))
                     if a in names)
        if not axes:
            out.append(None)
            continue
        entry2 = axes if len(axes) > 1 else axes[0]
        if i < len(shape) and shape[i] % _spec_axis_size(mesh, entry2) == 0:
            out.append(entry2)
        else:
            out.append(None)
    return tuple(out)


# name -> spec of the *unstacked* parameter
_PARAM_RULES: dict[str, tuple] = {
    # embeddings
    "tok": (None, MODEL, DATA),           # (K, V, D)
    "unembed": (None, DATA, MODEL),       # (K, D, V)
    # norms / small vectors: replicated
    "scale": (),
    "q_norm": (), "k_norm": (),
    "A_log": (), "dt_bias": (), "D": (), "norm": (), "lam": (),
    "gate_a_w": (), "gate_a_b": (), "gate_i_w": (), "gate_i_b": (),
    "conv_w": (), "conv_b": (),
    # attention
    "w_q": (DATA, MODEL), "w_k": (DATA, MODEL), "w_v": (DATA, MODEL),
    "w_o": (MODEL, DATA),
    "b_q": (MODEL,), "b_k": (MODEL,), "b_v": (MODEL,),
    # dense FFN / shared expert
    "w_gate": (DATA, MODEL), "w_up": (DATA, MODEL), "w_down": (MODEL, DATA),
    # moe (the expert banks are matched by name and rank below)
    "router": (DATA, None),
    # mamba2
    "w_in_zx": (DATA, MODEL), "w_in_bc": (DATA, None),
    "w_in_dt": (DATA, MODEL),
    "w_out": (MODEL, DATA),
    # rglru
    "w_y": (DATA, MODEL), "w_x": (DATA, MODEL),
}

# expert banks: (E, D, F) / (E, F, D): experts over MODEL, D over DATA
_EXPERT_RULES = {
    "w_gate": (MODEL, DATA, None),
    "w_up": (MODEL, DATA, None),
    "w_down": (MODEL, None, DATA),
}


def _map_with_path(fn, tree: dict, path: tuple = ()) -> dict:
    return {k: _map_with_path(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def param_spec_tree(cfg: ModelConfig, params_shape: dict, mesh) -> dict:
    """The spec tree parallel to the parameters' tree (tensors, meta
    tensors or arrays: only shapes are read), fitted to ``mesh``
    (non-dividing dimensions fall back to replication, e.g. mamba2's 50280
    vocab on a 16-way model axis)."""

    def spec_for(keys, leaf) -> tuple:
        name = keys[-1]
        ndim = len(leaf.shape)
        stacked = keys[0] == "blocks"
        if "moe" in keys and "shared" not in keys and name in _EXPERT_RULES \
                and ndim >= 3:
            spec = _EXPERT_RULES[name]
        elif name in _PARAM_RULES:
            spec = _PARAM_RULES[name]
        else:
            raise KeyError(f"no sharding rule for param {'/'.join(keys)}")
        if ndim != len(spec) + stacked:
            return (None,) * ndim             # rank mismatch: replicate
        if stacked:
            spec = (None, *spec)
        return fit_spec(spec, tuple(leaf.shape), mesh)

    return _map_with_path(spec_for, params_shape)


def batch_axes(mesh) -> tuple:
    """The composite mesh axes that shard the global batch."""
    return (POD, DATA) if POD in axis_sizes(mesh) else (DATA,)


def data_spec(mesh, shape_or_ndim) -> tuple:
    """Spec of a (B, ...) data array: batch over pod x data, replicated
    where B does not divide the batch axes (e.g. long_500k's B = 1)."""
    if isinstance(shape_or_ndim, int):
        return (batch_axes(mesh),) + (None,) * (shape_or_ndim - 1)
    shape = tuple(shape_or_ndim)
    return fit_spec((batch_axes(mesh),) + (None,) * (len(shape) - 1), shape, mesh)


def cache_spec_tree(cfg: ModelConfig, cache_shape: dict, mesh) -> dict:
    """KV / recurrent cache specs: batch over (pod, data); the head axis
    over model where it divides, else head_dim over model, else
    replicated."""
    baxes = batch_axes(mesh)
    msize = _axis_size(mesh, MODEL)

    def spec_for(keys, leaf) -> tuple:
        name = keys[-1]
        lead = (None,) if keys[0] == "blocks" else ()
        if name in ("k", "v"):      # (B, L, KV, hd)
            kv, hd = leaf.shape[-2], leaf.shape[-1]
            if kv % msize == 0:
                spec = (baxes, None, MODEL, None)
            elif hd % msize == 0:
                spec = (baxes, None, None, MODEL)
            else:
                spec = (baxes, None, None, None)
        elif name == "ssm":          # (B, H, P, N)
            spec = (baxes, MODEL, None, None)
        elif name == "conv":         # (B, W-1, C)
            spec = (baxes, None, None)
        elif name == "h":            # (B, dr)
            spec = (baxes, MODEL)
        else:
            raise KeyError(f"no cache rule for {'/'.join(keys)}")
        return fit_spec((*lead, *spec), tuple(leaf.shape), mesh)

    return _map_with_path(spec_for, cache_shape)


def placements(mesh, spec: tuple) -> tuple:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    one per mesh dimension, ``Shard(i)`` where dimension i's entry names
    it, else ``Replicate()``."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        dims = [names.index(a) for a in (entry if isinstance(entry, tuple) else (entry,))]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} must name mesh axes in the "
                             f"mesh's order {names}")
        for d in dims:
            out[d] = Shard(i)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's mesh and placements (the reference's ``NamedSharding``)."""
    mesh: object
    placements: tuple


def named(mesh, spec_tree):
    """The ``NamedSharding`` tree of a spec tree (a dict of specs, or one
    spec) on the ``DeviceMesh`` ``mesh``."""
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    return NamedSharding(mesh, placements(mesh, spec_tree))


def distribute(tree, shardings):
    """Each leaf of ``tree`` (a tensor, the same on every rank) as a DTensor
    with its ``NamedSharding`` (a parallel tree, or one for a single
    tensor): every rank keeps its own shard of its own copy, so nothing
    crosses ranks (``jax.device_put``'s counterpart)."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    out = distribute_tensor(tree, shardings.mesh, shardings.placements,
                            src_data_rank=None)
    local = out.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        # the shard is a view of the whole leaf: own it, so that the whole
        # is freed with the caller's copy
        out = DTensor.from_local(local.clone(), shardings.mesh, shardings.placements,
                                 run_check=False, shape=out.shape, stride=out.stride())
    return out


# ---------------------------------------------------------------------------
# the ambient mesh and the pinning points
# ---------------------------------------------------------------------------

_AMBIENT: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh of :func:`constrain` (process-wide,
    so a checkpointed region recomputed in autograd's thread sees it too);
    with DTensor's implicit replication, so a plain tensor (positions,
    masks) meets a DTensor as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    _AMBIENT.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh():
    """The ambient mesh, or None."""
    return _AMBIENT[-1] if _AMBIENT else None


def redistribute(x: DTensor, pl: tuple) -> DTensor:
    return x if tuple(x.placements) == tuple(pl) else x.redistribute(x.device_mesh, pl)


def constrain(x, *entries):
    """Pin ``x``'s sharding against the ambient mesh, with absent and
    non-dividing axes dropped (:func:`fit_spec`): a ``redistribute`` of a
    DTensor, a no-op with no mesh or on a plain tensor.  This is how the
    model pins activations (batch over pod x data, vocab / heads / hidden
    over model) without naming a mesh."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    # the ambient mesh's axes: inside the compressed step's pod region it is
    # the (data, model) sub-mesh, so ``pod`` is bound, as under the
    # reference's manual ``shard_map``
    ok = axis_sizes(mesh)
    cleaned = []
    for e in entries:
        axes = () if e is None else tuple(
            a for a in (e if isinstance(e, tuple) else (e,)) if a in ok)
        cleaned.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return redistribute(x, placements(x.device_mesh, fit_spec(tuple(cleaned),
                                                                tuple(x.shape), mesh)))


def local_range(x: DTensor, dim: int) -> tuple[int, int]:
    """[start, stop) of this rank's block of ``x``'s dimension ``dim`` (the
    ceiling-first chunks of ``torch.chunk``, GSPMD's split of an uneven
    dimension), over every mesh dimension that shards it."""
    mesh = x.device_mesh
    start, size = 0, x.shape[dim]
    for d, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n = mesh.size(d)
            chunk = -(-size // n)
            lo = min(chunk * mesh.get_local_rank(d), size)
            start, size = start + lo, min(chunk, size - lo)
    return start, start + size


def local_region(fn, args: tuple, outs, grads: tuple | None = None):
    """``fn`` on the local shards of ``args`` (DTensors, or anything
    else passed as it is), its outputs made DTensors again: ``outs`` gives
    each output's (placements, global shape), one pair for a single tensor
    or a list of pairs for a tuple.  ``grads`` gives each argument's
    gradient placements where they differ from its own (an input
    replicated over a mesh dimension that the region's work is split over
    gets a gradient Partial there: each rank's share).  The counterpart of
    a ``shard_map`` body, and of ``local_map``, which infers each output's
    global shape as if its shards were even (a rank with no heads of 6
    over 4 holds 0).  ``to_local`` and ``from_local`` carry the gradients
    across."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    grads = grads or (None,) * len(args)
    res = fn(*(a.to_local(grad_placements=g) if isinstance(a, DTensor) else a
               for a, g in zip(args, grads)))
    single = not isinstance(outs, list)
    pairs = [outs] if single else outs
    res = (res,) if single else res

    out = tuple(_from_shard(t, mesh, pl, shape) for t, (pl, shape) in zip(res, pairs))
    return out[0] if single else out


def _from_shard(local: Tensor, mesh, pl: tuple, shape) -> DTensor:
    """``local``, this rank's shard, as a DTensor of global ``shape``
    (contiguous strides) with placements ``pl``: no check, no collective."""
    shape = torch.Size(shape)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                              stride=tuple(stride))


def shard_on(make, mesh, pl: tuple, shape) -> DTensor:
    """A DTensor of global ``shape`` with placements ``pl`` on ``mesh``
    whose local shard is ``make(local_shape)``, this rank's shape as
    ``torch.chunk`` splits (``distribute``'s result with no global tensor
    and no collective)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    local, _ = compute_local_shape_and_global_offset(tuple(shape), mesh, pl)
    return _from_shard(make(local), mesh, pl, shape)


def zeros_on(mesh, spec: tuple, shape: tuple, dtype: torch.dtype, device) -> DTensor:
    """A zero DTensor of global ``shape`` with ``spec``'s placements on the
    ``DeviceMesh`` ``mesh``: each rank allocates its own shard only (the
    counterpart of a jitted ``zeros`` with an out sharding)."""
    return shard_on(lambda local: torch.zeros(local, dtype=dtype, device=device), mesh,
                    placements(mesh, spec), shape)


def local_write(dst, src, write) -> None:
    """``write(dst, src)``, an in-place write of ``src`` into ``dst`` (a
    slice assignment, a ``copy_``), on each rank's shard where ``dst`` is a
    DTensor: ``src`` is brought to ``dst``'s split with as little traffic
    as the two allow (a dimension that ``src`` holds whole is narrowed to
    ``dst``'s block on the rank, no collective; a Partial sum is reduced; a
    split that ``dst`` lacks is gathered), then written into the local
    shard, so no write gathers ``dst``.  Dimensions that ``write`` indexes
    (the cache's positions) are split by neither.  Plain tensors: ``write``
    as it is."""
    if not isinstance(dst, DTensor):
        write(dst, src)
        return
    if isinstance(src, DTensor):
        src = redistribute(src, tuple(
            s if s == d or isinstance(s, Replicate) else Replicate()
            for s, d in zip(src.placements, dst.placements)))
        local = src.to_local()
    else:
        local = src
    for dim in range(dst.ndim):
        if not any(isinstance(p, Shard) and p.dim == dim for p in dst.placements):
            continue
        lo, hi = local_range(dst, dim)
        slo, shi = local_range(src, dim) if isinstance(src, DTensor) else (0, src.shape[dim])
        if (lo, hi) != (slo, shi):
            local = local.narrow(dim, lo - slo, hi - lo)
    write(dst.to_local(), local)


def vocab_lookup(table: Tensor, ids: Tensor, dtype: torch.dtype) -> Tensor:
    """``table[ids]`` cast to ``dtype`` (the gather first, as the one-device
    path: its gradient sums repeated ids in the table's dtype).  Of a (V, D)
    DTensor table with the vocab over model and D over data: the ids are
    gathered (small), each rank looks up every id inside its vocab block in
    its own block of D (a fitted spec splits both evenly) and zeros the rest
    (a local region); the output is Partial over the vocab's mesh
    dimensions (each row's one nonzero term) and split over D, so the table
    never moves (FSDP's unshard of the table would gather it whole)."""
    from torch.distributed.tensor import Partial

    if not isinstance(table, DTensor):
        return table[ids].to(dtype)
    mesh = table.device_mesh
    ids = redistribute(ids, (Replicate(),) * mesh.ndim)
    out_pl = tuple(Partial() if isinstance(p, Shard) and p.dim == 0
                   else Shard(ids.ndim) if isinstance(p, Shard) else Replicate()
                   for p in table.placements)
    lo, hi = local_range(table, 0)

    def body(w, t):
        if (lo, hi) == (0, table.shape[0]):     # the whole vocab: the plain gather
            return w[t]
        inside = (t >= lo) & (t < hi)
        return torch.where(inside[..., None], w[torch.where(inside, t - lo, 0)], 0.0)

    return local_region(body, (table, ids),
                        (out_pl, tuple(ids.shape) + tuple(table.shape[1:]))).to(dtype)
