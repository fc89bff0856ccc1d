"""Meshes and the card's hardware constants: NVIDIA H100 SXM (80 GB HBM3)
cards, eight to a node.

The counterpart of ``repro/launch/mesh.py``.  :func:`make_mesh` names the
axes of a ``torch.distributed`` DeviceMesh over the ranks of an
initialised process group, which the sharded SS and greedy loops
(``repro_torch.core.distributed``), the sharded train step
(``repro_torch.train.shard_train_step``) and sharded prefill and decode
run over; :func:`make_production_mesh` is the reference's 16 x 16 and 2 x
16 x 16.  The dry run counts those on one host, over a fake process group
of 256 or 512 ranks (:func:`fake_group`), whose collectives move nothing.

``HW`` holds NVIDIA's published figures, none measured here:

- ``peak_flops_bf16``: bfloat16 products on the tensor cores, float32 sums,
  dense, at the card's 700 W limit (a card set lower runs slower under
  load);
- ``peak_flops_f32``: IEEE float32 FFMA (TF32 off), an FMA counted as two
  operations;
- ``fp32_instr_per_s``: other float32 instructions (add, max, min): one per
  lane per clock, 132 SMs x 128 lanes x 1.98 GHz;
- ``hbm_bw``: HBM3 bandwidth, bytes per second;
- ``hbm_per_chip``: bytes of HBM;
- ``nvlink_bw``: NVLink 4 between the cards of a node, 450e9 B/s each
  direction (900 GB/s bidirectional: the H100 SXM datasheet);
- ``internode_bw``: between nodes, one 400 Gb/s NDR InfiniBand port a card,
  50e9 B/s (NVIDIA DGX H100);
- ``gpus_per_node``: 8 (DGX H100), ranks numbered node-major: rank r sits
  in node r // 8.

The roofline prices a collective at ``nvlink_bw`` when its group's ranks
share one node and at ``internode_bw`` when they span more
(``launch/roofline.py``).
"""

from __future__ import annotations

import contextlib

HW = {
    "peak_flops_bf16": 989e12,
    "peak_flops_f32": 67e12,
    "fp32_instr_per_s": 33.5e12,
    "hbm_bw": 3.35e12,
    "hbm_per_chip": 80e9,
    "nvlink_bw": 450e9,
    "internode_bw": 50e9,
    "gpus_per_node": 8,
}

# The peak that bounds products of each operand dtype (``launch/cost.py``
# splits FLOPs by dtype).
PEAK_BY_DTYPE = {"bfloat16": "peak_flops_bf16", "float32": "peak_flops_f32"}


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """A DeviceMesh of ``shape`` with the axis names ``axes`` over the ranks
    of the default process group (row-major: the last axis is the
    innermost).  The caller initialises the group
    (``torch.distributed.init_process_group``); this raises without one.
    ``device_type`` is what the groups serve: "cuda" for NCCL, "cpu" for
    gloo (also where gloo ranks' tensors live on a card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: call "
                           "torch.distributed.init_process_group first")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


#: the reference's name for a small explicit mesh ((1, 1), (2, 2), (2, 1, 2))
make_test_mesh = make_mesh


def single_device_mesh(device_type: str = "cuda"):
    """The (1, 1) ("data", "model") mesh of a one-rank group."""
    return make_mesh((1, 1), ("data", "model"), device_type)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production meshes: (16, 16) on ("data", "model"),
    256 ranks, or (2, 16, 16) on ("pod", "data", "model"), 512, over the
    process group that is open (a real one, or :func:`fake_group`'s); raises
    without one, as :func:`make_mesh` does.  ``device_type`` "cuda" is what
    NCCL ranks serve, and decides DTensor's collectives (a "cpu" mesh
    replaces an all-to-all by an all-gather)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks in this one process,
    as rank 0 (the reference's dry run forces 512 host devices instead):
    meshes and their sub-groups build over it, and its collectives move
    nothing.  Destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_group: a process group is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def node_of(rank: int, hw: dict = HW) -> int:
    """The node of a global rank (ranks node-major)."""
    return rank // hw["gpus_per_node"]
