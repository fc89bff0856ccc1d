"""The card's hardware constants: one NVIDIA H100 SXM (80 GB HBM3).

The counterpart of ``repro/launch/mesh.py``'s ``HW``, which holds a TPU
v5e chip's constants for the roofline, and of its ``make_test_mesh`` and
``single_device_mesh``: :func:`make_mesh` names the axes of a
``torch.distributed`` DeviceMesh over the ranks of an initialised process
group, which the sharded SS and greedy loops
(``repro_torch.core.distributed``) and the sharded train step
(``repro_torch.train.shard_train_step``) run over.  The production meshes
of the LM layouts (16 x 16 and 2 x 16 x 16) are pinned as shapes
(``models.sharding.MeshShape``) for their spec trees; a process group of
their size, and with it the collective term of the roofline, is still to
come (``make_production_mesh``).  On one card that term is 0.

``HW`` holds NVIDIA's published dense peaks of the H100 SXM at its 700 W
limit (a card set to a lower limit runs slower under load):

- ``peak_flops_bf16``: bfloat16 products on the tensor cores, float32 sums;
- ``peak_flops_f32``: IEEE float32 FFMA (TF32 off), an FMA counted as two
  operations;
- ``fp32_instr_per_s``: other float32 instructions (add, max, min): one per
  lane per clock, 132 SMs x 128 lanes x 1.98 GHz;
- ``hbm_bw``: HBM3 bandwidth, bytes per second;
- ``hbm_per_chip``: bytes of HBM.
"""

from __future__ import annotations

HW = {
    "peak_flops_bf16": 989e12,
    "peak_flops_f32": 67e12,
    "fp32_instr_per_s": 33.5e12,
    "hbm_bw": 3.35e12,
    "hbm_per_chip": 80e9,
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
