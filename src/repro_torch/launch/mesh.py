"""The card's hardware constants: one NVIDIA H100 SXM (80 GB HBM3).

The counterpart of ``repro/launch/mesh.py``'s ``HW``, which holds a TPU
v5e chip's constants for the roofline.  The port runs on one card, so this
module has no mesh: the production meshes (16 x 16 chips and 2 x 16 x 16)
come with the sharding slice (``torch.distributed``), which is still to
port.  On one card the collective term of the roofline is 0.

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
