"""The port's hand-written CUDA kernels, each with its plain PyTorch version."""

from repro_torch.kernels._build import build, load_library
from repro_torch.kernels.feature_gains import feature_gains_kernel
from repro_torch.kernels.ref import feature_gains_ref, ss_divergence_ref
from repro_torch.kernels.ss_weights import ss_divergence_kernel

__all__ = [
    "build",
    "feature_gains_kernel",
    "feature_gains_ref",
    "load_library",
    "ss_divergence_kernel",
    "ss_divergence_ref",
]
