"""The port's hand-written CUDA kernels, each with its plain PyTorch version."""

from repro_torch.kernels._build import build, load_library
from repro_torch.kernels.feature_gains import feature_gains_kernel
from repro_torch.kernels.flash_attention import flash_attention_kernel, flash_route
from repro_torch.kernels.fl_divergence import (
    GainsPanel,
    fl_divergence_kernel,
    fl_gains_kernel,
    fl_gains_panel,
    takes_panel,
)
from repro_torch.kernels.fl_stream import (
    fl_stream_divergence_kernel,
    fl_stream_gains_kernel,
)
from repro_torch.kernels.ref import (
    attention_ref,
    attention_split_p_ref,
    feature_gains_ref,
    flash_attention_ref,
    fl_divergence_ref,
    fl_stream_divergence_ref,
    fl_stream_pair_ref,
    split_bf16,
    ss_divergence_ref,
)
from repro_torch.kernels.ss_weights import ss_divergence_kernel

__all__ = [
    "GainsPanel",
    "attention_ref",
    "attention_split_p_ref",
    "build",
    "feature_gains_kernel",
    "feature_gains_ref",
    "fl_divergence_kernel",
    "fl_divergence_ref",
    "fl_gains_kernel",
    "fl_gains_panel",
    "fl_stream_divergence_kernel",
    "fl_stream_divergence_ref",
    "fl_stream_gains_kernel",
    "fl_stream_pair_ref",
    "flash_attention_kernel",
    "flash_attention_ref",
    "flash_route",
    "load_library",
    "split_bf16",
    "ss_divergence_kernel",
    "ss_divergence_ref",
    "takes_panel",
]
