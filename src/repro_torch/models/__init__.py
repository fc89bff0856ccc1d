"""Config-driven decoder-only LMs, the counterpart of ``repro.models`` for the
dense attention blocks (``attn``, ``local``): prefill through the flash
kernel, decode against a static KV cache."""

from repro_torch.models.config import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    cell_supported,
    is_subquadratic,
)
from repro_torch.models.decoder import (
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)

__all__ = [
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "cell_supported",
    "is_subquadratic",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "prefill",
]
