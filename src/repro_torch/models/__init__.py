"""Config-driven decoder-only LMs, the counterpart of ``repro.models``: dense
GQA (``attn``, ``local``), mixture of experts (``attn_moe``, ``moe.py``),
Mamba2 SSD (``mamba2``, ``ssm.py``) and the RG-LRU hybrid (``rglru``,
``rglru.py``).  Prefill runs attention through the flash kernel; decode
runs against a static KV cache and O(1) recurrent states.  ``sharding``
holds the layouts' partition specs and their DTensor placements."""

from repro_torch.models.config import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    cell_supported,
    is_subquadratic,
)
from repro_torch.models.decoder import (
    abstract_cache,
    abstract_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    lm_loss,
    prefill,
)
from repro_torch.models.sharding import (
    cache_spec_tree,
    data_spec,
    named,
    param_spec_tree,
)

__all__ = [
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "cell_supported",
    "is_subquadratic",
    "abstract_cache",
    "abstract_params",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "lm_loss",
    "prefill",
    "cache_spec_tree",
    "data_spec",
    "named",
    "param_spec_tree",
]
