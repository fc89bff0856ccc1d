"""PyTorch / CUDA port of the pruned-submodularity-graph system.

The paper's main path, SS (Algorithm 1) then greedy on the pruned set V',
over FeatureCoverage, with its two hot spots as hand-written CUDA kernels
for Hopper.  The JAX package ``repro`` is the reference it is tested
against; this package imports nothing of it.
"""

from repro_torch.convert import feature_coverage_from_numpy
from repro_torch.core import (
    CudaBackend,
    FeatureCoverage,
    GreedyResult,
    ReferenceBackend,
    SSResult,
    greedy,
    resolve_backend,
    ss_sparsify,
    summarize,
)
from repro_torch.data import news_day

__all__ = [
    "CudaBackend", "FeatureCoverage", "GreedyResult", "ReferenceBackend",
    "SSResult", "feature_coverage_from_numpy", "greedy", "news_day",
    "resolve_backend", "ss_sparsify", "summarize",
]
