"""PyTorch / CUDA port of the pruned-submodularity-graph system.

The paper's main path, SS (Algorithm 1) then greedy on the pruned set V',
over FeatureCoverage and over facility location (dense, and matrix-free over
embedding rows), with their hot spots as hand-written CUDA kernels for
Hopper.  The JAX package ``repro`` is the reference it is tested against;
this package imports nothing of it.
"""

from repro_torch.convert import (
    facility_location_from_features,
    facility_location_from_numpy,
    feature_coverage_from_numpy,
    streaming_facility_location_from_numpy,
)
from repro_torch.core import (
    CudaBackend,
    FacilityLocation,
    FeatureCoverage,
    GreedyResult,
    ReferenceBackend,
    SSResult,
    StreamingFacilityLocation,
    greedy,
    resolve_backend,
    ss_sparsify,
    summarize,
)
from repro_torch.data import clustered_embeddings, news_day, video

__all__ = [
    "CudaBackend", "FacilityLocation", "FeatureCoverage", "GreedyResult",
    "ReferenceBackend", "SSResult", "StreamingFacilityLocation",
    "clustered_embeddings", "facility_location_from_features",
    "facility_location_from_numpy", "feature_coverage_from_numpy", "greedy",
    "news_day", "resolve_backend", "ss_sparsify",
    "streaming_facility_location_from_numpy", "summarize", "video",
]
