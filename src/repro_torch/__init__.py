"""PyTorch / CUDA port of the pruned-submodularity-graph system.

The paper's main path, SS (Algorithm 1) then greedy on the pruned set V',
over FeatureCoverage and over facility location (dense, and matrix-free over
embedding rows), with their hot spots as hand-written CUDA kernels for
Hopper; the paper's other selectors (stochastic, lazy and bidirectional
greedy) and the §3.4 post-reduction run through the same kernels.  The JAX package ``repro`` is the reference it is tested against;
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
    LazyGreedyResult,
    ReferenceBackend,
    SSResult,
    StreamingFacilityLocation,
    auto_sample_size,
    bidirectional_greedy,
    check_triangle_inequality,
    divergence_update,
    full_edge_matrix,
    greedy,
    lazy_greedy,
    postreduce,
    resolve_backend,
    ss_sparsify,
    stochastic_greedy,
    summarize,
)
from repro_torch.data import clustered_embeddings, news_day, video

__all__ = [
    "CudaBackend", "FacilityLocation", "FeatureCoverage", "GreedyResult",
    "LazyGreedyResult", "ReferenceBackend", "SSResult",
    "StreamingFacilityLocation", "auto_sample_size", "bidirectional_greedy",
    "check_triangle_inequality", "clustered_embeddings", "divergence_update",
    "facility_location_from_features", "facility_location_from_numpy",
    "feature_coverage_from_numpy", "full_edge_matrix", "greedy", "lazy_greedy",
    "news_day", "postreduce", "resolve_backend", "ss_sparsify",
    "stochastic_greedy", "streaming_facility_location_from_numpy", "summarize",
    "video",
]
