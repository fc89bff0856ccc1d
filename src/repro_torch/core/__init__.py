"""Objectives, the submodularity graph, backends, SS and greedy."""

from repro_torch.core.backend import (
    Backend,
    CudaBackend,
    ReferenceBackend,
    resolve_backend,
)
from repro_torch.core.functions import (
    NEG,
    FacilityLocation,
    FeatureCoverage,
    StreamingFacilityLocation,
    SubmodularFunction,
)
from repro_torch.core.graph import (
    divergence,
    divergence_compact,
    edge_weights,
    edge_weights_compact,
)
from repro_torch.core.greedy import GreedyResult, greedy, selection_bucket
from repro_torch.core.sparsify import (
    SSResult,
    bucket_schedule,
    max_rounds,
    predicted_live_counts,
    preprune_mask,
    probe_count,
    ss_cost_model,
    ss_live_bound,
    ss_sparsify,
    summarize,
)

__all__ = [
    "Backend", "CudaBackend", "FacilityLocation", "FeatureCoverage",
    "GreedyResult", "NEG", "ReferenceBackend", "SSResult",
    "StreamingFacilityLocation", "SubmodularFunction", "bucket_schedule",
    "divergence", "divergence_compact", "edge_weights", "edge_weights_compact",
    "greedy", "max_rounds", "predicted_live_counts", "preprune_mask",
    "probe_count", "resolve_backend", "selection_bucket", "ss_cost_model",
    "ss_live_bound", "ss_sparsify", "summarize",
]
