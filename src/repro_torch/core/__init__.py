"""Objectives, the submodularity graph, backends, SS, greedy (single-query,
batched and sharded over torch.distributed) and sieve streaming."""

from repro_torch.core.backend import (
    Backend,
    CudaBackend,
    ReferenceBackend,
    ShardedBackend,
    resolve_backend,
)
from repro_torch.core.distributed import (
    greedy_sharded,
    ss_sparsify_sharded,
    stochastic_greedy_sharded,
    summarize_sharded,
)
from repro_torch.core.functions import (
    NEG,
    FacilityLocation,
    FeatureCoverage,
    StreamingFacilityLocation,
    SubmodularFunction,
)
from repro_torch.core.graph import (
    check_triangle_inequality,
    divergence,
    divergence_compact,
    divergence_update,
    edge_weights,
    edge_weights_compact,
    full_edge_matrix,
)
from repro_torch.core.greedy import (
    GreedyResult,
    LazyGreedyResult,
    auto_sample_size,
    bidirectional_greedy,
    greedy,
    greedy_batched,
    lazy_greedy,
    selection_bucket,
    stochastic_greedy,
    stochastic_greedy_batched,
)
from repro_torch.core.sieve import (
    STREAM_PHIS,
    SieveResult,
    SieveState,
    StreamSieveState,
    sieve_best,
    sieve_extend,
    sieve_init,
    sieve_streaming,
    sieve_update,
    stream_sieve_best,
    stream_sieve_init,
    stream_sieve_update,
    threshold_grid,
)
from repro_torch.core.sparsify import (
    SSResult,
    bucket_schedule,
    max_rounds,
    postreduce,
    predicted_live_counts,
    preprune_mask,
    probe_count,
    ss_cost_model,
    ss_live_bound,
    ss_sparsify,
    ss_sparsify_batched,
    summarize,
)

__all__ = [
    "Backend", "CudaBackend", "FacilityLocation", "FeatureCoverage",
    "GreedyResult", "LazyGreedyResult", "NEG", "ReferenceBackend", "SSResult",
    "ShardedBackend", "greedy_sharded", "ss_sparsify_sharded",
    "stochastic_greedy_sharded", "summarize_sharded",
    "STREAM_PHIS", "SieveResult", "SieveState", "StreamSieveState",
    "StreamingFacilityLocation", "SubmodularFunction", "auto_sample_size",
    "bidirectional_greedy", "bucket_schedule", "check_triangle_inequality",
    "divergence", "divergence_compact", "divergence_update", "edge_weights",
    "edge_weights_compact", "full_edge_matrix", "greedy", "greedy_batched", "lazy_greedy",
    "max_rounds", "postreduce", "predicted_live_counts", "preprune_mask",
    "probe_count", "resolve_backend", "selection_bucket", "sieve_best",
    "sieve_extend", "sieve_init", "sieve_streaming", "sieve_update",
    "ss_cost_model", "ss_live_bound", "ss_sparsify", "ss_sparsify_batched",
    "stochastic_greedy", "stochastic_greedy_batched",
    "stream_sieve_best", "stream_sieve_init", "stream_sieve_update",
    "summarize", "threshold_grid",
]
