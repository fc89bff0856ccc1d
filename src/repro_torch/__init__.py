"""PyTorch / CUDA port of the pruned-submodularity-graph system.

The paper's main path, SS (Algorithm 1) then greedy on the pruned set V',
over FeatureCoverage and over facility location (dense, and matrix-free over
embedding rows), with their hot spots as hand-written CUDA kernels for
Hopper; the paper's other selectors (stochastic, lazy and bidirectional
greedy) and the §3.4 post-reduction run through the same kernels, and the
streaming baseline, sieve streaming, through a gain-table kernel of its
own.  Batched SS and greedy run B same-shape queries in one loop
(``repro_torch.serve.summarize_batch``), which also prunes an LM's KV
cache (``repro_torch.serve.kv_select``).  The summarization service
(``repro_torch.serve.SummarizeService``: lanes, the sync and async
schedulers, retry, failover, isolation, the watchdog and the degradation
ladder) serves queries through that core, behind the facade
``repro_torch.api``, with its own telemetry (``repro_torch.obs``); the
durable streaming tier (``repro_torch.serve.SessionEngine``: a live summary
per session through row-sieve waves and SS compaction, with a write-ahead
log, snapshots and crash recovery) sits behind the same facade.  The LMs
also train (``repro_torch.train``, ``repro_torch.data.Pipeline`` with SS
selecting each batch, ``launch/train.py``), with attention's gradient
through a hand-written backward kernel.  The JAX package ``repro`` is the
reference it is tested against; this package imports nothing of it.
"""

from repro_torch import api, obs
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
    ShardedBackend,
    STREAM_PHIS,
    SieveResult,
    SieveState,
    StreamSieveState,
    StreamingFacilityLocation,
    auto_sample_size,
    bidirectional_greedy,
    check_triangle_inequality,
    divergence_update,
    full_edge_matrix,
    greedy,
    greedy_batched,
    greedy_sharded,
    lazy_greedy,
    postreduce,
    resolve_backend,
    sieve_best,
    sieve_extend,
    sieve_init,
    sieve_streaming,
    sieve_update,
    ss_sparsify,
    ss_sparsify_batched,
    ss_sparsify_sharded,
    stochastic_greedy,
    stochastic_greedy_batched,
    stochastic_greedy_sharded,
    stream_sieve_best,
    stream_sieve_init,
    stream_sieve_update,
    summarize,
    summarize_sharded,
    threshold_grid,
)
from repro_torch.data import clustered_embeddings, news_day, video
from repro_torch.serve.sessions import SessionConfig, SessionEngine, SessionSummary

__all__ = [
    "CudaBackend", "FacilityLocation", "FeatureCoverage", "GreedyResult",
    "LazyGreedyResult", "ReferenceBackend", "SSResult", "STREAM_PHIS",
    "ShardedBackend",
    "SessionConfig", "SessionEngine", "SessionSummary",
    "SieveResult", "SieveState", "StreamSieveState",
    "StreamingFacilityLocation", "api", "auto_sample_size", "bidirectional_greedy",
    "check_triangle_inequality", "clustered_embeddings", "divergence_update",
    "facility_location_from_features", "facility_location_from_numpy",
    "feature_coverage_from_numpy", "full_edge_matrix", "greedy", "greedy_batched",
    "greedy_sharded", "lazy_greedy",
    "news_day", "obs", "postreduce", "resolve_backend", "sieve_best", "sieve_extend",
    "sieve_init", "sieve_streaming", "sieve_update", "ss_sparsify",
    "ss_sparsify_batched", "ss_sparsify_sharded", "stochastic_greedy",
    "stochastic_greedy_batched", "stochastic_greedy_sharded", "stream_sieve_best",
    "stream_sieve_init",
    "stream_sieve_update", "streaming_facility_location_from_numpy",
    "summarize", "summarize_sharded", "threshold_grid", "video",
]
