"""LM serving: batched prefill + decode (``Engine``), SS pruning of the KV
cache, and the summarization core that both this and batched queries run
(``summarize_batch``)."""

from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.kv_select import (
    KVSelectConfig,
    pooled_keys,
    prune_cache,
    select_positions,
    select_positions_batched,
)
from repro_torch.serve.summarize_service import (
    RunConfig,
    SummarizeRequest,
    batch_buckets,
    build_batch_objective,
    summarize_batch,
)

__all__ = ["Engine", "KVSelectConfig", "RunConfig", "ServeConfig",
           "SummarizeRequest", "batch_buckets", "build_batch_objective",
           "pooled_keys", "prune_cache", "select_positions",
           "select_positions_batched", "summarize_batch"]
