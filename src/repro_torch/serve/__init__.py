"""LM serving: batched prefill + decode (``Engine``), SS pruning of the KV
cache, and the summarization service (``SummarizeService``: lanes, the
sync and async schedulers, retry → failover → isolation, the watchdog and
the degradation ladder) over the batched core both run
(``summarize_batch``), and the durable multi-session streaming tier
(``SessionEngine``: row-sieve waves, SS compaction of each session's
buffer, a write-ahead log, snapshots, crash recovery and the eviction
ladder)."""

from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.faults import Fault, FaultEvent, FaultInjected, FaultPlan
from repro_torch.serve.kv_select import (
    KVSelectConfig,
    pooled_keys,
    prune_cache,
    select_positions,
    select_positions_batched,
)
from repro_torch.serve.sessions import (
    SessionConfig,
    SessionEngine,
    SessionState,
    SessionSummary,
)
from repro_torch.serve.summarize_service import (
    LADDER_STEPS,
    ChunkTimeout,
    DeadlineExceeded,
    MalformedResult,
    RunConfig,
    ServiceOverloaded,
    ServiceRestarted,
    SummarizeRequest,
    SummarizeResponse,
    SummarizeService,
    Ticket,
    TicketPending,
    batch_buckets,
    build_batch_objective,
    summarize_batch,
)
from repro_torch.serve.wal import (
    WALCorrupt,
    WALTruncated,
    WalRecord,
    WalScan,
    WalWriter,
    scan_wal,
)

__all__ = ["ChunkTimeout", "DeadlineExceeded", "Engine", "Fault", "FaultEvent",
           "FaultInjected", "FaultPlan", "KVSelectConfig", "LADDER_STEPS",
           "MalformedResult", "RunConfig", "ServeConfig",
           "ServiceOverloaded", "ServiceRestarted", "SessionConfig",
           "SessionEngine", "SessionState", "SessionSummary", "SummarizeRequest",
           "SummarizeResponse", "SummarizeService", "Ticket", "TicketPending",
           "batch_buckets", "build_batch_objective", "pooled_keys",
           "prune_cache", "select_positions", "select_positions_batched",
           "WALCorrupt", "WALTruncated", "WalRecord", "WalScan", "WalWriter",
           "scan_wal", "summarize_batch"]
