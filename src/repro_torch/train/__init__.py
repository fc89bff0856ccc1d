"""Training substrate: optimizers, the train step (on one device, or
sharded over a mesh: ``shard_train_step``), the pod-axis gradient
compression, checkpoints (elastic across meshes) and the preemption-safe
loop."""

from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.compress import (
    CompressConfig,
    compressed_state_shardings,
    init_error_state,
    make_compressed_train_step,
    topk_block_sparsify,
)
from repro_torch.train.optimizer import Adafactor, AdamW, make_optimizer
from repro_torch.train.runtime import (
    LoopReport,
    PreemptionGuard,
    StragglerGuard,
    resume_or_init,
    run,
)
from repro_torch.train.trainer import (
    TrainConfig,
    abstract_train_state,
    lr_schedule,
    make_train_state,
    make_train_step,
    shard_train_step,
    state_spec_tree,
)

__all__ = [
    "Adafactor", "AdamW", "Checkpointer", "CompressConfig", "LoopReport",
    "PreemptionGuard", "StragglerGuard", "TrainConfig", "abstract_train_state",
    "compressed_state_shardings", "init_error_state", "lr_schedule",
    "make_compressed_train_step", "make_optimizer", "make_train_state",
    "make_train_step", "resume_or_init", "run", "shard_train_step",
    "state_spec_tree", "topk_block_sparsify",
]
