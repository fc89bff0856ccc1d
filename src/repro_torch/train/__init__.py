"""Training substrate on one device: optimizers, the train step,
checkpoints and the preemption-safe loop.  (The JAX package's sharding
names, ``shard_train_step`` and ``state_spec_tree``, and its pod-axis
gradient compression are not ported.)"""

from repro_torch.train.checkpoint import Checkpointer
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
)

__all__ = [
    "Adafactor", "AdamW", "Checkpointer", "LoopReport", "PreemptionGuard",
    "StragglerGuard", "TrainConfig", "abstract_train_state", "lr_schedule",
    "make_optimizer", "make_train_state", "make_train_step", "resume_or_init",
    "run",
]
