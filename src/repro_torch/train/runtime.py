"""Fault-tolerance runtime: the preemption-safe training loop with periodic
and on-signal checkpoints, restart from the latest commit, and straggler
mitigation for the host-side data path; the counterpart of
``repro/train/runtime.py``.

* ``PreemptionGuard`` — a SIGTERM/SIGINT handler that flips a flag; the
  loop checkpoints and exits cleanly at the next step boundary.
* ``resume_or_init`` — idempotent start: restore the newest *committed*
  checkpoint if any (half-written ones are invisible by construction),
  otherwise initialise.
* ``StragglerGuard`` — wraps the data iterator with a deadline; a shard
  that misses it is *skipped* and the batch re-drawn from the next shard.
  Skips are counted and reported.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Iterator

from repro_torch.train.checkpoint import Checkpointer


class PreemptionGuard:
    """Flips ``should_stop`` on SIGTERM/SIGINT.  The context manager restores
    the previous handlers."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self.should_stop = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.should_stop = True

    def __enter__(self):
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False


class StragglerGuard:
    """Deadline-enforcing wrapper around a data iterator.

    ``next_fn()`` returns the next batch for the *current* shard;
    ``skip_fn()`` advances to the next shard.  If ``next_fn`` exceeds
    ``deadline_s``, the batch is dropped and re-drawn after ``skip_fn``.
    """

    def __init__(self, next_fn: Callable, skip_fn: Callable,
                 deadline_s: float = 30.0, max_skips: int = 16):
        self.next_fn = next_fn
        self.skip_fn = skip_fn
        self.deadline_s = deadline_s
        self.max_skips = max_skips
        self.skipped = 0

    def __call__(self):
        for _ in range(self.max_skips):
            t0 = time.monotonic()
            batch = self.next_fn()
            if time.monotonic() - t0 <= self.deadline_s:
                return batch
            self.skipped += 1
            self.skip_fn()
        raise TimeoutError(
            f"data path missed the {self.deadline_s}s deadline "
            f"{self.max_skips} times in a row"
        )


def resume_or_init(ckpt: Checkpointer, state_shape, init_fn: Callable,
                   device="cuda", shardings=None):
    """Restore the latest committed checkpoint onto ``device`` (and, with
    ``shardings``, onto their meshes) or build a fresh state; returns
    (state, step, resumed)."""
    if ckpt.latest_step() is not None:
        state, step = ckpt.restore(state_shape, device=device, shardings=shardings)
        return state, step, True
    return init_fn(), 0, False


@dataclasses.dataclass
class LoopReport:
    steps_done: int
    final_step: int
    preempted: bool
    straggler_skips: int
    metrics_history: list


def run(
    state,
    train_step: Callable,
    batches: Iterator | Callable,
    ckpt: Checkpointer,
    *,
    num_steps: int,
    start_step: int = 0,
    ckpt_every: int = 100,
    log_every: int = 10,
    log_fn: Callable = print,
    straggler: StragglerGuard | None = None,
) -> tuple[object, LoopReport]:
    """Preemption-safe training loop.  The metrics are read to the host only
    at the steps it logs."""
    next_batch = (
        straggler if straggler is not None
        else (batches if callable(batches) else lambda it=iter(batches): next(it))
    )
    history = []
    done = 0
    preempted = False
    with PreemptionGuard() as guard:
        for step in range(start_step, num_steps):
            batch = next_batch()
            state, metrics = train_step(state, batch)
            done += 1
            if log_every and (step % log_every == 0 or step == num_steps - 1):
                m = {k: float(v) for k, v in metrics.items()}
                history.append({"step": step, **m})
                log_fn(
                    f"step {step:6d} loss {m.get('loss', float('nan')):.4f} "
                    f"lr {m.get('lr', 0):.2e} gnorm {m.get('grad_norm', 0):.3f}"
                )
            stop = guard.should_stop
            if ckpt_every and ((step + 1) % ckpt_every == 0 or stop):
                ckpt.save_async(step + 1, state)
            if stop:
                preempted = True
                break
    ckpt.wait()
    final = start_step + done
    if preempted or (ckpt_every and final % ckpt_every != 0):
        ckpt.save(final, state)
    return state, LoopReport(
        steps_done=done,
        final_step=final,
        preempted=preempted,
        straggler_skips=straggler.skipped if straggler else 0,
        metrics_history=history,
    )
