"""The port's checkpoints and preemption-safe loop on the CPU: atomicity,
GC and the restore guards; float32 train states that cross between the
two packages in both directions (the same directory format and leaf
names); ``save_async`` against the optimizer's in-place update; and a run
preempted by SIGTERM, resumed, ending bit for bit where an uninterrupted
run ends."""

import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.train import Checkpointer as JCheckpointer
from repro.train import TrainConfig as JTrainConfig
from repro.train import abstract_train_state as jabstract_train_state
from repro.train import make_train_state as jmake_train_state
from repro_torch import configs
from repro_torch.data import DataConfig, Pipeline
from repro_torch.train import (
    Checkpointer,
    TrainConfig,
    abstract_train_state,
    make_train_state,
    make_train_step,
    resume_or_init,
    run,
)
from repro_torch.train.checkpoint import _flatten_with_names

ARCH = "llama3.2-3b"


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _state(tc=None, seed=0):
    return make_train_state(torch.Generator().manual_seed(seed), configs.smoke(ARCH),
                            tc or TrainConfig(), device="cpu")


def _named(state):
    names, leaves = _flatten_with_names(state)
    return dict(zip(names, leaves))


def _same(a, b):
    na, nb = _named(a), _named(b)
    assert na.keys() == nb.keys()
    for key in na:
        assert na[key].dtype == nb[key].dtype and na[key].shape == nb[key].shape, key
        assert torch.equal(na[key], nb[key]), key


def test_atomicity_gc_and_guards(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    st = _state()
    for step in (1, 2, 3):
        ck.save(step, st)
    assert ck.all_steps() == [2, 3]
    # a half-written save (no COMMIT) and a stray temp dir are invisible
    shutil.copytree(tmp_path / "step_0000000003", tmp_path / "step_0000000009")
    os.remove(tmp_path / "step_0000000009" / "COMMIT")
    os.makedirs(tmp_path / "tmp.10")
    assert ck.latest_step() == 3
    restored, step = ck.restore(abstract_train_state(configs.smoke(ARCH), TrainConfig()),
                                device="cpu")
    assert step == 3 and restored["step"].dim() == 0
    _same(restored, st)
    # the guards: a shape that does not match, a missing leaf, no checkpoint
    bad = abstract_train_state(configs.smoke(ARCH), TrainConfig())
    bad["params"]["final_norm"]["scale"] = torch.empty(7, device="meta")
    with pytest.raises(ValueError, match="shape"):
        ck.restore(bad, device="cpu")
    more = abstract_train_state(configs.smoke(ARCH), TrainConfig())
    more["extra"] = torch.empty(3, device="meta")
    with pytest.raises(KeyError):
        ck.restore(more, device="cpu")
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(bad, device="cpu")


def test_restore_casts_to_the_target_dtype(tmp_path):
    ck = Checkpointer(str(tmp_path))
    st = {"w": torch.randn(4, 3, generator=torch.Generator().manual_seed(1)),
          "h": torch.randn(5).bfloat16(), "step": torch.tensor(7, dtype=torch.int32)}
    ck.save(1, st)
    target = {"w": torch.empty(4, 3, dtype=torch.bfloat16, device="meta"),
              "h": torch.empty(5, dtype=torch.bfloat16, device="meta"),
              "step": torch.empty((), dtype=torch.int32, device="meta")}
    got, _ = ck.restore(target, device="cpu")
    assert torch.equal(got["w"], st["w"].bfloat16())
    assert torch.equal(got["h"], st["h"]) and int(got["step"]) == 7


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_a_jax_train_state_restores_in_the_port(tmp_path, optimizer):
    jcfg = jconfigs.smoke(ARCH)
    jtc = JTrainConfig(optimizer=optimizer)
    jstate = jmake_train_state(jax.random.PRNGKey(3), jcfg, jtc)
    jstate["step"] = jnp.int32(5)
    JCheckpointer(str(tmp_path)).save(5, jstate)
    got, step = Checkpointer(str(tmp_path)).restore(
        abstract_train_state(configs.smoke(ARCH), TrainConfig(optimizer=optimizer)),
        device="cpu")
    assert step == 5
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    named = _named(got)
    assert sorted(named) == sorted(want)
    for key, arr in want.items():
        assert named[key].numpy().dtype == arr.dtype
        assert np.array_equal(named[key].numpy(), arr), key


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_a_port_train_state_restores_in_jax(tmp_path, optimizer):
    tc = TrainConfig(optimizer=optimizer)
    st = _state(tc, seed=4)
    st["step"] = torch.tensor(6, dtype=torch.int32)
    Checkpointer(str(tmp_path)).save(6, st)
    jshape = jabstract_train_state(jconfigs.smoke(ARCH), JTrainConfig(optimizer=optimizer))
    got, step = JCheckpointer(str(tmp_path)).restore(jshape)
    assert step == 6
    named = _named(st)
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert sorted(jax.tree_util.keystr(p) for p, _ in flat) == sorted(named)
    for path, arr in flat:
        assert np.array_equal(np.asarray(arr), named[jax.tree_util.keystr(path)].numpy())


def test_save_async_writes_the_values_before_an_in_place_update(tmp_path):
    ck = Checkpointer(str(tmp_path))
    st = _state()
    before = {k: v.clone() for k, v in _named(st).items()}
    ck.save_async(1, st)
    for leaf in _named(st).values():          # the next step's in-place update
        leaf.add_(1)
    ck.wait()
    got, _ = ck.restore(abstract_train_state(configs.smoke(ARCH), TrainConfig()),
                        device="cpu")
    for key, leaf in _named(got).items():
        assert torch.equal(leaf, before[key]), key


def test_preemption_and_resume_give_the_uninterrupted_state(tmp_path, deterministic):
    cfg = configs.smoke(ARCH)
    tc = TrainConfig(warmup_steps=1, total_steps=6)
    dc = DataConfig(batch_size=2, seq_len=16, vocab_size=cfg.vocab_size,
                    selection="greedy")
    step = make_train_step(cfg, tc)
    full, rep = run(_state(tc), step, Pipeline(dc, device="cpu"),
                    Checkpointer(str(tmp_path / "full")), num_steps=6,
                    ckpt_every=0, log_every=0)
    assert rep.final_step == 6 and not rep.preempted

    pipe = Pipeline(dc, device="cpu")
    calls = [0]

    def preempting():
        calls[0] += 1
        if calls[0] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return pipe()

    ck = Checkpointer(str(tmp_path / "cut"))
    _, cut = run(_state(tc), step, preempting, ck, num_steps=6, ckpt_every=2,
                 log_every=0)
    assert cut.preempted and cut.final_step == 3 and ck.latest_step() == 3
    # a restart: a fresh process's state from the commit, the data stream
    # carried on from where it stopped
    state, start, resumed = resume_or_init(
        ck, abstract_train_state(cfg, tc), lambda: _state(tc), device="cpu")
    assert resumed and start == 3
    end, rep2 = run(state, step, pipe, ck, num_steps=6, start_step=start,
                    ckpt_every=2, log_every=0)
    assert rep2.final_step == 6 and ck.latest_step() == 6
    _same(end, full)
