"""The port's training path on the CPU against the JAX package: ``lm_loss``;
the loss and every gradient leaf of the smoke configs of ten
architectures (every block family, qk-norm, QKV bias, top-1 routing with a
shared expert, patch inputs) against ``jax.value_and_grad`` of the reference ``_loss_fn``; the
remat policies; AdamW and Adafactor against the reference's ``update``;
``lr_schedule``; microbatching; three steps of ``make_train_step`` against
the JAX step; the runtime's straggler guard; and ``launch/train.py`` with a
resume.  Inputs are numpy draws from a seed, parameters carried across
with ``model_params_from_numpy``.  Tolerance: 1e-4 of max|want| (float32
through a few layers in other summation orders), tighter where the
arithmetic is the same."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decoder as jdec
from repro.train import optimizer as jopt
from repro.train import trainer as jtr
from repro_torch import configs
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models import forward, lm_loss
from repro_torch.models.layers import tree_leaves
from repro_torch.train import (
    Adafactor,
    AdamW,
    StragglerGuard,
    TrainConfig,
    lr_schedule,
    make_train_step,
)
from repro_torch.train import trainer as ttr
from repro_torch.train.checkpoint import _flatten_with_names

GRAD_ARCHS = ["llama3.2-3b", "olmoe-1b-7b", "mamba2-780m", "recurrentgemma-2b",
              "musicgen-large", "qwen3-4b", "starcoder2-3b", "qwen2-7b",
              "llama4-maverick-400b-a17b", "internvl2-76b"]


@pytest.fixture
def deterministic():
    """Deterministic CPU kernels (the MoE's scatter backward is not
    otherwise), restored after the test."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float64)
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _np_params(jcfg, seed=0):
    """The reference's parameter tree filled with numpy draws: weights at
    fan-in scale, embeddings at unit scale, norm scales near 1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jdec.init_params(jax.random.PRNGKey(0), jcfg))

    def fill(path, sd):
        name = jax.tree_util.keystr(path)
        if "tok" in name:
            return rng.standard_normal(sd.shape).astype(np.float32)
        if "scale" in name or "_norm" in name:
            return (1.0 + 0.2 * rng.standard_normal(sd.shape)).astype(np.float32)
        fan_in = sd.shape[-2] if len(sd.shape) >= 2 else 1
        return (rng.standard_normal(sd.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batch(cfg, B=2, S=12, seed=1):
    rng = np.random.default_rng(seed)
    shape = (B, S) if cfg.num_codebooks == 1 else (B, S, cfg.num_codebooks)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels[0, :2] = -1                     # masked positions
    batch = {"tokens": toks, "labels": labels}
    if cfg.input_mode == "tokens+patches":  # precomputed patch embeddings
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def _named(tree_np):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree_np)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _port_named(tree):
    names, leaves = _flatten_with_names(tree)
    return dict(zip(names, leaves))


# -- lm_loss ------------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 3])
def test_lm_loss_matches_jax_with_masked_and_codebook_labels(K):
    rng = np.random.default_rng(2)
    shape = (2, 7) if K == 1 else (2, 7, K)
    logits = (3 * rng.standard_normal(shape + (50,))).astype(np.float32)
    labels = rng.integers(0, 50, shape).astype(np.int32)
    labels[0, :3] = -1
    labels[1, -1] = -5
    cfg = configs.smoke("musicgen-large" if K > 1 else "llama3.2-3b")
    jcfg = jconfigs.smoke(cfg.name.removesuffix("-smoke"))
    want = jdec.lm_loss(jcfg, jnp.asarray(logits), jnp.asarray(labels))
    got = lm_loss(cfg, torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    _close(got, want, 1e-6)
    # every position masked: 0, as the reference's max(sum(valid), 1)
    none = lm_loss(cfg, torch.from_numpy(logits), torch.full(shape, -1))
    assert float(none) == 0.0


# -- loss and gradients of the block families --------------------------------

_JAX_GRAD = {}


def _jax_value_and_grad(arch):
    if arch not in _JAX_GRAD:
        jcfg = jconfigs.smoke(arch)
        tc = jtr.TrainConfig()
        _JAX_GRAD[arch] = jax.jit(jax.value_and_grad(
            lambda p, b: jtr._loss_fn(jcfg, tc, p, b), has_aux=True))
    return _JAX_GRAD[arch]


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch):
    jcfg, cfg = jconfigs.smoke(arch), configs.smoke(arch)
    pnp = _np_params(jcfg)
    batch = _batch(cfg)
    (jtotal, jm), jgrads = _jax_value_and_grad(arch)(
        pnp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = model_params_from_numpy(pnp, cfg, device="cpu")
    names, leaves = _flatten_with_names({"params": params})
    grads, m = ttr._grads(cfg, TrainConfig(), params, list(leaves),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(m["loss"], jm["loss"])
    _close(m["aux"], jm["aux"])
    if arch == "olmoe-1b-7b":
        assert float(m["aux"]) > 0          # the load-balance term counts
    want = _named({"params": jgrads})
    assert sorted(want) == sorted(names)
    for name, g in zip(names, grads):
        _close(g, want[name])


def test_head_dim_256_local_attention_loss_and_gradients_match_jax():
    """recurrentgemma's local attention at its published head width, 256:
    the smoke config cut to one group of its pattern (rglru, rglru, local)
    with head_dim 256 and a window of 8 over 12 positions (MQA 2:1).  The
    loss and every gradient leaf against ``jax.value_and_grad`` of the
    reference ``_loss_fn``, as at the smoke config's head_dim 32 (on the
    CPU the flash function's backward is its plain version, the one the
    card's tensor-core backward at 256 is held to)."""
    arch = "recurrentgemma-2b"
    jcfg = dataclasses.replace(jconfigs.smoke(arch), head_dim=256, num_layers=3)
    cfg = dataclasses.replace(configs.smoke(arch), head_dim=256, num_layers=3)
    assert cfg.layer_types == ("rglru", "rglru", "local")
    assert 0 < cfg.local_window < 12
    pnp = _np_params(jcfg)
    batch = _batch(cfg)
    tc = jtr.TrainConfig()
    (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtr._loss_fn(jcfg, tc, p, b), has_aux=True))(
        pnp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = model_params_from_numpy(pnp, cfg, device="cpu")
    assert params["blocks"]["p2"]["attn"]["w_q"].shape[-1] == 2 * 256
    names, leaves = _flatten_with_names({"params": params})
    grads, m = ttr._grads(cfg, TrainConfig(), params, list(leaves),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(m["loss"], jm["loss"])
    want = _named({"params": jgrads})
    assert sorted(want) == sorted(names)
    for name, g in zip(names, grads):
        assert float(g.abs().max()) > 0, f"{name} got no gradient"
        _close(g, want[name])


@pytest.mark.parametrize("arch", ["llama3.2-3b", "olmoe-1b-7b", "recurrentgemma-2b"])
def test_remat_policies_give_bitwise_equal_gradients(arch, deterministic):
    cfg = configs.smoke(arch)
    params = model_params_from_numpy(_np_params(jconfigs.smoke(arch)), cfg,
                                     device="cpu")
    leaves = list(tree_leaves(params))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = {}
    for remat in ("none", "nothing", "dots", "nested"):
        tc = TrainConfig(remat=remat)
        out[remat] = ttr._grads(cfg, tc, params, leaves, batch)
    for remat in ("nothing", "dots", "nested"):
        assert torch.equal(out[remat][1]["loss"], out["none"][1]["loss"])
        assert all(torch.equal(a, b) for a, b in zip(out[remat][0], out["none"][0]))


def test_forward_rejects_an_unknown_remat_policy():
    cfg = configs.smoke("llama3.2-3b")
    params = model_params_from_numpy(_np_params(jconfigs.smoke("llama3.2-3b")),
                                     cfg, device="cpu")
    with pytest.raises(ValueError):
        forward(cfg, params, torch.zeros((1, 4), dtype=torch.int32), remat="all")


# -- optimizers ------------------------------------------------------------------


def _opt_tree(rng):
    """Leaves of every kind: factored (both axes >= 128), unfactored, a 3-D
    stacked leaf, vectors."""
    return {"w": rng.standard_normal((128, 160)).astype(np.float32),
            "stack": {"a": rng.standard_normal((3, 130, 128)).astype(np.float32),
                      "b": rng.standard_normal((2, 16, 200)).astype(np.float32)},
            "small": rng.standard_normal((64, 32)).astype(np.float32),
            "scale": rng.standard_normal((40,)).astype(np.float32)}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference_over_three_steps(name):
    rng = np.random.default_rng(3)
    p_np = _opt_tree(rng)
    jo = jopt.make_optimizer(name)
    to = AdamW() if name == "adamw" else Adafactor()
    jp, js = jax.tree.map(jnp.asarray, p_np), None
    js = jo.init(jp)
    tp = _to_torch(p_np)
    ts = to.init(tp)
    for step in range(3):
        g_np = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                            p_np)
        lr = np.float32(1e-2 * (step + 1))
        jp, js = jo.update(jax.tree.map(jnp.asarray, g_np), js, jp, jnp.float32(lr),
                           jnp.int32(step))
        tp2, ts2 = to.update(_to_torch(g_np), ts, tp, torch.tensor(lr),
                             torch.tensor(step, dtype=torch.int32))
        assert tp2 is tp and ts2 is ts      # in place
        want = _named({"p": jp, "s": js})
        got = _port_named({"p": tp, "s": ts})
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key], 1e-5)
    if name == "adafactor":
        assert set(ts["v"]["w"]) == {"vr", "vc"} and set(ts["v"]["small"]) == {"v"}
        assert ts["v"]["stack"]["a"]["vr"].shape == (3, 130)


def test_lr_schedule_matches_reference():
    for tc_kw in (dict(warmup_steps=3, total_steps=20), dict(warmup_steps=0, total_steps=5),
                  dict(warmup_steps=10, total_steps=10, min_lr_frac=0.3)):
        jtc, ttc = jtr.TrainConfig(**tc_kw), TrainConfig(**tc_kw)
        for s in range(0, 25):
            want = jtr.lr_schedule(jtc, jnp.int32(s))
            got = lr_schedule(ttc, torch.tensor(s, dtype=torch.int32))
            _close(got, want, 1e-6)


# -- the train step -------------------------------------------------------------


def _state(cfg, tc, pnp):
    params = model_params_from_numpy(pnp, cfg, device="cpu")
    opt = AdamW(weight_decay=tc.weight_decay) if tc.optimizer == "adamw" else Adafactor()
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def test_microbatches_match_one_batch(deterministic):
    """µ = 2 against µ = 1 on the same global batch (no masked label, so the
    mean of the two halves' losses is the whole batch's): two steps, every
    parameter and optimizer leaf within 1e-4 of its largest magnitude."""
    cfg = configs.smoke("llama3.2-3b")
    pnp = _np_params(jconfigs.smoke("llama3.2-3b"))
    batches = []
    for seed in (5, 6):
        b = _batch(cfg, B=4, seed=seed)
        b["labels"] = np.abs(b["labels"])
        batches.append({k: torch.from_numpy(v) for k, v in b.items()})
    out = {}
    for mu in (1, 2):
        tc = TrainConfig(num_microbatches=mu, warmup_steps=1, total_steps=4)
        step, st = make_train_step(cfg, tc), _state(cfg, tc, pnp)
        for b in batches:
            st, m = step(st, b)
        out[mu] = (_port_named(st), m)
    for key, want in out[1][0].items():
        got = out[2][0][key].double()
        want = want.double()
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), key
    _close(out[2][1]["loss"], out[1][1]["loss"], 1e-5)


@pytest.mark.parametrize("optimizer,mu", [("adamw", 1), ("adafactor", 1), ("adamw", 2)])
def test_three_train_steps_match_jax(optimizer, mu):
    arch = "llama3.2-3b"
    jcfg, cfg = jconfigs.smoke(arch), configs.smoke(arch)
    kw = dict(optimizer=optimizer, warmup_steps=1, total_steps=6, num_microbatches=mu)
    jtc, tc = jtr.TrainConfig(**kw), TrainConfig(**kw)
    pnp = _np_params(jcfg)
    jopt_ = jopt.make_optimizer(optimizer, **({"weight_decay": 0.1}
                                               if optimizer == "adamw" else {}))
    jstate = {"params": jax.tree.map(jnp.asarray, pnp), "opt": None,
              "step": jnp.zeros((), jnp.int32)}
    jstate["opt"] = jopt_.init(jstate["params"])
    jstep = jax.jit(jtr.make_train_step(jcfg, jtc))
    tstate = _state(cfg, tc, pnp)
    tstep = make_train_step(cfg, tc)
    for i in range(3):
        b = _batch(cfg, B=4, seed=10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        assert all(v.dim() == 0 for v in tm.values())
        for key in ("loss", "aux", "grad_norm", "lr"):
            _close(tm[key], jm[key])
    assert int(tstate["step"]) == 3
    want, got = _named(jstate), _port_named(tstate)
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key])


# -- runtime and launcher ----------------------------------------------------------


def test_straggler_guard_skips_a_slow_shard_and_gives_up():
    import time

    calls = {"n": 0, "skips": 0}

    def next_fn():
        calls["n"] += 1
        if calls["n"] <= 2:
            time.sleep(0.15)
        return {"x": calls["n"]}

    guard = StragglerGuard(next_fn, lambda: calls.__setitem__(
        "skips", calls["skips"] + 1), deadline_s=0.05, max_skips=5)
    assert guard() == {"x": 3}
    assert guard.skipped == 2 and calls["skips"] == 2
    stuck = StragglerGuard(lambda: time.sleep(0.05) or {}, lambda: None,
                           deadline_s=0.01, max_skips=2)
    with pytest.raises(TimeoutError):
        stuck()


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    assert launch_train.main(argv + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "done: 4 steps" in out and "resumed" not in out
    assert sorted(p.name for p in (tmp_path / "llama3.2-3b-smoke").iterdir()) == [
        "step_0000000002", "step_0000000004"]
    assert launch_train.main(argv + ["--steps", "6", "--remat", "dots"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "done: 2 steps" in out


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.train import Checkpointer, abstract_train_state, make_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.smoke("llama3.2-3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline(DataConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_state(torch.Generator(), cfg, TrainConfig())
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ck.restore({"x": torch.empty(2, device="meta")})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "llama3.2-3b", "--smoke", "--ckpt-dir",
                           str(tmp_path)])
    assert abstract_train_state(cfg, TrainConfig())["step"].device.type == "meta"


def test_launcher_takes_one_device_only():
    with pytest.raises(NotImplementedError, match="1x1"):
        launch_train.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                           "--mesh", "2x2"])
