"""The port's examples (``examples/*_torch.py``) and the modules they read
(``configs/paper_ss.py``, ``data/video_eval.py``) held to their JAX
counterparts on the CPU.

The JAX examples print and return nothing, so each test runs the reference
example's body through the JAX package and the port's example function on
the same inputs: the JAX parameters, tokens and train state carried across
as numpy arrays, and the JAX draws replayed (SS noise from the key's split
chain, the pipeline's draws through ``pipeline._ss_draws``).  Selections
must be identical; values, logits and losses agree at 1e-4 of the largest
magnitude (float32 through a few layers in other summation orders).  Each
example also runs end to end from its command line with ``--device cpu``.
"""

import dataclasses
import importlib.util
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:      # the reference examples import ``benchmarks``
    sys.path.insert(0, str(ROOT))

from benchmarks.common import frame_f1 as jframe_f1  # noqa: E402
from benchmarks.table2_video import _reference as jnovelty_reference  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.configs import paper_ss as jpaper_ss  # noqa: E402
from repro.core import FeatureCoverage as JFeatureCoverage  # noqa: E402
from repro.core import greedy as jgreedy  # noqa: E402
from repro.core.sparsify import ss_sparsify as jss_sparsify  # noqa: E402
from repro.data import video as jvideo  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import KVSelectConfig as JKVSelectConfig  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import paper_ss  # noqa: E402
from repro_torch.convert import cache_from_numpy, model_params_from_numpy  # noqa: E402
from repro_torch.core.sparsify import max_rounds  # noqa: E402
from repro_torch.data import pipeline as pipeline_mod  # noqa: E402
from repro_torch.data import video  # noqa: E402
from repro_torch.data.video_eval import frame_f1, novelty_reference  # noqa: E402
from repro_torch.train.checkpoint import _flatten_with_names  # noqa: E402


def _example(name: str):
    """``examples/<name>.py`` as a module (not run as a script)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _gumbels(key, n: int, rounds: int) -> np.ndarray:
    """SS's draws under ``key``: round j's Gumbel from the j-th split."""
    rows = []
    for _ in range(rounds):
        key, k1 = jax.random.split(key)
        rows.append(np.asarray(jax.random.gumbel(k1, (n,))))
    return np.stack(rows)


# -- the scorers and the paper's workload config ----------------------------------


def _tied_video(n: int = 300, seed: int = 1) -> np.ndarray:
    """A synthetic video with runs of identical frames: their novelties tie
    (zero inside a long enough run, equal at mirrored places)."""
    X = video(seed, n, n_features=32)
    X[40:140] = X[40]
    X[200:260] = X[200]
    return X


@pytest.mark.parametrize("frac", [0.15, 0.5, 0.0])
def test_novelty_reference_equals_the_benchmarks_with_ties(frac):
    X = _tied_video()
    w = 24
    pad = np.pad(X, ((w, w), (0, 0)), mode="edge")
    novelty = np.linalg.norm(X - np.stack([pad[i:i + 2 * w + 1].mean(0)
                                           for i in range(len(X))]), axis=1)
    assert len(novelty) - len(np.unique(novelty)) > 50      # ties among the inputs
    want = jnovelty_reference(X, frac)
    got = novelty_reference(X, frac)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("window", [0, 3, 16])
def test_frame_f1_equals_the_benchmarks(window):
    rng = np.random.default_rng(window)
    for n, a, b in [(500, 60, 75), (120, 1, 30), (50, 10, 0), (9721, 1458, 1458)]:
        sel = rng.choice(n, a, replace=False)
        ref = rng.choice(n, b, replace=False) if b else np.array([], int)
        sel = np.concatenate([sel, sel[: a // 3]])            # repeated picks
        assert frame_f1(sel, ref, n, window) == jframe_f1(sel, ref, n, window)


def test_paper_ss_default_equals_the_reference():
    assert dataclasses.asdict(paper_ss.DEFAULT) == dataclasses.asdict(jpaper_ss.DEFAULT)
    assert (paper_ss.DEFAULT.r, paper_ss.DEFAULT.c, paper_ss.DEFAULT.summary_frac) == \
        (8, 8.0, 0.15)                     # the reference example's literals


# -- video_summarize --------------------------------------------------------------


def test_video_example_matches_jax_at_400_frames():
    """``examples/video_summarize.py``'s body at 400 frames (k = 60) under
    the JAX key, against ``summarize_video`` with the key's SS draws."""
    n, seed = 400, 0
    k = int(0.15 * n)
    Xj = jvideo(seed, n, n_features=256)
    X = video(seed, n, n_features=256)
    assert np.array_equal(X, Xj)
    fn = JFeatureCoverage(W=jnp.asarray(Xj), phi="sqrt")
    jfull = jgreedy(fn, k)
    jss = jss_sparsify(fn, jax.random.PRNGKey(seed), r=8, c=8.0)
    jred = jgreedy(fn, k, alive=jss.vprime)
    jref = jnovelty_reference(Xj)

    ex = _example("video_summarize_torch")
    noise = torch.from_numpy(_gumbels(jax.random.PRNGKey(seed), n, max_rounds(n)))
    out = ex.summarize_video(X, k, noise=noise, device="cpu")
    assert out["parity"] is None
    np.testing.assert_array_equal(out["full"].selected.numpy(), np.asarray(jfull.selected))
    np.testing.assert_array_equal(out["ss"].vprime.numpy(), np.asarray(jss.vprime))
    np.testing.assert_array_equal(out["reduced"].selected.numpy(),
                                  np.asarray(jred.selected))
    _close(out["full"].value, jfull.value)
    _close(out["reduced"].value, jred.value)
    assert np.array_equal(out["reference"], jref)
    want = {"greedy": np.asarray(jfull.selected), "ss": np.asarray(jred.selected),
            "first15%": np.arange(k)}
    assert out["f1"] == {name: jframe_f1(sel, jref, n) for name, sel in want.items()}
    assert 0 < out["vprime_size"] < n


# -- serve_kv_pruning -------------------------------------------------------------


def _jax_kv_example(B: int, S: int, budget: int) -> dict:
    """``examples/serve_kv_pruning.py``'s body on the SMOKE qwen2-7b."""
    cfg = jconfigs.smoke("qwen2-7b")
    key = jax.random.PRNGKey(0)
    params = jinit_params(key, cfg)
    toks = jax.random.randint(key, (B, S), 0, cfg.vocab_size)
    engine = JEngine(cfg, params, JServeConfig(max_len=S + 16))
    logits, cache = engine.prefill(toks)
    nxt = jnp.argmax(logits, -1).astype(jnp.int32)
    ref, _ = engine.decode_with_cache(nxt, cache, jnp.int32(S))
    pruned, clen, kept = engine.prune_kv(cache, S, key, JKVSelectConfig(budget=budget))
    out_ss, _ = engine.decode_with_cache(nxt, pruned, clen, pos=jnp.int32(S))

    rng = np.random.default_rng(0)
    kept_r = jnp.asarray(np.sort(rng.choice(S, budget, replace=False)))[None].repeat(B, 0)

    def compact(path, leaf):
        names = [p.key for p in path if hasattr(p, "key")]
        if names[-1] not in ("k", "v"):
            return leaf

        def per_row(row, idx):
            return jnp.zeros_like(row).at[:budget].set(row[idx])
        if leaf.ndim == 5:
            return jax.vmap(lambda g: jax.vmap(per_row)(g, kept_r))(leaf)
        return jax.vmap(per_row)(leaf, kept_r)

    rand = jax.tree_util.tree_map_with_path(compact, cache)
    out_r, _ = engine.decode_with_cache(nxt, rand, jnp.int32(budget), pos=jnp.int32(S))
    return dict(cfg=cfg, key=key, params=params, toks=toks, ref=ref, kept=kept, cache=cache,
                out_ss=out_ss, rand=rand, out_r=out_r,
                mse_ss=float(jnp.mean((out_ss - ref) ** 2)),
                mse_r=float(jnp.mean((out_r - ref) ** 2)),
                agree_ss=float(jnp.mean(jnp.argmax(out_ss, -1) == jnp.argmax(ref, -1))),
                agree_r=float(jnp.mean(jnp.argmax(out_r, -1) == jnp.argmax(ref, -1))))


def test_kv_example_matches_jax_on_smoke_qwen2():
    B, S, budget = 2, 48, 16
    want = _jax_kv_example(B, S, budget)
    ex = _example("serve_kv_pruning_torch")
    cfg = ex.example_config("smoke", "cpu")
    assert cfg == configs.smoke("qwen2-7b") and cfg.qkv_bias
    params = model_params_from_numpy(jax.tree.map(np.asarray, want["params"]), cfg,
                                     device="cpu")
    tokens = torch.from_numpy(np.array(want["toks"])).long()
    noise = torch.from_numpy(np.stack([
        _gumbels(k, S, max_rounds(S)) for k in jax.random.split(want["key"], B)]))
    out = ex.serve_and_prune(cfg, params, tokens, budget, noise=noise, device="cpu")

    # the kept positions: prune_kv under the JAX draws, and the service and
    # prune_kv under the row generators (asserted inside)
    np.testing.assert_array_equal(out["kept"].numpy(), np.asarray(want["kept"]))
    assert out["kept_service"].shape == (B, budget)
    assert [r.selected.shape for r in out["responses"]] == [(budget,)] * B
    # the random baseline's cache, leaf for leaf
    np.testing.assert_array_equal(out["kept_random"].numpy(),
                                  np.asarray(jnp.broadcast_to(
                                      jnp.asarray(np.sort(np.random.default_rng(0).choice(
                                          S, budget, replace=False))), (B, budget))))
    jrand = cache_from_numpy(jax.tree.map(np.asarray, want["rand"]), device="cpu")
    # the example's cache (positions below S: the decode step wrote only S)
    # through the example's compaction
    names_t, leaves_t = _flatten_with_names(
        ex.compact_cache(out["cache"], out["kept_random"]))
    names_j, leaves_j = _flatten_with_names(jrand)
    assert names_t == names_j and any("['k']" in n for n in names_t)
    for name, got, exp in zip(names_t, leaves_t, leaves_j):
        # the prefill's keys and values agree to float32 rounding, the
        # pruned layout exactly: the same positions kept, zeros past budget
        assert got.dtype == exp.dtype, name
        _close(got, exp.numpy())
        assert torch.equal(got == 0, exp == 0), name
    # compact_cache gives the reference's bytes on the reference's cache
    jcache = cache_from_numpy(jax.tree.map(np.asarray, want["cache"]), device="cpu")
    mine = _flatten_with_names(ex.compact_cache(jcache, out["kept_random"]))[1]
    assert all(torch.equal(a, b) for a, b in zip(mine, leaves_j))
    # logits, MSEs and agreements
    for name in ("ref", "out_ss"):
        _close(out[name], want[name])
    _close(out["out_random"], want["out_r"])
    for got, exp in (("mse_ss", "mse_ss"), ("mse_random", "mse_r")):
        _close(out[got], want[exp])
        assert want[exp] > 0
    assert (out["agree_ss"], out["agree_random"]) == (want["agree_ss"], want["agree_r"])


# -- train_lm_ss ------------------------------------------------------------------


class _JaxDraws:
    """``pipeline._ss_draws`` replaced by the JAX pipeline's draws (its key
    ``PRNGKey(seed * 1009)`` split once a batch)."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed * 1009)

    def __call__(self, generator, n, rounds):
        self.key, key = jax.random.split(self.key)
        return {"noise": torch.from_numpy(_gumbels(key, n, rounds))}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _port_state(jstate, cfg) -> dict:
    np_state = jax.tree.map(np.asarray, jstate)
    return {"params": model_params_from_numpy(np_state["params"], cfg, device="cpu"),
            "opt": _to_torch(np_state["opt"]),
            "step": torch.tensor(int(np_state["step"]), dtype=torch.int32)}


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.mark.parametrize("selection", ["uniform", "ss"])
def test_train_example_matches_jax_for_three_steps(selection, tmp_path, monkeypatch):
    """Three steps of the reference example's ``train`` from its initial
    state against the port's from the same state: every logged loss and the
    held-out loss at 1e-4."""
    steps, seed = 3, 0
    jex = _example("train_lm_ss")
    reports = []
    real_run = jex.run

    def recording_run(*args, **kwargs):
        state, rep = real_run(*args, **kwargs)
        reports.append(rep)
        return state, rep

    monkeypatch.setattr(jex, "run", recording_run)
    want = jex.train(selection, steps, seed=seed, ckpt_dir=str(tmp_path / "jax"))
    jcfg = jconfigs.smoke("llama3.2-3b")
    jtc = jtrainer.TrainConfig(optimizer="adamw", lr=1e-3, warmup_steps=10,
                               total_steps=steps)
    jstate = jtrainer.make_train_state(jax.random.PRNGKey(seed), jcfg, jtc)

    ex = _example("train_lm_ss_torch")
    cfg = ex.example_config("cpu")
    assert cfg == configs.smoke("llama3.2-3b")
    monkeypatch.setattr(pipeline_mod, "_ss_draws", _JaxDraws(seed))
    got = ex.train(selection, steps, seed=seed, ckpt_dir=str(tmp_path / "port"),
                   device="cpu", state=_port_state(jstate, cfg))
    assert got["steps_done"] == steps and int(got["state"]["step"]) == steps
    hist_j = reports[0].metrics_history
    assert [h["step"] for h in got["history"]] == [h["step"] for h in hist_j] == [0, 1, 2]
    for g, w in zip(got["history"], hist_j):
        for key in ("loss", "grad_norm", "lr"):
            _close(g[key], w[key])
    _close(got["train"], want["train"])
    _close(got["eval"], want["eval"])


def test_train_example_resume_gives_the_uninterrupted_state(tmp_path, deterministic):
    """Two steps, a checkpoint, then a resumed third step (the data stream
    replayed to step 2) against three uninterrupted steps: every leaf of
    the state bitwise equal on the CPU."""
    ex = _example("train_lm_ss_torch")
    whole = ex.train("ss", 3, ckpt_dir=str(tmp_path / "whole"), device="cpu")
    first = ex.train("ss", 2, ckpt_dir=str(tmp_path / "cut"), device="cpu")
    assert first["steps_done"] == 2
    resumed = ex.train("ss", 3, ckpt_dir=str(tmp_path / "cut"), device="cpu")
    assert resumed["steps_done"] == 1
    names_a, leaves_a = _flatten_with_names(whole["state"])
    names_b, leaves_b = _flatten_with_names(resumed["state"])
    assert names_a == names_b
    for name, a, b in zip(names_a, leaves_a, leaves_b):
        assert torch.equal(a, b), name
    assert resumed["eval"] == whole["eval"]


# -- each example end to end from its command line ---------------------------------


@pytest.mark.parametrize("name,argv,expect", [
    ("video_summarize_torch", ["--frames", "400"], "relative utility"),
    ("serve_kv_pruning_torch", [], "service round-trip: 2 queries"),
    ("train_lm_ss_torch", ["--steps", "2"], "SS keeps the pool whole"),
])
def test_example_runs_on_the_cpu(name, argv, expect, monkeypatch, capsys, tmp_path):
    path = ROOT / "examples" / f"{name}.py"
    if name == "train_lm_ss_torch":
        argv = argv + ["--ckpt-root", str(tmp_path)]
    monkeypatch.setattr("sys.argv", [str(path), "--device", "cpu", *argv])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(str(path), run_name="__main__")
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert expect in out


@pytest.mark.parametrize("name", ["video_summarize_torch", "serve_kv_pruning_torch",
                                  "train_lm_ss_torch"])
def test_examples_default_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])
