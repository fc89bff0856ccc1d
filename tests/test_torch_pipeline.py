"""The port's data pipeline on the CPU against the JAX package: the
synthetic token generators bit for bit, ``Pipeline`` batches bit for bit
for every selection (SS's draws replayed from the JAX pipeline's
``jax.random.split`` chain through ``pipeline._ss_draws``), shards,
codebooks and patch stubs, and ``selection_quality``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import Pipeline as JPipeline
from repro.data import selection_quality as jselection_quality
from repro.data import synthetic as jsyn
from repro_torch.data import DataConfig, Pipeline, selection_quality
from repro_torch.data import pipeline as pipeline_mod
from repro_torch.data import synthetic as tsyn

BASE = dict(batch_size=8, seq_len=32, vocab_size=300, feature_dim=64)


def test_zipf_tokens_bitwise():
    for a in (1.07, 1.3):
        want = jsyn.zipf_tokens(np.random.default_rng(4), (6, 9), 777, a)
        got = tsyn.zipf_tokens(np.random.default_rng(4), (6, 9), 777, a)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n_docs,dup", [(40, 0.3), (7, 0.0), (25, 0.9)])
def test_lm_documents_bitwise(n_docs, dup):
    want = jsyn.lm_documents(11, n_docs, 65, 500, dup_frac=dup)
    got = tsyn.lm_documents(11, n_docs, 65, 500, dup_frac=dup)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("F,ngram", [(64, 2), (512, 1), (100, 3)])
def test_hashed_features_bitwise(F, ngram):
    docs = jsyn.lm_documents(3, 30, 50, 128256)
    want = jsyn.hashed_features(docs, F, ngram)
    got = tsyn.hashed_features(docs, F, ngram)
    assert got.dtype == want.dtype and np.array_equal(got, want)


class _JaxDraws:
    """``pipeline._ss_draws`` replaced by the JAX pipeline's draws: its key
    ``PRNGKey(seed * 1009 + shard_id)`` split once a batch, and round j of
    SS drawn as ``key, k1 = split(key); gumbel(k1, (n,))``."""

    def __init__(self, seed: int, shard_id: int = 0):
        self.key = jax.random.PRNGKey(seed * 1009 + shard_id)

    def __call__(self, generator, n, rounds):
        self.key, key = jax.random.split(self.key)
        rows = []
        for _ in range(rounds):
            key, k1 = jax.random.split(key)
            rows.append(np.asarray(jax.random.gumbel(k1, (n,))))
        return {"noise": torch.from_numpy(np.stack(rows))}


def _same_batches(kw, n_batches=2, seed=1, shard=(0, 1), monkeypatch=None):
    jp = JPipeline(JDataConfig(**kw), shard_id=shard[0], num_shards=shard[1],
                   seed=seed)
    tp = Pipeline(DataConfig(**kw), shard_id=shard[0], num_shards=shard[1],
                  seed=seed, device="cpu")
    if monkeypatch is not None:
        monkeypatch.setattr(pipeline_mod, "_ss_draws", _JaxDraws(seed, shard[0]))
    for _ in range(n_batches):
        want, got = jp(), tp()
        assert sorted(got) == sorted(want)
        for key in want:
            w = np.asarray(want[key])
            g = got[key].numpy()
            assert g.dtype == w.dtype and np.array_equal(g, w), key
        assert got["tokens"].device.type == "cpu"


@pytest.mark.parametrize("selection", ["none", "uniform", "greedy"])
def test_batches_bitwise(selection):
    _same_batches(dict(BASE, selection=selection))


@pytest.mark.parametrize("selection", ["ss", "ss_fl"])
def test_ss_batches_under_replayed_draws(selection, monkeypatch):
    _same_batches(dict(BASE, selection=selection), monkeypatch=monkeypatch)


def test_shards_codebooks_and_patches(monkeypatch):
    kw = dict(BASE, selection="ss", num_codebooks=4, patch_count=3, d_model=8)
    _same_batches(kw, shard=(1, 2), seed=2, monkeypatch=monkeypatch)


def test_selection_quality(monkeypatch):
    monkeypatch.setattr(pipeline_mod, "_ss_draws", _JaxDraws(0))
    cfg = dict(BASE, batch_size=4)
    want = jselection_quality(JDataConfig(**cfg), steps=2)
    got = selection_quality(DataConfig(**cfg), steps=2, device="cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)


def test_unknown_selection_raises():
    with pytest.raises(ValueError):
        Pipeline(dataclasses.replace(DataConfig(), selection="random"), device="cpu")


def test_pipeline_reports_its_timing():
    pipe = Pipeline(DataConfig(**dict(BASE, selection="greedy")), device="cpu")
    pipe()
    assert set(pipe.last_timing) == {"pool_ms", "features_ms", "select_ms"}
    assert all(v >= 0 for v in pipe.last_timing.values())
