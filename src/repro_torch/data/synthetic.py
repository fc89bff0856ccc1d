"""Synthetic corpora matched to the paper's datasets: numpy copies of
``news_day``, ``video`` and ``clustered_embeddings`` from the JAX package's
``repro/data/synthetic.py``, kept here so the port imports nothing of that
package.  Same seed, same arrays.

``news_day`` gives ``n`` sentences as hashed-TF-IDF rows over ``F`` features,
with Zipfian token draws and per-day topical clusters: sentences within a
cluster share a topic distribution, the redundancy SS finds.  ``video`` gives
SumMe-like frame descriptors (the facility-location objective of the paper's
video summarization), ``clustered_embeddings`` unit-norm embedding rows for
the matrix-free facility location.
"""

from __future__ import annotations

import numpy as np


def _rng(seed) -> np.random.Generator:
    return np.random.default_rng(seed)


def news_day(
    seed: int,
    n_sentences: int,
    n_features: int = 1024,
    n_topics: int = 12,
    mean_len: int = 20,
    zipf_a: float = 1.07,
) -> np.ndarray:
    """One day's sentences as a nonnegative (n, F) float32 TF-IDF matrix."""
    rng = _rng(seed)
    topics = rng.dirichlet(np.full(n_features, 0.05), size=n_topics)
    # cluster sizes ~ broken-stick: few big stories, many small ones
    weights = rng.dirichlet(np.ones(n_topics) * 0.6)
    assign = rng.choice(n_topics, size=n_sentences, p=weights)
    lengths = np.maximum(3, rng.poisson(mean_len, size=n_sentences))
    W = np.zeros((n_sentences, n_features), np.float32)
    zipf_boost = (np.arange(1, n_features + 1) ** (-zipf_a))
    for t in range(n_topics):
        idx = np.where(assign == t)[0]
        if idx.size == 0:
            continue
        p = topics[t] * zipf_boost
        p /= p.sum()
        # One draw for the whole topic in place of one rng.choice per
        # sentence: rng.choice(F, size=L, p=p) is searchsorted(cdf,
        # rng.random(L), "right"), and consecutive rng.random draws
        # concatenate, so the tokens (and the array) are the reference's.
        cdf = p.cumsum()
        cdf /= cdf[-1]
        toks = cdf.searchsorted(rng.random(int(lengths[idx].sum())), side="right")
        np.add.at(W, (np.repeat(idx, lengths[idx]), toks), 1.0)
    # tf * idf, l2-normalized rows (standard setup for coverage objectives)
    df = np.maximum((W > 0).sum(axis=0), 1)
    idf = np.log(1.0 + n_sentences / df).astype(np.float32)
    W = W * idf[None, :]
    W /= np.maximum(np.linalg.norm(W, axis=1, keepdims=True), 1e-9)
    return W


def video(
    seed: int,
    n_frames: int,
    n_features: int = 512,
    n_scenes: int | None = None,
    walk_sigma: float = 0.02,
) -> np.ndarray:
    """Frame descriptors (n, F) float32, nonnegative, unit-norm rows: a
    smooth random walk through each scene, with shot cuts between scenes."""
    rng = _rng(seed)
    if n_scenes is None:
        n_scenes = max(3, n_frames // 400)
    cuts = np.sort(rng.choice(np.arange(1, n_frames), n_scenes - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [n_frames]])
    X = np.zeros((n_frames, n_features), np.float32)
    for s in range(n_scenes):
        lo, hi = bounds[s], bounds[s + 1]
        center = np.abs(rng.normal(0, 1, n_features))
        steps = rng.normal(0, walk_sigma, (hi - lo, n_features)).cumsum(axis=0)
        X[lo:hi] = np.abs(center[None, :] + steps)
    X /= np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-9)
    return X.astype(np.float32)


def clustered_embeddings(
    seed: int,
    n: int,
    d: int = 16,
    n_clusters: int = 32,
    noise: float = 0.25,
) -> np.ndarray:
    """Unit-norm gaussian-cluster embedding rows (n, d) float32:
    ``normalize(center[c] + noise * N(0, I))`` with broken-stick cluster
    sizes.  Memory is O(n * d); the (n, n) similarity is never needed."""
    rng = _rng(seed)
    centers = rng.normal(0, 1, (n_clusters, d))
    centers /= np.maximum(np.linalg.norm(centers, axis=1, keepdims=True), 1e-9)
    weights = rng.dirichlet(np.ones(n_clusters) * 0.6)
    assign = rng.choice(n_clusters, size=n, p=weights)
    X = centers[assign] + noise * rng.normal(0, 1, (n, d))
    X /= np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-9)
    return X.astype(np.float32)
