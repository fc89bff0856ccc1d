"""Sharded LM data pipeline with the paper's technique as its coreset-selection
stage: the counterpart of ``repro/data/pipeline.py``.

Flow per batch (selection="ss"):

    pool of pool_factor*B candidate sequences   (this shard's slice, host)
      -> hashed n-gram features (n, F)           (host, numpy)
      -> FeatureCoverage objective  f(S) = Σ_f sqrt(c_f(S))   (on the device)
      -> Submodular Sparsification prunes the pool to V'   (Algorithm 1)
      -> greedy on V' picks the B most feature-covering sequences
      -> batch = {tokens, labels}                (tensors on the device)

so each batch is a non-redundant summary of its candidate pool.  On the
card the objective is built from the host's features in one upload a batch,
SS and greedy run through the port's kernels (``ss_divergence``,
``feature_gains``; with selection="ss_fl" the matrix-free facility location
over the same rows, ``fl_stream_divergence`` and ``fl_stream_gains``), and
the picks are read back once.  selection="uniform" and "greedy" (no SS) are
the ablation baselines, selection="none" a plain loader.

Randomness: SS draws from a ``torch.Generator`` on the device, seeded
``seed * 1009 + shard_id``, through :func:`_ss_draws` (the CPU tests replace
it to replay the JAX pipeline's ``jax.random.split`` chain as ``noise``);
the pool and the uniform and patch draws are numpy's, as in the reference.

Sharding: each data shard owns a disjoint seed range (``shard_id`` /
``num_shards``).  ``slow_every`` injects an artificial stall for the
straggler tests.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.convert import feature_coverage_from_numpy
from repro_torch.core import StreamingFacilityLocation, greedy, ss_sparsify
from repro_torch.core.sparsify import max_rounds
from repro_torch.data import synthetic
from repro_torch.device import resolve_device

SELECTIONS = ("none", "uniform", "greedy", "ss", "ss_fl")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    vocab_size: int = 50304
    selection: str = "ss"          # none | uniform | greedy | ss | ss_fl
    pool_factor: int = 4           # candidate pool = pool_factor * batch
    feature_dim: int = 512
    ngram: int = 2
    ss_r: int = 8
    ss_c: float = 8.0
    dup_frac: float = 0.3          # redundancy planted in the synthetic stream
    num_codebooks: int = 1
    patch_count: int = 0           # >0: emit stub patch embeddings (vlm)
    d_model: int = 0               # for patch stub width


def _ss_draws(generator: torch.Generator, n: int, rounds: int) -> dict:
    """The draws of one batch's SS, as keyword arguments of
    :func:`~repro_torch.core.ss_sparsify`: the pipeline's generator.  (``n``
    and ``rounds`` give the shape, (rounds, n), of an injected ``noise``
    instead.)"""
    return {"generator": generator}


def select_documents(W: np.ndarray, k: int, selection: str, draws: dict, *,
                     r: int = 8, c: float = 8.0, device="cuda",
                     backend=None) -> np.ndarray:
    """The selection stage on hashed features W (n, F): the k picked rows'
    indices, read to the host once.  ``selection`` is "greedy" (greedy over
    the pool), "ss" (SS, then greedy on V', on FeatureCoverage) or "ss_fl"
    (the same on the matrix-free facility location over W's rows);
    ``draws`` are SS's (:func:`_ss_draws`); ``backend`` as in
    :func:`~repro_torch.core.greedy` (None: by the device)."""
    dev = resolve_device(device)
    if selection == "ss_fl":
        fn = StreamingFacilityLocation.from_features(
            torch.from_numpy(np.ascontiguousarray(W)).to(dev), kernel="dot")
    else:
        fn = feature_coverage_from_numpy(W, phi="sqrt", device=dev)
    if selection == "greedy":
        res = greedy(fn, k, backend=backend)
    elif selection in ("ss", "ss_fl"):
        ss = ss_sparsify(fn, r=r, c=c, backend=backend, **draws)
        res = greedy(fn, k, alive=ss.vprime, backend=backend)
    else:
        raise ValueError(f"unknown selection {selection!r}")
    return res.selected.cpu().numpy()


class Pipeline:
    """``pipe()`` gives the next batch: ``{"tokens", "labels"}`` (and
    ``"patches"``) as tensors on ``device`` (the card by default).
    ``last_timing`` holds the last batch's host milliseconds (the pool and
    its features) and selection milliseconds (the objective's upload, SS and
    greedy on the device, and the picks' read-back)."""

    def __init__(
        self,
        cfg: DataConfig,
        shard_id: int = 0,
        num_shards: int = 1,
        seed: int = 0,
        slow_every: int = 0,
        slow_s: float = 0.0,
        device="cuda",
    ):
        if cfg.selection not in SELECTIONS:
            raise ValueError(f"unknown selection {cfg.selection!r}")
        self.cfg = cfg
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        self.slow_every = slow_every
        self.slow_s = slow_s
        self.device = resolve_device(device)
        self._step = 0
        self._gen = torch.Generator(device=self.device).manual_seed(
            seed * 1009 + shard_id)
        self.last_timing: dict = {}

    # -- candidate pool -------------------------------------------------------
    def _pool(self) -> np.ndarray:
        c = self.cfg
        n = c.batch_size * (c.pool_factor if c.selection != "none" else 1)
        # +1 token so labels are a clean shift
        pool_seed = (
            self.seed * 7_919
            + self._step * self.num_shards
            + self.shard_id
        )
        return synthetic.lm_documents(
            pool_seed, n, c.seq_len + 1, c.vocab_size, dup_frac=c.dup_frac
        )

    # -- selection stage ------------------------------------------------------
    def _select(self, docs: np.ndarray) -> np.ndarray:
        c = self.cfg
        B = c.batch_size
        t = time.perf_counter()
        if c.selection == "none":
            return docs[:B]
        if c.selection == "uniform":
            rng = np.random.default_rng(self._step)
            return docs[rng.choice(len(docs), B, replace=False)]
        W = synthetic.hashed_features(docs[:, :-1], c.feature_dim, c.ngram)
        t_sel = time.perf_counter()
        draws = (_ss_draws(self._gen, len(W), max_rounds(len(W), c.ss_r, c.ss_c))
                 if c.selection != "greedy" else {})
        picks = select_documents(W, B, c.selection, draws, r=c.ss_r, c=c.ss_c,
                                 device=self.device)
        self.last_timing["select_ms"] = (time.perf_counter() - t_sel) * 1e3
        self.last_timing["features_ms"] = (t_sel - t) * 1e3
        return docs[picks]

    # -- batch emission ---------------------------------------------------------
    def __call__(self) -> dict:
        if self.slow_every and self._step > 0 and self._step % self.slow_every == 0:
            time.sleep(self.slow_s)   # injected straggler
        self.last_timing = {"select_ms": 0.0, "features_ms": 0.0}
        t = time.perf_counter()
        docs = self._pool()
        self.last_timing["pool_ms"] = (time.perf_counter() - t) * 1e3
        docs = self._select(docs)
        self._step += 1
        c = self.cfg
        tokens = docs[:, :-1]
        labels = docs[:, 1:]
        if c.num_codebooks > 1:
            # replicate the stream into K codebooks with per-book offsets
            tokens = np.stack(
                [(tokens + k) % c.vocab_size for k in range(c.num_codebooks)],
                axis=-1,
            )
            labels = np.stack(
                [(labels + k) % c.vocab_size for k in range(c.num_codebooks)],
                axis=-1,
            )
        dev = self.device
        batch = {"tokens": torch.from_numpy(np.ascontiguousarray(tokens)).to(dev),
                 "labels": torch.from_numpy(np.ascontiguousarray(labels)).to(dev)}
        if c.patch_count > 0:
            rng = np.random.default_rng(self._step)
            batch["patches"] = torch.from_numpy(
                rng.normal(0, 1, (c.batch_size, c.patch_count, c.d_model))
                .astype(np.float32)).to(dev)
        return batch

    def __iter__(self):
        while True:
            yield self()


def selection_quality(cfg: DataConfig, steps: int = 4, seed: int = 0,
                      device="cuda") -> dict:
    """Utility of each selection policy's batches under the coverage
    objective (the diagnostic of the tests and the data-selection
    benchmark)."""
    dev = resolve_device(device)
    out = {}
    for sel in ("uniform", "ss", "greedy"):
        pipe = Pipeline(dataclasses.replace(cfg, selection=sel), seed=seed,
                        device=dev)
        vals = []
        for _ in range(steps):
            docs = pipe._pool()
            chosen = pipe._select(docs)
            W = synthetic.hashed_features(
                chosen[:, :-1], cfg.feature_dim, cfg.ngram
            )
            fn = feature_coverage_from_numpy(W, phi="sqrt", device=dev)
            vals.append(float(fn.value(fn.add_many(
                fn.empty_state(), torch.ones(len(W), dtype=torch.bool, device=dev)))))
            pipe._step += 1
        out[sel] = float(np.mean(vals))
    return out
