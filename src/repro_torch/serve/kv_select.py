"""SS pruning of the KV cache: the counterpart of ``repro/serve/kv_select.py``.

When a decode context outgrows its budget, the cached positions become the
ground set of a summarization problem (positions as "sentences", pooled
|key| vectors as features): SS shrinks the candidate set, then greedy keeps
``budget`` representative positions.  Every attention layer's cache is
compacted to them, and decoding goes on at the true sequence position
(``decode_step(..., pos=S)`` keeps RoPE right).

Objectives: ``coverage`` (default) is FeatureCoverage over the pooled
features; ``fl`` is facility location over their cosine similarity (an
(L, L) matrix per decode row).  The decode batch is one lane of the
summarization core, :func:`repro_torch.serve.summarize_service.summarize_batch`.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.functions import FacilityLocation, FeatureCoverage
from repro_torch.serve.summarize_service import (
    RunConfig,
    fold_in,
    generator,
    summarize_batch,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class KVSelectConfig:
    """What KV pruning keeps and how it runs.  ``run`` holds the execution
    knobs (``backend``, SS ``r`` / ``c``, ``compact``).

    The reference pins ``run.backend="oracle"``, because its Pallas backend
    has no batched primitive.  Here the default is None, which resolves by
    the cache's device: ``cuda`` on the card (the hand-written kernels, one
    launch per decode row) and ``reference`` on the CPU (the plain path, the
    oracle's counterpart)."""

    budget: int = 256            # positions kept
    objective: str = "coverage"  # coverage | fl
    use_ss: bool = True          # False: greedy on every position (ablation)
    run: RunConfig = dataclasses.field(default_factory=RunConfig)


def pooled_keys(cache: dict, seq_len: int) -> Tensor:
    """Mean |key| over every attention layer and KV head, in float32:
    (B, seq_len, head_dim).  Stacked groups' keys are (G, B, L, KV, hd),
    the tail's (B, L, KV, hd)."""
    ks = []
    for grp in cache.get("blocks", {}).values():
        if isinstance(grp, dict) and "k" in grp:
            ks.append(grp["k"].float().abs().mean(dim=(0, 3)))
    for c in cache.get("rem", {}).values():
        if isinstance(c, dict) and "k" in c:
            ks.append(c["k"].float().abs().mean(dim=2))
    if not ks:
        raise ValueError("the cache has no attention layers to prune")
    return (sum(ks) / len(ks))[:, :seq_len]


def _batch_objective(feats: Tensor, kv: KVSelectConfig):
    """The stacked objective over the (B, L, F) pooled features, one row per
    decode row."""
    if kv.objective == "coverage":
        return FeatureCoverage(W=feats.contiguous(), phi="sqrt")
    if kv.objective == "fl":
        return FacilityLocation(sim=torch.stack([
            FacilityLocation.from_features(X, kernel="cosine").sim for X in feats]))
    raise ValueError(f"unknown KV objective {kv.objective!r}")


def select_positions_batched(
    feats: Tensor,
    kv: KVSelectConfig,
    generators: "list[torch.Generator] | None" = None,
    *,
    noise: Tensor | None = None,
) -> Tensor:
    """SS + greedy position selection for the whole decode batch through
    ``summarize_batch``: ``feats`` (B, L, F) nonnegative, one generator per
    row (or SS ``noise`` (B, max_rounds, L)).  Row b equals
    :func:`select_positions` on that row alone.  Returns the sorted (B,
    budget) int64 positions."""
    run = kv.run
    res, _ = summarize_batch(
        _batch_objective(feats, kv), kv.budget, generators, r=run.r, c=run.c,
        use_ss=kv.use_ss, backend=run.backend, compact=run.compact, noise=noise)
    return torch.sort(res.selected, dim=1).values


def select_positions(
    feats: Tensor,
    kv: KVSelectConfig,
    gen: "torch.Generator | None" = None,
    *,
    noise: Tensor | None = None,
) -> Tensor:
    """One row's positions, (L, F) features: the batched path with B = 1
    (``noise`` (max_rounds, L)).  Returns the sorted (budget,) positions."""
    return select_positions_batched(
        feats[None], kv, None if gen is None else [gen],
        noise=None if noise is None else noise[None])[0]


def row_generators(seed: "int | torch.Generator", B: int, device
                   ) -> list[torch.Generator]:
    """One generator per decode row, seeded with ``fold_in(seed, b)`` (the
    counterpart of the reference's ``split(key, B)``)."""
    base = generator(seed, device).initial_seed()
    return [generator(fold_in(base, b), device) for b in range(B)]


def prune_cache(
    cfg,
    cache: dict,
    seq_len: int,
    kv: KVSelectConfig,
    seed: "int | torch.Generator" = 0,
    *,
    noise: Tensor | None = None,
) -> tuple[dict, int, Tensor]:
    """Compact every attention layer's cache to the selected positions.

    Returns (a new cache, its length = ``kv.budget``, the kept (B, budget)
    positions, sorted).  Each k and v leaf of the new cache holds the kept
    positions first, in order, and zeros past ``budget``.  The new cache
    shares no tensor with ``cache``: ``decode_step`` updates its cache in
    place, and ``cache`` must still decode.  Row b's draws come from
    :func:`row_generators` (or ``noise`` (B, max_rounds, seq_len))."""
    feats = pooled_keys(cache, seq_len)
    gens = None if noise is not None else row_generators(seed, feats.shape[0],
                                                         feats.device)
    kept = select_positions_batched(feats, kv, gens, noise=noise)
    return compact_cache(cache, kept), kv.budget, kept


def compact_cache(cache: dict, kept: Tensor) -> dict:
    """A new cache whose k and v leaves hold, for each row b, the positions
    ``kept[b]`` (B, budget) first, in order, and zeros past them; every
    other leaf is copied.  Stacked groups' leaves are (G, B, L, KV, hd),
    the tail's (B, L, KV, hd)."""
    budget = kept.shape[1]

    def compact(tree: dict) -> dict:
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = compact(leaf)
            elif name in ("k", "v"):
                new = torch.zeros_like(leaf)
                lead = leaf.dim() - 4        # 1 for stacked groups, else 0
                for b in range(kept.shape[0]):
                    new.select(lead, b)[..., :budget, :, :] = \
                        leaf.select(lead, b).index_select(lead, kept[b])
                out[name] = new
            else:
                out[name] = leaf.clone()
        return out

    return compact(cache)
