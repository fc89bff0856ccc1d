"""The summarization service's functional core: batched SS, then batched
selection, on a stacked objective.  The counterpart of the functional part
of ``repro/serve/summarize_service.py``: ``RunConfig``, ``batch_buckets``,
``SummarizeRequest``, ``build_batch_objective`` and ``summarize_batch``.
The service itself (lanes, flushers, the recovery and degradation ladders)
is not ported yet.

Row b of ``summarize_batch`` is exactly the single-query pipeline
(``ss_sparsify`` then ``greedy``) on query b under its own draws.  The KV
pruning path (:mod:`repro_torch.serve.kv_select`) runs one decode batch
through it.

Randomness: the JAX package derives every draw from a per-query PRNG key.
Here a query carries a seed (or a ``torch.Generator``); a batch takes one
generator per row.  Streams that the reference derives by ``fold_in`` come
from :func:`fold_in`, a splitmix64 mix of a seed and a number, seeding a
new generator.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.backend import resolve_backend
from repro_torch.core.functions import FacilityLocation, FeatureCoverage
from repro_torch.core.greedy import (
    GreedyResult,
    greedy_batched,
    stochastic_greedy_batched,
)
from repro_torch.core.sparsify import (
    SSResult,
    bucket_schedule,
    ss_live_bound,
    ss_sparsify_batched,
)
from repro_torch.device import resolve_device

Tensor = torch.Tensor

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (splitmix64 of their
    mix): the counterpart of ``jax.random.fold_in`` for seeds.  Streams
    seeded from ``fold_in(s, 1)`` and ``s`` do not replay each other."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def generator(seed: "int | torch.Generator", device) -> torch.Generator:
    """A generator on ``device``: ``seed`` itself when it is one, else a new
    one seeded with it."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=resolve_device(device)).manual_seed(int(seed))


def fold_generators(generators: "list[torch.Generator]", data: int
                    ) -> list[torch.Generator]:
    """One new generator per row, seeded with ``fold_in(initial seed of
    generators[b], data)``, on its device."""
    return [torch.Generator(device=g.device).manual_seed(fold_in(g.initial_seed(), data))
            for g in generators]


# ------------------------------------------------------------- run config ----

@dataclasses.dataclass(frozen=True)
class RunConfig:
    """The execution config of a batched run: the fields of the reference's
    ``RunConfig`` that :func:`summarize_batch`'s callers read.

    ``backend`` ("reference", "cuda", a Backend, or None: by the objective's
    device); ``compact`` the compact-selection policy of ``greedy_batched``
    (None: the static SS live bound); SS's probe multiplier ``r`` and
    accuracy/speed ``c``.  The service's fields (batching, scheduling, fault
    tolerance, degradation) come with the service, which is not ported yet.
    """

    backend: Any = None
    r: int = 8
    c: float = 8.0
    compact: "bool | int | None" = None


def batch_buckets(max_batch: int, c: float = 4.0) -> tuple[int, ...]:
    """Batch-dimension buckets: ``bucket_schedule`` applied to B (tile 1).
    A chunk of j queries pads up to the smallest bucket >= j."""
    return bucket_schedule(max_batch, c, tile=1)


# ----------------------------------------------------------- request API ----

@dataclasses.dataclass(frozen=True)
class SummarizeRequest:
    """One summarization query.

    ``features`` is the (n, F) nonnegative payload (FeatureCoverage's W for
    ``objective="coverage"``, the similarity kernel's input for ``"fl"``);
    ``sim`` a precomputed (n, n) similarity for ``"fl"`` instead.  ``seed``
    is the query's seed or ``torch.Generator``, in place of the reference's
    PRNG key.  ``use_ss=False`` selects on the whole ground set.
    """

    k: int
    seed: "int | torch.Generator"
    features: Any = None
    sim: Any = None
    objective: str = "coverage"     # coverage | fl
    phi: str = "sqrt"               # FeatureCoverage's concave transform
    kernel: str = "cosine"          # FacilityLocation's feature kernel
    use_ss: bool = True

    def generator(self, device) -> torch.Generator:
        """The query's generator on ``device``."""
        return generator(self.seed, device)


# ------------------------------------------------------- functional core ----

def _as_f32(a, dev: torch.device) -> Tensor:
    """A payload on ``dev``: bfloat16 and float32 tensors keep their dtype,
    anything else becomes float32 (as ``jnp.asarray`` with x64 off)."""
    t = torch.as_tensor(np.asarray(a) if not isinstance(a, Tensor) else a)
    if t.dtype not in (torch.float32, torch.bfloat16):
        t = t.float()
    return t.to(dev)


def build_batch_objective(requests: "list[SummarizeRequest]", n_pad: int | None,
                          device="cuda"):
    """Stack one lane's payloads into a stacked objective on ``device`` (the
    card by default), and with ground-set padding to ``n_pad`` the (B,
    n_pad) mask of real elements (else None).  All requests share a lane.
    Facility location's padded rows and columns of the *similarity* are
    zero, which is inert for any kernel (the rbf similarity of a zero
    feature row is not)."""
    dev = resolve_device(device)
    req0 = requests[0]
    if req0.objective == "coverage":
        Ws = [_as_f32(r.features, dev) for r in requests]
        if n_pad is not None:
            Ws = [torch.cat([W, W.new_zeros((n_pad - W.shape[0], W.shape[1]))])
                  for W in Ws]
        fn = FeatureCoverage(W=torch.stack(Ws), phi=req0.phi)
    elif req0.objective == "fl":
        if req0.sim is not None:
            sims = []
            for r in requests:
                s = _as_f32(r.sim, dev)
                if n_pad is not None:
                    s = torch.nn.functional.pad(
                        s, (0, n_pad - s.shape[1], 0, n_pad - s.shape[0]))
                sims.append(s)
        else:
            sims = []
            for r in requests:
                X = _as_f32(r.features, dev)
                n_real = X.shape[0]
                if n_pad is not None:
                    X = torch.cat([X, X.new_zeros((n_pad - n_real, X.shape[1]))])
                s = FacilityLocation.from_features(X, kernel=req0.kernel).sim
                if n_pad is not None:
                    valid = torch.arange(n_pad, device=dev) < n_real
                    s = s * (valid[:, None] & valid[None, :]).to(s.dtype)
                sims.append(s)
        fn = FacilityLocation(sim=torch.stack(sims))
    else:
        raise ValueError(f"unknown objective {req0.objective!r}")
    if n_pad is None:
        return fn, None
    n_reals = [(r.features if r.sim is None else r.sim).shape[0] for r in requests]
    alive = torch.stack([torch.arange(n_pad, device=dev) < m for m in n_reals])
    return fn, alive


def summarize_batch(
    fn,
    k: int,
    generators: "list[torch.Generator] | None" = None,
    *,
    r: int = 8,
    c: float = 8.0,
    use_ss: bool = True,
    alive: Tensor | None = None,
    backend=None,
    compact: "bool | int | None" = None,
    on_step=None,
    selector: str = "greedy",
    eps: float = 0.1,
    s: int | None = None,
    noise: Tensor | None = None,
    selector_noise: Tensor | None = None,
) -> tuple[GreedyResult, SSResult | None]:
    """The service's execution core: batched SS, then batched selection on
    V', for the stacked objective ``fn``.  Row b is the single-query
    pipeline under ``generators[b]``.

    ``compact=None`` derives the static SS live bound (``ss_live_bound``),
    which the selection checks against each row's |V'|.  ``on_step``
    streams the selection's steps (:func:`greedy_batched`).  ``selector``
    is ``"greedy"`` (exact) or ``"stochastic"``
    (:func:`stochastic_greedy_batched`, sample size from ``eps`` / ``s``).

    Draws: SS takes ``generators[b]`` (or ``noise``, (B, max_rounds, n), as
    :func:`ss_sparsify_batched`).  The stochastic selector draws from a
    stream of its own per row, the counterpart of the reference's
    ``fold_in(keys[b], 1)``: a generator seeded with
    ``fold_in(generators[b].initial_seed(), 1)`` (:func:`fold_in`), so it
    never replays the SS stream; a sequential run that is to match derives
    it the same way.  ``selector_noise`` ((k, B, slots)) replaces those
    draws.
    """
    be = resolve_backend(backend, fn.device)
    ss = None
    sel_alive = alive
    if use_ss:
        ss = ss_sparsify_batched(fn, generators, r=r, c=c, alive=alive, backend=be,
                                 noise=noise)
        sel_alive = ss.vprime
        if compact is None:
            compact = ss_live_bound(fn.row(0).n, r, c)
    if selector == "greedy":
        res = greedy_batched(fn, k, alive=sel_alive, backend=be, compact=compact,
                             on_step=on_step)
    elif selector == "stochastic":
        sel_gens = None
        if selector_noise is None and generators is not None:
            sel_gens = fold_generators(generators, 1)
        res = stochastic_greedy_batched(
            fn, k, sel_gens, s=s, alive=sel_alive, backend=be, compact=compact,
            eps=eps, on_step=on_step, noise=selector_noise)
    else:
        raise ValueError(f"selector must be 'greedy' or 'stochastic'; got {selector!r}")
    return res, ss
