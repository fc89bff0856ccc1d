"""Decoder-only LM assembly for every block type the configs use: the
counterpart of ``repro/models/decoder.py``.

Params layout (plain nested dicts of tensors), the reference's own:

    {"embed":  {...},
     "blocks": {"p0": <stacked over groups>, "p1": ..., ...},
     "rem":    {"r0": ..., ...},                # the unstacked tail
     "final_norm": {...}}

``blocks.p<i>`` holds the i-th entry of ``cfg.block_pattern`` stacked over
the ``cfg.num_groups`` pattern repetitions.  The reference scans over the
groups; here a Python loop walks them, taking group g's parameters as views
(``[g]``) of the stacked tensors.  The decode cache keeps the same layout:
``{"k", "v"}`` (G, B, L, KV, hd) for attention blocks, ``{"conv", "ssm"}``
for ``mamba2`` and ``{"conv", "h"}`` for ``rglru``, each layer's state
updated in place.

Block types: ``attn`` (full causal attention + FFN), ``attn_moe``
(attention + mixture of experts, :mod:`repro_torch.models.moe`), ``local``
(sliding-window attention + FFN), ``mamba2`` (the SSD mixer alone,
:mod:`repro_torch.models.ssm`) and ``rglru`` (the RG-LRU mixer + FFN,
:mod:`repro_torch.models.rglru`).

Entry points: ``forward`` (with the reference's remat policies, for
training), ``lm_loss``, ``prefill``, ``init_cache``, ``decode_step``;
``abstract_params`` and ``abstract_cache`` give the trees as meta tensors
(the dry run's inputs).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.utils.checkpoint as tc
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (
    DATA,
    POD,
    cache_spec_tree,
    constrain,
    current_mesh,
    local_range,
    local_region,
    local_write,
    redistribute,
    zeros_on,
)
from repro_torch.models.layers import (
    Params,
    dtype_of,
    embed_tokens,
    embedding_init,
    ffn,
    ffn_init,
    rmsnorm,
    rmsnorm_init,
    unembed,
)

Tensor = torch.Tensor

_ATTN = ("attn", "attn_moe", "local")      # the block types with attention


def _group(tree: Params, g: int) -> Params:
    """Group g's slice (views) of a tree stacked over groups."""
    return {k: _group(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_init(gen: torch.Generator, cfg: ModelConfig, btype: str,
                lead: tuple[int, ...] = ()) -> Params:
    pdt = dtype_of(cfg.param_dtype)
    d, dev = cfg.d_model, gen.device
    p: Params = {"ln1": rmsnorm_init(d, pdt, dev, lead)}
    if btype in _ATTN:
        p["attn"] = attn.attention_init(gen, cfg, lead)
        p["ln2"] = rmsnorm_init(d, pdt, dev, lead)
        if btype == "attn_moe":
            p["moe"] = moe_lib.moe_init(gen, cfg, lead)
        else:
            p["ffn"] = ffn_init(gen, d, cfg.d_ff, pdt, gated=cfg.mlp_gated,
                                lead=lead)
    elif btype == "mamba2":
        p["mixer"] = ssm_lib.mamba2_init(gen, cfg, lead)
    elif btype == "rglru":
        p["mixer"] = rglru_lib.rglru_init(gen, cfg, lead)
        p["ln2"] = rmsnorm_init(d, pdt, dev, lead)
        p["ffn"] = ffn_init(gen, d, cfg.d_ff, pdt, gated=cfg.mlp_gated, lead=lead)
    else:
        raise ValueError(f"unknown block type {btype!r}")
    return p


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device="cuda") -> Params:
    """Synthetic parameters in ``cfg.param_dtype`` on ``device`` (the card by
    default), drawn from ``generator`` (on that device), with the reference's
    shapes and standard deviations.  The draws differ from ``jax.random``'s:
    tests that compare the two packages carry the JAX parameters across with
    ``convert.model_params_from_numpy``."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"init_params: the generator is on {generator.device}, "
                         f"not {dev}")
    pdt = dtype_of(cfg.param_dtype)
    params: Params = {"embed": embedding_init(generator, cfg)}
    params["blocks"] = {
        f"p{i}": _block_init(generator, cfg, btype, (cfg.num_groups,))
        for i, btype in enumerate(cfg.block_pattern)
    }
    params["rem"] = {f"r{i}": _block_init(generator, cfg, btype)
                     for i, btype in enumerate(cfg.remainder_blocks)}
    params["final_norm"] = rmsnorm_init(cfg.d_model, pdt, dev)
    return params


def _to_meta(tree: Params) -> Params:
    return {k: _to_meta(v) if isinstance(v, dict)
            else torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameters' tree as meta tensors: shapes and dtypes, no memory
    (built under ``FakeTensorMode``: nothing is drawn)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = init_params(torch.Generator(), cfg, device="cpu")
    return _to_meta(fake)


# ---------------------------------------------------------------------------
# forward (prefill without a cache)
# ---------------------------------------------------------------------------

def _layers(cfg: ModelConfig, params: Params, cache: Params | None = None):
    """(btype, params, cache or None) of every layer in order: group by
    group through the pattern, then the tail."""
    for g in range(cfg.num_groups):
        for i, btype in enumerate(cfg.block_pattern):
            key = f"p{i}"
            yield (btype, _group(params["blocks"][key], g),
                   None if cache is None else _group(cache["blocks"][key], g))
    for i, btype in enumerate(cfg.remainder_blocks):
        key = f"r{i}"
        yield (btype, params["rem"][key],
               None if cache is None else cache["rem"][key])


def _window(cfg: ModelConfig, btype: str) -> int:
    return cfg.local_window if btype == "local" else 0


def _residual(x: Tensor) -> Tensor:
    """The residual stream between sublayers pinned as the reference lays
    out activations: batch over pod x data, d_model whole (tensor
    parallelism happens inside the mixers and FFNs).  Unpinned, DTensor
    reduces a sublayer's Partial output onto the sequence over model, and
    on a 3-D mesh its planner then takes minutes over the flattened rows'
    strided split.  A no-op without a mesh."""
    return constrain(x, (POD, DATA), None, None)


def _second_half(cfg: ModelConfig, btype: str, p: Params,
                 x: Tensor) -> tuple[Tensor, Tensor | None]:
    """The sublayer after a block's mixer (whose residual sum is ``x``):
    experts (``attn_moe``, with their aux loss), the FFN (``attn``,
    ``local``, ``rglru``), or none (``mamba2``).  Returns (x, aux or
    None)."""
    x = _residual(x)
    if btype == "mamba2":
        return x, None
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if btype == "attn_moe":
        y, aux = moe_lib.moe_forward(p["moe"], cfg, h2)
        return _residual(x + y), aux
    return _residual(x + ffn(p["ffn"], h2, dtype_of(cfg.compute_dtype), cfg.mlp_act)), None


def _copy(c: Tensor, t: Tensor) -> None:
    c.copy_(t)


def _store(cache: Params, new: dict) -> None:
    """Write a recurrent mixer's new state into this layer's cache views
    (on DTensors, each rank its shard: ``local_write``)."""
    for name, t in new.items():
        local_write(cache[name], t, _copy)


def _pin_logits(logits: Tensor) -> Tensor:
    """The returned logits split as ``data_spec`` splits a (B, ...) array:
    batch over pod x data, the vocab whole (the reference's out sharding
    of its prefill and decode cells); a no-op without a mesh."""
    return constrain(logits, (POD, DATA), *(None,) * (logits.ndim - 1))


def _embed(cfg: ModelConfig, params: Params, tokens: Tensor,
           patches: Tensor | None) -> Tensor:
    x = embed_tokens(params["embed"], cfg, tokens)
    if cfg.input_mode == "tokens+patches":
        if patches is None:
            raise ValueError(f"{cfg.name} takes patches (B, P, d_model)")
        P = patches.shape[1]
        x = torch.cat([patches.to(x.dtype), x[:, P:]], dim=1)
    return x


def _block_apply(cfg: ModelConfig, btype: str, p: Params, x: Tensor,
                 positions: Tensor, aux: Tensor) -> tuple[Tensor, Tensor]:
    """One block over the full sequence; returns (x, aux plus the block's
    load-balance loss)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if btype in _ATTN:
        y = attn.attention_forward(p["attn"], cfg, h, positions,
                                   window=_window(cfg, btype))
    elif btype == "mamba2":
        y = ssm_lib.mamba2_forward(p["mixer"], cfg, h)
    else:
        y = rglru_lib.rglru_forward(p["mixer"], cfg, h)
    x, a = _second_half(cfg, btype, p, x + y)
    return x, aux if a is None else aux + a


def _unstack(tree: Params, G: int) -> list[Params]:
    """The G groups of a tree stacked over groups, as views from one
    ``unbind`` per leaf.  Under autograd each leaf's gradient is then one
    stack of its G slices; a view ``[g]`` a group would add a zero-filled
    gradient of the whole stack per group (G^2 / 2 stacks of traffic)."""
    parts = {k: _unstack(v, G) if isinstance(v, dict) else torch.unbind(v)
             for k, v in tree.items()}
    return [{k: v[g] for k, v in parts.items()} for g in range(G)]


def _groups_apply(cfg: ModelConfig, groups: list[Params], lo: int, hi: int,
                  positions: Tensor, x: Tensor, aux: Tensor,
                  inner=None) -> tuple[Tensor, Tensor]:
    """Groups [lo, hi) (``_unstack``'s), the reference's scan body one group
    at a time; ``inner(body, x, aux)`` wraps each group (a checkpoint), None
    runs it as it is."""
    for g in range(lo, hi):
        def body(x, aux, gp=groups[g]):
            x = constrain(x, (POD, DATA), None, None)
            for i, btype in enumerate(cfg.block_pattern):
                x, aux = _block_apply(cfg, btype, gp[f"p{i}"], x, positions, aux)
            return x, aux
        x, aux = body(x, aux) if inner is None else inner(body, x, aux)
    return x, aux


# ``dots``: keep the outputs of the plain matrix products (the reference's
# dots_with_no_batch_dims_saveable: x @ W, not attention's batched
# einsums), recompute the rest.
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    return (tc.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else tc.CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpoint(body, *args, context_fn=None):
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return tc.checkpoint(body, *args, use_reentrant=False, **kw)


REMAT_POLICIES = ("none", "nothing", "dots", "nested")


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: Tensor,                 # (B, S) or (B, S, K) codebooks
    patches: Tensor | None = None,  # (B, P, D) for tokens+patches mode
    *,
    remat: str = "nothing",
    logits_slice: int = 0,          # >0: only last N positions get logits
) -> tuple[Tensor, Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss): the sum of the
    MoE layers' load-balance losses (0 without experts), float32.

    ``remat`` is the reference's rematerialisation policy under autograd
    (it changes no value): ``"none"`` keeps every activation;
    ``"nothing"`` checkpoints each group of the block pattern (a layer, for
    a pattern of one block: ``torch.utils.checkpoint``, non-reentrant),
    keeping only its input; ``"dots"`` keeps the plain matrix products'
    outputs as well (selective checkpointing); ``"nested"`` checkpoints
    about √G chunks of groups, each group inside again (two levels; plain
    ``"nothing"`` below 4 groups).  The unstacked tail blocks run without
    a checkpoint, as in the reference."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}")
    x = _embed(cfg, params, tokens, patches)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    G = cfg.num_groups
    blocks = _unstack(params["blocks"], G)
    if not torch.is_grad_enabled() or remat == "none":
        x, aux = _groups_apply(cfg, blocks, 0, G, positions, x, aux)
    elif remat == "dots":
        ctx = functools.partial(tc.create_selective_checkpoint_contexts,
                                _dots_policy)
        x, aux = _groups_apply(
            cfg, blocks, 0, G, positions, x, aux,
            inner=lambda body, x, aux: _checkpoint(body, x, aux, context_fn=ctx))
    elif remat == "nested" and G >= 4:
        # two levels: ~sqrt(G) outer chunks, each a checkpointed run of
        # checkpointed groups; the stash drops from G group inputs to
        # chunks + G / chunks, for one more forward of a chunk
        outer = max(2, int(math.sqrt(G)))
        while G % outer != 0:
            outer -= 1
        inner = G // outer
        for c in range(outer):
            def chunk(x, aux, c=c):
                return _groups_apply(cfg, blocks, c * inner, (c + 1) * inner,
                                     positions, x, aux, inner=_checkpoint)
            x, aux = _checkpoint(chunk, x, aux)
    else:
        x, aux = _groups_apply(cfg, blocks, 0, G, positions, x, aux,
                               inner=_checkpoint)
    for i, btype in enumerate(cfg.remainder_blocks):
        x, aux = _block_apply(cfg, btype, params["rem"][f"r{i}"], x, positions, aux)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_slice > 0:
        x = x[:, -logits_slice:]
    return unembed(params["embed"], cfg, x), aux


def lm_loss(
    cfg: ModelConfig,
    logits: Tensor,      # (B, S, V) or (B, S, K, V)
    labels: Tensor,      # (B, S) or (B, S, K) integers; negatives are masked
) -> Tensor:
    """Mean next-token cross entropy over unmasked positions (float32).

    The reference's order: the max over V (held constant), exp, sum, log;
    the label's logit by ``gather``, which gives the reference's one-hot sum
    exactly (its other terms add 0).  On DTensor logits with the vocab over
    model the max, exp, sum and log reduce over the shards, and the label's
    logit comes from the rank whose block holds it (:func:`_label_logit`):
    the (B, S, V) logits are never gathered."""
    valid = labels >= 0
    labels_safe = labels.clamp_min(0).long()
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    # exp in place on the fresh difference: one (B, S, V) float32 buffer less
    lse = torch.log(torch.exp_(lf - m).sum(dim=-1)) + m[..., 0]
    if isinstance(lf, DTensor):
        label_logit = _label_logit(lf, labels_safe)
    else:
        label_logit = lf.gather(-1, labels_safe[..., None])[..., 0]
    nll = lse - label_logit
    return (nll * valid).sum() / valid.sum().clamp_min(1)


def _label_logit(lf: DTensor, labels: DTensor) -> DTensor:
    """The label's logit of vocab-sharded logits: each rank gathers the
    labels inside its vocab block (zeros elsewhere), a local region whose
    output is Partial over the vocab's mesh dimensions (a sum of one
    nonzero term, as the reference's one-hot contraction)."""
    from torch.distributed.tensor import Partial, Shard

    vd = lf.ndim - 1
    lo, hi = local_range(lf, vd)
    out_pl = tuple(Partial() if isinstance(p, Shard) and p.dim == vd else p
                   for p in lf.placements)
    lab_pl = tuple(Replicate() if isinstance(p, Partial) else p for p in out_pl)
    labels = redistribute(labels, lab_pl)

    def body(l, y):
        if (lo, hi) == (0, lf.shape[vd]):       # the whole vocab: the plain gather
            return l.gather(-1, y[..., None])[..., 0]
        inside = (y >= lo) & (y < hi)
        got = l.gather(-1, torch.where(inside, y - lo, 0)[..., None])[..., 0]
        return torch.where(inside, got, 0.0)

    return local_region(body, (lf, labels), (out_pl, tuple(labels.shape)))


# ---------------------------------------------------------------------------
# prefill (forward + populated decode cache)
# ---------------------------------------------------------------------------

def _block_prefill(cfg: ModelConfig, btype: str, p: Params, x: Tensor,
                   positions: Tensor, cache: Params) -> Tensor:
    """One block over the prompt; writes its decode state into ``cache``
    (this layer's ``init_cache`` views) in place."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if btype in _ATTN:
        y, _ = attn.attention_prefill(p["attn"], cfg, h, positions, cache,
                                      window=_window(cfg, btype))
    else:
        mixer = ssm_lib.mamba2_forward if btype == "mamba2" else \
            rglru_lib.rglru_forward
        y, new = mixer(p["mixer"], cfg, h, return_cache=True)
        _store(cache, new)
    return _second_half(cfg, btype, p, x + y)[0]


def prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: Tensor,
    patches: Tensor | None = None,
    *,
    max_len: int,
) -> tuple[Tensor, Params]:
    """Full-sequence forward that also populates the decode cache.

    Returns (last-position logits (B, 1, V...), cache).  On DTensors
    under a mesh (``sharding.use_mesh``) the cache is made split as
    ``cache_spec_tree`` splits it, each rank allocating and writing its own
    shards, and the logits come back split as ``data_spec`` splits them."""
    x = _embed(cfg, params, tokens, patches)
    positions = torch.arange(x.shape[1], device=x.device)
    mesh = current_mesh() if isinstance(x, DTensor) else None
    dev = x.to_local().device if isinstance(x, DTensor) else x.device
    cache = init_cache(cfg, x.shape[0], max_len, device=dev, mesh=mesh)
    for btype, p, c in _layers(cfg, params, cache):
        x = _block_prefill(cfg, btype, p, constrain(x, (POD, DATA), None, None),
                           positions, c)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _pin_logits(unembed(params["embed"], cfg, x[:, -1:])), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _block_cache_init(cfg: ModelConfig, btype: str, batch: int, max_len: int,
                      dev: torch.device, lead: tuple[int, ...] = ()) -> Params:
    if btype in _ATTN:
        return attn.kv_cache_init(cfg, batch, max_len, _window(cfg, btype),
                                  device=dev, lead=lead)
    if btype == "mamba2":
        return ssm_lib.mamba2_cache_init(cfg, batch, device=dev, lead=lead)
    if btype == "rglru":
        return rglru_lib.rglru_cache_init(cfg, batch, device=dev, lead=lead)
    raise ValueError(f"unknown block type {btype!r}")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda", mesh=None) -> Params:
    """Decode cache, stacked over groups like the params.  With a
    ``DeviceMesh`` ``mesh``, DTensors split as ``cache_spec_tree`` splits
    them, each rank holding its shards on ``device``."""
    dev = resolve_device(device)
    if mesh is not None:
        from torch.utils._python_dispatch import _disable_current_modes

        with _disable_current_modes():      # shapes only: no operator of the step
            shapes = abstract_cache(cfg, batch, max_len)
        specs = cache_spec_tree(cfg, shapes, mesh)

        def build(shape_tree, spec_tree):
            return {k: build(v, spec_tree[k]) if isinstance(v, dict)
                    else zeros_on(mesh, spec_tree[k], tuple(v.shape), v.dtype, dev)
                    for k, v in shape_tree.items()}

        return build(shapes, specs)
    return {
        "blocks": {
            f"p{i}": _block_cache_init(cfg, btype, batch, max_len, dev,
                                       (cfg.num_groups,))
            for i, btype in enumerate(cfg.block_pattern)
        },
        "rem": {
            f"r{i}": _block_cache_init(cfg, btype, batch, max_len, dev)
            for i, btype in enumerate(cfg.remainder_blocks)
        },
    }


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    """``init_cache``'s tree as meta tensors: shapes and dtypes, no memory."""
    return init_cache(cfg, batch, max_len, device="meta")


def _block_decode(cfg: ModelConfig, btype: str, p: Params, x: Tensor, cache,
                  cache_len: int, pos: int | None = None) -> Tensor:
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if btype in _ATTN:
        y, _ = attn.attention_decode(p["attn"], cfg, h, cache, cache_len,
                                     window=_window(cfg, btype), pos=pos)
    else:
        mixer = ssm_lib.mamba2_decode if btype == "mamba2" else \
            rglru_lib.rglru_decode
        y, new = mixer(p["mixer"], cfg, h, cache)
        _store(cache, new)
    return _second_half(cfg, btype, p, x + y)[0]


def decode_step(
    cfg: ModelConfig,
    params: Params,
    tokens: Tensor,      # (B, 1) or (B, 1, K)
    cache: Params,
    cache_len: int,      # tokens already in the cache
    pos: int | None = None,  # true sequence position (after KV pruning)
) -> tuple[Tensor, Params]:
    """One-token decode.  Returns (logits (B, 1, V...), the cache), which
    is updated in place (the reference returns a new one)."""
    x = embed_tokens(params["embed"], cfg, tokens)
    for btype, p, c in _layers(cfg, params, cache):
        x = _block_decode(cfg, btype, p, x, c, cache_len, pos)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _pin_logits(unembed(params["embed"], cfg, x)), cache
