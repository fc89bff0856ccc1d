"""The port's ``launch/`` analysis held to the JAX package's.

(a) every cell's ``model_flops``, ``input_specs``, ``all_cells`` status,
``train_config_for`` at the reference's budget, and ``roofline`` on a grid;
(b) every arch's parameter, train-state and cache bytes, leaf by leaf;
(c) the counted FLOPs of a SMOKE prefill and decode against ``hlo_cost`` of
the JAX step compiled on the CPU; (d) the flash operators: the pair count,
fake tensors, and bit-for-bit agreement with the plain version on the CPU;
(e) ``run_cell``'s record and a train step's FLOPs against a hand count.

This file does not import ``repro.launch.dryrun`` (it sets ``XLA_FLAGS`` to
512 host devices when imported) nor ``repro.launch.roofline`` (which
imports it).
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import hlo_analysis, hlo_cost
from repro.launch import steps as jsteps
from repro.launch.mesh import HW as V5E_HW
from repro.models import decoder as jdecoder
from repro.train import trainer as jtrainer
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import attention_bwd_ref, attention_lse_ref, attention_ref
from repro_torch.launch import cost, dryrun, roofline, steps
from repro_torch.launch.mesh import HW
from repro_torch.models import SHAPES, ShapeConfig, abstract_cache, abstract_params
from repro_torch.train.checkpoint import _flatten_with_names
from repro_torch.train.trainer import abstract_train_state

CELLS = [(a, s) for a in configs.ARCHS for s in SHAPES]


def _dt(t) -> str:
    return str(t.dtype).removeprefix("torch.")


# -- (a) the cell tables ------------------------------------------------------


def test_model_flops_input_specs_and_cells_match_the_reference():
    for arch, sname in CELLS:
        assert steps.model_flops(arch, sname) == jsteps.model_flops(arch, sname)
        got = configs.input_specs(configs.get(arch), SHAPES[sname])
        want = jconfigs.input_specs(jconfigs.get(arch), jconfigs.shape(sname))
        assert {k: (tuple(v.shape), _dt(v)) for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}, (arch, sname)
        assert all(v.device.type == "meta" for v in got.values())
    assert list(configs.all_cells()) == list(jconfigs.all_cells())


@pytest.mark.parametrize("batch_shards", [16, 32])
def test_train_config_for_at_the_reference_budget(batch_shards):
    """At the reference's 16 GB chip and its batch shards the rule gives the
    reference's TrainConfig; by default (one 80 GB card) its µ covers the
    stash in 7.5 GB."""
    for arch in configs.ARCHS:
        for sname, shp in SHAPES.items():
            if shp.kind != "train":
                continue
            got = steps.train_config_for(configs.get(arch), shp, batch_shards, 16e9)
            want = jsteps.train_config_for(jconfigs.get(arch), jconfigs.shape(sname),
                                           batch_shards)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
    cfg, shp = configs.get("llama3.2-3b"), SHAPES["train_4k"]
    tc = steps.train_config_for(cfg, shp)
    stash = cfg.num_layers * shp.global_batch * shp.seq_len * cfg.d_model * 2
    assert stash / tc.num_microbatches <= 7.5e9 < stash / (tc.num_microbatches // 2)


def test_roofline_matches_the_reference_on_a_grid():
    grid = itertools.product((0.0, 3.7e12, 2.2e15), (0.0, 5.1e9, 8.8e12),
                             (0.0, 1.3e9, 4.4e11), (0.0, 0.25))
    # the port names its two link rates for the card: the v5e's passed in
    links = dict(V5E_HW, nvlink_bw=V5E_HW["ici_bw"], internode_bw=V5E_HW["dcn_bw"])
    for flops, nbytes, coll, pod in grid:
        got = roofline.roofline(flops, nbytes, coll, links, pod_fraction=pod)
        want = hlo_analysis.roofline(flops, nbytes, coll, V5E_HW, pod_fraction=pod)
        assert got == want, (flops, nbytes, coll, pod)
    # on the card: FLOPs by dtype over their own peaks, no collective term
    rl = roofline.roofline({"bfloat16": 989e12, "float32": 67e12}, 3.35e12, 0.0, HW)
    assert rl["compute_s"] == pytest.approx(2.0) and rl["memory_s"] == 1.0
    assert rl["collective_s"] == 0.0 and rl["dominant"] == "compute"
    with pytest.raises(ValueError, match="float16"):
        roofline.roofline({"float16": 1.0}, 0.0, 0.0, HW)


# -- (b) the state's bytes -------------------------------------------------


def _jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype),
                                      math.prod(x.shape) * x.dtype.itemsize)
            for p, x in flat}


def _torch_leaves(tree) -> dict:
    names, leaves = _flatten_with_names(tree)
    assert all(t.device.type == "meta" for t in leaves)
    return {n: (tuple(t.shape), _dt(t), t.numel() * t.element_size())
            for n, t in zip(names, leaves)}


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_state_bytes_match_the_reference_leaf_by_leaf(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    shp = SHAPES["train_4k"]
    tc = steps.train_config_for(cfg, shp, 16, 16e9)
    jtc = jsteps.train_config_for(jcfg, jconfigs.shape("train_4k"), 16)
    B, L = 8, 4096
    assert _torch_leaves(abstract_params(cfg)) == _jax_leaves(jdecoder.abstract_params(jcfg))
    assert _torch_leaves(abstract_train_state(cfg, tc)) == \
        _jax_leaves(jtrainer.abstract_train_state(jcfg, jtc))
    assert _torch_leaves(abstract_cache(cfg, B, L)) == \
        _jax_leaves(jdecoder.abstract_cache(jcfg, B, L))


# -- (c) FLOPs against the reference's HLO ---------------------------------


def _smoke32(arch):
    """The SMOKE config at head_dim 32, the flash kernels' narrowest (8 and
    16 have no kernel, and the count follows the card's route)."""
    return (dataclasses.replace(configs.smoke(arch), head_dim=32),
            dataclasses.replace(jconfigs.smoke(arch), head_dim=32))


def _jax_flops(fn, *args) -> float:
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text())["flops"]


def _blockwise_flops(cfg, B: int, S: int) -> float:
    """The reference's attention FLOPs: every padded (q-block, k-block) tile
    of ``blockwise_attention``, 4·B·H·Sq·Sk·hd a layer
    (``src/repro/models/attention.py:129-238``)."""
    bq, bk = min(512, S), min(1024, S)
    Sq, Sk = -(-S // bq) * bq, -(-S // bk) * bk
    return cfg.num_layers * 4.0 * B * cfg.num_heads * Sq * Sk * cfg.head_dim


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-4b"])
def test_prefill_and_decode_flops_match_hlo_cost(arch):
    cfg, jcfg = _smoke32(arch)
    B, S = 2, 600                  # past one 512-row query block: JAX pads
    pre = dryrun.run_cell(arch, ShapeConfig("p", S, B, "prefill"), cfg)
    flash = sum(r["flops"] for r in pre["cost"]["top_by_flops"]
                if r["op"] == "repro_torch.flash_attention")
    assert flash == cfg.num_layers * 4 * cfg.head_dim * B * cfg.num_heads * S * (S + 1) // 2
    jparams = jdecoder.abstract_params(jcfg)
    toks = jax.ShapeDtypeStruct((B, S), jnp.int32)
    want = _jax_flops(lambda p, t: jdecoder.prefill(jcfg, p, t, max_len=S), jparams, toks)
    assert pre["cost"]["flops_per_chip"] - flash + _blockwise_flops(cfg, B, S) == want

    dec = dryrun.run_cell(arch, ShapeConfig("d", S, B, "decode"), cfg)
    cache = jdecoder.abstract_cache(jcfg, B, S)
    want = _jax_flops(lambda p, t, c, n: jdecoder.decode_step(jcfg, p, t, c, n), jparams,
                      jax.ShapeDtypeStruct((B, 1), jnp.int32), cache,
                      jax.ShapeDtypeStruct((), jnp.int32))
    assert dec["cost"]["flops_per_chip"] == want
    assert dec["cost"]["attention_pairs"] == 0


# -- (d) the flash operators -------------------------------------------------


@pytest.mark.parametrize("S", [1, 7, 33, 101])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 1), (True, 5),
                                           (True, 64), (True, 200), (False, 0)])
def test_pair_count_matches_the_mask(S, causal, window):
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    keep = np.ones((S, S), bool)
    if causal:
        keep = i >= j
        if window:
            keep &= i - j < window
    assert cost.attention_pairs(S, causal, window) == int(keep.sum())


def test_flash_ops_under_fake_tensors_build_and_launch_nothing(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_build(*a, **k):
        raise AssertionError("a fake tensor reached the kernels' build")

    monkeypatch.setattr(fa._build, "load_library", no_build)
    launches = (fa.flash_attention_kernel.launches, fa.flash_attention_bwd_kernel.launches)
    with FakeTensorMode():
        for dtype, hd in ((torch.bfloat16, 256), (torch.float32, 64)):
            q = torch.empty((2, 40, 10, hd), dtype=dtype, device="meta", requires_grad=True)
            k, v = (torch.empty((2, 40, 1, hd), dtype=dtype, device="meta",
                                requires_grad=True) for _ in range(2))
            o = fa.flash_attention_kernel(q, k, v, causal=True, window=16)
            grads = torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
            assert (o.shape, o.dtype) == (q.shape, dtype)
            assert [(g.shape, g.dtype) for g in grads] == [(t.shape, dtype) for t in (q, k, v)]
            o2, L = fa.flash_attention_lse(q.detach(), k.detach(), v.detach())
            assert o2.shape == q.shape and (L.shape, L.dtype) == ((2, 10, 40), torch.float32)
    assert (fa.flash_attention_kernel.launches,
            fa.flash_attention_bwd_kernel.launches) == launches


@pytest.mark.parametrize("window", [0, 9])
def test_flash_ops_on_the_cpu_equal_the_plain_version_bit_for_bit(window):
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 37, 6, 32, generator=g)
    k, v = (torch.randn(2, 37, 2, 32, generator=g) for _ in range(2))
    do = torch.randn(2, 37, 6, 32, generator=g)
    ops = torch.ops.repro_torch
    assert torch.equal(ops.flash_attention(q, k, v, True, window),
                       attention_ref(q, k, v, True, window))
    o, L = ops.flash_attention_lse(q, k, v, True, window)
    o_ref, L_ref = attention_lse_ref(q, k, v, True, window)
    assert torch.equal(o, o_ref) and torch.equal(L, L_ref)
    got = ops.flash_attention_bwd(q, k, v, o, do, L, True, window)
    want = attention_bwd_ref(q, k, v, o_ref, do, L_ref, True, window)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # through autograd: FlashAttentionFn's forward and gradients
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.FlashAttentionFn.apply(qs, ks, vs, True, window)
    assert torch.equal(out, o_ref)
    grads = torch.autograd.grad(out, (qs, ks, vs), do)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


# -- (e) run_cell ----------------------------------------------------------------


_KEYS = {"arch", "shape", "mesh", "chips", "status", "count_s", "kind", "meta",
         "memory", "cost", "roofline", "model_flops_total", "model_flops_per_chip",
         "useful_flops_ratio"}


def test_run_cell_writes_every_key_and_counts_a_train_step_by_hand():
    cfg = _smoke32("llama3.2-3b")[0]
    B, S = 2, 32
    recs = {kind: dryrun.run_cell("llama3.2-3b", ShapeConfig(kind, S, B, kind), cfg)
            for kind in ("train", "prefill", "decode")}
    for kind, rec in recs.items():
        assert set(rec) == _KEYS and rec["status"] == "ok" and rec["kind"] == kind
        assert set(rec["memory"]) == {"analytic_state_bytes", "peak_bytes", "fits_80gb"}
        assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                        "dominant", "step_time_lower_bound_s",
                                        "roofline_fraction"}
        assert rec["cost"]["bytes_per_chip"] > 0
        assert rec["memory"]["peak_bytes"] >= rec["memory"]["analytic_state_bytes"]
    assert recs["train"]["meta"]["remat"] == "nothing"
    assert recs["train"]["meta"]["microbatches"] == 1

    # the hand count: each layer's projections and FFN, the tied lm head;
    # the backward twice the forward's products; under remat the forward
    # of every (checkpointed) layer again but its last product, the FFN's
    # down projection (non-reentrant checkpointing stops recomputing once
    # every tensor the backward saved is back, and that product's output is
    # not one); flash 4 hd a kept pair in each forward, 10 hd in the backward
    T, d, f, L = B * S, cfg.d_model, cfg.d_ff, cfg.num_layers
    layer = 2 * T * d * (2 * cfg.q_dim + 2 * cfg.kv_dim + 3 * f)
    fwd = L * layer + 2 * T * d * cfg.vocab_size
    recompute = L * (layer - 2 * T * f * d)
    pairs = B * cfg.num_heads * S * (S + 1) // 2
    flash = L * pairs * cfg.head_dim * (4 + 4 + 10)
    train = recs["train"]["cost"]
    assert train["flops_per_chip"] == 3 * fwd + recompute + flash
    assert train["flops_by_dtype"] == {"float32": train["flops_per_chip"]}
    assert train["attention_pairs"] == 3 * L * pairs


def test_a_host_read_inside_the_step_fails_the_count():
    cell = steps.build_cell("llama3.2-3b", ShapeConfig("d", 16, 2, "decode"),
                            _smoke32("llama3.2-3b")[0])
    fn = cell.fn
    cell.fn = lambda p, t, c: fn(p, t, c)[0].sum().item()
    with pytest.raises(cost.HostRead, match="_local_scalar_dense"):
        cost.count(cell)
