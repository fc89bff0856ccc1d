"""SS pruning of the KV cache: the port held against ``repro.serve.kv_select``
on the CPU.

The JAX package prunes with the row keys ``split(key, B)``; its row b draws
SS's round-j noise from the j-th split of that key, which ``_ss_noise``
rebuilds and hands to the port as ``noise``.  Kept positions must be
identical and the pruned leaves equal; the decode from the pruned cache is
held to the JAX decode as ``tests/test_torch_engine.py`` holds generation
(identical greedy tokens) and to rtol 1e-4 with atol 1e-4 x max|logits|, the
float32 tolerance of ``tests/test_torch_models.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.serve import KVSelectConfig as JKVSelectConfig
from repro.serve import prune_cache as jprune_cache
from repro.serve import select_positions_batched as jselect_positions_batched
from repro.serve.kv_select import pooled_keys as jpooled_keys
from repro_torch import configs
from repro_torch.convert import cache_from_numpy, model_params_from_numpy
from repro_torch.core import max_rounds
from repro_torch.launch import serve as serve_cli
from repro_torch.models import decode_step
from repro_torch.serve import (
    Engine,
    KVSelectConfig,
    RunConfig,
    ServeConfig,
    pooled_keys,
    prune_cache,
    select_positions,
    select_positions_batched,
)
from repro_torch.serve.kv_select import row_generators


def _ss_noise(keys, n):
    out = []
    for key in keys:
        rows = []
        for _ in range(max_rounds(n)):
            key, k1 = jax.random.split(key)
            rows.append(np.asarray(jax.random.gumbel(k1, (n,))))
        out.append(np.stack(rows))
    return torch.from_numpy(np.stack(out))


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _feats(B, L, F, seed=0):
    return np.stack([np.abs(np.asarray(jax.random.normal(jax.random.PRNGKey(seed + i),
                                                          (L, F)))) for i in range(B)])


@pytest.fixture(scope="module")
def served():
    """llama3.2-3b's smoke config prefilled on both packages (B = 2, S = 32)."""
    jcfg, tcfg = jax_configs.smoke("llama3.2-3b"), configs.smoke("llama3.2-3b")
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    B, S = 2, 32
    toks = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, jcfg.vocab_size)
    jlogits, jcache = jprefill(jcfg, jparams, toks, max_len=S + 8)
    params = model_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, params=params, B=B, S=S,
                jlogits=jlogits, jcache=jcache,
                cache=cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu"))


def test_pooled_keys_match_jax(served):
    got = pooled_keys(served["cache"], served["S"])
    want = jpooled_keys(served["jcache"], served["S"])
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    with pytest.raises(ValueError, match="no attention layers"):
        pooled_keys({"blocks": {}, "rem": {}}, 4)


@pytest.mark.parametrize("objective", ["coverage", "fl"])
@pytest.mark.parametrize("L", [64, 300])
def test_select_positions_batched_matches_jax_and_single_rows(objective, L):
    feats = _feats(3, L, 16)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    want = jselect_positions_batched(
        jnp.asarray(feats), JKVSelectConfig(budget=8, objective=objective), keys)
    kv = KVSelectConfig(budget=8, objective=objective)
    noise = _ss_noise(keys, L)
    got = select_positions_batched(torch.from_numpy(feats), kv, noise=noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for b in range(3):
        row = select_positions(torch.from_numpy(feats[b]), kv, noise=noise[b])
        assert torch.equal(row, got[b])
    # under generators, row b equals the single row under the same generator
    gens = [torch.Generator().manual_seed(b) for b in range(3)]
    batched = select_positions_batched(torch.from_numpy(feats), kv, gens)
    for b in range(3):
        row = select_positions(torch.from_numpy(feats[b]), kv,
                               torch.Generator().manual_seed(b))
        assert torch.equal(row, batched[b])


def test_kv_select_config_defaults_resolve_by_device():
    kv = KVSelectConfig()
    assert kv.budget == 256 and kv.objective == "coverage" and kv.use_ss
    assert kv.run.backend is None
    with pytest.raises(ValueError, match="KV objective"):
        select_positions_batched(torch.ones(1, 8, 4), KVSelectConfig(objective="x"))
    ablation = KVSelectConfig(budget=5, use_ss=False)
    feats = torch.from_numpy(_feats(2, 40, 8))
    got = select_positions_batched(feats, ablation)
    want = jselect_positions_batched(jnp.asarray(feats.numpy()),
                                     JKVSelectConfig(budget=5, use_ss=False),
                                     jax.random.split(jax.random.PRNGKey(0), 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # an explicit backend rides on run
    plain = KVSelectConfig(budget=5, run=RunConfig(backend="reference"))
    assert torch.equal(select_positions_batched(feats, plain, [torch.Generator()] * 2),
                       select_positions_batched(feats, KVSelectConfig(budget=5),
                                                [torch.Generator()] * 2))


@pytest.mark.parametrize("objective", ["coverage", "fl"])
def test_prune_cache_matches_jax_and_decodes(served, objective):
    B, S, budget = served["B"], served["S"], 12
    key = jax.random.PRNGKey(2)
    jpruned, jclen, jkept = jprune_cache(
        served["jcfg"], served["jcache"], S, JKVSelectConfig(budget=budget,
                                                             objective=objective), key)
    cache = served["cache"]
    before = {n: t.clone() for n, t in cache["blocks"]["p0"].items()}
    pruned, clen, kept = prune_cache(
        served["tcfg"], cache, S, KVSelectConfig(budget=budget, objective=objective),
        noise=_ss_noise(jax.random.split(key, B), S))
    assert clen == int(jclen) == budget
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    assert kept.shape == (B, budget) and bool((kept >= 0).all() & (kept < S).all())
    assert bool((kept.diff(dim=1) > 0).all())
    for name in ("k", "v"):
        got, want = pruned["blocks"]["p0"][name], jpruned["blocks"]["p0"][name]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert not got[:, :, budget:].any()
        assert got.data_ptr() != cache["blocks"]["p0"][name].data_ptr()

    # decode from the pruned cache at the true position, as the JAX package
    nxt = jnp.argmax(served["jlogits"], -1).astype(jnp.int32)
    jout, _ = jdecode_step(served["jcfg"], served["jparams"], nxt, jpruned, jclen,
                           pos=jnp.int32(S))
    out, _ = decode_step(served["tcfg"], served["params"],
                         torch.from_numpy(np.array(nxt)).long(), pruned, clen, pos=S)
    _close(out.numpy(), jout)
    np.testing.assert_array_equal(out.argmax(-1).numpy(), np.asarray(jout.argmax(-1)))
    # the cache that was pruned is unchanged, and still decodes as JAX's does
    for name, t in before.items():
        assert torch.equal(cache["blocks"]["p0"][name], t)
    jfull, _ = jdecode_step(served["jcfg"], served["jparams"], nxt, served["jcache"],
                            jnp.int32(S))
    full, _ = decode_step(served["tcfg"], served["params"],
                          torch.from_numpy(np.array(nxt)).long(),
                          {k: {kk: {n: t.clone() for n, t in vv.items()}
                               for kk, vv in v.items()} for k, v in cache.items()}, S)
    _close(full.numpy(), jfull)


def test_engine_prune_kv_then_decode_and_the_old_cache_still_decodes(served):
    eng = Engine(served["tcfg"], served["params"], ServeConfig(max_len=40), device="cpu")
    S = served["S"]
    toks = torch.from_numpy(np.array(
        jax.random.randint(jax.random.PRNGKey(1), (2, S), 0, served["tcfg"].vocab_size))).long()
    logits, cache = eng.prefill(toks)
    pruned, n, kept = eng.prune_kv(cache, S, 3, KVSelectConfig(budget=10))
    again, _, kept2 = eng.prune_kv(cache, S, 3, KVSelectConfig(budget=10))
    assert torch.equal(kept, kept2) and n == 10          # a seed repeats
    tok = logits.argmax(-1)
    out, _ = eng.decode_with_cache(tok, pruned, n, pos=S)
    full, _ = eng.decode_with_cache(tok, cache, S)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(full).all())
    ref, _ = decode_step(served["tcfg"], served["params"], tok, again, n, S)
    assert torch.equal(out, ref)
    assert [g.initial_seed() for g in row_generators(3, 2, "cpu")] == \
        [g.initial_seed() for g in row_generators(3, 2, "cpu")]


def test_launch_serve_kv_budget_on_cpu(capsys):
    assert serve_cli.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "24", "--gen", "4",
                           "--kv-budget", "8"]) == 0
    out = capsys.readouterr().out
    assert "KV cache pruned 24 -> 8 positions" in out
    assert "generated (2, 4) tokens" in out and "on cpu" in out
