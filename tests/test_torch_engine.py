"""The port's serving engine on the CPU against the JAX package: greedy
generation gives identical tokens on the smoke configs of every block
type, and top-k sampling draws only from the top k."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import init_params as jax_init_params
from repro.serve import Engine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch import configs
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import init_params
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.engine import _sample

ATTN_ARCHS = ["llama3.2-3b", "qwen3-4b", "qwen2-7b", "starcoder2-3b",
              "musicgen-large", "internvl2-76b"]
BLOCK_ARCHS = ["olmoe-1b-7b", "llama4-maverick-400b-a17b", "mamba2-780m",
               "recurrentgemma-2b"]


def _prompt(cfg, B, S, seed=5):
    rng = np.random.default_rng(seed)
    shape = (B, S) if cfg.num_codebooks == 1 else (B, S, cfg.num_codebooks)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    patches = None
    if cfg.input_mode == "tokens+patches":
        patches = rng.standard_normal((B, cfg.num_patches, cfg.d_model)
                                      ).astype(np.float32)
    return toks, patches


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_greedy_generate_matches_jax(arch):
    jcfg, tcfg = jax_configs.smoke(arch), configs.smoke(arch)
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(3), jcfg))
    toks, patches = _prompt(jcfg, 3, 10)
    want, _ = JaxEngine(jcfg, jax.tree.map(jnp.asarray, params),
                        JaxServeConfig(max_len=32)).generate(
        jnp.asarray(toks), 12,
        patches=None if patches is None else jnp.asarray(patches))
    eng = Engine(tcfg, model_params_from_numpy(params, tcfg, device="cpu"),
                 ServeConfig(max_len=32), device="cpu")
    got, cache = eng.generate(
        torch.from_numpy(toks).long(), 12,
        patches=None if patches is None else torch.from_numpy(patches))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cache["blocks"]["p0"]["k"].shape[2] == 32


@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_greedy_generate_matches_jax_on_the_other_block_types(arch):
    """Experts, Mamba2 and the RG-LRU hybrid: the JAX engine's greedy
    tokens, and a cache with the block types' own states."""
    jcfg, tcfg = jax_configs.smoke(arch), configs.smoke(arch)
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(3), jcfg))
    toks, _ = _prompt(jcfg, 3, 10)
    want, _ = JaxEngine(jcfg, jax.tree.map(jnp.asarray, params),
                        JaxServeConfig(max_len=32)).generate(jnp.asarray(toks), 12)
    eng = Engine(tcfg, model_params_from_numpy(params, tcfg, device="cpu"),
                 ServeConfig(max_len=32), device="cpu")
    got, cache = eng.generate(torch.from_numpy(toks).long(), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    names = {name for c in cache["blocks"].values() for name in c}
    assert names == ({"conv", "ssm"} if arch == "mamba2-780m" else
                     {"conv", "h", "k", "v"} if arch == "recurrentgemma-2b" else
                     {"k", "v"})


def test_argmax_takes_the_first_maximum():
    logits = torch.tensor([[[0.0, 2.0, 2.0, 1.0]], [[5.0, 5.0, 5.0, 5.0]]])
    np.testing.assert_array_equal(_sample(logits, None, ServeConfig()).numpy(),
                                  [[1], [0]])


@pytest.mark.parametrize("top_k", [1, 3, 10])
def test_top_k_draws_only_from_the_top_k(top_k):
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.standard_normal((8, 1, 50)).astype(np.float32))
    sc = ServeConfig(temperature=2.0, top_k=top_k)
    gen = torch.Generator().manual_seed(0)
    top = torch.topk(logits, top_k, dim=-1).indices
    seen = set()
    for _ in range(200):
        tok = _sample(logits, gen, sc)
        assert tok.shape == (8, 1)
        assert bool((top == tok[..., None]).any(-1).all())
        seen.update(tok[0].tolist())
    assert len(seen) == top_k     # and it does draw all of them


def test_sampled_generate_is_reproducible_and_in_range():
    cfg = configs.smoke("qwen3-4b")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = Engine(cfg, params, ServeConfig(max_len=24, temperature=0.8, top_k=5),
                 device="cpu")
    toks = torch.from_numpy(_prompt(cfg, 2, 8)[0]).long()
    a, _ = eng.generate(toks, 6, generator=torch.Generator().manual_seed(1))
    b, _ = eng.generate(toks, 6, generator=torch.Generator().manual_seed(1))
    assert a.shape == (2, 6) and torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


def test_generate_refuses_past_max_len_and_foreign_params():
    cfg = configs.smoke("llama3.2-3b")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = Engine(cfg, params, ServeConfig(max_len=16), device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(torch.zeros((1, 10), dtype=torch.long), 7)
    with pytest.raises(ValueError, match="parameters lie on"):
        Engine(cfg, params, device="meta")


def test_launch_serve_smoke_on_cpu(capsys):
    assert serve_cli.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 4) tokens" in out and "on cpu" in out


@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_launch_serve_smoke_on_cpu_other_block_types(capsys, arch):
    assert serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 4) tokens" in out and "on cpu" in out


def test_launch_serve_kv_budget_needs_attention_layers():
    """``--kv-budget`` prunes attention caches; mamba2 has none, and the
    reference's ``pooled_keys`` asserts as the port raises."""
    with pytest.raises(ValueError, match="no attention layers"):
        serve_cli.main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "8", "--gen", "4",
                        "--kv-budget", "4"])
