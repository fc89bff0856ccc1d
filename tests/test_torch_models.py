"""The port's LM stack on the CPU against the JAX package: every layer, then
``prefill`` (logits and the whole cache), ``decode_step`` and ``forward``
of the attention-only smoke configs, on the same numpy-made parameters
carried across with ``model_params_from_numpy``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import decoder as jdec
from repro.models import layers as jlayers
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch import configs
from repro_torch.convert import cache_from_numpy, model_params_from_numpy
from repro_torch.models import decode_step, forward, init_params, prefill
from repro_torch.models import layers

# The six attention-only smoke configs, and two with sliding-window blocks
# (a local layer in both the scanned groups and the unrolled tail), one
# with a window shorter than the prompt (the ring buffer wraps) and one
# longer.
ATTN_ARCHS = ["llama3.2-3b", "qwen3-4b", "qwen2-7b", "starcoder2-3b",
              "musicgen-large", "internvl2-76b"]
LOCAL = {"local-window-6": 6, "local-window-16": 16}
UNPORTED = {"olmoe-1b-7b": "attn_moe", "llama4-maverick-400b-a17b": "attn_moe",
            "mamba2-780m": "mamba2", "recurrentgemma-2b": "rglru"}


def _cfgs(arch):
    """(JAX config, port config) of a smoke arch."""
    if arch in LOCAL:
        kw = dict(num_layers=5, block_pattern=("local", "attn"),
                  local_window=LOCAL[arch])
        return (dataclasses.replace(jax_configs.smoke("qwen3-4b"), **kw),
                dataclasses.replace(configs.smoke("qwen3-4b"), **kw))
    return jax_configs.smoke(arch), configs.smoke(arch)


def _np_params(jcfg, seed=0):
    """A parameter tree of the reference's shapes, filled with numpy draws:
    weights at fan-in scale, embeddings at unit scale, and norm scales and
    biases off their init values (1 and 0) so that they count."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jdec.init_params(jax.random.PRNGKey(0), jcfg))

    def fill(path, sd):
        name = jax.tree_util.keystr(path)
        if "tok" in name:
            return rng.standard_normal(sd.shape).astype(np.float32)
        if "scale" in name or "_norm" in name:
            return (1.0 + 0.2 * rng.standard_normal(sd.shape)).astype(np.float32)
        if "'b_" in name:
            return (0.2 * rng.standard_normal(sd.shape)).astype(np.float32)
        fan_in = sd.shape[-2] if len(sd.shape) >= 2 else 1
        return (rng.standard_normal(sd.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _inputs(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    shape = (B, S) if cfg.num_codebooks == 1 else (B, S, cfg.num_codebooks)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    patches = None
    if cfg.input_mode == "tokens+patches":
        patches = rng.standard_normal((B, cfg.num_patches, cfg.d_model)
                                      ).astype(np.float32)
    return toks, patches


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _close(got, want, rel=1e-4):
    """rtol 1e-4 with atol 1e-4 x max|want| (float32 through a few layers
    in different summation orders)."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- layers ----------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rmsnorm_and_headwise(dt):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(16)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(dt), torch.from_numpy(x).to(layers.dtype_of(dt))
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, xj, 1e-6)
    got = layers.rmsnorm({"scale": torch.from_numpy(scale)}, xt, 1e-6)
    assert got.dtype == xt.dtype
    # bfloat16: the same cast order rounds at the same places, bit for bit
    tol = 1e-6 if dt == "float32" else 0.0
    _close(got, np.asarray(want.astype(jnp.float32)), tol)
    want = jlayers.rmsnorm_headwise(jnp.asarray(scale), xj, 1e-6)
    got = layers.rmsnorm_headwise(torch.from_numpy(scale), xt, 1e-6)
    _close(got, np.asarray(want.astype(jnp.float32)), tol)


@pytest.mark.parametrize("pos_shape", ["S", "B1"])
def test_apply_rope(pos_shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    if pos_shape == "S":
        pos = np.arange(7)
    else:
        x = x[:, :1]
        pos = np.full((2, 1), 123, np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu"),
                                       (True, "gelu")])
def test_ffn(gated, act):
    rng = np.random.default_rng(2)
    d, f = 32, 48
    p = {"w_up": rng.standard_normal((d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((f, d)) / np.sqrt(f)}
    if gated:
        p["w_gate"] = rng.standard_normal((d, f)) / np.sqrt(d)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    want = jlayers.ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                       jnp.float32, act)
    got = layers.ffn({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), torch.float32, act)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("arch", ["musicgen-large", "qwen3-4b", "qwen2-7b"])
def test_embed_and_unembed(arch):
    """Codebooks (musicgen: K = 4 streams, untied), tied (qwen3) and untied
    (qwen2) embeddings."""
    jcfg, tcfg = _cfgs(arch)
    emb = _np_params(jcfg)["embed"]
    toks, _ = _inputs(jcfg, 2, 6)
    want = jlayers.embed_tokens(jax.tree.map(jnp.asarray, emb), jcfg,
                                jnp.asarray(toks))
    temb = {k: torch.from_numpy(v) for k, v in emb.items()}
    got = layers.embed_tokens(temb, tcfg, torch.from_numpy(toks).long())
    _close(got, want, 1e-6)
    x = np.random.default_rng(3).standard_normal((2, 6, jcfg.d_model))
    x = x.astype(np.float32)
    want = jlayers.unembed(jax.tree.map(jnp.asarray, emb), jcfg, jnp.asarray(x))
    got = layers.unembed(temb, tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)


# -- the model ---------------------------------------------------------------


def _both(arch, B=2, S=12, max_len=20):
    jcfg, tcfg = _cfgs(arch)
    params = _np_params(jcfg)
    tparams = model_params_from_numpy(params, tcfg, device="cpu")
    toks, patches = _inputs(jcfg, B, S)
    return jcfg, tcfg, params, tparams, toks, patches


@pytest.mark.parametrize("arch", ATTN_ARCHS + list(LOCAL))
def test_prefill_logits_and_cache_match_jax(arch):
    jcfg, tcfg, params, tparams, toks, patches = _both(arch)
    jp = jax.tree.map(jnp.asarray, params)
    want_logits, want_cache = jdec.prefill(jcfg, jp, jnp.asarray(toks),
                                           _j(patches), max_len=20)
    logits, cache = prefill(tcfg, tparams, _t(toks).long(), _t(patches),
                            max_len=20)
    _close(logits, want_logits)
    want_cache = _np_tree(want_cache)
    assert jax.tree.structure(want_cache) == jax.tree.structure(
        jax.tree.map(lambda t: 0, cache))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_cache),
                            jax.tree.leaves(cache)):
        assert g.dtype == torch.float32, path
        _close(g, w)


@pytest.mark.parametrize("arch", ATTN_ARCHS + list(LOCAL))
def test_decode_steps_and_forward_match_jax(arch):
    """Three decode steps from the JAX prefill's cache (carried across with
    cache_from_numpy), each step's logits and cache against JAX; then the
    full forward's logits."""
    jcfg, tcfg, params, tparams, toks, patches = _both(arch)
    jp = jax.tree.map(jnp.asarray, params)
    _, jcache = jdec.prefill(jcfg, jp, jnp.asarray(toks), _j(patches), max_len=20)
    cache = cache_from_numpy(_np_tree(jcache), device="cpu")
    rng = np.random.default_rng(4)
    S = toks.shape[1]
    for n in range(S, S + 3):
        shape = (2, 1) if jcfg.num_codebooks == 1 else (2, 1, jcfg.num_codebooks)
        tok = rng.integers(0, jcfg.vocab_size, shape).astype(np.int32)
        want, jcache = jdec.decode_step(jcfg, jp, jnp.asarray(tok), jcache,
                                        jnp.int32(n))
        got, cache = decode_step(tcfg, tparams, _t(tok).long(), cache, n)
        _close(got, want)
        for w, g in zip(jax.tree.leaves(_np_tree(jcache)), jax.tree.leaves(cache)):
            _close(g, w)
    want, _ = jdec.forward(jcfg, jp, jnp.asarray(toks), _j(patches))
    got, aux = forward(tcfg, tparams, _t(toks).long(), _t(patches))
    _close(got, want)
    assert float(aux) == 0.0
    got_last, _ = forward(tcfg, tparams, _t(toks).long(), _t(patches),
                          logits_slice=1)
    _close(got_last, np.asarray(want)[:, -1:])


def test_prefill_then_decode_equals_forward():
    """Decode logits at position S equal the forward's over S + 1 tokens:
    the port agrees with itself as the reference does."""
    jcfg, tcfg, params, tparams, toks, _ = _both("qwen3-4b")
    t = torch.from_numpy(toks).long()
    _, cache = prefill(tcfg, tparams, t, max_len=20)
    nxt = torch.tensor([[3], [5]])
    step, _ = decode_step(tcfg, tparams, nxt, cache, t.shape[1])
    full, _ = forward(tcfg, tparams, torch.cat([t, nxt], 1), logits_slice=1)
    torch.testing.assert_close(step, full, rtol=1e-4, atol=1e-4)


def test_bfloat16_compute_logits():
    """qwen3-4b-smoke with bfloat16 compute.  The reference's
    blockwise_attention rounds the probabilities to bfloat16 before P·V; the
    flash function does not (it keeps them in float32, as the TPU kernel
    does).  Each such rounding moves an attention output by up to 2^-9
    relative, and the bfloat16 activations round at 2^-9 anyway, so over
    four layers the logits differ by a few bfloat16 ulps of their largest
    value.  Held to 3e-2 x max|logits|, the repository's bfloat16
    tolerance."""
    jcfg, tcfg = (dataclasses.replace(c, compute_dtype="bfloat16")
                  for c in _cfgs("qwen3-4b"))
    params = _np_params(jcfg)
    tparams = model_params_from_numpy(params, tcfg, device="cpu")
    toks, _ = _inputs(jcfg, 2, 12)
    jp = jax.tree.map(jnp.asarray, params)
    want, _ = jdec.prefill(jcfg, jp, jnp.asarray(toks), max_len=20)
    got, cache = prefill(tcfg, tparams, _t(toks).long(), max_len=20)
    assert cache["blocks"]["p0"]["k"].dtype == torch.bfloat16
    _close(got, want, 3e-2)
    want, _ = jdec.forward(jcfg, jp, jnp.asarray(toks))
    got, _ = forward(tcfg, tparams, _t(toks).long())
    _close(got, want, 3e-2)


def test_config_copies_are_identical():
    for arch in jax_configs.ARCHS:
        for get in ("get", "smoke"):
            jc = getattr(jax_configs, get)(arch)
            tc = getattr(configs, get)(arch)
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc), arch
            assert jc.param_count() == tc.param_count()
    assert isinstance(jax_configs.get("qwen3-4b"), JaxModelConfig)
    assert configs.get("qwen3-4b").param_count() == jax_configs.get(
        "qwen3-4b").param_count()


@pytest.mark.parametrize("arch", sorted(UNPORTED))
def test_unported_block_types_raise(arch):
    jcfg, tcfg = jax_configs.smoke(arch), configs.smoke(arch)
    with pytest.raises(NotImplementedError, match=UNPORTED[arch]):
        init_params(torch.Generator(), tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_params_from_numpy(_np_params(jcfg), tcfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    for call in (lambda: forward(tcfg, {}, toks),
                 lambda: prefill(tcfg, {}, toks, max_len=8),
                 lambda: decode_step(tcfg, {}, toks[:, :1], {}, 4)):
        with pytest.raises(NotImplementedError):
            call()


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_init_params_shapes_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    want = jax.eval_shape(lambda: jdec.init_params(jax.random.PRNGKey(0), jcfg))
    got = init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, got))
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype)
    w = got["blocks"]["p0"]["attn"]["w_q"]
    assert abs(float(w.std()) * np.sqrt(tcfg.d_model) - 1.0) < 0.1
