"""The port's MoE, Mamba2 (SSD) and RG-LRU blocks on the CPU against the JAX
package, on the same numpy-made parameters and inputs: routing (top-1 and
top-k, the aux loss, the tie order), the capacity-bounded prefill dispatch
with and without drops, the S == 1 path, the chunked SSD with its cache,
the exact SSM recurrence, and the RG-LRU scan and recurrence with non-zero
gates.  float32 throughout, held at 1e-4 relative to max|want|."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.models import moe, rglru, ssm


def _close(got, want, rel=1e-4):
    """rtol 1e-4 with atol 1e-4 x max|want| (float32 in different summation
    orders)."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _fill(init, cfg, seed):
    """numpy draws in the shapes of a JAX init's parameters: weights at
    fan-in scale and every 1-D leaf (gates, biases, Λ, A_log, dt_bias, D,
    the norm scale) a unit normal, so zero-initialised leaves count."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))

    def fill(sd):
        fan_in = sd.shape[-2] if len(sd.shape) >= 2 else 1
        return (rng.standard_normal(sd.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(fill, shapes)


def _both(params):
    return (jax.tree.map(jnp.asarray, params),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- MoE -----------------------------------------------------------------


MOE = {"top-k": "olmoe-1b-7b", "top-1": "llama4-maverick-400b-a17b"}


def _moe(kind, seed=0):
    jcfg, tcfg = jax_configs.smoke(MOE[kind]), configs.smoke(MOE[kind])
    return jcfg, tcfg, *_both(_fill(jmoe.moe_init, jcfg, seed))


@pytest.mark.parametrize("kind", list(MOE))
def test_route_matches_jax(kind):
    """Top-k softmax renormalised (olmoe) and top-1 sigmoid (llama4): the
    same picks in the same order, the gates and the Switch aux loss."""
    jcfg, tcfg, jp, tp = _moe(kind)
    xt = _x((40, jcfg.d_model), 1)
    want_idx, want_gates, want_aux = jmoe._route(jp, jcfg, jnp.asarray(xt))
    idx, gates, aux = moe._route(tp, tcfg, torch.from_numpy(xt))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    _close(gates, want_gates)
    _close(aux, want_aux)
    assert idx.shape == (40, tcfg.top_k)


def test_top_k_puts_the_lower_index_first_on_ties():
    """``jax.lax.top_k``'s tie order, which ``torch.topk`` does not give."""
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 2.0],
                  [0.5, 0.5, 0.5, 0.5, 0.5, 0.5]], np.float32)
    for k in (1, 3, 5):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = moe.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("kind", list(MOE))
@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_moe_prefill_matches_jax(kind, cf):
    """The slot dispatch at a capacity factor that drops (token, k) pairs
    (0.5) and one that drops none (4.0), with the shared expert on llama4."""
    jcfg, tcfg, jp, tp = _moe(kind)
    B, S = 2, 16
    x = _x((B, S, jcfg.d_model), 2)
    want, want_aux = jmoe.moe_forward(jp, jcfg, jnp.asarray(x), capacity_factor=cf)
    got, aux = moe.moe_forward(tp, tcfg, torch.from_numpy(x), capacity_factor=cf)
    _close(got, want)
    _close(aux, want_aux)
    idx, _, _ = moe._route(tp, tcfg, torch.from_numpy(x).reshape(B * S, -1))
    C = moe.capacity(tcfg, S, cf)
    keys = moe.dispatch_keys(idx.reshape(B, S, -1), tcfg.num_experts, C)
    dropped = int((keys == tcfg.num_experts * C).sum())
    assert (dropped > 0) == (cf < 1), dropped
    # kept pairs take distinct slots
    for row in keys:
        kept = row[row < tcfg.num_experts * C]
        assert kept.unique().numel() == kept.numel()


@pytest.mark.parametrize("kind", list(MOE))
def test_moe_decode_path_matches_jax(kind):
    """S == 1: no capacity, the K chosen experts gathered a token."""
    jcfg, tcfg, jp, tp = _moe(kind)
    x = _x((3, 1, jcfg.d_model), 3)
    want, want_aux = jmoe.moe_forward(jp, jcfg, jnp.asarray(x))
    got, aux = moe.moe_forward(tp, tcfg, torch.from_numpy(x))
    _close(got, want)
    _close(aux, want_aux)


# -- Mamba2 (SSD) --------------------------------------------------------

# G = 2 groups of B and C over H = 8 heads, so that jnp.repeat (each group
# over its run of heads: repeat_interleave) differs from Tensor.repeat.
SSM_KW = dict(ssm_groups=2, ssm_chunk=8)


def _ssm(seed=0):
    jcfg = dataclasses.replace(jax_configs.smoke("mamba2-780m"), **SSM_KW)
    tcfg = dataclasses.replace(configs.smoke("mamba2-780m"), **SSM_KW)
    assert tcfg.ssm_heads // tcfg.ssm_groups > 1
    return jcfg, tcfg, *_both(_fill(jssm.mamba2_init, jcfg, seed))


@pytest.mark.parametrize("S", [12, 2, 16])
def test_mamba2_forward_and_cache_match_jax(S):
    """S = 12 with chunk 8 runs two chunks of Q = 6; S = 2 < W - 1 pads the
    conv tail on the left; S = 16 two full chunks."""
    jcfg, tcfg, jp, tp = _ssm()
    assert S % ssm.chunk_len(tcfg, S) == 0 and ssm.chunk_len(tcfg, 12) == 6
    u = _x((2, S, jcfg.d_model), 4)
    want, want_cache = jssm.mamba2_forward(jp, jcfg, jnp.asarray(u), return_cache=True)
    got, cache = ssm.mamba2_forward(tp, tcfg, torch.from_numpy(u), return_cache=True)
    _close(got, want)
    assert set(cache) == {"conv", "ssm"}
    for name in cache:
        assert cache[name].dtype == torch.float32
        _close(cache[name], want_cache[name])
    _close(ssm.mamba2_forward(tp, tcfg, torch.from_numpy(u)), want)


def test_mamba2_decode_three_steps_match_jax():
    jcfg, tcfg, jp, tp = _ssm(1)
    u = _x((2, 5, jcfg.d_model), 5)
    _, jcache = jssm.mamba2_forward(jp, jcfg, jnp.asarray(u), return_cache=True)
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    for step in range(3):
        ut = _x((2, 1, jcfg.d_model), 10 + step)
        want, jcache = jssm.mamba2_decode(jp, jcfg, jnp.asarray(ut), jcache)
        got, cache = ssm.mamba2_decode(tp, tcfg, torch.from_numpy(ut), cache)
        _close(got, want)
        for name in cache:
            _close(cache[name], jcache[name])


def test_mamba2_cache_init_matches_jax():
    jcfg, tcfg, _, _ = _ssm()
    want = jssm.mamba2_cache_init(jcfg, 3)
    got = ssm.mamba2_cache_init(tcfg, 3, device="cpu", lead=(2,))
    for name in want:
        assert tuple(got[name].shape) == (2, *want[name].shape)
        assert str(got[name].dtype)[6:] == str(want[name].dtype)
        assert not got[name].any()


# -- RG-LRU --------------------------------------------------------------


def _rglru(seed=0):
    jcfg, tcfg = jax_configs.smoke("recurrentgemma-2b"), configs.smoke("recurrentgemma-2b")
    params = _fill(jrglru.rglru_init, jcfg, seed)
    # the reference initialises the gates and the conv bias to zero: the
    # draws must reach them, or the gates go untested
    for name in ("gate_a_w", "gate_a_b", "gate_i_w", "gate_i_b", "conv_b"):
        assert np.abs(params[name]).min() > 0, name
    return jcfg, tcfg, *_both(params)


@pytest.mark.parametrize("S", [2, 16])
def test_rglru_forward_and_decode_match_jax(S):
    """The doubling scan against the reference's associative scan (equal to
    rounding), the prefill cache, then three decode steps from it."""
    jcfg, tcfg, jp, tp = _rglru()
    x = _x((2, S, jcfg.d_model), 6)
    want, jcache = jrglru.rglru_forward(jp, jcfg, jnp.asarray(x), return_cache=True)
    got, cache = rglru.rglru_forward(tp, tcfg, torch.from_numpy(x), return_cache=True)
    _close(got, want)
    assert set(cache) == {"conv", "h"}
    for name in cache:
        assert cache[name].dtype == torch.float32
        _close(cache[name], jcache[name])
    for step in range(3):
        xt = _x((2, 1, jcfg.d_model), 20 + step)
        want, jcache = jrglru.rglru_decode(jp, jcfg, jnp.asarray(xt), jcache)
        got, cache = rglru.rglru_decode(tp, tcfg, torch.from_numpy(xt), cache)
        _close(got, want)
        for name in cache:
            _close(cache[name], jcache[name])


@pytest.mark.parametrize("S", [1, 5, 64, 4096])
def test_linear_scan_equals_the_recurrence(S):
    """The doubling scan against h_t = a_t h_{t-1} + b_t walked one position
    at a time, in float64 (the scan's own arithmetic, no rounding to hide
    a wrong composition)."""
    g = torch.Generator().manual_seed(S)
    a = torch.rand((2, S, 3), generator=g, dtype=torch.float64)
    b = torch.randn((2, S, 3), generator=g, dtype=torch.float64)
    h, want = torch.zeros((2, 3), dtype=torch.float64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, b), torch.stack(want, 1),
                               rtol=1e-12, atol=1e-12)
