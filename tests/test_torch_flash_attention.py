"""The port's flash attention on the CPU against the JAX package: the plain
version behind the wrapper vs the Pallas kernel in interpret mode and its
oracle, the port's ``blockwise_attention`` vs the JAX one, and the
wrapper's input checks.  The CUDA kernel itself is held to the same plain
version on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models.attention import blockwise_attention as jax_blockwise
from repro_torch.kernels import flash_attention_kernel, flash_attention_ref
from repro_torch.models.attention import blockwise_attention


def _qkv(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# tests/test_kernels.py's parametrisation of the Pallas kernel
@pytest.mark.parametrize("S,hd,bq,bk", [(128, 64, 64, 64), (256, 128, 128, 64),
                                        (96, 32, 64, 32)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (False, 0)])
def test_plain_flash_matches_pallas_interpret(S, hd, bq, bk, causal, window):
    BH = 4
    q, k, v = _qkv(7, *[(BH, S, hd)] * 3)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, window=window, bq=bq, bk=bk,
                                interpret=True))
    oracle = np.asarray(jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      window=window))
    got = flash_attention_kernel(*_t(q, k, v), causal=causal, window=window)
    assert got.shape == (BH, S, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-4, atol=2e-4)
    ref = flash_attention_ref(*_t(q, k, v), causal, window)
    np.testing.assert_allclose(ref.numpy(), oracle, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S", [96, 128])
@pytest.mark.parametrize("window", [0, 32])
def test_blockwise_matches_jax(S, window):
    B, H, KV, hd = 2, 4, 2, 32
    q, k, v = _qkv(8, (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    want = np.asarray(jax_blockwise(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True, window=window,
                                    block_q=64, block_k=32))
    got = blockwise_attention(*_t(q, k, v), causal=True, window=window)
    assert got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # the wrapper's grouped (4-D) form is the same function on the CPU
    np.testing.assert_allclose(
        flash_attention_kernel(*_t(q, k, v), window=window).numpy(), want,
        rtol=2e-4, atol=2e-4)


def test_blockwise_softcap_on_cpu_matches_jax():
    B, S, H, KV, hd = 1, 64, 4, 1, 16
    q, k, v = _qkv(9, (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    q *= 4.0
    want = np.asarray(jax_blockwise(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), softcap=5.0))
    got = blockwise_attention(*_t(q, k, v), softcap=5.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_grouped_form_equals_expanded_heads():
    """(B, S, H, hd) with KV heads read in place is the TPU contract's
    (BH, S, hd) on heads expanded by head_map."""
    B, S, H, KV, hd = 2, 80, 8, 2, 64
    q, k, v = _t(*_qkv(10, (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    head_map = torch.arange(H) // (H // KV)
    flat = lambda t: t.transpose(1, 2).reshape(B * H, S, hd)  # noqa: E731
    want = flash_attention_kernel(flat(q), flat(k[:, :, head_map]),
                           flat(v[:, :, head_map]), window=24)
    got = flash_attention_kernel(q, k, v, window=24)
    torch.testing.assert_close(flat(got), want, rtol=0, atol=1e-6)


def test_bfloat16_in_bfloat16_out():
    q, k, v = _t(*_qkv(11, *[(3, 70, 32)] * 3))
    got = flash_attention_kernel(q.bfloat16(), k.bfloat16(), v.bfloat16())
    want = flash_attention_kernel(q.bfloat16().float(), k.bfloat16().float(),
                           v.bfloat16().float())
    assert got.dtype == torch.bfloat16
    # float32 arithmetic on the bf16 inputs, rounded once at the output
    torch.testing.assert_close(got.float(), want, rtol=2**-8, atol=1e-6)


@pytest.mark.parametrize("shapes", [
    [(4, 32), (4, 32), (4, 32)],                         # rank 2
    [(1, 2, 4, 3, 32)] * 3,                              # rank 5
    [(2, 16, 32), (2, 16, 2, 32), (2, 16, 2, 32)],       # mixed ranks
    [(2, 16, 4, 32), (2, 16, 3, 32), (2, 16, 3, 32)],    # KV does not divide H
    [(2, 16, 32), (2, 17, 32), (2, 17, 32)],             # k is not q's shape
])
def test_wrapper_raises_on_wrong_rank_or_shape(shapes):
    with pytest.raises(ValueError):
        flash_attention_kernel(*[torch.zeros(s) for s in shapes])


@pytest.mark.parametrize("hd", [8, 16, 48, 96, 512])
def test_wrapper_raises_on_unsupported_head_dim(hd):
    q = torch.zeros(2, 16, hd)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_kernel(q, q, q)


def test_wrapper_raises_on_mixed_dtypes_and_negative_window():
    q = torch.zeros(2, 16, 32)
    with pytest.raises(TypeError):
        flash_attention_kernel(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(TypeError):
        flash_attention_kernel(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="window"):
        flash_attention_kernel(q, q, q, window=-1)


def test_softcap_raises_off_the_cpu():
    """The kernel has no softcap: a tensor that is not on the CPU (a meta
    tensor here, a CUDA tensor on the card) raises before any launch."""
    q = torch.empty(1, 16, 2, 32, device="meta")
    with pytest.raises(NotImplementedError, match="softcap"):
        blockwise_attention(q, q, q, softcap=30.0)
