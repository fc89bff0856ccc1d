"""The port's flash attention on the CPU against the JAX package: the plain
version behind the wrapper vs the Pallas kernel in interpret mode and its
oracle, the port's ``blockwise_attention`` vs the JAX one, the wrapper's
input checks, the route rule, and the tensor-core kernel's arithmetic (P
split into bfloat16 parts for P·V) in its plain form.  The CUDA kernels
themselves are held to the same plain version on the card by
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models.attention import blockwise_attention as jax_blockwise
from repro_torch.kernels import (
    attention_split_p_ref,
    flash_attention_kernel,
    flash_attention_ref,
    flash_route,
    split_bf16,
)
from repro_torch.kernels.flash_attention import check_tc_layout
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


# -- the tensor-core route: its split of P, its route rule, its layout check --


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_split_bf16_sums_back_to_p(parts):
    rng = np.random.default_rng(12)
    p = np.concatenate([rng.random(4096), rng.random(64) * 1e-20,
                        [1.0, 0.0, 2.0**-126, 0.99999994]]).astype(np.float32)
    pt = torch.from_numpy(p)
    got = split_bf16(pt, parts)
    assert len(got) == parts and all(x.dtype == torch.bfloat16 for x in got)
    total = sum(x.double() for x in got)
    bound = 2.0 ** (-8 * parts) * pt.double().abs()
    assert bool(((total - pt.double()).abs() <= bound).all())
    # each subtraction is exact in float32: the remainder is what float64 gives
    r = pt
    for x in got:
        exact = r.double() - x.double()
        r = r - x.float()
        assert torch.equal(r.double(), exact)


def _bf16_qkv(seed, shape_q, shape_kv):
    """float32 inputs that bfloat16 represents exactly (the tc route's)."""
    q, k, v = _qkv(seed, shape_q, shape_kv, shape_kv)
    return [torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, v)]


@pytest.mark.parametrize("S,hd", [(128, 64), (96, 128)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (False, 0)])
def test_split_p_matches_pallas_interpret(S, hd, causal, window):
    """P·V over three bf16 parts of float32 P is the Pallas kernel's
    function (float32 P) within 1e-5 of max|v|; P rounded to bf16 once is
    not, on the same inputs."""
    BH = 4
    q, k, v = _bf16_qkv(13, (BH, S, hd), (BH, S, hd))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, window=window, bq=64, bk=32,
                                interpret=True))
    tol = 1e-5 * float(np.abs(v).max())
    qkv = [t[:, :, None] for t in _t(q, k, v)]
    split = attention_split_p_ref(*qkv, causal, window, parts=3)[:, :, 0]
    assert float(np.abs(split.numpy() - want).max()) <= tol
    once = attention_split_p_ref(*qkv, causal, window, parts=1)[:, :, 0]
    assert float(np.abs(once.numpy() - want).max()) > tol


def test_split_p_grouped_matches_attention_ref():
    """The grouped (B, S, H, hd) form at three parts is attention_ref's
    function: the split changes nothing a float32 sum can see."""
    from repro_torch.kernels import attention_ref

    B, S, H, KV, hd = 2, 80, 8, 2, 64
    q, k, v = _t(*_bf16_qkv(14, (B, S, H, hd), (B, S, KV, hd)))
    got = attention_split_p_ref(q, k, v, True, 24)
    torch.testing.assert_close(got, attention_ref(q, k, v, True, 24),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 32, "ffma"), (torch.bfloat16, 256, "ffma"),
    (torch.float32, 64, "ffma"), (torch.float32, 128, "ffma"),
    (torch.float32, 32, "ffma"), (torch.float32, 256, "ffma"),
])
def test_flash_route_table(dtype, hd, route):
    assert flash_route(dtype, hd) == route


def test_tc_layout_check_raises_on_misaligned_strides():
    # the model's layout (from _project_qkv) passes
    q = torch.zeros(2, 16, 4, 128, dtype=torch.bfloat16)
    check_tc_layout(q, q, q)
    # a sequence stride of 4 * 130 elements (1040 bytes) passes; a head
    # stride of 130 (260 bytes) does not
    wide = torch.zeros(2, 16, 4, 130, dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="16 bytes"):
        check_tc_layout(wide, q, q)
    # a base one element (2 bytes) off 16-byte alignment
    off = torch.zeros(2 * 16 * 4 * 128 + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="aligned"):
        check_tc_layout(q, off.view(2, 16, 4, 128), q)
    # the wrapper applies the check on the tc route, and only there
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention_kernel(wide, q, q)
    assert flash_attention_kernel(wide.float(), q.float(), q.float()).shape == q.shape
