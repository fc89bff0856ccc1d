"""The flash attention gradient on the CPU: ``attention_bwd_ref`` (the plain
version of ``csrc/flash_attention_bwd.cu`` and
``csrc/flash_attention_bwd_tc.cu``) against ``jax.vjp`` of the JAX
package's ``flash_attention_ref`` and against torch autograd of
``attention_ref``; its split form (``parts``: P and dS in bfloat16 parts,
the tensor-core kernel's arithmetic) against the function and against P
and dS rounded once; ``attention_lse_ref``'s O and L; ``FlashAttentionFn``
under ``gradcheck`` in float64; the backward's route rule and layout
checks; and attention's gradient reaching the projections through the
model's plain route.  Tolerance: float32 within 1e-4 of max|want| (the
model tests' rule), the split form within 1e-5; O bitwise."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as jflash_ref
from repro_torch import configs
from repro_torch.kernels import (
    FlashAttentionFn,
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
    flash_attention_bwd_kernel,
    flash_attention_kernel,
    flash_attention_lse,
    flash_bwd_route,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import forward, init_params, lm_loss
from repro_torch.models.layers import tree_leaves

MASKS = [(True, 0), (True, 5), (False, 0)]


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor) else got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1e-30, float(np.abs(want).max())))


def _qkv(B, S, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, H, hd)).astype(np.float32))


_jax_vjp = {}


def _jvjp(causal, window):
    """jit-compiled vjp of the JAX reference, one per mask (reused)."""
    key = (causal, window)
    if key not in _jax_vjp:
        def f(q, k, v, do):
            _, pull = jax.vjp(lambda a, b, c: jflash_ref(a, b, c, causal, window),
                              q, k, v)
            return pull(do)
        _jax_vjp[key] = jax.jit(f)
    return _jax_vjp[key]


@pytest.mark.parametrize("causal,window", MASKS)
def test_bwd_ref_matches_jax_vjp_flat_layout(causal, window):
    """The TPU layout (BH, S, hd): the JAX reference's own."""
    q, k, v, do = (a[:, :, 0] for a in _qkv(6, 19, 1, 1, 16, seed=1))
    want = _jvjp(causal, window)(*(jnp.asarray(a) for a in (q, k, v, do)))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o, L = attention_lse_ref(qt[:, :, None], kt[:, :, None], vt[:, :, None],
                             causal, window)
    got = attention_bwd_ref(qt, kt, vt, o[:, :, 0], dot, L[:, 0], causal, window)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("causal,window", MASKS)
def test_bwd_ref_matches_jax_vjp_grouped(causal, window):
    """Grouped KV (H = 6 on KV = 2): JAX sees the expanded heads, as the
    model's head_map gather gives them; dK and dV sum over each group."""
    B, S, H, KV, hd = 2, 23, 6, 2, 8
    G = H // KV
    q, k, v, do = _qkv(B, S, H, KV, hd, seed=2)

    def flat(a):            # (B, S, heads, hd) -> (B heads, S, hd)
        return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(-1, S, hd)

    kx, vx = (np.repeat(a, G, axis=2) for a in (k, v))
    dq, dk, dv = _jvjp(causal, window)(flat(q), flat(kx), flat(vx), flat(do))

    def unflat(a):
        return np.asarray(a).reshape(B, -1, S, hd).transpose(0, 2, 1, 3)

    dk = unflat(dk).reshape(B, S, KV, G, hd).sum(3)
    dv = unflat(dv).reshape(B, S, KV, G, hd).sum(3)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o, L = attention_lse_ref(qt, kt, vt, causal, window)
    got = attention_bwd_ref(qt, kt, vt, o, dot, L, causal, window)
    for g, w in zip(got, (unflat(dq), dk, dv)):
        _close(g, w)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("H,KV", [(4, 4), (6, 2), (5, 1)])
def test_bwd_ref_matches_torch_autograd(causal, window, H, KV):
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(2, 17, H, KV, 16, seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention_ref(*leaves, causal, window)
    want = torch.autograd.grad(out, leaves, do)
    o, L = attention_lse_ref(q, k, v, causal, window)
    assert torch.equal(o, out.detach())
    got = attention_bwd_ref(q, k, v, o, do, L, causal, window)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("causal,window", MASKS)
def test_lse_ref_is_the_masked_logsumexp(causal, window):
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(1, 9, 3, 1, 8, seed=4))
    o, L = attention_lse_ref(q, k, v, causal, window)
    assert torch.equal(o, attention_ref(q, k, v, causal, window))
    s = torch.einsum("bqhd,bkd->bhqk", q, k[:, :, 0]) / np.sqrt(8)
    i = torch.arange(9)
    keep = torch.ones(9, 9, dtype=torch.bool)
    if causal:
        keep = (i[:, None] >= i[None]) & ((i[:, None] - i[None] < window) | (window == 0))
    _close(L, torch.logsumexp(torch.where(keep, s, -torch.inf), -1), 1e-6)


@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_attention_fn_gradcheck_float64(causal, window):
    g = torch.Generator().manual_seed(5)
    q = torch.randn((1, 7, 4, 4), generator=g, dtype=torch.float64, requires_grad=True)
    k, v = (torch.randn((1, 7, 2, 4), generator=g, dtype=torch.float64,
                        requires_grad=True) for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda a, b, c: FlashAttentionFn.apply(a, b, c, causal, window), (q, k, v))


def test_kernel_wrapper_under_grad_has_a_grad_fn_on_the_cpu():
    """On CPU tensors that require grad the wrapper goes through
    FlashAttentionFn's plain directions: a grad_fn, and the plain backward's
    gradients; without grad it returns attention_ref's bits, no grad_fn."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(2, 12, 4, 2, 32, seed=6))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_kernel(*leaves, causal=True, window=0)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    n = flash_attention_bwd_kernel.launches
    o, L = attention_lse_ref(q, k, v, True, 0)
    for a, b in zip(got, flash_attention_bwd_kernel(q, k, v, o, do, L)):
        assert torch.equal(a, b)
    assert flash_attention_bwd_kernel.launches == n     # CPU calls do not count
    with torch.no_grad():
        plain = flash_attention_kernel(*leaves, causal=True, window=0)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())


def test_forward_under_autograd_gives_the_projections_gradients():
    """The repair's CPU side: every attention leaf (w_q, w_k, w_v, w_o and
    qwen3's qk-norm scales) gets a nonzero gradient through the plain
    route."""
    cfg = configs.smoke("qwen3-4b")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    attn = params["blocks"]["p0"]["attn"]
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(1))
    logits, _ = forward(cfg, params, toks)
    lm_loss(cfg, logits, toks.roll(-1, 1)).backward()
    for name in ("w_q", "w_k", "w_v", "w_o", "q_norm", "k_norm"):
        assert attn[name].grad is not None and bool(attn[name].grad.abs().sum() > 0), name


def _dense_bwd(q, k, v, o, do, L, causal, window, rnd):
    """The gradient in one dense pass, KV heads expanded, with ``rnd``
    applied to P and dS before the three products that take them."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kx, vx = (t.repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kx) / math.sqrt(hd)
    p = torch.exp(s - L[..., None])
    i = torch.arange(S)
    keep = torch.ones(S, S, dtype=torch.bool)
    if causal:
        keep = (i[:, None] >= i[None]) & ((i[:, None] - i[None] < window) | (window == 0))
    p = torch.where(keep, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vx)
    ds = p * (dp - (do * o).sum(-1).transpose(1, 2)[..., None])
    p, ds = rnd(p), rnd(ds)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do).reshape(B, S, -1, G, hd).sum(3)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kx) / math.sqrt(hd)
    dk = (torch.einsum("bhqk,bqhd->bkhd", ds, q) / math.sqrt(hd)
          ).reshape(B, S, -1, G, hd).sum(3)
    return dq, dk, dv


@pytest.mark.parametrize("causal,window", MASKS)
def test_split_backward_at_three_parts_is_the_function(causal, window):
    """P and dS in three bf16 parts summed back in float32 (the tensor-core
    kernel's arithmetic) give the function: within 1e-5 of max|want|."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(2, 21, 6, 2, 16, seed=7))
    o, L = attention_lse_ref(q, k, v, causal, window)
    want = attention_bwd_ref(q, k, v, o, do, L, causal, window)
    got = attention_bwd_ref(q, k, v, o, do, L, causal, window, parts=3)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("causal,window", MASKS)
def test_split_backward_at_one_part_rounds_p_and_ds_once(causal, window):
    """One part is P and dS rounded to bf16 once (scaled_dot_product_attention's
    backward): the dense closed form with that rounding, within 1e-5 of
    max|want|, and not the function."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(2, 21, 6, 2, 16, seed=8))
    o, L = attention_lse_ref(q, k, v, causal, window)
    got = attention_bwd_ref(q, k, v, o, do, L, causal, window, parts=1)
    want = _dense_bwd(q, k, v, o, do, L, causal, window,
                      lambda x: x.to(torch.bfloat16).float())
    exact = attention_bwd_ref(q, k, v, o, do, L, causal, window)
    for g, w, e in zip(got, want, exact):
        _close(g, w, 1e-5)
        assert float((g - e).abs().max()) > 1e-4 * float(e.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_backward_takes_the_forwards_route(monkeypatch, dtype, hd):
    """On a device other than the CPU the backward launches the kernel of
    ``flash_bwd_route(dtype, head_dim)``, the backward's own rule: the
    tensor-core kernel for bf16 at hd 64/128/256, the FFMA kernel for the
    rest, float32 at every width and bf16 at hd 32 (meta tensors stand in
    for the card; the launch is recorded, not made)."""
    seen = []

    def record(q, k, v, *rest):
        # a stand-in launch: the route taken, and what a launch returns
        seen.append(rest[-1])
        return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)

    monkeypatch.setattr(fa, "_bwd_launch", record)
    q = torch.empty((1, 8, 4, hd), dtype=dtype, device="meta")
    k = v = torch.empty((1, 8, 2, hd), dtype=dtype, device="meta")
    L = torch.empty((1, 4, 8), dtype=torch.float32, device="meta")
    flash_attention_bwd_kernel(q, k, v, q, q, L)
    want = dtype == torch.bfloat16 and hd in (64, 128, 256)
    assert seen == [want] and (flash_bwd_route(dtype, hd) == "tc") == want


def test_head_dim_256_runs_forward_on_tc_and_backward_on_ffma(monkeypatch):
    """recurrentgemma's local attention (bf16, MQA 10:1, hd 256, windowed)
    under autograd: the forward launches the tensor-core kernel with L, and
    the backward the tensor-core backward on that L (both routes of bf16 at
    hd 256 are the tensor cores'; float32 at hd 256 stays on the FFMA
    kernels both ways).  Meta tensors stand in for the card; each launch is
    recorded, not made."""
    fwd, bwd = [], []
    monkeypatch.setattr(fa, "_launch", lambda *a: fwd.append((a[6], a[7] is not None)))

    def bwd_launch(q, k, v, o, do, lse, causal, window, tc):
        bwd.append(tc)
        return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)

    monkeypatch.setattr(fa, "_bwd_launch", bwd_launch)
    q = torch.empty((2, 64, 10, 256), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    k, v = (torch.empty((2, 64, 1, 256), dtype=torch.bfloat16, device="meta",
                        requires_grad=True) for _ in range(2))
    out = flash_attention_kernel(q, k, v, causal=True, window=16)
    grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert fwd == [(True, True)] and bwd == [True]
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    # without grad the forward takes the same route, L not requested
    with torch.no_grad():
        flash_attention_kernel(q, k, v, causal=True, window=16)
    assert fwd[-1] == (True, False)
    assert flash_attention_lse(q.detach(), k.detach(), v.detach())[1].shape == (2, 10, 64)
    # float32 at the same width: FFMA forward with L, FFMA backward
    q32, k32, v32 = (t.detach().float().requires_grad_() for t in (q, k, v))
    out = flash_attention_kernel(q32, k32, v32, causal=True, window=16)
    torch.autograd.grad(out, (q32, k32, v32), torch.empty_like(out))
    assert fwd[-1] == (False, True) and bwd == [True, False]


def test_tma_ready_copies_what_is_not_contiguous_and_aligned():
    """O and dO reach the tensor-core backward as they are when contiguous
    and 16-byte aligned, else as a contiguous copy with the same values."""
    base = torch.randn(2, 16, 4, 128).to(torch.bfloat16)
    assert fa._tma_ready(base) is base
    for odd in (torch.randn(2, 16, 4, 130).to(torch.bfloat16)[..., :128],
                base.flatten()[1:1 + base.numel() // 2].view(2, 8, 4, 128),
                torch.ones(1, 1, 1, 1).to(torch.bfloat16).expand(2, 16, 4, 128)):
        ready = fa._tma_ready(odd)
        assert ready is not odd and torch.equal(ready, odd)
        fa.check_tc_layout(ready, ready, ready)      # TMA takes the copy
