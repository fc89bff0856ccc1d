"""Training's kernels on the card: the flash backward kernels against their
plain version, each on its route (``flash_bwd_route``: the tensor-core
kernel for bf16 at head_dim 64/128/256, FFMA for the rest), recurrentgemma's
head_dim 256 under autograd (the tensor-core forward and the tensor-core
backward on its L), both tensor-core directions launched from a fresh thread, the
tensor-core route's flip rate
against rounding P and dS once, the flash forward's L, attention's
gradient through ``FlashAttentionFn`` in a 2-layer llama3.2-shaped model
against the plain route, and the SS-selected pipeline's picks against the
plain route's.
These tests need a CUDA card (marker ``cuda``) and skip without one; they
import nothing of JAX:

    python -m pytest -m cuda tests/test_torch_train_card.py
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data import DataConfig, Pipeline, hashed_features
from repro_torch.data.pipeline import select_documents
from repro_torch.kernels import (
    attention_bwd_ref,
    attention_ref,
    flash_attention_bwd_kernel,
    flash_attention_kernel,
    flash_attention_lse,
    flash_bwd_route,
    flash_route,
)
from repro_torch.models import forward, init_params, lm_loss
from repro_torch.models import attention as attn
from repro_torch.models.layers import tree_leaves


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels are CUDA kernels")
    return torch.device("cuda")


def _bwd_close(got, want, what):
    """float32: within 1e-4 of max|want|; bfloat16: within one bfloat16
    rounding of the float32 plain result (2^-8 |want|) plus that."""
    scale = float(want.abs().max())
    diff = (got.float() - want).abs()
    tol = 1e-4 * scale + (2.0 ** -8 * want.abs() if got.dtype == torch.bfloat16 else 0)
    assert bool((diff <= tol).all()), f"{what}: err {float(diff.max())} (max {scale})"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G,S,causal,window", [
    (32, 1, 17, True, 0), (64, 3, 130, True, 40), (128, 3, 1000, True, 0),
    (256, 10, 64, False, 0), (128, 1, 130, True, 64), (256, 10, 200, True, 72)])
def test_backward_kernel_matches_plain(card, dtype, hd, G, S, causal, window):
    g = torch.Generator(device=card).manual_seed(hd + S)
    B, KV = 2, 2
    q = torch.randn((B, S, KV * G, hd), generator=g, device=card).to(dtype)
    k, v = (torch.randn((B, S, KV, hd), generator=g, device=card).to(dtype)
            for _ in range(2))
    o, L = flash_attention_lse(q, k, v, causal=causal, window=window)
    assert torch.equal(o, flash_attention_kernel(q, k, v, causal=causal,
                                                 window=window))
    do = torch.randn(q.shape, generator=g, device=card).to(dtype)
    n, n_tc = flash_attention_bwd_kernel.launches, flash_attention_bwd_kernel.launches_tc
    got = flash_attention_bwd_kernel(q, k, v, o, do, L, causal=causal, window=window)
    assert flash_attention_bwd_kernel.launches == n + 1
    tc = dtype == torch.bfloat16 and hd in (64, 128, 256)
    assert flash_bwd_route(dtype, hd) == ("tc" if tc else "ffma")
    assert flash_attention_bwd_kernel.launches_tc == n_tc + tc
    want = attention_bwd_ref(q, k, v, o, do, L, causal, window)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype
        _bwd_close(a, b, f"d{name} {dtype} hd={hd} G={G} S={S}")


@pytest.mark.cuda
def test_head_dim_256_trains_on_tc_forward_and_ffma_backward(card):
    """recurrentgemma's local attention under autograd (bf16, 10 query heads
    on one KV head, head_dim 256, a window of 96 over 320 positions): the
    forward launches the tensor-core kernel with L, the backward the
    tensor-core backward on that L (bf16 at 256 is the tensor cores' both
    ways; float32 stays on FFMA), and the gradients match the plain
    backward's."""
    assert flash_route(torch.bfloat16, 256) == "tc"
    assert flash_bwd_route(torch.bfloat16, 256) == "tc"
    assert flash_bwd_route(torch.float32, 256) == "ffma"
    g = torch.Generator(device=card).manual_seed(256)
    B, S, H, hd, window = 2, 320, 10, 256, 96
    q = torch.randn((B, S, H, hd), generator=g, device=card).bfloat16()
    k, v = (torch.randn((B, S, 1, hd), generator=g, device=card).bfloat16()
            for _ in range(2))
    do = torch.randn(q.shape, generator=g, device=card).bfloat16()
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    n_f, n_ftc = flash_attention_kernel.launches, flash_attention_kernel.launches_tc
    n_b, n_btc = (flash_attention_bwd_kernel.launches,
                  flash_attention_bwd_kernel.launches_tc)
    out = flash_attention_kernel(qg, kg, vg, causal=True, window=window)
    assert flash_attention_kernel.launches == n_f + 1
    assert flash_attention_kernel.launches_tc == n_ftc + 1
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    assert flash_attention_bwd_kernel.launches == n_b + 1
    assert flash_attention_bwd_kernel.launches_tc == n_btc + 1
    o, L = flash_attention_lse(q, k, v, causal=True, window=window)
    assert torch.equal(o, out.detach())
    want = attention_bwd_ref(q, k, v, o, do, L, True, window)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16
        _bwd_close(a, b, f"d{name} bf16 hd=256 MQA window={window}")


@pytest.mark.cuda
def test_tensor_core_kernels_launch_from_a_thread_that_made_no_cuda_call(card):
    """The tensor-core kernels encode their TMA maps with a libcuda call that
    needs a context current on the calling thread.  A fresh thread whose
    tensors come from the allocator's cache (autograd's backward thread, a
    serving worker) has made no runtime call; the forward with L and the
    backward launch there all the same, with the main thread's bits."""
    g = torch.Generator(device=card).manual_seed(5)
    B, S, H, KV, hd = 1, 160, 4, 1, 256
    q = torch.randn((B, S, H, hd), generator=g, device=card).bfloat16()
    k, v = (torch.randn((B, S, KV, hd), generator=g, device=card).bfloat16()
            for _ in range(2))
    do = torch.randn(q.shape, generator=g, device=card).bfloat16()

    def both():
        o, L = flash_attention_lse(q, k, v, window=64)
        return (o, L, *flash_attention_bwd_kernel(q, k, v, o, do, L, window=64))

    want = both()
    del_me = both()          # freed: the thread's allocations hit the cache
    del del_me
    torch.cuda.synchronize()
    got, errors = [], []

    def work():
        try:
            got.extend(both())
            torch.cuda.synchronize()
        except Exception as e:   # reported on the main thread below
            errors.append(e)

    t = threading.Thread(target=work)
    t.start()
    t.join()
    assert not errors, errors
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_tc_backward_flips_under_a_quarter_of_rounding_once(card):
    """The tensor-core route keeps P and dS in float32 (three bf16 parts):
    its bf16 gradients differ from the plain float32 ones rounded at most a
    quarter as often as the plain version's with P and dS rounded once."""
    g = torch.Generator(device=card).manual_seed(3)
    B, S, H, KV, hd = 2, 1024, 6, 2, 128
    q = torch.randn((B, S, H, hd), generator=g, device=card).bfloat16()
    k, v = (torch.randn((B, S, KV, hd), generator=g, device=card).bfloat16()
            for _ in range(2))
    do = torch.randn(q.shape, generator=g, device=card).bfloat16()
    o, L = flash_attention_lse(q, k, v)
    n_tc = flash_attention_bwd_kernel.launches_tc
    got = flash_attention_bwd_kernel(q, k, v, o, do, L)
    assert flash_attention_bwd_kernel.launches_tc == n_tc + 1
    want = [w.bfloat16() for w in attention_bwd_ref(q, k, v, o, do, L)]
    once = attention_bwd_ref(q, k, v, o, do, L, parts=1)
    n = sum(w.numel() for w in want)

    def flips(grads):
        return sum(int((a.bfloat16() != w).sum()) for a, w in zip(grads, want)) / n

    assert flips(got) <= flips(once) / 4


@pytest.mark.cuda
def test_kernel_output_has_a_grad_fn_and_backward_launches_the_kernel(card):
    g = torch.Generator(device=card).manual_seed(1)
    q, k, v = (torch.randn((2, 96, 4, 64), generator=g, device=card)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    out = flash_attention_kernel(q, k, v, causal=True)
    assert out.grad_fn is not None
    n = flash_attention_bwd_kernel.launches
    out.float().sum().backward()
    assert flash_attention_bwd_kernel.launches == n + 1
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in (q, k, v))


@pytest.mark.cuda
def test_two_layer_llama_gradients_match_the_plain_route(card, monkeypatch):
    cfg = dataclasses.replace(configs.get("llama3.2-3b"), num_layers=2)
    params = init_params(torch.Generator(device=card).manual_seed(0), cfg)
    leaves = list(tree_leaves(params))
    g = torch.Generator(device=card).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 256), generator=g, device=card)

    def grads():
        for p in leaves:
            p.requires_grad_(True)
        logits, _ = forward(cfg, params, toks)
        loss = lm_loss(cfg, logits, toks.roll(-1, 1))
        out = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        return loss.detach(), out

    n = flash_attention_bwd_kernel.launches
    loss_k, g_k = grads()
    assert flash_attention_bwd_kernel.launches == n + 2
    monkeypatch.setattr(attn, "flash_attention_kernel",
                        lambda q, k, v, *, causal, window:
                        attention_ref(q, k, v, causal, window))
    loss_p, g_p = grads()
    assert abs(float(loss_k) / float(loss_p) - 1) < 1e-3
    for a, b in zip(g_k, g_p):
        assert bool(a.abs().sum() > 0), "a leaf got no gradient"
        assert float((a - b).norm() / b.norm()) < 5e-2


@pytest.mark.cuda
def test_pipeline_picks_match_the_plain_route(card):
    """selection="ss" (FeatureCoverage): the kernel route's picks equal the
    plain route's under the same generator state.  (The matrix-free FL of
    "ss_fl" computes its similarities in another order on each route, so
    its near ties can flip: ``chip_smoke.py`` explains those.)"""
    selection = "ss"
    dc = DataConfig(batch_size=16, seq_len=512, vocab_size=32000,
                    selection=selection)
    pipe = Pipeline(dc, seed=3)
    docs = pipe._pool()
    W = hashed_features(docs[:, :-1], dc.feature_dim, dc.ngram)
    state = pipe._gen.get_state()
    got = select_documents(W, 16, selection, {"generator": pipe._gen}, device=card)
    g2 = torch.Generator(device=card)
    g2.set_state(state)
    want = select_documents(W, 16, selection, {"generator": g2}, device=card,
                            backend="reference")
    np.testing.assert_array_equal(got, want)
