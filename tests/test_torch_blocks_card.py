"""The other LM block types' kernel on the card: the flash kernel at
recurrentgemma's head_dim 256 with a window shorter than the prompt and one
KV head (MQA), bf16 on the tensor-core route and float32 on the FFMA
route, and one olmoe-shaped attention + MoE layer
routed from either attention route's output (the kernel's and the plain
version's) picking the same experts but for near ties.  These tests need a
CUDA card (marker ``cuda``) and skip without one; they import nothing of
JAX:

    python -m pytest -m cuda tests/test_torch_blocks_card.py
"""

import math

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import attention_ref, flash_attention_kernel, flash_route
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.decoder import _block_init
from repro_torch.models.layers import rmsnorm


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels are CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ffma_flash_windowed_mqa_at_head_dim_256(card, dtype):
    """recurrentgemma's local attention: 10 query heads on one KV head,
    head_dim 256, a window of 128 over 640 positions; bf16 launches the
    tensor-core kernel (O in two column halves), float32 the FFMA kernel.
    Per element within one bfloat16 rounding of the plain version (2^-7
    |ref| plus 1e-3 of the row's largest), float32 within 2e-4."""
    g = torch.Generator(device=card).manual_seed(0)
    B, S, H, hd, window = 2, 640, 10, 256, 128
    q = torch.randn((B, S, H, hd), generator=g, device=card).to(dtype)
    k = torch.randn((B, S, 1, hd), generator=g, device=card).to(dtype)
    v = torch.randn((B, S, 1, hd), generator=g, device=card).to(dtype)
    tc = dtype == torch.bfloat16
    assert flash_route(dtype, hd) == ("tc" if tc else "ffma")
    n, n_tc = flash_attention_kernel.launches, flash_attention_kernel.launches_tc
    out = flash_attention_kernel(q, k, v, causal=True, window=window)
    assert flash_attention_kernel.launches == n + 1
    assert flash_attention_kernel.launches_tc == n_tc + tc
    ref = attention_ref(q, k, v, True, window)
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 2e-4
    else:
        r = ref.float().abs()
        assert bool((diff <= 2.0 ** -7 * r + 1e-3 * r.amax(-1, keepdim=True)).all())
    # the window masks: a key 128 positions back changes nothing
    k2, v2 = k.clone(), v.clone()
    k2[:, 0], v2[:, 0] = 0, 0
    out2 = flash_attention_kernel(q, k2, v2, causal=True, window=window)
    assert torch.equal(out2[:, window:], out[:, window:])


@pytest.mark.cuda
def test_olmoe_layer_routes_alike_under_both_attention_routes(card):
    """One olmoe layer at its widths (d_model 2048, 16 heads of 128, 64
    experts top-8, qk-norm, bf16 compute) on 2 x 512 tokens: attention on
    the tensor-core route and through the plain version, the residual
    routed from each.  A token whose top-8 sets differ must be a near tie:
    on each route the logits of the experts it swaps are equal or adjacent
    bfloat16 values (the widest gap between one it picks and one it passes
    over at most one bfloat16 spacing at their magnitude)."""
    cfg = configs.get("olmoe-1b-7b")
    p = _block_init(torch.Generator(device=card).manual_seed(0), cfg, "attn_moe")
    g = torch.Generator(device=card).manual_seed(1)
    B, S = 2, 512
    x = torch.randn((B, S, cfg.d_model), generator=g, device=card).bfloat16()
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = attn._project_qkv(p["attn"], cfg, h, torch.arange(S, device=card))
    n_tc = flash_attention_kernel.launches_tc
    logits = []
    for o in (flash_attention_kernel(q, k, v), attention_ref(q, k, v, True, 0)):
        xr = x + o.reshape(B, S, cfg.q_dim) @ p["attn"]["w_o"].bfloat16()
        h2 = rmsnorm(p["ln2"], xr, cfg.norm_eps).reshape(B * S, -1)
        logits.append((h2 @ p["moe"]["router"].bfloat16()).float())
    assert flash_attention_kernel.launches_tc == n_tc + 1
    sets = [moe.top_k(torch.softmax(lg, -1), cfg.top_k)[1].sort(-1).values
            for lg in logits]
    differ = (sets[0] != sets[1]).any(-1).nonzero()[:, 0].tolist()
    assert len(differ) <= B * S // 20, len(differ)

    def spacings(lg, hi, lo):
        mag = float(lg[hi + lo].abs().max())
        return float(lg[hi].max() - lg[lo].min()) / 2.0 ** (math.floor(math.log2(mag)) - 7)

    for t in differ:
        a = sorted(set(sets[0][t].tolist()) - set(sets[1][t].tolist()))
        b = sorted(set(sets[1][t].tolist()) - set(sets[0][t].tolist()))
        gaps = spacings(logits[1][t], b, a), spacings(logits[0][t], a, b)
        assert max(gaps) <= 1, (t, a, b, gaps)
