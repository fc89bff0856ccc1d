"""Fused online-softmax attention: the prefill attention of the LM path.

    O = softmax(mask(Q Kᵀ / √hd)) V

with the causal mask (qpos >= kpos), a sliding window (qpos - kpos <
window, causal only) or no mask: the counterpart of the Pallas
``repro/kernels/flash_attention.py:flash_attention``.  On CUDA tensors the
wrapper launches one of two hand-written kernels, chosen by
:func:`flash_route` from the dtype and head width alone:

- ``"tc"`` (bfloat16 at head_dim 64 or 128): ``csrc/flash_attention_tc.cu``,
  both products on the tensor cores (wgmma), TMA-fed.  P stays float32: P·V
  is summed over ``TC_PARTS`` bfloat16 parts of P (:func:`split_bf16
  <repro_torch.kernels.ref.split_bf16>`).  TMA needs 16-byte aligned
  tensors with strides of 16 bytes; anything else raises.
- ``"ffma"`` (float32, and bfloat16 at head_dim 32 or 256):
  ``csrc/flash_attention.cu``, IEEE float32 FFMA on the CUDA cores.

On CPU tensors it runs the plain version,
:func:`~repro_torch.kernels.ref.attention_ref`.  Nothing else: a failed
build or launch raises, and no route stands in for another.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

Tensor = torch.Tensor

__all__ = ["HEAD_DIMS", "TC_HEAD_DIMS", "TC_PARTS", "flash_attention_kernel",
           "flash_route"]

# The head widths the FFMA kernel is compiled for (csrc/flash_attention.cu),
# and the tensor-core kernel (csrc/flash_attention_tc.cu, bfloat16 only).
HEAD_DIMS = (32, 64, 128, 256)
TC_HEAD_DIMS = (64, 128)
# bfloat16 parts of P in the tensor-core kernel's P·V (its PARTS).
TC_PARTS = 3


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that computes attention on these inputs: ``"tc"`` for
    bfloat16 at head_dim 64 or 128, ``"ffma"`` for the rest.  A fixed rule:
    the wrapper never reroutes on failure."""
    return "tc" if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS else "ffma"


def check_tc_layout(q: Tensor, k: Tensor, v: Tensor) -> None:
    """What the tensor-core route's TMA needs: each tensor's base 16-byte
    aligned and every stride but the last (contiguous) axis a multiple of
    16 bytes.  Raises ValueError otherwise."""
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {arg} is not 16-byte aligned, "
                             "which the tensor-core route's TMA needs")
        for i in range(t.dim() - 1):
            if t.stride(i) * t.element_size() % 16:
                raise ValueError(
                    f"flash_attention: {arg}'s stride {t.stride(i)} (axis {i}) "
                    "is not a multiple of 16 bytes, which the tensor-core "
                    "route's TMA needs")


def _check(q: Tensor, k: Tensor, v: Tensor, window: int) -> None:
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"flash_attention: {arg} must be a tensor")
        if t.dim() != q.dim() or t.dim() not in (3, 4):
            raise ValueError(
                "flash_attention: q, k and v must all be (BH, S, hd) or all "
                f"(B, S, heads, hd); got ranks {q.dim()}, {k.dim()}, {v.dim()}")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise TypeError("flash_attention: q, k and v must share one dtype, "
                            f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                            f"{v.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {arg} is on {t.device}, not "
                             f"{q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {arg}'s last axis must be "
                             "contiguous")
    if k.shape != v.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    hd = q.shape[-1]
    if q.dim() == 3 and k.shape != q.shape:
        raise ValueError(f"flash_attention: k must be {tuple(q.shape)}, got "
                         f"{tuple(k.shape)}")
    if q.dim() == 4:
        B, S, H, _ = q.shape
        if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, hd) or H % k.shape[2]:
            raise ValueError(
                f"flash_attention: k must be ({B}, {S}, KV, {hd}) with KV "
                f"dividing {H}, got {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} is not one of "
                         f"{HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    # The kernel's grid has one row of blocks per 64 query positions.
    if q.shape[-3] > 64 * 65535:
        raise ValueError(f"flash_attention: sequence too long ({q.shape[-3]})")


def flash_attention_kernel(
    q: Tensor,            # (BH, S, hd), or (B, S, H, hd)
    k: Tensor,            # (BH, S, hd), or (B, S, KV, hd)
    v: Tensor,            # as k
    *,
    causal: bool = True,
    window: int = 0,      # > 0: sliding window (causal only)
) -> Tensor:
    """Fused attention; returns an array shaped like q, in q's dtype.

    The TPU kernel's contract is the 3-D form: batch and heads flattened,
    k and v expanded to the query heads.  The 4-D form keeps the model's
    layout, with KV heads grouped (query head h reads KV head h // (H/KV)
    in place, so the expanded copy is never built).  The arithmetic is
    float32 on float32 or bfloat16 inputs (float32 P in P·V on both
    routes); head_dim must be one of ``HEAD_DIMS``.  The kernel is
    ``flash_route(q.dtype, head_dim)``'s.  ``flash_attention_kernel.launches``
    counts kernel launches of both routes, ``.launches_tc`` those of the
    tensor-core route (CPU calls do not count).
    """
    _check(q, k, v, window)
    flat = q.dim() == 3
    if flat:
        q, k, v = q[:, :, None], k[:, :, None], v[:, :, None]
    tc = flash_route(q.dtype, q.shape[-1]) == "tc"
    if tc:
        check_tc_layout(q, k, v)
    if q.device.type == "cpu":
        out = attention_ref(q, k, v, causal, window)
    else:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        _launch(q, k, v, out, causal, window, tc)
    return out[:, :, 0] if flat else out


def _launch(q: Tensor, k: Tensor, v: Tensor, out: Tensor, causal: bool,
            window: int, tc: bool) -> None:
    """One kernel on (B, S, heads, hd) tensors: the tensor-core kernel
    (``tc``: bfloat16, laid out as ``check_tc_layout`` requires) or the
    CUDA-core kernel (either dtype)."""
    B, S, H, hd = q.shape
    if B * S * H == 0:
        return
    lib = _build.load_library()
    strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
    if tc:
        name, fn, flag = "flash_attention_tc", lib.flash_attention_tc_launch, ()
    else:
        name, fn = "flash_attention", lib.flash_attention_launch
        flag = (int(q.dtype == torch.bfloat16),)
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *flag, B, S, H, k.shape[2], hd, *strides,
            int(causal), int(window), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on_error(name, rc)
    flash_attention_kernel.launches += 1
    flash_attention_kernel.launches_tc += tc


flash_attention_kernel.launches = 0
flash_attention_kernel.launches_tc = 0
