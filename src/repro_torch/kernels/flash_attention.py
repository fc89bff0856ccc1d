"""Fused online-softmax attention: the prefill attention of the LM path.

    O = softmax(mask(Q Kᵀ / √hd)) V

with the causal mask (qpos >= kpos), a sliding window (qpos - kpos <
window, causal only) or no mask: the counterpart of the Pallas
``repro/kernels/flash_attention.py:flash_attention``.  On CUDA tensors the
wrapper launches one of two hand-written kernels, chosen by
:func:`flash_route` from the dtype and head width alone:

- ``"tc"`` (bfloat16 at head_dim 64, 128 or 256):
  ``csrc/flash_attention_tc.cu``, both products on the tensor cores
  (wgmma), TMA-fed; at 256 each half of O's columns is one CTA.  P stays
  float32: P·V is summed over ``TC_PARTS`` bfloat16 parts of P
  (:func:`split_bf16 <repro_torch.kernels.ref.split_bf16>`).  TMA needs
  16-byte aligned tensors with strides of 16 bytes; anything else raises.
- ``"ffma"`` (float32, and bfloat16 at head_dim 32):
  ``csrc/flash_attention.cu``, IEEE float32 FFMA on the CUDA cores.

On CPU tensors it runs the plain version,
:func:`~repro_torch.kernels.ref.attention_ref`.  Nothing else: a failed
build or launch raises, and no route stands in for another.

Training goes through :class:`FlashAttentionFn`, the autograd function
around the kernels: its forward launches the kernel of the same route with
each row's L = m + log(max(l, 1e-30)) requested (:func:`flash_attention_lse`),
and its backward (:func:`flash_attention_bwd_kernel`) the backward kernel
that :func:`flash_bwd_route` names (the forward's rule), never the plain
backward: ``csrc/flash_attention_bwd_tc.cu`` on ``"tc"`` (bfloat16 at
head_dim 64, 128 or 256; all five products on the tensor cores, P and dS
float32 in ``TC_PARTS`` bfloat16 parts; at 256 the two consumer warpgroups
of a CTA each own one column half of the gradients),
``csrc/flash_attention_bwd.cu`` on ``"ffma"`` (float32, and bfloat16 at
head_dim 32; it reads the L that either forward writes, the same natural
log).
``flash_attention_kernel`` takes that path whenever grad mode is on and an
input requires grad; otherwise (serving, ``torch.no_grad()``) it launches
what it always did, L not requested.

Each launch is an operator the dispatcher sees (``torch.library.custom_op``):
``repro_torch::flash_attention`` (O), ``repro_torch::flash_attention_lse``
(O and L) and ``repro_torch::flash_attention_bwd`` (dq, dk, dv).  On CPU
tensors an operator's body is the plain version; on any other device
(the card, or a meta tensor) it launches the route's kernel.  Under
``FakeTensorMode`` each returns empty outputs of the right shapes and
dtypes and builds and launches nothing, so a whole step can be traced and
counted without a card (``repro_torch.launch.cost``).
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_bwd_ref, attention_lse_ref, attention_ref

Tensor = torch.Tensor

__all__ = ["HEAD_DIMS", "TC_HEAD_DIMS", "TC_PARTS",
           "FlashAttentionFn", "flash_attention_bwd_kernel",
           "flash_attention_kernel", "flash_attention_lse", "flash_bwd_route",
           "flash_route"]

# The head widths the FFMA kernels are compiled for (csrc/flash_attention.cu,
# csrc/flash_attention_bwd.cu), and those of the tensor-core kernels
# (csrc/flash_attention_tc.cu and csrc/flash_attention_bwd_tc.cu, bfloat16
# only).
HEAD_DIMS = (32, 64, 128, 256)
TC_HEAD_DIMS = (64, 128, 256)
# bfloat16 parts of P in the tensor-core kernel's P·V (its PARTS), and of
# P and dS in the tensor-core backward's dV, dK and dQ.
TC_PARTS = 3
# The tensor-core backward's L and D scratch pads S to a multiple of this
# (PAD in csrc/flash_attention_bwd_tc.cu; rows a CTA owns divide it).
TC_BWD_ROWS = 128


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that computes attention on these inputs: ``"tc"`` for
    bfloat16 at head_dim 64, 128 or 256, ``"ffma"`` for the rest.  A fixed
    rule: the wrapper never reroutes on failure."""
    return "tc" if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS else "ffma"


def flash_bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that computes the gradient on these inputs: ``"tc"`` for
    bfloat16 at head_dim 64, 128 or 256, ``"ffma"`` for the rest (float32,
    and bfloat16 at 32).  A fixed rule: the forward's, since the
    tensor-core backward covers every width the tensor-core forward does."""
    return flash_route(dtype, head_dim)


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


def _tma_ready(t: Tensor) -> Tensor:
    """``t`` if it is contiguous and 16-byte aligned (at the tensor-core
    backward's head widths that meets :func:`check_tc_layout`'s rule), else
    a contiguous copy: the
    backward's O and dO, which autograd may hand over in any layout."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = FlashAttentionFn.apply(q, k, v, causal, window)
    else:
        out = _flash_op(q, k, v, causal, window)
    return out[:, :, 0] if flat else out


def flash_attention_lse(
    q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True, window: int = 0,
) -> tuple[Tensor, Tensor]:
    """(O, L) on (B, S, H, hd) inputs: ``flash_attention_kernel``'s output
    and each query row's float32 L = m + log(max(l, 1e-30)), (B, H, S),
    from one launch of the same route (counted in
    ``flash_attention_kernel.launches``); O's bits are those of a launch
    without L.  On CPU tensors, :func:`attention_lse_ref`."""
    _check(q, k, v, window)
    if q.dim() != 4:
        raise ValueError("flash_attention_lse: q, k and v must be (B, S, heads, hd)")
    return _flash_lse_op(q, k, v, causal, window)


def _forward(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
             lse: bool) -> tuple[Tensor, Tensor | None]:
    """O (and L when ``lse``) on checked (B, S, heads, hd) inputs: the body
    of the forward operators."""
    tc = flash_route(q.dtype, q.shape[-1]) == "tc"
    if tc:
        check_tc_layout(q, k, v)
    if q.device.type == "cpu":
        if lse:
            return attention_lse_ref(q, k, v, causal, window)
        return attention_ref(q, k, v, causal, window), None
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    L = None
    if lse:
        B, S, H, _ = q.shape
        L = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch(q, k, v, out, causal, window, tc, L)
    return out, L


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int) -> Tensor:
    """The forward launch, L not requested: O."""
    return _forward(q, k, v, causal, window, lse=False)[0]


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=())
def _flash_lse_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                  window: int) -> tuple[Tensor, Tensor]:
    """The forward launch with each row's L: (O, L)."""
    return _forward(q, k, v, causal, window, lse=True)


# The fake versions serve FakeTensorMode: empty outputs, nothing built or
# launched.  The dispatcher also sends a plain meta tensor to them; it takes
# the card's branch (the launch), as it did before the launches were
# operators.


@_flash_op.register_fake
def _(q, k, v, causal, window):
    if not is_fake(q):
        return _forward(q, k, v, causal, window, lse=False)[0]
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@_flash_lse_op.register_fake
def _(q, k, v, causal, window):
    if not is_fake(q):
        return _forward(q, k, v, causal, window, lse=True)
    B, S, H, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, H, S), dtype=torch.promote_types(q.dtype, torch.float32)))


def _launch(q: Tensor, k: Tensor, v: Tensor, out: Tensor, causal: bool,
            window: int, tc: bool, lse: Tensor | None = None) -> None:
    """One kernel on (B, S, heads, hd) tensors: the tensor-core kernel
    (``tc``: bfloat16, laid out as ``check_tc_layout`` requires) or the
    CUDA-core kernel (either dtype); ``lse`` (B, H, S) float32 or None."""
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
            _build.ptr(lse), *flag, B, S, H, k.shape[2], hd, *strides,
            int(causal), int(window), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on_error(name, rc)
    flash_attention_kernel.launches += 1
    flash_attention_kernel.launches_tc += tc


flash_attention_kernel.launches = 0
flash_attention_kernel.launches_tc = 0


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient, on (B, S, H, hd) q and (B, S, KV,
    hd) k and v: ``FlashAttentionFn.apply(q, k, v, causal, window)``.

    Forward: :func:`flash_attention_lse` (the forward kernel with L); it
    saves q, k, v, O and L.  Backward: :func:`flash_attention_bwd_kernel`,
    the backward kernel on CUDA tensors.  On CPU tensors both directions
    are the plain versions (any float dtype, float64 included)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        if q.device.type != "cpu":
            _check(q, k, v, window)
        o, L = _flash_lse_op(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, L)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, L = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(q, k, v, o, do, L,
                                                causal=ctx.causal,
                                                window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_bwd_kernel(
    q: Tensor, k: Tensor, v: Tensor, o: Tensor, do: Tensor, lse: Tensor, *,
    causal: bool = True, window: int = 0,
) -> tuple[Tensor, Tensor, Tensor]:
    """The flash function's gradient (dq, dk, dv), shaped and typed like q,
    k and v, from the forward's O and L and the output gradient ``do``, on
    (B, S, H, hd) q and (B, S, KV, hd) k and v.  On CUDA tensors the
    backward kernel of ``flash_bwd_route(q.dtype, head_dim)``: ``"tc"``,
    ``csrc/flash_attention_bwd_tc.cu`` (q, k and v laid out as
    :func:`check_tc_layout` requires, O and dO copied where they are not),
    or ``"ffma"``, ``csrc/flash_attention_bwd.cu``.
    ``.launches`` counts launches of both routes (a pre-pass and two
    kernels each), ``.launches_tc`` those of the tensor-core route; on CPU
    tensors :func:`~repro_torch.kernels.ref.attention_bwd_ref`, rounded to
    the input dtype (CPU calls do not count)."""
    if q.device.type == "cpu":
        return _flash_bwd_op(q, k, v, o, do, lse, causal, window)
    _check(q, k, v, window)
    if q.dim() != 4:
        raise ValueError("flash_attention_bwd: q, k and v must be (B, S, heads, hd)")
    B, S, H, hd = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, S):
        raise ValueError("flash_attention_bwd: q, o and do must be (B, S, H, hd) "
                         "and lse (B, H, S)")
    for arg, t in (("o", o), ("do", do)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"flash_attention_bwd: {arg} must be {q.dtype} on "
                            f"{q.device}")
    if lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise TypeError("flash_attention_bwd: lse must be contiguous float32 on "
                        f"{q.device}")
    return _flash_bwd_op(q, k, v, o, do, lse, causal, window)


def _bwd_body(q: Tensor, k: Tensor, v: Tensor, o: Tensor, do: Tensor,
              lse: Tensor, causal: bool, window: int) -> tuple[Tensor, Tensor, Tensor]:
    """The backward operator's body: on CPU tensors the plain backward
    rounded to the input dtype, else the kernel of ``flash_bwd_route``."""
    if q.device.type == "cpu":
        return tuple(g.to(t.dtype) for g, t in zip(
            attention_bwd_ref(q, k, v, o, do, lse, causal, window), (q, k, v)))
    return _bwd_launch(q, k, v, o, do, lse, causal, window,
                       flash_bwd_route(q.dtype, q.shape[-1]) == "tc")


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _flash_bwd_op(q: Tensor, k: Tensor, v: Tensor, o: Tensor, do: Tensor,
                  lse: Tensor, causal: bool, window: int
                  ) -> tuple[Tensor, Tensor, Tensor]:
    """The backward launch: (dq, dk, dv)."""
    return _bwd_body(q, k, v, o, do, lse, causal, window)


@_flash_bwd_op.register_fake
def _(q, k, v, o, do, lse, causal, window):
    if not is_fake(q):
        return _bwd_body(q, k, v, o, do, lse, causal, window)
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (q, k, v))


def _bwd_launch(q: Tensor, k: Tensor, v: Tensor, o: Tensor, do: Tensor,
                lse: Tensor, causal: bool, window: int,
                tc: bool) -> tuple[Tensor, Tensor, Tensor]:
    """One backward on checked (B, S, heads, hd) CUDA tensors: the
    tensor-core kernel (``tc``: bfloat16 at head_dim 64, 128 or 256) or the
    CUDA-core kernel (either dtype, any head width of HEAD_DIMS)."""
    B, S, H, hd = q.shape
    if tc:
        check_tc_layout(q, k, v)
        o, do = _tma_ready(o), _tma_ready(do)
    else:
        o, do = (t if t.stride(-1) == 1 else t.contiguous() for t in (o, do))
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    if B * S * H == 0:
        return dq, dk, dv
    strides = (ctypes.c_longlong * 24)(*[
        t.stride(i) for t in (q, k, v, o, do, dq, dk, dv) for i in range(3)])
    lib = _build.load_library()
    if tc:
        spad = -(-S // TC_BWD_ROWS) * TC_BWD_ROWS
        scratch = torch.empty(B * H * 2 * spad, dtype=torch.float32, device=q.device)
        name, fn, flag = "flash_attention_bwd_tc", lib.flash_attention_bwd_tc_launch, ()
    else:
        scratch = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        name, fn = "flash_attention_bwd", lib.flash_attention_bwd_launch
        flag = (int(q.dtype == torch.bfloat16),)
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *flag, B, S, H, k.shape[2], hd,
            ctypes.addressof(strides), int(causal), int(window),
            1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on_error(name, rc)
    flash_attention_bwd_kernel.launches += 1
    flash_attention_bwd_kernel.launches_tc += tc
    return dq, dk, dv


flash_attention_bwd_kernel.launches = 0
flash_attention_bwd_kernel.launches_tc = 0
