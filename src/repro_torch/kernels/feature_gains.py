"""The greedy inner loop: marginal gains of FeatureCoverage.

    g_v = sum_f w_f phi(c_f + W[v, f]) - phi_c

for every candidate v, once per greedy step.  On a CUDA tensor the wrapper
launches the hand-written kernel in ``csrc/feature_gains.cu`` (counterpart of
the Pallas ``repro/kernels/feature_gains.py:feature_gains_kernel``), which
sums phi(c + W) - phi(c) over a row's nonzeros only and adds
sum_f w_f phi(c) - phi_c once; on a CPU tensor it runs the plain version,
:func:`feature_gains_ref`.  Nothing else: a failed build or launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import feature_gains_ref

Tensor = torch.Tensor

__all__ = ["feature_gains_kernel", "feature_gains_ref"]


def feature_gains_kernel(
    W: Tensor,          # (n, F) float32 or bfloat16
    c: Tensor,          # (F,) float32 coverage state
    phi_c: Tensor,      # () float32: sum_f w_f phi(c)
    cap: Tensor | None = None,      # (F,) float32, satcov only
    feat_w: Tensor | None = None,   # (F,) float32
    cand_idx: Tensor | None = None,  # (k,) int64 rows of W
    *,
    phi: str = "sqrt",
) -> Tensor:
    """Gains of every row of ``W`` (or of the rows ``cand_idx`` names).
    Returns (n,) or (k,) float32.

    ``phi_c`` stays on the device, so a greedy step never waits on the host.
    ``feature_gains_kernel.launches`` counts the kernel launches (CPU calls
    do not count).
    """
    _build.check_inputs("feature_gains", W, cand_idx, phi, cap, c=c,
                        phi_c=phi_c, feat_w=feat_w)
    n, F = W.shape
    for arg, t, shape in (("c", c, (F,)), ("phi_c", phi_c, ()),
                          ("cap", cap, (F,)), ("feat_w", feat_w, (F,))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"feature_gains: {arg} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if W.device.type == "cpu":
        return feature_gains_ref(W, c, phi_c, cap, phi, feat_w, cand_idx)
    n_out = n if cand_idx is None else cand_idx.shape[0]
    out = torch.empty((n_out,), dtype=torch.float32, device=W.device)
    if n_out == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(W.device):
        rc = lib.feature_gains_launch(
            W.data_ptr(), int(W.dtype == torch.bfloat16), n, F,
            _build.ptr(cand_idx), n_out, c.data_ptr(), phi_c.data_ptr(),
            _build.ptr(cap), _build.ptr(feat_w), _build.PHI_CODES[phi],
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on_error("feature_gains", rc)
    feature_gains_kernel.launches += 1
    return out


feature_gains_kernel.launches = 0
