"""The SS hot spot: fused submodularity-graph divergence of FeatureCoverage.

    w_v = min_{u in U} [ sum_f w_f phi(CU[u, f] + W[v, f]) - phi_cu[u] - resid[u] ]

for every candidate v in one pass.  On a CUDA tensor the wrapper launches the
hand-written kernels in ``csrc/ss_divergence.cu`` (counterpart of the Pallas
``repro/kernels/ss_weights.py:ss_divergence_kernel``), which sum only the
terms W's nonzeros make nonzero, phi(CU + W) - phi(CU), and add the probe's
offset sum_f w_f phi(CU[u]) - phi_cu[u] - resid[u] once; a block whose rows
are dense (a rule of the kernel's own, stated in its note) runs a dense loop
with the same bits.  The wrapper allocates their scratch
(``_build.ss_scratch_floats``), where each block also flags its loop.  On a
CPU tensor it runs the plain version, :func:`ss_divergence_ref`.  Nothing
else: a failed build or launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ss_divergence_ref

Tensor = torch.Tensor

__all__ = ["ss_divergence_kernel", "ss_divergence_ref"]


def ss_divergence_kernel(
    W: Tensor,          # (n, F) float32 or bfloat16
    CU: Tensor,         # (r, F) float32 probe coverage rows
    phi_cu: Tensor,     # (r,) float32; -INF marks a pad probe
    resid: Tensor,      # (r,) float32
    cap: Tensor | None = None,      # (F,) float32, satcov only
    feat_w: Tensor | None = None,   # (F,) float32
    cand_idx: Tensor | None = None,  # (k,) int64 rows of W
    *,
    phi: str = "sqrt",
) -> Tensor:
    """Divergence of every row of ``W`` (or of the rows ``cand_idx`` names)
    against the probes.  Returns (n,) or (k,) float32.

    ``ss_divergence_kernel.launches`` counts the kernel launches (CPU calls
    do not count).  A ``cand_idx`` entry outside W gives NaN on the card and
    an IndexError on the CPU.
    """
    _build.check_inputs("ss_divergence", W, cand_idx, phi, cap, CU=CU,
                        phi_cu=phi_cu, resid=resid, feat_w=feat_w)
    n, F = W.shape
    if CU.dim() != 2 or CU.shape[1] != F or CU.shape[0] < 1:
        raise ValueError(f"ss_divergence: CU must be (r >= 1, {F}), got "
                         f"{tuple(CU.shape)}")
    r = CU.shape[0]
    if r >= 2**31:
        raise ValueError(f"ss_divergence: too many probes ({r})")
    for arg, t, shape in (("phi_cu", phi_cu, (r,)), ("resid", resid, (r,)),
                          ("cap", cap, (F,)), ("feat_w", feat_w, (F,))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"ss_divergence: {arg} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if W.device.type == "cpu":
        return ss_divergence_ref(W, CU, phi_cu, resid, cap, phi, feat_w,
                                 cand_idx)
    n_out = n if cand_idx is None else cand_idx.shape[0]
    out = torch.empty((n_out,), dtype=torch.float32, device=W.device)
    if n_out == 0:
        return out
    scratch = torch.empty((_build.ss_scratch_floats(r, F, n_out),),
                          dtype=torch.float32, device=W.device)
    _launch(W, CU, phi_cu, resid, cap, feat_w, cand_idx, phi, scratch, out)
    return out


def _launch(W: Tensor, CU: Tensor, phi_cu: Tensor, resid: Tensor,
            cap: Tensor | None, feat_w: Tensor | None, cand_idx: Tensor | None,
            phi: str, scratch: Tensor, out: Tensor) -> None:
    """The kernels on checked CUDA tensors, into ``out`` (n_out >= 1), with
    ``scratch`` of ``_build.ss_scratch_floats`` floats; each block's loop
    is left in its flag there (int32, the scratch's last
    ceil(n_out / SS_BLOCK_CANDS) floats: 1 = dense)."""
    n, F = W.shape
    lib = _build.load_library()
    with torch.cuda.device(W.device):
        rc = lib.ss_divergence_launch(
            W.data_ptr(), int(W.dtype == torch.bfloat16), n, F,
            _build.ptr(cand_idx), out.shape[0], CU.data_ptr(), phi_cu.data_ptr(),
            resid.data_ptr(), CU.shape[0], _build.ptr(cap), _build.ptr(feat_w),
            _build.PHI_CODES[phi], scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on_error("ss_divergence", rc)
    ss_divergence_kernel.launches += 1


ss_divergence_kernel.launches = 0
