"""Plain PyTorch versions of the two FeatureCoverage kernels.

They define the arithmetic the CUDA kernels must match: every input is
upcast to float32 and the feature reduction accumulates in float32.  The
wrappers in :mod:`repro_torch.kernels.ss_weights` and
:mod:`repro_torch.kernels.feature_gains` run them for tensors on the CPU; on
the card they serve only as the comparison in ``chip_smoke.py``.

Both walk the candidate rows in chunks (and the probes one at a time), so the
(r, n, F) block of the textbook formula never exists: at n = 2^20, F = 1024 a
single (n, F) float32 temporary is already 4 GiB.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

INF = 1e30

PHI_KINDS = ("sqrt", "log1p", "setcover", "satcov", "linear")

# Candidate rows per chunk: bounds each (rows, F) float32 temporary to
# 256 MiB at F = 1024.
_ROW_CHUNK = 1 << 16


def _phi(kind: str, c: Tensor, cap: Tensor | None) -> Tensor:
    """Concave scalar transforms phi(c), elementwise."""
    if kind == "sqrt":
        return torch.sqrt(torch.clamp_min(c, 0.0))
    if kind == "log1p":
        return torch.log1p(torch.clamp_min(c, 0.0))
    if kind == "setcover":
        return torch.clamp_max(c, 1.0)
    if kind == "satcov":
        if cap is None:
            raise ValueError("phi='satcov' needs a cap vector")
        return torch.minimum(c, cap)
    if kind == "linear":
        return c
    raise ValueError(f"unknown concave transform {kind!r}")


def _rows(W: Tensor, cand_idx: Tensor | None, lo: int, hi: int) -> Tensor:
    rows = W[lo:hi] if cand_idx is None else W[cand_idx[lo:hi]]
    return rows.float()


def ss_divergence_ref(
    W: Tensor,             # (n, F) candidate feature rows
    CU: Tensor,            # (r, F) probe coverage rows (state + W[probe])
    phi_cu: Tensor,        # (r,) sum_f w_f phi(CU); -INF marks a pad probe
    resid: Tensor,         # (r,) residual gains f(u | V \\ u)
    cap: Tensor | None = None,     # (F,) satcov caps
    phi: str = "sqrt",
    feat_w: Tensor | None = None,  # (F,) feature weights
    cand_idx: Tensor | None = None,  # (k,) rows of W to evaluate
) -> Tensor:
    """w_v = min_u [sum_f w_f phi(CU_u + W_v) - phi_cu_u - resid_u].

    Shape (n,), or (k,) with ``cand_idx``.  A pad probe (phi_cu = -INF)
    gives +INF and never wins the min.
    """
    CUf = CU.float()
    capf = None if cap is None else cap.float()
    fw = None if feat_w is None else feat_w.float()
    base = phi_cu.float()
    n_out = W.shape[0] if cand_idx is None else cand_idx.shape[0]
    out = torch.empty((n_out,), dtype=torch.float32, device=W.device)
    for lo in range(0, n_out, _ROW_CHUNK):
        hi = min(n_out, lo + _ROW_CHUNK)
        rows = _rows(W, cand_idx, lo, hi)
        best = torch.full((hi - lo,), INF, dtype=torch.float32, device=W.device)
        for u in range(CUf.shape[0]):
            val = _phi(phi, CUf[u] + rows, capf)
            if fw is not None:
                val = val * fw
            w = (val.sum(dim=-1) - base[u]) - resid[u].float()
            best = torch.minimum(best, w)
        out[lo:hi] = best
    return out


def feature_gains_ref(
    W: Tensor,            # (n, F)
    c: Tensor,            # (F,) current coverage state
    phi_c: Tensor,        # scalar: sum_f w_f phi(c)
    cap: Tensor | None = None,
    phi: str = "sqrt",
    feat_w: Tensor | None = None,
    cand_idx: Tensor | None = None,
) -> Tensor:
    """g_v = sum_f w_f phi(c + W_v) - phi_c.  Shape (n,), or (k,)."""
    cf = c.float()
    capf = None if cap is None else cap.float()
    fw = None if feat_w is None else feat_w.float()
    n_out = W.shape[0] if cand_idx is None else cand_idx.shape[0]
    out = torch.empty((n_out,), dtype=torch.float32, device=W.device)
    for lo in range(0, n_out, _ROW_CHUNK):
        hi = min(n_out, lo + _ROW_CHUNK)
        val = _phi(phi, cf + _rows(W, cand_idx, lo, hi), capf)
        if fw is not None:
            val = val * fw
        out[lo:hi] = val.sum(dim=-1) - phi_c.float()
    return out
