"""Matrix-free facility location: the fused kernels and the plain passes.

The objective is dense facility location with sim[i, v] = max(x_i . x_v, 0)
over embedding rows, but the (n, n) similarity is never stored:

    w_v = min_u [ sum_i max(sim[i, v] - MU[u, i], 0) - resid_u ]

On a CUDA tensor :func:`fl_stream_divergence_kernel` and its single-probe
instance :func:`fl_stream_gains_kernel` launch the hand-written kernel in
``csrc/fl_stream.cu`` (counterpart of the Pallas ``repro/kernels/
fl_stream.py:fl_stream_divergence_kernel`` / ``fl_stream_gains_kernel``),
which forms each similarity tile in registers; on a CPU tensor they run the
plain version, :func:`fl_stream_divergence_ref`.  A failed build or launch
raises.

``Xc`` (the candidate rows) is kept apart from ``X`` (the served rows), as in
the TPU kernel, for the compacted and sharded views; ``cand_idx`` gathers rows
of ``Xc``.

The residual gains f(v | V \\ v) need per-served-row statistics over all
candidates.  The JAX package computes them in ``lax.scan`` passes; here they
are loops over blocks of served rows, each block's similarity one IEEE
float32 ``torch.matmul`` of at most 256 MiB: :func:`fl_stream_col_max`,
:func:`fl_stream_top2`, :func:`fl_stream_count_best`,
:func:`fl_stream_best_loss_sum`, and :func:`fl_stream_residuals`, which
takes the statistics of each block in one pass.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    _ELEMS,
    NEG,
    fl_residuals,
    fl_stream_divergence_ref,
    fl_stream_pair_ref,
    sim_rows,
    top2,
)

Tensor = torch.Tensor

__all__ = [
    "fl_stream_best_loss_sum", "fl_stream_col_max", "fl_stream_count_best",
    "fl_stream_divergence_kernel", "fl_stream_divergence_ref",
    "fl_stream_gains_kernel", "fl_stream_pair_ref", "fl_stream_residuals",
    "fl_stream_top2",
]


def _check(name: str, X: Tensor, Xc: Tensor, MU: Tensor, resid: Tensor | None,
           cand_idx: Tensor | None) -> None:
    for arg, t in (("X", X), ("Xc", Xc)):
        if not isinstance(t, Tensor) or t.dim() != 2:
            raise ValueError(f"{name}: {arg} must be a 2-D tensor")
    if X.shape[1] != Xc.shape[1] or not 1 <= X.shape[1] < 2**31:
        raise ValueError(f"{name}: X and Xc need the same width d >= 1, got "
                         f"{X.shape[1]} and {Xc.shape[1]}")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {X.device}")
    _build.check_side(name, X, cand_idx, X=X, Xc=Xc, MU=MU, resid=resid)
    _build.check_probes(name, MU, resid, X.shape[0])


def _launch(X: Tensor, Xc: Tensor, MU: Tensor, resid: Tensor | None,
            cand_idx: Tensor | None) -> Tensor:
    n_out = Xc.shape[0] if cand_idx is None else cand_idx.shape[0]
    out = torch.empty((n_out,), dtype=torch.float32, device=X.device)
    if n_out == 0:
        return out
    r = MU.shape[0]
    tile = _build.fl_probe_tile(r)
    splits = _build.row_splits(n_out, X.shape[0])
    partial = (torch.empty((splits * r * n_out,), dtype=torch.float32,
                           device=X.device) if splits > 1 else None)
    lib = _build.load_library()
    with torch.cuda.device(X.device):
        rc = lib.fl_stream_launch(
            X.data_ptr(), X.shape[0], X.shape[1], Xc.data_ptr(), Xc.shape[0],
            _build.ptr(cand_idx), n_out, MU.data_ptr(), _build.ptr(resid), r,
            tile.ppt, tile.passes,
            splits, _build.ptr(partial), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on_error("fl_stream", rc)
    return out


def fl_stream_divergence_kernel(
    X: Tensor,          # (ni, d) float32 served rows
    MU: Tensor,         # (r, ni) float32 probe coverage rows
    resid: Tensor,      # (r,) float32; -INF marks a pad probe
    cand_idx: Tensor | None = None,  # (k,) int64 rows of Xc
    Xc: Tensor | None = None,        # (n, d) float32 candidate rows; None = X
) -> Tensor:
    """Divergence of every row of ``Xc`` (or of the rows ``cand_idx`` names)
    against the probes, over relu(X · Xcᵀ) in IEEE float32.  Returns (n,) or
    (k,) float32.  ``fl_stream_divergence_kernel.launches`` counts the
    kernel launches (CPU calls do not count)."""
    Xc = X if Xc is None else Xc
    _check("fl_stream_divergence", X, Xc, MU, resid, cand_idx)
    if X.device.type == "cpu":
        return fl_stream_divergence_ref(X, MU, resid, cand_idx, Xc)
    out = _launch(X, Xc, MU, resid, cand_idx)
    fl_stream_divergence_kernel.launches += 1
    return out


def fl_stream_gains_kernel(
    X: Tensor,          # (ni, d) served rows
    state: Tensor,      # (ni,) coverage m_i
    cand_idx: Tensor | None = None,
    Xc: Tensor | None = None,
) -> Tensor:
    """Greedy gains f(v|S) = sum_i max(sim[i, v] - m_i, 0): the single-probe
    instance (MU = the state, resid = 0).  Returns (n,) or (k,) float32;
    ``fl_stream_gains_kernel.launches`` counts its own launches."""
    Xc = X if Xc is None else Xc
    MU = state.float().reshape(1, -1).contiguous()
    _check("fl_stream_gains", X, Xc, MU, None, cand_idx)
    if X.device.type == "cpu":
        return fl_stream_divergence_ref(X, MU, torch.zeros((1,)), cand_idx, Xc)
    out = _launch(X, Xc, MU, None, cand_idx)
    fl_stream_gains_kernel.launches += 1
    return out


fl_stream_divergence_kernel.launches = 0
fl_stream_gains_kernel.launches = 0


# -- the plain matrix-free passes ---------------------------------------------


def _row_blocks(X: Tensor, Xc: Tensor):
    """(lo, hi, relu(X[lo:hi] · Xcᵀ)) over blocks of served rows, each block
    at most 256 MiB of float32."""
    bi = max(1, _ELEMS // max(1, Xc.shape[0]))
    for lo in range(0, X.shape[0], bi):
        hi = min(X.shape[0], lo + bi)
        yield lo, hi, sim_rows(X[lo:hi], Xc)


def fl_stream_col_max(X: Tensor, Xc: Tensor, mask: Tensor | None = None) -> Tensor:
    """max over the (masked) candidates v of sim[i, v], per served row i.
    (ni,).  NEG where no candidate is masked in (the dense add_many
    convention)."""
    if mask is not None:
        Xc = Xc[mask.to(device=Xc.device, dtype=torch.bool)]
    if Xc.shape[0] == 0:
        return torch.full((X.shape[0],), NEG, dtype=torch.float32, device=X.device)
    return torch.cat([blk.amax(dim=1) for _, _, blk in _row_blocks(X, Xc)])


def fl_stream_top2(X: Tensor, Xc: Tensor) -> Tensor:
    """Per-served-row top-2 of sim[i, :] over the candidates.  (ni, 2).  Two
    equal maxima give best == second; one candidate gives second = NEG."""
    return torch.cat([torch.stack(top2(blk), dim=1)
                      for _, _, blk in _row_blocks(X, Xc)])


def fl_stream_count_best(X: Tensor, Xc: Tensor, best: Tensor) -> Tensor:
    """Number of candidates with sim[i, v] >= best_i, per served row.  (ni,)
    int32: the tie count of the residual gains."""
    return torch.cat([(blk >= best[lo:hi, None]).sum(dim=1, dtype=torch.int32)
                      for lo, hi, blk in _row_blocks(X, Xc)])


def fl_stream_best_loss_sum(X: Tensor, Xc: Tensor, best: Tensor,
                            loss: Tensor) -> Tensor:
    """sum_i 1[sim[i, v] >= best_i] * loss_i per candidate v.  (n,)."""
    out = torch.zeros((Xc.shape[0],), dtype=torch.float32, device=X.device)
    for lo, hi, blk in _row_blocks(X, Xc):
        out += torch.where(blk >= best[lo:hi, None], loss[lo:hi, None], 0.0).sum(0)
    return out


def fl_stream_residuals(X: Tensor, Xc: Tensor | None = None) -> Tensor:
    """f(v | V \\ v) for every candidate, with the dense tie rule (a row whose
    best is reached by more than one candidate loses nothing when one of
    them leaves).  One pass: each block of served rows yields its top-2, tie
    counts and losses at once."""
    Xc = X if Xc is None else Xc
    return fl_residuals((blk for _, _, blk in _row_blocks(X, Xc)), Xc.shape[0],
                        X.device)
