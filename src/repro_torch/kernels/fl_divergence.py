"""The SS hot spot of dense facility location, and its greedy instance.

    w_v = min_{u in U} [ sum_i max(sim[i, v] - MU[u, i], 0) - resid[u] ]

for every candidate column v of ``sim`` in one pass; with one probe (MU =
the greedy state, resid = 0) it is the greedy gain f(v|S).  On a CUDA tensor
the wrappers launch the hand-written kernel in ``csrc/fl_divergence.cu``
(counterpart of the Pallas ``repro/kernels/fl_divergence.py:
fl_divergence_kernel`` and ``fl_gains_kernel``); on a CPU tensor they run the
plain version, :func:`fl_divergence_ref`.  Nothing else: a failed build or
launch raises.

Greedy over a small candidate buffer reads the same columns of ``sim`` in
every step.  Gathered in place, each column element costs the kernel a
32-byte sector of its own; :func:`fl_gains_panel` copies them once into a
contiguous panel (as the JAX wrapper's ``jnp.take`` does on every call), and
the steps read that with 16-byte vectors.  :func:`takes_panel` decides.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fl_divergence_ref

Tensor = torch.Tensor

__all__ = ["GainsPanel", "fl_divergence_kernel", "fl_divergence_ref",
           "fl_gains_kernel", "fl_gains_panel", "takes_panel"]

#: A panel of k columns is taken when it is at most 1/PANEL_SHARE of sim.
PANEL_SHARE = 8


def _check(name: str, sim: Tensor, MU: Tensor, resid: Tensor | None,
           cand_idx: Tensor | None) -> None:
    if not isinstance(sim, Tensor) or sim.dim() != 2:
        raise ValueError(f"{name}: sim must be a 2-D tensor")
    if sim.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: sim must be float32 or bfloat16, got {sim.dtype}")
    if sim.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {sim.device}")
    _build.check_side(name, sim, cand_idx, MU=MU, resid=resid)
    _build.check_probes(name, MU, resid, sim.shape[0])


def _launch(sim: Tensor, MU: Tensor, resid: Tensor | None,
            cand_idx: Tensor | None) -> Tensor:
    ni, n = sim.shape
    n_out = n if cand_idx is None else cand_idx.shape[0]
    out = torch.empty((n_out,), dtype=torch.float32, device=sim.device)
    if n_out == 0:
        return out
    r = MU.shape[0]
    tile = _build.fl_probe_tile(r)
    splits = _build.row_splits(n_out, ni)
    partial = (torch.empty((splits * r * n_out,), dtype=torch.float32,
                           device=sim.device) if splits > 1 else None)
    lib = _build.load_library()
    with torch.cuda.device(sim.device):
        rc = lib.fl_divergence_launch(
            sim.data_ptr(), int(sim.dtype == torch.bfloat16), ni, n,
            _build.ptr(cand_idx), n_out, MU.data_ptr(), _build.ptr(resid), r,
            tile.ppt, tile.passes,
            splits, _build.ptr(partial), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on_error("fl_divergence", rc)
    return out


def fl_divergence_kernel(
    sim: Tensor,        # (ni, n) float32 or bfloat16; sim[i, v] = service of i by v
    MU: Tensor,         # (r, ni) float32 probe coverage rows max(state, sim[:, u])
    resid: Tensor,      # (r,) float32; -INF marks a pad probe
    cand_idx: Tensor | None = None,  # (k,) int64 columns of sim
) -> Tensor:
    """Divergence of every column of ``sim`` (or of the columns ``cand_idx``
    names) against the probes.  Returns (n,) or (k,) float32.

    ``sim`` need not be symmetric: candidates are its columns, the sum runs
    down its rows.  ``fl_divergence_kernel.launches`` counts the kernel
    launches (CPU calls do not count).  A ``cand_idx`` entry outside sim
    gives NaN on the card and an IndexError on the CPU.
    """
    _check("fl_divergence", sim, MU, resid, cand_idx)
    if sim.device.type == "cpu":
        return fl_divergence_ref(sim, MU, resid, cand_idx)
    out = _launch(sim, MU, resid, cand_idx)
    fl_divergence_kernel.launches += 1
    return out


def fl_gains_kernel(
    sim: Tensor,        # (ni, n)
    state: Tensor,      # (ni,) coverage m_i = max(0, max_{s in S} sim[i, s])
    cand_idx: Tensor | None = None,
) -> Tensor:
    """Greedy gains f(v|S) = sum_i max(sim[i, v] - m_i, 0) for every column
    (or for ``cand_idx``): the single-probe instance of the divergence, with
    MU = the state and resid = 0.  Returns (n,) or (k,) float32.

    ``fl_gains_kernel.launches`` counts its own launches.
    """
    MU = state.float().reshape(1, -1).contiguous()
    _check("fl_gains", sim, MU, None, cand_idx)
    if sim.device.type == "cpu":
        return fl_divergence_ref(sim, MU, torch.zeros((1,)), cand_idx)
    out = _launch(sim, MU, None, cand_idx)
    fl_gains_kernel.launches += 1
    return out


def takes_panel(k: int, n: int) -> bool:
    """Whether greedy over k gathered columns of an (ni, n) sim copies them
    into a panel first: a pure rule of shapes, true when the panel is at
    most 1/PANEL_SHARE of sim (path A: 1024 of 65536 columns, 268 MB; not a
    near-full SS bucket of 23296, which would be 6.1 GB)."""
    return 0 < k and PANEL_SHARE * k <= n


class GainsPanel(NamedTuple):
    """sim[:, cand_idx] as one contiguous (ni, k) tensor in sim's dtype:
    what greedy's steps read in place of the gathered columns."""

    cols: Tensor


def fl_gains_panel(sim: Tensor, cand_idx: Tensor) -> GainsPanel:
    """Gather the columns ``cand_idx`` of ``sim`` once, for the greedy steps
    (``fl_gains_kernel(panel.cols, state)`` then equals
    ``fl_gains_kernel(sim, state, cand_idx)`` bitwise: the kernel walks the
    same rows in the same order).  ``fl_gains_panel.gathers`` counts the
    gathers, on any device."""
    fl_gains_panel.gathers += 1
    return GainsPanel(sim.index_select(1, cand_idx))


fl_divergence_kernel.launches = 0
fl_gains_kernel.launches = 0
fl_gains_panel.gathers = 0
