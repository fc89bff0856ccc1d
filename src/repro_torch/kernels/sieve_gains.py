"""The gain table of sieve streaming.

    out[j, c] = sum_l h(S[j, l], E(c, l))

for sieve states S (R, L) against elements c: h = w_l phi(s + e) for
FeatureCoverage (an element a row of W), max(s, e) for facility location
(a column of sim, or of a chunk's similarity columns); the element index -1
is the zero element, whose entry is value(S_j).  The sieve's gain is the
reference's literal value(add(s, v)) - value(s), both terms from this table.
On a CUDA tensor the wrapper launches the hand-written kernels in
``csrc/sieve_gains.cu`` (no TPU kernel: the reference's ``lax.scan`` body,
``repro/core/sieve.py:_sieve_step``) by one of two routes, a pure rule of the
layout (:func:`sieve_route`): phi over rows of W (FeatureCoverage) the
sparse route, which walks W's nonzeros and reuses the zero tree's sums,
everything else the tile; on a CPU tensor it runs the plain
version, :func:`sieve_gains_ref`, which sums in the kernels' order.  Nothing
else: a failed build or launch raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sieve_gains_ref

Tensor = torch.Tensor

__all__ = ["SieveElements", "sieve_gains_kernel", "sieve_gains_ref", "sieve_route"]

#: Elements a block of the sparse route; its route flags are one int32 a
#: block.  Must match SP_BLOCK in csrc/sieve_gains.cu.
SIEVE_SPARSE_BLOCK = 16


class SieveElements(NamedTuple):
    """The element side of a sieve table: ``E`` with rows (``cols`` False,
    (n_e, L)) or columns (``cols`` True, (L, n_e)) as elements, ``idx`` the
    (n_cols,) int64 elements of the table (-1: the zero element), and the
    term: ``phi`` (FeatureCoverage, with ``feat_w`` and ``cap``) or None
    (facility location's max)."""

    E: Tensor
    idx: Tensor
    cols: bool
    phi: str | None = None
    feat_w: Tensor | None = None
    cap: Tensor | None = None

    def add(self, S: Tensor, pos: Tensor) -> Tensor:
        """add(S[j], the element at table column pos[j]) for each row j of
        the states ``S`` (R, L): S + e (FeatureCoverage) or max(S, e)
        (facility location)."""
        ix = self.idx.index_select(0, pos)
        e = self.E.index_select(1, ix).T if self.cols else self.E.index_select(0, ix)
        return torch.maximum(S, e) if self.phi is None else S + e


def _check(S: Tensor, el: SieveElements, start: Tensor | None) -> None:
    name = "sieve_gains"
    for arg, t in (("S", S), ("E", el.E)):
        if not isinstance(t, Tensor) or t.dim() != 2 or t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be a 2-D float32 tensor")
    if S.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {S.device}")
    L = S.shape[1]
    if (el.E.shape[0] if el.cols else el.E.shape[1]) != L:
        raise ValueError(f"{name}: E {tuple(el.E.shape)} does not match L = {L}")
    if el.phi is not None and el.phi not in _build.PHI_CODES:
        raise ValueError(f"{name}: unknown phi {el.phi!r}")
    if el.phi == "satcov" and el.cap is None:
        raise ValueError(f"{name}: phi='satcov' needs cap")
    _build.check_side(name, S, el.idx, E=el.E, feat_w=el.feat_w, cap=el.cap)
    for arg, t in (("feat_w", el.feat_w), ("cap", el.cap)):
        if t is not None and tuple(t.shape) != (L,):
            raise ValueError(f"{name}: {arg} must be ({L},), got {tuple(t.shape)}")
    if start is not None:
        _build.check_side(name, S, start)
        if tuple(start.shape) != (S.shape[0],):
            raise ValueError(f"{name}: start must be ({S.shape[0]},)")
    if S.shape[0] >= 2**31 or el.idx.shape[0] >= 2**31 or L >= 2**31 - 1:
        raise ValueError(f"{name}: too many sieves, elements or leaves")


def sieve_route(el: SieveElements) -> str:
    """The card's route for ``el``, a pure rule of its layout: "sparse"
    for phi over rows (FeatureCoverage's ``sieve_elements``), "tile" for
    anything else (facility location's max, or FeatureCoverage given
    columns).  A sparse launch runs its dense blocks through the tile."""
    return "sparse" if el.phi is not None and not el.cols else "tile"


def _launch(S: Tensor, el: SieveElements,
            start: Tensor | None) -> tuple[Tensor, Tensor | None]:
    """Launch the route's kernels on the card: the table, and on the sparse
    route each block's flag (int32, 1: its elements ran through the tile)."""
    R, L = S.shape
    n_cols = el.idx.shape[0]
    out = torch.empty((R, n_cols), dtype=torch.float32, device=S.device)
    sparse = sieve_route(el) == "sparse"
    if R == 0 or n_cols == 0:
        return out, None
    n_e, ld = ((el.E.shape[1], el.E.shape[1]) if el.cols
               else (el.E.shape[0], el.E.shape[1]))
    lib = _build.load_library()
    # the slabs' partial sums past one slab, and on the sparse route S
    # transposed, the zero tree and one int32 route flag a block, last
    scratch = torch.empty((lib.sieve_gains_scratch_floats(R, L, n_cols, int(sparse)),),
                          dtype=torch.float32, device=S.device)
    with torch.cuda.device(S.device):
        rc = lib.sieve_gains_launch(
            S.data_ptr(), R, L, el.E.data_ptr(), int(el.cols), ld, n_e,
            el.idx.data_ptr(), n_cols, _build.ptr(start), int(el.phi is None),
            _build.PHI_CODES.get(el.phi, 0), _build.ptr(el.feat_w),
            _build.ptr(el.cap), int(sparse), scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on_error("sieve_gains", rc)
    sieve_gains_kernel.launches += 1
    if sparse:
        sieve_gains_kernel.launches_sparse += 1
        blocks = -(-n_cols // SIEVE_SPARSE_BLOCK)
        return out, scratch[-blocks:].view(torch.int32)
    sieve_gains_kernel.launches_tile += 1
    return out, None


def sieve_gains_kernel(S: Tensor, el: SieveElements,
                       start: Tensor | None = None) -> Tensor:
    """The table of the states ``S`` (R, L) against ``el``'s elements:
    (R, n_cols) float32.  ``start`` (R,) int64, optional: on the card, the
    entries of row j before column start[j] are not computed (their values
    are unspecified; the zero element's column always is); the plain version
    computes them all.  A bad element index gives NaN on the card and an
    IndexError on the CPU.  ``sieve_gains_kernel.launches`` counts the
    launches, ``.launches_sparse`` and ``.launches_tile`` those of each
    route (CPU calls do not count)."""
    _check(S, el, start)
    if S.device.type == "cpu":
        return sieve_gains_ref(S, el.E, el.idx, cols=el.cols, phi=el.phi,
                               feat_w=el.feat_w, cap=el.cap)
    return _launch(S, el, start)[0]


sieve_gains_kernel.launches = 0
sieve_gains_kernel.launches_sparse = 0
sieve_gains_kernel.launches_tile = 0
