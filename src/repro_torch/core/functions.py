"""Submodular objectives with batched marginal-gain APIs, in PyTorch.

The counterpart of ``repro/core/functions.py`` for the slice of the port
that the paper's main path needs: the :class:`SubmodularFunction` protocol
and :class:`FeatureCoverage`,

    f(S) = sum_f w_f * phi(c_f(S)),   c_f(S) = sum_{v in S} W[v, f].

Objectives are frozen dataclasses that hold tensors.  A *state* summarizes
the current solution set S (for FeatureCoverage, the coverage vector c), so
the gains f(v|S) of all candidates come from one dense operation.

Two kernel hooks, ``cuda_divergence`` and ``cuda_gains``, carry the SS round
and the greedy step to the CUDA kernels (:mod:`repro_torch.core.backend`,
``CudaBackend``).  The base class has no kernel: its hooks raise, and the
backend does not fall back to the plain path.
"""

from __future__ import annotations

import abc
import dataclasses

import torch

from repro_torch.kernels.feature_gains import feature_gains_kernel
from repro_torch.kernels.ref import _ROW_CHUNK, _phi
from repro_torch.kernels.ss_weights import ss_divergence_kernel

Tensor = torch.Tensor

# Large-but-finite negative used to mask dead candidates in argmax / min.
NEG = -1e30

__all__ = ["NEG", "SubmodularFunction", "FeatureCoverage", "_phi"]


class SubmodularFunction(abc.ABC):
    """Monotone submodular objective over n ground elements."""

    @property
    @abc.abstractmethod
    def n(self) -> int:
        """Ground-set size."""

    @property
    @abc.abstractmethod
    def device(self) -> torch.device:
        """Device the objective's tensors live on."""

    @abc.abstractmethod
    def empty_state(self) -> Tensor:
        """Summary state for S = ∅."""

    @abc.abstractmethod
    def value(self, state: Tensor) -> Tensor:
        """f(S) from the summary state."""

    @abc.abstractmethod
    def gains(self, state: Tensor) -> Tensor:
        """f(v|S) for all v.  Shape (n,)."""

    @abc.abstractmethod
    def add(self, state: Tensor, v: Tensor) -> Tensor:
        """State for S + v."""

    @abc.abstractmethod
    def add_many(self, state: Tensor, mask: Tensor) -> Tensor:
        """State for S + {v : mask[v]}."""

    @abc.abstractmethod
    def pairwise_gains(self, probes: Tensor, state: Tensor | None = None) -> Tensor:
        """f(v | S + u) for u in probes (r,), all v.  Shape (r, n)."""

    @abc.abstractmethod
    def residual_gains(self) -> Tensor:
        """f(v | V \\ v) for all v.  Shape (n,)."""

    def singleton_gains(self) -> Tensor:
        """f(v) for all v ( = gains on the empty state)."""
        return self.gains(self.empty_state())

    def pairwise_gains_compact(
        self, probes: Tensor, cand_idx: Tensor, state: Tensor | None = None
    ) -> Tensor:
        """f(v | S + u) for u in probes (r,) and v = cand_idx (k,).  (r, k)."""
        return self.pairwise_gains(probes, state)[:, cand_idx]

    def gains_compact(self, state: Tensor, cand_idx: Tensor) -> Tensor:
        """f(v|S) for v = cand_idx (k,).  Shape (k,)."""
        return self.gains(state)[cand_idx]

    # -- kernel hooks ------------------------------------------------------
    def cuda_divergence(
        self,
        probes: Tensor,
        residual: Tensor,
        state: Tensor | None = None,
        cand_idx: Tensor | None = None,
    ) -> Tensor:
        """Fused divergence w_{U,v} for all v, or for v = cand_idx."""
        raise NotImplementedError(
            f"{type(self).__name__} has no CUDA divergence kernel"
        )

    def cuda_gains(self, state: Tensor, cand_idx: Tensor | None = None) -> Tensor:
        """Fused greedy gains f(v|S) for all v, or for v = cand_idx."""
        raise NotImplementedError(
            f"{type(self).__name__} has no CUDA gains kernel"
        )


@dataclasses.dataclass(frozen=True)
class FeatureCoverage(SubmodularFunction):
    """Feature-based concave-over-modular coverage function (paper §4).

    ``W`` is the (n, F) nonnegative affinity matrix (e.g. TF-IDF), float32 or
    bfloat16.  ``feat_w`` optionally weights features.  ``phi`` is one of
    {"sqrt", "log1p", "setcover", "satcov", "linear"}; satcov saturates at
    ``alpha`` times the feature's total.  The state is the coverage vector c.
    """

    W: Tensor
    feat_w: Tensor | None = None
    phi: str = "sqrt"
    alpha: float = 0.2

    @property
    def n(self) -> int:
        return self.W.shape[0]

    @property
    def device(self) -> torch.device:
        return self.W.device

    def _cap(self) -> Tensor | None:
        if self.phi != "satcov":
            return None
        return self.alpha * self.W.sum(dim=0)

    def _wsum(self, x: Tensor) -> Tensor:
        """Weighted sum over the trailing feature axis."""
        if self.feat_w is not None:
            x = x * self.feat_w
        return x.sum(dim=-1)

    def empty_state(self) -> Tensor:
        return torch.zeros((self.W.shape[1],), dtype=self.W.dtype,
                           device=self.W.device)

    def value(self, state: Tensor) -> Tensor:
        return self._wsum(_phi(self.phi, state, self._cap()))

    def gains(self, state: Tensor) -> Tensor:
        """f(v|S) for all v: sum_f [phi(c + W_v) - phi(c)].  Shape (n,)."""
        return self._gains_rows(state, self.W)

    def gains_compact(self, state: Tensor, cand_idx: Tensor) -> Tensor:
        """The gains of the gathered candidate rows only: the same
        arithmetic per element as :meth:`gains`."""
        return self._gains_rows(state, self.W[cand_idx])

    def _gains_rows(self, state: Tensor, rows: Tensor) -> Tensor:
        cap = self._cap()
        phi_c = _phi(self.phi, state[None, :], cap)
        return _by_rows(
            rows, lambda W: self._wsum(_phi(self.phi, state[None, :] + W, cap) - phi_c)
        )

    def add(self, state: Tensor, v: Tensor) -> Tensor:
        return state + self.W[v]

    def add_many(self, state: Tensor, mask: Tensor) -> Tensor:
        return state + mask.to(self.W.dtype) @ self.W

    def pairwise_gains(self, probes: Tensor, state: Tensor | None = None) -> Tensor:
        """f(v | S + u) for u in probes (r,), all v.  Shape (r, n).

        The (r, n, F) block of the plain path; the CUDA kernel fuses it with
        the min over probes (:meth:`cuda_divergence`).
        """
        cand = torch.arange(self.n, device=self.W.device)
        return self._pairwise_rows(probes, self.W, cand, state)

    def pairwise_gains_compact(
        self, probes: Tensor, cand_idx: Tensor, state: Tensor | None = None
    ) -> Tensor:
        """The (r, k) block over the gathered candidates: the same arithmetic
        per element as :meth:`pairwise_gains`."""
        return self._pairwise_rows(probes, self.W[cand_idx], cand_idx, state)

    def _pairwise_rows(
        self, probes: Tensor, rows: Tensor, cand: Tensor, state: Tensor | None
    ) -> Tensor:
        base = self.empty_state() if state is None else state
        cap = self._cap()
        cu = base[None, :] + self.W[probes]                      # (r, F)
        phi_cu = self._wsum(_phi(self.phi, cu, cap))             # (r,)
        both = cu[:, None, :] + rows[None, :, :]                 # (r, k, F)
        out = self._wsum(_phi(self.phi, both, cap)) - phi_cu[:, None]
        # Set semantics: f(u | S + u) = 0 (the coverage state is a sum, so
        # v == probe would otherwise count W[u] twice).
        return torch.where(probes[:, None] == cand[None, :], 0.0, out)

    def residual_gains(self) -> Tensor:
        """f(v | V \\ v) = sum_f [phi(C) - phi(C - W_v)] for all v.  (n,)."""
        cap = self._cap()
        C = self.W.sum(dim=0)                                    # (F,)
        phi_C = _phi(self.phi, C[None, :], cap)
        return _by_rows(
            self.W, lambda W: self._wsum(phi_C - _phi(self.phi, C[None, :] - W, cap))
        )

    # -- kernel hooks ------------------------------------------------------
    def cuda_divergence(
        self,
        probes: Tensor,
        residual: Tensor,
        state: Tensor | None = None,
        cand_idx: Tensor | None = None,
    ) -> Tensor:
        base = self.empty_state() if state is None else state
        cap = self._cap()
        CU = (base[None, :] + self.W[probes]).float().contiguous()  # (r, F)
        # The kernel carries feat_w through the phi reduction, so the probe
        # baseline is the same weighted sum.
        phi_cu = self._wsum(_phi(self.phi, CU, cap)).contiguous()
        return ss_divergence_kernel(
            self.W, CU, phi_cu, residual[probes].float().contiguous(),
            _f32(cap), _f32(self.feat_w), cand_idx, phi=self.phi,
        )

    def cuda_gains(self, state: Tensor, cand_idx: Tensor | None = None) -> Tensor:
        cap = self._cap()
        c = state.float().contiguous()
        phi_c = self._wsum(_phi(self.phi, c, cap))
        return feature_gains_kernel(
            self.W, c, phi_c, _f32(cap), _f32(self.feat_w), cand_idx,
            phi=self.phi,
        )


def _by_rows(W: Tensor, row_fn) -> Tensor:
    """``row_fn`` over row chunks of ``W``, concatenated: the plain
    full-width paths never hold a whole (n, F) temporary (4 GiB per
    temporary at n = 2^20, F = 1024 in float32)."""
    if W.shape[0] <= _ROW_CHUNK:
        return row_fn(W)
    return torch.cat([row_fn(chunk) for chunk in W.split(_ROW_CHUNK)])


def _f32(t: Tensor | None) -> Tensor | None:
    return None if t is None else t.float().contiguous()
