"""Submodular objectives with batched marginal-gain APIs, in PyTorch.

The counterpart of ``repro/core/functions.py`` for the objectives the port
runs so far: the :class:`SubmodularFunction` protocol, :class:`FeatureCoverage`,

    f(S) = sum_f w_f * phi(c_f(S)),   c_f(S) = sum_{v in S} W[v, f],

and facility location, dense (:class:`FacilityLocation`, over an (n, n)
similarity) and matrix-free (:class:`StreamingFacilityLocation`, over (n, d)
embedding rows),

    f(S) = sum_i max(0, max_{s in S} sim[i, s]).

Objectives are frozen dataclasses that hold tensors.  A *state* summarizes
the current solution set S (the coverage vector c, or the per-row best
coverage m), so the gains f(v|S) of all candidates come from one dense
operation.

Two kernel hooks, ``cuda_divergence`` and ``cuda_gains``, carry the SS round
and the greedy step to the CUDA kernels (:mod:`repro_torch.core.backend`,
``CudaBackend``).  The base class has no kernel: its hooks raise, and the
backend does not fall back to the plain path.  A third, ``cuda_prepare``,
lays a greedy run's candidate buffer out for ``cuda_gains`` once, before the
first step; by default it keeps the buffer as it is.
"""

from __future__ import annotations

import abc
import dataclasses

import torch

from repro_torch.kernels.feature_gains import feature_gains_kernel
from repro_torch.kernels.fl_divergence import (
    GainsPanel,
    fl_divergence_kernel,
    fl_gains_kernel,
    fl_gains_panel,
    takes_panel,
)
from repro_torch.kernels.fl_stream import (
    fl_stream_col_max,
    fl_stream_divergence_kernel,
    fl_stream_gains_kernel,
    fl_stream_residuals,
)
from repro_torch.kernels.ref import (
    _ELEMS,
    _ROW_CHUNK,
    _phi,
    fl_pair_ref,
    fl_residuals,
    fl_stream_pair_ref,
    matmul_ieee,
    sim_rows,
)
from repro_torch.kernels.ss_weights import ss_divergence_kernel

Tensor = torch.Tensor

# Large-but-finite negative used to mask dead candidates in argmax / min.
NEG = -1e30

__all__ = ["NEG", "SubmodularFunction", "FeatureCoverage", "FacilityLocation",
           "StreamingFacilityLocation", "_phi"]


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
        """Fused greedy gains f(v|S) for all v, or for v = cand_idx (or what
        :meth:`cuda_prepare` made of it)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no CUDA gains kernel"
        )

    def cuda_prepare(self, cand_idx: Tensor):
        """What :meth:`cuda_gains` reads in place of the candidate buffer
        ``cand_idx`` over a greedy run, made once: the buffer itself."""
        return cand_idx


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


@dataclasses.dataclass(frozen=True)
class FacilityLocation(SubmodularFunction):
    """Facility location: f(S) = sum_i max(0, max_{s in S} sim[i, s]).

    ``sim`` is the (n, n) similarity, float32 or bfloat16; sim[i, v] is how
    well v serves row i.  It need not be symmetric: candidates are columns,
    served rows are rows.  Negative entries are clipped by the implicit
    "serve yourself at 0" baseline, which also makes f(∅) = 0.  The state is
    the per-row best coverage m_i = max(0, max_{s in S} sim[i, s]).

    The plain primitives walk ``sim`` in blocks of at most 256 MiB, so none
    of them builds the (r, n, n) hinge block or a second (n, n) matrix.
    """

    sim: Tensor  # (n, n)

    #: from_features refuses to build (n, n) above this many rows unless
    #: told to: 16k rows is already a 1 GiB float32 similarity.
    N_THRESHOLD = 16384

    @classmethod
    def from_features(
        cls,
        X: Tensor,
        kernel: str = "dot",
        *,
        n_threshold: int | None = N_THRESHOLD,
    ) -> "FacilityLocation":
        """The similarity of the rows of ``X`` (n, d) under ``kernel`` (dot,
        rbf or cosine), computed on X's device in IEEE float32."""
        n = X.shape[0]
        if n_threshold is not None and n > n_threshold:
            raise ValueError(
                f"FacilityLocation.from_features would materialize an "
                f"(n, n) = ({n}, {n}) similarity matrix "
                f"({4 * n * n / 2**30:.1f} GiB of f32). For kernel="
                f"'dot'/'cosine' use the matrix-free equivalent instead:\n"
                f"    StreamingFacilityLocation.from_features(X, "
                f"kernel={kernel!r})\n"
                f"which stores only the (n, d) embeddings and computes "
                f"similarity tiles on the fly. Pass n_threshold=None to "
                f"force the dense construction anyway."
            )
        X = X.float()
        if kernel == "dot":
            sim = matmul_ieee(X, X.T).clamp_min_(0.0)
        elif kernel == "rbf":
            sq = (X * X).sum(dim=1)
            d2 = sq[:, None] - matmul_ieee(2.0 * X, X.T) + sq[None, :]
            sim = torch.exp(-d2 / torch.clamp_min(d2.mean(), 1e-9))
        elif kernel == "cosine":
            Xn = _normalize(X)
            sim = matmul_ieee(Xn, Xn.T).clamp_min_(0.0)
        else:
            raise ValueError(kernel)
        return cls(sim=sim)

    @property
    def n(self) -> int:
        return self.sim.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sim.device

    def empty_state(self) -> Tensor:
        return torch.zeros((self.sim.shape[0],), dtype=self.sim.dtype,
                           device=self.sim.device)

    def value(self, state: Tensor) -> Tensor:
        return state.sum()

    def _row_blocks(self):
        bi = max(1, _ELEMS // max(1, self.sim.shape[1]))
        return (self.sim[lo:lo + bi] for lo in range(0, self.sim.shape[0], bi))

    def _probe_mu(self, probes: Tensor, state: Tensor | None) -> Tensor:
        """Probe coverage rows mu_u = max(state, sim[:, u]).  (r, n)."""
        base = self.empty_state() if state is None else state
        return torch.maximum(base[None, :], self.sim[:, probes].T)

    def gains(self, state: Tensor) -> Tensor:
        """f(v|S) = sum_i max(sim[i, v] - m_i, 0) for all v.  (n,)."""
        return fl_pair_ref(self.sim, state[None, :])[0]

    def gains_compact(self, state: Tensor, cand_idx: Tensor) -> Tensor:
        """The gains of the gathered candidate columns only; the served-row
        sum still spans all n rows (that is f's definition)."""
        return fl_pair_ref(self.sim, state[None, :], cand_idx)[0]

    def add(self, state: Tensor, v: Tensor) -> Tensor:
        return torch.maximum(state, self.sim[:, v])

    def add_many(self, state: Tensor, mask: Tensor) -> Tensor:
        mask = mask.to(device=self.sim.device, dtype=torch.bool)
        if not bool(mask.any()):
            return state
        best = torch.cat([blk[:, mask].amax(dim=1) for blk in self._row_blocks()])
        return torch.maximum(state, best.to(state.dtype))

    def pairwise_gains(self, probes: Tensor, state: Tensor | None = None) -> Tensor:
        """f(v | S + u) = sum_i max(sim[i, v] - mu[u, i], 0).  (r, n)."""
        return fl_pair_ref(self.sim, self._probe_mu(probes, state))

    def pairwise_gains_compact(
        self, probes: Tensor, cand_idx: Tensor, state: Tensor | None = None
    ) -> Tensor:
        """The (r, k) block over the gathered candidate columns."""
        return fl_pair_ref(self.sim, self._probe_mu(probes, state), cand_idx)

    def residual_gains(self) -> Tensor:
        """f(V) - f(V \\ v) for all v, with the top-2 tie rule."""
        return fl_residuals(self._row_blocks(), self.sim.shape[1], self.sim.device)

    # -- kernel hooks ------------------------------------------------------
    def cuda_divergence(
        self,
        probes: Tensor,
        residual: Tensor,
        state: Tensor | None = None,
        cand_idx: Tensor | None = None,
    ) -> Tensor:
        MU = self._probe_mu(probes, state).float().contiguous()
        return fl_divergence_kernel(
            self.sim, MU, residual[probes].float().contiguous(), cand_idx
        )

    def cuda_prepare(self, cand_idx: Tensor) -> "Tensor | GainsPanel":
        """sim's candidate columns copied once into a contiguous panel when
        :func:`takes_panel` says so (the kernel then reads them with 16-byte
        vectors, not a sector per element), else ``cand_idx``."""
        if not takes_panel(cand_idx.shape[0], self.sim.shape[1]):
            return cand_idx
        return fl_gains_panel(self.sim, cand_idx)

    def cuda_gains(
        self, state: Tensor, cand_idx: "Tensor | GainsPanel | None" = None
    ) -> Tensor:
        if isinstance(cand_idx, GainsPanel):
            return fl_gains_kernel(cand_idx.cols, state)
        return fl_gains_kernel(self.sim, state, cand_idx)


@dataclasses.dataclass(frozen=True)
class StreamingFacilityLocation(SubmodularFunction):
    """Matrix-free facility location over embedding rows.

    The objective of :class:`FacilityLocation` with the dot kernel,
    sim[i, v] = max(x_i . x_v, 0), but only the (n, d) rows are stored:
    every pass computes similarity blocks (plain path) or tiles (the CUDA
    kernel) on the fly, so the (n, n) matrix never exists.  Cosine is dot
    after one row normalization at construction.

    ``X`` holds the *candidate* rows.  ``Xs`` (None for the global objective,
    where served == candidates) holds the *served* rows, so that compacted
    and sharded views can restrict the candidates and still serve the whole
    ground set.  The state is the served-row coverage m, as in the dense
    objective.
    """

    X: Tensor                  # (n, d) candidate embedding rows, float32
    Xs: Tensor | None = None   # (ni, d) served rows; None = X

    @classmethod
    def from_features(
        cls, X: Tensor, kernel: str = "dot"
    ) -> "StreamingFacilityLocation":
        X = X.float()
        if kernel == "cosine":
            X = _normalize(X)
        elif kernel != "dot":
            raise ValueError(
                f"StreamingFacilityLocation supports kernel='dot'/'cosine' "
                f"(similarities factor through the embedding rows); "
                f"got {kernel!r}"
            )
        return cls(X=X.contiguous())

    def _served(self) -> Tensor:
        return self.X if self.Xs is None else self.Xs

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def device(self) -> torch.device:
        return self.X.device

    def empty_state(self) -> Tensor:
        return torch.zeros((self._served().shape[0],), dtype=torch.float32,
                           device=self.X.device)

    def value(self, state: Tensor) -> Tensor:
        return state.sum()

    def _probe_mu(self, probes: Tensor, state: Tensor | None) -> Tensor:
        """Probe coverage rows mu_u = max(state, relu(Xs · x_u)).  (r, ni):
        an (r, d) gather and a thin product, nothing O(n^2)."""
        base = self.empty_state() if state is None else state
        return torch.maximum(base[None, :], sim_rows(self._served(), self.X[probes]).T)

    def gains(self, state: Tensor) -> Tensor:
        return fl_stream_pair_ref(self._served(), state.float()[None, :],
                                  Xc=self.X)[0]

    def gains_compact(self, state: Tensor, cand_idx: Tensor) -> Tensor:
        return fl_stream_pair_ref(self._served(), state.float()[None, :],
                                  cand_idx, Xc=self.X)[0]

    def add(self, state: Tensor, v: Tensor) -> Tensor:
        return torch.maximum(state, sim_rows(self._served(), self.X[v][None])[:, 0])

    def add_many(self, state: Tensor, mask: Tensor) -> Tensor:
        return torch.maximum(state, fl_stream_col_max(self._served(), self.X, mask))

    def pairwise_gains(self, probes: Tensor, state: Tensor | None = None) -> Tensor:
        return fl_stream_pair_ref(self._served(), self._probe_mu(probes, state),
                                  Xc=self.X)

    def pairwise_gains_compact(
        self, probes: Tensor, cand_idx: Tensor, state: Tensor | None = None
    ) -> Tensor:
        """``cand_idx`` gathers candidate rows (k, d); the served-row sum
        still spans all rows."""
        return fl_stream_pair_ref(self._served(), self._probe_mu(probes, state),
                                  cand_idx, Xc=self.X)

    def residual_gains(self) -> Tensor:
        return fl_stream_residuals(self._served(), self.X)

    # -- kernel hooks ------------------------------------------------------
    def cuda_divergence(
        self,
        probes: Tensor,
        residual: Tensor,
        state: Tensor | None = None,
        cand_idx: Tensor | None = None,
    ) -> Tensor:
        MU = self._probe_mu(probes, state).contiguous()
        return fl_stream_divergence_kernel(
            self._served(), MU, residual[probes].float().contiguous(), cand_idx,
            self.X,
        )

    def cuda_gains(self, state: Tensor, cand_idx: Tensor | None = None) -> Tensor:
        return fl_stream_gains_kernel(self._served(), state, cand_idx, self.X)


def _normalize(X: Tensor) -> Tensor:
    """Rows of X scaled to unit norm (rows of norm below 1e-9 by 1e-9)."""
    return X / torch.clamp_min(torch.linalg.vector_norm(X, dim=1, keepdim=True), 1e-9)


def _by_rows(W: Tensor, row_fn) -> Tensor:
    """``row_fn`` over row chunks of ``W``, concatenated: the plain
    full-width paths never hold a whole (n, F) temporary (4 GiB per
    temporary at n = 2^20, F = 1024 in float32)."""
    if W.shape[0] <= _ROW_CHUNK:
        return row_fn(W)
    return torch.cat([row_fn(chunk) for chunk in W.split(_ROW_CHUNK)])


def _f32(t: Tensor | None) -> Tensor | None:
    return None if t is None else t.float().contiguous()
