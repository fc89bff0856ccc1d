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

A *stacked* objective runs B same-shape queries at once (the batched SS and
greedy of :mod:`repro_torch.core.sparsify` / ``greedy``): the same class with
a leading B axis on every tensor, as in the JAX package.  Only ``batch`` and
:meth:`SubmodularFunction.row` are valid on it (``n`` and the others read
the wrong axis); ``row(b)`` is query b as a plain objective made of views,
and the backends' batched primitives map the single-query hooks over the
rows (:mod:`repro_torch.core.backend`).

Two kernel hooks, ``cuda_divergence`` and ``cuda_gains``, carry the SS round
and the greedy step to the CUDA kernels (:mod:`repro_torch.core.backend`,
``CudaBackend``).  The base class has no kernel: its hooks raise, and the
backend does not fall back to the plain path.  A third, ``cuda_prepare``,
lays a greedy run's candidate buffer out for ``cuda_gains`` once, before the
first step; by default it keeps the buffer as it is.  Sieve streaming reads
its gain table's elements through ``sieve_elements`` (and the chunk size
that bounds, ``sieve_chunk``).

The shard hooks (``shard`` and the ``shard_*`` methods) describe a per-rank
*view* of an objective for the sharded loops of
:mod:`repro_torch.core.distributed`: ``fn.shard(mesh, axes)`` keeps this
rank's block of candidates (FeatureCoverage: rows of W; FacilityLocation:
columns of sim, every served row; StreamingFacilityLocation: rows of X,
with every served row in ``Xs``), and the hooks evaluate residuals,
probe-conditioned divergences and greedy gains for the view's candidates
only.  Pod-global quantities come from ``shard_init``'s context, never from
the view's own tensors.  Two of them reach the kernels: ``shard_divergence``
and ``shard_gains`` are the plain versions, ``cuda_shard_divergence`` and
``cuda_shard_gains`` launch the objective's divergence and gains kernels
on the view, with the probes' payloads as the kernel's probe rows.
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
    fl_stream_best_loss_sum,
    fl_stream_col_max,
    fl_stream_count_best,
    fl_stream_divergence_kernel,
    fl_stream_gains_kernel,
    fl_stream_residuals,
    fl_stream_top2,
)
from repro_torch.kernels.ref import (
    _ELEMS,
    _ROW_CHUNK,
    _phi,
    fl_divergence_ref,
    fl_pair_ref,
    fl_residuals,
    fl_stream_divergence_ref,
    fl_stream_pair_ref,
    matmul_ieee,
    sim_rows,
    ss_divergence_ref,
    top2,
)
from repro_torch.kernels.sieve_gains import SieveElements
from repro_torch.kernels.ss_weights import ss_divergence_kernel

Tensor = torch.Tensor

# Large-but-finite negative used to mask dead candidates in argmax / min.
NEG = -1e30
# Matrix-free facility location's sieve table: a chunk's similarity columns
# stay under SIEVE_COLUMN_ELEMS float32 entries (1 GiB) and are computed in
# blocks of exactly SIEVE_BLOCK columns.
SIEVE_COLUMN_ELEMS = 1 << 28
SIEVE_BLOCK = 128

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
        """State for S + v; ``v`` a 0-d int64 tensor on the objective's
        device, read with ``index_select`` (indexing by it would read it
        back to the host)."""

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

    # -- stacked objectives ------------------------------------------------
    @property
    def batch(self) -> int:
        """B, the number of rows of a stacked objective."""
        return next(t for t in self._tensors().values() if t is not None).shape[0]

    def _tensors(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), (Tensor, type(None)))}

    def row(self, b: int) -> "SubmodularFunction":
        """Row b of a stacked objective as a plain objective: each tensor
        is a view, ``t[b]``, so a row of a contiguous stack is contiguous."""
        return dataclasses.replace(self, **{
            k: None if t is None else t[b] for k, t in self._tensors().items()})

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

    def sieve_elements(self, vals: Tensor) -> SieveElements:
        """The element side of sieve streaming's gain table
        (``kernels/sieve_gains.py``) for the stream values ``vals`` (c,):
        the c elements, then the zero element (index -1), whose entry is
        value(S)."""
        raise NotImplementedError(f"{type(self).__name__} has no sieve table")

    def sieve_chunk(self) -> int | None:
        """The most stream elements one :meth:`sieve_elements` takes (None:
        no limit of the objective's own)."""
        return None

    # -- shard hooks ---------------------------------------------------------
    # A view, ``fn.shard(mesh, axes)``, holds one rank's block of the
    # candidates; the hooks below run on it.  ``comm`` is the loop's
    # collectives over the mesh axes (``repro_torch.core.distributed``);
    # ``ctx`` is what ``shard_init`` returned.

    #: each pod may run as a ground set of its own (the view's tensors are
    #: row-local)
    supports_pod_sharding = False
    #: the divergence hooks take ``cand_idx`` (the sharded SS compaction)
    supports_shard_compact = False
    #: the view runs the sharded selection loop (``shard_gains``,
    #: ``shard_take``, ``shard_add`` over a replicated state)
    supports_shard_greedy = False

    def shard(self, mesh, axes: tuple[str, ...]) -> "SubmodularFunction":
        """This rank's view: its contiguous block of the n candidates, in
        the mesh's (outer, ..., inner) order of ``axes``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the sharded protocol")

    def local_n(self) -> int:
        """The number of candidates the view holds."""
        raise NotImplementedError

    def shard_init(self, comm):
        """The pod-global context, once a run: collectives over ``comm``."""
        raise NotImplementedError

    def shard_residuals(self, ctx) -> Tensor:
        """f(u | V \\ u) of the view's candidates.  (n_loc,)."""
        raise NotImplementedError

    def shard_payloads(self, idx: Tensor, state: Tensor | None = None) -> Tensor:
        """The payload rows of the view's candidates ``idx`` (k,): what any
        rank needs to evaluate f(v | S + u) against them.  (k, D) float32."""
        raise NotImplementedError

    def shard_payload_gains(self, payloads: Tensor, ctx) -> Tensor:
        """f(v | S + u) for the probes' ``payloads`` (m, D) and the view's
        candidates v.  (m, n_loc)."""
        raise NotImplementedError

    def shard_divergence(self, payloads: Tensor, resid_p: Tensor, ctx,
                         cand_idx: Tensor | None = None) -> Tensor:
        """min over the probes of f(v | S + u) - resid_p[u] for the view's
        candidates (or for ``cand_idx``).  (n_loc,) or (k,).  The plain
        version; :meth:`cuda_shard_divergence` is the kernel."""
        view = self if cand_idx is None else self.shard_take(cand_idx)
        return (view.shard_payload_gains(payloads, ctx)
                - resid_p[:, None]).amin(dim=0)

    def cuda_shard_divergence(self, payloads: Tensor, resid_p: Tensor, ctx,
                              cand_idx: Tensor | None = None) -> Tensor:
        """:meth:`shard_divergence` in one launch of the objective's kernel."""
        raise NotImplementedError(
            f"{type(self).__name__} has no CUDA divergence kernel")

    def shard_take(self, cand_idx: Tensor) -> "SubmodularFunction":
        """The view restricted to its candidates ``cand_idx`` (k,)."""
        raise NotImplementedError

    def shard_gains(self, state: Tensor, ctx,
                    cand_idx: Tensor | None = None) -> Tensor:
        """f(v|S) of the view's candidates (or of ``cand_idx``) from a
        replicated state, the arithmetic of the dense :meth:`gains`.  The
        plain version; :meth:`cuda_shard_gains` is the kernel."""
        raise NotImplementedError

    def cuda_shard_gains(self, state: Tensor, ctx,
                         cand_idx: Tensor | None = None) -> Tensor:
        """:meth:`shard_gains` in one launch of the objective's kernel."""
        raise NotImplementedError(
            f"{type(self).__name__} has no CUDA gains kernel")

    def shard_add(self, state: Tensor, v: Tensor, ctx) -> Tensor:
        """The replicated state for S + v, ``v`` a 0-d index of the view's
        candidates; the dense :meth:`add` of that element."""
        raise NotImplementedError

    def shard_value(self, state: Tensor, ctx) -> Tensor:
        """f(S) from a replicated state, pod-global constants from ``ctx``."""
        return self.value(state)


def _block(n: int, mesh, axes: tuple[str, ...]) -> tuple[int, int]:
    """(first, count) of this rank's contiguous block of n candidates over
    the mesh ``axes`` (outer first)."""
    shards, idx = 1, 0
    for a in axes:
        size = mesh.size(mesh.mesh_dim_names.index(a))
        shards, idx = shards * size, idx * size + mesh.get_local_rank(a)
    if n % shards:
        raise ValueError(f"n = {n} does not divide into {shards} shards (pad rows)")
    n_loc = n // shards
    return idx * n_loc, n_loc


def _gather_top2(comm, loc: Tensor) -> tuple[Tensor, Tensor]:
    """The global (best, second) of each served row from every shard's
    local top-2 rows ``loc`` (ni, 2): an all_gather, then the top-2 of the
    gathered values (NEG padding, as the reference's), exact."""
    allt = comm.all_gather(loc.float().contiguous())              # (S, ni, 2)
    allt = allt.permute(1, 0, 2).reshape(loc.shape[0], -1)
    pad = torch.full((loc.shape[0], 2), NEG, dtype=torch.float32, device=loc.device)
    t = torch.topk(torch.cat([allt, pad], dim=1), 2, dim=1).values
    return t[:, 0], t[:, 1]


def _fl_ctx(comm, best: Tensor, second: Tensor, cnt_loc: Tensor):
    """(best, loss) of facility location's residuals: a row whose best is
    reached by more than one candidate over all shards (an int32
    all_reduce) loses nothing."""
    cnt = comm.all_reduce(cnt_loc.to(torch.int32).contiguous(), "sum")
    loss = torch.where(cnt > 1, 0.0, best.clamp_min(0.0) - second.clamp_min(0.0))
    return best, loss



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

    supports_pod_sharding = True
    supports_shard_compact = True
    supports_shard_greedy = True

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
        return self._gains_rows(state, self.W, self._cap())

    def gains_compact(self, state: Tensor, cand_idx: Tensor) -> Tensor:
        """The gains of the gathered candidate rows only: the same
        arithmetic per element as :meth:`gains`."""
        return self._gains_rows(state, self.W[cand_idx], self._cap())

    def _gains_rows(self, state: Tensor, rows: Tensor, cap: Tensor | None) -> Tensor:
        phi_c = _phi(self.phi, state[None, :], cap)
        return _by_rows(
            rows, lambda W: self._wsum(_phi(self.phi, state[None, :] + W, cap) - phi_c)
        )

    def add(self, state: Tensor, v: Tensor) -> Tensor:
        return state + self.W.index_select(0, v.reshape(1))[0]

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
        # (r, chunk, F) blocks of at most 256 MiB: the whole (r, k, F) block
        # is 480 GB for 1792 probes over 2^16 rows of 1024 features.
        step = max(1, _ELEMS // max(1, cu.numel()))
        pair = [self._wsum(_phi(self.phi, cu[:, None, :] + chunk[None, :, :], cap))
                for chunk in rows.split(step)]
        out = torch.cat(pair, dim=1) - phi_cu[:, None]
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

    def sieve_elements(self, vals: Tensor) -> SieveElements:
        """Rows of W, the term w_l phi(s + e)."""
        return SieveElements(_sieve_f32(self.W), _with_zero(vals), False, self.phi,
                             _f32(self.feat_w), _f32(self._cap()))

    # -- shard hooks (rows of W) ---------------------------------------------
    # ctx = (C, cap, phi(C)): C the pod's feature totals, summed in rank
    # order so that every rank and both backends hold the same bits; every
    # gain, divergence, phi_cu and value of the view takes cap from it (the
    # view's own W would under-saturate satcov).

    def shard(self, mesh, axes):
        lo, n_loc = _block(self.n, mesh, tuple(axes))
        return dataclasses.replace(self, W=self.W[lo:lo + n_loc])

    def local_n(self) -> int:
        return self.W.shape[0]

    def shard_init(self, comm):
        parts = comm.all_gather(self.W.sum(dim=0, dtype=torch.float32))  # (S, F)
        C = parts[0].clone()
        for p in parts[1:]:
            C += p
        cap = self.alpha * C if self.phi == "satcov" else None
        return C, cap, self._wsum(_phi(self.phi, C, cap))

    def shard_residuals(self, ctx) -> Tensor:
        C, cap, phi_C = ctx
        return _by_rows(
            self.W, lambda W: phi_C - self._wsum(_phi(self.phi, C[None, :] - W, cap)))

    def shard_payloads(self, idx: Tensor, state: Tensor | None = None) -> Tensor:
        """A probe's coverage row c(S + u)."""
        rows = self.W[idx]
        return (rows if state is None else state[None, :] + rows).float()

    def _phi_cu(self, payloads: Tensor, ctx) -> Tensor:
        return self._wsum(_phi(self.phi, payloads, ctx[1]))

    def shard_payload_gains(self, payloads: Tensor, ctx) -> Tensor:
        cap, phi_cu = ctx[1], self._phi_cu(payloads, ctx)
        step = max(1, _ELEMS // max(1, payloads.numel()))
        return torch.cat([
            self._wsum(_phi(self.phi, payloads[:, None, :] + rows[None].float(), cap))
            for rows in self.W.split(step)], dim=1) - phi_cu[:, None]

    def shard_divergence(self, payloads, resid_p, ctx, cand_idx=None):
        return ss_divergence_ref(self.W, payloads, self._phi_cu(payloads, ctx),
                                 resid_p, ctx[1], self.phi, self.feat_w, cand_idx)

    def cuda_shard_divergence(self, payloads, resid_p, ctx, cand_idx=None):
        return ss_divergence_kernel(
            self.W, payloads.contiguous(), self._phi_cu(payloads, ctx).contiguous(),
            resid_p.float().contiguous(), _f32(ctx[1]), _f32(self.feat_w), cand_idx,
            phi=self.phi)

    def shard_take(self, cand_idx: Tensor) -> "FeatureCoverage":
        return dataclasses.replace(self, W=self.W[cand_idx])

    def shard_gains(self, state, ctx, cand_idx=None):
        rows = self.W if cand_idx is None else self.W[cand_idx]
        return self._gains_rows(state, rows, ctx[1])

    def cuda_shard_gains(self, state, ctx, cand_idx=None):
        c = state.float().contiguous()
        return feature_gains_kernel(
            self.W, c, self._wsum(_phi(self.phi, c, ctx[1])), _f32(ctx[1]),
            _f32(self.feat_w), cand_idx, phi=self.phi)

    def shard_add(self, state: Tensor, v: Tensor, ctx) -> Tensor:
        return self.add(state, v)

    def shard_value(self, state: Tensor, ctx) -> Tensor:
        return self._wsum(_phi(self.phi, state, ctx[1]))


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

    supports_shard_compact = True
    supports_shard_greedy = True

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
        return torch.maximum(state, self.sim.index_select(1, v.reshape(1))[:, 0])

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

    def sieve_elements(self, vals: Tensor) -> SieveElements:
        """Columns of sim, the term max(s, e)."""
        return SieveElements(_sieve_f32(self.sim), _with_zero(vals), True)

    # -- shard hooks (columns of sim, every served row) ----------------------
    # A probe's payload is its coverage row max(state, sim[:, u]) over all n
    # served rows, so any rank evaluates f(v | S + u) for its own columns.
    # ctx = (best, loss) of the residuals.  No pod hierarchy: the served
    # rows span the whole ground set.

    def shard(self, mesh, axes):
        if len(axes) > 1:
            raise NotImplementedError(
                "FacilityLocation shards candidates only (no pod hierarchy): "
                "its served rows span the full ground set")
        lo, n_loc = _block(self.sim.shape[1], mesh, tuple(axes))
        if n_loc == self.sim.shape[1]:
            return self                     # one rank: sim itself, no copy
        return dataclasses.replace(self, sim=self.sim[:, lo:lo + n_loc].contiguous())

    def local_n(self) -> int:
        return self.sim.shape[1]

    def shard_init(self, comm):
        loc = torch.cat([torch.stack(top2(blk.float()), dim=1)
                         for blk in self._row_blocks()])               # (n, 2)
        best, second = _gather_top2(comm, loc)
        rows = self._row_blocks()
        cnt = torch.cat([(blk >= best[lo:lo + blk.shape[0], None]).sum(
            dim=1, dtype=torch.int32) for lo, blk in _offsets(rows)])
        return _fl_ctx(comm, best, second, cnt)

    def shard_residuals(self, ctx) -> Tensor:
        best, loss = ctx
        out = torch.zeros((self.sim.shape[1],), dtype=torch.float32,
                          device=self.sim.device)
        for lo, blk in _offsets(self._row_blocks()):
            hi = lo + blk.shape[0]
            out += torch.where(blk >= best[lo:hi, None], loss[lo:hi, None], 0.0).sum(0)
        return out

    def shard_payloads(self, idx: Tensor, state: Tensor | None = None) -> Tensor:
        return self._probe_mu(idx, state).float()

    def shard_payload_gains(self, payloads: Tensor, ctx) -> Tensor:
        return fl_pair_ref(self.sim, payloads)

    def shard_divergence(self, payloads, resid_p, ctx, cand_idx=None):
        return fl_divergence_ref(self.sim, payloads, resid_p, cand_idx)

    def cuda_shard_divergence(self, payloads, resid_p, ctx, cand_idx=None):
        return fl_divergence_kernel(self.sim, payloads.contiguous(),
                                    resid_p.float().contiguous(), cand_idx)

    def shard_take(self, cand_idx: Tensor) -> "FacilityLocation":
        """The candidate columns as one contiguous (n, k) tensor."""
        return dataclasses.replace(self, sim=self.sim.index_select(1, cand_idx))

    def shard_gains(self, state, ctx, cand_idx=None):
        return fl_pair_ref(self.sim, state[None, :], cand_idx)[0]

    def cuda_shard_gains(self, state, ctx, cand_idx=None):
        return fl_gains_kernel(self.sim, state, cand_idx)

    def shard_add(self, state: Tensor, v: Tensor, ctx) -> Tensor:
        return self.add(state, v)


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

    supports_shard_compact = True
    supports_shard_greedy = True

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
        row = self.X.index_select(0, v.reshape(1))
        return torch.maximum(state, sim_rows(self._served(), row)[:, 0])

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

    def sieve_elements(self, vals: Tensor) -> SieveElements:
        """The chunk's columns relu(X_served · X[v]), as the first c columns
        of one (ni, c rounded up to SIEVE_BLOCK) buffer, made by
        ``matmul_ieee`` in blocks of exactly SIEVE_BLOCK columns (the last
        padded with the chunk's first element), so that each column has the
        bits of one product shape at any position in any chunk; the term
        max(s, e)."""
        _sieve_f32(self.X)
        vals = vals.long()
        c = vals.shape[0]
        pad = -c % SIEVE_BLOCK
        blocks = torch.cat([vals, vals[:1].expand(pad)]) if pad else vals
        Xs = self._served()
        cols = torch.empty((Xs.shape[0], blocks.shape[0]), dtype=torch.float32,
                           device=vals.device)
        for lo in range(0, blocks.shape[0], SIEVE_BLOCK):
            cols[:, lo:lo + SIEVE_BLOCK] = sim_rows(
                Xs, self.X.index_select(0, blocks[lo:lo + SIEVE_BLOCK]))
        pos = torch.arange(c, device=vals.device)
        return SieveElements(cols, _with_zero(pos), True)

    def sieve_chunk(self) -> int:
        """A chunk's columns stay under SIEVE_COLUMN_ELEMS float32 entries."""
        return max(1, SIEVE_COLUMN_ELEMS // self._served().shape[0])

    # -- shard hooks (rows of X, every served row in Xs) ---------------------
    # The payloads are the (k, ni) probe coverage rows of dense facility
    # location, formed from the rows on the fly; ctx = (best, loss).

    def shard(self, mesh, axes):
        if len(axes) > 1:
            raise NotImplementedError(
                "StreamingFacilityLocation shards candidates only (no pod "
                "hierarchy): its served rows span the full ground set")
        lo, n_loc = _block(self.n, mesh, tuple(axes))
        return dataclasses.replace(self, X=self.X[lo:lo + n_loc], Xs=self._served())

    def local_n(self) -> int:
        return self.X.shape[0]

    def shard_init(self, comm):
        best, second = _gather_top2(comm, fl_stream_top2(self._served(), self.X))
        cnt = fl_stream_count_best(self._served(), self.X, best)
        return _fl_ctx(comm, best, second, cnt)

    def shard_residuals(self, ctx) -> Tensor:
        best, loss = ctx
        return fl_stream_best_loss_sum(self._served(), self.X, best, loss)

    def shard_payloads(self, idx: Tensor, state: Tensor | None = None) -> Tensor:
        return self._probe_mu(idx, state)

    def shard_payload_gains(self, payloads: Tensor, ctx) -> Tensor:
        return fl_stream_pair_ref(self._served(), payloads, Xc=self.X)

    def shard_divergence(self, payloads, resid_p, ctx, cand_idx=None):
        return fl_stream_divergence_ref(self._served(), payloads, resid_p,
                                        cand_idx, self.X)

    def cuda_shard_divergence(self, payloads, resid_p, ctx, cand_idx=None):
        return fl_stream_divergence_kernel(
            self._served(), payloads.contiguous(), resid_p.float().contiguous(),
            cand_idx, self.X)

    def shard_take(self, cand_idx: Tensor) -> "StreamingFacilityLocation":
        return dataclasses.replace(self, X=self.X[cand_idx], Xs=self._served())

    def shard_gains(self, state, ctx, cand_idx=None):
        return self.gains(state) if cand_idx is None else self.gains_compact(
            state, cand_idx)

    def cuda_shard_gains(self, state, ctx, cand_idx=None):
        return fl_stream_gains_kernel(self._served(), state, cand_idx, self.X)

    def shard_add(self, state: Tensor, v: Tensor, ctx) -> Tensor:
        return self.add(state, v)


def _normalize(X: Tensor) -> Tensor:
    """Rows of X scaled to unit norm (rows of norm below 1e-9 by 1e-9)."""
    return X / torch.clamp_min(torch.linalg.vector_norm(X, dim=1, keepdim=True), 1e-9)


def _offsets(blocks):
    """(first row, block) over consecutive row blocks."""
    lo = 0
    for blk in blocks:
        yield lo, blk
        lo += blk.shape[0]


def _by_rows(W: Tensor, row_fn) -> Tensor:
    """``row_fn`` over row chunks of ``W``, concatenated: the plain
    full-width paths never hold a whole (n, F) temporary (4 GiB per
    temporary at n = 2^20, F = 1024 in float32)."""
    if W.shape[0] <= _ROW_CHUNK:
        return row_fn(W)
    return torch.cat([row_fn(chunk) for chunk in W.split(_ROW_CHUNK)])


def _f32(t: Tensor | None) -> Tensor | None:
    return None if t is None else t.float().contiguous()


def _sieve_f32(t: Tensor) -> Tensor:
    if t.dtype != torch.float32:
        raise TypeError(f"sieve streaming runs float32 objectives; got {t.dtype}")
    return t


def _with_zero(vals: Tensor) -> Tensor:
    """The stream values (int64) and the zero element, -1, last."""
    return torch.cat([vals.long(), vals.new_full((1,), -1, dtype=torch.int64)])
