"""Execution backends for the submodular hot paths.

SS and greedy evaluate four primitives: ``gains`` / ``gains_compact`` (the
greedy step, full width or over a compacted candidate buffer) and
``divergence`` / ``divergence_compact`` (the SS round, paper Def. 2);
sieve streaming a fifth, ``sieve_table`` (its states against a chunk of
the stream).
The batched SS and greedy of a stacked objective (B same-shape queries)
evaluate two more, ``divergence_batched`` and ``gains_batched`` (after
``prepare_batched``, the batched ``prepare_compact``): the base class maps
its single-query primitives over the rows, for both backends.
Greedy over a buffer first asks ``prepare_compact`` what its steps should
read (the objective's ``cuda_prepare`` under ``cuda``: dense facility
location gathers its candidate columns once).  This module decides how they
run:

- ``reference`` (:class:`ReferenceBackend`): plain PyTorch on whatever
  device the objective lives on; the counterpart of the JAX ``oracle``.
- ``cuda`` (:class:`CudaBackend`): the objective's CUDA kernel hooks; the
  counterpart of the JAX ``pallas`` backend.  It takes CUDA tensors only,
  and an objective without a kernel raises: nothing falls back to the plain
  path.  Its batched primitives launch the single-query kernels once per
  row, on views of the row's tensors (a kernel over the whole batch grid is
  later work).

- ``sharded`` (:class:`ShardedBackend`): the whole SS, greedy and
  stochastic greedy loops over the ranks of a ``torch.distributed``
  DeviceMesh (:mod:`repro_torch.core.distributed`); each rank's view of the
  objective runs through a per-rank backend of the two above.

The sharded loops evaluate two primitives of their own on a rank's view,
``shard_divergence`` and ``shard_gains`` (the objective's plain hooks, or
its kernels under ``cuda``).  Every backend also owns three whole loops,
``sparsify``, ``greedy`` and ``stochastic_greedy`` (and ``sparsify_batched``):
the dense loops by default, the sharded ones under ``sharded``.

``resolve_backend(None, device)`` picks ``cuda`` for an objective on a CUDA
device and ``reference`` for one on the CPU, never the reverse, and never
``sharded``.  No environment variable takes part in the choice.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import graph
from repro_torch.core.functions import SubmodularFunction
from repro_torch.kernels.sieve_gains import (
    SieveElements,
    sieve_gains_kernel,
    sieve_gains_ref,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Backend:
    """Execution strategy for the primitives.  The base class is the plain
    PyTorch path; :class:`CudaBackend` overrides every primitive."""

    name = "reference"

    def gains(self, fn: SubmodularFunction, state: Tensor) -> Tensor:
        """f(v|S) for all v.  Shape (n,)."""
        return fn.gains(state)

    def gains_compact(
        self, fn: SubmodularFunction, state: Tensor, cand_idx: Tensor
    ) -> Tensor:
        """f(v|S) for the candidate buffer ``cand_idx`` (k,).  Shape (k,)."""
        return fn.gains_compact(state, cand_idx)

    def prepare_compact(self, fn: SubmodularFunction, cand_idx: Tensor):
        """What greedy's steps over the buffer ``cand_idx`` hand
        :meth:`gains_compact` in its place, made once before the first
        step: ``cand_idx`` itself on the plain path."""
        return cand_idx

    def divergence(
        self,
        fn: SubmodularFunction,
        probes: Tensor,
        residual: Tensor | None = None,
        state: Tensor | None = None,
    ) -> Tensor:
        """w_{U,v} = min_u [f(v|S+u) - f(u|V\\u)] for all v.  (n,)."""
        return graph.divergence(fn, probes, residual, state)

    def divergence_compact(
        self,
        fn: SubmodularFunction,
        probes: Tensor,
        cand_idx: Tensor,
        residual: Tensor | None = None,
        state: Tensor | None = None,
    ) -> Tensor:
        """w_{U,v} for the candidate buffer ``cand_idx`` (k,).  (k,)."""
        return graph.divergence_compact(fn, probes, cand_idx, residual, state)

    # The batched primitives of a stacked objective: row b's views
    # (``fn.row(b)``), then this backend's single-query primitive, so each
    # row equals its single-query call bit for bit (one kernel launch a row
    # under ``cuda``).

    def divergence_batched(
        self,
        fn: SubmodularFunction,
        probes: Tensor,
        cand_idx: Tensor | None = None,
        residual: Tensor | None = None,
        state: Tensor | None = None,
        rows: "list[int] | None" = None,
    ) -> Tensor:
        """w_{U_b,v} of a stacked objective, one position per row of
        ``rows`` (all B when None): probes (R, r), cand_idx (R, k) or None
        (all n), ``residual`` the stacked (B, n) block, ``state`` the
        per-position states or None.  (R, k); position i is
        :meth:`divergence_compact` (:meth:`divergence` when cand_idx is
        None) of ``fn.row(rows[i])``."""
        rows = range(fn.batch) if rows is None else rows
        out = []
        for i, b in enumerate(rows):
            f, st = fn.row(b), None if state is None else state[i]
            res = None if residual is None else residual[b]
            out.append(self.divergence(f, probes[i], res, st) if cand_idx is None
                       else self.divergence_compact(f, probes[i], cand_idx[i], res, st))
        return torch.stack(out)

    def gains_batched(
        self,
        fn: SubmodularFunction,
        state: Tensor,
        cand_idx,
        rows: "list[int] | None" = None,
    ) -> Tensor:
        """f(v|S_b) of a stacked objective, one position per row of
        ``rows`` (all B when None): ``state`` (R, ·), ``cand_idx`` (R, k),
        None (all n), or what :meth:`prepare_batched` made of it.  (R, k);
        position i is :meth:`gains_compact` (:meth:`gains` when None) of
        ``fn.row(rows[i])``."""
        rows = range(fn.batch) if rows is None else rows
        return torch.stack([
            self.gains(fn.row(b), state[i]) if cand_idx is None
            else self.gains_compact(fn.row(b), state[i], cand_idx[i])
            for i, b in enumerate(rows)])

    def prepare_batched(self, fn: SubmodularFunction, cand_idx: Tensor) -> list:
        """:meth:`prepare_compact` of each row's buffer of the (B, k)
        ``cand_idx``, once per batched greedy run (dense facility location's
        V' panel under ``cuda``), as a list of B."""
        return [self.prepare_compact(fn.row(b), c) for b, c in enumerate(cand_idx)]

    def sieve_table(
        self,
        fn: SubmodularFunction,
        S: Tensor,
        el: SieveElements,
        start: Tensor | None = None,
    ) -> Tensor:
        """The sieve table of the states ``S`` (R, L) against ``el``'s
        elements (``kernels/sieve_gains.py``), (R, n_cols).  Rows may skip
        the columns before ``start`` (R,); the plain path computes them."""
        return sieve_gains_ref(S, el.E, el.idx, cols=el.cols, phi=el.phi,
                               feat_w=el.feat_w, cap=el.cap)

    # The sharded loops' primitives on a rank's view (``fn.shard``).

    def shard_divergence(self, view: SubmodularFunction, payloads: Tensor,
                         resid_p: Tensor, ctx, cand_idx: Tensor | None = None
                         ) -> Tensor:
        """min over the probes' ``payloads`` of f(v | S + u) - resid_p[u]
        for the view's candidates (or ``cand_idx``).  (n_loc,) or (k,)."""
        return view.shard_divergence(payloads, resid_p, ctx, cand_idx)

    def shard_gains(self, view: SubmodularFunction, state: Tensor, ctx,
                    cand_idx: Tensor | None = None) -> Tensor:
        """f(v|S) of the view's candidates (or ``cand_idx``).  (n_loc,)."""
        return view.shard_gains(state, ctx, cand_idx)

    # The whole loops: the dense single-process ones; ``sharded`` owns its
    # own.  Keyword arguments are the entry points' (``ss_sparsify``,
    # ``ss_sparsify_batched``, ``greedy``, ``stochastic_greedy``).

    def sparsify(self, fn: SubmodularFunction, generator=None, **kw):
        from repro_torch.core.sparsify import _sparsify_dense

        return _sparsify_dense(fn, generator, backend=self, **kw)

    def sparsify_batched(self, fn: SubmodularFunction, generators=None, **kw):
        from repro_torch.core.sparsify import _sparsify_batched

        return _sparsify_batched(fn, generators, backend=self, **kw)

    def greedy(self, fn: SubmodularFunction, k: int, **kw):
        from repro_torch.core.greedy import _greedy_dense

        return _greedy_dense(fn, k, backend=self, **kw)

    def stochastic_greedy(self, fn: SubmodularFunction, k: int, generator=None,
                          **kw):
        from repro_torch.core.greedy import _stochastic_greedy_dense

        return _stochastic_greedy_dense(fn, k, generator, backend=self, **kw)


@dataclasses.dataclass(frozen=True)
class ReferenceBackend(Backend):
    """Plain PyTorch: inherits every primitive unchanged."""

    name = "reference"


@dataclasses.dataclass(frozen=True)
class CudaBackend(Backend):
    """The hand-written CUDA kernels, through the objective's hooks."""

    name = "cuda"

    @staticmethod
    def _check(fn: SubmodularFunction) -> None:
        if fn.device.type != "cuda":
            raise ValueError(
                f"the cuda backend runs CUDA tensors only; the objective is on "
                f"{fn.device} (use backend='reference' for the plain path)"
            )

    def gains(self, fn, state):
        self._check(fn)
        return fn.cuda_gains(state)

    def gains_compact(self, fn, state, cand_idx):
        self._check(fn)
        return fn.cuda_gains(state, cand_idx)

    def prepare_compact(self, fn, cand_idx):
        self._check(fn)
        return fn.cuda_prepare(cand_idx)

    def divergence(self, fn, probes, residual=None, state=None):
        self._check(fn)
        if residual is None:
            residual = fn.residual_gains()
        return fn.cuda_divergence(probes, residual, state)

    def divergence_compact(self, fn, probes, cand_idx, residual=None, state=None):
        self._check(fn)
        if residual is None:
            residual = fn.residual_gains()
        return fn.cuda_divergence(probes, residual, state, cand_idx)

    def sieve_table(self, fn, S, el, start=None):
        self._check(fn)
        return sieve_gains_kernel(S, el, start)

    def shard_divergence(self, view, payloads, resid_p, ctx, cand_idx=None):
        self._check(view)
        return view.cuda_shard_divergence(payloads, resid_p, ctx, cand_idx)

    def shard_gains(self, view, state, ctx, cand_idx=None):
        self._check(view)
        return view.cuda_shard_gains(state, ctx, cand_idx)


@dataclasses.dataclass(frozen=True)
class ShardedBackend(Backend):
    """The sharded loops over a DeviceMesh (SPMD: every rank makes the same
    call with the same whole objective, and gets the same result).

    ``mesh=None`` is one ``data_axis`` over the default group's world,
    made at call time; without an initialised process group the backend
    raises (no function here opens one).  ``pod_axis`` runs SS per pod
    (each pod's rows a ground set of its own).  ``shard_backend`` runs each
    rank's view: None picks it by the view's device (the kernels on the
    card), as the dense loops do; the per-call primitives (``gains``,
    ``divergence``, ...) go through it too.

    ``greedy`` keeps the reference's rule: with a pod axis, without the
    objective's selection hooks, or with n not divisible by the data
    axis, it runs the dense loop (``ShardedBackend.dense_greedy_runs``
    counts those runs).  ``sparsify_batched`` and stochastic greedy with a
    pod axis raise.
    """

    name = "sharded"
    mesh: object = None
    data_axis: str = "data"
    pod_axis: str | None = None
    bins: int = 512
    shard_backend: "str | Backend | None" = None

    dense_greedy_runs = 0

    def __post_init__(self):
        if self.mesh is None and not dist.is_initialized():
            raise RuntimeError(
                "ShardedBackend(mesh=None) spans the default process group, and "
                "none is initialised: call torch.distributed.init_process_group "
                "first, or pass a DeviceMesh")

    def _mesh(self):
        if self.mesh is not None:
            return self.mesh
        from repro_torch.launch.mesh import make_mesh

        return make_mesh((dist.get_world_size(),), (self.data_axis,),
                         "cuda" if dist.get_backend() == "nccl" else "cpu")

    def _local(self, fn: SubmodularFunction) -> Backend:
        return resolve_backend(self.shard_backend, fn.device)

    def gains(self, fn, state):
        return self._local(fn).gains(fn, state)

    def gains_compact(self, fn, state, cand_idx):
        return self._local(fn).gains_compact(fn, state, cand_idx)

    def prepare_compact(self, fn, cand_idx):
        return self._local(fn).prepare_compact(fn, cand_idx)

    def divergence(self, fn, probes, residual=None, state=None):
        return self._local(fn).divergence(fn, probes, residual, state)

    def divergence_compact(self, fn, probes, cand_idx, residual=None, state=None):
        return self._local(fn).divergence_compact(fn, probes, cand_idx, residual, state)

    def sieve_table(self, fn, S, el, start=None):
        return self._local(fn).sieve_table(fn, S, el, start)

    def sparsify(self, fn, generator=None, **kw):
        from repro_torch.core import distributed

        fn = distributed._as_objective(fn)
        mesh = self._mesh()
        axes = (self.pod_axis, self.data_axis) if self.pod_axis else (self.data_axis,)
        return distributed.ss_sparsify_sharded(
            fn.shard(mesh, axes), mesh, generator,
            data_axis=self.data_axis, pod_axis=self.pod_axis, bins=self.bins,
            backend=self.shard_backend, **kw)

    def sparsify_batched(self, fn, generators=None, **kw):
        raise NotImplementedError(
            "the sharded backend owns the whole mesh per query and does not "
            "micro-batch; use backend='reference' or 'cuda' for the batched "
            "serving path")

    def greedy(self, fn, k, **kw):
        from repro_torch.core import distributed

        fn = distributed._as_objective(fn)
        mesh = None if self.pod_axis else self._mesh()
        if (mesh is None or not fn.supports_shard_greedy
                or fn.n % mesh.size(mesh.mesh_dim_names.index(self.data_axis))):
            # the reference's rule (a pure rule of the objective and its
            # shape): the dense loop, through the per-rank backend
            ShardedBackend.dense_greedy_runs += 1
            return super().greedy(fn, k, **kw)
        return distributed.greedy_sharded(
            fn.shard(mesh, (self.data_axis,)), k, mesh, data_axis=self.data_axis,
            backend=self.shard_backend, **kw)

    def stochastic_greedy(self, fn, k, generator=None, **kw):
        from repro_torch.core import distributed

        if self.pod_axis:
            raise NotImplementedError(
                "sharded stochastic greedy is single-level (the selection stage "
                "is global); use a data-axis-only ShardedBackend")
        fn = distributed._as_objective(fn)
        mesh = self._mesh()
        return distributed.stochastic_greedy_sharded(
            fn.shard(mesh, (self.data_axis,)), k, mesh, generator,
            data_axis=self.data_axis, backend=self.shard_backend, **kw)


_BACKENDS = {"reference": ReferenceBackend, "cuda": CudaBackend,
             "sharded": ShardedBackend}


def resolve_backend(
    spec: "str | Backend | None" = None, device: torch.device | None = None
) -> Backend:
    """A ``backend=`` argument: a Backend (as is), a name ("reference",
    "cuda" or "sharded"), or None, which picks by ``device``: cuda for a
    CUDA device, reference for the CPU (never sharded)."""
    if isinstance(spec, Backend):
        return spec
    if spec is None:
        if device is None:
            raise ValueError("resolve_backend(None) needs the objective's device")
        spec = "cuda" if torch.device(device).type == "cuda" else "reference"
    if isinstance(spec, str):
        if spec not in _BACKENDS:
            raise KeyError(f"unknown backend {spec!r}; available: {sorted(_BACKENDS)}")
        return _BACKENDS[spec]()
    raise TypeError(f"backend must be a name, Backend, or None; got {spec!r}")
