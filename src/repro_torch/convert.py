"""Carry the JAX package's arrays across to the port.

A JAX objective's arrays (``FeatureCoverage.W``, ``FacilityLocation.sim``,
``StreamingFacilityLocation.X`` / ``Xs``), as numpy arrays, become the
port's objective on the chosen device, the card by default.  A JAX model's
parameter tree and decode cache, as numpy arrays, become the port's (same
layout: groups stacked on axis 0).  The tests and ``chip_smoke.py`` build
their objectives this way.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.functions import (
    FacilityLocation,
    FeatureCoverage,
    StreamingFacilityLocation,
)
from repro_torch.device import resolve_device as _device
from repro_torch.models.config import ModelConfig
from repro_torch.models.decoder import _require_ported
from repro_torch.models.layers import tree_leaves


def feature_coverage_from_numpy(
    W: np.ndarray,
    feat_w: np.ndarray | None = None,
    phi: str = "sqrt",
    alpha: float = 0.2,
    device="cuda",
    dtype: torch.dtype | None = None,
) -> FeatureCoverage:
    """FeatureCoverage over ``W`` (n, F) on ``device`` (the card by default).

    ``dtype`` casts W (e.g. ``torch.bfloat16``); None keeps W's dtype.
    ``feat_w`` stays float32.
    """
    dev = _device(device)
    Wt = torch.as_tensor(np.ascontiguousarray(W)).to(dev)
    if dtype is not None:
        Wt = Wt.to(dtype)
    fw = None
    if feat_w is not None:
        fw = torch.as_tensor(np.asarray(feat_w, np.float32)).to(dev)
    return FeatureCoverage(W=Wt, feat_w=fw, phi=phi, alpha=alpha)


def _f32(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C")).to(dev)


def facility_location_from_numpy(sim: np.ndarray, device="cuda") -> FacilityLocation:
    """FacilityLocation over the (n, n) similarity ``sim`` (a JAX
    ``FacilityLocation.sim``) on ``device``; float32 is kept as it is, other
    dtypes become float32."""
    return FacilityLocation(sim=_f32(sim, _device(device)))


def streaming_facility_location_from_numpy(
    X: np.ndarray, Xs: np.ndarray | None = None, device="cuda"
) -> StreamingFacilityLocation:
    """StreamingFacilityLocation over the candidate rows ``X`` (n, d) and the
    served rows ``Xs`` (None: X itself), as the JAX objective holds them."""
    dev = _device(device)
    return StreamingFacilityLocation(
        X=_f32(X, dev), Xs=None if Xs is None else _f32(Xs, dev))


def facility_location_from_features(
    X: np.ndarray,
    kernel: str = "dot",
    device="cuda",
    n_threshold: int | None = FacilityLocation.N_THRESHOLD,
) -> FacilityLocation:
    """``FacilityLocation.from_features`` with the (n, n) similarity computed
    on ``device`` from the rows of ``X``."""
    return FacilityLocation.from_features(_f32(X, _device(device)), kernel,
                                          n_threshold=n_threshold)


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A copy of a numpy array (bfloat16 arrays, which JAX hands out through
    ml_dtypes, included) as a tensor of the same dtype on ``dev``.  Always a
    copy: the port updates its decode cache in place, and JAX's arrays are
    read-only views of its own buffers."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _tree(tree: dict, dev: torch.device) -> dict:
    return {k: _tree(v, dev) if isinstance(v, dict) else _tensor(v, dev)
            for k, v in tree.items()}


def model_params_from_numpy(params: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The port's parameters from a JAX parameter tree (``init_params``'s,
    leaves as numpy arrays, groups stacked on axis 0), on ``device``, each
    leaf in its own dtype."""
    dev = _device(device)
    _require_ported(cfg)
    G = cfg.num_groups
    for i in range(len(cfg.block_pattern)):
        for leaf in tree_leaves(params["blocks"][f"p{i}"]):
            if leaf.shape[:1] != (G,):
                raise ValueError(f"{cfg.name}: blocks.p{i} must be stacked over "
                                 f"{G} groups on axis 0, got {leaf.shape}")
    return _tree(params, dev)


def cache_from_numpy(cache: dict, device="cuda") -> dict:
    """The port's decode cache from a JAX one (``prefill``'s or
    ``init_cache``'s, leaves as numpy arrays), on ``device``."""
    return _tree(cache, _device(device))

