"""Carry the JAX objectives' arrays across to the port.

A JAX objective's arrays (``FeatureCoverage.W``, ``FacilityLocation.sim``,
``StreamingFacilityLocation.X`` / ``Xs``), as numpy arrays, become the
port's objective on the chosen device, the card by default.  The tests and
``chip_smoke.py`` build their objectives this way.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.functions import (
    FacilityLocation,
    FeatureCoverage,
    StreamingFacilityLocation,
)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the host"
        )
    return dev


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
