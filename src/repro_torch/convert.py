"""Carry a JAX ``FeatureCoverage``'s fields across to the port.

The JAX objective's arrays, as numpy arrays, become the port's objective on
the chosen device.  The tests and ``chip_smoke.py`` build their objectives
this way.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.functions import FeatureCoverage


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
