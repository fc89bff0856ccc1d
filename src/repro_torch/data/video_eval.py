"""Scoring of video summaries (the paper's SumMe study, §4.3 / §5.13): the
windowed frame F1 between two summaries and the novelty reference summary.

Numpy only, on the host.  Copies of ``benchmarks/common.py``'s ``frame_f1``
and ``benchmarks/table2_video.py``'s ``_reference``, which the port cannot
import (the second module imports JAX).  Both are kept verbatim: in
particular ``novelty_reference`` ranks with numpy's default (unstable)
``argsort``, which can keep other frames than a stable sort where two
novelties tie.
"""

from __future__ import annotations

import numpy as np


def frame_f1(selected, reference, n_frames: int, window: int = 16) -> float:
    """Windowed F1 between two frame-index summaries (SumMe-style voting
    tolerance: a selected frame matches a reference frame within ±window)."""
    sel = np.asarray(sorted(set(int(i) for i in selected)))
    ref = np.asarray(sorted(set(int(i) for i in reference)))
    if len(sel) == 0 or len(ref) == 0:
        return 0.0
    hit_sel = np.zeros(len(sel), bool)
    hit_ref = np.zeros(len(ref), bool)
    j = 0
    for i, s in enumerate(sel):
        dists = np.abs(ref - s)
        k = int(np.argmin(dists))
        if dists[k] <= window:
            hit_sel[i] = True
            hit_ref[k] = True
    p = hit_sel.mean()
    r = hit_ref.mean()
    return 0.0 if p + r == 0 else float(2 * p * r / (p + r))


def novelty_reference(X: np.ndarray, frac: float = 0.15) -> np.ndarray:
    """Ground-truth 'user' summary: frames farthest from their local temporal
    context (scene changes / unique moments), SumMe's voting proxy."""
    w = 24
    n = len(X)
    pad = np.pad(X, ((w, w), (0, 0)), mode="edge")
    local = np.stack([pad[i : i + 2 * w + 1].mean(0) for i in range(n)])
    novelty = np.linalg.norm(X - local, axis=1)
    k = max(1, int(frac * n))
    return np.argsort(-novelty)[:k]
