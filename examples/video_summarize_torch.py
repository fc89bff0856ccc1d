"""Video summarization with SS (paper §4.3 / §5.13) on the card: a synthetic
SumMe-like video, 15% of its frames selected by greedy on all frames and by
SS then greedy on the pruned set V', beside the first-15% baseline, each
scored by frame F1 against the novelty reference.  The counterpart of
``examples/video_summarize.py``.

On the card SS runs the ``ss_divergence`` kernel and greedy the
``feature_gains`` kernel; SS and greedy then run once more on the plain
backend under the same draws, and the example reports whether V' and the
picks are the same on both routes (``cuda vs reference``).

    PYTHONPATH=src python examples/video_summarize_torch.py [--frames 2000]
    PYTHONPATH=src python examples/video_summarize_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import feature_coverage_from_numpy, greedy, ss_sparsify
from repro_torch.configs.paper_ss import DEFAULT
from repro_torch.data import video
from repro_torch.data.video_eval import frame_f1, novelty_reference
from repro_torch.device import resolve_device


def _timed(dev: torch.device, call):
    """(result, seconds) on the host clock, synchronised on the card."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = call()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t


def summarize_video(X: np.ndarray, k: int, *, seed: int = 0,
                    noise: torch.Tensor | None = None, device="cuda") -> dict:
    """Greedy on all n frames of ``X`` (n, F) at budget ``k``; SS (the
    paper's r and c, ``configs/paper_ss.py``) then greedy on V'; the frame
    F1 of greedy, SS and the first k frames against ``novelty_reference``.

    SS draws from a generator on the device seeded with ``seed``, or takes
    ``noise`` (max_rounds, n) in its place.  On the card, SS and greedy run
    again through the plain backend under the same draws; ``parity`` says
    which results the two routes share (None on the CPU, where both are the
    plain route)."""
    dev = resolve_device(device)
    n = len(X)
    fn = feature_coverage_from_numpy(X, phi=DEFAULT.phi, device=dev)

    def draws():
        if noise is not None:
            return {"noise": noise}
        return {"generator": torch.Generator(device=dev).manual_seed(seed)}

    def run_ss(backend=None):
        ss = ss_sparsify(fn, r=DEFAULT.r, c=DEFAULT.c, backend=backend, **draws())
        return ss, greedy(fn, k, alive=ss.vprime, backend=backend)

    full, t_full = _timed(dev, lambda: greedy(fn, k))
    (ss, red), t_ss = _timed(dev, run_ss)
    ref = novelty_reference(X, DEFAULT.summary_frac)
    picks = {"greedy": full.selected.cpu().numpy(), "ss": red.selected.cpu().numpy(),
             "first15%": np.arange(k)}
    out = {"fn": fn, "k": k, "full": full, "ss": ss, "reduced": red,
           "t_full": t_full, "t_ss": t_ss, "reference": ref,
           "vprime_size": int(ss.vprime.sum()),
           "relative": float(red.value / full.value),
           "f1": {name: frame_f1(sel, ref, n) for name, sel in picks.items()},
           "parity": None}
    if dev.type == "cuda":
        full_p = greedy(fn, k, backend="reference")
        ss_p, red_p = run_ss("reference")
        out["parity"] = {
            "greedy_v": torch.equal(full.selected, full_p.selected),
            "vprime": torch.equal(ss.vprime, ss_p.vprime),
            "greedy_vprime": torch.equal(red.selected, red_p.selected),
            "plain_values": (float(full_p.value), float(red_p.value))}
    return out


def main(argv=None, results: dict | None = None) -> int:
    """The example's command line; ``results``, where given, receives
    :func:`summarize_video`'s dictionary."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    X = video(args.seed, args.frames, n_features=256)
    k = int(DEFAULT.summary_frac * args.frames)
    print(f"video: {args.frames} frames, budget k = {k} (15%) on {dev}")
    out = summarize_video(X, k, seed=args.seed, device=dev)
    nv = out["vprime_size"]
    print(f"greedy: f={float(out['full'].value):.3f}  {out['t_full']:.2f}s")
    print(f"SS:     f={float(out['reduced'].value):.3f}  {out['t_ss']:.2f}s  "
          f"|V'|={nv} ({100 * nv / args.frames:.0f}% kept)")
    print(f"relative utility: {out['relative']:.4f}")
    for name, f1 in out["f1"].items():
        print(f"  F1 vs reference [{name:9s}]: {f1:.3f}")
    par = out["parity"]
    if par is None:
        print("cuda vs reference:  not run (the cuda backend needs a card)")
    else:
        same = [what for what in ("vprime", "greedy_v", "greedy_vprime") if par[what]]
        differ = [what for what in ("vprime", "greedy_v", "greedy_vprime")
                  if not par[what]]
        print(f"cuda vs reference:  same {', '.join(same) or 'nothing'}"
              + (f"; differ: {', '.join(differ)}" if differ else "")
              + f"; plain f(S) {par['plain_values'][0]:.3f} / "
              f"{par['plain_values'][1]:.3f}")
    for name in ("full", "reduced"):
        sel = out[name].selected
        assert sel.shape == (k,) and bool(torch.isfinite(out[name].value)), name
    if results is not None:
        results.update(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
