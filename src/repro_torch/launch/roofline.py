"""Roofline terms of a counted step on one H100, and the dry run's table:
the counterpart of ``repro/launch/hlo_analysis.py``'s ``roofline`` and of
``repro/launch/roofline.py``.

    PYTHONPATH=src python -m repro_torch.launch.roofline
    PYTHONPATH=src python -m repro_torch.launch.roofline --markdown

reads the dry run's cache (``python -m repro_torch.launch.dryrun`` writes
it) and prints a row a cell.  ``roofline%`` is the model's FLOPs over the
bf16 peak times the bound (the ``mfu`` the step would reach at its bound),
``useful%`` the model's FLOPs over the counted ones.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.mesh import HW, PEAK_BY_DTYPE

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                       "dryrun_torch", "h100")


def compute_seconds(flops, hw: dict) -> float:
    """FLOPs over their peak: a number counts at the bf16 peak (the
    reference's convention); a {dtype: FLOPs} dict sums each dtype over its
    own peak (``PEAK_BY_DTYPE``)."""
    if not isinstance(flops, dict):
        return flops / hw["peak_flops_bf16"]
    total = 0.0
    for dt, f in flops.items():
        if dt not in PEAK_BY_DTYPE:
            raise ValueError(f"no peak for products of {dt} operands")
        total += f / hw[PEAK_BY_DTYPE[dt]]
    return total


def roofline(
    flops_per_chip,
    bytes_per_chip: float,
    coll_bytes_per_chip: float,
    hw: dict,
    *,
    pod_fraction: float = 0.0,   # fraction of collective bytes on DCN links
) -> dict:
    """The reference's three terms, keys and bound.  ``flops_per_chip`` is
    a number or a {dtype: FLOPs} dict (``compute_seconds``).  One card moves
    no collective bytes: its term is 0 (and ``hw`` needs no link rates)."""
    compute_s = compute_seconds(flops_per_chip, hw)
    memory_s = bytes_per_chip / hw["hbm_bw"]
    collective_s = 0.0
    if coll_bytes_per_chip:
        collective_s = (coll_bytes_per_chip * (1.0 - pod_fraction) / hw["ici_bw"]
                        + coll_bytes_per_chip * pod_fraction / hw["dcn_bw"])
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return dict(
        terms,
        dominant=dominant.removesuffix("_s"),
        step_time_lower_bound_s=bound,
        # fraction of the bound spent doing useful math
        roofline_fraction=(compute_s / bound) if bound > 0 else 0.0,
    )


def mfu(model_flops: float, seconds: float) -> float:
    """The model's FLOPs over the card's bf16 peak for ``seconds``."""
    return model_flops / (HW["peak_flops_bf16"] * seconds)


def load_records(results: str = RESULTS) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(results, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}µs"
    if x < 1.0:
        return f"{x*1e3:.2f}ms"
    return f"{x:.2f}s"


def table(recs: list[dict], markdown: bool = False) -> str:
    rows = []
    hdr = ["arch", "shape", "FLOPs", "bytes", "compute", "memory", "collective",
           "dominant", "roofline%", "useful%", "stateGB", "peakGB", "fits"]
    for r in recs:
        if r.get("status") == "skipped":
            rows.append([r["arch"], r["shape"]] + ["—"] * 5 + ["skip"]
                        + ["—"] * 5)
            continue
        if r.get("status") != "ok":
            rows.append([r["arch"], r["shape"], "ERR"] + [""] * 10)
            continue
        rl, mem = r["roofline"], r["memory"]
        rows.append([
            r["arch"], r["shape"],
            f"{r['cost']['flops_per_chip']:.3e}", f"{r['cost']['bytes_per_chip']:.3e}",
            _fmt_s(rl["compute_s"]), _fmt_s(rl["memory_s"]),
            _fmt_s(rl["collective_s"]), rl["dominant"],
            f"{100 * mfu(r['model_flops_per_chip'], rl['step_time_lower_bound_s']):.1f}",
            f"{100 * r['useful_flops_ratio']:.0f}",
            f"{mem['analytic_state_bytes'] / 1e9:.2f}",
            f"{mem['peak_bytes'] / 1e9:.2f}",
            "y" if mem["fits_80gb"] else "N",
        ])
    widths = [max(len(str(row[i])) for row in [hdr] + rows) for i in range(len(hdr))]
    lines = []
    sep = " | " if markdown else "  "
    line = sep.join(h.ljust(w) for h, w in zip(hdr, widths))
    lines.append(("| " + line + " |") if markdown else line)
    if markdown:
        lines.append("|" + "|".join("-" * (w + 2) for w in widths) + "|")
    for row in rows:
        line = sep.join(str(c).ljust(w) for c, w in zip(row, widths))
        lines.append(("| " + line + " |") if markdown else line)
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--results", default=RESULTS)
    args = ap.parse_args(argv)
    recs = load_records(args.results)
    if not recs:
        print("no dry-run results; run `python -m repro_torch.launch.dryrun` first")
        return 1
    print("# Roofline — one NVIDIA H100 SXM (published peaks at 700 W: bf16 "
          f"{HW['peak_flops_bf16']:.3g} FLOP/s, float32 {HW['peak_flops_f32']:.3g} "
          f"FLOP/s, HBM {HW['hbm_bw']:.3g} B/s, {HW['hbm_per_chip'] / 1e9:.0f} GB)")
    print(table(recs, markdown=args.markdown))
    print("\nroofline% = MODEL_FLOPs / (bf16 peak × bound); useful% = MODEL_FLOPs / "
          "counted FLOPs (remat, attention, the lm head); stateGB = the step's "
          "arguments; peakGB = the most live bytes; fits = peak under 80 GB.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
