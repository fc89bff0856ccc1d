"""Roofline terms of a counted step on H100 cards, and the dry run's table:
the counterpart of ``repro/launch/hlo_analysis.py``'s ``roofline`` and of
``repro/launch/roofline.py``.

    PYTHONPATH=src python -m repro_torch.launch.roofline
    PYTHONPATH=src python -m repro_torch.launch.roofline --mesh single --markdown

reads the dry run's cache of a mesh (``python -m repro_torch.launch.dryrun``
writes it) and prints a row a cell.  ``roofline%`` is the model's FLOPs
over the bf16 peak times the bound (the ``mfu`` the step would reach at its
bound), ``useful%`` the model's FLOPs over the counted ones.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.mesh import HW, PEAK_BY_DTYPE

ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                    "dryrun_torch")
#: the cache of each mesh: one card, and the reference's two production meshes
MESH_DIRS = {"1x1": "h100", "single": "single_16x16", "multipod": "multipod_2x16x16"}
RESULTS = os.path.join(ROOT, MESH_DIRS["1x1"])


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
    pod_fraction: float = 0.0,   # fraction of collective bytes between nodes
) -> dict:
    """The reference's three terms, keys and bound.  ``flops_per_chip`` is
    a number or a {dtype: FLOPs} dict (``compute_seconds``).  The
    collective term is the bytes inside a node over ``hw["nvlink_bw"]``
    plus the bytes between nodes (``pod_fraction`` of them) over
    ``hw["internode_bw"]``.  The reference guessed its fraction (half the
    all-reduce bytes, as if the pod axis were pure data parallelism); the
    dry run computes it from the groups that each collective ran over
    (``launch/dryrun.py``).  No collective bytes, no term (and ``hw`` then
    needs no link rates)."""
    compute_s = compute_seconds(flops_per_chip, hw)
    memory_s = bytes_per_chip / hw["hbm_bw"]
    collective_s = 0.0
    if coll_bytes_per_chip:
        collective_s = (coll_bytes_per_chip * (1.0 - pod_fraction) / hw["nvlink_bw"]
                        + coll_bytes_per_chip * pod_fraction / hw["internode_bw"])
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


_OP_TAG = {"all-gather": "ag", "all-reduce": "ar", "reduce-scatter": "rs",
           "all-to-all": "a2a", "collective-permute": "cp"}


def table(recs: list[dict], markdown: bool = False) -> str:
    rows = []
    hdr = ["arch", "shape", "FLOPs", "bytes", "coll bytes", "coll GB by op",
           "inter-node", "compute", "memory", "collective", "dominant", "roofline%",
           "useful%", "stateGB", "peakGB", "fits", "count s"]
    for r in recs:
        if r.get("status") == "skipped":
            rows.append([r["arch"], r["shape"]] + ["—"] * 8 + ["skip"]
                        + ["—"] * 6)
            continue
        if r.get("status") != "ok":
            rows.append([r["arch"], r["shape"], "ERR"] + [""] * 14)
            continue
        rl, mem, c = r["roofline"], r["memory"], r["cost"]
        by_op = " ".join(f"{_OP_TAG[op]} {b / 1e9:.3g}"
                         for op, b in sorted(c.get("collectives", {}).items())) or "—"
        rows.append([
            r["arch"], r["shape"],
            f"{c['flops_per_chip']:.3e}", f"{c['bytes_per_chip']:.3e}",
            f"{c['collective_bytes_per_chip']:.3e}", by_op,
            f"{c.get('internode_fraction', 0.0):.2f}",
            _fmt_s(rl["compute_s"]), _fmt_s(rl["memory_s"]),
            _fmt_s(rl["collective_s"]), rl["dominant"],
            f"{100 * mfu(r['model_flops_per_chip'], rl['step_time_lower_bound_s']):.1f}",
            f"{100 * r['useful_flops_ratio']:.0f}",
            f"{mem['analytic_state_bytes'] / 1e9:.2f}",
            f"{mem['peak_bytes'] / 1e9:.2f}",
            "y" if mem["fits_80gb"] else "N",
            f"{r['count_s']:.1f}",
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
    ap.add_argument("--mesh", default="1x1", choices=list(MESH_DIRS))
    ap.add_argument("--results", default=None)
    args = ap.parse_args(argv)
    recs = load_records(args.results or os.path.join(ROOT, MESH_DIRS[args.mesh]))
    if not recs:
        print(f"no dry-run results; run `python -m repro_torch.launch.dryrun --mesh "
              f"{args.mesh}` first")
        return 1
    chips = next((r["chips"] for r in recs if "chips" in r), 1)
    print(f"# Roofline — {chips} NVIDIA H100 SXM, per card (published figures: bf16 "
          f"{HW['peak_flops_bf16']:.3g} FLOP/s at 700 W, float32 "
          f"{HW['peak_flops_f32']:.3g} FLOP/s, HBM {HW['hbm_bw']:.3g} B/s, "
          f"{HW['hbm_per_chip'] / 1e9:.0f} GB, NVLink {HW['nvlink_bw']:.3g} B/s, "
          f"between nodes {HW['internode_bw']:.3g} B/s)")
    print(table(recs, markdown=args.markdown))
    print("\nroofline% = MODEL_FLOPs / (bf16 peak × bound); useful% = MODEL_FLOPs / "
          "counted FLOPs (remat, attention, the lm head); coll bytes = the "
          "collectives' operand bytes (by op: ag all-gather, ar all-reduce, rs "
          "reduce-scatter, a2a all-to-all); inter-node = their share between nodes; "
          "stateGB = the step's arguments; peakGB = the most live bytes; fits = peak "
          "under 80 GB; count s = host seconds to count.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
