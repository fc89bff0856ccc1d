"""Time this tree's FeatureCoverage kernels against a parent tree's, on one card.

    git archive <parent commit> | tar -x -C build/parent   # a directory git ignores
    python3 chip_ab.py build/parent

From the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit.  It builds the parent tree's ``csrc/ss_divergence.cu`` and
``csrc/feature_gains.cu`` (with that tree's ``common.cuh``) into a library
of their own, beside this tree's kernels, and calls the parent's through
their C interface as the first design had it (``ss_divergence_launch``
without a scratch argument).  At the FeatureCoverage main path's shapes
(``chip_smoke.py``: news_day(0, 2^20, 1024), r = c = 8, k = 32, seed 0) it
times, in 10 pairs of runs with the parent first in every other pair:

- ``ss_divergence`` at SS round 1, on news_day's W and on a dense random W
  of the same shape;
- ``feature_gains`` at full width (greedy on V) and over the V' of
  ``summarize`` (its compact buffer of 2048 slots).

Every time follows ``chip_smoke.kernel_ms``, the rule of every record there,
so both trees are measured alike.  Both trees' outputs are held to the plain
versions at ``chip_smoke.TOL``.  The last line is one JSON object of the
times; the script exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402  (the shared timing rule and checks)

SOURCES = ("ss_divergence.cu", "feature_gains.cu")
PAIRS = 10  # runs of each tree, in pairs; each run is one kernel_ms time


def build_parent(parent: Path) -> ctypes.CDLL:
    """The parent's two FeatureCoverage sources, compiled as this tree's
    build compiles its own, linked into ``<parent>/build/ab/libparent_fc.so``."""
    from repro_torch.kernels import _build

    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    out = parent / "build" / "ab"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    objs = [out / (Path(s).stem + ".o") for s in SOURCES]
    _build._run_all([
        [nvcc, *_build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c",
         str(csrc / s), "-o", str(o)]
        for s, o in zip(SOURCES, objs)
    ])
    lib_path = out / "libparent_fc.so"
    _build._run_all([[nvcc, *_build.ARCH, "-shared", "-o", str(lib_path),
                      *map(str, objs)]])
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ss_divergence_launch.argtypes = [p, i, ll, i, p, ll, p, p, p, i, p, p, i,
                                         p, p]
    lib.ss_divergence_launch.restype = i
    lib.feature_gains_launch.argtypes = [p, i, ll, i, p, ll, p, p, p, p, i, p, p]
    lib.feature_gains_launch.restype = i
    return lib


def parent_calls(lib: ctypes.CDLL):
    """The parent's kernels on float32 W, phi = sqrt, no cap and no feature
    weights, as the main path calls them."""
    def stream():
        return torch.cuda.current_stream().cuda_stream

    def ss(W, CU, phi_cu, resid):
        out = torch.empty((W.shape[0],), device=W.device)
        rc = lib.ss_divergence_launch(
            W.data_ptr(), 0, W.shape[0], W.shape[1], None, W.shape[0],
            CU.data_ptr(), phi_cu.data_ptr(), resid.data_ptr(), CU.shape[0],
            None, None, 0, out.data_ptr(), stream())
        cs.check(rc == 0, f"parent ss_divergence: CUDA error {rc}")
        return out

    def gains(W, c, phi_c, cand_idx=None):
        n_out = W.shape[0] if cand_idx is None else cand_idx.shape[0]
        out = torch.empty((n_out,), device=W.device)
        rc = lib.feature_gains_launch(
            W.data_ptr(), 0, W.shape[0], W.shape[1],
            None if cand_idx is None else cand_idx.data_ptr(), n_out,
            c.data_ptr(), phi_c.data_ptr(), None, None, 0, out.data_ptr(), stream())
        cs.check(rc == 0, f"parent feature_gains: CUDA error {rc}")
        return out

    return ss, gains


def in_pairs(what: str, old, new, iters: int, bound_ms: float, ref, scale: float,
             pairs: int = PAIRS):
    """Both trees' call, each held to the plain output `ref` within
    TOL x scale, then timed in `pairs` pairs, the parent first in every
    other pair.  Returns the record of `what`: each side's median, the
    pairs this tree won, and the spread of the parent's own times (the
    distance between their quartiles)."""
    tol = cs.TOL[torch.float32] * scale
    for tree, fn in (("parent", old), ("this tree", new)):
        err = float((fn() - ref).abs().max())
        cs.check(err <= tol, f"{what}, {tree}: err {err} > {tol}")
    olds, news = [], []
    for i in range(pairs):
        order = ((olds, old), (news, new)) if i % 2 == 0 else ((news, new), (olds, old))
        for times, fn in order:
            times.append(cs.kernel_ms(fn, iters)[1])
    q = statistics.quantiles([t.ms for t in olds], n=4)
    rec = {"parent_ms": statistics.median(t.ms for t in olds),
           "ms": statistics.median(t.ms for t in news),
           "wins": sum(n.ms < o.ms for o, n in zip(olds, news)), "pairs": pairs,
           "parent_spread_ms": q[2] - q[0],
           "parent_runs_ms": [t.ms for t in olds], "runs_ms": [t.ms for t in news],
           "queued": {"parent": sum(t.queued for t in olds),
                      "this_tree": sum(t.queued for t in news)},
           "host_ms_per_call": {"parent": statistics.median(t.host_ms for t in olds),
                                "this_tree": statistics.median(t.host_ms for t in news)},
           "bound_ms": bound_ms}
    print(f"{what}: parent {rec['parent_ms']:.4f} ms, this tree {rec['ms']:.4f} "
          f"ms per launch (medians of {pairs} runs each; this tree faster in "
          f"{rec['wins']} of {pairs} pairs; the parent's spread "
          f"{rec['parent_spread_ms']:.4f} ms; runs queued on the card: parent "
          f"{rec['queued']['parent']}, this tree {rec['queued']['this_tree']}), "
          f"bound {bound_ms:.4f} ms (share: parent "
          f"{bound_ms / rec['parent_ms']:.4f}, this tree {bound_ms / rec['ms']:.4f}); "
          f"runs: parent {', '.join(f'{t.ms:.4f}' for t in olds)}; this tree "
          f"{', '.join(f'{t.ms:.4f}' for t in news)}", flush=True)
    return rec


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: python3 chip_ab.py <parent tree>, on a CUDA card",
              file=sys.stderr)
        return 2
    parent = Path(sys.argv[1]).resolve()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cs.card_rates()

    from repro_torch import (
        feature_coverage_from_numpy, greedy, news_day, summarize,
    )
    from repro_torch.core.greedy import compact_indices, selection_bucket
    from repro_torch.core.sparsify import gumbel, probe_count
    from repro_torch.kernels import (
        build, feature_gains_kernel, feature_gains_ref, load_library,
        ss_divergence_kernel, ss_divergence_ref,
    )

    t = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        old_lib = pool.submit(build_parent, parent)
        pool.submit(build, True).result()
        old_lib = old_lib.result()
    load_library()
    print(f"build of both trees: {time.perf_counter() - t:.2f} s", flush=True)
    old_ss, old_gains = parent_calls(old_lib)

    N, F, K, R, C = cs.N, cs.F, cs.K, cs.R, cs.C
    fn = feature_coverage_from_numpy(news_day(0, N, F))
    full = greedy(fn, K)
    res, ss = summarize(fn, K, torch.Generator(device="cuda").manual_seed(0),
                        r=R, c=C)
    m = probe_count(N, R)
    probes = torch.topk(gumbel(N, torch.Generator(device="cuda").manual_seed(0),
                               "cuda"), m).indices
    CU = fn.W[probes].contiguous()
    phi_cu = torch.sqrt(CU).sum(-1)
    resid = fn.residual_gains()[probes].contiguous()
    scale = max(1.0, float(phi_cu.abs().max()) + float(resid.abs().max()))
    nnz = int(torch.count_nonzero(fn.W))
    records = {}

    records["ss_divergence_round1"] = in_pairs(
        f"ss_divergence, round 1 ({N} x {m} x {F}, {nnz} nonzeros)",
        lambda: old_ss(fn.W, CU, phi_cu, resid),
        lambda: ss_divergence_kernel(fn.W, CU, phi_cu, resid), 3,
        cs.ss_bounds(N, F, m, nnz)[0], ss_divergence_ref(fn.W, CU, phi_cu, resid),
        scale)

    state_half = fn.W[full.selected[: K // 2]].sum(0)
    phi_c = torch.sqrt(state_half).sum()
    records["feature_gains_full_width"] = in_pairs(
        f"feature_gains, full width ({N} x {F})",
        lambda: old_gains(fn.W, state_half, phi_c),
        lambda: feature_gains_kernel(fn.W, state_half, phi_c), 10,
        cs.gains_bounds(N, F, nnz, N * F * 4)[0],
        feature_gains_ref(fn.W, state_half, phi_c), max(1.0, float(phi_c)))

    size = selection_bucket(N, int(ss.vprime.sum()))
    cs.check(size is not None, "V' does not fit a compact bucket")
    cand_vp = compact_indices(ss.vprime, size)
    state_red = res.state.float().contiguous()
    phi_red = torch.sqrt(state_red).sum()
    nnz_vp = int(torch.count_nonzero(fn.W[cand_vp]))
    records["feature_gains_vprime"] = in_pairs(
        f"feature_gains over V' ({size} slots, {nnz_vp} nonzeros)",
        lambda: old_gains(fn.W, state_red, phi_red, cand_vp),
        lambda: feature_gains_kernel(fn.W, state_red, phi_red, cand_idx=cand_vp),
        200, cs.gains_bounds(size, F, nnz_vp, size * (F * 4 + 8))[0],
        feature_gains_ref(fn.W, state_red, phi_red, cand_idx=cand_vp),
        max(1.0, float(phi_red)))

    del fn
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(7)
    Wd = torch.rand((N, F), generator=g, device="cuda")
    CU = Wd[torch.randint(0, N, (m,), generator=g, device="cuda")].contiguous()
    phi_cu = torch.sqrt(CU).sum(-1)
    resid = torch.rand((m,), generator=g, device="cuda")
    records["ss_divergence_dense_w"] = in_pairs(
        f"ss_divergence on a dense random W ({N} x {m} x {F})",
        lambda: old_ss(Wd, CU, phi_cu, resid),
        lambda: ss_divergence_kernel(Wd, CU, phi_cu, resid), 1,
        cs.ss_bounds(N, F, m, N * F)[0], ss_divergence_ref(Wd, CU, phi_cu, resid),
        max(1.0, float(phi_cu.abs().max()) + float(resid.abs().max())))

    print(json.dumps({"card": smi, "ab": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
