"""Time sieve streaming on this tree against other trees' (a parent's, a
variant's), on one card.

    git archive <parent commit> | tar -x -C build/parent   # a directory git ignores
    python3 chip_ab_sieve.py [--rates] build/parent [build/variant ...]

From the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit.  Every tree builds its own kernels (all at once, before any
timing), and each tree runs in a process of its own, with its own package,
in turns: this tree and the others in order, then in reverse (this,
parent, parent, this for one other tree).  At ``chip_smoke.py``'s
full-size objectives (FeatureCoverage over news_day(0, 2^20, 1024); path
A, dense FL over video(0, 2^16, 256), cosine; path B, matrix-free FL over
clustered_embeddings(0, 2^18, 16), dot) a process runs
``sieve_streaming(fn, 32)`` (the legacy 50 thresholds) once to warm up,
three times for the synchronised wall (median), and once under the
profiler for the device time of the sieve table's kernels (every kernel
whose name holds ``sieve``): the kernels on the sieve's own mix of
launches.  Then ``sieve_gains`` alone at the path's record shape (the
empty state and the 50 states of a finished run against the largest
chunk), timed by CUDA events (median of 5 windows of 20 launches).  All
trees must select the same elements (one summation order: the same table
bits).

``--rates`` first times the card's float32 issue rates for max, add and
the two alternating (the facility-location term's FMNMX and FADD): 32
independent chains a thread in inline PTX, 8 blocks of 256 threads an SM,
built from the source in this file into ``build/issue_rate``.

The last line is one JSON object of the figures; the script exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
K = 32

ISSUE_RATE_CU = r"""
template <int OP>
__global__ void __launch_bounds__(256) issue_rate(int iters, float* out) {
  float x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = static_cast<float>(threadIdx.x + i);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const float y = __int_as_float(0x3f800000 | it);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (OP == 0 || (OP == 2 && i % 2 == 0)) {
        asm volatile("max.f32 %0, %0, %1;" : "+f"(x[i]) : "f"(y));
      } else {
        asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(x[i]) : "f"(y));
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s += x[i];
  if (s == -1.f) out[0] = s;
}

extern "C" int issue_rate_launch(int op, int blocks, int iters, float* out) {
  if (op == 0) issue_rate<0><<<blocks, 256>>>(iters, out);
  else if (op == 1) issue_rate<1><<<blocks, 256>>>(iters, out);
  else issue_rate<2><<<blocks, 256>>>(iters, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def issue_rates() -> dict:
    """Lanes a clock an SM that the card issues for max, add and both."""
    import torch

    out_dir = ROOT / "build" / "issue_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "issue_rate.cu").write_text(ISSUE_RATE_CU)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-gencode", "arch=compute_90a,code=sm_90a", "-o",
                    str(out_dir / "libissue_rate.so"), str(out_dir / "issue_rate.cu")],
                   check=True, timeout=300)
    lib = ctypes.CDLL(str(out_dir / "libissue_rate.so"))
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    clk = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout.split()[0]) * 1e6
    sink = torch.zeros(1, device="cuda")
    blocks, iters = sms * 8, 1 << 14
    rates = {}
    for op, name in enumerate(("max", "add", "max+add")):
        ms = []
        for _ in range(4):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            assert lib.issue_rate_launch(op, blocks, iters, ctypes.c_void_p(sink.data_ptr())) == 0
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        t = statistics.median(ms[1:])
        rates[name] = blocks * 256 * iters * 32 / (t * 1e-3) / sms / clk
    return rates


def _objectives():
    import torch
    from repro_torch import (
        StreamingFacilityLocation, clustered_embeddings, facility_location_from_features,
        feature_coverage_from_numpy, news_day, video,
    )

    yield "FeatureCoverage", lambda: feature_coverage_from_numpy(news_day(0, 1 << 20, 1024))
    yield "path A", lambda: facility_location_from_features(video(0, 1 << 16, 256), "cosine",
                                                            n_threshold=None)
    yield "path B", lambda: StreamingFacilityLocation.from_features(
        torch.from_numpy(clustered_embeddings(0, 1 << 18, 16)).cuda(), "dot")


def record_ms(fn) -> float:
    """sieve_gains at the path's record shape: median of 5 windows of 20
    launches, by CUDA events."""
    import torch

    from repro_torch import sieve_extend, sieve_init
    from repro_torch.core.sieve import MAX_CHUNK
    from repro_torch.kernels import sieve_gains_kernel

    states = sieve_extend(fn, sieve_init(fn, K), torch.arange(fn.n, device="cuda")).states
    C = min(fn.sieve_chunk() or MAX_CHUNK, MAX_CHUNK, fn.n)
    el = fn.sieve_elements(torch.arange(C, device="cuda"))
    rows = torch.cat([torch.zeros_like(states[:1]), states]).contiguous()
    sieve_gains_kernel(rows, el)
    ms = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            sieve_gains_kernel(rows, el)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b) / 20)
    return statistics.median(ms)


def run(tree: Path) -> dict:
    """One tree's figures, in this process."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch import sieve_streaming
    from repro_torch.kernels import load_library

    load_library()
    out = {}
    for label, make in _objectives():
        fn = make()
        res = sieve_streaming(fn, K)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = sieve_streaming(fn, K)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            sieve_streaming(fn, K)
            torch.cuda.synchronize()
        sieve_ms = sum(e.self_device_time_total for e in prof.key_averages()
                       if "sieve" in e.key) / 1e3
        out[label] = {"wall_s": statistics.median(walls), "walls_s": walls,
                      "sieve_kernels_ms": sieve_ms, "record_ms": record_ms(fn),
                      "selected": res.selected.tolist()}
        del fn, res
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if "--run" in sys.argv:
        print(json.dumps(run(Path(sys.argv[sys.argv.index("--run") + 1]).resolve())))
        return 0
    if "--build" in sys.argv:
        sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--build") + 1]).resolve() / "src"))
        from repro_torch.kernels import build

        build(force=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_ab_sieve: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    figures = {}
    if "--rates" in sys.argv:
        figures["issue_rates"] = issue_rates()
        print("issue rates (lanes a clock an SM): " + ", ".join(
            f"{k} {v:.2f}" for k, v in figures["issue_rates"].items()), flush=True)
    others = [Path(a).resolve() for a in sys.argv[1:] if not a.startswith("--")]
    trees = [ROOT] + others
    names = {ROOT: "this"} | {t: t.name for t in others}
    t0 = time.perf_counter()
    builds = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--build",
                                str(t)]) for t in trees]
    if any(p.wait(timeout=900) != 0 for p in builds):
        print("chip_ab_sieve: a build failed", file=sys.stderr)
        return 1
    print(f"built {len(trees)} trees in {time.perf_counter() - t0:.1f} s", flush=True)
    runs = []
    for tree in trees + trees[::-1]:
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--run",
                            str(tree)], capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            return 1
        figs = json.loads(p.stdout.strip().splitlines()[-1])
        runs.append((names[tree], figs))
        for label, f in figs.items():
            print(f"{names[tree]:8s} {label:16s} wall {f['wall_s']:.4f} s (runs "
                  f"{', '.join(f'{w:.4f}' for w in f['walls_s'])}), the sieve's "
                  f"kernels {f['sieve_kernels_ms']:.4f} ms, record shape "
                  f"{f['record_ms']:.4f} ms", flush=True)
    first = runs[0][1]
    same = all(f[label]["selected"] == first[label]["selected"]
               for _, f in runs for label in first)
    print(f"every tree selects the same elements on every path: {same}", flush=True)
    figures["runs"] = [[n, {k: {kk: vv for kk, vv in v.items() if kk != "selected"}
                            for k, v in f.items()}] for n, f in runs]
    figures["same_selections"] = same
    print(json.dumps(figures))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
