"""Drive the PyTorch/CUDA port on one NVIDIA card and hold it to its plain path.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit.  It builds the kernels from ``src/repro_torch/kernels/csrc``, checks
each against its plain PyTorch version over a sweep of shapes, dtypes and
options, runs the paper's main path (SS, then greedy on the pruned set V')
over FeatureCoverage on a synthetic news corpus of 2^20 sentences x 1024
features, and checks its result, its kernel launches and its agreement with
the plain path.  Then it times each kernel at the main path's shapes beside
its bound and its plain version.

The last two lines of its output are JSON: the kernels' records, then
``{"ok": true, "device": {...}}``.  Any failure raises before them, and the
script exits non-zero without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

# Main-path configuration: the paper's news setting scaled to one card.
N, F, K, R, C = 1 << 20, 1024, 32, 8, 8.0
# H100 SXM published peaks: HBM bandwidth and float32 CUDA-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Operations per (candidate, feature[, probe]) element of phi = sqrt without
# feature weights: the add c + W, the clamp at 0, the sqrt, the accumulate.
OPS_PER_ELEMENT = 4
# Tolerances of kernel vs plain, relative to the size of the sums involved.
# Both accumulate in float32, in different orders; the result is a difference
# (sum - phi_cu - resid) that cancels, so the error scales with the sums'
# size, not the result's.  1e-4 is the repository's float32 kernel tolerance;
# 3e-2 its bfloat16 one.
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
PHIS = ("sqrt", "log1p", "setcover", "satcov", "linear")


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def sync_ms(fn, iters: int) -> float:
    """Milliseconds per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plain_phi_sum(phi, X, cap, fw):
    from repro_torch.kernels.ref import _phi

    v = _phi(phi, X, cap)
    return (v if fw is None else v * fw).sum(-1)


def sweep(errs: dict) -> None:
    """Kernel vs plain on the card over phi x dtype x feat_w x cand_idx x
    ragged shapes, with a pad probe (phi_cu = -INF) in every divergence."""
    from repro_torch.kernels import (
        feature_gains_kernel, feature_gains_ref, ss_divergence_kernel,
        ss_divergence_ref,
    )

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    shapes = [(64, 32, 4), (130, 70, 9), (513, 257, 33), (1000, 1024, 40)]
    cases = 0
    for (n, f, r), phi, dt, weighted, compact in itertools.product(
        shapes, PHIS, (torch.float32, torch.bfloat16), (False, True), (False, True)
    ):
        W = torch.rand((n, f), generator=g, device=dev).to(dt)
        CU = torch.rand((r, f), generator=g, device=dev)
        resid = torch.rand((r,), generator=g, device=dev)
        fw = (torch.linspace(0.5, 1.5, f, device=dev) if weighted else None)
        cap = 0.2 * W.float().sum(0) if phi == "satcov" else None
        phi_cu = plain_phi_sum(phi, CU, cap, fw)
        phi_cu[-1] = -1e30  # a pad probe: never wins the min
        cand = (torch.randint(0, n, (n // 3 + 2,), generator=g, device=dev)
                if compact else None)
        if cand is not None:
            cand[-2:] = 0  # zero padding, as the SS loop's buffers carry
        tol = TOL[dt]
        out = ss_divergence_kernel(W, CU, phi_cu, resid, cap, fw, cand, phi=phi)
        ref = ss_divergence_ref(W, CU, phi_cu, resid, cap, phi, fw, cand)
        scale = max(1.0, float(phi_cu[:-1].abs().max()) + float(resid.abs().max()))
        err = float((out - ref).abs().max())
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"ss_divergence {phi} {dt} {n}x{f}x{r}: bad output")
        check(err <= tol * scale, f"ss_divergence {phi} {dt} {n}x{f}x{r} "
              f"fw={weighted} cand={compact}: err {err} > {tol * scale}")
        errs["ss_divergence"] = max(errs["ss_divergence"], err)

        c = CU[0]
        phi_c = plain_phi_sum(phi, c, cap, fw)
        out = feature_gains_kernel(W, c, phi_c, cap, fw, cand, phi=phi)
        ref = feature_gains_ref(W, c, phi_c, cap, phi, fw, cand)
        scale = max(1.0, float(phi_c.abs()), float(ref.abs().max()))
        err = float((out - ref).abs().max())
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"feature_gains {phi} {dt} {n}x{f}: bad output")
        check(err <= tol * scale, f"feature_gains {phi} {dt} {n}x{f} "
              f"fw={weighted} cand={compact}: err {err} > {tol * scale}")
        errs["feature_gains"] = max(errs["feature_gains"], err)
        cases += 1
    torch.cuda.synchronize()
    print(f"kernel vs plain: {cases} cases per kernel passed; max abs err "
          f"ss_divergence {errs['ss_divergence']:.3g}, feature_gains "
          f"{errs['feature_gains']:.3g}", flush=True)


def small_pipeline() -> None:
    """The whole pipeline on a small corpus, kernels vs the plain backend on
    the card, under the same draws: same V' and the same picks."""
    from repro_torch import feature_coverage_from_numpy, news_day, summarize
    from repro_torch.core.sparsify import gumbel, max_rounds

    n = 4096
    fn = feature_coverage_from_numpy(news_day(0, n, 512))
    g = torch.Generator(device="cuda").manual_seed(1)
    noise = torch.stack([gumbel(n, g, "cuda") for _ in range(max_rounds(n, R, C))])
    res_k, ss_k = summarize(fn, 10, r=R, c=C, noise=noise)
    res_p, ss_p = summarize(fn, 10, r=R, c=C, noise=noise, backend="reference")
    check(torch.equal(ss_k.vprime, ss_p.vprime), "small SS: V' differs")
    check(torch.equal(res_k.selected, res_p.selected), "small greedy: picks differ")
    check(abs(float(res_k.value) - float(res_p.value)) <= 1e-5 * float(res_p.value),
          "small summarize: values differ")
    print(f"small summarize (n={n}): cuda == reference, |V'| = "
          f"{int(ss_k.vprime.sum())}, f(S') = {float(res_k.value):.6f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import (
        feature_coverage_from_numpy, greedy, news_day, ss_sparsify, summarize,
    )
    from repro_torch.core.greedy import compact_indices, selection_bucket
    from repro_torch.core.sparsify import bucket_schedule, gumbel, probe_count
    from repro_torch.kernels import (
        build, feature_gains_kernel, feature_gains_ref, load_library,
        ss_divergence_kernel, ss_divergence_ref,
    )

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}",
          flush=True)

    # 2. the build, from the sources in this checkout
    t = time.perf_counter()
    build(force=True)
    load_library()
    print(f"build: {time.perf_counter() - t:.2f} s (nvcc, sm_90a, one process "
          "per source)", flush=True)

    # 3. kernel vs plain, and the small pipeline
    errs = {"ss_divergence": 0.0, "feature_gains": 0.0}
    sweep(errs)
    small_pipeline()

    # 4. the main path at full size
    t = time.perf_counter()
    W_np = news_day(0, N, F)
    t_host = time.perf_counter() - t
    t = time.perf_counter()
    fn = feature_coverage_from_numpy(W_np)
    torch.cuda.synchronize()
    del W_np
    print(f"news_day(0, {N}, {F}) float32: host set-up {t_host:.2f} s, to card "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()

    counts = {}

    def reset():
        ss_divergence_kernel.launches = 0
        feature_gains_kernel.launches = 0

    def read(path):
        counts[path] = {"ss_divergence": ss_divergence_kernel.launches,
                        "feature_gains": feature_gains_kernel.launches}

    reset()
    t = time.perf_counter()
    full = greedy(fn, K)
    f_full = float(full.value)
    wall_full = time.perf_counter() - t
    read("greedy_on_V")

    reset()
    t = time.perf_counter()
    res, ss = summarize(fn, K, torch.Generator(device="cuda").manual_seed(0),
                        r=R, c=C)
    f_red = float(res.value)
    wall_sum = time.perf_counter() - t
    read("summarize")
    peak = torch.cuda.max_memory_allocated() / 2**30

    nv = int(ss.vprime.sum())
    rel = f_red / f_full
    print(f"greedy on V: f(S) = {f_full:.6f}, wall {wall_full:.4f} s")
    print(f"summarize: rounds = {ss.rounds}, |V'| = {nv}, eps_hat = "
          f"{float(ss.eps_hat):.6f}, f(S') = {f_red:.6f}, relative = {rel:.6f}, "
          f"wall {wall_sum:.4f} s")
    print(f"launches: {json.dumps(counts)}; peak device memory {peak:.2f} GiB",
          flush=True)
    for r_ in (full, res):
        check(r_.selected.shape == (K,) and bool(torch.isfinite(r_.gains).all()),
              "greedy result has the wrong shape or non-finite gains")
        check(int(r_.selected.unique().numel()) == K, "greedy picked twice")
    check(bool(ss.vprime[res.selected].all()), "greedy on V' left V'")
    check(0 < nv < N and ss.rounds > 0, "SS pruned nothing or everything")
    check(rel >= 0.95, f"relative quality {rel} < 0.95")
    for kern in ("ss_divergence", "feature_gains"):
        check(counts["summarize"][kern] > 0, f"the main path never launched {kern}")

    # 5. the plain route on the card for the same work
    m = probe_count(N, R)
    g1 = gumbel(N, torch.Generator(device="cuda").manual_seed(0), "cuda")
    probes = torch.topk(g1, m).indices          # round 1's draw, as SS took it
    residual = fn.residual_gains()
    CU = fn.W[probes].contiguous()
    phi_cu = torch.sqrt(CU).sum(-1)
    resid = residual[probes].contiguous()
    scale = max(1.0, float(phi_cu.abs().max()) + float(resid.abs().max()))
    div_k = ss_divergence_kernel(fn.W, CU, phi_cu, resid)
    div_p = ss_divergence_ref(fn.W, CU, phi_cu, resid)
    err = float((div_k - div_p).abs().max())
    check(err <= TOL[torch.float32] * scale,
          f"round 1 divergence: kernel vs plain err {err}")
    errs["ss_divergence"] = max(errs["ss_divergence"], err)
    cand_mid = torch.randperm(N, device="cuda")[: bucket_schedule(N, C)[1]]
    err = float((ss_divergence_kernel(fn.W, CU, phi_cu, resid, cand_idx=cand_mid)
                 - div_p[cand_mid]).abs().max())
    check(err <= TOL[torch.float32] * scale, f"round 2 shape divergence err {err}")
    errs["ss_divergence"] = max(errs["ss_divergence"], err)

    state_half = fn.W[full.selected[: K // 2]].sum(0)
    phi_c = torch.sqrt(state_half).sum()
    gk = feature_gains_kernel(fn.W, state_half, phi_c)
    gp = feature_gains_ref(fn.W, state_half, phi_c)
    err = float((gk - gp).abs().max())
    check(err <= TOL[torch.float32] * max(1.0, float(phi_c)),
          f"full-width gains err {err}")
    errs["feature_gains"] = max(errs["feature_gains"], err)
    size = selection_bucket(N, nv)
    check(size is not None, "V' does not fit a compact bucket")
    cand_vp = compact_indices(ss.vprime, size)
    state_red = res.state.float().contiguous()
    phi_red = torch.sqrt(state_red).sum()
    err = float((feature_gains_kernel(fn.W, state_red, phi_red, cand_idx=cand_vp)
                 - feature_gains_ref(fn.W, state_red, phi_red, cand_idx=cand_vp))
                .abs().max())
    check(err <= TOL[torch.float32] * max(1.0, float(phi_red)),
          f"compact gains err {err}")
    errs["feature_gains"] = max(errs["feature_gains"], err)

    ref_res = greedy(fn, K, alive=ss.vprime, backend="reference")
    check(torch.equal(ref_res.selected, res.selected),
          "greedy on V' through the plain backend picks another set")
    print("main-path shapes: kernels match their plain versions (round 1 and a "
          "round-2-sized buffer; full-width and V' gains); greedy on V' selects "
          "the same set through the reference backend", flush=True)

    # 6. times at the main path's shapes
    records = []
    ms = sync_ms(lambda: ss_divergence_kernel(fn.W, CU, phi_cu, resid), 5)
    plain_ms = sync_ms(lambda: ss_divergence_ref(fn.W, CU, phi_cu, resid), 1)
    b_ms, b_by = bound(N * F * 4 + m * F * 4 + 2 * m * 4 + N * 4,
                       N * m * F * OPS_PER_ELEMENT + 3 * N * m)
    print(f"ss_divergence, round 1 ({N} candidates x {m} probes x {F} features, "
          f"{OPS_PER_ELEMENT} ops per element): {ms:.4f} ms per launch, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library none; "
          f"{counts['summarize']['ss_divergence']} launches in summarize")
    records.append({
        "name": "ss_divergence", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ss_divergence.cu",
        "replaces": "src/repro/kernels/ss_weights.py:114",
        "launches": counts["summarize"]["ss_divergence"],
        "max_abs_err": errs["ss_divergence"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })

    ms_full = sync_ms(lambda: feature_gains_kernel(fn.W, state_half, phi_c), 20)
    plain_full = sync_ms(lambda: feature_gains_ref(fn.W, state_half, phi_c), 3)
    bf_ms, bf_by = bound(N * F * 4 + F * 4 + 4 + N * 4, N * F * OPS_PER_ELEMENT + N)
    print(f"feature_gains, full width (greedy on V, {N} x {F}): {ms_full:.4f} ms "
          f"per launch, plain {plain_full:.4f} ms, bound {bf_ms:.4f} ms "
          f"({bf_by}); {counts['greedy_on_V']['feature_gains']} launches")
    ms = sync_ms(lambda: feature_gains_kernel(
        fn.W, state_red, phi_red, cand_idx=cand_vp), 200)
    plain_ms = sync_ms(lambda: feature_gains_ref(
        fn.W, state_red, phi_red, cand_idx=cand_vp), 20)
    b_ms, b_by = bound(size * (F * 4 + 8 + 4) + F * 4 + 4,
                       size * F * OPS_PER_ELEMENT + size)
    print(f"feature_gains in summarize (greedy on V': {size} slots x {F}): "
          f"{ms:.4f} ms per launch, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), library none; {counts['summarize']['feature_gains']} launches")
    records.append({
        "name": "feature_gains", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/feature_gains.cu",
        "replaces": "src/repro/kernels/feature_gains.py:61",
        "launches": counts["summarize"]["feature_gains"],
        "max_abs_err": errs["feature_gains"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "full_width": {"ms": ms_full, "plain_ms": plain_full, "bound_ms": bf_ms,
                       "bound_by": bf_by,
                       "launches": counts["greedy_on_V"]["feature_gains"]},
    })
    check(all(math.isfinite(r_[k]) for r_ in records
              for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")),
          "a measurement is not finite")

    # 7. where the time goes: the same run again, warm, split by stage and
    # then under the profiler for device time by kernel.
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ss2 = ss_sparsify(fn, gen, r=R, c=C)
    torch.cuda.synchronize()
    wall_ss = time.perf_counter() - t
    t = time.perf_counter()
    res2 = greedy(fn, K, alive=ss2.vprime)
    torch.cuda.synchronize()
    wall_gr = time.perf_counter() - t
    check(torch.equal(res2.selected, res.selected), "a rerun of the path differs")
    print(f"warm rerun: SS wall {wall_ss:.4f} s, greedy on V' wall {wall_gr:.4f} s "
          "(host clock, synchronised)")
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        t = time.perf_counter()
        summarize(fn, K, torch.Generator(device="cuda").manual_seed(0), r=R, c=C)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t
    # Device-side events only: a PyTorch operator also reports its kernels'
    # time as its own, and would count them twice.
    by_kernel = sorted(
        ((e.self_device_time_total, e.key, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        reverse=True,
    )
    busy_ms = sum(us for us, _, _ in by_kernel) / 1e3
    if busy_ms > 0:
        print(f"profiled summarize: wall {wall_prof * 1e3:.4f} ms, device busy "
              f"{busy_ms:.4f} ms, idle share {1 - busy_ms / (wall_prof * 1e3):.4f}")
        for us, key, count in by_kernel[:8]:
            print(f"  {us / 1e3:10.4f} ms  x{count:<4d} {key[:90]}")
    else:
        print("profiled summarize: the profiler saw no device time (not measured)")

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
