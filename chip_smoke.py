"""Drive the PyTorch/CUDA port on one NVIDIA card and hold it to its plain path.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit.  It builds the kernels from ``src/repro_torch/kernels/csrc``, checks
each against its plain PyTorch version over a sweep of shapes, dtypes and
options, and runs the paper's main path (SS, then greedy on the pruned set V')
on three objectives, one after the other, each at full size:

- FeatureCoverage over a synthetic news corpus of 2^20 sentences x 1024
  features;
- path A, dense facility location over a synthetic video of 2^16 frames x
  256 features (cosine similarity, a 16 GiB matrix on the card);
- path B, matrix-free facility location over 2^18 clustered embeddings of
  width 16 (its dense similarity would be 256 GiB);

then the LM serving path: qwen3-4b at its published widths and depth (36
layers, synthetic weights from a seed) serves four 2048-token prompts,
prefill through the flash-attention kernel (its tensor-core route, bf16 at
head_dim 128), then 32 greedy tokens of decode.  The tensor-core route is
timed beside the earlier CUDA-core (FFMA) kernel on the same inputs, in
turns, and both are held to the plain version, with their flip rates
(bf16 outputs that differ from it) beside that of P rounded to bf16 once.

For each it checks the result, its kernel launches and its agreement with
the plain path, times each kernel at the path's shapes beside its bound and
its plain version, and profiles the path.  The FeatureCoverage kernels sum
only the terms W's nonzeros make nonzero, so they are also swept over sparse
W and their bounds count what these inputs need (W read once as stored, the
work of its nonzeros), printed beside the dense bounds; the divergence is
also timed on a dense random W of round 1's shape.  Every time follows one
rule, ``kernel_ms``: the median of 5 windows of back-to-back calls between
CUDA events, each window queued behind a sleep on the card where Python's
enqueue takes at least half of it, so that the events time the card alone.

The last two lines of its output are JSON: the kernels' records, then
``{"ok": true, "device": {...}}``.  Any failure raises before them, and the
script exits non-zero without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch

# Main-path configuration: the paper's news setting scaled to one card.
N, F, K, R, C = 1 << 20, 1024, 32, 8, 8.0
# Path A (dense FL over video frames) and path B (matrix-free FL).
N_A, F_A = 1 << 16, 256
N_B, D_B = 1 << 18, 16
# H100 SXM published peaks: HBM bandwidth, the float32 FFMA rate (an FMA
# counted as two operations), and the rate of other float32 instructions
# (add, max, min: one per lane per clock, 132 SMs x 128 lanes x 1.98 GHz).
# The special-function units (sqrt.approx, lg2) issue 16 per clock per SM:
# that rate comes from the card's SM count and maximum SM clock.
HBM_BYTES_PER_S = 3.35e12
FFMA_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12
FP32_INSTR_PER_S = 33.5e12
SFU_PER_CLOCK_PER_SM = 16
# Tolerances of kernel vs plain, relative to the size of the sums involved.
# Both accumulate in float32, in different orders; the result is a difference
# (sum - phi_cu - resid) that cancels, so the error scales with the sums'
# size, not the result's.  1e-4 is the repository's float32 kernel tolerance;
# 3e-2 its bfloat16 one.
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# Probe counts that cross the FL kernels' tile and pass boundaries
# (kernels/_build.py:fl_probe_tile).
FL_TILE_PROBES = (2, 15, 16, 17, 64, 65, 128, 144, 145, 160, 161, 300)
# Widths and (served rows, candidates) across the one-probe matrix-free
# kernels' edges (csrc/fl_stream.cu: 16 resident features, 128-row chunks,
# 128-candidate blocks; kernels/_build.py:row_splits).
GAINS_EDGE_D = (1, 15, 16, 17, 33)
GAINS_EDGE_SHAPES = ((700, 300), (1037, 301), (5000, 130), (70001, 1500),
                     (300, 40000))
# The LM path: qwen3-4b serving four 2048-token prompts, 32 new tokens each.
LM_ARCH, LM_B, LM_S, LM_NEW = "qwen3-4b", 4, 2048, 32
PHIS = ("sqrt", "log1p", "setcover", "satcov", "linear")
RATES: dict[str, float] = {}
FLASH_WORST = [0.0]  # largest |out - ref| / tolerance of a bfloat16 flash check


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


class Timing(NamedTuple):
    ms: float              # per call: the median of the windows
    windows: list[float]   # per call, each window
    host_ms: float         # per call: the time Python takes to enqueue it
    queued: bool           # the windows were queued behind a sleep on the card


def _window(fn, iters: int, sleep_ms: float = 0.0):
    """(last result, ms on the card, ms to enqueue, ms slept) of `iters`
    back-to-back calls between two CUDA events, after a sleep on the card
    of `sleep_ms` if one is asked for."""
    pre, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    pre.record()
    if sleep_ms:
        torch.cuda._sleep(int(RATES["clock_hz"] * sleep_ms / 1e3))
    start.record()
    t = time.perf_counter()
    for _ in range(iters):
        out = fn()
    enqueue_ms = (time.perf_counter() - t) * 1e3
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), enqueue_ms, pre.elapsed_time(start)


def kernel_ms(fn, iters: int, windows: int = 5):
    """(last result, Timing): the one timing rule of every record.  After a
    warm-up call, `windows` windows of `iters` back-to-back calls, each
    between CUDA events; the time is the median window per call.  The
    first window also times Python's enqueue: where that takes at least
    half the window, the events would time the host, so every window is
    instead queued behind a sleep on the card that outlasts its enqueue
    (checked), and the events time the card alone.  A call that waits on
    the card (a sync inside, or more launches than the queue holds) cannot
    be queued: the sleep ends first, and such a call keeps its plain
    windows, host time included."""
    fn()
    torch.cuda.synchronize()
    out, ms, enqueue, _ = _window(fn, iters)
    host = enqueue / iters
    times, sleep = [ms], 0.0
    if enqueue >= 0.5 * ms:
        sleep = 4 * enqueue + 5.0
        out, ms, enqueue, slept = _window(fn, iters, sleep)
        if slept > enqueue:
            times = [ms]
        else:
            sleep = 0.0
    while len(times) < windows:
        out, ms, enqueue, slept = _window(fn, iters, sleep)
        check(not sleep or slept > enqueue,
              f"kernel_ms: the sleep ({slept:.3f} ms) ended before the {iters} "
              f"calls were queued ({enqueue:.3f} ms)")
        times.append(ms)
    per_call = [t / iters for t in times]
    return out, Timing(statistics.median(per_call), per_call, host, bool(sleep))


def fmt_windows(t: Timing) -> str:
    """How a time was taken, for the printed lines."""
    return (f"median of {', '.join(f'{x:.4f}' for x in t.windows)}"
            + ("; queued on the card" if t.queued else "")
            + f"; {t.host_ms:.4f} ms a call to enqueue")


def card_rates() -> None:
    """The special-function rate of this card: 16 per clock per SM at the
    maximum SM clock that nvidia-smi reports."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    RATES["sms"] = sms
    RATES["clock_hz"] = float(clk) * 1e6
    RATES["sfu"] = SFU_PER_CLOCK_PER_SM * sms * RATES["clock_hz"]
    print(f"{sms} SMs at {clk} MHz: special-function rate {RATES['sfu']:.4g}/s",
          flush=True)


def bound(bytes_moved: float, fp32: float = 0.0, ffma: float = 0.0,
          sfu: float = 0.0, bf16_tc: float = 0.0) -> tuple[float, str, str]:
    """The least time for the work: the largest of the bytes over the memory
    rate and each instruction class over its own rate (FFMA at 67 TFLOP/s,
    other float32 instructions at 33.5e12/s, special functions at 16 per
    clock per SM, products of bfloat16 operands with float32 accumulation
    (``bf16_tc`` flops) on the tensor cores at 989 TFLOP/s).  Returns (ms,
    "bytes" or "operations", the binding one)."""
    times = {
        "bytes": bytes_moved / HBM_BYTES_PER_S,
        "fp32": fp32 / FP32_INSTR_PER_S,
        "ffma": 2.0 * ffma / FFMA_FLOPS_PER_S,
        "sfu": sfu / RATES["sfu"],
        "bf16_tc": bf16_tc / BF16_TENSOR_FLOPS_PER_S,
    }
    pipe = max(times, key=times.get)
    return times[pipe] * 1e3, ("bytes" if pipe == "bytes" else "operations"), pipe


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


# The sparse sweep: densities of W (100%: every element nonzero), and
# (n, F, r) with F a multiple of 4 or not, of the 192-slot chunk or not,
# at the sparse loop's widest (8192) and past it (the dense loop), and r on
# both sides of the 32-probe passes.
SPARSE_DENSITIES = (0.005, 0.01, 0.1, 1.0)
SPARSE_SHAPES = ((300, 1024, 161), (1000, 1023, 33), (700, 257, 65),
                 (2000, 512, 32), (130, 8192, 3), (200, 8196, 5))


def sparse_w(n: int, f: int, density: float, g) -> torch.Tensor:
    """A float32 W of the given density in [0, 1), with row 0 empty, row 1
    one nonzero and, below full density, row n - 1 dense: its block crosses
    the dense-loop rule (csrc/ss_divergence.cu) while the others stay
    sparse."""
    W = torch.rand((n, f), generator=g, device="cuda")
    W *= torch.rand((n, f), generator=g, device="cuda") < density
    W[0] = 0.0
    W[1] = 0.0
    W[1, f // 3] = 0.7
    if density < 1.0:
        W[n - 1] = torch.rand((f,), generator=g, device="cuda") + 0.05
    return W


def sparse_sweep(errs: dict) -> None:
    """Kernel vs plain on sparse W: every phi x dtype x density x shape, with
    feat_w, a zero-padded cand_idx and a phi_cu / phi_c that is not the sum
    of phi cycled through them, and a pad probe (phi_cu = -INF) in every
    divergence; tolerances as in sweep()."""
    from repro_torch.kernels import (
        feature_gains_kernel, feature_gains_ref, ss_divergence_kernel,
        ss_divergence_ref,
    )

    g = torch.Generator(device="cuda").manual_seed(5)
    dev = "cuda"
    variants = list(itertools.product((False, True), repeat=3))
    cases = 0
    for (n, f, r), dens, phi, dt in itertools.product(
        SPARSE_SHAPES, SPARSE_DENSITIES, PHIS, (torch.float32, torch.bfloat16)
    ):
        weighted, compact, summed = variants[cases % len(variants)]
        W32 = sparse_w(n, f, dens, g)
        W = W32.to(dt)
        state = W32[2:6].sum(0)
        CU = (state[None, :] + W32[torch.randint(0, n, (r,), generator=g,
                                                 device=dev)]).contiguous()
        resid = torch.rand((r,), generator=g, device=dev)
        fw = (torch.linspace(0.5, 1.5, f, device=dev) if weighted else None)
        cap = 0.2 * W.float().sum(0) + 0.01 if phi == "satcov" else None
        phi_cu = plain_phi_sum(phi, CU, cap, fw)
        if not summed:  # any phi_cu: the kernel computes its offset itself
            phi_cu = phi_cu + torch.randn((r,), generator=g, device=dev)
        phi_cu[-1] = -1e30  # a pad probe: never wins the min
        cand = (torch.randint(0, n, (n // 3 + 2,), generator=g, device=dev)
                if compact else None)
        if cand is not None:
            cand[-2:] = 0  # zero padding, as the SS loop's buffers carry
        what = (f"{phi} {dt} {n}x{f}x{r} density {dens} fw={weighted} "
                f"cand={compact} summed={summed}")
        tol = TOL[dt]
        out = ss_divergence_kernel(W, CU, phi_cu, resid, cap, fw, cand, phi=phi)
        ref = ss_divergence_ref(W, CU, phi_cu, resid, cap, phi, fw, cand)
        scale = max(1.0, float(phi_cu[:-1].abs().max()) + float(resid.abs().max()))
        err = float((out - ref).abs().max())
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"sparse ss_divergence {what}: bad output")
        check(err <= tol * scale, f"sparse ss_divergence {what}: err {err} > "
              f"{tol * scale}")
        errs["ss_divergence"] = max(errs["ss_divergence"], err)

        c = CU[0]
        phi_c = plain_phi_sum(phi, c, cap, fw) + (0.0 if summed else 0.3)
        out = feature_gains_kernel(W, c, phi_c, cap, fw, cand, phi=phi)
        ref = feature_gains_ref(W, c, phi_c, cap, phi, fw, cand)
        scale = max(1.0, float(phi_c.abs()), float(ref.abs().max()))
        err = float((out - ref).abs().max())
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"sparse feature_gains {what}: bad output")
        check(err <= tol * scale, f"sparse feature_gains {what}: err {err} > "
              f"{tol * scale}")
        errs["feature_gains"] = max(errs["feature_gains"], err)
        cases += 1
    torch.cuda.synchronize()
    print(f"sparse kernel vs plain: {cases} cases per kernel passed (densities "
          f"{SPARSE_DENSITIES}); max abs err so far ss_divergence "
          f"{errs['ss_divergence']:.3g}, feature_gains {errs['feature_gains']:.3g}",
          flush=True)


def route_check() -> None:
    """ss_divergence's two loops give the same bits for the same row: block
    0 of W holds 128 rows of 1% density, block 1 the same rows with row 7
    made dense.  The kernel's own flags (left in its scratch) must say that
    block 0 ran the sparse loop and block 1 the dense one, and the other
    127 rows' divergences must be equal."""
    from repro_torch.kernels import ss_weights
    from repro_torch.kernels._build import SS_BLOCK_CANDS, ss_scratch_floats

    g = torch.Generator(device="cuda").manual_seed(6)
    dev = "cuda"
    B, f, r = SS_BLOCK_CANDS, 1024, 40
    keep = torch.arange(B, device=dev) != 7
    for phi, dt, weighted in itertools.product(
        PHIS, (torch.float32, torch.bfloat16), (False, True)
    ):
        A = sparse_w(B, f, 0.01, g)[: B - 1]
        A = torch.cat([A, torch.zeros((1, f), device=dev)])
        W = torch.cat([A, A])
        W[B + 7] = torch.rand((f,), generator=g, device=dev) + 0.05
        W = W.to(dt)
        CU = torch.rand((r, f), generator=g, device=dev)
        CU *= torch.rand((r, f), generator=g, device=dev) < 0.05
        fw = torch.linspace(0.5, 1.5, f, device=dev) if weighted else None
        cap = 0.2 * W.float().sum(0) + 0.01 if phi == "satcov" else None
        phi_cu = plain_phi_sum(phi, CU, cap, fw)
        phi_cu[-1] = -1e30
        resid = torch.rand((r,), generator=g, device=dev)
        out = torch.empty((2 * B,), device=dev)
        scratch = torch.empty((ss_scratch_floats(r, f, 2 * B),), device=dev)
        ss_weights._launch(W, CU, phi_cu, resid, cap, fw, None, phi, scratch, out)
        flags = scratch[-2:].view(torch.int32).tolist()
        what = f"ss_divergence {phi} {dt} fw={weighted}"
        check(flags == [0, 1], f"{what}: the kernel flagged its blocks {flags}, "
              "not [0, 1] (sparse, dense)")
        check(torch.equal(out[:B][keep], out[B:][keep]),
              f"{what}: the sparse and dense loops give different bits")
    torch.cuda.synchronize()
    print("route check: ss_divergence's sparse and dense loops give the same "
          f"bits ({len(PHIS) * 4} cases; each block's loop read from the "
          "kernel's own flag)", flush=True)


def small_pipeline() -> None:
    """The whole pipeline on a small corpus, kernels vs the plain backend on
    the card, under the same draws: same V' and the same picks."""
    from repro_torch import feature_coverage_from_numpy, news_day

    n = 4096
    fn = feature_coverage_from_numpy(news_day(0, n, 512))
    res_k, ss_k = _cuda_vs_reference(fn, 10, seed=1)
    print(f"small summarize (n={n}): cuda == reference, |V'| = "
          f"{int(ss_k.vprime.sum())}, f(S') = {float(res_k.value):.6f}", flush=True)


def _cuda_vs_reference(fn, k: int, seed: int, what: str = "small"):
    """summarize through the kernels and through the plain backend under the
    same draws: the same V', the same picks and f(S') to 1e-5 relative."""
    from repro_torch import summarize
    from repro_torch.core.sparsify import gumbel, max_rounds

    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.stack([gumbel(fn.n, g, "cuda")
                         for _ in range(max_rounds(fn.n, R, C))])
    res_k, ss_k = summarize(fn, k, r=R, c=C, noise=noise)
    res_p, ss_p = summarize(fn, k, r=R, c=C, noise=noise, backend="reference")
    check(torch.equal(ss_k.vprime, ss_p.vprime), f"{what} SS: V' differs")
    check(torch.equal(res_k.selected, res_p.selected),
          f"{what} greedy: picks differ")
    check(abs(float(res_k.value) - float(res_p.value)) <= 1e-5 * float(res_p.value),
          f"{what} summarize: values differ")
    return res_k, ss_k


def profile_summarize(label: str, fn, watch: tuple[str, ...] = ()) -> dict:
    """One summarize under the profiler: device busy time by kernel (device
    events only: a PyTorch operator also reports its kernels' time as its
    own, and would count them twice) against the synchronised wall, and for
    each string of ``watch`` the total of the kernels whose names hold it,
    or for an operator ("aten::...") the device time of the kernels it
    launched."""
    from repro_torch import summarize

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        t = time.perf_counter()
        summarize(fn, K, torch.Generator(device="cuda").manual_seed(0), r=R, c=C)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    by_kernel = sorted(
        ((e.self_device_time_total, e.key, e.count)
         for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
        reverse=True,
    )
    busy_ms = sum(us for us, _, _ in by_kernel) / 1e3
    if busy_ms <= 0:
        print(f"profiled {label} summarize: the profiler saw no device time "
              "(not measured)")
        return {}
    print(f"profiled {label} summarize: wall {wall_ms:.4f} ms, device busy "
          f"{busy_ms:.4f} ms, idle share {1 - busy_ms / wall_ms:.4f}")
    for us, key, count in by_kernel[:8]:
        print(f"  {us / 1e3:10.4f} ms  x{count:<4d} {key[:90]}")
    for name in watch:
        if name.startswith("aten::"):
            hits = [(e.device_time_total, e.count) for e in events if e.key == name]
        else:
            hits = [(us, count) for us, key, count in by_kernel if name in key]
        print(f"  {name}: {sum(us for us, _ in hits) / 1e3:.4f} ms of device time "
              f"over {sum(count for _, count in hits)} calls")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms}


def ss_bounds(n: int, f: int, m: int, nnz: int) -> tuple[float, str, str, float]:
    """ss_divergence's bound at n candidates x m probes x f features whose
    rows hold nnz nonzeros (sqrt): W read once as stored, CU, phi_cu and
    resid read and the output written once; per (nonzero, probe) an add, a
    max and a subtraction (float32), sqrt.approx (special function) and the
    weighted accumulate (FFMA); per (candidate, probe) the offset's add and
    the min; phi(CU) once per (probe, feature).  Returns the bound as
    bound() does, then the dense bound, which counts every element of W as
    a nonzero."""
    bytes_ = n * f * 4 + m * f * 4 + 2 * m * 4 + n * 4
    pairs = nnz * m
    b = bound(bytes_, fp32=3 * pairs + 2 * n * m, ffma=pairs, sfu=pairs + m * f)
    elems = n * m * f
    dense = bound(bytes_, fp32=2 * elems + 3 * n * m, ffma=elems, sfu=elems)
    return (*b, dense[0])


def gains_bounds(n: int, f: int, nnz: int, w_bytes: int) -> tuple[float, str, str, float]:
    """feature_gains' bound over n rows of f features holding nnz nonzeros
    (sqrt): the rows read once as stored (w_bytes, with cand_idx), c, the
    scalar phi_c and the output; a compare per element; per nonzero an add,
    a max, a subtraction, sqrt.approx and the weighted accumulate; phi(c)
    once per feature.  Then the dense bound."""
    bytes_ = w_bytes + f * 4 + 4 + n * 4
    b = bound(bytes_, fp32=n * f + 3 * nnz + n, ffma=nnz, sfu=nnz + f)
    elems = n * f
    dense = bound(bytes_, fp32=2 * elems + n, ffma=elems, sfu=elems)
    return (*b, dense[0])


def ss_dense_w(m: int) -> dict:
    """ss_divergence on a dense random W at round 1's shape (every element
    nonzero: the dense loop in every block), timed and held to the plain
    version once."""
    from repro_torch.kernels import ss_divergence_kernel, ss_divergence_ref

    g = torch.Generator(device="cuda").manual_seed(7)
    Wd = torch.rand((N, F), generator=g, device="cuda")
    CU = Wd[torch.randint(0, N, (m,), generator=g, device="cuda")].contiguous()
    phi_cu = torch.sqrt(CU).sum(-1)
    resid = torch.rand((m,), generator=g, device="cuda")
    out, t = kernel_ms(lambda: ss_divergence_kernel(Wd, CU, phi_cu, resid), 1)
    err = float((out - ss_divergence_ref(Wd, CU, phi_cu, resid)).abs().max())
    scale = max(1.0, float(phi_cu.abs().max()) + float(resid.abs().max()))
    check(err <= TOL[torch.float32] * scale, f"dense W divergence err {err}")
    b_ms, b_by, b_pipe, _ = ss_bounds(N, F, m, N * F)
    del Wd
    torch.cuda.empty_cache()
    print(f"ss_divergence on a dense random W ({N} x {m} x {F}, every element "
          f"nonzero): {t.ms:.4f} ms per launch ({fmt_windows(t)}), bound "
          f"{b_ms:.4f} ms ({b_by}: {b_pipe}), share {b_ms / t.ms:.4f}; vs plain "
          f"err {err:.3g}", flush=True)
    return {"ms": t.ms, "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}


def fc_path(errs: dict) -> list[dict]:
    """The FeatureCoverage main path at n = 2^20 x F = 1024: run, check,
    hold the kernels to their plain versions, time, profile."""
    from repro_torch import (
        feature_coverage_from_numpy, greedy, news_day, ss_sparsify, summarize,
    )
    from repro_torch.core.greedy import compact_indices, selection_bucket
    from repro_torch.core.sparsify import bucket_schedule, gumbel, probe_count
    from repro_torch.kernels import (
        feature_gains_kernel, feature_gains_ref, ss_divergence_kernel,
        ss_divergence_ref,
    )

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

    # the plain route on the card for the same work
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

    # times at the main path's shapes, against bounds that count the work
    # these inputs need: W read once as stored, and the float32 and
    # special-function work of its nonzeros only (a zero of W adds exactly 0
    # to both kernels' sums).  The dense bounds, which price every element
    # of W as a nonzero, are printed beside them.
    records = []
    _, t = kernel_ms(lambda: ss_divergence_kernel(fn.W, CU, phi_cu, resid), 3)
    plain_ms = kernel_ms(lambda: ss_divergence_ref(fn.W, CU, phi_cu, resid),
                         1)[1].ms
    nnz = int(torch.count_nonzero(fn.W))
    b_ms, b_by, b_pipe, d_ms = ss_bounds(N, F, m, nnz)
    regs, st, ld, per_sm = ptxas_report("ss_divergence", "ss_divergence_sparseIfLi0ELb1E")
    d_regs, d_st, d_ld, d_per_sm = ptxas_report("ss_divergence",
                                                "ss_divergence_denseIfLi0E")
    print(f"ss_divergence, round 1 ({N} candidates x {m} probes x {F} features, "
          f"{nnz} nonzeros, {nnz / N:.2f} a row): {t.ms:.4f} ms per launch "
          f"({fmt_windows(t)}), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}: {b_pipe}), share {b_ms / t.ms:.4f}; dense bound {d_ms:.4f} "
          f"ms; library none; {counts['summarize']['ss_divergence']} launches in "
          f"summarize; ptxas: sparse kernel {regs} registers, spill stores/loads "
          f"{st}/{ld} bytes; dense kernel {d_regs} registers, spill stores/loads "
          f"{d_st}/{d_ld} bytes, {d_per_sm} blocks an SM by registers", flush=True)
    records.append({
        "name": "ss_divergence", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ss_divergence.cu",
        "replaces": "src/repro/kernels/ss_weights.py:114",
        "launches": counts["summarize"]["ss_divergence"],
        "max_abs_err": errs["ss_divergence"], "ms": t.ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "nnz": nnz, "share_of_bound": b_ms / t.ms, "dense_bound_ms": d_ms,
        "host_ms_per_call": t.host_ms,
        "ptxas": {"sparse": {"registers": regs, "spill_store_bytes": st,
                             "spill_load_bytes": ld},
                  "dense": {"registers": d_regs, "spill_store_bytes": d_st,
                            "spill_load_bytes": d_ld}},
    })

    _, t_full = kernel_ms(lambda: feature_gains_kernel(fn.W, state_half, phi_c), 10)
    plain_full = kernel_ms(lambda: feature_gains_ref(fn.W, state_half, phi_c),
                           3)[1].ms
    bf_ms, bf_by, bf_pipe, bfd_ms = gains_bounds(N, F, nnz, N * F * 4)
    print(f"feature_gains, full width (greedy on V, {N} x {F}, {nnz} nonzeros): "
          f"{t_full.ms:.4f} ms per launch ({fmt_windows(t_full)}), plain "
          f"{plain_full:.4f} ms, bound {bf_ms:.4f} ms ({bf_by}: {bf_pipe}), share "
          f"{bf_ms / t_full.ms:.4f}; dense bound {bfd_ms:.4f} ms; "
          f"{counts['greedy_on_V']['feature_gains']} launches", flush=True)
    nnz_vp = int(torch.count_nonzero(fn.W[cand_vp]))
    _, t = kernel_ms(lambda: feature_gains_kernel(
        fn.W, state_red, phi_red, cand_idx=cand_vp), 200)
    plain_ms = kernel_ms(lambda: feature_gains_ref(
        fn.W, state_red, phi_red, cand_idx=cand_vp), 20)[1].ms
    b_ms, b_by, b_pipe, bd_ms = gains_bounds(size, F, nnz_vp, size * (F * 4 + 8))
    print(f"feature_gains in summarize (greedy on V': {size} slots x {F}, "
          f"{nnz_vp} nonzeros): {t.ms:.4f} ms per launch ({fmt_windows(t)}), "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {b_pipe}), "
          f"share {b_ms / t.ms:.4f}; dense bound {bd_ms:.4f} ms; library none; "
          f"{counts['summarize']['feature_gains']} launches", flush=True)
    records.append({
        "name": "feature_gains", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/feature_gains.cu",
        "replaces": "src/repro/kernels/feature_gains.py:61",
        "launches": counts["summarize"]["feature_gains"],
        "max_abs_err": errs["feature_gains"], "ms": t.ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "nnz": nnz_vp, "share_of_bound": b_ms / t.ms, "dense_bound_ms": bd_ms,
        "host_ms_per_call": t.host_ms,
        "full_width": {"ms": t_full.ms, "plain_ms": plain_full, "bound_ms": bf_ms,
                       "bound_by": bf_by, "nnz": nnz, "dense_bound_ms": bfd_ms,
                       "launches": counts["greedy_on_V"]["feature_gains"]},
    })
    # last, so that its minute of special functions heats no other timing
    records[0]["dense_w"] = ss_dense_w(m)

    # where the time goes: the same run again, warm, split by stage and
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
    profile_summarize("FeatureCoverage", fn,
                      ("ss_divergence", "ss_probe", "feature_gains"))
    return records


# -- facility location --------------------------------------------------------


def _fl_close(out, ref, resid, tol, what):
    """Kernel vs plain: finite, same shape, error within tol of the sums'
    size (max |ref| + max |resid| over live probes, at least 1)."""
    live = resid[resid > -1e29] if resid is not None else resid
    size = float(ref.abs().max()) + (float(live.abs().max())
                                     if live is not None and live.numel() else 0.0)
    err = float((out - ref).abs().max())
    check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
          f"{what}: bad output")
    check(err <= tol * max(1.0, size), f"{what}: err {err} > {tol * max(1.0, size)}")
    return err


def fl_sweep(errs: dict) -> None:
    """The two FL kernels and their gains instances vs their plain versions
    on the card: ragged shapes x float32/bfloat16 sim x cand_idx none or
    zero-padded x symmetric or asymmetric sim (dense), and x d x Xc = X or
    Xc != X (matrix-free), each with a pad probe (resid = -INF); then the
    divergence kernels at probe counts across their tile and pass
    boundaries, with the served rows split."""
    from repro_torch.kernels import (
        fl_divergence_kernel, fl_divergence_ref, fl_gains_kernel,
        fl_stream_divergence_kernel, fl_stream_divergence_ref,
        fl_stream_gains_kernel,
    )
    from repro_torch.kernels._build import fl_probe_tile, row_splits
    from repro_torch.kernels.ref import sim_rows

    g = torch.Generator(device="cuda").manual_seed(2)
    dev = "cuda"
    shapes = [(64, 3), (130, 5), (513, 33), (2000, 130)]

    def probe_rows(sim, r, with_state):
        n = sim.shape[1]
        probes = torch.randperm(n, generator=g, device=dev)[:r]
        state = (sim[:, probes[:2]].float().amax(1).clamp_min(0) if with_state
                 else torch.zeros(sim.shape[0], device=dev))
        MU = torch.maximum(state[None, :], sim[:, probes].T.float()).contiguous()
        resid = torch.rand((r,), generator=g, device=dev) * 0.1
        resid[-1] = -1e30  # a pad probe: never wins the min
        return MU, resid, state.contiguous()

    def cand_of(n):
        cand = torch.randint(0, n, (n // 3 + 2,), generator=g, device=dev)
        cand[-2:] = 0  # zero padding, as the SS and greedy buffers carry
        return cand

    dense = 0
    for (n, r), dt, compact, asym in itertools.product(
        shapes, (torch.float32, torch.bfloat16), (False, True), (False, True)
    ):
        if asym:   # rectangular and asymmetric: candidates are columns
            sim = torch.rand((n + 37, n), generator=g, device=dev)
        else:      # a cosine similarity, as from_features builds it
            X = torch.rand((n, 8), generator=g, device=dev)
            X = X / X.norm(dim=1, keepdim=True)
            sim = sim_rows(X, X)
        sim = sim.to(dt).contiguous()
        MU, resid, state = probe_rows(sim, r, with_state=compact)
        cand = cand_of(n) if compact else None
        what = f"fl_divergence {n}x{r} {dt} cand={compact} asym={asym}"
        errs["fl_divergence"] = max(errs["fl_divergence"], _fl_close(
            fl_divergence_kernel(sim, MU, resid, cand),
            fl_divergence_ref(sim, MU, resid, cand), resid, TOL[dt], what))
        errs["fl_gains"] = max(errs["fl_gains"], _fl_close(
            fl_gains_kernel(sim, state, cand),
            fl_divergence_ref(sim, state[None], torch.zeros(1, device=dev), cand),
            None, TOL[dt], "fl_gains: " + what))
        dense += 1

    stream = 0
    for (n, r), d, separate, compact in itertools.product(
        shapes, (5, 16, 130, 256), (False, True), (False, True)
    ):
        X = torch.randn((n, d), generator=g, device=dev)
        X = X / X.norm(dim=1, keepdim=True)
        Xc = X
        if separate:
            Xc = torch.randn((n + 11, d), generator=g, device=dev)
            Xc = Xc / Xc.norm(dim=1, keepdim=True)
        probes = torch.randperm(Xc.shape[0], generator=g, device=dev)[:r]
        state = (sim_rows(X, Xc[probes[:2]]).amax(1) if compact
                 else torch.zeros(n, device=dev))
        MU = torch.maximum(state[None, :], sim_rows(X, Xc[probes]).T).contiguous()
        resid = torch.rand((r,), generator=g, device=dev) * 0.1
        resid[-1] = -1e30
        cand = cand_of(Xc.shape[0]) if compact else None
        Xc_arg = Xc if separate else None
        what = f"fl_stream {n}x{r} d={d} Xc!=X={separate} cand={compact}"
        errs["fl_stream_divergence"] = max(errs["fl_stream_divergence"], _fl_close(
            fl_stream_divergence_kernel(X, MU, resid, cand, Xc_arg),
            fl_stream_divergence_ref(X, MU, resid, cand, Xc_arg), resid,
            TOL[torch.float32], what))
        errs["fl_stream_gains"] = max(errs["fl_stream_gains"], _fl_close(
            fl_stream_gains_kernel(X, state, cand, Xc_arg),
            fl_stream_divergence_ref(X, state[None], torch.zeros(1, device=dev),
                                     cand, Xc_arg),
            None, TOL[torch.float32], "fl_stream_gains: " + what))
        stream += 1
    # Probe counts across the many-probe tile's boundaries (fl_probe_tile:
    # 1 to 10 probes a thread, one pass or more), each with a pad probe, over
    # 1500 candidates and 1537 or 1500 served rows, so the rows are split.
    tiles, tile_dense, tile_stream = {}, 0, 0
    for r in FL_TILE_PROBES:
        tiles[r] = fl_probe_tile(r)
        for dt, compact in itertools.product((torch.float32, torch.bfloat16),
                                             (False, True)):
            sim = torch.rand((1537, 1500), generator=g, device=dev).to(dt).contiguous()
            MU, resid, _ = probe_rows(sim, r, with_state=compact)
            cand = cand_of(1500) if compact else None
            n_out = 1500 if cand is None else cand.numel()
            check(row_splits(n_out, 1537) > 1, "fl tile sweep: rows not split")
            what = f"fl_divergence tile r={r} {dt} cand={compact}"
            errs["fl_divergence"] = max(errs["fl_divergence"], _fl_close(
                fl_divergence_kernel(sim, MU, resid, cand),
                fl_divergence_ref(sim, MU, resid, cand), resid, TOL[dt], what))
            tile_dense += 1
        for d, compact in itertools.product((16, 40), (False, True)):
            X = torch.randn((1500, d), generator=g, device=dev)
            X = X / X.norm(dim=1, keepdim=True)
            MU, resid, _ = probe_rows(sim_rows(X, X), r, with_state=compact)
            cand = cand_of(1500) if compact else None
            what = f"fl_stream tile r={r} d={d} cand={compact}"
            errs["fl_stream_divergence"] = max(errs["fl_stream_divergence"], _fl_close(
                fl_stream_divergence_kernel(X, MU, resid, cand),
                fl_stream_divergence_ref(X, MU, resid, cand), resid,
                TOL[torch.float32], what))
            tile_stream += 1
    # The one-probe matrix-free kernels across their tiles' edges: d on both
    # sides of the resident kernel's 16 features (1, 15, 16; 17 and 33 take
    # the piecewise kernel), served rows off the 128-row chunk, candidates off
    # the 128-candidate block, rows split and not, and a state with negative
    # entries (the hinge's max(-m, 0) floor).
    edge = 0
    for d, (ni, nc), compact in itertools.product(
        GAINS_EDGE_D, GAINS_EDGE_SHAPES, (False, True)
    ):
        X = torch.randn((ni, d), generator=g, device=dev)
        X = X / X.norm(dim=1, keepdim=True)
        Xc = torch.randn((nc, d), generator=g, device=dev)
        Xc = Xc / Xc.norm(dim=1, keepdim=True)
        state = torch.rand((ni,), generator=g, device=dev) * 0.6 - 0.1
        cand = cand_of(nc) if compact else None
        n_out = nc if cand is None else cand.numel()
        what = (f"fl_stream_gains edge d={d} ni={ni} n={nc} cand={compact} "
                f"splits={row_splits(n_out, ni)}")
        errs["fl_stream_gains"] = max(errs["fl_stream_gains"], _fl_close(
            fl_stream_gains_kernel(X, state, cand, Xc),
            fl_stream_divergence_ref(X, state[None], torch.zeros(1, device=dev),
                                     cand, Xc),
            None, TOL[torch.float32], what))
        edge += 1
    torch.cuda.synchronize()
    print("FL probe tiles swept (r: probes a thread x passes): " + ", ".join(
        f"{r}: {t.ppt} x {t.passes}" for r, t in tiles.items()), flush=True)
    print(f"FL kernel vs plain: {dense} dense cases (fl_divergence and "
          f"fl_gains) and {tile_dense} probe-tile cases (fl_divergence), "
          f"{stream} matrix-free cases (fl_stream_divergence and fl_stream_gains)"
          f" and {tile_stream} probe-tile cases (fl_stream_divergence), {edge} "
          f"tile-edge cases (fl_stream_gains) passed; "
          f"max abs err "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()
                      if k.startswith("fl_")), flush=True)


def fl_small_pipelines() -> None:
    """Dense and matrix-free FL at n = 4096: through the kernels and the
    plain backend under the same draws (same V', same picks), and dense vs
    matrix-free over the same embeddings (f(S') to 1e-4 relative)."""
    from repro_torch import (
        StreamingFacilityLocation, clustered_embeddings,
        facility_location_from_features, video,
    )

    n = 4096
    fn = facility_location_from_features(video(0, n, 256), "cosine")
    res_a, ss_a = _cuda_vs_reference(fn, 10, seed=3, what="small dense FL")
    E = torch.from_numpy(clustered_embeddings(0, n, 16)).cuda()
    sfl = StreamingFacilityLocation.from_features(E, "dot")
    res_b, ss_b = _cuda_vs_reference(sfl, 10, seed=4, what="small matrix-free FL")
    dense = facility_location_from_features(E.cpu().numpy(), "dot")
    res_d, _ = _cuda_vs_reference(dense, 10, seed=4, what="small dense-dot FL")
    f_b, f_d = float(res_b.value), float(res_d.value)
    check(abs(f_b - f_d) <= 1e-4 * f_d,
          f"dense and matrix-free FL disagree: f(S') {f_d} vs {f_b}")
    print(f"small FL pipelines (n={n}): cuda == reference; dense |V'| = "
          f"{int(ss_a.vprime.sum())}, f(S') = {float(res_a.value):.6f}; "
          f"matrix-free |V'| = {int(ss_b.vprime.sum())}, f(S') = {f_b:.6f}, "
          f"dense over the same embeddings {f_d:.6f}", flush=True)


def _fl_drive(label: str, fn, kernels: dict) -> tuple:
    """Greedy on V, then summarize, each with the kernels' counts (and the
    count of V' panel gathers) set to 0 just before and read just after;
    checks the results, except the relative quality, which the caller checks
    after its measurements."""
    from repro_torch import greedy, summarize
    from repro_torch.kernels import fl_gains_panel

    counts = {}

    def run(path, call):
        for kern in kernels.values():
            kern.launches = 0
        fl_gains_panel.gathers = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        counts[path] = {name: kern.launches for name, kern in kernels.items()}
        counts[path]["panel_gathers"] = fl_gains_panel.gathers
        return out, time.perf_counter() - t

    full, wall_full = run("greedy_on_V", lambda: greedy(fn, K))
    (res, ss), wall_sum = run("summarize", lambda: summarize(
        fn, K, torch.Generator(device="cuda").manual_seed(0), r=R, c=C))
    peak = torch.cuda.max_memory_allocated() / 2**30
    f_full, f_red = float(full.value), float(res.value)
    nv = int(ss.vprime.sum())
    rel = f_red / f_full
    print(f"{label} greedy on V: f(S) = {f_full:.6f}, wall {wall_full:.4f} s")
    print(f"{label} summarize: rounds = {ss.rounds}, |V'| = {nv}, eps_hat = "
          f"{float(ss.eps_hat):.6f}, f(S') = {f_red:.6f}, relative = {rel:.6f}, "
          f"wall {wall_sum:.4f} s")
    print(f"{label} launches: {json.dumps(counts)}; peak device memory "
          f"{peak:.2f} GiB", flush=True)
    for r_ in (full, res):
        check(r_.selected.shape == (K,) and bool(torch.isfinite(r_.gains).all()),
              f"{label}: greedy result has the wrong shape or non-finite gains")
        check(int(r_.selected.unique().numel()) == K, f"{label}: greedy picked twice")
    check(bool(ss.vprime[res.selected].all()), f"{label}: greedy on V' left V'")
    check(0 < nv < fn.n and ss.rounds > 0, f"{label}: SS pruned nothing or all")
    for name in kernels:
        path = "greedy_on_V" if name.endswith("gains") else "summarize"
        check(counts["summarize"][name] > 0 and counts[path][name] > 0,
              f"{label}: {path} never launched {name}")
    ref = greedy(fn, K, alive=ss.vprime, backend="reference")
    check(torch.equal(ref.selected, res.selected),
          f"{label}: greedy on V' through the plain backend picks another set")
    return full, res, ss, counts, rel


def _round1(fn, residual):
    """Round 1's probes, as SS draws them, and the kernels' inputs."""
    from repro_torch.core.sparsify import gumbel, probe_count

    m = probe_count(fn.n, R)
    g1 = gumbel(fn.n, torch.Generator(device="cuda").manual_seed(0), "cuda")
    probes = torch.topk(g1, m).indices
    MU = fn._probe_mu(probes, None).float().contiguous()
    return m, MU, residual[probes].float().contiguous()


def ptxas_report(stem: str, entry: str, threads: int = 256) -> tuple[int, int, int, int]:
    """What ptxas reported for the one kernel of ``csrc/<stem>.cu`` whose
    mangled name holds ``entry``: registers, spill store and load bytes,
    and the blocks of ``threads`` threads an SM holds by registers."""
    from repro_torch.kernels._build import BUILD_DIR

    lines = (BUILD_DIR / f"{stem}.ptxas.txt").read_text().splitlines()
    found = [" ".join(lines[i + 1:i + 4]) for i, line in enumerate(lines)
             if "Compiling entry" in line and entry in line]
    check(len(found) == 1, f"{stem}: no single ptxas report for {entry}")
    regs = int(re.search(r"Used (\d+) registers", found[0]).group(1))
    store, load = (int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                              found[0]))
    return regs, store, load, 65536 // (threads * (-(-regs // 8) * 8))


def fl_tile_report(kernel: str, m: int) -> dict:
    """The probe tile that fl_probe_tile picks at a path's m, and what
    ptxas reported for that template instance (float32 sim): registers,
    spills, and the 256-thread blocks an SM holds by registers."""
    from repro_torch.kernels._build import FL_PROBE_THREADS, fl_probe_tile

    tile = fl_probe_tile(m)
    stem, entry = {"fl_divergence": ("fl_divergence", "fl_divergence_tiledIfLi"),
                   "fl_stream_divergence": ("fl_stream", "fl_stream_tiledILi")}[kernel]
    regs, store, load, per_sm = ptxas_report(stem, f"{entry}{tile.ppt}E")
    print(f"{kernel} at m = {m}: probe tile {FL_PROBE_THREADS} threads x "
          f"{tile.ppt} probes, {tile.passes} pass(es), {tile.slots - m} pad "
          f"slots; ptxas: {regs} registers, spill stores/loads {store}/{load} "
          f"bytes, {per_sm} blocks of 256 threads per SM by registers", flush=True)
    return {"ppt": tile.ppt, "passes": tile.passes, "pad_slots": tile.slots - m,
            "registers": regs, "spill_store_bytes": store, "spill_load_bytes": load,
            "blocks_per_sm_by_registers": per_sm}


def fl_dense_path(errs: dict) -> list[dict]:
    """Path A: dense FL over 2^16 video frames x 256 features (cosine), the
    paper's video objective with a 16 GiB similarity on the card."""
    from repro_torch import facility_location_from_features, video
    from repro_torch.core.greedy import compact_indices, selection_bucket
    from repro_torch.core.sparsify import bucket_schedule
    from repro_torch.kernels import (
        fl_divergence_kernel, fl_divergence_ref, fl_gains_kernel, fl_gains_panel,
        takes_panel,
    )

    t = time.perf_counter()
    X = video(0, N_A, F_A)
    t_host = time.perf_counter() - t
    t = time.perf_counter()
    fn = facility_location_from_features(X, "cosine", n_threshold=None)
    torch.cuda.synchronize()
    print(f"path A: video(0, {N_A}, {F_A}): host set-up {t_host:.2f} s; cosine "
          f"similarity ({N_A} x {N_A} float32) on the card in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    kernels = {"fl_divergence": fl_divergence_kernel, "fl_gains": fl_gains_kernel}
    full, res, ss, counts, rel = _fl_drive("path A", fn, kernels)
    # greedy over V' copies V''s columns once (a panel) and reads it K times
    check(counts["summarize"]["panel_gathers"] == 1
          and counts["greedy_on_V"]["panel_gathers"] == 0,
          f"path A: panel gathers {counts['summarize']['panel_gathers']} in "
          f"summarize, {counts['greedy_on_V']['panel_gathers']} in greedy on V "
          "(want one per greedy run over V', none at full width)")
    check(counts["summarize"]["fl_gains"] == K,
          f"path A: {counts['summarize']['fl_gains']} fl_gains launches in "
          f"summarize, not one per greedy step ({K})")

    # main-path shapes against plain
    residual = fn.residual_gains()
    m, MU, resid = _round1(fn, residual)
    tile = fl_tile_report("fl_divergence", m)
    div_k, (ms, *_) = kernel_ms(lambda: fl_divergence_kernel(fn.sim, MU, resid), 3)
    div_p, (plain_ms, *_) = kernel_ms(lambda: fl_divergence_ref(fn.sim, MU, resid),
                                      1)
    errs["fl_divergence"] = max(errs["fl_divergence"], _fl_close(
        div_k, div_p, resid, TOL[torch.float32], "path A round 1 divergence"))
    mid = bucket_schedule(N_A, C)[1]
    cand_mid = torch.sort(torch.randperm(N_A, device="cuda")[:mid]).values
    div_mid, (ms_mid, *_) = kernel_ms(lambda: fl_divergence_kernel(
        fn.sim, MU, resid, cand_mid), 3)
    errs["fl_divergence"] = max(errs["fl_divergence"], _fl_close(
        div_mid, div_p[cand_mid], resid, TOL[torch.float32],
        "path A round-2-sized divergence"))
    state_half = fn.add_many(fn.empty_state(), _mask(N_A, full.selected[: K // 2]))
    zero = torch.zeros(1, device="cuda")
    g_k, (ms_full, *_) = kernel_ms(lambda: fl_gains_kernel(fn.sim, state_half), 20)
    g_p, (plain_full, *_) = kernel_ms(lambda: fl_divergence_ref(
        fn.sim, state_half[None], zero), 1)
    errs["fl_gains"] = max(errs["fl_gains"], _fl_close(
        g_k, g_p, None, TOL[torch.float32], "path A full-width gains"))
    size = selection_bucket(N_A, int(ss.vprime.sum()))
    check(size is not None, "path A: V' does not fit a compact bucket")
    cand_vp = compact_indices(ss.vprime, size)
    check(takes_panel(size, N_A), f"path A: V' ({size} slots) takes no panel")
    st = res.state.float().contiguous()
    panel = fl_gains_panel(fn.sim, cand_vp)
    gather_ms = kernel_ms(lambda: fl_gains_panel(fn.sim, cand_vp), 5)[1].ms
    panel_bytes = panel.cols.numel() * panel.cols.element_size()
    g_k, t_vp = kernel_ms(lambda: fl_gains_kernel(panel.cols, st), 200)
    ms_vp = t_vp.ms
    g_g, (ms_gathered, *_) = kernel_ms(lambda: fl_gains_kernel(fn.sim, st, cand_vp),
                                       50)
    check(torch.equal(g_k, g_g),
          "path A V' gains: the panel route is not bitwise the gathered route")
    g_p, (plain_vp, *_) = kernel_ms(lambda: fl_divergence_ref(
        fn.sim, st[None], zero, cand_vp), 1)
    errs["fl_gains"] = max(errs["fl_gains"], _fl_close(
        g_k, g_p, None, TOL[torch.float32], "path A V' gains"))
    del panel
    print("path A main-path shapes: kernels match their plain versions (round 1,"
          f" a round-2-sized buffer of {mid}; full-width and V' gains, the V' "
          "panel bitwise equal to the gathered columns); greedy on V' selects "
          "the same set through the reference backend", flush=True)

    # bounds: 3 float32 instructions (subtract, max, add) per (probe,
    # candidate, row); each input read once, the output written once.
    b_ms, b_by, b_pipe = bound(N_A * N_A * 4 + m * N_A * 4 + m * 4 + N_A * 4,
                               fp32=3 * m * N_A * N_A)
    print(f"fl_divergence, round 1 ({N_A} candidates x {m} probes x {N_A} rows):"
          f" {ms:.4f} ms per launch, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}: {b_pipe}), library none; round-2-sized buffer ({mid} "
          f"gathered columns) {ms_mid:.4f} ms; "
          f"{counts['summarize']['fl_divergence']} launches in summarize")
    bf_ms, bf_by, bf_pipe = bound(N_A * N_A * 4 + 2 * N_A * 4, fp32=3 * N_A * N_A)
    bv_ms, bv_by, bv_pipe = bound(size * (N_A * 4 + 8 + 4) + N_A * 4,
                                  fp32=3 * size * N_A)
    print(f"fl_gains, full width (greedy on V, {N_A} x {N_A}): {ms_full:.4f} ms "
          f"per launch, plain {plain_full:.4f} ms, bound {bf_ms:.4f} ms ({bf_by}); "
          f"{counts['greedy_on_V']['fl_gains']} launches; over V' ({size} "
          f"columns, from the panel): {ms_vp:.4f} ms ({fmt_windows(t_vp)}), "
          f"gathered in place "
          f"{ms_gathered:.4f} ms, plain {plain_vp:.4f} ms, bound {bv_ms:.4f} ms "
          f"({bv_by}); {counts['summarize']['fl_gains']} launches in summarize; "
          f"the panel ({panel_bytes} bytes) gathered in {gather_ms:.4f} ms, "
          f"{counts['summarize']['panel_gathers']} per greedy run; library none",
          flush=True)
    profile_summarize("path A", fn, ("fl_gains_rows", "aten::index_select"))
    check(rel >= 0.95, f"path A: relative quality {rel} < 0.95")
    return [
        {"name": "fl_divergence", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fl_divergence.cu",
         "replaces": "src/repro/kernels/fl_divergence.py:110",
         "launches": counts["summarize"]["fl_divergence"],
         "max_abs_err": errs["fl_divergence"], "ms": ms, "plain_ms": plain_ms,
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
         "round2_sized": {"cands": mid, "ms": ms_mid}, "tile": tile},
        {"name": "fl_gains", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fl_divergence.cu",
         "replaces": "src/repro/kernels/fl_divergence.py:175",
         "launches": counts["summarize"]["fl_gains"],
         "max_abs_err": errs["fl_gains"], "ms": ms_vp, "plain_ms": plain_vp,
         "bound_ms": bv_ms, "bound_by": bv_by, "library_ms": None,
         "full_width": {"ms": ms_full, "plain_ms": plain_full, "bound_ms": bf_ms,
                        "bound_by": bf_by,
                        "launches": counts["greedy_on_V"]["fl_gains"]},
         "panel": {"ms": gather_ms, "bytes": panel_bytes,
                   "per_greedy_run": counts["summarize"]["panel_gathers"]},
         "gathered_ms": ms_gathered},
    ]


def _mask(n, idx):
    mask = torch.zeros(n, dtype=torch.bool, device="cuda")
    mask[idx] = True
    return mask


def fl_stream_path(errs: dict) -> list[dict]:
    """Path B: matrix-free FL over 2^18 clustered embeddings of width 16
    (dot similarity; the dense matrix would be 256 GiB)."""
    from repro_torch import (
        StreamingFacilityLocation, clustered_embeddings, greedy, summarize,
    )
    from repro_torch.core.greedy import compact_indices, selection_bucket
    from repro_torch.kernels import (
        fl_stream_divergence_kernel, fl_stream_divergence_ref,
        fl_stream_gains_kernel,
    )

    t = time.perf_counter()
    E = clustered_embeddings(0, N_B, D_B)
    t_host = time.perf_counter() - t
    fn = StreamingFacilityLocation.from_features(torch.from_numpy(E).cuda(), "dot")
    print(f"path B: clustered_embeddings(0, {N_B}, {D_B}): host set-up "
          f"{t_host:.2f} s", flush=True)
    kernels = {"fl_stream_divergence": fl_stream_divergence_kernel,
               "fl_stream_gains": fl_stream_gains_kernel}
    full, res, ss, counts, rel = _fl_drive("path B", fn, kernels)
    check(counts["summarize"]["panel_gathers"] == 0, "path B gathered a panel")

    # main-path shapes against plain.  A full-width plain round 1 would take
    # minutes, so the plain comparison runs on 2048 gathered candidates at
    # full served width; the kernel is timed on both.
    residual = fn.residual_gains()
    m, MU, resid = _round1(fn, residual)
    tile = fl_tile_report("fl_stream_divergence", m)
    X = fn.X
    div_k, (ms, *_) = kernel_ms(lambda: fl_stream_divergence_kernel(X, MU, resid),
                                1)
    check(div_k.shape == (N_B,) and bool(torch.isfinite(div_k).all()),
          "path B round 1 divergence: bad output")
    cand = torch.sort(torch.randperm(N_B, device="cuda")[:2048]).values
    d_k, (ms_2048, *_) = kernel_ms(lambda: fl_stream_divergence_kernel(
        X, MU, resid, cand), 3)
    d_p, (plain_ms, *_) = kernel_ms(lambda: fl_stream_divergence_ref(
        X, MU, resid, cand), 1)
    errs["fl_stream_divergence"] = max(errs["fl_stream_divergence"], _fl_close(
        d_k, d_p, resid, TOL[torch.float32], "path B 2048-candidate divergence"))
    errs["fl_stream_divergence"] = max(errs["fl_stream_divergence"], _fl_close(
        div_k[cand], d_p, resid, TOL[torch.float32],
        "path B round 1 divergence at 2048 candidates"))
    state_half = fn.add_many(fn.empty_state(), _mask(N_B, full.selected[: K // 2]))
    zero = torch.zeros(1, device="cuda")
    g_k, (ms_full, *_) = kernel_ms(lambda: fl_stream_gains_kernel(X, state_half), 3)
    g_p, (plain_g, *_) = kernel_ms(lambda: fl_stream_divergence_ref(
        X, state_half[None], zero, cand), 1)
    errs["fl_stream_gains"] = max(errs["fl_stream_gains"], _fl_close(
        g_k[cand], g_p, None, TOL[torch.float32], "path B full-width gains"))
    size = selection_bucket(N_B, int(ss.vprime.sum()))
    check(size is not None, "path B: V' does not fit a compact bucket")
    cand_vp = compact_indices(ss.vprime, size)
    st = res.state.float().contiguous()
    g_k, t_vp = kernel_ms(lambda: fl_stream_gains_kernel(X, st, cand_vp), 20)
    ms_vp = t_vp.ms
    g_p, (plain_vp, *_) = kernel_ms(lambda: fl_stream_divergence_ref(
        X, st[None], zero, cand_vp), 1)
    errs["fl_stream_gains"] = max(errs["fl_stream_gains"], _fl_close(
        g_k, g_p, None, TOL[torch.float32], "path B V' gains"))
    print("path B main-path shapes: kernels match their plain versions (round "
          "1 and the kernel's own 2048-candidate buffer against plain at full "
          "served width; full-width gains at 2048 candidates, V' gains); greedy "
          "on V' selects the same set through the reference backend", flush=True)

    # bounds: per (candidate, row) d FFMAs and one max for the similarity,
    # then 3 float32 instructions per probe.
    def stream_bound(k, r):
        return bound(N_B * D_B * 4 + k * (D_B * 4 + 4) + r * N_B * 4 + r * 4,
                     fp32=(3 * r + 1) * k * N_B, ffma=D_B * k * N_B)

    b_ms, b_by, b_pipe = stream_bound(N_B, m)
    b2_ms, _, _ = stream_bound(2048, m)
    print(f"fl_stream_divergence, round 1 ({N_B} candidates x {m} probes x "
          f"{N_B} rows, d = {D_B}): {ms:.4f} ms per launch, bound {b_ms:.4f} ms "
          f"({b_by}: {b_pipe}); at 2048 candidates {ms_2048:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b2_ms:.4f} ms; library none; "
          f"{counts['summarize']['fl_stream_divergence']} launches in summarize")
    bf_ms, bf_by, bf_pipe = stream_bound(N_B, 1)
    bv_ms, bv_by, bv_pipe = stream_bound(size, 1)
    regs, store, load, per_sm = ptxas_report("fl_stream", "fl_stream_gains_resident",
                                             threads=128)
    gains_ptxas = {"registers": regs, "spill_store_bytes": store,
                   "spill_load_bytes": load, "blocks_per_sm_by_registers": per_sm}
    print(f"fl_stream_gains (d <= 16: fl_stream_gains_resident): ptxas {regs} "
          f"registers, spill stores/loads {store}/{load} bytes, {per_sm} blocks "
          "of 128 threads per SM by registers", flush=True)
    print(f"fl_stream_gains, full width (greedy on V): {ms_full:.4f} ms per "
          f"launch, bound {bf_ms:.4f} ms ({bf_by}: {bf_pipe}), plain at 2048 "
          f"candidates {plain_g:.4f} ms; {counts['greedy_on_V']['fl_stream_gains']}"
          f" launches; over V' ({size} slots): {ms_vp:.4f} ms "
          f"({fmt_windows(t_vp)}), plain "
          f"{plain_vp:.4f} ms, bound {bv_ms:.4f} ms ({bv_by}: {bv_pipe}); "
          f"{counts['summarize']['fl_stream_gains']} launches in summarize; "
          "library none", flush=True)
    profile_summarize("path B", fn, ("fl_stream_gains",))

    # SS's quality at r = c = 8 falls as this data set grows, in the JAX
    # reference as in the port (they prune alike under the same draws,
    # tests/test_torch_fl_summarize.py), and at 2^18 it sits below the 0.95
    # of path A.  Measure it over seeds and sizes; hold each run to 0.93.
    rels = {"n=2^18 seed 0": rel}
    for seed in (1, 2):
        res_s, _ = summarize(fn, K, torch.Generator(device="cuda").manual_seed(seed),
                             r=R, c=C)
        rels[f"n=2^18 seed {seed}"] = float(res_s.value) / float(full.value)
    del fn
    for log_n in (16, 17):
        fn_n = StreamingFacilityLocation.from_features(
            torch.from_numpy(clustered_embeddings(0, 1 << log_n, D_B)).cuda(), "dot")
        res_n, _ = summarize(fn_n, K, torch.Generator(device="cuda").manual_seed(0),
                             r=R, c=C)
        rels[f"n=2^{log_n} seed 0"] = (float(res_n.value)
                                       / float(greedy(fn_n, K).value))
    print("path B relative quality: " + ", ".join(
        f"{k} {v:.6f}" for k, v in rels.items()), flush=True)
    check(min(rels.values()) >= 0.93,
          f"path B: relative quality {min(rels.values())} < 0.93")
    return [
        {"name": "fl_stream_divergence", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fl_stream.cu",
         "replaces": "src/repro/kernels/fl_stream.py:135",
         "launches": counts["summarize"]["fl_stream_divergence"],
         "max_abs_err": errs["fl_stream_divergence"], "ms": ms,
         "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": None,
         "at_2048_candidates": {"ms": ms_2048, "plain_ms": plain_ms,
                                "bound_ms": b2_ms}, "tile": tile},
        {"name": "fl_stream_gains", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fl_stream.cu",
         "replaces": "src/repro/kernels/fl_stream.py:201",
         "launches": counts["summarize"]["fl_stream_gains"],
         "max_abs_err": errs["fl_stream_gains"], "ms": ms_vp, "plain_ms": plain_vp,
         "bound_ms": bv_ms, "bound_by": bv_by, "library_ms": None,
         "full_width": {"ms": ms_full, "bound_ms": bf_ms, "bound_by": bf_by,
                        "plain_ms_at_2048_candidates": plain_g,
                        "launches": counts["greedy_on_V"]["fl_stream_gains"]},
         "ptxas": gains_ptxas},
    ]


# -- flash attention and the LM serving path ----------------------------------


def flash_close(out, ref, what: str) -> float:
    """Flash kernel vs the plain version on the same inputs, both float32
    inside; returns max |out - ref|, and keeps the largest share of the
    bfloat16 tolerance used in ``FLASH_WORST``.  float32: 2e-4 absolute
    (tests/test_kernels.py's).  bfloat16: per element, the output's own
    rounding, |out - ref| <= 2^-7 |ref| + 1e-3 max|ref over the row| (two
    float32 results rounded once to bfloat16 differ by at most one ulp,
    <= 2^-7 of the value; the row term covers the float32 difference where
    |ref| is tiny, and scales with the row so that a wrong late row, whose
    outputs average many keys and are small, is not hidden)."""
    check(out.shape == ref.shape and out.dtype == ref.dtype
          and bool(torch.isfinite(out).all()), f"{what}: bad output")
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    if out.dtype == torch.float32:
        check(err <= 2e-4, f"{what}: err {err} > 2e-4")
        return err
    r = ref.float().abs()
    tol = 2.0 ** -7 * r + 1e-3 * r.amax(-1, keepdim=True)
    worst = float((diff / tol.clamp_min(1e-30)).max())
    FLASH_WORST[0] = max(FLASH_WORST[0], worst)
    check(worst <= 1.0, f"{what}: err {err}, {worst:.3g} x the bfloat16 "
          "tolerance (2^-7 |ref| + 1e-3 row max|ref|)")
    return err


def flash_sweep(errs: dict) -> None:
    """The flash kernels vs their plain version on the card: float32 and
    bfloat16 x head_dim 32/64/128/256 x S = 96 (ragged), 128, 2048 x causal,
    a 32-wide window, or no mask x GQA groups of 1 and 4, then the TPU
    kernel's own (BH, S, hd) form (float32, and bfloat16 at head_dim 64 and
    128), held by ``flash_close``.  Each case goes through the route
    ``flash_route`` names; every bfloat16 case at head_dim 64 or 128 must
    launch the tensor-core kernel."""
    from repro_torch.kernels import (attention_ref, flash_attention_kernel,
                                     flash_attention_ref, flash_route)

    g = torch.Generator(device="cuda").manual_seed(5)
    cases, tc_cases = 0, 0

    def run(*args, **kw):
        nonlocal cases, tc_cases
        q = args[0]
        n_tc = flash_attention_kernel.launches_tc
        out = flash_attention_kernel(*args, **kw)
        tc = flash_route(q.dtype, q.shape[-1]) == "tc"
        check(flash_attention_kernel.launches_tc - n_tc == int(tc),
              f"flash {q.dtype} hd={q.shape[-1]}: not the {'tc' if tc else 'ffma'}"
              " route")
        cases += 1
        tc_cases += tc
        return out

    for dt, hd, S, (causal, window), G in itertools.product(
        (torch.float32, torch.bfloat16), (32, 64, 128, 256), (96, 128, 2048),
        ((True, 0), (True, 32), (False, 0)), (1, 4),
    ):
        B, KV = 2, 2
        q = torch.randn((B, S, KV * G, hd), generator=g, device="cuda").to(dt)
        k = torch.randn((B, S, KV, hd), generator=g, device="cuda").to(dt)
        v = torch.randn((B, S, KV, hd), generator=g, device="cuda").to(dt)
        out = run(q, k, v, causal=causal, window=window)
        ref = attention_ref(q, k, v, causal, window)
        err = flash_close(out, ref, f"flash_attention {dt} hd={hd} S={S} "
                          f"causal={causal} window={window} G={G}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
    # the TPU kernel's own (BH, S, hd) form
    for dt, hd in ((torch.float32, 64), (torch.bfloat16, 64), (torch.bfloat16, 128)):
        q, k, v = (torch.randn((8, 200, hd), generator=g, device="cuda").to(dt)
                   for _ in range(3))
        err = flash_close(run(q, k, v, window=48),
                          flash_attention_ref(q, k, v, True, 48),
                          f"flash_attention (BH, S, hd) form, {dt} hd={hd}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
    torch.cuda.synchronize()
    print(f"flash kernels vs plain: {cases} cases passed, {tc_cases} of them "
          f"(every bfloat16 case at head_dim 64 and 128) on the tensor-core "
          f"route; max abs err {errs['flash_attention']:.3g}; bfloat16 at most "
          f"{FLASH_WORST[0]:.4f} of its tolerance", flush=True)


@contextlib.contextmanager
def plain_attention(seen: list | None = None):
    """The LM path's attention through the plain version on the card (the
    comparison route); ``seen`` keeps the first call's (q, k, v)."""
    import repro_torch.models.attention as attn_mod
    from repro_torch.kernels import attention_ref

    def plain(q, k, v, *, causal, window):
        if seen is not None and not seen:
            seen.append((q, k, v))
        return attention_ref(q, k, v, causal, window)

    kernel = attn_mod.flash_attention_kernel
    attn_mod.flash_attention_kernel = plain
    try:
        yield
    finally:
        attn_mod.flash_attention_kernel = kernel


def _logits_close(got, want, what):
    """bfloat16 compute: the two routes differ in float32 summation order
    inside attention, so a bfloat16 rounding flips here and there and
    propagates through 36 layers; hold the logits to 3e-2 of their largest
    magnitude, the repository's bfloat16 tolerance."""
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(err <= TOL[torch.bfloat16] * scale,
          f"{what}: err {err} > {TOL[torch.bfloat16]} x {scale}")
    return err / scale


def profile_lm(label: str, call) -> dict:
    """One prefill or decode step under the profiler: device time by kernel
    (device events only) against the synchronised wall, and the flash
    kernel's share."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_kernel = sorted(
        ((e.self_device_time_total, e.key, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        reverse=True,
    )
    busy_ms = sum(us for us, _, _ in by_kernel) / 1e3
    check(busy_ms > 0, f"the profiler saw no device time in the {label}")
    flash_ms = sum(us for us, key, _ in by_kernel if "flash_kernel" in key) / 1e3
    launches = sum(count for _, _, count in by_kernel)
    print(f"profiled {label}: wall {wall_ms:.4f} ms, device busy {busy_ms:.4f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f}, {launches} device kernels; "
          f"flash kernel {flash_ms:.4f} ms = {flash_ms / busy_ms:.4f} of device time")
    for us, key, count in by_kernel[:10]:
        print(f"  {us / 1e3:10.4f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "flash_ms": flash_ms,
            "device_kernels": launches}


def lm_path(errs: dict) -> dict:
    """qwen3-4b at full width and depth on synthetic weights serves four
    2048-token prompts (greedy, 32 new tokens): launches (all 36 of a
    prefill on the tensor-core route), agreement with the plain route,
    timings, a profile of the prefill, and the flash kernels timed at the
    path's shape and at S = 32768 beside their bounds, with flip rates."""
    from repro_torch import configs
    from repro_torch.kernels import (attention_ref, attention_split_p_ref,
                                     flash_attention_kernel)
    from repro_torch.kernels.flash_attention import TC_PARTS, _launch
    from repro_torch.models import decode_step, forward, init_params, prefill
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.engine import _sample

    cfg = configs.get(LM_ARCH)
    B, S, NEW = LM_B, LM_S, LM_NEW
    t = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t_.numel() for t_ in tree_leaves(params))
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV heads x {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n_params} parameters "
          f"({cfg.param_dtype}, compute {cfg.compute_dtype}) made on the card in "
          f"{time.perf_counter() - t:.2f} s (the config counts "
          f"{cfg.param_count()}, norm scales aside)", flush=True)
    check(abs(n_params / cfg.param_count() - 1) < 1e-3,
          "the parameters are not the config's")
    sc = ServeConfig(max_len=S + NEW + 8)
    eng = Engine(cfg, params, sc)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")

    # the main path: Engine.generate, counts set to 0 just before
    flash_attention_kernel.launches = flash_attention_kernel.launches_tc = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    tokens, _ = eng.generate(prompts, NEW)
    torch.cuda.synchronize()
    wall_gen = time.perf_counter() - t
    launches = flash_attention_kernel.launches
    launches_tc = flash_attention_kernel.launches_tc
    check(tokens.shape == (B, NEW) and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.vocab_size, "generate: bad tokens")
    check(launches == launches_tc == cfg.num_layers,
          f"generate launched the flash kernels {launches} times ({launches_tc} "
          f"on the tensor-core route), not once per layer of the prefill "
          f"({cfg.num_layers}), all on the tensor-core route, and never in decode")
    print(f"generate: {B} x {S}-token prompts -> {tuple(tokens.shape)} tokens in "
          f"{wall_gen:.4f} s (host clock, synchronised, first call); flash "
          f"launches {launches}, {launches_tc} on the tensor-core route", flush=True)

    # the same path step by step, timed, with the counts per phase
    torch.cuda.reset_peak_memory_stats()
    flash_attention_kernel.launches = flash_attention_kernel.launches_tc = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = eng.prefill(prompts)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    tok = _sample(logits, None, sc)
    torch.cuda.synchronize()
    ttft_ms = (time.perf_counter() - t) * 1e3
    prefill_launches = flash_attention_kernel.launches
    prefill_tc = flash_attention_kernel.launches_tc
    flash_attention_kernel.launches = 0
    step_logits, toks = [logits], [tok]
    t = time.perf_counter()
    for n in range(S, S + NEW - 1):
        logits, cache = eng.decode_with_cache(tok, cache, n)
        tok = _sample(logits, None, sc)
        step_logits.append(logits)
        toks.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    decode_launches = flash_attention_kernel.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(prefill_launches == prefill_tc == cfg.num_layers and decode_launches == 0,
          f"launches: prefill {prefill_launches} ({prefill_tc} tensor-core), "
          f"decode {decode_launches}")
    check(torch.equal(torch.cat(toks, 1), tokens),
          "the step-by-step run gave other tokens than generate")
    ms_tok = decode_s * 1e3 / (NEW - 1)
    print(f"prefill {prefill_ms:.4f} ms, time to first token {ttft_ms:.4f} ms; "
          f"decode {ms_tok:.4f} ms per step ({B * (NEW - 1) / decode_s:.1f} "
          f"tokens/s over {B} requests); peak device memory {peak:.2f} GiB; "
          f"flash launches: prefill {prefill_launches}, decode {decode_launches}",
          flush=True)

    # the plain route: same weights, attention through the plain version,
    # fed the kernel route's tokens
    seen = []
    with plain_attention(seen):
        p_logits, p_cache = prefill(cfg, params, prompts, max_len=sc.max_len)
        rel = _logits_close(step_logits[0], p_logits, "prefill, kernel vs plain")
        for i, n in enumerate(range(S, S + NEW - 1)):
            p_logits, p_cache = decode_step(cfg, params, toks[i], p_cache, n)
            rel = max(rel, _logits_close(step_logits[i + 1], p_logits,
                                         f"decode step {i + 1}, kernel vs plain"))
    del p_cache
    full, _ = forward(cfg, params, torch.cat([prompts, toks[0]], 1),
                      logits_slice=1)
    rel_fwd = _logits_close(step_logits[1], full, "decode at S vs forward over S+1")
    print(f"plain route (attention through the plain version, the kernel route's "
          f"tokens): logits agree at every step, max err {rel:.4g} of max|logits|;"
          f" decode at position {S} vs forward over {S + 1} tokens {rel_fwd:.4g}",
          flush=True)
    prof = {"prefill": profile_lm("prefill", lambda: eng.prefill(prompts)),
            "decode_step": profile_lm("decode step", lambda: eng.decode_with_cache(
                toks[-1], cache, S + NEW - 1))}

    # the kernel at the path's shape: layer 0's (q, k, v) of the plain prefill
    q, k, v = seen[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KV

    def ffma(q_, k_, v_):
        # the CUDA-core kernel on the same bf16 inputs (the earlier design)
        out = torch.empty_like(q_)
        _launch(q_, k_, v_, out, True, 0, tc=False)
        return out

    out_k = flash_attention_kernel(q, k, v)
    out_f = ffma(q, k, v)
    ref = attention_ref(q, k, v, True, 0)
    for out, what in ((out_k, "tensor-core"), (out_f, "FFMA")):
        err = flash_close(out, ref, f"flash ({what}) at the path's shape")
        errs["flash_attention"] = max(errs["flash_attention"], err)
    # flip rates: the share of bf16 outputs that differ from the plain
    # version's (float32 P throughout, rounded once at the output)
    flips = {"tc": float((out_k != ref).float().mean()),
             "ffma": float((out_f != ref).float().mean())}
    for parts in (1, 2, 3):
        alt = attention_split_p_ref(q, k, v, True, 0, parts=parts)
        flips[f"plain_{parts}_parts"] = float((alt != ref).float().mean())
    del out_f, alt
    check(flips["tc"] <= flips["plain_1_parts"] / 4,
          f"flash flip rate {flips['tc']} is over a quarter of rounding P once "
          f"({flips['plain_1_parts']}): P·V does not keep float32 P")
    print(f"flip rates at the path's shape (bf16 outputs that differ from the "
          f"plain version): tensor-core route ({TC_PARTS} parts) "
          f"{flips['tc']:.6f}, FFMA kernel {flips['ffma']:.6f}; plain with P "
          f"rounded to bf16 once {flips['plain_1_parts']:.6f}, in 2 parts "
          f"{flips['plain_2_parts']:.6f}, in 3 parts {flips['plain_3_parts']:.6f}",
          flush=True)

    # both kernels in turns (tc, ffma, ffma, tc), then plain and the library
    def in_turns(args, n_tc, n_ffma):
        t1 = kernel_ms(lambda: flash_attention_kernel(*args), n_tc)[1].ms
        f1 = kernel_ms(lambda: ffma(*args), n_ffma)[1].ms
        f2 = kernel_ms(lambda: ffma(*args), n_ffma)[1].ms
        t2 = kernel_ms(lambda: flash_attention_kernel(*args), n_tc)[1].ms
        return (t1 + t2) / 2, (f1 + f2) / 2, (t1, f1, f2, t2)

    ms, ffma_ms, turns = in_turns((q, k, v), 20, 5)
    plain_ms = kernel_ms(lambda: attention_ref(q, k, v, True, 0), 3)[1].ms
    qx, kx, vx = (t_.transpose(1, 2).contiguous() for t_ in (
        q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = kernel_ms(lambda: sdpa(qx, kx, vx, is_causal=True), 20)[1].ms

    def flash_bounds(b, s):
        # One exponential a causal (q, k) pair.  The tensor-core design: QKᵀ
        # on bf16 q, k (exact products, float32 sums) and P·V as TC_PARTS
        # bf16 products, all at the tensor cores' rate.  Yardsticks: the
        # FFMA design (P·V on the CUDA cores) and both products once on the
        # tensor cores (P rounded once: a different result).
        pairs = b * H * s * (s + 1) / 2
        nbytes = (2 * b * s * H * hd + 2 * b * s * KV * hd) * q.element_size()
        check(q.dtype == torch.bfloat16, "flash_bounds count bfloat16 inputs")
        tc = bound(nbytes, sfu=pairs, bf16_tc=(2 + 2 * TC_PARTS) * pairs * hd)
        ffma_design = bound(nbytes, ffma=pairs * hd, sfu=pairs,
                            bf16_tc=2 * pairs * hd)[0]
        return tc, ffma_design, 4 * pairs * hd / BF16_TENSOR_FLOPS_PER_S * 1e3

    (b_ms, b_by, b_pipe), ffma_bound, tc_ms = flash_bounds(B, S)
    share = b_ms / ms
    check(share <= 1.05, f"flash runs at {share:.3f} of its bound: the count "
          "is wrong")
    print(f"flash_attention at the path's shape (B={B}, S={S}, H={H}, KV={KV}, "
          f"hd={hd}, bf16, causal): tensor-core route {ms:.4f} ms per launch "
          f"(in turns {', '.join(f'{x:.4f}' for x in turns)}: tc, ffma, ffma, tc), "
          f"bound {b_ms:.4f} ms ({b_by}: {b_pipe}), share of the bound "
          f"{share:.4f}; FFMA kernel {ffma_ms:.4f} ms (its design's bound "
          f"{ffma_bound:.4f} ms); both products once on the bf16 tensor cores "
          f"{tc_ms:.4f} ms; plain {plain_ms:.4f} ms; library "
          f"(scaled_dot_product_attention, is_causal) {lib_ms:.4f} ms; "
          f"{launches} launches per prefill = {ms * launches:.4f} ms", flush=True)

    # one long request: S = 32768, B = 1, as the prefill_32k cells
    del out_k, ref, qx, kx, vx
    long = 32768
    q1 = torch.randn((1, long, H, hd), generator=gen, device="cuda").bfloat16()
    k1 = torch.randn((1, long, KV, hd), generator=gen, device="cuda").bfloat16()
    v1 = torch.randn((1, long, KV, hd), generator=gen, device="cuda").bfloat16()
    out_long = flash_attention_kernel(q1, k1, v1)
    err_plain = flash_close(out_long, attention_ref(q1, k1, v1, True, 0),
                            f"flash at S={long} vs plain")
    errs["flash_attention"] = max(errs["flash_attention"], err_plain)
    long_ms, long_ffma, turns_l = in_turns((q1, k1, v1), 5, 1)
    qx, kx, vx = (t_.transpose(1, 2).contiguous() for t_ in (
        q1, k1.repeat_interleave(G, dim=2), v1.repeat_interleave(G, dim=2)))
    lib_out = sdpa(qx, kx, vx, is_causal=True)
    lib_long = kernel_ms(lambda: sdpa(qx, kx, vx, is_causal=True), 5)[1].ms
    # the library rounds P to bfloat16 before P·V, so it is held only to the
    # repository's bfloat16 tolerance; the kernel is held to the plain version
    err_long = float((out_long.float() - lib_out.transpose(1, 2).float()).abs().max())
    check(err_long <= TOL[torch.bfloat16] * float(v1.float().abs().max()),
          f"flash at S={long} vs the library: err {err_long}")
    (bl_ms, bl_by, _), ffma_bound_l, tc_l = flash_bounds(1, long)
    share_l = bl_ms / long_ms
    check(share_l <= 1.05, f"flash at S={long} runs at {share_l:.3f} of its bound")
    print(f"flash_attention at S={long}, B=1: tensor-core route {long_ms:.4f} ms "
          f"per launch (in turns {', '.join(f'{x:.4f}' for x in turns_l)}), "
          f"bound {bl_ms:.4f} ms ({bl_by}), share {share_l:.4f}; FFMA kernel "
          f"{long_ffma:.4f} ms (its design's bound {ffma_bound_l:.4f} ms); both "
          f"products once on the tensor cores {tc_l:.4f} ms; library "
          f"{lib_long:.4f} ms; vs plain err {err_plain:.3g}, vs the library "
          f"{err_long:.3g}; bfloat16 checks at most {FLASH_WORST[0]:.4f} of "
          "their tolerance", flush=True)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention.py:122",
        "launches": launches, "max_abs_err": errs["flash_attention"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
        "launches_tc": launches_tc, "parts": TC_PARTS, "share_of_bound": share,
        "flip_rates": flips,
        "ffma_design_bound_ms": ffma_bound, "tensor_core_bound_ms": tc_ms,
        "ffma_kernel": {"source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "ms": ffma_ms, "at_32k_ms": long_ffma},
        "at_32k": {"ms": long_ms, "bound_ms": bl_ms, "share_of_bound": share_l,
                   "ffma_design_bound_ms": ffma_bound_l,
                   "tensor_core_bound_ms": tc_l, "library_ms": lib_long},
        "lm_path": {"arch": cfg.name, "batch": B, "prompt": S, "new": NEW,
                    "prefill_ms": prefill_ms, "ttft_ms": ttft_ms,
                    "decode_ms_per_step": ms_tok, "peak_gib": peak,
                    "profile": prof},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build, load_library

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}",
          flush=True)
    card_rates()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmul is on: the FL similarities need IEEE float32")

    # 2. the build, from the sources in this checkout
    t = time.perf_counter()
    build(force=True)
    load_library()
    print(f"build: {time.perf_counter() - t:.2f} s (nvcc, sm_90a, one process "
          "per source)", flush=True)

    # 3. kernel vs plain, and the small pipeline
    errs = {"ss_divergence": 0.0, "feature_gains": 0.0}
    sweep(errs)
    sparse_sweep(errs)
    route_check()
    small_pipeline()

    # 4-7. the FeatureCoverage main path at full size
    records = fc_path(errs)

    # 8-9. facility location: kernel vs plain, the small pipelines
    errs.update(fl_divergence=0.0, fl_gains=0.0, fl_stream_divergence=0.0,
                fl_stream_gains=0.0)
    torch.cuda.empty_cache()
    fl_sweep(errs)
    fl_small_pipelines()

    # 10-11. path A and path B at full size, each on a freed card
    for path in (fl_dense_path, fl_stream_path):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        records += path(errs)
    # 12-13. flash attention: kernel vs plain, then the LM serving path
    errs["flash_attention"] = 0.0
    torch.cuda.empty_cache()
    flash_sweep(errs)
    torch.cuda.reset_peak_memory_stats()
    records.append(lm_path(errs))
    check(len(records) == 7 and all(
        math.isfinite(r_[k]) for r_ in records
        for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")),
        "a measurement is missing or not finite")
    check(math.isfinite(records[-1]["library_ms"]), "flash: no library time")

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
