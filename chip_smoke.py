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
its plain version, and profiles the path.  On each SS path's objective at
full size it also runs stochastic greedy over V' and over V (k = 32, s from
the live count: the gains kernel once a step), and on FeatureCoverage lazy
greedy over the first sixteenth of V and over V' (every evaluation through
the kernel, f(S) equal to greedy's on the same set); the §3.4 post-reduction runs after SS on a 2^16-sentence news
day.  At n = 4096 the three objectives hold stochastic and lazy greedy to
the plain backend and ``postreduce`` on the card to the host under the same
draws, and ``examples/quickstart_torch.py`` runs on the card.  At the end
of each SS path ``summarize_sharded`` runs on the path's own objective at
one rank over NCCL (``sharded_one_rank``), and after path B four ranks of
this script share the card over gloo and hold the kernel route to the
plain route (``sharded_phase``; ``--sharded-rank R STORE OUT`` is one of
them).  After each
path's selectors the streaming baseline, sieve streaming (k = 32, the
legacy 50 thresholds; on FeatureCoverage also eps = 0.1), runs at full size
in exact chunks over its gain-table kernel ``sieve_gains``: the card's
decisions are held to the plain table's (full size on FeatureCoverage,
n = 4096 on all three, where one shot, two halves and per-element updates
agree bit for bit; on path B at full size an element's similarity column
is checked to have one set of bits wherever it sits in its block), and the
row sieve runs over 2^12 rows against the index sieve.  Each path's
``sieve_gains`` launches in the legacy run are recorded as a histogram of
(sieves, columns, columns due from the starts), and the sieve's kernels
timed on that mix (profiler); ``sieve_gains`` is timed at each path's
record shape and at a re-launch the run really made, by route
(FeatureCoverage's sparse walk over W's nonzeros, its dense blocks
through the tile, held to each other bit for bit on the same rows at full
size), with ptxas' registers and spills and the facility location tile's
SASS a term.  Batched
execution runs as the summarization service's lanes: the first 2^19
sentences of the news day as 8 queries of 2^16 (a view, no new bytes) and
4 queries of 2^13 frames of path A's video (cosine, 1 GiB of stacked
similarities), each through ``summarize_batch`` (one kernel launch a row a
round or step), its rows held bit for bit to the card's single-query
``summarize``, its stochastic selector to per-row stochastic greedy, its
streamed selection to the unstreamed one, its wall to the single queries'.
The summarization service then serves those lanes (``service_phase``): one
sync flush of three lanes and an async run, every response held bit for bit
to the core's run, with no recovery, no degradation and the kernels'
launches counted; seeded faults (retries bit-identical, a failover to the
plain route on the card within TOL, the watchdog, a crash); and a traced
run that changes no bit.  The durable session tier follows
(``session_phase``): 16 sessions of 384 news rows (F = 1024, k = 32)
appended round robin on a durable root, each final state and summary equal
to a B = 1 replay bit for bit, every SS compaction and summary held to the
plain route on the same inputs, then a crash, two restarts, a torn WAL
tail and the eviction ladder, each ending in the same bits, and a traced
run.
After the LM path, a fresh prefill's KV cache is pruned to 256 positions
(``Engine.prune_kv``, coverage and fl objectives, the kernel route held to
the plain one under the same draws) and 32 tokens are decoded from it,
held to the plain attention at every step.
Then the other block types serve at full width and depth,
each on a freed card (``lm_families_phase``): olmoe-1b-7b (16 attn_moe
layers, 64 experts top-8; flash on the tensor-core route) and mamba2-780m
(48 SSD layers, no kernel) on four 2048-token prompts, recurrentgemma-2b
(26 rglru / local layers; flash on the tensor-core route at head_dim 256,
window 2048) on four
4096-token prompts, 32 new tokens each: launches, TTFT, decode, peak, the
plain attention route's logits at every step (olmoe: the prefill's; its
decode steps' differences are printed), the prefill layer by layer
(each attention layer's flash output against the plain version on the
same inputs, each MoE layer's top-8 under both routes with any differing
choice shown a near tie, the pairs capacity drops), decode seeded by the
prefill against the forward (the recurrent families), a profiled prefill,
and at each attention family's shape the tensor-core and FFMA kernels
timed in turns beside the bounds, the plain version and
``scaled_dot_product_attention`` with the mask as a tensor
(``_flash_at_shape``; recurrentgemma's goes into the flash record as
``at_recurrentgemma``).
Then training (``train_phase``, on a freed card): the flash backward
kernels (by ``flash_bwd_route``: the tensor-core route for bf16 at
head_dim 64/128/256, FFMA for float32 and bf16 at 32) against their
plain version over a sweep (both dtypes, head_dim 32
to 256, grouped KV, three masks, S from 1 to 1000, causal bf16 at 2048
and 4096, MQA 10:1 at head_dim 256 with window 2048 at S 3000 and 4096,
the TPU layout; the forward's O with and without L bitwise equal), ptxas'
report of the tensor-core instances, and at llama3.2-3b's and
recurrentgemma-2b's shapes (both routes in turns) beside the bounds, the
plain backward and SDPA's, with flip rates; then llama3.2-3b and
recurrentgemma-2b, each at full width and depth: step 0's loss and every
gradient leaf on the kernel route against the plain attention route, and
8 steps through ``launch/train.py`` (the main path: AdamW, remat
"nothing", SS-selected batches of 4 x 2048 and 2 x 4096; 56 forward and
28 backward flash launches a llama step, 16 and 8 a recurrentgemma step
(its eight local layers), all on the tensor-core route, SS's kernels
every batch, the loss falling, one step profiled); checkpoint, SIGTERM
and resume on
the card; and the data pipeline at a 256 x 2048 global batch with both SS
objectives, its picks held to the plain route's.  Then LM training sharded
over a DeviceMesh (``lm_sharded_phase``): ``launch/train.py --mesh 1x1`` on
a one-rank NCCL group at llama3.2-3b's full size with the training run's
seed and arguments (its three losses against that run's; step time, peak,
flash launches, the collectives DTensor issues), then four ranks of this
script on the card over gloo (``--lm-sharded-rank R STORE OUT``, DTensor's
all-gathers staged through the host): llama3.2-3b cut to 2 layers through
``launch/train.py --mesh 2x2`` (3 steps), olmoe-1b-7b cut alike
(Adafactor, µ = 2) and the compressed pod step on (2, 1, 2) on the kernel
and the plain attention routes (one step each at the full rate, each
parameter's change and the error state held across the routes), each held
to the plain step, qwen3-4b cut to 2 layers served sharded (a 4 x 1024 prefill
and 4 decode steps, held to one unsharded process), and the flash kernels
at a rank's shard shapes; each rank records the collectives of that
prefill, its first decode step and the second llama step with the dry
run's ``CostMode``, and rank 0's must equal the counter's count of the same
steps on a fake group of four.  Sharded serving at one rank runs inside
the LM path: qwen3-4b at full size on a (1, 1) NCCL mesh from the path's
parameters and prompts, bit for bit with its plain run.  Then the three examples
run through their own ``main`` (``examples_phase``), each kernel's launches
counted from 0 for each: ``video_summarize_torch.py`` at Table 2's longest
video (9721 frames, k = 1458; SS and greedy on the kernels against the
plain backend under the same draws, any differing decision shown a near
tie in float64); ``serve_kv_pruning_torch.py`` on qwen2-7b's smoke config
at head_dim 32 (float32, the FFMA flash kernel) and on qwen2-7b at full
width and depth (28 layers, GQA 28:4 at head_dim 128 with QKV bias, 2 x
2048 tokens pruned to 512 positions, then to 256; the service keeps what
``prune_kv`` keeps), whose parameters serve the LM main path (TTFT, decode, peak),
are held to the plain attention route at every step and give the flash
kernels their shape (``at_qwen2_7b`` in the flash record); and
``train_lm_ss_torch.py``, 100 steps each of uniform and SS selection on
llama3.2-3b's smoke config at head_dim 32 (the FFMA flash kernels forward
and backward; SS keeps each pool of 32 whole).  Last, each timed LM
step (the four prefills and decode steps, the two train steps) beside its
bound: counted on fake tensors (``repro_torch.launch``: FLOPs by dtype,
the eager program's bytes, the live-bytes peak) by a process of its own
that starts after the build, with the card hidden, while the card runs
the rest; the line of each step prints the bound and what binds it, mfu,
the share (bound / measured, at most 1.05) and the counted peak against
the measured (within 25 %).  The same counter counts part (b)'s three
sharded steps first, and last two of the dry run's production cells
(llama3.2-3b train_4k on 16 x 16, qwen3-4b decode_32k on 2 x 16 x 16, a
fake group of 256 or 512 ranks), whose three terms the roofline phase
prints.
The
FeatureCoverage kernels sum only the terms W's nonzeros make nonzero, so
they are also swept over sparse W and their bounds count what these inputs
need (W read once as stored, the work of its nonzeros), printed beside the
dense bounds; so does ``sieve_gains``' bound; the divergence is
also timed on a dense random W of round 1's shape.  Every time follows one
rule, ``kernel_ms``: the median of 5 windows of back-to-back calls between
CUDA events, each window queued behind a sleep on the card where Python's
enqueue takes at least half of it, so that the events time the card alone.

The last lines of its output are JSON: the block types' figures
(``lm_families``), training's (``training``), the examples'
(``examples``), the steps' bounds
(``roofline``), the sharded phase's (``sharded``), the LM sharding's
(``lm_sharded``), sharded serving's (``lm_sharded_serve``), the dry run's
production cells (``dryrun``), the kernels' records
(nine), then ``{"ok": true,
"device": {...}}``.  Any failure raises before them, and the
script exits non-zero without a CUDA device or outside a checkout.

    python3 chip_smoke.py --lm-sharded

runs the LM sharding phase alone after a five-step run of training's (c),
with no kernel records and no result line.

    python3 chip_smoke.py --first-chunk cold|warmed

runs only the service's first coverage chunk in a fresh process
(``first_chunk_probe``) and prints its numbers, the last line as JSON;
``--count-roofline PATH`` only counts the LM steps on fake tensors into
PATH, part (b)'s sharded steps into PATH.ranks.json and the production
cells into PATH.pod.json (``count_cells``: host work, no card).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

# Main-path configuration: the paper's news setting scaled to one card.
N, F, K, R, C = 1 << 20, 1024, 32, 8, 8.0
# Path A (dense FL over video frames) and path B (matrix-free FL).
N_A, F_A = 1 << 16, 256
N_B, D_B = 1 << 18, 16
# The H100 SXM's published peaks (HBM bandwidth, bf16 tensor-core and
# float32 FFMA FLOP/s, other float32 instructions a second) are
# ``repro_torch.launch.mesh.HW``, the roofline's own.  The special-function
# units (sqrt.approx, lg2) issue 16 per clock per SM: that rate comes from
# the card's SM count and maximum SM clock.
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


def mark(what: str) -> None:
    """The script's elapsed time (host clock) as a phase ends."""
    print(f"[{time.perf_counter() - T0[0]:.1f} s] {what} done", flush=True)


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
    (``bf16_tc`` flops) on the tensor cores at 989 TFLOP/s; the rates of
    ``repro_torch.launch.mesh.HW`` but the card's own special-function
    rate).  Returns (ms, "bytes" or "operations", the binding one)."""
    from repro_torch.launch.mesh import HW

    times = {
        "bytes": bytes_moved / HW["hbm_bw"],
        "fp32": fp32 / HW["fp32_instr_per_s"],
        "ffma": 2.0 * ffma / HW["peak_flops_f32"],
        "sfu": sfu / RATES["sfu"],
        "bf16_tc": bf16_tc / HW["peak_flops_bf16"],
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


# -- the paper's other selectors and the §3.4 post-reduction ------------------


def _small_objectives(n: int) -> dict:
    """The three objectives at a small n, each built on a given device from
    the same numpy data."""
    from repro_torch import (
        StreamingFacilityLocation, clustered_embeddings,
        facility_location_from_features, feature_coverage_from_numpy, news_day,
        video,
    )

    W, X, E = news_day(0, n, 512), video(0, n, 256), clustered_embeddings(0, n, 16)
    return {
        "FeatureCoverage": lambda dev: feature_coverage_from_numpy(W, device=dev),
        "dense FL": lambda dev: facility_location_from_features(X, "cosine",
                                                                device=dev),
        "matrix-free FL": lambda dev: StreamingFacilityLocation.from_features(
            torch.from_numpy(E).to(dev), "dot"),
    }


def _shared_cover_eps(fn, fn_cpu, members, pruned, eps0: float) -> tuple[float, float]:
    """An eps at or above ``eps0`` at which the card's and the host's float32
    edge weights of ``members`` (the arithmetic of ``postreduce``'s edge
    pass on each device) cover the same pruned elements: the midpoint of the
    first gap between consecutive card weights where both devices' covers
    agree.  Sums in another order differ in their last bits, which can move
    an edge lying within a rounding of eps across it; at such an eps both
    devices must then keep the same members.  Also returns the largest
    |card - host| edge weight, held to TOL of the weights' size."""
    from repro_torch.core.sparsify import member_edges

    valid = torch.ones_like(members, dtype=torch.bool)
    W_k = torch.cat([w for _, w in member_edges(fn, members, valid)])[:, pruned]
    W_p = torch.cat([w for _, w in member_edges(fn_cpu, members.cpu(),
                                                valid.cpu())])[:, pruned.cpu()]
    err = float((W_k.cpu() - W_p).abs().max())
    scale = max(1.0, float(W_p.abs().max()))
    check(err <= TOL[torch.float32] * scale,
          f"postreduce edge weights: card vs host err {err} > TOL x {scale}")
    vals = torch.unique(W_k.flatten())                      # ascending
    vals = vals[vals >= eps0]
    for lo, hi in zip(vals[:-1].tolist(), vals[1:].tolist()):
        eps = 0.5 * (lo + hi)
        if torch.equal((W_k <= eps).cpu(), W_p <= eps):
            return eps, err
    fail("postreduce: no eps above eps_hat where card and host covers agree")


def host_syncs(call) -> int:
    """How many synchronising CUDA operations (a value read back to the
    host, a stream synchronise) one call makes: torch.cuda's sync debug mode
    warns at each.  The mode is switched on outside the count: its first
    switch in a process warns once itself."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def selectors_small() -> None:
    """Stochastic greedy, lazy greedy and postreduce at n = 4096 on the three
    objectives.  Stochastic greedy over V and over V' (after an SS run)
    through the kernels and through the plain backend under the same
    injected noise: the same picks, gains within TOL; greedy and stochastic
    greedy over V and V' through the kernels make as many host syncs in k
    steps as in one (no step waits on the host); lazy greedy the same picks,
    gains within TOL; postreduce on the card and on the host under the same
    uniforms (at an eps where both devices' edge weights cover alike): the
    same mask."""
    from repro_torch import (
        SSResult, greedy, lazy_greedy, postreduce, ss_sparsify, stochastic_greedy,
    )
    from repro_torch.core import selection_bucket
    from repro_torch.core.greedy import gumbel

    n, k = 4096, 10
    for label, make in _small_objectives(n).items():
        fn = make("cuda")
        g = torch.Generator(device="cuda").manual_seed(2)
        ss = ss_sparsify(fn, g, r=R, c=C)
        nv = int(ss.vprime.sum())
        syncs = []
        for where, alive in (("V", None), ("V'", ss.vprime)):
            m = n if alive is None else selection_bucket(n, nv)
            noise = torch.stack([gumbel(m, g, "cuda") for _ in range(k)])
            a = stochastic_greedy(fn, k, alive=alive, noise=noise)
            b = stochastic_greedy(fn, k, alive=alive, noise=noise,
                                  backend="reference")
            check(torch.equal(a.selected, b.selected),
                  f"small {label} stochastic greedy on {where}: picks differ")
            err = float((a.gains - b.gains).abs().max())
            check(err <= TOL[torch.float32] * max(1.0, float(b.gains.abs().max())),
                  f"small {label} stochastic greedy on {where}: gains err {err}")
            check(alive is None or bool(alive[a.selected].all()),
                  f"small {label} stochastic greedy left V'")
            for name, select in (("greedy", greedy),
                                 ("stochastic greedy", stochastic_greedy)):
                def run(kk, select=select, alive=alive):
                    extra = ((torch.Generator(device="cuda").manual_seed(4),)
                             if select is stochastic_greedy else ())
                    return select(fn, kk, *extra, alive=alive)

                one, many = host_syncs(lambda: run(1)), host_syncs(lambda: run(k))
                check(many == one, f"small {label} {name} on {where}: {many} host "
                      f"syncs in {k} steps, {one} in 1 (a step waits on the host)")
                syncs.append(f"{name} on {where} {one}")
        lz_k, lz_p = lazy_greedy(fn, k), lazy_greedy(fn, k, backend="reference")
        check(torch.equal(lz_k.selected, lz_p.selected),
              f"small {label} lazy greedy: picks differ")
        lz_err = float((lz_k.gains - lz_p.gains).abs().max())
        check(lz_err <= TOL[torch.float32] * max(1.0, float(lz_p.gains.abs().max())),
              f"small {label} lazy greedy: gains err {lz_err}")

        # postreduce over V''s |V'| slots on the card and on the host
        fn_cpu = make("cpu")
        members = torch.nonzero(ss.vprime).flatten()
        eps, err = _shared_cover_eps(fn, fn_cpu, members, ~ss.vprime,
                                     float(ss.eps_hat))
        u = torch.rand((nv,), generator=g, device="cuda")
        vpp = postreduce(fn, ss, eps, max_members="exact", noise=u)
        ss_cpu = SSResult(ss.vprime.cpu(), None, None, ss.rounds, None)
        vpp_cpu = postreduce(fn_cpu, ss_cpu, eps, max_members="exact", noise=u.cpu())
        check(torch.equal(vpp.cpu(), vpp_cpu),
              f"small {label} postreduce: card and host masks differ")
        check(bool((~vpp | ss.vprime).all()) and int(vpp.sum()) > 0,
              f"small {label} postreduce: V'' is empty or leaves V'")
        print(f"small {label} selectors (n={n}, k={k}): stochastic greedy on V "
              f"and V' cuda == reference; host syncs a run, the same at k = 1 "
              f"and k = {k}: {', '.join(syncs)}; lazy greedy cuda == reference, "
              f"gains err {lz_err:.3g} "
              f"({lz_k.reevaluations} re-evaluations); postreduce card == host, "
              f"|V'| = {nv} -> |V''| = {int(vpp.sum())} at eps {eps:.6f} "
              f"(eps_hat {float(ss.eps_hat):.6f}; edge weights card vs host err "
              f"{err:.3g})", flush=True)
        del fn, fn_cpu
        torch.cuda.empty_cache()


def quickstart_phase() -> None:
    """``examples/quickstart_torch.py`` on the card, asserts included, and
    its sieve streaming relative held to [0.6, 1 + 1e-5] (0.6: the
    reference's floor on FeatureCoverage, ``tests/test_sieve.py:41``)."""
    import runpy

    path = Path(__file__).resolve().parent / "examples" / "quickstart_torch.py"
    argv = sys.argv
    sys.argv = [str(path)]
    t = time.perf_counter()
    try:
        out = runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = argv
    rel = out["sieve_relative"]
    check(0.6 <= rel <= 1.0 + 1e-5,
          f"quickstart: sieve streaming relative {rel} outside [0.6, 1 + 1e-5]")
    print(f"examples/quickstart_torch.py on the card passed its asserts in "
          f"{time.perf_counter() - t:.2f} s; sieve streaming relative {rel:.6f}",
          flush=True)


def _synced(call):
    """(result, seconds) of one call on the host clock, synchronised."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def stochastic_phase(label: str, fn, ss, full, wall_full: float, kernel,
                     panel: bool = False) -> dict:
    """Stochastic greedy at k = K, s = None, over V' (after the path's SS)
    and over V, while the path's objective is on the card: each run with
    the gains kernel's count (and the V' panel gathers) set to 0 just before
    and read just after.  Checks K launches a run, picks in V', one panel
    gather over V' where the path takes panels, and as many host syncs in K
    steps as in one; prints s, the synchronised
    wall beside greedy on V's, the device busy time of a profiled rerun and
    f(S) relative to greedy on V."""
    from repro_torch import stochastic_greedy
    from repro_torch.core import auto_sample_size
    from repro_torch.kernels import fl_gains_panel

    out = {}
    f_full = float(full.value)
    for where, alive in (("V'", ss.vprime), ("V", None)):
        live = fn.n if alive is None else int(alive.sum())
        s = auto_sample_size(fn.n, K, 0.1, live)

        def call(k=K):
            return stochastic_greedy(
                fn, k, torch.Generator(device="cuda").manual_seed(3), alive=alive)

        kernel.launches = 0
        fl_gains_panel.gathers = 0
        res, wall = _synced(call)
        launches, gathers = kernel.launches, fl_gains_panel.gathers
        what = f"{label} stochastic greedy on {where}"
        check(res.selected.shape == (K,) and bool(torch.isfinite(res.gains).all()),
              f"{what}: wrong shape or non-finite gains")
        check(int(res.selected.unique().numel()) == K, f"{what}: picked twice")
        check(alive is None or bool(alive[res.selected].all()), f"{what}: left V'")
        check(launches == K, f"{what}: {launches} launches of the gains kernel, "
              f"not one a step ({K})")
        want = int(panel and alive is not None)
        check(gathers == want, f"{what}: {gathers} panel gathers, not {want}")
        syncs, syncs_1 = host_syncs(call), host_syncs(lambda: call(1))
        check(syncs == syncs_1, f"{what}: {syncs} host syncs in {K} steps, "
              f"{syncs_1} in 1 (a step waits on the host)")
        rel = float(res.value) / f_full
        prof = profile_run(what, call, watch=("Memcpy DtoH",), top=4)
        busy = prof.get("busy_ms")  # None: the profiler saw no device time
        print(f"{what}: s = {s} of {live}, f(S) = {float(res.value):.6f}, relative "
              f"to greedy on V {rel:.6f}; wall {wall:.4f} s (host clock, "
              f"synchronised; greedy on V {wall_full:.4f} s); device busy "
              + ("not measured" if busy is None else f"{busy:.4f} ms")
              + f" (profiler, a rerun); {launches} gains launches, {gathers} "
              f"panel gathers; {syncs} host syncs a run, as at k = 1", flush=True)
        out[where] = {"s": s, "relative": rel, "wall_s": wall, "busy_ms": busy,
                      "launches": launches, "panel_gathers": gathers,
                      "host_syncs": syncs}
    return out


# Lazy greedy's ground set on FeatureCoverage: the first LAZY_PREFIX of the
# 2^20 sentences (on all of V it re-evaluates about 395000 times, one
# launch each, for about a minute; an eighth took 12.1 s).  A sixteenth
# since the sharded phase came, to keep the script within its time.
LAZY_PREFIX = N // 16


def lazy_phase(fn, ss, res) -> dict:
    """Lazy greedy on FeatureCoverage at full size, on the first
    ``LAZY_PREFIX`` sentences of V (against greedy on the same prefix) and
    on V' (against greedy on V'), with feature_gains' count set to 0 just
    before and read just after: every evaluation goes through the kernel
    (one full-width bound pass, then one one-slot call per re-evaluation),
    and f(S) equals greedy's to 1e-5 relative (news_day has duplicate rows,
    so picks may differ where gains tie: the differing positions are
    printed)."""
    from repro_torch import greedy, lazy_greedy
    from repro_torch.kernels import feature_gains_kernel

    prefix = torch.arange(fn.n, device="cuda") < LAZY_PREFIX
    out = {}
    where_v = f"the first {LAZY_PREFIX} of V"
    for where, alive, ref in ((where_v, prefix, greedy(fn, K, alive=prefix)),
                              ("V'", ss.vprime, res)):
        feature_gains_kernel.launches = 0
        lz, wall = _synced(lambda: lazy_greedy(fn, K, alive=alive))
        launches = feature_gains_kernel.launches
        what = f"lazy greedy on {where}"
        check(launches == 1 + lz.reevaluations,
              f"{what}: {launches} feature_gains launches for "
              f"{lz.reevaluations} re-evaluations (want one more)")
        f_lz, f_ref = float(lz.value), float(ref.value)
        check(abs(f_lz - f_ref) <= 1e-5 * f_ref,
              f"{what}: f(S) {f_lz} vs greedy's {f_ref}")
        diff = torch.nonzero(lz.selected != ref.selected).flatten().tolist()
        print(f"{what}: f(S) = {f_lz:.6f} (greedy {f_ref:.6f}), "
              f"{lz.reevaluations} re-evaluations, {launches} feature_gains "
              f"launches, wall {wall:.4f} s (host clock, synchronised); picks "
              f"differ from greedy's at positions {diff}"
              + "".join(f" [{i}: {int(lz.selected[i])} gain {float(lz.gains[i]):.6f}"
                        f" vs {int(ref.selected[i])} gain {float(ref.gains[i]):.6f}]"
                        for i in diff), flush=True)
        out[where] = {"reevaluations": lz.reevaluations, "launches": launches,
                      "wall_s": wall, "differing_positions": diff}
    return out


def postreduce_path() -> dict:
    """postreduce (§3.4 improvement 3) after SS at r = c = 8 on
    news_day(0, 2^16, 1024), eps = eps_hat: V'' must be a nonempty subset
    of V'; prints |V'|, |V''|, the wall, the peak device memory and f(greedy
    on V'') relative to f(greedy on V').  Cut from 2^20: there its 2720
    slots make the (slots, n) edge pass 2.9e12 terms of the plain torch
    arithmetic (PERF.md section 4)."""
    from repro_torch import (
        feature_coverage_from_numpy, greedy, news_day, postreduce, ss_sparsify,
    )
    from repro_torch.core import ss_live_bound

    n = 1 << 16
    fn = feature_coverage_from_numpy(news_day(0, n, F))
    ss = ss_sparsify(fn, torch.Generator(device="cuda").manual_seed(0), r=R, c=C)
    nv = int(ss.vprime.sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    vpp, wall = _synced(lambda: postreduce(
        fn, ss, float(ss.eps_hat), torch.Generator(device="cuda").manual_seed(1),
        r=R, c=C))
    peak = torch.cuda.max_memory_allocated() / 2**30
    extra = (torch.cuda.max_memory_allocated() - base) / 2**30
    n2 = int(vpp.sum())
    check(bool((~vpp | ss.vprime).all()), "postreduce: V'' leaves V'")
    check(n2 > 0, "postreduce: V'' is empty")
    f_vp = float(greedy(fn, K, alive=ss.vprime).value)
    f_vpp = float(greedy(fn, K, alive=vpp).value)
    slots = min(n, ss_live_bound(n, R, C))
    print(f"postreduce on news_day(0, {n}, {F}), eps = eps_hat = "
          f"{float(ss.eps_hat):.6f}: {slots} slots, |V'| = {nv} -> |V''| = {n2}; "
          f"wall {wall:.4f} s (host clock, synchronised); peak device memory "
          f"{peak:.2f} GiB ({extra:.2f} GiB above the objective and V'); "
          f"f(greedy on V'') / f(greedy on V') = {f_vpp / f_vp:.6f} at k = {K}",
          flush=True)
    return {"n": n, "slots": slots, "vprime": nv, "vpp": n2, "wall_s": wall,
            "peak_gib": peak, "relative_to_vprime": f_vpp / f_vp}


def profile_summarize(label: str, fn, watch: tuple[str, ...] = ()) -> dict:
    """One summarize under the profiler (``profile_run``)."""
    from repro_torch import summarize

    return profile_run(f"{label} summarize", lambda: summarize(
        fn, K, torch.Generator(device="cuda").manual_seed(0), r=R, c=C), watch)


def profile_run(label: str, call, watch: tuple[str, ...] = (), top: int = 8) -> dict:
    """One call under the profiler: device busy time by kernel (device
    events only: a PyTorch operator also reports its kernels' time as its
    own, and would count them twice) against the synchronised wall, and for
    each string of ``watch`` the total of the kernels whose names hold it,
    or for an operator ("aten::...") the device time of the kernels it
    launched.  (Without CPU activity the profiler records no NCCL kernel
    on the card.)"""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        t = time.perf_counter()
        call()
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
        print(f"profiled {label}: the profiler saw no device time (not measured)")
        return {}
    print(f"profiled {label}: wall {wall_ms:.4f} ms, device busy "
          f"{busy_ms:.4f} ms, idle share {1 - busy_ms / wall_ms:.4f}")
    for us, key, count in by_kernel[:top]:
        print(f"  {us / 1e3:10.4f} ms  x{count:<4d} {key[:90]}")
    watched = {}
    for name in watch:
        if name.startswith("aten::"):
            hits = [(e.device_time_total, e.count) for e in events if e.key == name]
        else:
            hits = [(us, count) for us, key, count in by_kernel if name in key]
        watched[name] = sum(us for us, _ in hits) / 1e3
        print(f"  {name}: {watched[name]:.4f} ms of device time "
              f"over {sum(count for _, count in hits)} calls")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "watched_ms": watched}


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
    # the sharded phase's part (a): the same objective at one rank over NCCL
    SHARDED["FeatureCoverage"] = sharded_one_rank(
        "FeatureCoverage", fn, full, wall_ss + wall_gr,
        {"ss_divergence": ss_divergence_kernel, "feature_gains": feature_gains_kernel},
        0.95)

    # the paper's other selectors at full size, on the same objective
    records[1]["stochastic"] = stochastic_phase(
        "FeatureCoverage", fn, ss, full, wall_full, feature_gains_kernel)
    records[1]["lazy"] = lazy_phase(fn, ss, res)
    # the streaming baseline on the same objective
    SIEVE["FeatureCoverage"] = sieve_path("FeatureCoverage", fn, full, wall_full,
                                          eps_runs=(None, 0.1), plain=True)
    SIEVE["row_sieve"] = row_sieve_phase(fn)
    # the service's coverage lane: the same news day as 8 queries of 2^16
    mark("FeatureCoverage path and its selectors")
    records[0]["lane"] = coverage_lane(fn, errs)
    # the summarization service over the lanes, on the same news day
    mark("coverage lane")
    records[0]["service"] = service_phase(fn)
    mark("service")
    # durable streaming sessions over the news rows
    records[0]["sessions"] = session_phase(errs)
    mark("sessions")
    return records


# -- sieve streaming -----------------------------------------------------------

SIEVE = {"errs": [], "paths": {}}   # the sieve_gains record, filled per path


def _sieve_reset() -> None:
    from repro_torch import sieve_extend
    from repro_torch.kernels import sieve_gains_kernel

    sieve_extend.chunks = sieve_extend.rounds = sieve_extend.host_reads = 0
    sieve_gains_kernel.launches = 0
    sieve_gains_kernel.launches_sparse = sieve_gains_kernel.launches_tile = 0


def _sieve_read() -> dict:
    from repro_torch import sieve_extend
    from repro_torch.kernels import sieve_gains_kernel

    return {"chunks": sieve_extend.chunks, "rounds": sieve_extend.rounds,
            "host_reads": sieve_extend.host_reads,
            "sieve_gains_launches": sieve_gains_kernel.launches,
            "sieve_gains_sparse_launches": sieve_gains_kernel.launches_sparse,
            "sieve_gains_tile_launches": sieve_gains_kernel.launches_tile}


def _same_bits(a, b) -> bool:
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def _same_decisions(a, b, what: str) -> None:
    """Two sieve states made every take and reset alike: the same picks in
    the same order in every sieve (legacy sieves never reset, so their
    picks are every decision), the same counts and guess exponents."""
    same = (torch.equal(a.sel, b.sel) and torch.equal(a.counts, b.counts)
            and (a.jidx is None or torch.equal(a.jidx, b.jidx)))
    if not same:
        rows = torch.nonzero((a.sel != b.sel).any(1) | (a.counts != b.counts)).flatten()
        j = int(rows[0]) if rows.numel() else -1
        fail(f"{what}: decisions differ in {rows.numel()} sieves; first sieve {j}: "
             f"{a.sel[j].tolist() if j >= 0 else ''} vs "
             f"{b.sel[j].tolist() if j >= 0 else ''}")


def _record_launches(call):
    """``call()`` with each ``sieve_gains`` launch on the card recorded as
    (sieves, columns, start): the start tensor the walk passed, kept as is
    (no copy, no host read, so the run's timing and its launches are the
    unrecorded run's).  Returns call's result and the records."""
    from repro_torch.kernels import sieve_gains as sg

    seen, launch = [], sg._launch

    def recorded(S, el, start):
        seen.append((S.shape[0], el.idx.shape[0], start))
        return launch(S, el, start)

    sg._launch = recorded
    try:
        return call(), seen
    finally:
        sg._launch = launch


def launch_mix(what: str, seen) -> dict:
    """The histogram of a run's ``sieve_gains`` launches: chunk launches
    (every live sieve, no start) by columns, re-launches (the sieves that
    changed in a round, with starts) by sieves and by columns, the columns
    due in each (from the earliest start to the zero element), the entries
    due in all, and the re-launch that ``sieve_gains_record`` times: at the
    widest chunk any re-launch reached, one with the most frequent number
    of sieves there (the median by columns due), its sieves and starts."""
    first = collections.Counter((R, n) for R, n, st in seen if st is None)
    again = [(R, n, n - int(st.min()), st) for R, n, st in seen if st is not None]
    buckets = ("1", "2", "3-4", "5-8", "9-16", "17-32", "33+")
    by_r = collections.Counter(
        next(b for b in buckets if b == "33+" or R <= int(b.split("-")[-1]))
        for R, _, _, _ in again)
    by_n = collections.Counter(n for _, n, _, _ in again)
    entries = sum(R * n for (R, n), c in first.items() for _ in range(c)) + sum(
        R * due for R, _, due, _ in again)
    widest = max((n for _, n, _, _ in again), default=0)
    at_w = [a for a in again if a[1] == widest]
    pick = None
    if at_w:
        r_mode = collections.Counter(R for R, _, _, _ in at_w).most_common(1)[0][0]
        cands = sorted((a for a in at_w if a[0] == r_mode), key=lambda a: a[2])
        pick = cands[len(cands) // 2]
    mix = {"chunk_launches": {f"{R}x{n}": c for (R, n), c in sorted(first.items(),
                                                                     key=lambda x: x[0][1])},
           "relaunches": len(again),
           "relaunch_sieves": {b: by_r[b] for b in buckets if by_r[b]},
           "relaunch_columns": dict(sorted(by_n.items())),
           "relaunch_due_share": (sum(d for _, _, d, _ in again)
                                  / max(1, sum(n for _, n, _, _ in again))),
           "entries_due": entries, "widest_relaunch": widest,
           "timed_relaunch": None if pick is None else {
               "sieves": pick[0], "columns": pick[1], "due": pick[2],
               "starts": pick[3].tolist()}}
    print(f"{what} launches: {sum(first.values())} chunk launches "
          f"({', '.join(f'{k} x{v}' for k, v in mix['chunk_launches'].items())}; "
          f"sieves x columns), {len(again)} re-launches with starts (by sieves "
          f"{mix['relaunch_sieves']}; by columns {mix['relaunch_columns']}; "
          f"{mix['relaunch_due_share']:.4f} of their columns due); "
          f"{entries} entries due in all", flush=True)
    return mix


def sieve_phase(label: str, fn, f_full: float, wall_full: float, eps=None,
                plain: bool = False) -> dict:
    """``sieve_streaming(fn, K)`` (legacy, 50 thresholds, or ``eps``) at
    the path's full size, with the walk's and the kernel's counts set to 0
    just before and read just after: the synchronised wall beside greedy on
    V's, chunks, rounds and host reads, f(S) relative to greedy on V (never
    above 1 + 1e-5; with eps at least 1/2 - eps), the peak above the
    objective, device busy and idle share from a profiled rerun, which must
    give the same bits (the sieve has no randomness).  With ``plain``, the
    same stream also through the plain table on the card: the same
    decisions, sieve for sieve."""
    from repro_torch import sieve_extend, sieve_init, sieve_streaming

    what = f"{label} sieve streaming" + ("" if eps is None else f" eps={eps}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _sieve_reset()
    (res, wall), seen = _record_launches(
        lambda: _synced(lambda: sieve_streaming(fn, K, eps=eps)))
    counts = _sieve_read()
    mix = launch_mix(what, seen)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    T = res.thresholds.shape[0]
    rel = float(res.value) / f_full
    check(res.selected.shape == (K,) and math.isfinite(float(res.value)),
          f"{what}: wrong shape or a non-finite value")
    picks = res.selected[res.selected >= 0]
    check(int(picks.unique().numel()) == int(picks.numel()), f"{what}: picked twice")
    check(rel <= 1.0 + 1e-5, f"{what}: f(S) above greedy on V ({rel})")
    check(eps is None or rel >= 0.5 - eps, f"{what}: below 1/2 - eps ({rel})")
    check(counts["sieve_gains_launches"] > 0, f"{what}: never launched sieve_gains")
    again = []
    prof = profile_run(what, lambda: again.append(sieve_streaming(fn, K, eps=eps)),
                       watch=("::sieve_",), top=6)
    check(_same_bits(again[0], res), f"{what}: a rerun gives other bits")
    busy = prof.get("busy_ms")
    mix["sieve_kernels_ms"] = prof.get("watched_ms", {}).get("::sieve_")
    out = {"T": T, "relative": rel, "wall_s": wall, "greedy_on_V_wall_s": wall_full,
           "busy_ms": busy, "wall_ms_profiled": prof.get("wall_ms"),
           "peak_above_objective_gib": peak, **counts, "launch_mix": mix}
    line = (f"{what}: T = {T}, f(S) = {float(res.value):.6f}, relative to greedy "
            f"on V {rel:.6f}; wall {wall:.4f} s (host clock, synchronised; greedy "
            f"on V {wall_full:.4f} s); device busy "
            + ("not measured" if busy is None else
               f"{busy:.4f} ms, idle share {1 - busy / prof['wall_ms']:.4f}")
            + f" (profiler, a rerun: same bits); {counts['chunks']} chunks, "
            f"{counts['rounds']} rounds, {counts['host_reads']} host reads, "
            f"{counts['sieve_gains_launches']} sieve_gains launches "
            f"({counts['sieve_gains_sparse_launches']} sparse route, "
            f"{counts['sieve_gains_tile_launches']} tile); the sieve's kernels "
            + ("not measured" if mix["sieve_kernels_ms"] is None else
               f"{mix['sieve_kernels_ms']:.4f} ms of device time on that mix")
            + f"; peak {peak:.3f} GiB above the objective")
    if plain:
        stream = torch.arange(fn.n, device="cuda")
        card = sieve_extend(fn, sieve_init(fn, K, eps=eps), stream)
        ref, wall_p = _synced(lambda: sieve_extend(
            fn, sieve_init(fn, K, eps=eps), stream, backend="reference"))
        _same_decisions(card, ref, f"{what}: card vs plain route")
        out["plain_route_wall_s"] = wall_p
        line += (f"; the plain table on the card made the same decisions in "
                 f"every sieve ({wall_p:.4f} s)")
    print(line, flush=True)
    return out


def sieve_sass() -> dict:
    """What the card issues for facility location's term: the SASS of the
    tile's facility-location instance over columns (``cuobjdump -sass`` of
    the built library), the loop that holds the most FMNMX (the segment
    loop; one FMNMX a term), and in it the FMNMX, FADD and LDS counts and
    every instruction a term: static counts, in which the staging's
    branches count whether or not they run."""
    from repro_torch.kernels._build import BUILD_DIR, _nvcc

    sass = subprocess.run(
        [str(Path(_nvcc()).parent / "cuobjdump"), "-sass",
         str(BUILD_DIR / "libkernels.so")],
        check=True, capture_output=True, text=True, timeout=300).stdout
    body = [f for f in re.split(r"\n\s*Function : ", sass)
            if f.split("\n", 1)[0].strip().find("sieve_tileILi0ELb1ELb1E") >= 0]
    check(len(body) == 1, "sieve_gains: no single SASS body of the FL tile")
    ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)([^;]*);",
        body[0])]
    loops = []
    for a, op, rest in ins:
        to = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if to and int(to.group(1), 16) < a:
            span = [o for b, o, _ in ins if int(to.group(1), 16) <= b <= a]
            loops.append((span.count("FMNMX"), span))
    check(loops and max(loops)[0] > 0, "sieve_gains: no loop of FMNMX in the FL tile")
    span = max(loops, key=lambda x: x[0])[1]
    n = {op: span.count(op) for op in ("FMNMX", "FADD", "LDS")}
    per_term = len(span) / n["FMNMX"]
    print(f"sieve_gains FL tile SASS: the segment loop holds {len(span)} "
          f"instructions, FMNMX {n['FMNMX']}, FADD {n['FADD']}, LDS {n['LDS']}: "
          f"{per_term:.4f} a term (static)", flush=True)
    return {"loop_instructions": len(span), **n, "issued_per_term": per_term}


def sieve_ptxas() -> dict:
    """Registers and spills of the sieve's kernels (ptxas, this build)."""
    out = {}
    for name, entry, threads in (("tile FL", "sieve_tileILi0ELb1ELb1E", 256),
                                 ("tile sqrt", "sieve_tileILi0ELb0ELb0E", 256),
                                 ("sparse sqrt", "sieve_sparseILi0E", 256),
                                 ("zero tree sqrt", "sieve_zero_treeILi0E", 256)):
        regs, store, load, per_sm = ptxas_report("sieve_gains", entry, threads)
        out[name] = {"registers": regs, "spill_store_bytes": store,
                     "spill_load_bytes": load, "blocks_per_sm_by_registers": per_sm}
    print("sieve_gains ptxas: " + "; ".join(
        f"{k} {v['registers']} registers, spills {v['spill_store_bytes']}/"
        f"{v['spill_load_bytes']} bytes" for k, v in out.items()), flush=True)
    return out


def sieve_routes_check(fn, el, C: int, rows) -> dict:
    """FeatureCoverage's two routes on the same rows at full size: blocks
    of SIEVE_SPARSE_BLOCK - 1 chunk rows and a sparse last one (every block
    sparse), then the same blocks with a dense last row (every block dense,
    through the tile): the kernel's own flags say so and the chunk rows'
    entries are equal bit for bit.  Returns the routes' block counts and
    the dense route's ms."""
    from repro_torch.kernels import sieve_gains as sg
    from repro_torch.kernels import sieve_gains_kernel

    B = sg.SIEVE_SPARSE_BLOCK
    nb = C // (B - 1)
    E = torch.cat([el.E[:C], torch.ones((1, el.E.shape[1]), device="cuda")])
    base = torch.arange(nb * (B - 1), device="cuda").reshape(nb, B - 1)
    ia = torch.cat([base, base[:, :1]], 1).flatten()
    ib = torch.cat([base, torch.full((nb, 1), C, device="cuda")], 1).flatten()
    ea, eb = el._replace(E=E, idx=ia), el._replace(E=E, idx=ib)
    out_a, fa = sg._launch(rows, ea, None)
    out_b, fb = sg._launch(rows, eb, None)
    torch.cuda.synchronize()
    keep = (torch.arange(nb * B, device="cuda") % B) != B - 1
    sparse_a, dense_b = int((fa == 0).sum()), int((fb == 1).sum())
    check(sparse_a == nb and dense_b == nb,
          f"FeatureCoverage sieve routes: {sparse_a} of {nb} blocks sparse, "
          f"{dense_b} of {nb} dense where all should be")
    check(torch.equal(out_a[:, keep], out_b[:, keep]),
          "FeatureCoverage sieve routes: the sparse and dense loops give "
          "different bits for the same rows")
    _, t = kernel_ms(lambda: sieve_gains_kernel(rows, eb), 3)
    print(f"FeatureCoverage sieve routes at full size ({rows.shape[0]} sieves x "
          f"{nb} blocks of {B - 1} chunk rows): {nb} blocks sparse, then {nb} "
          f"dense with a dense last row; the chunk rows' entries equal bit for "
          f"bit; the dense route {t.ms:.4f} ms a launch", flush=True)
    return {"blocks": nb, "dense_route_ms": t.ms}


def sieve_gains_record(label: str, fn, states, relaunch: dict) -> dict:
    """``sieve_gains`` against its plain version at the path's shapes: the
    empty state and T sieve states (a finished run's) against the route's
    largest chunk and the zero element, and a re-launch that the legacy run
    made (``launch_mix``'s ``timed_relaunch``: its chunk's width, its number
    of sieves, taken from those states, and its starts), timed by ``kernel_ms``,
    with its bound: S, the chunk's elements and the table moved once; per
    (sieve, element, leaf) facility location's max and add.
    FeatureCoverage's (the sparse route) counts what these inputs need:
    L/32 adds an entry, each nonzero's term (phi, an add and a multiply)
    and the 5 adds up its path a sieve, and the zero tree once a sieve and
    leaf; beside it the full-tree bound (the tree's add per (sieve, element,
    leaf), phi at the nonzeros and once a sieve and leaf) and the dense bound
    (every term's phi).  Facility location's table must equal the plain one
    bit for bit (one order, exact operations); FeatureCoverage's within TOL
    of the table's size (sqrt.approx against IEEE sqrt), and its sparse
    route's blocks are counted from the kernel's flags."""
    from repro_torch.core.sieve import MAX_CHUNK
    from repro_torch.kernels import sieve_gains as sg
    from repro_torch.kernels import sieve_gains_kernel, sieve_gains_ref

    C = min(fn.sieve_chunk() or MAX_CHUNK, MAX_CHUNK, fn.n)
    el = fn.sieve_elements(torch.arange(C, device="cuda"))
    rows = torch.cat([torch.zeros_like(states[:1]), states]).contiguous()
    R_, L = rows.shape
    cols = el.idx.shape[0]
    fc = el.phi is not None
    out_k, t = kernel_ms(lambda: sieve_gains_kernel(rows, el), 3)

    def plain():
        return sieve_gains_ref(rows, el.E, el.idx, cols=el.cols, phi=el.phi,
                               feat_w=el.feat_w, cap=el.cap)

    out_p, tp = kernel_ms(plain, 1, windows=1 if L > 4096 else 5)
    err = float((out_k - out_p).abs().max())
    scale = max(1.0, float(out_p.abs().max()))
    bitwise = torch.equal(out_k, out_p)
    if fc:
        check(err <= TOL[torch.float32] * scale,
              f"{label} sieve_gains: kernel vs plain err {err} > TOL x {scale}")
    else:
        check(bitwise, f"{label} sieve_gains: the table is not the plain one bit "
              f"for bit (max err {err})")
    t_checks = time.perf_counter()
    # a re-launch the run made: its chunk's width, its sieves and starts
    check(relaunch is not None, f"{label} sieve_gains: the legacy run made no re-launch")
    n4 = relaunch["columns"]
    el4 = el if n4 == cols else fn.sieve_elements(torch.arange(n4 - 1, device="cuda"))
    r4 = rows[1:1 + relaunch["sieves"]].contiguous()
    st = torch.tensor(relaunch["starts"], device="cuda")
    out4, t4 = kernel_ms(lambda: sieve_gains_kernel(r4, el4, st), 3)
    due = ((torch.arange(n4, device="cuda")[None, :] >= st[:, None])
           | (el4.idx == -1)[None, :])
    ref4 = torch.where(due, sieve_gains_ref(r4, el4.E, el4.idx, cols=el4.cols,
                                            phi=el4.phi, feat_w=el4.feat_w,
                                            cap=el4.cap), 0.0)
    got4 = torch.where(due, out4, 0.0)
    err4 = float((got4 - ref4).abs().max())
    if fc:
        check(err4 <= TOL[torch.float32] * scale,
              f"{label} sieve_gains re-launch: err {err4} > TOL x {scale}")
    else:
        check(torch.equal(got4, ref4), f"{label} sieve_gains re-launch: not the "
              f"plain table bit for bit (max err {err4})")
    terms = R_ * cols * L
    bytes_ = (R_ * L + C * L + R_ * cols) * 4
    # the re-launch needs row r's columns from its start (and the zero element)
    due_r = [n4 - x for x in relaunch["starts"]]
    bytes4 = (r4.shape[0] * L + relaunch["due"] * L + sum(due_r)) * 4
    sqrt = fc and el.phi == "sqrt"
    routes = None
    if fc:
        nnz = int(torch.count_nonzero(el.E[:C]))
        segs = -(-L // 32)

        def sparse_bound(r, b):
            return bound(b, fp32=r * cols * segs + 7 * r * nnz + 4 * r * L,
                         sfu=r * (nnz + L) if sqrt else 0)

        b_ms, b_by, b_pipe = sparse_bound(R_, bytes_)
        row_nnz = torch.count_nonzero(el.E[:n4 - 1], dim=1).flip(0).cumsum(0).flip(0)
        nnz4 = sum(int(row_nnz[x]) for x in relaunch["starts"] if x < n4 - 1)
        b4 = bound(bytes4, fp32=sum(due_r) * segs + 7 * nnz4 + 4 * r4.shape[0] * L,
                   sfu=nnz4 + r4.shape[0] * L if sqrt else 0)[0]
        full_tree = bound(bytes_, fp32=terms + 2 * R_ * (nnz + L),
                          sfu=R_ * (nnz + L) if sqrt else 0)[0]
        dense = bound(bytes_, fp32=3 * terms, sfu=terms if sqrt else 0)[0]
        _, flags = sg._launch(rows, el, None)
        routes = {"sparse_blocks": int((flags == 0).sum()),
                  "dense_blocks": int((flags == 1).sum())}
        routes.update(sieve_routes_check(fn, el, C, rows))
    else:
        nnz = None
        b_ms, b_by, b_pipe = bound(bytes_, fp32=2 * terms)
        b4 = bound(bytes4, fp32=2 * sum(due_r) * L)[0]
        full_tree = dense = b_ms
    SIEVE["errs"].extend([err, err4])
    rec = {"sieves": R_, "columns": cols, "L": L, "nnz": nnz, "ms": t.ms,
           "plain_ms": tp.ms, "bound_ms": b_ms, "bound_by": b_by, "pipe": b_pipe,
           "full_tree_bound_ms": full_tree, "dense_bound_ms": dense,
           "max_abs_err": err, "bitwise": bitwise, "share_of_bound": b_ms / t.ms,
           "relaunch": {"sieves": r4.shape[0], "columns": n4, "due": relaunch["due"],
                        "ms": t4.ms,
                        "bound_ms": b4, "share_of_bound": b4 / t4.ms,
                        "max_abs_err": err4},
           "routes": routes}
    if "ptxas" not in SIEVE:
        SIEVE["ptxas"] = sieve_ptxas()
    if not fc and "sass" not in SIEVE:
        SIEVE["sass"] = sieve_sass()
    rec["checks_s"] = time.perf_counter() - t_checks
    SIEVE["paths"][label] = rec
    print(f"sieve_gains at {label}'s shapes ({R_} sieves x {cols} columns x {L} "
          f"leaves" + ("" if nnz is None else f", {nnz} nonzeros in the chunk")
          + f"): {t.ms:.4f} ms per launch ({fmt_windows(t)}), plain "
          f"{tp.ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {b_pipe}), share "
          f"{b_ms / t.ms:.4f}"
          + (f"; full-tree bound {full_tree:.4f} ms (share {full_tree / t.ms:.4f}),"
             f" dense bound {dense:.4f} ms (share {dense / t.ms:.4f}); blocks "
             f"{routes['sparse_blocks']} sparse, {routes['dense_blocks']} dense"
             if fc else "")
          + f"; vs plain err {err:.3g} (scale {scale:.4g}), bitwise {bitwise}; "
          f"the run's re-launch of {r4.shape[0]} sieves with starts over {n4} "
          f"columns ({relaunch['due']} due) {t4.ms:.4f} ms, bound {b4:.4f} ms, share "
          f"{b4 / t4.ms:.4f}, err {err4:.3g}; library none; the re-launch, route, "
          f"ptxas and SASS checks took {rec['checks_s']:.2f} s", flush=True)
    return rec


def columns_check(fn) -> None:
    """Matrix-free facility location at full size: a stream element's
    similarity column has the same bits at any position of its block of
    SIEVE_BLOCK columns, on which the sieve's claim that the chunking
    changes no bit rests (cuBLAS picks its algorithm by shape): elements
    64..127 at positions 64..127 of one chunk and 0..63 of another, and
    element 100 in a chunk of one."""
    a = fn.sieve_elements(torch.arange(0, 128, device="cuda")).E
    b = fn.sieve_elements(torch.arange(64, 192, device="cuda")).E
    one = fn.sieve_elements(torch.tensor([100], device="cuda")).E
    check(torch.equal(a[:, 64:128], b[:, :64]) and torch.equal(one[:, 0], a[:, 100]),
          "path B: a similarity column's bits depend on its place in the chunk")
    print(f"path B columns ({a.shape[0]} served rows): an element's column has "
          f"the same bits at three places in its block", flush=True)


def sieve_path(label: str, fn, full, wall_full: float, eps_runs=(None,),
               plain: bool = False) -> dict:
    """The sieve phases of one path: each run of ``sieve_phase``, then
    ``sieve_gains`` at the path's shapes against the states of the legacy
    run."""
    from repro_torch import StreamingFacilityLocation, sieve_extend, sieve_init

    out = {}
    for eps in eps_runs:
        key = "legacy" if eps is None else f"eps={eps}"
        out[key] = sieve_phase(label, fn, float(full.value), wall_full, eps,
                               plain=plain and eps is None)
    if isinstance(fn, StreamingFacilityLocation):
        columns_check(fn)
    states = sieve_extend(fn, sieve_init(fn, K), torch.arange(fn.n, device="cuda")).states
    out["sieve_gains"] = sieve_gains_record(label, fn, states,
                                            out["legacy"]["launch_mix"]["timed_relaunch"])
    SIEVE.setdefault("launches", out["legacy"]["sieve_gains_launches"])
    return out


def sieve_small() -> None:
    """Sieve streaming at n = 4096 on the three objectives, legacy and
    eps = 0.2: the card's route against the plain table on the card (the
    same decisions in every sieve), two calls alike, and one-shot, two
    halves and per-element updates (the first 512 elements) alike bit for
    bit."""
    from repro_torch import sieve_extend, sieve_init, sieve_update

    n = 4096
    for label, make in _small_objectives(n).items():
        fn = make("cuda")
        stream = torch.arange(n, device="cuda")
        for eps in (None, 0.2):
            what = f"small {label} sieve ({'legacy' if eps is None else f'eps={eps}'})"
            _sieve_reset()
            card = sieve_extend(fn, sieve_init(fn, K, eps=eps), stream)
            counts = _sieve_read()
            check(counts["sieve_gains_launches"] > 0, f"{what}: no kernel launch")
            ref = sieve_extend(fn, sieve_init(fn, K, eps=eps), stream,
                               backend="reference")
            _same_decisions(card, ref, f"{what}: card vs plain route")
            check(_same_bits(card, sieve_extend(fn, sieve_init(fn, K, eps=eps), stream)),
                  f"{what}: two calls differ")
            half = sieve_extend(fn, sieve_init(fn, K, eps=eps), stream[: n // 2])
            check(_same_bits(card, sieve_extend(fn, half, stream[n // 2:])),
                  f"{what}: two halves differ from one shot")
            st = sieve_init(fn, K, eps=eps)
            for v in range(512):
                st = sieve_update(fn, st, v)
            check(_same_bits(st, sieve_extend(fn, sieve_init(fn, K, eps=eps),
                                              stream[:512])),
                  f"{what}: per-element updates differ from one shot")
            print(f"{what} (n={n}, k={K}): card == plain route decision for "
                  f"decision; deterministic; one-shot == two halves == per-element "
                  f"(512) bit for bit; {counts['chunks']} chunks, "
                  f"{counts['rounds']} rounds, {counts['host_reads']} host reads",
                  flush=True)
        del fn
        torch.cuda.empty_cache()


def row_sieve_phase(fn) -> dict:
    """The row sieve over the first 2^12 rows of FeatureCoverage's W at eps
    = 0.2, one row per ``stream_sieve_update``: µs per update (host clock,
    synchronised, over the whole stream), and the same picks as the index
    sieve over the same elements.  (2^14 rows took 39 s at 2.4 ms an
    update; cut since the sharded phase came.)"""
    from repro_torch import (
        sieve_best, sieve_extend, sieve_init, stream_sieve_best, stream_sieve_init,
        stream_sieve_update,
    )

    n, eps = min(1 << 12, fn.n), 0.2
    rows = fn.W[:n]

    def run():
        st = stream_sieve_init(K, fn.W.shape[1], eps=eps, device=fn.device)
        took = 0
        for i in range(n):
            st, t_ = stream_sieve_update(st, rows[i])
            took = took + t_
        return st, took

    (st, took), wall = _synced(run)
    us = wall / n * 1e6
    a = sieve_best(sieve_extend(fn, sieve_init(fn, K, eps=eps),
                                torch.arange(n, device="cuda")))
    b = stream_sieve_best(st)
    check(torch.equal(a.selected, b.selected),
          f"row sieve: picks {b.selected.tolist()} vs the index sieve's "
          f"{a.selected.tolist()}")
    rel = abs(float(a.value) - float(b.value)) / float(a.value)
    check(rel <= 1e-5, f"row sieve: f(S) {float(b.value)} vs {float(a.value)}")
    print(f"row sieve over news_day's first {n} rows (eps = {eps}, T = "
          f"{st.jidx.shape[0]}, k = {K}): {us:.2f} us per update (host clock, "
          f"synchronised), {int(took)} rows accepted; the same picks as the index "
          f"sieve, f(S) {float(b.value):.6f} vs {float(a.value):.6f}", flush=True)
    return {"rows": n, "us_per_update": us, "accepted": int(took)}


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
    return full, res, ss, counts, rel, wall_full, wall_sum


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
    full, res, ss, counts, rel, wall_full, wall_sum = _fl_drive("path A", fn, kernels)
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
    SHARDED["path A"] = sharded_one_rank("path A", fn, full, wall_sum, kernels, 0.95)
    stochastic = stochastic_phase("path A", fn, ss, full, wall_full,
                                  fl_gains_kernel, panel=True)
    SIEVE["path A"] = sieve_path("path A", fn, full, wall_full)
    # the service's FL lane: 4 queries of 2^13 frames of the same video
    lane = fl_lane(X, errs)
    return [
        {"name": "fl_divergence", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fl_divergence.cu",
         "replaces": "src/repro/kernels/fl_divergence.py:110",
         "launches": counts["summarize"]["fl_divergence"],
         "max_abs_err": errs["fl_divergence"], "ms": ms, "plain_ms": plain_ms,
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
         "round2_sized": {"cands": mid, "ms": ms_mid}, "tile": tile, "lane": lane},
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
         "gathered_ms": ms_gathered, "stochastic": stochastic},
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
    full, res, ss, counts, rel, wall_full, wall_sum = _fl_drive("path B", fn, kernels)
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
    # not profiled: its profile took 31.76 s of the script's time around a
    # 5.96 s wall, and the LM sharding phase needed the time
    SHARDED["path B"] = sharded_one_rank("path B", fn, full, wall_sum, kernels, 0.93,
                                         profile=False)
    stochastic = stochastic_phase("path B", fn, ss, full, wall_full,
                                  fl_stream_gains_kernel)
    SIEVE["path B"] = sieve_path("path B", fn, full, wall_full)

    # SS's quality at r = c = 8 falls as this data set grows, in the JAX
    # reference as in the port (they prune alike under the same draws,
    # tests/test_torch_fl_summarize.py), and at 2^18 it sits below the 0.95
    # of path A.  Measure it at a second seed and at 2^16 (seed 2 and 2^17
    # were cut for the sharded phase's time); hold each run to 0.93.
    rels = {"n=2^18 seed 0": rel}
    for seed in (1,):
        res_s, _ = summarize(fn, K, torch.Generator(device="cuda").manual_seed(seed),
                             r=R, c=C)
        rels[f"n=2^18 seed {seed}"] = float(res_s.value) / float(full.value)
    del fn
    for log_n in (16,):
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
         "ptxas": gains_ptxas, "stochastic": stochastic},
    ]


# -- sharded SS and greedy over torch.distributed -----------------------------

SHARDED: dict = {}     # part (a) of each SS path, then part (b) (sharded_phase)
SHARDED_RANKS = 4
# part (b)'s sizes: each of four ranks on the one card holds a quarter
# (path B at 2^14: its plain route took 13-15 s at four ranks at 2^16)
SH_N, SH_N_A, SH_N_B = 1 << 18, 1 << 14, 1 << 14


@contextlib.contextmanager
def _one_rank_group():
    """A one-rank NCCL group in this process (a HashStore: no address),
    destroyed on the way out."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _sharded_counts(kernels: dict) -> None:
    from repro_torch.core import distributed as dd

    for kern in kernels.values():
        kern.launches = 0
    dd.ss_sparsify_sharded.host_reads = 0
    dd._select_sharded.host_reads = 0
    for key in dd.COUNTS:
        dd.COUNTS[key] = 0


def _frame_gains(comm, gains, loc_counts) -> torch.Tensor:
    """The gains of every shard's live candidates, gathered, in ground
    order: (live,)."""
    allg = comm.all_gather(gains.float().contiguous())
    return torch.cat([allg[s, :c] for s, c in enumerate(loc_counts)])


def _explain_picks(label: str, fn, cand, k: int, routes: dict) -> str:
    """Step two greedy routes in lockstep (the first route's state) over the
    live candidates ``cand`` (ground order) to the first argmax they take
    differently, and bound it in float64 (``_margin``); raises where no
    decision differs.  Each route maps a state to the gains of ``cand``."""
    from repro_torch.core.greedy import NEG

    st = fn.empty_state()
    avail = torch.ones(cand.shape[0], dtype=torch.bool, device=cand.device)
    for i in range(k):
        a, b = (int(torch.argmax(torch.where(avail, route(st), NEG)))
                for route in routes.values())
        if a != b:
            t, mag = _f64_pair(fn, st.double()[None], cand[[a, b]])
            vals = t[0].sum(-1)
            return _margin(label, f"greedy step {i}, the argmax ({' vs '.join(routes)})",
                           int(cand[a]), int(cand[b]),
                           (float(vals[0]), float(_f64_bound(mag[0, 0]))),
                           (float(vals[1]), float(_f64_bound(mag[0, 1]))))
        st = fn.add(st, cand[a])
        avail[a] = False
    fail(f"{label}: the routes pick other elements, but no decision differs in "
         "lockstep")
    return ""


def _sharded_taken(view, vprime, comm, c: float = C):
    """A shard's compact frame of ``vprime`` as the selection loop builds
    it: (the taken view, the shards' live counts)."""
    from repro_torch.core.greedy import compact_indices
    from repro_torch.core.sparsify import bucket_schedule

    n_loc = view.local_n()
    counts = vprime.reshape(comm.size, n_loc).sum(1).tolist()
    fits = [b for b in bucket_schedule(n_loc, c, tile=8) if b >= max(counts)]
    lo = comm.index * n_loc
    lidx = compact_indices(vprime[lo:lo + n_loc], min(fits) if fits else n_loc)
    return view.shard_take(lidx), counts


def sharded_one_rank(label: str, fn, full, dense_wall: float, kernels: dict,
                     bar: float, profile: bool = True) -> dict:
    """Part (a) of the sharded phase on a path's own objective at full
    size: ``summarize_sharded`` at one rank over NCCL in this process (the
    view is the objective's own tensor: no copy), beside the path's dense
    summarize.  Checks the relative value against greedy on V (``bar``), one
    divergence launch a round and K gains launches, and that sharded greedy
    over V' picks what dense greedy over V' picks (a differing pick shown a
    near tie in float64); prints the synchronised wall, the collectives'
    device time (profiler), the host reads a round and the peak."""
    from repro_torch import greedy, summarize_sharded
    from repro_torch.core import CudaBackend, distributed as dd
    from repro_torch.core.greedy import compact_indices, selection_bucket
    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with _one_rank_group():
        mesh = make_mesh((1,), ("data",), "cuda")
        view = fn.shard(mesh, ("data",))
        own = {"FeatureCoverage": "W", "path A": "sim", "path B": "X"}[label]
        check(getattr(view, own).data_ptr() == getattr(fn, own).data_ptr(),
              f"{label}: the one-rank view copied the objective")
        gen = torch.Generator(device="cuda")

        def run():
            return summarize_sharded(view, K, mesh, gen.manual_seed(0), r=R, c=C)

        # NCCL makes its communicator at the first collective: not in the wall
        torch.distributed.all_reduce(torch.zeros(1, device="cuda"))
        _sharded_counts(kernels)
        torch.cuda.reset_peak_memory_stats()
        (res, ss), wall = _synced(run)
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = {name: kern.launches for name, kern in kernels.items()}
        reads = {"ss": dd.ss_sparsify_sharded.host_reads,
                 "greedy": dd._select_sharded.host_reads}
        colls = dict(dd.COUNTS)
        div_name, gains_name = kernels
        nv = int(ss.vprime.sum())
        rel = float(res.value) / float(full.value)
        check(launches[div_name] == ss.rounds and launches[gains_name] == K,
              f"{label} sharded: launches {launches}, want {ss.rounds} "
              f"{div_name} (one a round at one rank) and {K} {gains_name}")
        check(reads["ss"] == ss.rounds + 1 and reads["greedy"] == 1,
              f"{label} sharded: host reads {reads}, want one a round (+1) and one")
        check(colls["staged"] == 0, f"{label} sharded: NCCL staged {colls['staged']}")
        check(0 < nv < fn.n and ss.rounds > 0, f"{label} sharded: SS pruned nothing or all")
        check(rel >= bar, f"{label} sharded: relative value {rel} < {bar}")
        # dense greedy over the same V' on the card
        dense = greedy(fn, K, alive=ss.vprime)
        note = "the same picks"
        if not torch.equal(dense.selected, res.selected):
            size = selection_bucket(fn.n, nv)
            cands = CudaBackend().prepare_compact(fn, compact_indices(ss.vprime, size))
            comm = dd.Collectives(mesh, ("data",))
            ctx = view.shard_init(comm)
            taken, counts = _sharded_taken(view, ss.vprime, comm)
            note = _explain_picks(label, fn, torch.nonzero(ss.vprime).flatten(), K, {
                "dense": lambda st: CudaBackend().gains_compact(fn, st, cands)[:nv],
                "sharded": lambda st: _frame_gains(
                    comm, CudaBackend().shard_gains(taken, st, ctx), counts)})
        t = time.perf_counter()
        prof = profile_run(f"{label} summarize_sharded (1 rank, NCCL)", run,
                           ("nccl",)) if profile else {}
        prof["profile_s"] = time.perf_counter() - t
    trace = [int(x) for x in ss.alive_trace if x >= 0]
    phase_s = time.perf_counter() - t0
    print(f"{label} summarize_sharded, 1 rank over NCCL: |V'| = {nv}, rounds = "
          f"{ss.rounds}, eps_hat = {float(ss.eps_hat):.6f}, f(S') = "
          f"{float(res.value):.6f}, relative = {rel:.6f} (bar {bar}); wall "
          f"{wall:.4f} s (the path's dense summarize: {dense_wall:.4f} s); launches "
          f"{json.dumps(launches)}; host reads: SS {reads['ss']} over {ss.rounds} "
          f"rounds (one a round, one at the exit), greedy {reads['greedy']}; "
          f"collectives {json.dumps(colls)}; peak {peak:.2f} GiB; dense greedy "
          f"over V': {note}; live counts {trace}; this part {phase_s:.2f} s "
          f"(the profiled run {prof['profile_s']:.2f} s)",
          flush=True)
    return {"vprime": nv, "rounds": ss.rounds, "eps_hat": float(ss.eps_hat),
            "trace": trace, "phase_s": phase_s,
            "relative": rel, "bar": bar, "wall_s": wall, "dense_wall_s": dense_wall,
            "launches": launches, "host_reads": reads, "collectives": colls,
            "peak_gib": peak, "dense_greedy_over_vprime": note,
            "nccl_device_ms": prof.get("watched_ms", {}).get("nccl"),
            "profile": prof}


def _sharded_objectives() -> dict:
    """Part (b)'s objectives, each whole on this rank's card."""
    from repro_torch import (
        FeatureCoverage, StreamingFacilityLocation, clustered_embeddings,
        facility_location_from_features, feature_coverage_from_numpy, news_day, video,
    )

    W = feature_coverage_from_numpy(news_day(0, SH_N, F)).W
    return {
        "news sqrt": FeatureCoverage(W=W),
        "news satcov": FeatureCoverage(W=W, phi="satcov", alpha=0.3),
        "path A": facility_location_from_features(video(0, SH_N_A, F_A), "cosine"),
        "path B": StreamingFacilityLocation.from_features(
            torch.from_numpy(clustered_embeddings(0, SH_N_B, D_B)).to("cuda"), "dot"),
    }


def _explain_sharded_ss(label: str, fn, view, mesh, noise, bins: int = 512) -> str:
    """Step sharded SS on the kernel route and the plain route in lockstep
    on every rank (the kernel route's state, the same draws) to the first
    round whose prune they cut differently, and show in float64 that the
    element that flips lies within float32 rounding of the cut: of the bin
    edge it crosses where the routes' histograms differ, else of the
    routes' thresholds.  Raises where it does not, or where no cut
    differs.  ``fn`` is the whole objective (for the float64 values)."""
    from repro_torch.core import CudaBackend, ReferenceBackend, distributed as dd
    from repro_torch.core.greedy import NEG, compact_indices
    from repro_torch.core.sparsify import (
        INF, _scatter_min, bucket_schedule, max_rounds, probe_count,
    )

    comm = dd.Collectives(mesh, ("data",))
    n_loc = view.local_n()
    n, first = n_loc * comm.size, comm.index * n_loc
    m = min(probe_count(n, R), n)
    shrink = torch.tensor(1.0 - 1.0 / math.sqrt(C), dtype=torch.float32, device="cuda")
    buckets = bucket_schedule(n_loc, C, tile=8)
    ctx = view.shard_init(comm)
    resid = view.shard_residuals(ctx).float()
    resid_all = comm.all_gather(resid).reshape(-1)
    routes = {"cuda": CudaBackend(), "reference": ReferenceBackend()}
    alive = torch.ones(n_loc, dtype=torch.bool, device="cuda")
    div = {k: torch.full((n_loc,), INF, device="cuda") for k in routes}
    slots = torch.arange(n_loc, device="cuda")
    zero = fn.empty_state()
    probes_all = []

    def div64(v):
        allp = torch.cat(probes_all)
        t, mag = _f64_pair(fn, _f64_mu(fn, allp, zero), torch.tensor([v], device="cuda"))
        w = t.sum(-1)[:, 0] - resid_all.double()[allp]
        u = int(torch.argmin(w))
        return float(w[u]), float(_f64_bound(mag[u, 0]))

    for rnd in range(max_rounds(n, R, C)):
        if int(comm.all_reduce(alive.sum().to(torch.int32), "sum")) <= m:
            break
        g = noise[rnd] + torch.where(alive, 0.0, NEG)
        probes, last, loc_idx, top_pos = dd._propose(view, comm, g, m, min(m, n_loc),
                                                     resid, None)
        ids = comm.all_gather((loc_idx + first).to(torch.int32)).reshape(-1)
        probes_all.append(ids[top_pos].long())
        alive &= ~(g >= last)
        left = comm.all_gather(alive.sum().to(torch.int32)).tolist()
        size = min(b for b in buckets if b >= max(left))
        cut = {}
        for k, be in routes.items():
            if size >= n_loc:
                div[k] = torch.minimum(div[k], be.shard_divergence(
                    view, probes[:, :-2], probes[:, -1], ctx))
            else:
                cand = compact_indices(alive, size)
                w = be.shard_divergence(view, probes[:, :-2], probes[:, -1], ctx, cand)
                div[k] = _scatter_min(div[k], w, cand, left[comm.index], slots)
            cut[k] = dd._cut(comm, div[k], alive, bins, shrink)
        rm = {k: alive & (div[k] < cut[k][0]) for k in routes}
        differs = comm.all_reduce((rm["cuda"] != rm["reference"]).any().to(torch.int32)
                                  .reshape(1), "max")
        if int(differs[0]):
            (tk, lo, width, hk), (tp, _, _, hp) = cut["cuda"], cut["reference"]
            flips = torch.nonzero(rm["cuda"] != rm["reference"]).flatten().tolist()
            notes = []
            if not torch.equal(hk, hp):
                # a bin count moved: the elements whose bin differs sit on an edge
                bk = ((div["cuda"] - lo) / width * bins).to(torch.int32)
                bp = ((div["reference"] - cut["reference"][1]) / cut["reference"][2]
                      * bins).to(torch.int32)
                flips = torch.nonzero(alive & (bk != bp)).flatten().tolist()
                for j in flips[:1]:
                    edge = float(lo) + float(width) * max(int(bk[j]), int(bp[j])) / bins
                    x, b = div64(first + j)
                    gap = abs(x - edge)
                    check(gap <= b + abs(float(tk) - float(tp)) + 4 * 2**-24 * abs(edge),
                          f"{label}: SS round {rnd}: element {first + j} is {gap:.3g} "
                          f"from bin edge {edge:.6g} in float64, above float32 "
                          f"rounding {b:.3g}")
                    notes.append(f"SS round {rnd}: element {first + j}'s bin differs; "
                                 f"its float64 divergence is {gap:.3g} from the edge, "
                                 f"within float32 rounding {b:.3g}")
            else:
                for j in flips[:1]:
                    x, b = div64(first + j)
                    lo_t, hi_t = sorted((float(tk), float(tp)))
                    gap = max(lo_t - x, x - hi_t, 0.0)
                    check(gap <= b, f"{label}: SS round {rnd}: element {first + j} "
                          f"is {gap:.3g} outside the cut [{lo_t:.6g}, {hi_t:.6g}] in "
                          f"float64, above float32 rounding {b:.3g}")
                    notes.append(f"SS round {rnd}: element {first + j} flips at the "
                                 f"cut; float64 {gap:.3g} from it, within float32 "
                                 f"rounding {b:.3g}")
            return "; ".join(notes) or f"SS round {rnd}: the cut differs on another rank"
        alive &= ~rm["cuda"]
    fail(f"{label}: the routes keep other V', but no cut differs in lockstep")
    return ""


def sharded_rank(rank: int, store: str, out: str) -> None:
    """One of part (b)'s four ranks, each on the one card (gloo; every
    collective's tensors staged through the host, by ``staged``): on each
    objective, ``summarize_sharded`` on the kernel route and on the plain
    route under the same draws; V', rounds, the trace, eps_hat (within TOL)
    and the picks must agree, or the first decision that differs is shown a
    near tie in float64.  Writes its figures to ``out`` (JSON)."""
    import torch.distributed as dist

    from repro_torch import summarize_sharded
    from repro_torch.core import CudaBackend, ReferenceBackend, distributed as dd
    from repro_torch.core.greedy import fold_in, gumbel
    from repro_torch.core.sparsify import max_rounds
    from repro_torch.kernels import (
        feature_gains_kernel, fl_divergence_kernel, fl_gains_kernel,
        fl_stream_divergence_kernel, fl_stream_gains_kernel, load_library,
        ss_divergence_kernel,
    )
    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    load_library()
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=SHARDED_RANKS)
    mesh = make_mesh((SHARDED_RANKS,), ("data",), "cpu")
    fc = {"ss_divergence": ss_divergence_kernel, "feature_gains": feature_gains_kernel}
    kernels = {"news sqrt": fc, "news satcov": fc,
               "path A": {"fl_divergence": fl_divergence_kernel,
                          "fl_gains": fl_gains_kernel},
               "path B": {"fl_stream_divergence": fl_stream_divergence_kernel,
                          "fl_stream_gains": fl_stream_gains_kernel}}
    record = {}
    for label, fn in _sharded_objectives().items():
        view = fn.shard(mesh, ("data",))
        n_loc = view.local_n()
        gen = torch.Generator(device="cuda").manual_seed(fold_in(0, rank))
        noise = torch.stack([gumbel(n_loc, gen, "cuda")
                             for _ in range(max_rounds(fn.n, R, C))])
        runs = {}
        for route, be in (("cuda", CudaBackend()), ("reference", ReferenceBackend())):
            _sharded_counts(kernels[label])
            (res, ss), wall = _synced(lambda: summarize_sharded(
                view, K, mesh, r=R, c=C, backend=be, noise=noise))
            runs[route] = (res, ss, wall, {k: v.launches for k, v in kernels[label].items()},
                           dict(dd.COUNTS))
        (rk, sk, wk, lk, ck), (rp, sp, wp, lp, _) = runs["cuda"], runs["reference"]
        div_name, gains_name = kernels[label]
        check(lk[div_name] == sk.rounds and lk[gains_name] == K and not any(lp.values()),
              f"{label} rank {rank}: launches {lk} on the kernel route (want "
              f"{sk.rounds} and {K}), {lp} on the plain route (want none)")
        note = "equal"
        if not (torch.equal(sk.vprime, sp.vprime) and sk.rounds == sp.rounds
                and torch.equal(sk.alive_trace, sp.alive_trace)):
            note = _explain_sharded_ss(label, fn, view, mesh, noise)
        else:
            fin = sk.divergence < 1e29
            ddiv = float((sk.divergence[fin] - sp.divergence[fin]).abs().max())
            scale = max(1.0, float(sp.divergence[fin].abs().max()))
            check(ddiv <= TOL[torch.float32] * scale and
                  abs(float(sk.eps_hat) - float(sp.eps_hat)) <= ddiv,
                  f"{label}: divergence err {ddiv} (scale {scale}), eps_hat "
                  f"{float(sk.eps_hat)} vs {float(sp.eps_hat)}")
            if not torch.equal(rk.selected, rp.selected):
                comm = dd.Collectives(mesh, ("data",))
                ctx = view.shard_init(comm)
                taken, counts = _sharded_taken(view, sk.vprime, comm)
                note = _explain_picks(label, fn, torch.nonzero(sk.vprime).flatten(), K, {
                    route: (lambda st, be=be: _frame_gains(
                        comm, be.shard_gains(taken, st, ctx), counts))
                    for route, be in (("cuda", CudaBackend()),
                                      ("reference", ReferenceBackend()))})
        record[label] = {
            "n": fn.n, "n_loc": n_loc, "vprime": int(sk.vprime.sum()),
            "rounds": sk.rounds, "eps_hat": [float(sk.eps_hat), float(sp.eps_hat)],
            "value": [float(rk.value), float(rp.value)],
            "selected": rk.selected.tolist(), "wall_s": [wk, wp],
            "launches": lk, "collectives": ck, "routes": note}
    with open(out, "w") as fh:
        json.dump(record, fh)
    dist.destroy_process_group()


def sharded_phase() -> dict:
    """The sharded phase: part (a) ran at the end of each SS path
    (``sharded_one_rank``); part (b) here: four ranks on the one card over
    gloo, each a process of this script (``--sharded-rank``), which is
    possible only in the card's Default compute mode.  A failing rank fails
    the phase: its error is raised here."""
    import tempfile

    t0 = time.perf_counter()
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"compute mode: {mode}", flush=True)
    check(mode.splitlines()[0].strip() == "Default",
          f"four processes share the card only in Default compute mode, not {mode}")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(SHARDED_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--sharded-rank", str(r),
             os.path.join(tmp, "store"), outs[r]], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "OMP_NUM_THREADS": "2"}) for r in range(SHARDED_RANKS)]
        logs = []
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
        for r, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"sharded rank {r} failed:\n{log[-4000:]}")
        recs = [json.load(open(o)) for o in outs]
    for r, rec in enumerate(recs[1:], 1):
        for label, v in rec.items():
            check(v["selected"] == recs[0][label]["selected"]
                  and v["vprime"] == recs[0][label]["vprime"],
                  f"sharded rank {r} returned other results on {label}")
    four = recs[0]
    for label, v in four.items():
        print(f"{label} summarize_sharded, 4 ranks on one card over gloo: n = "
              f"{v['n']} ({v['n_loc']} a rank), |V'| = {v['vprime']}, rounds = "
              f"{v['rounds']}, eps_hat {v['eps_hat'][0]:.6f} (plain "
              f"{v['eps_hat'][1]:.6f}), f(S') {v['value'][0]:.6f} (plain "
              f"{v['value'][1]:.6f}); wall {v['wall_s'][0]:.3f} s (plain "
              f"{v['wall_s'][1]:.3f} s); rank 0 launches {json.dumps(v['launches'])}, "
              f"collectives {json.dumps(v['collectives'])}; kernel route vs plain: "
              f"{v['routes']}", flush=True)
    SHARDED["four_ranks"] = four
    SHARDED["four_ranks_s"] = time.perf_counter() - t0
    SHARDED["compute_mode"] = mode
    return SHARDED


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
    kernel's own (BH, S, hd) form (float32, and bfloat16 at head_dim 64,
    128 and 256), held by ``flash_close``.  Each case goes through the
    route ``flash_route`` names; every bfloat16 case at head_dim 64, 128 or
    256 must launch the tensor-core kernel."""
    from repro_torch.kernels import (attention_ref, flash_attention_kernel,
                                     flash_attention_ref, flash_route)

    g = torch.Generator(device="cuda").manual_seed(5)
    cases, tc_cases, tc_want = 0, 0, 0

    def run(*args, **kw):
        nonlocal cases, tc_cases, tc_want
        q = args[0]
        n_tc = flash_attention_kernel.launches_tc
        out = flash_attention_kernel(*args, **kw)
        tc = flash_route(q.dtype, q.shape[-1]) == "tc"
        check(flash_attention_kernel.launches_tc - n_tc == int(tc),
              f"flash {q.dtype} hd={q.shape[-1]}: not the {'tc' if tc else 'ffma'}"
              " route")
        cases += 1
        tc_cases += flash_attention_kernel.launches_tc - n_tc
        tc_want += q.dtype == torch.bfloat16 and q.shape[-1] in (64, 128, 256)
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
    for dt, hd in ((torch.float32, 64), (torch.bfloat16, 64), (torch.bfloat16, 128),
                   (torch.bfloat16, 256)):
        q, k, v = (torch.randn((8, 200, hd), generator=g, device="cuda").to(dt)
                   for _ in range(3))
        err = flash_close(run(q, k, v, window=48),
                          flash_attention_ref(q, k, v, True, 48),
                          f"flash_attention (BH, S, hd) form, {dt} hd={hd}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
    torch.cuda.synchronize()
    check(tc_cases == tc_want, f"flash: {tc_cases} tensor-core launches, not one "
          f"for each of the {tc_want} bfloat16 cases at head_dim 64, 128 and 256")
    print(f"flash kernels vs plain: {cases} cases passed, {tc_cases} of them "
          f"(every bfloat16 case at head_dim 64, 128 and 256) on the tensor-core "
          f"route; max abs err {errs['flash_attention']:.3g}; bfloat16 at most "
          f"{FLASH_WORST[0]:.4f} of its tolerance", flush=True)


def flash_bound(nbytes: float, pairs: float, hd: int) -> tuple[float, str, str]:
    """The least time for the flash function on bf16 inputs: one
    exponential a (q, k) pair the mask keeps, QKᵀ on the bf16 tensor cores
    (exact products, float32 sums) and P·V as TC_PARTS bf16 products (P
    kept in float32), against one read of q, k, v and one write of o."""
    from repro_torch.kernels.flash_attention import TC_PARTS

    return bound(nbytes, sfu=pairs, bf16_tc=(2 + 2 * TC_PARTS) * pairs * hd)


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


def _serve(cfg, params, B: int, S: int, NEW: int) -> dict:
    """The LM main path on ``params``: ``Engine.generate`` on B random
    S-token prompts with the flash counts set to 0 just before (one launch
    per attention layer of the prefill, on ``flash_route``'s route, none in
    decode), then the same path step by step, timed (TTFT, decode ms a step,
    peak), with the counts per phase and the same tokens."""
    from repro_torch.kernels import flash_attention_kernel, flash_route
    from repro_torch.models.layers import dtype_of
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.engine import _sample

    n_attn = sum(b in ("attn", "attn_moe", "local") for b in cfg.layer_types)
    route = flash_route(dtype_of(cfg.compute_dtype), cfg.head_dim) if n_attn else None
    n_tc = n_attn if route == "tc" else 0
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
          and int(tokens.max()) < cfg.vocab_size, f"{cfg.name} generate: bad tokens")
    check(launches == n_attn and launches_tc == n_tc,
          f"{cfg.name}: generate launched the flash kernels {launches} times "
          f"({launches_tc} on the tensor-core route), not once per attention "
          f"layer of the prefill ({n_attn}, route {route}) and never in decode")
    print(f"{cfg.name} generate: {B} x {S}-token prompts -> {tuple(tokens.shape)} "
          f"tokens in {wall_gen:.4f} s (host clock, synchronised, first call); "
          f"flash launches {launches}, {launches_tc} on the tensor-core route",
          flush=True)

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
    prefill_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
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
    decode_peak = torch.cuda.max_memory_allocated() / 2**30
    peak = max(prefill_peak, decode_peak)
    check(prefill_launches == n_attn and prefill_tc == n_tc and decode_launches == 0,
          f"{cfg.name} launches: prefill {prefill_launches} ({prefill_tc} "
          f"tensor-core), decode {decode_launches}")
    check(torch.equal(torch.cat(toks, 1), tokens),
          f"{cfg.name}: the step-by-step run gave other tokens than generate")
    ms_tok = decode_s * 1e3 / (NEW - 1)
    print(f"{cfg.name} ({CARD[0]}): prefill {prefill_ms:.4f} ms, time to first "
          f"token {ttft_ms:.4f} ms; decode {ms_tok:.4f} ms per step "
          f"({B * (NEW - 1) / decode_s:.1f} tokens/s over {B} requests); peak "
          f"device memory {peak:.2f} GiB (prefill {prefill_peak:.2f}, decode "
          f"{decode_peak:.2f}); flash launches: prefill "
          f"{prefill_launches}, decode {decode_launches}", flush=True)
    return {"eng": eng, "sc": sc, "gen": gen, "prompts": prompts, "tokens": tokens,
            "toks": toks, "step_logits": step_logits, "cache": cache,
            "n_attn": n_attn, "route": route, "launches": launches,
            "launches_tc": launches_tc, "prefill_ms": prefill_ms,
            "ttft_ms": ttft_ms, "decode_ms_per_step": ms_tok,
            "tokens_per_s": B * (NEW - 1) / decode_s, "peak_gib": peak,
            "prefill_peak_gib": prefill_peak, "decode_peak_gib": decode_peak}


@contextlib.contextmanager
def routing(chosen: list, replay: bool):
    """Every MoE layer's expert picks, in the order the layers route:
    recorded into ``chosen``, or replayed from it (each layer then gates
    its own probabilities at the replayed picks)."""
    import repro_torch.models.moe as moe_lib

    real, picks = moe_lib.top_k, iter(chosen)

    def top_k(x, k):
        if replay:
            idx = next(picks)
            return x.gather(-1, idx), idx
        vals, idx = real(x, k)
        chosen.append(idx)
        return vals, idx

    moe_lib.top_k = top_k
    try:
        yield
    finally:
        moe_lib.top_k = real
    check(not replay or next(picks, None) is None,
          "the replay routed fewer layers than the recording")


def _plain_route(cfg, params, prompts, toks, step_logits, max_len: int,
                 seen: list | None = None) -> float:
    """The same weights with attention through the plain version, fed the
    kernel route's tokens: logits at every step held by ``_logits_close``.
    With experts, the kernel route runs again recording every layer's
    picks and the plain route replays them (``routing``), so both dispatch
    the same pairs: a near-tie flip (``_lockstep`` shows each) would
    otherwise move a pair to another expert and shift which pairs capacity
    drops, a discrete change.  Returns the largest error relative to
    max|logits|."""
    from repro_torch.models import decode_step, prefill

    S = prompts.shape[1]

    def steps():
        logits, cache = prefill(cfg, params, prompts, max_len=max_len)
        yield logits
        for i in range(len(toks) - 1):
            logits, cache = decode_step(cfg, params, toks[i], cache, S + i)
            yield logits

    chosen, moe_model = [], "attn_moe" in cfg.block_pattern
    if moe_model:
        with routing(chosen, replay=False):
            step_logits = list(steps())
    with plain_attention(seen), (routing(chosen, replay=True) if moe_model
                                 else contextlib.nullcontext()):
        rel = max(_logits_close(got, want, f"{cfg.name} step {i} (0: the prefill), "
                                "kernel vs plain")
                  for i, (got, want) in enumerate(zip(step_logits, steps())))
    print(f"{cfg.name} plain route (attention through the plain version, the "
          f"kernel route's tokens{', its expert picks replayed' if moe_model else ''}"
          f"): logits agree at every step, max err {rel:.4g} of max|logits|",
          flush=True)
    return rel


def _params_on_card(cfg) -> tuple[dict, int]:
    """Full-size float32 parameters made on the card from seed 0, held to
    the config's count: the config estimates the weight matrices (the
    leaves of two or more axes) and the final norm and leaves out the other
    norm scales, biases and per-channel vectors, so the matrices are held
    to it within 1e-3 (mamba2-780m's conv taps are the most it leaves out,
    8.2e-4).  Returns (params, every parameter's count)."""
    from repro_torch.models import init_params
    from repro_torch.models.decoder import _layers
    from repro_torch.models.layers import tree_leaves

    t = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t
    n_params = sum(t_.numel() for t_ in tree_leaves(params))
    n_mat = sum(t_.numel() for t_ in tree_leaves(params["embed"]) if t_.dim() >= 2)
    n_mat += sum(t_.numel() for _, p, _ in _layers(cfg, params)
                 for t_ in tree_leaves(p) if t_.dim() >= 2)
    est = cfg.param_count() - cfg.d_model
    print(f"{cfg.name}: {cfg.num_layers} layers {cfg.layer_types[:3]}..., d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV heads x "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}: {n_params} parameters "
          f"({cfg.param_dtype}, {n_params * 4 / 2**30:.2f} GiB; compute "
          f"{cfg.compute_dtype}) made on the card in {made_s:.2f} s; weight "
          f"matrices {n_mat}, the config's estimate {est} "
          f"({n_mat / est - 1:.3g} off)", flush=True)
    check(abs(n_mat / est - 1) < 1e-3, f"{cfg.name}: the parameters are not the config's")
    return params, n_params


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
    from repro_torch.models import forward

    cfg = configs.get(LM_ARCH)
    B, S, NEW = LM_B, LM_S, LM_NEW
    params, _ = _params_on_card(cfg)
    run = _serve(cfg, params, B, S, NEW)
    check(run["n_attn"] == cfg.num_layers and run["route"] == "tc",
          "qwen3-4b: every layer's attention on the tensor-core route")
    # the same prompts and parameters served sharded at one rank over NCCL
    SHARDED_SERVE["one_rank"] = lm_serve_one_rank(cfg, params, run)
    eng, sc, gen, prompts = run["eng"], run["sc"], run["gen"], run["prompts"]
    toks, step_logits, cache = run["toks"], run["step_logits"], run["cache"]
    launches, launches_tc = run["launches"], run["launches_tc"]

    # the plain route: same weights, attention through the plain version,
    # fed the kernel route's tokens
    seen = []
    _plain_route(cfg, params, prompts, toks, step_logits, sc.max_len, seen)
    full, _ = forward(cfg, params, torch.cat([prompts, toks[0]], 1),
                      logits_slice=1)
    rel_fwd = _logits_close(step_logits[1], full, "decode at S vs forward over S+1")
    print(f"decode at position {S} vs forward over {S + 1} tokens {rel_fwd:.4g}",
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
        # ``flash_bound`` over the causal pairs.  Yardsticks: the FFMA
        # design (P·V on the CUDA cores) and both products once on the
        # tensor cores (P rounded once: a different result).
        pairs = b * H * s * (s + 1) / 2
        nbytes = (2 * b * s * H * hd + 2 * b * s * KV * hd) * q.element_size()
        check(q.dtype == torch.bfloat16, "flash_bounds count bfloat16 inputs")
        tc = flash_bound(nbytes, pairs, hd)
        ffma_design = bound(nbytes, ffma=pairs * hd, sfu=pairs,
                            bf16_tc=2 * pairs * hd)[0]
        return tc, ffma_design, bound(0.0, bf16_tc=4 * pairs * hd)[0]

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
    # SS pruning of the KV cache after a fresh prefill, then decode from it
    del q1, k1, v1, out_long, lib_out, qx, kx, vx
    kv_prune = kv_prune_phase(cfg, eng, prompts, sc, errs)
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
                    **{k_: run[k_] for k_ in ("prefill_ms", "ttft_ms",
                                              "decode_ms_per_step", "peak_gib",
                                              "prefill_peak_gib",
                                              "decode_peak_gib")},
                    "profile": prof,
                    "kv_prune": kv_prune},
    }


# -- the other LM block types: experts, Mamba2 SSD and RG-LRU -----------------

# (arch, batch, prompt length): olmoe's attn_moe blocks (flash on the
# tensor-core route), recurrentgemma's rglru / local hybrid at prompts of
# twice its 2048 window (the tensor-core route at head_dim 256, windowed;
# the local caches' ring buffers wrap), mamba2's SSD stack (no attention,
# no kernel).  Full widths
# and depths, 32 new tokens each.
FAMILIES = (("olmoe-1b-7b", 4, 2048), ("recurrentgemma-2b", 4, 4096),
            ("mamba2-780m", 4, 2048))
FAMILY_NEW = 32
# The reference's prefill-seeds-decode rule (tests/test_models_smoke.py:95-
# 115, float32 compute): max |decode - forward| < 5e-3, absolute.
SEED_DECODE_TOL = 5e-3


def _route_flips(label: str, logits_k, logits_p, K: int) -> tuple[int, list]:
    """The kernel route's and the plain route's top-K experts of every token
    of one layer (router logits (T, E): bf16 values in float32; the picks
    are ``_route``'s, on their softmax): the tokens whose sets differ.  A
    swap must be a near tie: on each route the logits of the experts it
    swaps are equal or adjacent bf16 values (the widest gap between one it
    picks and one it passes over at most one bf16 spacing at their
    magnitude), so one rounding of the logits explains it.  Returns each
    swap's (token, plain gap, kernel gap) in bf16 spacings."""
    from repro_torch.models.moe import top_k

    set_k = top_k(torch.softmax(logits_k, -1), K)[1].sort(-1).values
    set_p = top_k(torch.softmax(logits_p, -1), K)[1].sort(-1).values
    diff = (set_k != set_p).any(-1).nonzero()[:, 0].tolist()

    def spacings(lg, hi, lo):
        # the widest gap between a picked (hi) and a passed-over (lo)
        # expert, in bf16 spacings at the largest magnitude among them
        mag = float(lg[hi + lo].abs().max())
        return float(lg[hi].max() - lg[lo].min()) / 2.0 ** (math.floor(math.log2(mag)) - 7)

    gaps = []
    for t in diff:
        a = sorted(set(set_k[t].tolist()) - set(set_p[t].tolist()))
        b = sorted(set(set_p[t].tolist()) - set(set_k[t].tolist()))
        g_p, g_k = spacings(logits_p[t], b, a), spacings(logits_k[t], a, b)
        check(max(g_p, g_k) <= 1,
              f"{label}: token {t} takes experts {a} on the kernel route, {b} on "
              f"the plain: gaps {g_p:.3g} (plain), {g_k:.3g} (kernel) bf16 "
              "spacings is no near tie")
        gaps.append((t, g_p, g_k))
    return len(diff), gaps


def _lockstep(cfg, params, prompts, errs: dict) -> dict:
    """The prefill layer by layer, both attention routes from the kernel
    route's input: each attention layer's flash output against the plain
    version on the same (q, k, v) (``flash_close``); for ``attn_moe`` the
    top-K experts each route's residual picks (``_route_flips``) and the
    (token, k) pairs capacity drops on the kernel route.  Returns the
    first attention layer's (q, k, v, window) with the per-layer figures."""
    from repro_torch.kernels import attention_ref, flash_attention_kernel
    from repro_torch.models import attention as attn
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import rglru as rglru_lib
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models.decoder import _embed, _layers, _second_half, _window
    from repro_torch.models.layers import dtype_of, rmsnorm

    cdt = dtype_of(cfg.compute_dtype)
    B, S = prompts.shape
    x = _embed(cfg, params, prompts, None)
    positions = torch.arange(S, device=x.device)
    C = moe_lib.capacity(cfg, S) if cfg.num_experts else 0
    first, layers = None, []
    for i, (btype, p, _) in enumerate(_layers(cfg, params)):
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        if btype == "mamba2":
            x = x + ssm_lib.mamba2_forward(p["mixer"], cfg, h)
            continue
        if btype == "rglru":
            x = _second_half(cfg, btype, p, x + rglru_lib.rglru_forward(
                p["mixer"], cfg, h))[0]
            continue
        w = _window(cfg, btype)
        q, k, v = attn._project_qkv(p["attn"], cfg, h, positions)
        o_k = flash_attention_kernel(q, k, v, causal=True, window=w)
        o_p = attention_ref(q, k, v, True, w)
        err = flash_close(o_k, o_p, f"{cfg.name} layer {i} ({btype}): flash vs plain")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        if first is None:
            first = (q, k, v, w)
        row = {"layer": i, "type": btype, "attn_err": err}
        x_k = x + o_k.reshape(B, S, cfg.q_dim) @ p["attn"]["w_o"].to(cdt)
        if btype == "attn_moe":
            x_p = x + o_p.reshape(B, S, cfg.q_dim) @ p["attn"]["w_o"].to(cdt)
            logits = []
            for xr in (x_k, x_p):
                h2 = rmsnorm(p["ln2"], xr, cfg.norm_eps).reshape(B * S, -1)
                logits.append((h2.to(cdt) @ p["moe"]["router"].to(cdt)).float())
            flips, gaps = _route_flips(f"{cfg.name} layer {i}", *logits, cfg.top_k)
            top = moe_lib.top_k(torch.softmax(logits[0], -1),
                                cfg.top_k)[1].reshape(B, S, -1)
            keys = moe_lib.dispatch_keys(top, cfg.num_experts, C)
            row.update(dropped=int((keys == cfg.num_experts * C).sum()),
                       flips=flips, gaps=[[g_p, g_k] for _, g_p, g_k in gaps])
            moe_line = (f"; (token, k) pairs dropped by capacity (C = {C}) "
                        f"{row['dropped']} of {B * S * cfg.top_k}; tokens routed "
                        f"differently by the two routes {flips}"
                        + "".join(f"; token {t} gaps {g_p:.3g}, {g_k:.3g}"
                                  for t, g_p, g_k in gaps[:4])
                        + (" (bf16 spacings: plain, kernel)" if gaps else ""))
        print(f"  layer {i} ({btype}): attention err {err:.4g}"
              + (moe_line if btype == "attn_moe" else ""), flush=True)
        layers.append(row)
        x = _second_half(cfg, btype, p, x_k)[0]
        del q, k, v, o_k, o_p
    return {"first": first, "layers": layers, "capacity": C}


def _flash_at_shape(cfg, q, k, v, window: int, errs: dict) -> dict:
    """The flash kernels at a family's first attention layer's shape
    (recurrentgemma-2b: windowed MQA at head_dim 256): the route's kernel
    (``flash_route``: the tensor cores) and the FFMA kernel (the first
    design, ``_launch(..., tc=False)``) on the same inputs, timed in turns
    (tc, ffma, ffma, tc; ``kernel_ms``), the tensor-core kernel faster in
    each pair; beside them the function's bound (``flash_bound``), each
    design's own, the plain version and ``scaled_dot_product_attention``
    with the window as a boolean mask (P rounded to bf16 once: another
    function, a yardstick); the share of each kernel's bf16 outputs that
    differ from the plain version's, and of the plain version's with P
    rounded once; what ptxas reported for the head width's tensor-core
    instance (no spill allowed at head_dim 256)."""
    from repro_torch.kernels import (attention_ref, attention_split_p_ref,
                                     flash_attention_kernel, flash_route)
    from repro_torch.kernels.flash_attention import TC_PARTS, _launch

    B, S, H, hd = q.shape
    KV = k.shape[2]
    check(q.dtype == torch.bfloat16, "flash_bound counts bfloat16 inputs")
    check(flash_route(q.dtype, hd) == "tc", f"{cfg.name}: not the tensor-core route")

    def kern():
        return flash_attention_kernel(q, k, v, causal=True, window=window)

    def ffma():
        o = torch.empty_like(q)
        _launch(q, k, v, o, True, window, tc=False)
        return o

    n0, tc0 = flash_attention_kernel.launches, flash_attention_kernel.launches_tc
    out = kern()
    check(flash_attention_kernel.launches - n0 == 1
          and flash_attention_kernel.launches_tc - tc0 == 1,
          f"{cfg.name}: the tensor-core kernel did not launch")
    out_f = ffma()
    ref = attention_ref(q, k, v, True, window)
    err = flash_close(out, ref, f"flash (tensor-core) at {cfg.name}'s shape")
    err_f = flash_close(out_f, ref, f"flash (FFMA) at {cfg.name}'s shape")
    errs["flash_attention"] = max(errs["flash_attention"], err, err_f)
    once = attention_split_p_ref(q, k, v, True, window, parts=1)
    flips = {"tc": float((out != ref).float().mean()),
             "ffma": float((out_f != ref).float().mean()),
             "plain_1_parts": float((once != ref).float().mean())}
    del out_f, once
    check(flips["tc"] <= flips["plain_1_parts"] / 4,
          f"{cfg.name}: flash flip rate {flips['tc']} is over a quarter of "
          f"rounding P once ({flips['plain_1_parts']})")
    turns = [kernel_ms(kern, 10)[1], kernel_ms(ffma, 2)[1],
             kernel_ms(ffma, 2)[1], kernel_ms(kern, 10)[1]]
    check(turns[0].ms < turns[1].ms and turns[3].ms < turns[2].ms,
          f"{cfg.name}: the tensor-core kernel is not faster than the FFMA kernel "
          f"in each pair ({', '.join(f'{t.ms:.4f}' for t in turns)})")
    ms = statistics.median(turns[0].windows + turns[3].windows)
    ffma_ms = statistics.median(turns[1].windows + turns[2].windows)
    plain_ms = kernel_ms(lambda: attention_ref(q, k, v, True, window), 2)[1].ms
    qx, kx, vx = (t.transpose(1, 2).contiguous() for t in (
        q, k.repeat_interleave(H // KV, dim=2), v.repeat_interleave(H // KV, dim=2)))
    i = torch.arange(S, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window:
        mask &= i[:, None] - i[None, :] < window
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qx, kx, vx, attn_mask=mask)
    err_lib = float((out.float() - lib_out.transpose(1, 2).float()).abs().max())
    check(err_lib <= TOL[torch.bfloat16] * float(v.float().abs().max()),
          f"flash at {cfg.name}'s shape vs the library: err {err_lib}")
    lib_ms = kernel_ms(lambda: sdpa(qx, kx, vx, attn_mask=mask), 5)[1].ms
    del qx, kx, vx, lib_out, mask
    # each query reads min(i + 1, window) keys.  The bound is the
    # function's on bf16 inputs (``flash_bound``).  Yardsticks: the
    # tensor-core design's own (at head_dim 256 each of O's two column
    # halves computes QKᵀ and the softmax: 10 hd flops a pair, not 8) and
    # the FFMA design's, 2 hd FFMAs (Q.K, P.V) and one exponential a pair.
    pairs = B * H * sum(min(j + 1, window or S) for j in range(S))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b_ms, b_by, b_pipe = flash_bound(nbytes, pairs, hd)
    halves = 2 if hd == 256 else 1
    design = bound(nbytes, sfu=halves * pairs,
                   bf16_tc=(2 * halves + 2 * TC_PARTS) * pairs * hd)[0]
    ffma_design = bound(nbytes, ffma=2 * pairs * hd, sfu=pairs)[0]
    share = b_ms / ms
    check(share <= 1.05, f"flash at {cfg.name}'s shape runs at {share:.3f} of its "
          "bound")
    regs, store, load, _ = ptxas_report("flash_attention_tc", f"flash_kernel_tcILi{hd}E",
                                        threads=384)
    check(hd != 256 or store == load == 0,
          f"flash_kernel_tc<256>: ptxas spills {store}/{load} bytes")
    print(f"flash_attention at {cfg.name}'s shape (B={B}, S={S}, H={H}, KV={KV}, "
          f"hd={hd}, bf16, causal, window {window}; {CARD[0]}): tensor-core route "
          f"{ms:.4f} ms per launch (median of its 10 windows; in turns "
          f"{', '.join(f'{t.ms:.4f}' for t in turns)}: tc, ffma, ffma, tc), bound "
          f"{b_ms:.4f} ms ({b_by}: {b_pipe}), share {share:.4f}; the tensor-core "
          f"design's bound {design:.4f} ms (share {design / ms:.4f}); FFMA kernel "
          f"{ffma_ms:.4f} ms (its design's bound {ffma_design:.4f} ms); plain "
          f"{plain_ms:.4f} ms; library (scaled_dot_product_attention, the mask as "
          f"a boolean tensor, P rounded once) {lib_ms:.4f} ms; flip rates against "
          f"the plain version: tensor-core {flips['tc']:.6f}, FFMA "
          f"{flips['ffma']:.6f}, plain with P rounded once "
          f"{flips['plain_1_parts']:.6f}; vs plain err {err:.3g}, vs the library "
          f"{err_lib:.3g}; ptxas flash_kernel_tc<{hd}>: {regs} registers (launch "
          f"bound; consumers 232 by setmaxnreg), spill stores/loads {store}/{load} "
          "bytes", flush=True)
    return {"route": "tc", "ms": ms, "windows": turns[0].windows + turns[3].windows,
            "turns_ms": [t.ms for t in turns], "ffma_ms": ffma_ms,
            "bound_ms": b_ms, "bound_by": b_by, "pipe": b_pipe,
            "share_of_bound": share, "tc_design_bound_ms": design,
            "ffma_design_bound_ms": ffma_design, "plain_ms": plain_ms,
            "library_ms": lib_ms, "flip_rates": flips, "max_abs_err": err,
            "ptxas": {"registers": regs, "spill_store_bytes": store,
                      "spill_load_bytes": load},
            "shape": [B, S, H, KV, hd], "window": window}


def _seeds_decode(cfg, params, prompts, toks, label: str) -> dict:
    """Decode seeded by the prefill against the forward over S + n tokens,
    for the first 2 decode steps, with float32 compute (the reference's own
    setting) at ``SEED_DECODE_TOL``."""
    import dataclasses

    from repro_torch.models import decode_step, forward, prefill

    S = prompts.shape[1]
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    logits, cache = prefill(cfg32, params, prompts, max_len=S + 8)
    full32, _ = forward(cfg32, params, torch.cat([prompts, toks[0], toks[1]], 1),
                        logits_slice=3)
    steps = [logits]
    for n in range(2):
        lg, cache = decode_step(cfg32, params, toks[n], cache, S + n)
        steps.append(lg)
    del cache
    errs32 = [float((got - full32[:, n:n + 1]).abs().max())
              for n, got in enumerate(steps)]
    scale = float(full32.abs().max())
    check(max(errs32) < SEED_DECODE_TOL,
          f"{label}: float32 prefill and decode vs the forward err {errs32}, not "
          f"under {SEED_DECODE_TOL}")
    print(f"{label}: decode seeded by the prefill vs the forward over S + n "
          f"tokens, float32 compute (prefill, step 1, step 2): max abs err "
          f"{', '.join(f'{e:.4g}' for e in errs32)} against max|logits| {scale:.4g}",
          flush=True)
    return {"float32_abs": errs32, "float32_scale": scale}


def _family(arch: str, B: int, S: int, errs: dict) -> dict:
    """One model served at full width and depth on a freed card: the main
    path (``Engine.generate``, counts from 0), the same path step by step
    (TTFT, decode, peak), the plain attention route's logits
    (``_plain_route``), the prefill layer by layer, decode seeded by the
    prefill (recurrent families), the flash kernels at the first attention
    layer's shape (``_flash_at_shape``) and a profiled prefill."""
    from repro_torch import configs

    cfg = configs.get(arch)
    NEW = FAMILY_NEW
    params, n_params = _params_on_card(cfg)
    run = _serve(cfg, params, B, S, NEW)
    eng, prompts = run["eng"], run["prompts"]
    toks, step_logits = run["toks"], run["step_logits"]
    out = {"arch": cfg.name, "batch": B, "prompt": S, "new": NEW, "params": n_params,
           **{k: run[k] for k in ("n_attn", "launches", "launches_tc", "route",
                                  "prefill_ms", "ttft_ms", "decode_ms_per_step",
                                  "tokens_per_s", "peak_gib", "prefill_peak_gib",
                                  "decode_peak_gib")}}
    del run
    if out["n_attn"]:
        rel = _plain_route(cfg, params, prompts, toks, step_logits, S + NEW + 8)
        print(f"{cfg.name} layer by layer:", flush=True)
        lock = _lockstep(cfg, params, prompts, errs)
        out.update(plain_rel=rel, layers=lock["layers"],
                   capacity=lock["capacity"])
        q, k, v, w = lock["first"]
        out["flash_at_shape"] = _flash_at_shape(cfg, q, k, v, w, errs)
        del q, k, v
        del lock
    if {"mamba2", "rglru"} & set(cfg.block_pattern):
        # (not olmoe: its prefill drops pairs past capacity, its decode has
        # no capacity, so the two differ by design)
        out["seeds_decode"] = _seeds_decode(cfg, params, prompts, toks, cfg.name)
    out["profile"] = profile_lm(f"{cfg.name} prefill", lambda: eng.prefill(prompts))
    return out


def lm_families_phase(errs: dict) -> dict:
    """olmoe-1b-7b, recurrentgemma-2b and mamba2-780m (``FAMILIES``), each
    on a freed card."""
    out = {}
    for arch, B, S in FAMILIES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out[arch] = _family(arch, B, S, errs)
        out[arch]["phase_s"] = time.perf_counter() - t
        print(f"{arch}: {out[arch]['phase_s']:.2f} s", flush=True)
    return out


# -- training: the flash backward kernel, llama3.2-3b at full width -----------

TRAIN_ARCH, TRAIN_STEPS = "llama3.2-3b", 8   # (d)'s smoke config; steps a run
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-3, 5e-2   # (b): kernel vs plain route
# The trained models: (arch, batch, sequence, pool factor).  Candidates a
# batch, pool factor x batch = 64, lie above SS's probe count (8 log2 64 =
# 48), so SS prunes (one round, ``ss_divergence`` launched) before greedy
# picks the batch; the launcher's default 4 (16 or 8 candidates, under 8
# log2 n) would leave the pool whole and never launch it.  recurrentgemma's
# local layers see a window of 2048 keys, which bites only past 2048
# positions: hence 2 x 4096.
TRAIN_RUNS = (("llama3.2-3b", 4, 2048, 16), ("recurrentgemma-2b", 2, 4096, 32))
POOL_B, POOL_S = 256, 2048                    # (e): a 0.5 M-token global batch
BWD_WORST = [0.0]  # largest |out - ref| / tolerance of a bfloat16 backward check


def _bwd_magnitudes(q, k, v, o, do, L, causal: bool, window: int):
    """float64 sums of the magnitudes of the terms each gradient sums, shaped
    like (dq, dk, dv): with P = exp(S - L) (0 where masked), |dS| bounded by
    P (|dO| |V|ᵀ + rowsum(|dO| |O|)), the magnitude of dq is scale |dS| |K|,
    of dk scale |dS|ᵀ |Q|, of dv Pᵀ |dO|.  A float32 evaluation of the
    gradient in any order lies within (hd + S + 4) 2^-24 of them."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G, scale = H // KV, 1.0 / math.sqrt(hd)
    qd, kd, vd, od, gd = (t.double() for t in (q, k, v, o, do))
    s = torch.einsum("bqkgd,bskd->bkgqs", qd.reshape(B, S, KV, G, hd), kd) * scale
    p = torch.exp(s - L.double().reshape(B, KV, G, S)[..., None])
    if causal:
        i = torch.arange(S, device=q.device)
        keep = i[:, None] >= i[None]
        if window > 0:
            keep &= i[:, None] - i[None] < window
        p = torch.where(keep, p, 0.0)
    ga = gd.abs().reshape(B, S, KV, G, hd)
    dsa = p * (torch.einsum("bqkgd,bskd->bkgqs", ga, vd.abs())
               + (gd.abs() * od.abs()).sum(-1).reshape(B, S, KV, G)
               .permute(0, 2, 3, 1)[..., None])
    mq = scale * torch.einsum("bkgqs,bskd->bqkgd", dsa, kd.abs()).reshape(B, S, H, hd)
    mk = scale * torch.einsum("bkgqs,bqkgd->bskd", dsa,
                              qd.abs().reshape(B, S, KV, G, hd))
    mv = torch.einsum("bkgqs,bqkgd->bskd", p, ga)
    return mq, mk, mv


def bwd_close(out, ref, what: str, ref64=None, mag=None) -> float:
    """A flash gradient vs the plain backward (``attention_bwd_ref``, float32
    throughout) on the same inputs; returns max |out - ref|.  float32:
    within 1e-4 of max|ref| (the repository's float32 kernel tolerance).
    bfloat16: per element within one bfloat16 rounding of the float32
    plain result, 2^-8 |ref|, plus that float32 term (the kernel's float32
    sums run in another order before its rounding).  In the sweep (``ref64``
    the plain backward in float64, ``mag`` = (n, the magnitudes of
    ``_bwd_magnitudes``)) the kernel is held to the float64 result instead,
    with the float32 rounding bound of its sums, (n + 4) 2^-24 mag, n = hd +
    S, added per element: a gradient that cancels to nothing (S = 1: one
    key, so dS = dO.V - dO.O = 0) is rounding noise on any float32 route,
    which no share of its own size bounds."""
    check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
          f"{what}: bad output")
    want, slack = ref, 0.0
    if ref64 is not None:
        n, m = mag
        want, slack = ref64, (n + 4) * 2.0 ** -24 * m
    diff = (out.double() - want).abs()
    err, scale = float((out.float() - ref).abs().max()), float(want.abs().max())
    tol = 1e-4 * scale + slack
    if out.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * want.abs()
    worst = float((diff / torch.as_tensor(tol).clamp_min(1e-300)).max())
    if out.dtype == torch.bfloat16:
        BWD_WORST[0] = max(BWD_WORST[0], worst)
    check(worst <= 1.0, f"{what}: err {float(diff.max())}, {worst:.3g} x the "
          f"{'bfloat16' if out.dtype == torch.bfloat16 else 'float32'} tolerance")
    return err


# Long cases of the backward sweep (dtype, head_dim, G, mask, S, KV; a mask
# that is a number is a causal window of that many keys): the tensor-core
# route's rings at their full depth (64 query tiles of a key block's G
# heads, 64 key tiles of a query block), and recurrentgemma-2b's local
# layers (MQA 10:1 at head_dim 256, window 2048; at S 4096 the window
# bites, at 3000 S is not a multiple of a tile).
BWD_LONG = (tuple((torch.bfloat16, 128, 3, "causal", s, 2) for s in (2048, 4096))
            + tuple((torch.bfloat16, 256, 10, 2048, s, 1) for s in (3000, 4096)))


def bwd_sweep(errs: dict) -> None:
    """The backward kernels vs their plain version: float32 and bfloat16 x
    head_dim 32/64/128/256 x G = 1, 3, 10 query heads a KV head x causal,
    a window shorter than S, or no mask x S = 1, 17, 64, 130, 1000, and
    ``BWD_LONG``, held by ``bwd_close`` against the float64 plain backward
    (with the float32 rounding bound of the sums beside), each on the route
    ``flash_bwd_route`` gives (the tensor-core kernel for bf16 at hd
    64/128/256, counted by ``launches_tc``; the FFMA kernel for the rest);
    the forward's O with L requested bitwise equal to O without it (the
    forward's route by ``flash_route``) and its L within 1e-5 relative of
    the plain one; then the TPU layout (BH, S, hd) through
    ``flash_attention_kernel`` under autograd."""
    from repro_torch.kernels import (attention_bwd_ref, attention_lse_ref,
                                     flash_attention_bwd_kernel,
                                     flash_attention_kernel, flash_attention_lse,
                                     flash_bwd_route, flash_route)

    g = torch.Generator(device="cuda").manual_seed(11)
    cases, tc_o, tc_bwd = 0, 0, 0
    for dt, hd, G, mask, S, KV in itertools.chain(((*c, 2) for c in itertools.product(
        (torch.float32, torch.bfloat16), (32, 64, 128, 256), (1, 3, 10),
        ("causal", "window", "none"), (1, 17, 64, 130, 1000),
    )), BWD_LONG):
        if mask == "window" and S == 1:
            continue                       # no window shorter than S
        causal = mask != "none"
        window = (mask if isinstance(mask, int)
                  else max(1, S // 3) if mask == "window" else 0)
        B = 2
        q = torch.randn((B, S, KV * G, hd), generator=g, device="cuda").to(dt)
        k, v = (torch.randn((B, S, KV, hd), generator=g, device="cuda").to(dt)
                for _ in range(2))
        do = torch.randn(q.shape, generator=g, device="cuda").to(dt)
        what = (f"flash backward {dt} hd={hd} G={G} KV={KV} "
                f"{f'window {mask}' if isinstance(mask, int) else mask} S={S}")
        n_ftc = flash_attention_kernel.launches_tc
        o, L = flash_attention_lse(q, k, v, causal=causal, window=window)
        with torch.no_grad():
            check(torch.equal(o, flash_attention_kernel(q, k, v, causal=causal,
                                                        window=window)),
                  f"{what}: O with L requested differs from O without")
        tc_f = flash_route(dt, hd) == "tc"
        check(flash_attention_kernel.launches_tc - n_ftc == 2 * tc_f,
              f"{what}: the forward is not on the "
              f"{'tensor-core' if tc_f else 'FFMA'} route")
        tc_o += tc_f
        o_ref, L_ref = attention_lse_ref(q, k, v, causal, window)
        l_err = float((L - L_ref).abs().max())
        check(l_err <= 1e-5 * max(1.0, float(L_ref.abs().max())),
              f"{what}: L err {l_err}")
        n_tc = flash_attention_bwd_kernel.launches_tc
        got = flash_attention_bwd_kernel(q, k, v, o, do, L, causal=causal,
                                         window=window)
        tc = flash_bwd_route(dt, hd) == "tc"
        check(flash_attention_bwd_kernel.launches_tc == n_tc + tc,
              f"{what}: not on the {'tensor-core' if tc else 'FFMA'} route")
        tc_bwd += tc
        want = attention_bwd_ref(q, k, v, o, do, L, causal, window)
        want64 = attention_bwd_ref(*(t.double() for t in (q, k, v, o, do, L)),
                                   causal, window)
        mags = _bwd_magnitudes(q, k, v, o, do, L, causal, window)
        for name, a, b, b64, m in zip(("dq", "dk", "dv"), got, want, want64, mags):
            check(a.dtype == dt, f"{what}: {name} is {a.dtype}")
            errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], bwd_close(
                a, b, f"{what} {name}", b64, (hd + S, m)))
        cases += 1
    # the TPU kernel's (BH, S, hd) layout, through autograd
    for dt, hd, mask in itertools.product((torch.float32, torch.bfloat16), (64, 128),
                                          ("causal", "window", "none")):
        causal, window = mask != "none", 48 if mask == "window" else 0
        q, k, v = (torch.randn((6, 200, hd), generator=g, device="cuda").to(dt)
                   .requires_grad_() for _ in range(3))
        do = torch.randn(q.shape, generator=g, device="cuda").to(dt)
        n = flash_attention_bwd_kernel.launches
        n_tc = flash_attention_bwd_kernel.launches_tc
        out = flash_attention_kernel(q, k, v, causal=causal, window=window)
        check(out.grad_fn is not None, "flash (BH, S, hd): no grad_fn")
        got = torch.autograd.grad(out, (q, k, v), do)
        check(flash_attention_bwd_kernel.launches == n + 1
              and flash_attention_bwd_kernel.launches_tc
              == n_tc + (flash_bwd_route(dt, hd) == "tc"),
              "flash (BH, S, hd): the backward kernel of its route did not launch")
        o, L = flash_attention_lse(*(t.detach()[:, :, None] for t in (q, k, v)),
                                   causal=causal, window=window)
        want = attention_bwd_ref(q.detach(), k.detach(), v.detach(), o[:, :, 0],
                                 do, L[:, 0], causal, window)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], bwd_close(
                a, b, f"flash backward (BH, S, hd) {dt} hd={hd} {mask} {name}"))
        cases += 1
    torch.cuda.synchronize()
    print(f"flash backward kernels vs plain: {cases} cases passed (O with and "
          f"without L bitwise equal, {tc_o} of them on the tensor-core route; "
          f"{tc_bwd} backward cases on the tensor-core route, the rest on FFMA); "
          f"max abs err {errs['flash_attention_bwd']:.3g}; bfloat16 at most "
          f"{BWD_WORST[0]:.4f} of its tolerance", flush=True)


# The backward's timed shapes: (arch, B, S, H, KV, hd, window) of an
# attention layer in each trained model's step (window 0: plain causal).
BWD_SHAPES = (("llama3.2-3b", 4, 2048, 24, 8, 128, 0),
              ("recurrentgemma-2b", 2, 4096, 10, 1, 256, 2048))


def bwd_ptxas() -> dict:
    """What ptxas reported for the tensor-core backward's instances
    (``dkdv_tc`` and ``dq_tc`` at head_dim 64, 128 and 256): registers at
    the launch bound and spill bytes; no spill allowed at 128 and 256, the
    widths training runs."""
    out = {}
    for hd in (64, 128, 256):
        for kern in ("dkdv_tc", "dq_tc"):
            regs, store, load, _ = ptxas_report("flash_attention_bwd_tc",
                                                f"{kern}ILi{hd}E", threads=384)
            check(hd == 64 or store == load == 0,
                  f"{kern}<{hd}>: ptxas spills {store}/{load} bytes")
            out[f"{kern}<{hd}>"] = {"registers": regs, "spill_store_bytes": store,
                                    "spill_load_bytes": load}
    print(f"flash_attention_bwd_tc ptxas (launch bound 168, consumers 232 by "
          f"setmaxnreg): {out}", flush=True)
    return out


def _sdpa_backend(q, k, v, **kw) -> str:
    """The backend ``scaled_dot_product_attention`` picks on these inputs."""
    from torch.nn.attention import SDPBackend

    choice = int(torch._fused_sdp_choice(q, k, v, **kw))
    return next((name for name, b in SDPBackend.__members__.items()
                 if int(b) == choice), f"backend {choice}")


def bwd_at_shape(errs: dict, arch: str, B: int, S: int, H: int, KV: int, hd: int,
                 window: int) -> dict:
    """The backward at a trained model's attention shape (``BWD_SHAPES``;
    bf16, causal, ``window`` > 0 a sliding window): the tensor-core route
    and the FFMA kernel on the same inputs, timed in turns (tc, ffma, ffma,
    tc; ``kernel_ms``, each route's time the median of its windows), the
    tensor-core route faster in each pair, beside the function's bound
    (``flash_bound``'s rule: QKᵀ and dO Vᵀ exact bf16 products, the three
    products with float32 P or dS at TC_PARTS parts each, 22 hd tensor-core
    flops and one exponential a pair), the tensor-core design's own (26 hd:
    QKᵀ and dO Vᵀ in both of its kernels; 34 hd at head_dim 256, where both
    column halves compute them too), the FFMA design's (7 hd FFMAs a pair),
    the plain backward, and the backward of ``scaled_dot_product_attention``
    (KV expanded, the window as a boolean mask; it rounds P once: a
    yardstick) with the backend it took; the flip rates of the bf16
    gradients against the plain float32 ones rounded, for both kernels and
    for the plain version with P and dS in 1, 2 and 3 bf16 parts (the
    tensor-core route's at most a quarter of one part's)."""
    from repro_torch.kernels import (attention_bwd_ref, flash_attention_bwd_kernel,
                                     flash_attention_lse)
    from repro_torch.kernels.flash_attention import TC_PARTS, _bwd_launch

    g = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((B, S, KV, hd), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    do = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
    o, L = flash_attention_lse(q, k, v, window=window)

    def tc_route():
        return flash_attention_bwd_kernel(q, k, v, o, do, L, window=window)

    def ffma():
        # the CUDA-core kernel on the same bf16 inputs (the earlier design)
        return _bwd_launch(q, k, v, o, do, L, True, window, False)

    n_tc = flash_attention_bwd_kernel.launches_tc
    got, got_f = tc_route(), ffma()
    check(flash_attention_bwd_kernel.launches_tc == n_tc + 1,
          f"flash backward at {arch}'s shape: not on the tensor-core route")
    want, tp = kernel_ms(lambda: attention_bwd_ref(q, k, v, o, do, L, True, window), 2)
    err = 0.0
    for name, a, f, b in zip(("dq", "dk", "dv"), got, got_f, want):
        err = max(err, bwd_close(a, b, f"flash backward (tensor-core) at {arch}'s "
                                       f"shape {name}"),
                  bwd_close(f, b, f"flash backward (FFMA) at {arch}'s shape {name}"))
    errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], err)
    n_out = sum(a.numel() for a in got)

    def flip_rate(grads):
        # the share of bf16 gradients that differ from the plain float32
        # ones rounded to bf16
        return sum(int((a.bfloat16() != b.bfloat16()).sum())
                   for a, b in zip(grads, want)) / n_out

    flips = {"tc": flip_rate(got), "ffma": flip_rate(got_f)}
    for parts in (1, 2, 3):
        flips[f"plain_{parts}_parts"] = flip_rate(
            attention_bwd_ref(q, k, v, o, do, L, True, window, parts=parts))
    del got, got_f, want
    check(flips["tc"] <= flips["plain_1_parts"] / 4,
          f"flash backward flip rate {flips['tc']} at {arch}'s shape is over a "
          f"quarter of rounding P and dS once ({flips['plain_1_parts']}): the "
          "products do not keep float32 P and dS")
    print(f"flash backward flip rates at {arch}'s shape (bf16 gradients that "
          f"differ from the plain float32 ones rounded): tensor-core route "
          f"({TC_PARTS} parts, summed in the wgmma accumulator across tiles) "
          f"{flips['tc']:.6f}, FFMA kernel {flips['ffma']:.6f}; plain with P and dS "
          f"rounded to bf16 once {flips['plain_1_parts']:.6f}, in 2 parts "
          f"{flips['plain_2_parts']:.6f}, in 3 parts {flips['plain_3_parts']:.6f}",
          flush=True)

    # both kernels in turns (tc, ffma, ffma, tc)
    turns = [kernel_ms(tc_route, 10)[1], kernel_ms(ffma, 2)[1],
             kernel_ms(ffma, 2)[1], kernel_ms(tc_route, 10)[1]]
    check(turns[0].ms < turns[1].ms and turns[3].ms < turns[2].ms,
          f"flash backward at {arch}'s shape: the tensor-core route is not faster "
          f"than the FFMA kernel in each pair ({', '.join(f'{t.ms:.4f}' for t in turns)})")
    tc_windows = turns[0].windows + turns[3].windows
    ffma_windows = turns[1].windows + turns[2].windows
    ms, ffma_ms = statistics.median(tc_windows), statistics.median(ffma_windows)
    # each query reads min(i + 1, window) keys
    pairs = B * H * sum(min(j + 1, window or S) for j in range(S))
    nbytes = 8 * q.numel() * 2 + 4 * k.numel() * 2 + L.numel() * 4
    b_ms, b_by, b_pipe = bound(nbytes, sfu=pairs,
                               bf16_tc=(2 + 2 + 3 * 2 * TC_PARTS) * pairs * hd)
    # QKᵀ and dO Vᵀ in both kernels, and at head_dim 256 in both column halves
    recompute = 4 if hd == 256 else 2
    tc_design = bound(nbytes, sfu=pairs,
                      bf16_tc=(recompute * (2 + 2) + 3 * 2 * TC_PARTS) * pairs * hd)[0]
    ffma_design = bound(nbytes, ffma=7 * pairs * hd, sfu=pairs)[0]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qx = q.transpose(1, 2).detach().requires_grad_()
    kx, vx = (t_.repeat_interleave(H // KV, dim=2).transpose(1, 2).detach()
              .requires_grad_() for t_ in (k, v))
    if window:
        i = torch.arange(S, device=q.device)
        mask_kw = {"attn_mask": (i[None, :] <= i[:, None])
                   & (i[:, None] - i[None, :] < window)}
    else:
        mask_kw = {"is_causal": True}
    lib_backend = _sdpa_backend(qx, kx, vx, **mask_kw)
    out = sdpa(qx, kx, vx, **mask_kw)
    dox = do.transpose(1, 2)
    lib_ms = kernel_ms(lambda: torch.autograd.grad(out, (qx, kx, vx), dox,
                                                   retain_graph=True), 5)[1].ms
    del out, qx, kx, vx, mask_kw
    share = b_ms / ms
    check(share <= 1.05, f"flash backward at {arch}'s shape runs at {share:.3f} of "
          "its bound")
    print(f"flash_attention_bwd at {arch}'s shape (B={B}, S={S}, H={H}, KV={KV}, "
          f"hd={hd}, bf16, causal, window {window}; {CARD[0]}): tensor-core route "
          f"{ms:.4f} ms per launch (median of its windows; in turns "
          f"{', '.join(f'{t_.ms:.4f}' for t_ in turns)}: tc, ffma, ffma, tc), bound "
          f"{b_ms:.4f} ms ({b_by}: {b_pipe}), share {share:.4f}; the tensor-core "
          f"design's bound {tc_design:.4f} ms (share {tc_design / ms:.4f}); FFMA "
          f"kernel {ffma_ms:.4f} ms (its design's bound {ffma_design:.4f} ms); "
          f"plain {tp.ms:.4f} ms; library (scaled_dot_product_attention's "
          f"backward, KV expanded, P rounded once, backend {lib_backend}) "
          f"{lib_ms:.4f} ms; vs plain err {err:.3g}", flush=True)
    return {"ms": ms, "windows": tc_windows, "turns_ms": [t_.ms for t_ in turns],
            "plain_ms": tp.ms, "bound_ms": b_ms, "bound_by": b_by, "pipe": b_pipe,
            "share_of_bound": share, "tc_design_bound_ms": tc_design,
            "ffma_design_bound_ms": ffma_design, "library_ms": lib_ms,
            "library_backend": lib_backend, "flip_rates": flips, "ffma_kernel": {
                "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                "ms": ffma_ms, "windows": ffma_windows},
            "shape": [B, S, H, KV, hd], "window": window, "pairs": pairs}


def _named_leaves(tree, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _named_leaves(val, f"{prefix}/{key}")
        else:
            yield f"{prefix}/{key}", val


def _flash_per_step(cfg) -> tuple[int, int]:
    """(forward, backward) flash launches of one training step under remat
    "nothing": an attention layer inside a checkpointed group of the block
    pattern runs its forward twice (the forward, then the recompute), one in
    the unstacked tail once; each runs its backward once."""
    attn = ("attn", "attn_moe", "local")
    grouped = cfg.num_groups * sum(b in attn for b in cfg.block_pattern)
    tail = sum(b in attn for b in cfg.remainder_blocks)
    return 2 * grouped + tail, grouped + tail


def _step0_routes(cfg, params, batch, B: int, S: int) -> dict:
    """(b) step 0's loss and gradients through the kernel route, then the
    plain route (``attention_ref`` under autograd, one layer live at a time
    under remat), on the same parameters and batch: every leaf (the RG-LRU's
    gates and conv bias included) gets a nonzero gradient on both."""
    from repro_torch.kernels import flash_attention_bwd_kernel, flash_attention_kernel
    from repro_torch.train import TrainConfig
    from repro_torch.train.trainer import _global_norm, _grads

    tc = TrainConfig(remat="nothing")
    names, leaves = zip(*_named_leaves(params))
    flash_attention_kernel.launches = flash_attention_bwd_kernel.launches = 0
    flash_attention_bwd_kernel.launches_tc = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    g_k, m_k = _grads(cfg, tc, params, list(leaves), batch)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t
    fwd, bwd = flash_attention_kernel.launches, flash_attention_bwd_kernel.launches
    bwd_tc = flash_attention_bwd_kernel.launches_tc
    want_f, want_b = _flash_per_step(cfg)
    check(fwd == want_f and bwd == bwd_tc == want_b,
          f"{cfg.name} step 0 kernel route: {fwd} forward and {bwd} backward flash "
          f"launches ({bwd_tc} on the tensor-core route), want {want_f} and {want_b}")
    t = time.perf_counter()
    with plain_attention():
        g_p, m_p = _grads(cfg, tc, params, list(leaves), batch)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t
    loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
    rel_loss = abs(loss_k / loss_p - 1)
    gn_k = float(_global_norm(dict(enumerate(g_k))))
    gn_p = float(_global_norm(dict(enumerate(g_p))))
    rels = {}
    for name, a, b in zip(names, g_k, g_p):
        nb = float(b.norm())
        check(nb > 0 and float(a.norm()) > 0,
              f"{cfg.name} step 0: {name} got no gradient")
        rels[name] = float((a - b).norm()) / nb
    del g_k, g_p
    worst = max(rels, key=rels.get)
    attn_leaves = [n for n in names if "/attn/" in n]
    print(f"{cfg.name} step 0 ({B} x {S} tokens, SS-selected, remat "
          f"nothing; {CARD[0]}): loss kernel route {loss_k:.6f}, plain route "
          f"{loss_p:.6f} (rel {rel_loss:.3g}); global grad norm {gn_k:.6f} vs "
          f"{gn_p:.6f}; worst leaf {worst} at {rels[worst]:.4g} relative; "
          f"attention leaves ({len(attn_leaves)}) at most "
          f"{max(rels[n] for n in attn_leaves):.4g}; wall {wall_k:.3f} s (kernel) "
          f"vs {wall_p:.3f} s (plain)", flush=True)
    check(rel_loss <= TRAIN_LOSS_REL,
          f"{cfg.name} step 0: loss differs by {rel_loss:.3g}")
    check(rels[worst] <= TRAIN_GRAD_REL,
          f"{cfg.name} step 0: {worst} differs by {rels[worst]:.3g}")
    return {"loss_kernel": loss_k, "loss_plain": loss_p, "loss_rel": rel_loss,
            "grad_norm_kernel": gn_k, "grad_norm_plain": gn_p, "worst_leaf": worst,
            "worst_rel": rels[worst], "leaf_rel": rels, "wall_kernel_s": wall_k,
            "wall_plain_s": wall_p, "flash_launches": [fwd, bwd]}


@contextlib.contextmanager
def _instrumented_training(steps: list, profile_at: int):
    """``launch/train.py`` with its train step and pipeline wrapped: each
    step synchronised and timed, its peak memory and the kernels' launches
    during it and during the batch before it, and one step profiled."""
    import repro_torch.launch.train as train_mod
    from repro_torch.kernels import (feature_gains_kernel, flash_attention_bwd_kernel,
                                     flash_attention_kernel, ss_divergence_kernel)

    kernels = {"flash_attention": flash_attention_kernel,
               "flash_attention_bwd": flash_attention_bwd_kernel,
               "ss_divergence": ss_divergence_kernel,
               "feature_gains": feature_gains_kernel}
    make, Pipe = train_mod.make_train_step, train_mod.Pipeline

    def counts():
        return {**{k: f.launches for k, f in kernels.items()},
                "flash_attention_bwd_tc": flash_attention_bwd_kernel.launches_tc}

    class TimedPipeline(Pipe):
        def __call__(self):
            c0 = counts()
            t = time.perf_counter()
            batch = super().__call__()
            torch.cuda.synchronize()
            steps.append({"pipeline_ms": (time.perf_counter() - t) * 1e3,
                          **{f"pipeline_{k}": v for k, v in self.last_timing.items()},
                          "pipeline_launches": {k: v - c0[k] for k, v in counts().items()}})
            return batch

    def make_timed(cfg, tc):
        step = make(cfg, tc)

        def timed(state, batch):
            rec = steps[-1]
            if len(steps) - 1 == profile_at:
                holder = []
                rec["profile"] = profile_run(f"{cfg.name} train step",
                                             lambda: holder.append(step(state, batch)),
                                             watch=("dkdv_tc", "dq_tc", "rows_kernel"))
                return holder[0]
            c0 = counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            rec["step_ms"] = (time.perf_counter() - t) * 1e3
            rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            rec["step_launches"] = {k: v - c0[k] for k, v in counts().items()}
            rec.update({k: float(v) for k, v in out[1].items()})
            return out

        return timed

    train_mod.make_train_step, train_mod.Pipeline = make_timed, TimedPipeline
    try:
        yield kernels
    finally:
        train_mod.make_train_step, train_mod.Pipeline = make, Pipe


def _train_main(cfg, tmp: str, B: int, S: int, pool: int) -> dict:
    """(c) ``launch/train.py`` on the card: a model at full width and
    depth, ``TRAIN_STEPS`` steps of B x S SS-selected tokens (pool factor
    ``pool``), AdamW (the launcher's rule), remat "nothing", no checkpoint;
    the kernels' counts set to 0 just before and read just after."""
    from repro_torch.launch import train as train_mod

    steps: list = []
    profile_at = TRAIN_STEPS - 2
    argv = ["--arch", cfg.name, "--steps", str(TRAIN_STEPS), "--batch",
            str(B), "--seq", str(S), "--selection", "ss",
            "--pool-factor", str(pool),
            "--ckpt-every", "0", "--remat", "nothing", "--ckpt-dir", tmp,
            "--device", "cuda"]
    with _instrumented_training(steps, profile_at) as kernels:
        for kern in kernels.values():
            kern.launches = 0
        kernels["flash_attention_bwd"].launches_tc = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        rc = train_mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {**{k: f.launches for k, f in kernels.items()},
                    "flash_attention_bwd_tc": kernels["flash_attention_bwd"].launches_tc}
    check(rc == 0 and len(steps) == TRAIN_STEPS,
          f"{cfg.name} train: rc {rc}, {len(steps)} steps")
    want_f, want_b = _flash_per_step(cfg)
    for i, rec in enumerate(steps):
        pl = rec["pipeline_launches"]
        check(pl["ss_divergence"] >= 1 and pl["feature_gains"] >= 1,
              f"{cfg.name} train step {i}: the batch launched no SS kernels ({pl})")
        if i == profile_at:
            continue
        sl = rec["step_launches"]
        check(sl["flash_attention"] == want_f
              and sl["flash_attention_bwd"] == sl["flash_attention_bwd_tc"] == want_b,
              f"{cfg.name} train step {i}: flash launches {sl}, want {want_f} "
              f"forward and {want_b} backward, all on the tensor-core route")
        check(math.isfinite(rec["loss"]),
              f"{cfg.name} train step {i}: loss {rec['loss']}")
        toks = B * S / (rec["step_ms"] / 1e3)
        rec["tokens_per_s"] = toks
        print(f"{cfg.name} train step {i}: loss {rec['loss']:.4f} grad norm "
              f"{rec['grad_norm']:.4f} lr {rec['lr']:.3e}; step {rec['step_ms']:.2f} "
              f"ms ({toks:.1f} tokens/s), pipeline {rec['pipeline_ms']:.2f} ms (pool "
              f"{rec['pipeline_pool_ms']:.2f}, features {rec['pipeline_features_ms']:.2f}"
              f" on the host, selection {rec['pipeline_select_ms']:.2f} on the "
              f"card), peak {rec['peak_gib']:.2f} GiB; launches: step {sl}, batch "
              f"{pl}", flush=True)
    timed = [r for i, r in enumerate(steps) if i != profile_at]
    check(timed[-1]["loss"] < timed[0]["loss"],
          f"{cfg.name} train: the loss did not fall ({timed[0]['loss']} -> "
          f"{timed[-1]['loss']})")
    steady = [r["step_ms"] for r in timed[1:]]
    med = statistics.median(steady)
    prof = steps[profile_at].get("profile", {})
    bwd_ms = sum(prof.get("watched_ms", {}).get(k_, 0.0)
                 for k_ in ("dkdv_tc", "dq_tc", "rows_kernel"))
    share = (f"{bwd_ms / prof['busy_ms']:.4f} of the profiled step's device time"
             if prof else "not measured")
    print(f"{cfg.name} training through launch/train.py ({B} x {S} tokens a step; "
          f"{CARD[0]}): {TRAIN_STEPS} steps in {wall:.2f} s (model and optimizer "
          f"set-up included); step median {med:.2f} ms after the first "
          f"({B * S / (med / 1e3):.1f} tokens/s), peak "
          f"{max(r['peak_gib'] for r in timed):.2f} GiB; flash backward "
          f"{bwd_ms:.4f} ms a step, {share}; launches in the run {launches}",
          flush=True)
    return {"steps": steps, "wall_s": wall, "launches": launches,
            "batch": [B, S], "step_ms_median": med, "tokens_per_s": B * S / (med / 1e3),
            "peak_gib": max(r["peak_gib"] for r in timed),
            "flash_bwd_ms_profiled": bwd_ms}


def _ckpt_resume(tmp: str) -> dict:
    """(d) Checkpoint and resume on the card at llama3.2-3b's smoke config
    (head_dim raised from 8 to 32, the flash kernels' narrowest): 4 steps
    uninterrupted, then from the same start a run that checkpoints every 2
    steps, preempted by SIGTERM during step 1 (saved at step 2), restored
    (bitwise the saved state, on the card) and finished at step 4."""
    import dataclasses
    import os
    import signal

    from repro_torch import configs
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.train import (Checkpointer, TrainConfig, abstract_train_state,
                                   make_train_state, make_train_step,
                                   resume_or_init, run)

    cfg = dataclasses.replace(configs.smoke(TRAIN_ARCH), head_dim=32)
    tc = TrainConfig(warmup_steps=2, total_steps=4)
    dc = DataConfig(batch_size=4, seq_len=128, vocab_size=cfg.vocab_size)
    init = lambda: make_train_state(torch.Generator(device="cuda").manual_seed(0),
                                    cfg, tc, device="cuda")
    logs = {"full": [], "cut": [], "resumed": []}
    step = make_train_step(cfg, tc)
    _, rep = run(init(), step, Pipeline(dc, device="cuda"),
                 Checkpointer(os.path.join(tmp, "full")),
                 num_steps=4, ckpt_every=0, log_fn=logs["full"].append, log_every=1)
    pipe = Pipeline(dc, device="cuda")
    calls = [0]

    def preempting():
        calls[0] += 1
        if calls[0] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return pipe()

    ck = Checkpointer(os.path.join(tmp, "cut"))
    state, rep_cut = run(init(), step, preempting, ck, num_steps=4, ckpt_every=2,
                         log_fn=logs["cut"].append, log_every=1)
    check(rep_cut.preempted and rep_cut.final_step == 2 and ck.latest_step() == 2,
          f"ckpt: preemption at step 2 not taken ({rep_cut})")
    saved = {n: t.detach().clone() for n, t in _named_leaves(state)}
    restored, start, resumed = resume_or_init(ck, abstract_train_state(cfg, tc), init,
                                              device="cuda")
    check(resumed and start == 2, "ckpt: no resume from step 2")
    got = dict(_named_leaves(restored))
    check(got.keys() == saved.keys() and all(
        got[n].device.type == "cuda" and got[n].dtype == saved[n].dtype
        and torch.equal(got[n], saved[n]) for n in saved),
        "ckpt: the restored state is not the saved one, bitwise, on the card")
    pipe._step = 2
    _, rep_res = run(restored, step, pipe, ck, num_steps=4, start_step=2,
                     ckpt_every=2, log_fn=logs["resumed"].append, log_every=1)
    check(rep_res.final_step == 4 and ck.latest_step() == 4,
          f"ckpt: the resumed run did not finish at step 4 ({rep_res})")
    full = [h["loss"] for h in rep.metrics_history]
    resumed_l = ([h["loss"] for h in rep_cut.metrics_history]
                 + [h["loss"] for h in rep_res.metrics_history])
    same = full == resumed_l
    print(f"checkpoint on the card ({cfg.name}, head_dim 32): preempted at step 2, "
          f"{len(saved)} leaves restored bitwise on the card, finished at step 4; "
          f"losses uninterrupted {full} vs preempted + resumed {resumed_l}: "
          f"{'equal' if same else 'not equal (the embedding backward sums with atomics)'}",
          flush=True)
    return {"leaves": len(saved), "losses_full": full, "losses_resumed": resumed_l,
            "losses_equal": same}


def _pipeline_at_scale() -> dict:
    """(e) The pipeline at a real global batch: 256 x 2048 tokens from 1024
    candidates (vocab 128256), selection "ss" and "ss_fl", 2 batches each;
    the kernel route's picks against the plain route's (ReferenceBackend,
    the same generator state), any difference shown a near tie in float64
    (``_explain_ss``, ``_explain_greedy``)."""
    import dataclasses

    from repro_torch.convert import feature_coverage_from_numpy
    from repro_torch.core import StreamingFacilityLocation
    from repro_torch.data import DataConfig, Pipeline, hashed_features
    from repro_torch.data.pipeline import select_documents
    from repro_torch.kernels import feature_gains_kernel, ss_divergence_kernel
    from repro_torch.kernels import fl_stream_divergence_kernel, fl_stream_gains_kernel

    base = DataConfig(batch_size=POOL_B, seq_len=POOL_S, pool_factor=4,
                      vocab_size=128256)
    out = {}
    for sel in ("ss", "ss_fl"):
        kerns = ((ss_divergence_kernel, feature_gains_kernel) if sel == "ss" else
                 (fl_stream_divergence_kernel, fl_stream_gains_kernel))
        pipe = Pipeline(dataclasses.replace(base, selection=sel), seed=0,
                        device="cuda")
        rows = []
        for b in range(2):
            t = time.perf_counter()
            docs = pipe._pool()
            t_pool = time.perf_counter() - t
            W = hashed_features(docs[:, :-1], base.feature_dim, base.ngram)
            t_host = time.perf_counter() - t
            state = pipe._gen.get_state()
            n0 = [k.launches for k in kerns]
            t = time.perf_counter()
            got = select_documents(W, POOL_B, sel, {"generator": pipe._gen},
                                   device="cuda")
            t_dev = time.perf_counter() - t
            launches = [k.launches - n for k, n in zip(kerns, n0)]
            check(min(launches) >= 1, f"pipeline {sel}: kernels not launched {launches}")
            g2 = torch.Generator(device="cuda")
            g2.set_state(state)
            t = time.perf_counter()
            want = select_documents(W, POOL_B, sel, {"generator": g2},
                                    device="cuda", backend="reference")
            t_plain = time.perf_counter() - t
            same = bool((got == want).all())
            note = "equal"
            if not same:
                fn = (feature_coverage_from_numpy(W, device="cuda") if sel == "ss"
                      else StreamingFacilityLocation.from_features(
                          torch.from_numpy(W).to("cuda")))
                g3 = torch.Generator(device="cuda")
                g3.set_state(state)
                label = f"pipeline {sel} batch {b}"
                note, vprime = _explain_ss(label, fn, g3)
                if note is None:
                    note = _explain_greedy(label, fn, vprime, POOL_B)
            pipe._step += 1
            rows.append({"host_ms": t_host * 1e3, "pool_ms": t_pool * 1e3,
                         "select_ms": t_dev * 1e3, "plain_select_ms": t_plain * 1e3,
                         "launches": launches, "same_picks": same,
                         "differing_picks": int((got != want).sum()), "note": note})
            print(f"pipeline {sel} at {POOL_B} x {POOL_S} ({len(docs)} candidates, "
                  f"F {base.feature_dim}; {CARD[0]}) batch {b}: host {t_host * 1e3:.2f} "
                  f"ms (pool {t_pool * 1e3:.2f}, features {(t_host - t_pool) * 1e3:.2f}), "
                  f"selection on the card {t_dev * 1e3:.2f} ms (launches {launches}), "
                  f"plain route {t_plain * 1e3:.2f} ms; picks vs plain: {note}",
                  flush=True)
        out[sel] = rows
    return out


def train_phase(errs: dict) -> tuple[dict, dict]:
    """Training on the card, on a freed card: (a) the backward kernel vs its
    plain version (``bwd_sweep``), ptxas' report of its tensor-core
    instances (``bwd_ptxas``) and the kernel at each trained model's
    attention shape (``bwd_at_shape``); for each model of ``TRAIN_RUNS``
    (llama3.2-3b, recurrentgemma-2b) at full width and depth, (b) step 0 on
    the kernel and the plain attention routes, then (c) ``TRAIN_STEPS``
    steps through ``launch/train.py`` (the main path: the counts from 0);
    (d) checkpoint and resume; (e) the pipeline at a 256 x 2048 global
    batch.  Returns (the ninth record, the phase's figures)."""
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.data import DataConfig, Pipeline

    errs["flash_attention_bwd"] = 0.0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bwd_sweep(errs)
    ptxas = bwd_ptxas()
    shapes = {spec[0]: bwd_at_shape(errs, *spec) for spec in BWD_SHAPES}
    torch.cuda.empty_cache()
    out = {"card": CARD[0], "bwd": shapes, "ptxas": ptxas, "step0": {}, "train": {}}

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        for arch, B, S, pool in TRAIN_RUNS:
            t = time.perf_counter()
            cfg = configs.get(arch)
            params, _ = _params_on_card(cfg)
            pipe = Pipeline(DataConfig(batch_size=B, seq_len=S, selection="ss",
                                       pool_factor=pool, feature_dim=512,
                                       vocab_size=cfg.vocab_size), seed=0,
                            device="cuda")
            out["step0"][arch] = _step0_routes(cfg, params, pipe(), B, S)
            del params, pipe
            torch.cuda.empty_cache()
            out["train"][arch] = _train_main(cfg, tmp, B, S, pool)
            torch.cuda.empty_cache()
            print(f"{arch} training: {time.perf_counter() - t:.2f} s", flush=True)
        out["ckpt"] = _ckpt_resume(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["pipeline"] = _pipeline_at_scale()
    out["phase_s"] = time.perf_counter() - t0
    print(f"train phase: {out['phase_s']:.2f} s", flush=True)
    runs = {arch: out["train"][arch]["launches"] for arch, *_ in TRAIN_RUNS}
    shape, rg = shapes[TRAIN_ARCH], shapes["recurrentgemma-2b"]
    record = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
        "replaces": "src/repro/models/attention.py:129 (the autodiff of "
                    "blockwise_attention; no TPU kernel)",
        "launches": sum(r["flash_attention_bwd"] for r in runs.values()),
        "launches_tc": sum(r["flash_attention_bwd_tc"] for r in runs.values()),
        "launches_by_run": {a: [r["flash_attention_bwd"], r["flash_attention_bwd_tc"]]
                            for a, r in runs.items()},
        "max_abs_err": errs["flash_attention_bwd"], "ms": shape["ms"],
        "plain_ms": shape["plain_ms"], "bound_ms": shape["bound_ms"],
        "bound_by": shape["bound_by"], "library_ms": shape["library_ms"],
        "library_backend": shape["library_backend"],
        "tc_design_bound_ms": shape["tc_design_bound_ms"],
        "ffma_design_bound_ms": shape["ffma_design_bound_ms"],
        "share_of_bound": shape["share_of_bound"], "flip_rates": shape["flip_rates"],
        "ffma_kernel": shape["ffma_kernel"], "ptxas": ptxas,
        "shape": shape["shape"], "bf16_worst_share_of_tolerance": BWD_WORST[0],
        "at_recurrentgemma": {k_: rg[k_] for k_ in (
            "ms", "turns_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_backend", "tc_design_bound_ms", "ffma_design_bound_ms",
            "share_of_bound", "flip_rates", "ffma_kernel", "shape", "window")},
    }
    return record, out


# -- LM training sharded over a DeviceMesh ------------------------------------

LM_SH_RANKS, LM_SH_STEPS, LM_SH_LAYERS = 4, 3, 2
# olmoe and the compressed step take LM_SH_SHORT steps from step
# LM_SH_FROM, past their warmup of 1, so the one step updates at the full
# rate: each held by its loss, gradient norm and each parameter's change
# (||p - p_init||, ``_hold_change``) against a plain run, the compressed
# step on its kernel and its plain attention route, its error feedback
# state too: the phase's time is the host's collectives
LM_SH_SHORT, LM_SH_FROM = 1, 1
# part (b)'s runs at full width, depth cut to LM_SH_LAYERS: (arch, B, S,
# optimizer, microbatches)
LM_SH_RUNS = {"llama3.2-3b": ("llama3.2-3b", 4, 1024, "adamw", 1),
              "olmoe-1b-7b": ("olmoe-1b-7b", 4, 512, "adafactor", 2)}
LM_SH_COMPRESS = {"ratio": 0.05, "block": 1024}
# part (b) keeps every activation: two layers need no rematerialisation,
# and a recomputed forward gathers each weight over data a second time
LM_SH_REMAT = "none"


# sharded serving (the dry run's prefill and decode cells on the card): (a)
# qwen3-4b at full size at one rank over NCCL, the LM path's run; (b) in
# part (b)'s four ranks, qwen3-4b at full width cut to LM_SH_LAYERS, a
# prefill of LM_SSH_B x LM_SSH_S and LM_SSH_DECODE decode steps on (2, 2)
LM_SSH_B, LM_SSH_S, LM_SSH_DECODE = 4, 1024, 4
SHARDED_SERVE: dict = {}     # (a)'s figures, then (b)'s and (c)'s
COUNTER: list = []           # the counter's output file and process (``start_counter``)
DRYRUN: dict = {}            # (d): the production cells the counter counted


def _collective_table(records) -> dict:
    """{op: [count, operand bytes]} of ``launch.cost.Collective`` records."""
    from repro_torch.launch.cost import collective_bytes

    st = collective_bytes(records)
    return {op: [n, st.bytes_by_op[op]] for op, n in sorted(st.count_by_op.items())}


def lm_serve_one_rank(cfg, params, run: dict) -> dict:
    """(a) of sharded serving: the LM path's parameters and prompts at one
    rank over NCCL on a (1, 1) mesh, placed by ``param_spec_tree`` and
    ``data_spec``, the cache made by prefill as ``cache_spec_tree`` splits
    it.  The prefill's logits and the decoded tokens against ``run``'s
    (``_serve``'s plain run) bit for bit; flash launches a prefill (all
    tensor-core); TTFT and decode ms beside the plain run's, warm as it is
    (a first prefill and decode step, under the dry run's mode, record the
    collectives: none on a size-1 mesh); the peak.  Flash counts from 0
    just before the timed run, read just after."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels import flash_attention_kernel
    from repro_torch.launch.cost import CostMode
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.sharding import (data_spec, distribute, named,
                                             param_spec_tree, use_mesh)
    from repro_torch.serve.engine import _sample

    B, S, NEW = LM_B, LM_S, LM_NEW
    sc, prompts = run["sc"], run["prompts"]
    t0 = time.perf_counter()
    with _one_rank_group():
        mesh = single_device_mesh("cuda")
        dp = distribute(params, named(mesh, param_spec_tree(cfg, params, mesh)))

        def place(t):
            return distribute(t, named(mesh, data_spec(mesh, tuple(t.shape))))

        def whole(t):
            return t.full_tensor() if isinstance(t, DTensor) else t

        mode = CostMode()
        with mode, torch.no_grad(), use_mesh(mesh):
            _, cache = prefill(cfg, dp, place(prompts), max_len=sc.max_len)
            decode_step(cfg, dp, place(run["toks"][0]), cache, S, S)
        del cache
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        flash_attention_kernel.launches = flash_attention_kernel.launches_tc = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad(), use_mesh(mesh):
            logits, cache = prefill(cfg, dp, place(prompts), max_len=sc.max_len)
            first = whole(logits)
            tok = _sample(first, None, sc)
        torch.cuda.synchronize()
        ttft_ms = (time.perf_counter() - t) * 1e3
        launches = (flash_attention_kernel.launches, flash_attention_kernel.launches_tc)
        toks = [tok]
        t = time.perf_counter()
        with torch.no_grad(), use_mesh(mesh):
            for n in range(S, S + NEW - 1):
                logits, cache = decode_step(cfg, dp, place(tok), cache, n, n)
                tok = _sample(whole(logits), None, sc)
                toks.append(tok)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t) * 1e3 / (NEW - 1)
        decode_launches = flash_attention_kernel.launches - launches[0]
        peak = torch.cuda.max_memory_allocated() / 2**30
        bits_logits = torch.equal(first, run["step_logits"][0])
        bits_tokens = torch.equal(torch.cat(toks, 1), torch.cat(run["toks"], 1))
        del cache, logits, dp
        torch.cuda.empty_cache()
    colls = _collective_table(mode.collectives)
    n_attn = run["n_attn"]
    check(launches == (n_attn, n_attn) and decode_launches == 0,
          f"(a) sharded serve: flash launches {launches} a prefill, {decode_launches} "
          f"in decode; want {n_attn} on the tensor-core route, none in decode")
    check(bits_logits, "(a) sharded serve at (1, 1): the prefill's logits differ from "
          "the plain run's")
    check(bits_tokens, "(a) sharded serve at (1, 1): the decoded tokens differ from the "
          "plain run's")
    check(not colls, f"(a) sharded serve at (1, 1): collectives {colls}")
    out = {"arch": cfg.name, "batch": [B, S], "new": NEW, "ttft_ms": ttft_ms,
           "plain_ttft_ms": run["ttft_ms"], "decode_ms_per_step": decode_ms,
           "plain_decode_ms_per_step": run["decode_ms_per_step"], "peak_gib": peak,
           "plain_peak_gib": run["peak_gib"], "launches": launches[0],
           "launches_tc": launches[1], "collectives": colls,
           "bit_for_bit": bits_logits and bits_tokens,
           "wall_s": time.perf_counter() - t0}
    print(f"(a) {cfg.name} served sharded at one rank over NCCL, (1, 1) mesh ({B} x "
          f"{S} prompts, {NEW} new tokens; {CARD[0]}): prefill logits and tokens bit "
          f"for bit with the plain run; TTFT {ttft_ms:.4f} ms (plain "
          f"{run['ttft_ms']:.4f}), decode {decode_ms:.4f} ms a step (plain "
          f"{run['decode_ms_per_step']:.4f}), both warm; peak {peak:.2f} GiB (plain "
          f"{run['peak_gib']:.2f}, the plain parameters still held); flash launches "
          f"a prefill {launches[0]} "
          f"({launches[1]} tensor-core), decode {decode_launches}; collectives "
          f"{colls or 'none'}; {out['wall_s']:.2f} s", flush=True)
    return out


def _serve_rank(mesh) -> dict:
    """(b) and (c) on one of the four ranks: qwen3-4b at full width cut to
    LM_SH_LAYERS layers, parameters from a seeded generator (the same on
    every rank) placed by ``param_spec_tree``, a LM_SSH_B x LM_SSH_S prefill
    and LM_SSH_DECODE greedy decode steps on (2, 2); the flash launches of
    the prefill; the collectives of the prefill and of the first decode
    step, recorded by the dry run's mode.  Rank 0's logits (whole) and
    tokens stay in the record for the unsharded run."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.cost import CostMode
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.sharding import (data_spec, distribute, named,
                                             param_spec_tree, use_mesh)

    cfg = _lm_config(LM_ARCH, LM_SH_LAYERS)
    B, S, D = LM_SSH_B, LM_SSH_S, LM_SSH_DECODE
    params = init_params(torch.Generator("cuda").manual_seed(0), cfg, device="cuda")
    # int32 token ids, as the dry run's cells take them (their gather moves
    # the ids' bytes)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", dtype=torch.int32,
                            generator=torch.Generator("cuda").manual_seed(11))
    dp = distribute(params, named(mesh, param_spec_tree(cfg, params, mesh)))
    del params

    def place(t):
        return distribute(t, named(mesh, data_spec(mesh, tuple(t.shape))))

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    _lm_counts_zero()
    modes = [CostMode(), CostMode()]
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.no_grad(), use_mesh(mesh), modes[0]:
        logits, cache = prefill(cfg, dp, place(prompts), max_len=S + D)
    first = whole(logits)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    launches = _lm_counts()
    logits_all, toks = [first], [torch.argmax(first, dim=-1).to(torch.int32)]
    t = time.perf_counter()
    for i in range(D):
        with (torch.no_grad(), use_mesh(mesh),
              modes[1] if i == 0 else contextlib.nullcontext()):
            logits, cache = decode_step(cfg, dp, place(toks[-1]), cache, S + i, S + i)
        logits_all.append(whole(logits))
        toks.append(torch.argmax(logits_all[-1], dim=-1).to(torch.int32))
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / D
    del cache, dp
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "launches": launches, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "collectives": {"prefill": _collective_table(modes[0].collectives),
                            "decode": _collective_table(modes[1].collectives)},
            "_logits": logits_all, "_prompts": prompts, "_tokens": toks}


def _serve_unsharded(srv: dict) -> list:
    """Rank 0's one-process unsharded run of ``_serve_rank``'s model from
    the same parameters, prompts and tokens: each step's logits relative
    error against the sharded run's, within the LM path's check
    (``_logits_close``, 3e-2 of max|logits|)."""
    from repro_torch.models import decode_step, init_params, prefill

    cfg = _lm_config(LM_ARCH, LM_SH_LAYERS)
    S, D = LM_SSH_S, LM_SSH_DECODE
    params = init_params(torch.Generator("cuda").manual_seed(0), cfg, device="cuda")
    got, toks = srv["_logits"], srv["_tokens"]
    with torch.no_grad():
        logits, cache = prefill(cfg, params, srv["_prompts"], max_len=S + D)
        errs = [_logits_close(got[0], logits, "(b) sharded prefill vs unsharded")]
        for i in range(D):
            logits, cache = decode_step(cfg, params, toks[i], cache, S + i, S + i)
            errs.append(_logits_close(got[i + 1], logits,
                                      f"(b) sharded decode step {i} vs unsharded"))
    del params, cache
    torch.cuda.empty_cache()
    return errs


def _lm_counts() -> dict:
    from repro_torch.kernels import (feature_gains_kernel, flash_attention_bwd_kernel,
                                     flash_attention_kernel, ss_divergence_kernel)

    return {"flash_attention": flash_attention_kernel.launches,
            "flash_attention_tc": flash_attention_kernel.launches_tc,
            "flash_attention_bwd": flash_attention_bwd_kernel.launches,
            "flash_attention_bwd_tc": flash_attention_bwd_kernel.launches_tc,
            "ss_divergence": ss_divergence_kernel.launches,
            "feature_gains": feature_gains_kernel.launches}


def _lm_counts_zero() -> None:
    from repro_torch.kernels import (feature_gains_kernel, flash_attention_bwd_kernel,
                                     flash_attention_kernel, ss_divergence_kernel)

    for kern in (flash_attention_kernel, flash_attention_bwd_kernel):
        kern.launches = kern.launches_tc = 0
    ss_divergence_kernel.launches = feature_gains_kernel.launches = 0


def _diff(a: dict, b: dict) -> dict:
    return {k: a[k] - b[k] for k in a}


def _timed_sharded(step, steps: list, comm_at: int | None):
    """A sharded step wrapped: each call synchronised and timed, its peak,
    its kernel launches and staged collectives; call ``comm_at`` under
    DTensor's ``CommDebugMode`` (the collectives it issues, by op: not
    timed) and the dry run's ``CostMode`` (each collective's operand bytes,
    recorded before gloo's all-gathers are staged)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.core import distributed as dd
    from repro_torch.launch.cost import CostMode

    def timed(state, batch):
        rec = {}
        c0, s0, b0, t0 = (_lm_counts(), dict(dd.STAGED), dd.STAGED_BYTES[0],
                          dd.STAGED_SECONDS[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        if len(steps) == comm_at:
            cost = CostMode()
            with CommDebugMode() as comm, cost:
                out = step(state, batch)
            rec["collectives"] = {str(k).split(".")[-1]: v
                                  for k, v in comm.get_comm_counts().items()}
            rec["collective_bytes"] = _collective_table(cost.collectives)
        else:
            out = step(state, batch)
        torch.cuda.synchronize()
        rec["step_ms"] = (time.perf_counter() - t) * 1e3
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rec["launches"] = _diff(_lm_counts(), c0)
        rec["staged"] = sum(_diff(dict(dd.STAGED), s0).values())
        rec["staged_gib"] = (dd.STAGED_BYTES[0] - b0) / 2**30
        rec["staged_ms"] = (dd.STAGED_SECONDS[0] - t0) * 1e3
        rec.update({k: float(v) for k, v in out[1].items()})
        steps.append(rec)
        return out

    return timed


@contextlib.contextmanager
def _sharded_launcher(steps: list, batches: list | None = None, comm_at: int = 1,
                      layers: int = 0):
    """``launch/train.py`` with its sharded step timed (``_timed_sharded``),
    with ``batches`` each batch its pipeline gives kept, and with ``layers``
    the config's depth cut to that many layers (full width)."""
    import repro_torch.launch.train as train_mod

    make, Pipe, get = train_mod.shard_train_step, train_mod.Pipeline, train_mod.configs.get

    def make_timed(*a, **kw):
        step, sh, bsh = make(*a, **kw)
        return _timed_sharded(step, steps, comm_at), sh, bsh

    class KeptPipeline(Pipe):
        def __call__(self):
            batch = super().__call__()
            if batches is not None:
                batches.append({k: v.clone() for k, v in batch.items()})
            return batch

    train_mod.shard_train_step, train_mod.Pipeline = make_timed, KeptPipeline
    if layers:
        train_mod.configs.get = lambda arch: dataclasses.replace(get(arch),
                                                                 num_layers=layers)
    try:
        yield
    finally:
        train_mod.shard_train_step, train_mod.Pipeline = make, Pipe
        train_mod.configs.get = get


def _sharded_argv(arch: str, B: int, S: int, tmp: str, mesh: str,
                  pool: int = 16, remat: str = "nothing") -> list:
    return (["--arch", arch, "--steps", str(LM_SH_STEPS), "--batch", str(B),
             "--seq", str(S), "--selection", "ss", "--pool-factor", str(pool),
             "--ckpt-every", "0", "--remat", remat, "--ckpt-dir", tmp,
             "--device", "cuda", "--mesh", mesh])


def lm_sharded_one_rank(plain: dict) -> dict:
    """(a) ``launch/train.py --mesh 1x1`` on a one-rank NCCL group: the
    sharded step over DTensors at llama3.2-3b's full size and depth, with
    (c)'s seed and arguments, so both runs start from the same state and see
    the same batches; its losses held to (c)'s first three (``plain``: (c)'s
    record), bit for bit or within TRAIN_LOSS_REL.  The counts from 0 just
    before, read just after."""
    import tempfile

    from repro_torch.launch import train as train_mod

    arch, B, S, pool = TRAIN_RUNS[0]
    steps: list = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, _one_rank_group(), \
            _sharded_launcher(steps):
        torch.distributed.all_reduce(torch.zeros(1, device="cuda"))
        _lm_counts_zero()
        rc = train_mod.main(_sharded_argv(arch, B, S, tmp, "1x1", pool=pool))
        torch.cuda.synchronize()
        launches = _lm_counts()
    wall = time.perf_counter() - t0
    check(rc == 0 and len(steps) == LM_SH_STEPS, f"(a) {arch}: rc {rc}, {len(steps)} steps")
    want = [r["loss"] for r in plain["steps"][:LM_SH_STEPS]]
    got = [r["loss"] for r in steps]
    bits = got == want
    rels = [abs(g / w - 1) for g, w in zip(got, want)]
    check(bits or max(rels) <= TRAIN_LOSS_REL,
          f"(a) {arch}: sharded losses {got} against the plain step's {want}")
    want_f, want_b = _flash_per_step(_lm_config(arch))
    for i, r in enumerate(steps):
        lf = r["launches"]
        check(lf["flash_attention"] == lf["flash_attention_tc"] == want_f
              and lf["flash_attention_bwd"] == lf["flash_attention_bwd_tc"] == want_b,
              f"(a) {arch} step {i}: flash launches {lf}, want {want_f} and {want_b} "
              "on the tensor-core route")
        check(r["staged"] == 0, f"(a) {arch} step {i}: NCCL staged {r['staged']}")
    check(launches["ss_divergence"] >= 1 and launches["feature_gains"] >= 1,
          f"(a) {arch}: the pipeline launched no SS kernels ({launches})")
    plain_ms = [r["step_ms"] for r in plain["steps"][:LM_SH_STEPS]]
    print(f"{arch} sharded step at one rank over NCCL, (1, 1) mesh, through "
          f"launch/train.py --mesh 1x1 ({B} x {S} tokens, AdamW; {CARD[0]}): losses "
          f"{got} against the plain step's {want}: "
          f"{'bit for bit' if bits else f'within {max(rels):.3g} relative'}; step ms "
          f"{[round(r['step_ms'], 2) for r in steps]} (plain {[round(x, 2) for x in plain_ms]}"
          f", median after the first {plain['step_ms_median']:.2f}); collectives a step "
          f"{steps[1].get('collectives')}; flash launches a step "
          f"{steps[0]['launches']['flash_attention']} forward, "
          f"{steps[0]['launches']['flash_attention_bwd']} backward; peak "
          f"{max(r['peak_gib'] for r in steps):.2f} GiB (plain {plain['peak_gib']:.2f});"
          f" launches in the run {launches}; {wall:.2f} s", flush=True)
    return {"losses": got, "plain_losses": want, "bit_for_bit": bits,
            "loss_rel": max(rels), "steps": steps, "plain_step_ms": plain_ms,
            "plain_step_ms_median": plain["step_ms_median"],
            "plain_peak_gib": plain["peak_gib"], "launches": launches, "wall_s": wall}


def _lm_config(arch: str, layers: int = 0):
    """``arch``'s published config, its depth cut to ``layers`` if given."""
    from repro_torch import configs

    cfg = configs.get(arch)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def _flash_shard_check(cfg, B_loc: int, S: int, H_loc: int, KV_loc: int) -> dict:
    """The flash kernels, forward and backward, at one rank's shard shape
    against their plain versions on the same inputs."""
    from repro_torch.kernels import (attention_bwd_ref, attention_ref,
                                     flash_attention_bwd_kernel, flash_attention_lse)

    g = torch.Generator(device="cuda").manual_seed(3)
    hd = cfg.head_dim
    q = torch.randn((B_loc, S, H_loc, hd), generator=g, device="cuda").bfloat16()
    k = torch.randn((B_loc, S, KV_loc, hd), generator=g, device="cuda").bfloat16()
    v = torch.randn((B_loc, S, KV_loc, hd), generator=g, device="cuda").bfloat16()
    do = torch.randn((B_loc, S, H_loc, hd), generator=g, device="cuda").bfloat16()
    o, lse = flash_attention_lse(q, k, v, causal=True, window=0)
    fwd = flash_close(o, attention_ref(q, k, v, True, 0), f"{cfg.name} shard forward")
    grads = flash_attention_bwd_kernel(q, k, v, o, do, lse, causal=True, window=0)
    refs = attention_bwd_ref(q, k, v, o, do, lse, True, 0)
    bwd = max(bwd_close(a, b, f"{cfg.name} shard d{n}")
              for a, b, n in zip(grads, refs, "qkv"))
    return {"shape": [B_loc, S, H_loc, KV_loc, hd], "fwd_err": fwd, "bwd_err": bwd}


def _param_norm(params: dict) -> float:
    """The parameters' global norm (a DTensor state's over every shard)."""
    from repro_torch.train.trainer import _global_norm

    n = _global_norm(params)
    return float(n.full_tensor() if hasattr(n, "full_tensor") else n)


def _unsharded(cfg, tc, batches: list, seed: int, start: int = 0) -> dict:
    """The plain step of ``cfg`` from ``make_train_state(seed)`` at step
    ``start`` over ``batches``: each step's metrics and each parameter's
    change."""
    from repro_torch.train import make_train_state, make_train_step

    state = make_train_state(torch.Generator("cuda").manual_seed(seed), cfg, tc,
                             device="cuda")
    state["step"].fill_(start)
    init = _leaves(state["params"])
    step = make_train_step(cfg, tc)
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append({k: float(v) for k, v in m.items()})
    change = _change(state["params"], init)
    del state, init
    torch.cuda.empty_cache()
    return {"steps": out, "change": change}


def _hold(label: str, got: list, want: list) -> float:
    """Three sharded steps against the plain ones: the loss within
    TRAIN_LOSS_REL, the gradient norm within TRAIN_GRAD_REL."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        rl = abs(g["loss"] / w["loss"] - 1)
        rg = abs(g["grad_norm"] / w["grad_norm"] - 1)
        check(rl <= TRAIN_LOSS_REL and rg <= TRAIN_GRAD_REL,
              f"{label} step {i}: loss {g['loss']} vs {w['loss']}, grad norm "
              f"{g['grad_norm']} vs {w['grad_norm']}")
        worst = max(worst, rl)
    return worst


def _untraced(log: str) -> str:
    """A rank's log without its traceback's source lines."""
    return "\n".join(line for line in log.splitlines()
                     if not line.lstrip("[rank0123]: ").startswith(("File ", "^"))
                     and not line.strip(" ^~[rank0123]:").startswith(("return ", "self.")))


def _card_free(rec: dict, what: str) -> None:
    """Free this process's cached blocks and note the card's free memory."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    rec.setdefault("card_free_gib", {})[what] = free / 2**30
    rec.setdefault("reserved_gib", {})[what] = torch.cuda.memory_reserved() / 2**30
    print(f"{what}: the card has {free / 2**30:.2f} GiB free; this rank holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved)", flush=True)


def _leaves(params: dict) -> list:
    """A copy of each parameter leaf (the step updates them in place)."""
    from repro_torch.models.layers import tree_leaves

    return [p.clone() for p in tree_leaves(params)]


def _change(params: dict, init: list) -> list:
    """Each parameter leaf's change over the run, ||p - p_init|| (a
    DTensor leaf's over every shard), in ``tree_leaves`` order."""
    from repro_torch.models.layers import tree_leaves

    return [_param_norm({"p": p - p0}) for p, p0 in zip(tree_leaves(params), init)]


def _norms(tree: dict) -> list:
    """Each leaf's norm (a DTensor leaf's over every shard), in
    ``tree_leaves`` order."""
    from repro_torch.models.layers import tree_leaves

    return [_param_norm({"p": t}) for t in tree_leaves(tree)]


def _hold_change(label: str, got: list, want: list) -> tuple[float, float]:
    """The parameters' change over the run (``_change``) against the plain
    run's: as one norm over every leaf within TRAIN_LOSS_REL, and each
    leaf's within TRAIN_GRAD_REL (a leaf's change is its gradient
    normalised: a small leaf's, a bfloat16 sum of many cancelling terms
    like a norm's scale, differs by some 1e-3 between the two runs' orders
    of summation).  A run that leaves the parameters in place fails.
    Returns (the total's, the worst leaf's) relative difference."""
    total = math.hypot(*want)
    check(total > 0, f"{label}: the plain run left the parameters in place")
    rel_total = abs(math.hypot(*got) - total) / total
    check(rel_total <= TRAIN_LOSS_REL, f"{label}: the parameters moved "
          f"{math.hypot(*got)}, the plain run's {total}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(abs(g - w) <= TRAIN_GRAD_REL * w,
              f"{label}: leaf {i} moved {g}, the plain run's {w}")
        worst = max(worst, abs(g - w) / w if w else 0.0)
    return rel_total, worst


def lm_sharded_rank(rank: int, store: str, out: str) -> None:
    """One of part (b)'s four ranks on the one card over gloo, DTensor's
    all-gathers staged through the host: llama3.2-3b cut to
    LM_SH_LAYERS layers through ``launch/train.py --mesh 2x2``;
    olmoe-1b-7b cut alike, Adafactor, µ = 2, through ``shard_train_step``;
    the compressed pod step on the cut llama at (2, 1, 2); qwen3-4b cut
    alike served (``_serve_rank``); the flash kernels at this rank's shard
    shapes against their plain versions.  Rank 0 then runs each cut model's
    plain step from the same state over the same batches, and the served
    model in one unsharded process.  Writes its figures to ``out``."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import distributed as dd
    from repro_torch.kernels import load_library
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import distribute
    from repro_torch.train import (CompressConfig, TrainConfig, compressed_state_shardings,
                                   init_error_state, make_compressed_train_step,
                                   make_train_state, shard_train_step)

    torch.cuda.set_device(0)
    load_library()
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=LM_SH_RANKS)
    check(dd.stage_functional_collectives(), "gloo: staging is off")
    rec: dict = {}
    t0 = time.perf_counter()
    # 1. llama through the launcher
    arch, B, S, _, _ = LM_SH_RUNS["llama3.2-3b"]
    steps, batches = [], []
    with (tempfile.TemporaryDirectory() as tmp,
          _sharded_launcher(steps, batches, layers=LM_SH_LAYERS)):
        _lm_counts_zero()
        rc = train_mod.main(_sharded_argv(arch, B, S, tmp, "2x2", remat=LM_SH_REMAT))
        launches = _lm_counts()
    check(rc == 0 and len(steps) == LM_SH_STEPS, f"(b) {arch}: rc {rc}, {len(steps)} steps")
    rec[arch] = {"steps": steps, "launches": launches, "batch": [B, S]}
    _card_free(rec, f"after {arch}")
    # 2. olmoe through shard_train_step, a seeded batch a step
    arch, B, S, opt, mu = LM_SH_RUNS["olmoe-1b-7b"]
    cfg = _lm_config(arch, LM_SH_LAYERS)
    otc = TrainConfig(optimizer=opt, num_microbatches=mu, warmup_steps=1,
                      total_steps=LM_SH_SHORT, remat=LM_SH_REMAT)
    mesh = make_mesh((2, 2), ("data", "model"), "cuda")
    g = torch.Generator("cuda").manual_seed(7)
    ob = [{"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda"),
           "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda")}
          for _ in range(LM_SH_SHORT)]
    state = make_train_state(torch.Generator("cuda").manual_seed(0), cfg, otc,
                             device="cuda")
    state["step"].fill_(LM_SH_FROM)
    step, sh, _ = shard_train_step(mesh, cfg, otc, state)
    state = distribute(state, sh)
    init = _leaves(state["params"])
    torch.cuda.empty_cache()
    osteps: list = []
    step = _timed_sharded(step, osteps, None)
    c0 = _lm_counts()
    for b in ob:
        state, _ = step(state, b)
    rec[arch] = {"steps": osteps, "launches": _diff(_lm_counts(), c0), "batch": [B, S],
                 "change": _change(state["params"], init)}
    del state, step, init
    _card_free(rec, f"after {arch}")
    # 3. the compressed pod step, kernel route then plain route, from the
    # plain llama run's state and first batch
    cfg = _lm_config("llama3.2-3b", LM_SH_LAYERS)
    tc = TrainConfig(warmup_steps=1, total_steps=LM_SH_SHORT + LM_SH_FROM,
                     remat=LM_SH_REMAT)
    pmesh = make_mesh((2, 1, 2), ("pod", "data", "model"), "cuda")
    comp = {}
    for route in ("cuda", "plain"):
        state = make_train_state(torch.Generator("cuda").manual_seed(0), cfg, tc,
                                 device="cuda")
        state["step"].fill_(LM_SH_FROM)
        state["error"] = init_error_state(state["params"])
        state = distribute(state, compressed_state_shardings(pmesh, cfg, tc, state))
        init = _leaves(state["params"])
        torch.cuda.empty_cache()
        cstep = make_compressed_train_step(pmesh, cfg, tc, CompressConfig(**LM_SH_COMPRESS))
        csteps: list = []
        cstep = _timed_sharded(cstep, csteps, None)
        with (plain_attention() if route == "plain" else contextlib.nullcontext()):
            for b in batches[:LM_SH_SHORT]:
                state, _ = cstep(state, b)
        comp[route] = {"steps": csteps, "change": _change(state["params"], init),
                       "error": _norms(state["error"])}
        del state, cstep, init
        _card_free(rec, f"after the compressed step, {route} route")
    rec["compressed"] = comp
    # 3b. sharded serving: qwen3-4b cut to LM_SH_LAYERS, prefill and decode
    t1 = time.perf_counter()
    srv = _serve_rank(mesh)
    rec["serve"] = {k: v for k, v in srv.items() if not k.startswith("_")}
    rec["serve"]["wall_s"] = time.perf_counter() - t1
    _card_free(rec, "after sharded serving")
    # 4. the flash kernels at this rank's shard shape
    lcfg = _lm_config("llama3.2-3b")
    ocfg = _lm_config("olmoe-1b-7b")
    qcfg = _lm_config(LM_ARCH)
    rec["flash_shard"] = {
        "llama3.2-3b": _flash_shard_check(lcfg, 2, 1024, lcfg.num_heads // 2,
                                          lcfg.num_kv_heads // 2),
        "olmoe-1b-7b": _flash_shard_check(ocfg, 2, 512, ocfg.num_heads // 2,
                                          ocfg.num_kv_heads // 2),
        LM_ARCH: _flash_shard_check(qcfg, LM_SSH_B // 2, LM_SSH_S, qcfg.num_heads // 2,
                                    qcfg.num_kv_heads // 2)}
    rec["staged"] = dict(dd.STAGED)
    rec["rank_s"] = time.perf_counter() - t0
    dist.destroy_process_group()
    if rank == 0:
        rec["serve"]["logit_rel"] = _serve_unsharded(srv)
    del srv
    if rank == 0:
        # the plain step of each cut model, from the same state, same batches
        lt = TrainConfig(warmup_steps=2, total_steps=LM_SH_STEPS, remat=LM_SH_REMAT)
        rec["plain"] = {
            "llama3.2-3b": _unsharded(_lm_config("llama3.2-3b", LM_SH_LAYERS), lt,
                                      batches, 0),
            "olmoe-1b-7b": _unsharded(_lm_config("olmoe-1b-7b", LM_SH_LAYERS), otc, ob, 0,
                                      LM_SH_FROM)}
    with open(out, "w") as fh:
        json.dump(rec, fh)


def _counter_part(suffix: str, timeout: float = 600.0):
    """The counter's file ``suffix`` (``count_cells``), waited for: the
    counter writes it whole (a rename) once that part is counted."""
    check(bool(COUNTER), "no counter was started")
    path = Path(COUNTER[0] + suffix)
    deadline = time.monotonic() + timeout
    while not path.exists():
        proc = COUNTER[1]
        check(proc.poll() in (None, 0), f"the counter exited {proc.returncode}")
        check(time.monotonic() < deadline, f"the counter wrote no {path.name}")
        time.sleep(0.5)
    return json.loads(path.read_text())


def _serve_check(recs: list) -> None:
    """(b) and (c) of sharded serving from the four ranks' records: the
    prefill's flash launches on each rank (LM_SH_LAYERS, all tensor-core,
    on its 16 query and 4 KV heads), the logits held by rank 0 to the
    unsharded run, and (c) rank 0's collectives (the prefill, the first
    decode step, the llama step of part (b)) against the counter's fake
    group of four, op for op, in count and in operand bytes."""
    four = recs[0]
    for r, rr in enumerate(recs):
        lf = rr["serve"]["launches"]
        check(lf["flash_attention"] == lf["flash_attention_tc"] == LM_SH_LAYERS,
              f"(b) serve rank {r}: flash launches {lf}, want {LM_SH_LAYERS} on the "
              "tensor-core route")
        fs = rr["flash_shard"][LM_ARCH]
        check(math.isfinite(fs["fwd_err"]), f"(b) rank {r}: flash at the serve shard")
        for k in ("prefill", "decode"):
            check(rr["serve"]["collectives"][k] == four["serve"]["collectives"][k],
                  f"(c) rank {r} issued other collectives in the {k}")
    srv = four["serve"]
    fake = _counter_part(".ranks.json")
    real = {"prefill": srv["collectives"]["prefill"],
            "decode": srv["collectives"]["decode"],
            "train": four["llama3.2-3b"]["steps"][1]["collective_bytes"]}
    for k, want in fake["cells"].items():
        check(real[k] == want["collectives"],
              f"(c) {k}: the ranks issued {real[k]}, the fake group counts "
              f"{want['collectives']}")
    SHARDED_SERVE["four_ranks"] = {
        "arch": LM_ARCH, "layers": LM_SH_LAYERS, "batch": [LM_SSH_B, LM_SSH_S],
        "decode_steps": LM_SSH_DECODE, "prefill_ms": srv["prefill_ms"],
        "decode_ms_per_step": srv["decode_ms_per_step"],
        "peak_gib": [rr["serve"]["peak_gib"] for rr in recs],
        "launches": srv["launches"], "logit_rel": srv["logit_rel"],
        "flash_shard": four["flash_shard"][LM_ARCH], "wall_s": srv["wall_s"]}
    SHARDED_SERVE["counts"] = {"ranks": real, "fake_group": fake}
    print(f"(b) {LM_ARCH} cut to {LM_SH_LAYERS} layers served sharded, 4 ranks on one "
          f"card over gloo, (2, 2) ({LM_SSH_B} x {LM_SSH_S} prompts, {LM_SSH_DECODE} "
          f"decode steps; {CARD[0]}): prefill {srv['prefill_ms']:.1f} ms (under the "
          f"dry run's mode), decode {srv['decode_ms_per_step']:.1f} ms a step; logits "
          f"against one unsharded process within {max(srv['logit_rel']):.3g} of max|logits|"
          f"; flash launches a prefill {srv['launches']['flash_attention']} a rank, all "
          f"tensor-core, at the shard {four['flash_shard'][LM_ARCH]}; (c) collectives "
          f"equal to the fake group's count: {json.dumps(real)} (counted in "
          f"{fake['count_s']:.1f} s)", flush=True)


def lm_sharded_phase(training: dict) -> dict:
    """LM training sharded over a DeviceMesh: (a) one rank over NCCL at
    llama3.2-3b's full size (``lm_sharded_one_rank``, against ``training``'s
    (c)); (b) four ranks on the one card over gloo, each a process of this
    script (``--lm-sharded-rank``), held to the plain step and the plain
    route.  A failing rank fails the phase."""
    import tempfile

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"card": CARD[0],
           "one_rank": lm_sharded_one_rank(training["train"][TRAIN_RUNS[0][0]])}
    gc.collect()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    print(f"before the four ranks: this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved), the card has "
          f"{free / 2**30:.2f} GiB free", flush=True)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(LM_SH_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--lm-sharded-rank", str(r),
             os.path.join(tmp, "store"), outs[r]], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "OMP_NUM_THREADS": "2",
                 "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
            for r in range(LM_SH_RANKS)]
        logs = [p.communicate(timeout=900)[0] for p in procs]
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        check(not failed, "lm sharded ranks failed: " + "\n".join(
            f"rank {r}:\n{_untraced(logs[r])[-3000:]}" for r in failed))
        recs = [json.load(open(o)) for o in outs]
    four = recs[0]
    for arch in LM_SH_RUNS:
        for r, other in enumerate(recs[1:], 1):
            check([s["loss"] for s in other[arch]["steps"]]
                  == [s["loss"] for s in four[arch]["steps"]],
                  f"(b) {arch}: rank {r} reports other losses")
        cfg = _lm_config(arch, LM_SH_LAYERS)
        mu = LM_SH_RUNS[arch][4]           # each microbatch its own forward and backward
        want_b = mu * _flash_per_step(cfg)[1]
        want_f = want_b                    # remat "none": one forward a backward
        for r, rr in enumerate(recs):
            for i, st in enumerate(rr[arch]["steps"]):
                lf = st["launches"]
                check(lf["flash_attention"] == lf["flash_attention_tc"] == want_f
                      and lf["flash_attention_bwd"] == lf["flash_attention_bwd_tc"]
                      == want_b,
                      f"(b) {arch} rank {r} step {i}: flash launches {lf}, want "
                      f"{want_f} and {want_b} on the tensor-core route")
        plain = four["plain"][arch]
        four[arch]["loss_rel"] = _hold(f"(b) {arch}", four[arch]["steps"], plain["steps"])
        moved = four[arch].get("change")
        if moved is not None:
            four[arch]["change_rel"] = _hold_change(f"(b) {arch}", moved, plain["change"])
        st = four[arch]["steps"]
        print(f"{arch} cut to {LM_SH_LAYERS} layers, 4 ranks on one card over gloo, "
              f"(2, 2) mesh ({four[arch]['batch'][0]} x {four[arch]['batch'][1]} tokens"
              f"; {CARD[0]}): losses {[s['loss'] for s in st]} (plain "
              f"{[s['loss'] for s in plain['steps']]}; worst {four[arch]['loss_rel']:.3g}"
              f" relative)" + (f"; the parameters' change {math.hypot(*moved)} (plain "
                               f"{math.hypot(*plain['change'])}: {four[arch]['change_rel'][0]:.3g} "
                               f"relative, the worst leaf {four[arch]['change_rel'][1]:.3g})"
                               if moved is not None else "")
              + f"; step ms {[round(s['step_ms'], 1) for s in st]}; collectives a "
              f"step {next((s['collectives'] for s in st if 'collectives' in s), None)}; staged a step {[s['staged'] for s in st]}"
              f" ({[round(s['staged_gib'], 3) for s in st]} GiB to the host, "
              f"{[round(s['staged_ms']) for s in st]} ms in them, rank 0);"
              f" per-rank peak {[round(max(s['peak_gib'] for s in rr[arch]['steps']), 2) for rr in recs]}"
              f" GiB; flash launches a step {st[0]['launches']['flash_attention']} forward, "
              f"{st[0]['launches']['flash_attention_bwd']} backward a rank", flush=True)
    comp = four["compressed"]
    dens = [s["compress_density"] for r in ("cuda", "plain") for s in comp[r]["steps"]]
    check(all(0 < d <= 0.075 for d in dens), f"(b) compressed: density {dens}")
    # the loss from the plain llama run's state and first batch
    got0 = comp["cuda"]["steps"][0]["loss"]
    want0 = four["plain"]["llama3.2-3b"]["steps"][0]["loss"]
    check(abs(got0 / want0 - 1) <= TRAIN_LOSS_REL,
          f"(b) compressed: loss {got0} vs the plain step's {want0}")
    label = "(b) compressed, kernel vs plain route"
    comp["loss_rel"] = _hold(label, comp["cuda"]["steps"], comp["plain"]["steps"])
    comp["change_rel"] = _hold_change(label, comp["cuda"]["change"], comp["plain"]["change"])
    comp["error_rel"] = _hold_change(label + ", the error state", comp["cuda"]["error"],
                                     comp["plain"]["error"])
    moved = math.hypot(*comp["cuda"]["change"])
    for r, rr in enumerate(recs):
        for arch, fs in rr["flash_shard"].items():
            check(math.isfinite(fs["fwd_err"]) and math.isfinite(fs["bwd_err"]),
                  f"(b) rank {r} {arch}: flash at the shard shape")
    print(f"compressed pod step, (pod, data, model) = (2, 1, 2), ratio "
          f"{LM_SH_COMPRESS['ratio']}, block {LM_SH_COMPRESS['block']}, one step at "
          f"the full rate: loss {[s['loss'] for s in comp['cuda']['steps']]} (plain route "
          f"{[s['loss'] for s in comp['plain']['steps']]}, {comp['loss_rel']:.3g}), the "
          f"parameters' change {moved} (plain route {math.hypot(*comp['plain']['change'])}"
          f": {comp['change_rel'][0]:.3g} relative, the worst leaf "
          f"{comp['change_rel'][1]:.3g}), the error state {math.hypot(*comp['cuda']['error'])}"
          f" ({comp['error_rel'][0]:.3g}, the worst leaf {comp['error_rel'][1]:.3g}), "
          f"density {dens}, step ms {[round(s['step_ms'], 1) for s in comp['cuda']['steps']]}"
          f" (plain route {[round(s['step_ms'], 1) for s in comp['plain']['steps']]}; "
          f"staged {[round(s['staged_ms']) for s in comp['cuda']['steps']]} ms); "
          f"flash at the shard "
          f"shapes {json.dumps(four['flash_shard'])}; staged by op {four['staged']};"
          f" rank wall {[round(rr['rank_s'], 1) for rr in recs]} s; the card's free "
          f"GiB (rank 0's reserved) {json.dumps(four['card_free_gib'])} "
          f"({json.dumps(four['reserved_gib'])})", flush=True)
    _serve_check(recs)
    out["four_ranks"] = four
    out["four_ranks_s"] = time.perf_counter() - t1
    out["phase_s"] = time.perf_counter() - t0
    print(f"lm sharded phase: {out['phase_s']:.2f} s ((a) "
          f"{out['one_rank']['wall_s']:.2f} s, (b) {out['four_ranks_s']:.2f} s)", flush=True)
    return out


# -- batched execution: the service's lanes and SS pruning of the KV cache ----

LANE_B, LANE_N = 8, 1 << 16        # coverage lane: 8 queries of 2^16 sentences
FL_LANE_B, FL_LANE_N = 4, 1 << 13  # FL lane: 4 queries of 2^13 frames
KV_BUDGET = 256                    # the reference's KVSelectConfig default


def _lane_gens(B: int, base: int) -> list:
    return [torch.Generator(device="cuda").manual_seed(base + b) for b in range(B)]


def _median_wall(call, reps: int = 3) -> float:
    """The median synchronised host-clock wall of ``reps`` calls."""
    return statistics.median(_synced(call)[1] for _ in range(reps))


def _rows_equal(res, ss, singles, what: str) -> None:
    """Row b of a batched summarize equals the b-th single-query summarize
    bit for bit: V', eps_hat, rounds, alive_trace, picks, gains, f(S)."""
    for b, (r1, s1) in enumerate(singles):
        for name, got, want in (
                ("vprime", ss.vprime[b], s1.vprime), ("eps_hat", ss.eps_hat[b], s1.eps_hat),
                ("alive_trace", ss.alive_trace[b], s1.alive_trace),
                ("selected", res.selected[b], r1.selected),
                ("gains", res.gains[b], r1.gains), ("value", res.value[b], r1.value)):
            check(torch.equal(got, want), f"{what}: row {b}'s {name} differs from "
                  "the single-query run on the card")
        check(ss.rounds[b] == s1.rounds, f"{what}: row {b}'s rounds differ")


def _hooks_vs_plain(label: str, f, names: tuple, alive_sel, state, errs: dict,
                    seed: int) -> str:
    """The kernels of one query at the shapes its batched run gives them,
    held to their plain versions on the same inputs at TOL (of the sums'
    size, as ``_fl_close``): the divergence of a draw of round 1's probes
    over the other elements (all, and a buffer of half of n), and the gains at
    the empty state over all n and at the run's final ``state`` over the
    selection's buffer of ``alive_sel`` (V'), through ``prepare_compact``
    (dense FL's V' panel where it takes one).  The errors go into
    ``errs``."""
    from repro_torch.core import CudaBackend, ReferenceBackend
    from repro_torch.core.greedy import compact_indices, gumbel, selection_bucket
    from repro_torch.core.sparsify import probe_count

    kb, pb = CudaBackend(), ReferenceBackend()
    n, tol = f.n, TOL[torch.float32]
    div_name, gains_name = names
    resid = f.residual_gains()
    g = torch.Generator(device="cuda").manual_seed(seed)
    probes = torch.topk(gumbel(n, g, "cuda"), min(probe_count(n, R), n)).indices
    # the probes' own slots: the plain version takes f(u | S + u) = 0, the
    # kernel counts W_u twice, and SS never reads them (they leave the live
    # set first), so both cases hold the other elements
    rest = torch.ones(n, dtype=torch.bool, device="cuda").index_fill_(0, probes, False)
    others = torch.nonzero(rest).flatten()
    half = torch.sort(others[torch.randperm(others.shape[0], generator=g,
                                            device="cuda")[: n // 2]]).values
    size = selection_bucket(n, int(alive_sel.sum()))
    cand = (compact_indices(alive_sel, size) if size is not None
            else torch.arange(n, device="cuda"))
    empty = f.empty_state()
    cases = (
        (div_name, "the non-probes", kb.divergence(f, probes, resid)[rest],
         pb.divergence(f, probes, resid)[rest], float(resid[probes].abs().max())),
        (div_name, "half of n", kb.divergence_compact(f, probes, half, resid),
         pb.divergence_compact(f, probes, half, resid), float(resid[probes].abs().max())),
        (gains_name, "all n, empty state", kb.gains(f, empty), pb.gains(f, empty), 0.0),
        (gains_name, f"V' buffer of {cand.shape[0]}, final state",
         kb.gains_compact(f, state, kb.prepare_compact(f, cand)),
         pb.gains_compact(f, state, cand), abs(float(f.value(state)))),
    )
    worst = {div_name: 0.0, gains_name: 0.0}
    for name, what, got, want, extra in cases:
        err = float((got - want).abs().max())
        lim = tol * max(1.0, float(want.abs().max()) + extra)
        check(got.shape == want.shape and bool(torch.isfinite(got).all())
              and err <= lim, f"{label}: {name} ({what}) kernel vs plain err {err} "
              f"> {lim}")
        errs[name] = max(errs[name], err)
        worst[name] = max(worst[name], err)
    return (f"{div_name} and {gains_name} against their plain versions at this "
            f"path's shapes (r = {probes.shape[0]}; the non-probes, half of n, V' buffer): max "
            f"abs err {worst[div_name]:.3g} and {worst[gains_name]:.3g}, within TOL")


def _lane(label: str, fn, kernels: dict, base_seed: int, errs: dict) -> dict:
    """One service lane through ``summarize_batch`` on the card: the kernels'
    launches (counts set to 0 just before, read just after), rows against
    the single-query ``summarize`` of each query bit for bit, the stochastic
    selector against per-row ``stochastic_greedy`` under the same plan and
    draws, the streamed call against the unstreamed, row 0's kernels against
    their plain versions at the lane's shapes (``_hooks_vs_plain``), the
    batched wall against the sum of the B single-query walls, host syncs
    (batched SS: its explicit reads only) and a profile."""
    from repro_torch import (
        FacilityLocation, auto_sample_size, ss_sparsify_batched, stochastic_greedy,
        summarize,
    )
    from repro_torch.core.greedy import _batched_compact_plan, selection_bucket
    from repro_torch.core.sparsify import _sparsify_batched, ss_live_bound
    from repro_torch.kernels import fl_gains_panel, takes_panel
    from repro_torch.serve import summarize_batch
    from repro_torch.serve.summarize_service import fold_generators

    B, n = fn.batch, fn.row(0).n

    def batched(**kw):
        return summarize_batch(fn, K, _lane_gens(B, base_seed), r=R, c=C, **kw)

    def sequential():
        return [summarize(fn.row(b), K, g, r=R, c=C)
                for b, g in enumerate(_lane_gens(B, base_seed))]

    for kern in kernels.values():
        kern.launches = 0
    fl_gains_panel.gathers = 0
    _sparsify_batched.host_reads = 0
    (res, ss), wall_first = _synced(batched)
    launches = {name: kern.launches for name, kern in kernels.items()}
    gathers, ss_reads = fl_gains_panel.gathers, _sparsify_batched.host_reads
    div_name, gains_name = list(kernels)
    check(launches[div_name] == sum(ss.rounds),
          f"{label}: {launches[div_name]} {div_name} launches, not one a row a round "
          f"({sum(ss.rounds)})")
    check(launches[gains_name] == B * K,
          f"{label}: {launches[gains_name]} {gains_name} launches, not one a row a "
          f"step ({B * K})")
    size, live = _batched_compact_plan(n, ss.vprime, ss_live_bound(n, R, C))
    want = B if isinstance(fn, FacilityLocation) and takes_panel(size or n, n) else 0
    check(gathers == want, f"{label}: {gathers} panel gathers, not {want} (one a row "
          "per greedy run where the bucket takes a panel)")
    check(ss_reads == max(ss.rounds) + 1,
          f"{label}: {ss_reads} host reads in SS, not one a round and one more")
    singles = sequential()
    _rows_equal(res, ss, singles, label)
    vp = [int(x) for x in ss.vprime.sum(1).tolist()]
    held = _hooks_vs_plain(label, fn.row(0), (div_name, gains_name), ss.vprime[0],
                           res.state[0], errs, base_seed)

    # the stochastic selector: per-row stochastic greedy under the same plan
    s = auto_sample_size(n, K, 0.1, live)
    sto, _ = batched(selector="stochastic")
    same_plan = [b for b in range(B) if selection_bucket(n, vp[b]) == size]
    for b, g in zip(same_plan, [fold_generators(_lane_gens(B, base_seed), 1)[b]
                                for b in same_plan]):
        one = stochastic_greedy(fn.row(b), K, g, s=s, alive=ss.vprime[b])
        check(torch.equal(one.selected, sto.selected[b])
              and torch.equal(one.gains, sto.gains[b]),
              f"{label}: stochastic row {b} differs from per-row stochastic greedy")
    check(same_plan, f"{label}: no row shares the batch's bucket")

    # the streamed selection equals the unstreamed one
    steps = []
    streamed, _ = batched(on_step=lambda i, v, g_, ok: steps.append(v))
    check(torch.equal(streamed.selected, res.selected)
          and torch.equal(streamed.gains, res.gains)
          and torch.equal(torch.stack(steps, 1), res.selected),
          f"{label}: the streamed selection differs from the unstreamed one")

    # walls: the batch against B single queries, each synchronised, median
    wall_b = _median_wall(batched)
    wall_s = _median_wall(sequential)
    reads_b, reads_s = host_syncs(batched), host_syncs(sequential)
    # the batched SS loop synchronises only where it reads the live counts
    _sparsify_batched.host_reads = 0
    ss_syncs = host_syncs(lambda: ss_sparsify_batched(fn, _lane_gens(B, base_seed),
                                                      r=R, c=C))
    check(ss_syncs == _sparsify_batched.host_reads == max(ss.rounds) + 1,
          f"{label}: batched SS made {ss_syncs} host syncs, not its "
          f"{_sparsify_batched.host_reads} explicit reads ({max(ss.rounds) + 1})")
    prof = profile_run(f"{label} summarize_batch", batched,
                       watch=(div_name, gains_name), top=6)
    print(f"{label}: B = {B} x n = {n}, k = {K}: rounds {ss.rounds}, |V'| {vp} "
          f"(shared bucket {size}), eps_hat {[round(float(x), 6) for x in ss.eps_hat]}; "
          f"rows equal the single-query summarize bit for bit; stochastic rows "
          f"{same_plan} equal per-row stochastic greedy (s = {s}); streamed == "
          f"unstreamed; launches {launches}, panel gathers {gathers}; batched wall "
          f"{wall_b:.4f} s against {wall_s:.4f} s for {B} single queries (host "
          f"clock, synchronised, median of 3; first batched call {wall_first:.4f} "
          f"s); host syncs {reads_b} batched against {reads_s} sequential, batched "
          f"SS alone {ss_syncs} (its explicit reads); row 0: "
          f"{held}", flush=True)
    return {"B": B, "n": n, "k": K, "rounds": ss.rounds, "vprime": vp,
            "bucket": size, "launches": launches, "panel_gathers": gathers,
            "ss_host_reads": ss_reads, "wall_s": wall_b, "sequential_wall_s": wall_s,
            "host_syncs": reads_b, "sequential_host_syncs": reads_s,
            "ss_host_syncs": ss_syncs,
            "busy_ms": prof.get("busy_ms"), "profiled_wall_ms": prof.get("wall_ms")}


def coverage_lane(fn, errs: dict) -> dict:
    """The coverage lane: the first 2^19 sentences of FeatureCoverage's news
    day (2^20 x 1024) viewed as the service's max_batch = 8 queries of 2^16
    sentences, a stacked (8, 2^16, 1024) W that costs no new bytes."""
    from repro_torch import FeatureCoverage
    from repro_torch.kernels import feature_gains_kernel, ss_divergence_kernel

    W = fn.W[:LANE_B * LANE_N].view(LANE_B, LANE_N, fn.W.shape[1])
    check(W.data_ptr() == fn.W.data_ptr(), "coverage lane: W was copied")
    fnb = FeatureCoverage(W=W, phi=fn.phi)
    return _lane("coverage lane", fnb, {"ss_divergence": ss_divergence_kernel,
                                        "feature_gains": feature_gains_kernel}, 100, errs)


def fl_lane(X, errs: dict) -> dict:
    """The FL lane: 4 queries of 2^13 frames cut from path A's video, each
    through ``build_batch_objective`` (cosine similarity on the card, 1 GiB
    stacked)."""
    from repro_torch.kernels import fl_divergence_kernel, fl_gains_kernel
    from repro_torch.serve import SummarizeRequest, build_batch_objective

    reqs = [SummarizeRequest(k=K, seed=b, objective="fl", kernel="cosine",
                             features=X[b * FL_LANE_N:(b + 1) * FL_LANE_N])
            for b in range(FL_LANE_B)]
    fnb, alive = build_batch_objective(reqs, None)
    check(alive is None and tuple(fnb.sim.shape) == (FL_LANE_B, FL_LANE_N, FL_LANE_N),
          "FL lane: wrong stacked objective")
    return _lane("FL lane", fnb, {"fl_divergence": fl_divergence_kernel,
                                  "fl_gains": fl_gains_kernel}, 200, errs)


def _f64_bound(terms: torch.Tensor) -> torch.Tensor:
    """The rounding bound of a float32 sum of ``terms`` (..., N) in any order,
    each term itself rounded a few times: 2 (N + 4) 2^-24 sum |t|."""
    return 2.0 * (terms.shape[-1] + 4) * 2.0 ** -24 * terms.abs().sum(-1)


def _f64_pair(fn, mu, cands):
    """float64 terms of f(v | mu) for the candidates, (r, k, N), and the
    magnitudes that the float32 routes' sums round against: FeatureCoverage's
    phi(mu + W_v) - phi(mu) (the plain divergence sums phi(mu + W_v) and
    subtracts sum phi(mu): both count), facility location's hinge
    max(sim_iv - mu_i, 0).  The matrix-free facility location computes
    each sim_iv = x_i . x_v in float32 too, within d 2^-24 sum_k |x_ik
    x_vk| of the float64 one: each term's magnitude carries that share of
    the bound, d sum_k |x_ik x_vk| / (2 (N + 4)), so ``_f64_bound`` adds
    it."""
    from repro_torch import FeatureCoverage, StreamingFacilityLocation

    if isinstance(fn, FeatureCoverage):
        hi = torch.sqrt((mu[:, None, :] + fn.W.double()[cands][None]).clamp_min(0))
        lo = torch.sqrt(mu.clamp_min(0))[:, None, :]
        return hi - lo, hi + lo
    if isinstance(fn, StreamingFacilityLocation):
        t = (_f64_sim(fn, cands).T[None] - mu[:, None, :]).clamp_min(0)
        N, d = fn.X.shape
        A = fn.X.double().abs()
        return t, t + d * (A @ A[cands].T).T[None] / (2 * (N + 4))
    t = (fn.sim.double()[:, cands].T[None] - mu[:, None, :]).clamp_min(0)
    return t, t


def _f64_sim(fn, cols):
    """float64 similarity columns of the matrix-free facility location:
    max(X X[cols]ᵀ, 0), (N, len(cols))."""
    X = fn.X.double()
    return (X @ X[cols].T).clamp_min(0)


def _f64_mu(fn, probes, state):
    """float64 probe coverage: state + W_u, or max(state, sim[:, u])."""
    from repro_torch import FeatureCoverage, StreamingFacilityLocation

    if isinstance(fn, FeatureCoverage):
        return state.double()[None] + fn.W.double()[probes]
    if isinstance(fn, StreamingFacilityLocation):
        return torch.maximum(state.double()[None], _f64_sim(fn, probes).T)
    return torch.maximum(state.double()[None], fn.sim.double()[:, probes].T)


def _margin(label: str, what: str, a: int, b: int, va, vb) -> str:
    """Elements ``a`` and ``b``, (float64 value, rounding bound) each, lie
    within float32 rounding of each other; raises where they do not."""
    gap = abs(float(va[0] - vb[0]))
    bound = float(va[1] + vb[1])
    check(gap <= bound, f"{label}: {what}: elements {a} and {b} differ by "
          f"{gap:.3g} in float64, above the float32 rounding bound {bound:.3g}")
    return (f"{what}: elements {a} and {b} differ by {gap:.3g} in float64, "
            f"within the float32 rounding bound {bound:.3g}")


def _explain_ss(label: str, fn, gen, alive=None, r: int = R, c: float = C):
    """Step SS on the kernel route and the plain route in lockstep (the
    kernel route's state, the draws of ``gen``, the live set ``alive``) to
    the first prune cut they make differently, and show in float64 that it
    lies within float32 rounding.  Returns (explanation, None) there, or
    (None, V') when every cut agrees."""
    from repro_torch.core import CudaBackend, ReferenceBackend
    from repro_torch.core.greedy import NEG, gumbel
    from repro_torch.core.sparsify import INF, max_rounds, probe_count

    kb, pb = CudaBackend(), ReferenceBackend()
    n = fn.n
    m, shrink = min(probe_count(n, r), n), 1.0 - 1.0 / math.sqrt(c)
    resid = fn.residual_gains()
    alive = (torch.ones(n, dtype=torch.bool, device="cuda") if alive is None
             else alive.clone())
    vprime = torch.zeros_like(alive)
    div_k = torch.full((n,), INF, device="cuda")
    div_p = div_k.clone()
    zero = fn.empty_state()

    def div64(probes, v):
        t, mag = _f64_pair(fn, _f64_mu(fn, probes, zero),
                           torch.tensor([v], device="cuda"))
        w = t.sum(-1)[:, 0] - resid.double()[probes]
        u = int(torch.argmin(w))
        return float(w[u]), float(_f64_bound(mag[u, 0]))

    probes_all = []
    for rnd in range(max_rounds(n, r, c)):
        live = int(alive.sum())
        if live <= m:
            break
        g = gumbel(n, gen, "cuda") + torch.where(alive, 0.0, NEG)
        probes = torch.topk(g, m).indices
        probes_all.append(probes)
        vprime[probes] = True
        alive[probes] = False
        live -= m
        cand = torch.nonzero(alive).flatten()
        div_k[cand] = torch.minimum(div_k[cand], kb.divergence_compact(fn, probes, cand, resid))
        div_p[cand] = torch.minimum(div_p[cand], pb.divergence_compact(fn, probes, cand, resid))
        # float32 live * shrink, as the SS loop sets the count
        n_remove = int(torch.floor(torch.tensor(float(live)) * torch.tensor(shrink)))
        rk = cand[torch.argsort(div_k[cand], stable=True)[:n_remove]]
        rp = cand[torch.argsort(div_p[cand], stable=True)[:n_remove]]
        if set(rk.tolist()) != set(rp.tolist()):
            a = sorted(set(rk.tolist()) - set(rp.tolist()))[0]
            b = sorted(set(rp.tolist()) - set(rk.tolist()))[0]
            allp = torch.cat(probes_all)
            return _margin(label, f"SS round {rnd}, the prune cut", a, b,
                           div64(allp, a), div64(allp, b)), None
        alive[rk] = False
    return None, vprime | alive


def _explain_greedy(label: str, fn, vprime, k: int) -> str:
    """Step greedy over ``vprime`` on both routes in lockstep to the first
    argmax they take differently and bound it in float64; raises where no
    decision differs or the gap exceeds float32 rounding."""
    from repro_torch.core import CudaBackend, ReferenceBackend

    cand = torch.nonzero(vprime).flatten()
    return _explain_picks(label, fn, cand, k, {
        route: (lambda st, be=be: be.gains_compact(fn, st, cand))
        for route, be in (("cuda", CudaBackend()), ("reference", ReferenceBackend()))})


def _explain_kv(label: str, fn, gen_seed: int, k: int) -> str:
    """One row whose kept positions differ between the kernel route and the
    plain route: step both routes in lockstep (the kernel route's state,
    the same draws) to the first decision they take differently, SS's prune
    cut or greedy's argmax, and show in float64 that it lies within float32
    rounding: the two elements' float64 values differ by less than their
    sums' rounding bounds.  Raises where it does not."""
    gen = torch.Generator(device="cuda").manual_seed(gen_seed)
    note, vprime = _explain_ss(label, fn, gen)
    return note if note is not None else _explain_greedy(label, fn, vprime, k)


def kv_prune_phase(cfg, eng, prompts, sc, errs: dict) -> dict:
    """SS pruning of the KV cache on the LM path: a fresh prefill (flash in
    every layer), ``Engine.prune_kv`` to the reference's budget with the
    coverage and the fl objective (counts set to 0 just before, read just
    after), the kernel route against the plain route (backend "reference"
    on the card's tensors) under the same draws (the same V' and picks, or a
    differing decision explained in float64; eps_hat, the gains before the
    first differing pick and f(S) of an equal kept set within TOL), row 0's kernels against their plain versions at this path's shapes
    (``_hooks_vs_plain``), then 32 tokens decoded from
    the pruned cache at the true position, held to the plain attention at
    every step; walls, peak memory and the fidelity of the first step's
    logits against a randomly pruned cache."""
    from repro_torch.kernels import (
        feature_gains_kernel, fl_divergence_kernel, fl_gains_kernel,
        flash_attention_kernel, ss_divergence_kernel,
    )
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import KVSelectConfig, summarize_batch
    from repro_torch.serve.engine import _sample
    from repro_torch.serve.kv_select import (
        _batch_objective, compact_cache, pooled_keys, row_generators,
    )

    B, S, NEW = prompts.shape[0], prompts.shape[1], LM_NEW
    kernels = {"flash_attention": flash_attention_kernel,
               "ss_divergence": ss_divergence_kernel,
               "feature_gains": feature_gains_kernel,
               "fl_divergence": fl_divergence_kernel, "fl_gains": fl_gains_kernel}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    out = {"budget": KV_BUDGET}
    seed = 5
    with plain_attention():          # the plain route's cache, for both objectives
        _, p_cache = prefill(cfg, eng.params, prompts, max_len=sc.max_len)

    def decode(cache, n0, pos0, tok, steps, plain=False):
        logits_all, toks = [], []
        for i in range(steps):
            if plain:
                with plain_attention():
                    logits, cache = decode_step(cfg, eng.params, tok, cache, n0 + i,
                                                pos0 + i)
            else:
                logits, cache = eng.decode_with_cache(tok, cache, n0 + i, pos=pos0 + i)
            logits_all.append(logits)
            tok = _sample(logits, None, sc)
            toks.append(tok)
        return logits_all, toks

    for objective in ("coverage", "fl"):
        kv = KVSelectConfig(budget=KV_BUDGET, objective=objective)
        for kern in kernels.values():
            kern.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = eng.prefill(prompts)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t
        (pruned, n_kv, kept), wall_prune = _synced(lambda: eng.prune_kv(cache, S, seed, kv))
        counts = {name: kern.launches for name, kern in kernels.items()}
        div_name, gains_name = (("ss_divergence", "feature_gains") if objective == "coverage"
                                else ("fl_divergence", "fl_gains"))
        other = {"ss_divergence", "feature_gains", "fl_divergence", "fl_gains"} - {
            div_name, gains_name}
        check(counts["flash_attention"] == cfg.num_layers,
              f"KV {objective}: {counts['flash_attention']} flash launches in the "
              f"prefill, not one a layer")
        check(counts[div_name] > 0 and counts[gains_name] == B * KV_BUDGET
              and all(counts[o] == 0 for o in other),
              f"KV {objective}: launches {counts} (want {div_name} each round of each "
              f"row and {gains_name} once a row a step, {B * KV_BUDGET})")
        check(n_kv == KV_BUDGET and tuple(kept.shape) == (B, KV_BUDGET)
              and bool((kept.diff(dim=1) > 0).all()) and int(kept.min()) >= 0
              and int(kept.max()) < S, f"KV {objective}: bad kept positions")

        # the plain route under the same draws, and each row's |V'|
        feats = pooled_keys(cache, S)
        fnb = _batch_objective(feats, kv)
        gens = row_generators(seed, B, "cuda")
        res_k, ss_k = summarize_batch(fnb, KV_BUDGET, gens, r=R, c=C)
        check(torch.equal(torch.sort(res_k.selected, 1).values, kept),
              f"KV {objective}: summarize_batch keeps other positions than prune_kv")
        res_p, ss_p = summarize_batch(fnb, KV_BUDGET, row_generators(seed, B, "cuda"),
                                      r=R, c=C, backend="reference")
        explained, route_err = [], {"eps_hat": 0.0, "gains": 0.0, "value": 0.0}
        tol = TOL[torch.float32]
        kept_p = torch.sort(res_p.selected, 1).values
        for b in range(B):
            f = fnb.row(b)
            same_ss = torch.equal(ss_k.vprime[b], ss_p.vprime[b])
            differ = torch.nonzero(res_k.selected[b] != res_p.selected[b]).flatten()
            upto = int(differ[0]) if differ.numel() else KV_BUDGET
            if not same_ss or upto < KV_BUDGET:
                explained.append(_explain_kv(f"KV {objective} row {b}", f,
                                             gens[b].initial_seed(), KV_BUDGET))
            if not same_ss:
                continue
            # Over the same V', the steps before the first differing pick
            # start from the same state, and a kept set equal to the plain
            # route's has its f(S).  eps_hat is a divergence: its sums are of
            # the size of a singleton and a residual; the gains and f(S) of
            # the size of f(S).
            div_size = float(f.singleton_gains().max() + f.residual_gains().abs().max())
            val_size = abs(float(res_p.value[b]))
            cases = [("eps_hat", ss_k.eps_hat[b], ss_p.eps_hat[b], div_size),
                     ("gains", res_k.gains[b, :upto], res_p.gains[b, :upto], val_size)]
            if torch.equal(kept[b], kept_p[b]):
                cases.append(("value", res_k.value[b], res_p.value[b], val_size))
            for name, got, want, size in cases:
                err = float((got - want).abs().max()) if got.numel() else 0.0
                check(err <= tol * max(1.0, size), f"KV {objective} row {b}: {name} "
                      f"of the kernel route vs the plain route err {err} > "
                      f"{tol * max(1.0, size)}")
                route_err[name] = max(route_err[name], err)
        same_kept = torch.equal(kept, kept_p)
        held = _hooks_vs_plain(f"KV {objective}", fnb.row(0), (div_name, gains_name),
                               ss_k.vprime[0], res_k.state[0], errs, seed)
        vp = [int(x) for x in ss_k.vprime.sum(1).tolist()]

        # decode from the pruned cache at the true position, both routes
        tok = _sample(logits, None, sc)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg_k, toks_k = decode(pruned, n_kv, S, tok, NEW - 1)
        torch.cuda.synchronize()
        ms_pruned = (time.perf_counter() - t) * 1e3 / (NEW - 1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        p_pruned = compact_cache(p_cache, kept)
        rel = 0.0
        tok_p = tok
        for i in range(NEW - 1):
            with plain_attention():
                lp, p_pruned = decode_step(cfg, eng.params, tok_p, p_pruned, n_kv + i,
                                           S + i)
            rel = max(rel, _logits_close(lg_k[i], lp, f"KV {objective} decode step "
                                         f"{i + 1}, kernel vs plain"))
            tok_p = toks_k[i]
        del p_pruned

        # fidelity: first-step logits of the pruned and of a randomly pruned
        # cache against the full cache (the reference test's measure)
        g = torch.Generator(device="cuda").manual_seed(11)
        rand_kept = torch.sort(torch.stack([torch.randperm(S, generator=g, device="cuda")
                                            [:KV_BUDGET] for _ in range(B)]), 1).values
        rand_cache = compact_cache(cache, rand_kept)
        lr, _ = eng.decode_with_cache(tok, rand_cache, n_kv, pos=S)
        del rand_cache
        t = time.perf_counter()
        lg_full, _ = decode(cache, S, S, tok, NEW - 1)
        torch.cuda.synchronize()
        ms_full = (time.perf_counter() - t) * 1e3 / (NEW - 1)
        full0 = lg_full[0].float().flatten()
        corr = float(torch.corrcoef(torch.stack([full0, lg_k[0].float().flatten()]))[0, 1])
        corr_r = float(torch.corrcoef(torch.stack([full0, lr.float().flatten()]))[0, 1])
        check(math.isfinite(corr) and math.isfinite(corr_r),
              f"KV {objective}: non-finite logit correlation")
        del pruned, cache, lg_full
        print(f"KV pruning ({objective}) on {cfg.name}: {B} x {S} -> {KV_BUDGET} "
              f"positions; |V'| {vp}, rounds {ss_k.rounds}; launches {counts}; "
              f"kernel route == plain route: "
              + ("yes" if not explained else "; ".join(explained))
              + f" (kept positions equal: {'yes' if same_kept else 'no'}; eps_hat, "
              f"gains before the first differing pick and f(S) of an equal kept "
              f"set: max abs err {route_err['eps_hat']:.3g}, "
              f"{route_err['gains']:.3g}, {route_err['value']:.3g}, within TOL); "
              f"row 0: {held}; prefill {t_prefill * 1e3:.4f} ms, prune {wall_prune * 1e3:.4f} ms "
              f"(host clock, synchronised, first call); decode {ms_pruned:.4f} ms a "
              f"step from the pruned cache against {ms_full:.4f} ms from the full "
              f"one; decode logits held to the plain attention at every step "
              f"(max err {rel:.4g} of max|logits|); peak device memory {peak:.2f} "
              f"GiB ({peak - base:.2f} above what the phase found allocated: the "
              f"parameters and the LM path's cache); first-step logits' "
              f"correlation with the full cache {corr:.6f}, a random {KV_BUDGET}-"
              f"position cache {corr_r:.6f}", flush=True)
        out[objective] = {"vprime": vp, "rounds": ss_k.rounds, "launches": counts,
                          "routes_equal": not explained, "explained": explained,
                          "route_max_abs_err": route_err, "kept_equal": same_kept,
                          "prefill_ms": t_prefill * 1e3, "prune_ms": wall_prune * 1e3,
                          "decode_ms_per_step": ms_pruned,
                          "full_decode_ms_per_step": ms_full, "peak_gib": peak,
                          "corr_pruned": corr, "corr_random": corr_r,
                          "max_rel_err_plain": rel}
    del p_cache
    return out


# -- the summarization service -------------------------------------------------

SVC_FAULT_N = 1 << 14              # the fault phase: 2 queries of 2^14 x 1024
CARD = [""]                        # nvidia-smi's name and power limit, set in main
T0 = [0.0]                         # the script's start (host clock), set in main


def _svc_kernels() -> dict:
    from repro_torch.kernels import (
        feature_gains_kernel, fl_divergence_kernel, fl_gains_kernel,
        ss_divergence_kernel,
    )

    return {"ss_divergence": ss_divergence_kernel, "feature_gains": feature_gains_kernel,
            "fl_divergence": fl_divergence_kernel, "fl_gains": fl_gains_kernel}


def _same_response(a, b, what: str) -> None:
    check(torch.equal(a.selected, b.selected) and torch.equal(a.gains, b.gains)
          and (a.value, a.vprime_size, a.eps_hat, a.rounds)
          == (b.value, b.vprime_size, b.eps_hat, b.rounds),
          f"service: {what} differs bit for bit")


def _same_as_row(resp, res, ss, b: int, what: str) -> None:
    """A response equals row b of a batched (or single, b = None) run."""
    sel, gains, value = ((res.selected, res.gains, res.value) if b is None
                         else (res.selected[b], res.gains[b], res.value[b]))
    check(torch.equal(resp.selected, sel) and torch.equal(resp.gains, gains)
          and resp.value == float(value), f"service: {what}: picks, gains or f(S) "
          "differ from the core's run")
    if ss is None:
        check(resp.vprime_size is None and resp.rounds is None,
              f"service: {what}: SS metadata without SS")
        return
    vp, eps, rounds = ((ss.vprime, ss.eps_hat, ss.rounds) if b is None
                       else (ss.vprime[b], ss.eps_hat[b], ss.rounds[b]))
    check(resp.vprime_size == int(vp.sum()) and resp.eps_hat == float(eps)
          and resp.rounds == rounds, f"service: {what}: |V'|, eps_hat or rounds "
          "differ from the core's run")


def _chunks(responses) -> list:
    """The chunks the responses rode in, one response each (a chunk's
    responses share its exec_s)."""
    seen = {}
    for r in responses:
        seen.setdefault((r.lane, r.exec_s), r)
    return list(seen.values())


def _want_launches(responses) -> dict:
    """The kernel launches a fault-free service run makes: each chunk runs
    its batch bucket's rows (padding included, each row with row 0's
    rounds), one divergence launch a row a round and one gains launch a row
    a step; ``use_ss=False`` lanes only the gains."""
    want = {"ss_divergence": 0, "feature_gains": 0, "fl_divergence": 0, "fl_gains": 0}
    by_chunk = {}
    for r in responses:
        by_chunk.setdefault((r.lane, r.exec_s), []).append(r)
    for (lane, _), rs in by_chunk.items():
        div, gains = (("ss_divergence", "feature_gains") if lane[0] == "coverage"
                      else ("fl_divergence", "fl_gains"))
        bucket = rs[0].batch_bucket
        want[gains] += bucket * lane[3]
        if lane[6]:
            rounds = [r.rounds for r in rs]
            check(len(set(rounds)) == 1, f"service: rows of one n with other "
                  f"rounds {rounds}")
            want[div] += bucket * rounds[0]
    return want


def _fault_free(label: str, svc, responses, launches: dict) -> None:
    """Tentpole's fault-free checks: no recovery or degradation record, no
    retry, failover, isolation or timeout, and the kernels' launches are the
    ones the chunks need (a failover to the plain route would leave them
    short)."""
    st = svc.stats()
    check(all(r.recovery is None and r.degradation is None for r in responses),
          f"{label}: a response carries a recovery or degradation record")
    bad = {k: st[k] for k in ("retries", "failovers", "isolated_queries",
                              "chunk_timeouts", "failed", "degraded") if st[k]}
    check(not bad, f"{label}: fault counters {bad} in a fault-free run")
    want = _want_launches(responses)
    check(launches == want, f"{label}: kernel launches {launches}, want {want}")


def _event_ms(call) -> tuple:
    """(result, ms) of one call between CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = call()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


CHUNK_TAIL_MS = 20.0   # a sleep on the card that ends each chunk's work in (a)


@contextlib.contextmanager
def _chunk_events(spans: list):
    """CUDA events around each chunk's own work inside the service: one
    recorded as the chunk builds its objective (its first device work),
    one after ``summarize_batch`` returns and a ``CHUNK_TAIL_MS`` sleep
    queued on the card behind its work (its last); ``spans`` gets [first
    request's seed, start, end] of each chunk in order.  The chunk's
    host-clock exec_s runs from before the first to after its synchronise,
    so a synchronised exec_s is at least the time between them on the card,
    whatever the host's load.  The chunk's own loop is host-bound (the card
    idles between its kernels, so its last kernel ends as the host returns),
    which alone would let an exec_s that stops at the enqueue pass: the
    sleep is device work that only a synchronise waits for."""
    import repro_torch.serve.summarize_service as svc_mod

    build, summ = svc_mod.build_batch_objective, svc_mod.summarize_batch

    def build_rec(reqs, *a, **kw):
        spans.append([reqs[0].seed, torch.cuda.Event(enable_timing=True)])
        spans[-1][1].record()
        return build(reqs, *a, **kw)

    def summ_rec(*a, **kw):
        out = summ(*a, **kw)
        torch.cuda._sleep(int(RATES["clock_hz"] * CHUNK_TAIL_MS / 1e3))
        spans[-1].append(torch.cuda.Event(enable_timing=True))
        spans[-1][2].record()
        return out

    svc_mod.build_batch_objective, svc_mod.summarize_batch = build_rec, summ_rec
    try:
        yield spans
    finally:
        svc_mod.build_batch_objective, svc_mod.summarize_batch = build, summ


def service_phase(fn) -> dict:
    """The summarization service on the card, at the lanes' sizes: (a) one
    sync flush of 8 coverage queries (2^16 x 1024 views of the news day), 3
    FL queries (2^13 frames of path A's video, cosine; bucket 4, one pad
    row) and 2 ``use_ss=False`` coverage queries, each response held bit
    for bit to the core's run; (b) the async scheduler over 32 coverage
    queries (16 slices x 2 seeds) and the 4 FL queries, some with
    deadlines, held to the sync engine; (c) faults at 2 x 2^14 x 1024:
    retries bit-identical, failover to the plain route on the card within
    TOL (or a differing decision explained in float64), the watchdog, a
    crash; (d) tracing changes no bit and its spans and metrics agree with
    the service."""
    from repro_torch import api, greedy, obs, summarize, video
    from repro_torch.serve import (
        Fault, FaultPlan, RunConfig, ServiceRestarted, SummarizeRequest,
        build_batch_objective, summarize_batch,
    )

    kernels = _svc_kernels()
    out = {"card": CARD[0]}
    W = fn.W
    t = time.perf_counter()
    X = video(0, N_A, F_A)[:FL_LANE_B * FL_LANE_N]
    t_video = time.perf_counter() - t

    def cov(b, seed, n=LANE_N, **kw):
        return SummarizeRequest(k=K, seed=seed, features=W[b * n:(b + 1) * n], **kw)

    def flq(b, seed, **kw):
        return SummarizeRequest(k=K, seed=seed, objective="fl", kernel="cosine",
                                features=X[b * FL_LANE_N:(b + 1) * FL_LANE_N], **kw)

    def gens(reqs):
        return [torch.Generator(device="cuda").manual_seed(r.seed) for r in reqs]

    def counted(call):
        for kern in kernels.values():
            kern.launches = 0
        res = call()
        return res, {name: kern.launches for name, kern in kernels.items()}

    # (a) one sync flush of three lanes
    cov_reqs = [cov(b, 100 + b) for b in range(LANE_B)]
    fl_reqs = [flq(b, 200 + b) for b in range(3)]
    noss_reqs = [cov(b, 300 + b, use_ss=False) for b in range(2)]
    svc = api.serve(RunConfig(max_batch=LANE_B), device="cuda")
    obs.reset()
    reqs_a = cov_reqs + fl_reqs + noss_reqs
    with _chunk_events([]) as spans:
        resp_a, launches_a = counted(lambda: svc.run(reqs_a))
    torch.cuda.synchronize()
    first = [sp for sp in spans if sp[0] == cov_reqs[0].seed]
    check(len(spans) == 3 and len(first) == 1 and len(first[0]) == 3,
          f"service (a): {len(spans)} chunks seen, want 3")
    dev_ms = first[0][1].elapsed_time(first[0][2])
    _fault_free("service (a)", svc, resp_a, launches_a)
    ra_cov, ra_fl, ra_noss = resp_a[:8], resp_a[8:11], resp_a[11:]
    check([r.batch_bucket for r in (ra_cov[0], ra_fl[0], ra_noss[0])] == [8, 4, 2]
          and ra_fl[0].batch_size == 3, "service (a): wrong batch buckets")
    fnb, _ = build_batch_objective(cov_reqs, None, device="cuda")
    (res_b, ss_b), ev_ms = _event_ms(lambda: summarize_batch(fnb, K, gens(cov_reqs),
                                                              r=R, c=C))
    for b, resp in enumerate(ra_cov):
        _same_as_row(resp, res_b, ss_b, b, f"(a) coverage row {b}")
    for i, (q, resp) in enumerate(zip(fl_reqs, ra_fl)):
        f1, _ = build_batch_objective([q], None, device="cuda")
        res1, ss1 = summarize(f1.row(0), K, gens([q])[0], r=R, c=C)
        _same_as_row(resp, res1, ss1, None, f"(a) FL query {i} (single-query run)")
    for i, resp in enumerate(ra_noss):
        f1, _ = build_batch_objective([noss_reqs[i]], None, device="cuda")
        _same_as_row(resp, greedy(f1.row(0), K), None, None,
                     f"(a) use_ss=False query {i} (greedy on V)")
    check(ra_cov[0].exec_s >= dev_ms / 1e3,
          f"service (a): exec_s {ra_cov[0].exec_s} s below the chunk's own work "
          f"between CUDA events in the service ({dev_ms:.4f} ms): not "
          "synchronised")
    # the lanes ran first, so this first chunk of a fresh service is warm
    # (a cold process's first chunk pays one-time costs: first_chunk_probe)
    check(ra_cov[0].exec_s <= 3 * ev_ms / 1e3,
          f"service (a): exec_s {ra_cov[0].exec_s} s above 3 times the chunk's "
          f"summarize_batch between events ({ev_ms:.4f} ms)")

    # host reads a chunk adds to summarize_batch's, at B = 8 and B = 2
    reads = {}
    for B_ in (LANE_B, 2):
        s2 = api.serve(RunConfig(max_batch=LANE_B), device="cuda")
        for q in cov_reqs[:B_]:
            s2.submit(q)
        f2, _ = build_batch_objective(cov_reqs[:B_], None, device="cuda")
        g2 = gens(cov_reqs[:B_])
        reads[B_] = (host_syncs(s2.flush),
                     host_syncs(lambda: summarize_batch(f2, K, g2, r=R, c=C)))
    extra = {b: s - c for b, (s, c) in reads.items()}
    check(len(set(extra.values())) == 1 and 0 < extra[LANE_B] <= 2,
          f"service (a): a chunk's host syncs above summarize_batch's {extra} "
          "(want one synchronise and one transfer at every B)")
    wall_svc = _median_wall(lambda: svc.run(cov_reqs))
    wall_core = _median_wall(lambda: summarize_batch(fnb, K, gens(cov_reqs), r=R, c=C))
    del fnb, res_b, ss_b
    prof = profile_run("service (a) run of the 8 coverage queries",
                       lambda: svc.run(cov_reqs), watch=("ss_divergence",
                                                         "feature_gains"), top=6)
    print(f"[{CARD[0]}] service (a), one sync flush: 8 coverage queries (8 x 2^16 "
          f"x 1024, bucket 8), 3 FL queries (2^13 frames, cosine, bucket 4, one pad "
          f"row; video set-up {t_video:.2f} s), 2 use_ss=False queries (bucket 2): "
          f"every response equals summarize_batch's row / the single-query run bit "
          f"for bit; no recovery or degradation; launches {launches_a}; host syncs "
          f"a chunk adds to summarize_batch's: {extra[LANE_B]} at B = 8, {extra[2]} "
          f"at B = 2 ({reads}); coverage chunk exec_s {ra_cov[0].exec_s:.4f} s "
          f"against its own work between CUDA events in the service "
          f"{dev_ms / 1e3:.4f} s (a {CHUNK_TAIL_MS:g} ms sleep on the card "
          f"included) and summarize_batch between events "
          f"{ev_ms / 1e3:.4f} s; "
          f"service.run of the 8 coverage queries {wall_svc:.4f} s against "
          f"summarize_batch alone {wall_core:.4f} s (host clock, synchronised, "
          f"median of 3)", flush=True)
    out["a"] = {"launches": launches_a, "host_syncs_above_core": extra,
                "exec_s": ra_cov[0].exec_s, "chunk_device_s": dev_ms / 1e3,
                "event_s": ev_ms / 1e3,
                "run_wall_s": wall_svc, "summarize_batch_wall_s": wall_core,
                "busy_ms": prof.get("busy_ms"), "profiled_wall_ms": prof.get("wall_ms"),
                "stats": svc.stats()}

    # (b) the async scheduler: 32 coverage queries and 4 FL queries
    reqs_b = [cov(b % 16, 400 + b, deadline_s=30.0 if b % 4 == 0 else None)
              for b in range(32)] + [flq(b, 500 + b, deadline_s=30.0 if b == 0 else None)
                                     for b in range(FL_LANE_B)]
    ref_b = api.serve(RunConfig(max_batch=LANE_B), device="cuda").run(reqs_b)
    svc_b = api.serve(RunConfig(max_batch=LANE_B, scheduler="async"), device="cuda")
    with svc_b:
        def run_b():
            tickets = [svc_b.submit(q) for q in reqs_b]
            svc_b.drain(timeout=300)
            return [tk.result(timeout=0) for tk in tickets]

        resp_b, launches_b = counted(run_b)
    for i, (a, b) in enumerate(zip(resp_b, ref_b)):
        _same_response(a, b, f"(b) async query {i} against the sync engine")
    _fault_free("service (b)", svc_b, resp_b, launches_b)
    delays = sorted(r.queue_delay_s for r in resp_b)
    p50 = delays[len(delays) // 2]
    p99 = delays[min(len(delays) - 1, math.ceil(0.99 * len(delays)) - 1)]
    st_b = svc_b.stats()
    check(st_b["deadlines_missed"] == 0, "service (b): a 30 s deadline was missed")
    print(f"[{CARD[0]}] service (b), async: 32 coverage queries (16 slices x 2 "
          f"seeds) + 4 FL queries, 9 with 30 s deadlines: responses equal the sync "
          f"engine's bit for bit; triggers {st_b['triggers']} over "
          f"{len(_chunks(resp_b))} chunks; queue delay p50 {p50:.4f} s, p99 "
          f"{p99:.4f} s; launches {launches_b}; stats {st_b}", flush=True)
    out["b"] = {"triggers": st_b["triggers"], "queue_delay_p50_s": p50,
                "queue_delay_p99_s": p99, "launches": launches_b, "stats": st_b}

    # (c) faults at 2 x 2^14 x 1024
    reqs_c = [cov(b, 600 + b, n=SVC_FAULT_N) for b in range(2)]
    clean = api.serve(RunConfig(max_batch=2), device="cuda").run(reqs_c)
    plan = FaultPlan({0: Fault("exec_error"), 1: Fault("malformed")})
    s_c = api.serve(RunConfig(max_batch=2, retry_backoff_s=0.002), faults=plan,
                    device="cuda")
    retried = s_c.run(reqs_c)
    for i, (a, b) in enumerate(zip(retried, clean)):
        _same_response(a, b, f"(c) query {i} after two retries")
        check(a.recovery == {"retries": 2, "stage": "primary", "backends": ("cuda",),
                             "isolated": False}, f"(c): recovery {a.recovery}")
    check(s_c.stats()["retries"] == 2, "service (c): retries not counted")

    s_f = api.serve(RunConfig(max_batch=2, max_retries=0),
                    faults=FaultPlan({0: Fault("exec_error")}), device="cuda")
    failed_over = s_f.run(reqs_c)
    check(s_f.stats()["failovers"] == 1 and all(
        r.recovery == {"retries": 1, "stage": "failover",
                       "backends": ("cuda", "reference"), "isolated": False}
        for r in failed_over), f"service (c): failover records "
        f"{[r.recovery for r in failed_over]}")
    route = []
    tol = TOL[torch.float32]
    for i, (q, k_resp, p_resp) in enumerate(zip(reqs_c, clean, failed_over)):
        f1, _ = build_batch_objective([q], None, device="cuda")
        f = f1.row(0)
        ss_k = summarize(f, K, gens([q])[0], r=R, c=C)[1]
        ss_p = summarize(f, K, gens([q])[0], r=R, c=C, backend="reference")[1]
        check(p_resp.vprime_size == int(ss_p.vprime.sum())
              and p_resp.eps_hat == float(ss_p.eps_hat),
              f"service (c): failed-over query {i} is not the plain route's run")
        differ = torch.nonzero(k_resp.selected != p_resp.selected).flatten()
        same_ss = torch.equal(ss_k.vprime, ss_p.vprime)
        note = "same V' and picks"
        if not same_ss or differ.numel():
            note = _explain_kv(f"service (c) query {i}", f, q.seed, K)
        if same_ss:
            upto = int(differ[0]) if differ.numel() else K
            div_size = float(f.singleton_gains().max() + f.residual_gains().abs().max())
            val_size = abs(p_resp.value)
            cases = [("eps_hat", abs(k_resp.eps_hat - p_resp.eps_hat), div_size),
                     ("gains", float((k_resp.gains[:upto] - p_resp.gains[:upto])
                                     .abs().max()) if upto else 0.0, val_size)]
            if not differ.numel():
                cases.append(("value", abs(k_resp.value - p_resp.value), val_size))
            for name, err, size in cases:
                check(err <= tol * max(1.0, size), f"service (c) query {i}: {name} "
                      f"of the failover (plain route) vs the kernel route err {err} "
                      f"> {tol * max(1.0, size)}")
                note += f"; {name} err {err:.3g}"
        route.append(note)

    hang = FaultPlan({0: Fault("hang", delay_s=4.0)})
    s_h = api.serve(RunConfig(max_batch=2, chunk_timeout_s=1.0), faults=hang,
                    device="cuda")
    t = time.perf_counter()
    hung = s_h.run(reqs_c)
    t_hang = time.perf_counter() - t
    check(all(r.recovery is not None and r.recovery["stage"] == "failover"
              for r in hung) and s_h.stats()["chunk_timeouts"] == 1,
          f"service (c): the hung chunk was not abandoned and failed over "
          f"({[r.recovery for r in hung]})")
    deadline = time.perf_counter() + 60
    while any(th.name == "summarize-chunk" and th.is_alive()
              for th in threading.enumerate()):
        check(time.perf_counter() < deadline, "service (c): the abandoned attempt "
              "did not end")
        time.sleep(0.1)
    check(s_h.stats()["queries"] == 2 and s_h.stats()["batches"] == 1 and all(
        r.recovery["stage"] == "failover" for r in hung),
        "service (c): the abandoned attempt's late result was not discarded")

    s_x = api.serve(RunConfig(max_batch=2), faults=FaultPlan({0: Fault("crash")}),
                    device="cuda")
    tickets = [s_x.submit(q) for q in reqs_c]
    s_x.flush()
    late = s_x.submit(reqs_c[0])
    check(all(tk.done() and isinstance(tk.exception(timeout=0), ServiceRestarted)
              for tk in tickets + [late]), "service (c): a crash left a ticket "
          "unsettled or settled it otherwise")
    print(f"[{CARD[0]}] service (c), faults at 2 x 2^14 x 1024: exec_error then "
          f"malformed retried, bit-identical to the fault-free run; max_retries=0 + "
          f"exec_error failed over to the plain route on the card (backends cuda, "
          f"reference): {route}; a hang under chunk_timeout_s = 1 s abandoned and "
          f"failed over in {t_hang:.2f} s, its late result discarded; a crash "
          f"settled every ticket with ServiceRestarted", flush=True)
    out["c"] = {"failover": route, "hang_run_s": t_hang}

    # (d) tracing on the coverage lane
    obs.reset()
    obs.configure(trace=True)
    try:
        s_d = api.serve(RunConfig(max_batch=LANE_B), device="cuda")
        traced, launches_d = counted(lambda: s_d.run(cov_reqs))
    finally:
        obs.configure(trace=False)
    for i, (a, b) in enumerate(zip(traced, ra_cov)):
        _same_response(a, b, f"(d) traced coverage query {i} against (a)")
    _fault_free("service (d)", s_d, traced, launches_d)
    tr = obs.get_tracer()
    for i in range(LANE_B):
        names = {sp.name for sp in tr.spans_for_request(i)}
        want = {"request.admit", "queue.wait", "chunk.exec", "ss.sparsify_batched",
                "greedy.select_batched"}
        check(want <= names, f"service (d): request {i}'s spans {names} miss "
              f"{want - names}")
    counted_q = obs.get_registry().get("repro_service_queries_total").value()
    check(counted_q == s_d.stats()["queries"] == LANE_B,
          f"service (d): metrics count {counted_q} queries, stats "
          f"{s_d.stats()['queries']}")
    (ss_span,) = tr.spans(name="ss.sparsify_batched")
    check(ss_span.attrs["rounds"] == [r.rounds for r in traced],
          "service (d): the SS span's rounds differ from the responses'")
    print(f"[{CARD[0]}] service (d), traced: the 8 coverage responses equal "
          f"untraced (a) bit for bit; every request's spans hold request.admit, "
          f"queue.wait, chunk.exec, ss.sparsify_batched, greedy.select_batched; "
          f"metrics count {counted_q:g} queries as stats does; ss.sparsify_batched "
          f"wall {ss_span.attrs['wall_s']:.4f} s, chunk exec_s "
          f"{traced[0].exec_s:.4f} s", flush=True)
    obs.reset()
    out["d"] = {"launches": launches_d, "exec_s": traced[0].exec_s,
                "ss_wall_s": ss_span.attrs["wall_s"]}
    return out


# -- durable streaming sessions ----------------------------------------------

# 16 sessions x 384 rows of news_day(0, 6144, 1024): the rows a session
# cut from 512 (the phase took 103-127 s, host-bound) to keep the script
# within its time; the torn-tail run below needs 300.
SESS_N, SESS_ROWS = 16, 384
SESS_CFG = dict(k=K, eps=0.2, n_features=F, phi="sqrt", buffer_cap=128,
                resparsify_every=40, ss_r=4, ss_c=8.0, max_batch=8, batch_c=4.0,
                snapshot_every=128)
SESS_CRASH_AT = 600                # a fault draw mid-stream (about 800 in all)
SESS_RESTARTS = (150, 300)         # of the restart run's 4 sessions (about 410)
SESS_BLOCK = 64                    # the eviction run's rows a session at a time


class _Compactions:
    """Records the SS compactions session engines run, through a transparent
    wrapper of ``ss_sparsify_batched`` in ``repro_torch.serve.sessions``:
    the rows' rounds (one ``ss_divergence`` launch a row a round) and, with
    ``keep``, each call's inputs (the stacked buffers, the live masks, each
    row's generator state before its draws) and result, for the route
    check."""

    def __init__(self, keep: bool = False):
        from repro_torch.serve import sessions

        self.mod, self.real, self.keep = sessions, sessions.ss_sparsify_batched, keep
        self.calls: list = []
        self.rounds = 0

    def __enter__(self) -> "_Compactions":
        def wrapped(fn, generators=None, **kw):
            states = [g.get_state() for g in generators] if self.keep else None
            ss = self.real(fn, generators, **kw)
            self.rounds += sum(ss.rounds)
            if self.keep:
                self.calls.append((fn.W.clone(), kw["alive"].clone(), states, ss))
            return ss

        self.mod.ss_sparsify_batched = wrapped
        return self

    def __exit__(self, *exc) -> None:
        self.mod.ss_sparsify_batched = self.real


def _sess_gens(states) -> list:
    gens = []
    for st in states:
        g = torch.Generator(device="cuda")
        g.set_state(st)
        gens.append(g)
    return gens


def _open_all(eng, streams) -> None:
    for sid in streams:
        eng.open_session(sid=sid, key=int(sid[1:]))


def _ingest(eng, streams, start=None, block: int = 1) -> None:
    """Append every stream round robin, ``block`` rows of a session at a
    time, each from its row ``start[sid]`` on (default 0); then flush."""
    start = start or {}
    for r0 in range(0, SESS_ROWS, block):
        for sid, rows in streams.items():
            for r in range(max(r0, start.get(sid, 0)), r0 + block):
                eng.append(sid, rows[r])
    eng.flush()


def _same_session(label: str, eng, sid: str, state, summary=None) -> None:
    """``eng``'s state of ``sid`` (and its summary) equal ``state`` (and
    ``summary``) bit for bit, leaf for leaf."""
    import numpy as np

    got = eng.state(sid)
    for i, (a, b) in enumerate(zip([*got.sieve, *got[1:]], [*state.sieve, *state[1:]])):
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"{label}: session {sid}'s state leaf {i} differs")
    if summary is not None:
        s = eng.summary(sid)
        check(np.array_equal(s.selected, summary.selected)
              and np.array_equal(s.gains, summary.gains)
              and (s.value, s.sieve_value, s.retained, s.seen, s.drops, s.resparsifies)
              == (summary.value, summary.sieve_value, summary.retained, summary.seen,
                  summary.drops, summary.resparsifies),
              f"{label}: session {sid}'s summary differs")


def _sess_fault_free(label: str, eng) -> dict:
    st = eng.stats()
    bad = {k: st[k] for k in ("restarts", "crashes", "snapshot_fallbacks",
                              "wal_truncations") if st[k]}
    check(not bad, f"{label}: fault counters {bad} in a fault-free run")
    return st


def _session_routes(calls, states: dict, summaries: dict) -> dict:
    """The kernel route against the plain route (backend "reference" on the
    card) on the same inputs: every recorded compaction replayed with the
    same draws (the kernel route bit for bit, the plain route's kept set
    equal with eps_hat within TOL of the divergences' size, or a differing
    prune cut explained in float64), and every session's summary greedy
    over its final buffer (the same picks with gains and f(S) within TOL,
    or a differing argmax explained)."""
    import numpy as np

    from repro_torch import FeatureCoverage, greedy
    from repro_torch.core.sparsify import ss_sparsify_batched

    cfg, tol = SESS_CFG, TOL[torch.float32]
    notes, eps_err, rows = [], 0.0, 0
    for W, alive, gen_states, ss in calls:
        runs = {be: ss_sparsify_batched(FeatureCoverage(W=W), _sess_gens(gen_states),
                                        r=cfg["ss_r"], c=cfg["ss_c"], alive=alive,
                                        backend=be) for be in ("cuda", "reference")}
        check(torch.equal(runs["cuda"].vprime, ss.vprime)
              and torch.equal(runs["cuda"].eps_hat, ss.eps_hat),
              "sessions: a compaction's kernel-route replay differs from its run")
        plain = runs["reference"]
        for b in range(W.shape[0]):
            rows += 1
            f = FeatureCoverage(W=W[b])
            if torch.equal(plain.vprime[b], ss.vprime[b]):
                size = float(f.singleton_gains().max() + f.residual_gains().abs().max())
                err = abs(float(plain.eps_hat[b] - ss.eps_hat[b]))
                check(err <= tol * max(1.0, size), f"sessions: compaction eps_hat of "
                      f"the plain route vs the kernel route err {err}")
                eps_err = max(eps_err, err)
                continue
            note, _ = _explain_ss("sessions compaction", f, _sess_gens(gen_states[b:b + 1])[0],
                                  alive[b], r=cfg["ss_r"], c=cfg["ss_c"])
            check(note is not None, "sessions: the routes keep other rows, but no "
                  "prune cut differs in lockstep")
            notes.append(note)
    val_err, picks_same = 0.0, 0
    for sid, st in states.items():
        s = summaries[sid]
        f = FeatureCoverage(W=st.buf)
        alive = torch.arange(cfg["buffer_cap"], device="cuda") < st.buf_len
        plain = greedy(f, cfg["k"], alive=alive, backend="reference")
        n_sel = min(cfg["k"], s.retained)
        ids = st.buf_ids[plain.selected[:n_sel]].cpu().numpy()
        gains = plain.gains[:n_sel].cpu().numpy()
        differ = np.nonzero(ids != s.selected)[0]
        upto = int(differ[0]) if differ.size else n_sel
        size = abs(s.value)
        err = float(np.abs(gains[:upto] - s.gains[:upto]).max()) if upto else 0.0
        if not differ.size:
            err = max(err, abs(float(plain.value) - s.value))
            picks_same += 1
        check(err <= tol * max(1.0, size), f"sessions: {sid}'s summary on the plain "
              f"route vs the kernel route err {err}")
        val_err = max(val_err, err)
        if differ.size:
            notes.append(_explain_greedy(f"sessions summary {sid}", f, alive, cfg["k"]))
    return {"compaction_rows": rows, "eps_hat_err": eps_err, "summary_err": val_err,
            "same_picks": picks_same, "explained": notes}


def session_phase(errs: dict) -> dict:
    """The durable session tier on the card (``api.sessions``):
    ``SESS_N`` sessions of ``SESS_ROWS`` consecutive news rows each,
    appended round robin under ``SESS_CFG`` (k = 32, F = 1024, a buffer of
    128 compacted by SS every 40 inserts, snapshots every 128) on a durable
    root in a temporary directory.  (a) Ingest and summaries: the launches
    (counts set to 0 just before, read just after) equal the compactions'
    rows x rounds and k a summary; a B = 1 replay of four sessions equals
    them bit for bit; the kernel route against the plain route on every
    compaction's and summary's inputs (``_session_routes``); the kernels
    against their plain versions at one buffer's shapes.  (b) Durability: a
    crash mid-stream, recovery by a fresh engine and the rest of the
    streams; two restarts; a WAL torn inside its last record.  (c) The
    eviction ladder at 4 live sessions.  (d) Traced.  Every final state and
    summary equals (a)'s bit for bit; the fault-free runs fail on any fault
    counter.  Also the host syncs of one wave, a profile of 16 waves, and
    walls, snapshot and WAL sizes, recovery, peak memory."""
    import os
    import tempfile

    from repro_torch import FeatureCoverage, api, greedy, news_day, obs
    from repro_torch.kernels import feature_gains_kernel, ss_divergence_kernel
    from repro_torch.serve import Fault, FaultPlan, ServiceRestarted, SessionConfig

    t_phase = time.perf_counter()
    kern = {"ss_divergence": ss_divergence_kernel, "feature_gains": feature_gains_kernel}

    def zero():
        for k_ in kern.values():
            k_.launches = 0

    def counts():
        return {name: k_.launches for name, k_ in kern.items()}

    cfg = SessionConfig(**SESS_CFG)
    W = news_day(0, SESS_N * SESS_ROWS, F)
    streams = {f"u{i:03d}": W[i * SESS_ROWS:(i + 1) * SESS_ROWS] for i in range(SESS_N)}
    sids = list(streams)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build)
    root = Path(tmp.name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = {"card": CARD[0], "sessions": SESS_N, "rows": SESS_ROWS}
    try:
        # host syncs of one wave of 8 sessions, and a profile of 16 waves
        eng_s = api.sessions(SessionConfig(**{**SESS_CFG, "flush_every": 100}),
                             device="cuda")
        eight = {sid: streams[sid] for sid in sids[:8]}
        _open_all(eng_s, eight)

        def one_row(t):
            for sid, rows in eight.items():
                eng_s.append(sid, rows[t])

        one_row(0)
        eng_s.flush()
        one_row(1)
        flush_syncs = host_syncs(eng_s.flush)
        one_row(2)
        wave_syncs = host_syncs(lambda: eng_s._exec_wave(list(eight), False))
        check(wave_syncs == 0 and flush_syncs == 2, f"sessions: a wave synchronises "
              f"{wave_syncs} times and its flush {flush_syncs} (want 0 and 2: the "
              "two due checks' transfers)")

        def sixteen_waves():
            for t in range(3, 19):
                one_row(t)
                eng_s.flush()

        prof = profile_run("sessions: 16 waves of 8 sessions (one row each)",
                           sixteen_waves, top=6)

        # (a) ingest and summaries
        eng_a = api.sessions(cfg, str(root / "a"), device="cuda")
        _open_all(eng_a, streams)
        obs.reset()
        zero()
        with _Compactions(keep=True) as comp_a:
            _, wall_a = _synced(lambda: _ingest(eng_a, streams))
            summaries = {sid: eng_a.summary(sid) for sid in sids}
        launches_a = counts()
        st_a = _sess_fault_free("sessions (a)", eng_a)
        check(st_a["rehydrations"] == 0 and st_a["evictions"] == 0,
              f"sessions (a): rehydrations or evictions without pressure: {st_a}")
        check(comp_a.rounds > 0 and st_a["resparsifies"] >= SESS_N,
              f"sessions (a): {st_a['resparsifies']} compactions, {comp_a.rounds} "
              "rounds: SS did no real work")
        want = {"ss_divergence": comp_a.rounds, "feature_gains": K * SESS_N}
        check(all(s.retained > 0 for s in summaries.values()) and launches_a == want,
              f"sessions (a): launches {launches_a}, want {want}")
        states = {sid: eng_a.state(sid) for sid in sids}
        snap = obs.get_registry().get("repro_sessions_snapshot_seconds").stats()
        sdir = root / "a" / sids[0]
        snap_bytes = os.path.getsize(sdir / max(n for n in os.listdir(sdir)
                                                if n.startswith("snap-")))
        wal_bytes = sum(os.path.getsize(root / "a" / s / "wal.log") for s in sids)

        four = [sids[0], sids[5], sids[10], sids[15]]
        eng_1 = api.sessions(SessionConfig(**{**SESS_CFG, "max_batch": 1}), device="cuda")
        _open_all(eng_1, {s: streams[s] for s in four})
        _, wall_1 = _synced(lambda: _ingest(eng_1, {s: streams[s] for s in four}))
        for sid in four:
            _same_session("sessions (a) B = 1 replay", eng_1, sid, states[sid],
                          summaries[sid])
        check(eng_1.stats()["wave_slots"] == eng_1.stats()["waves"],
              "sessions (a): the replay's waves were not B = 1")
        route = _session_routes(comp_a.calls, states, summaries)
        st0 = states[sids[0]]
        f0 = FeatureCoverage(W=st0.buf)
        alive0 = torch.arange(SESS_CFG["buffer_cap"], device="cuda") < st0.buf_len
        hooks = _hooks_vs_plain("sessions", f0, ("ss_divergence", "feature_gains"),
                                alive0, greedy(f0, K, alive=alive0).state, errs, 23)
        print(f"[{CARD[0]}] sessions (a): {SESS_N} sessions x {SESS_ROWS} news rows "
              f"(F = {F}, k = {K}, buffer 128, SS every 40 inserts, r = 4, c = 8, "
              f"snapshots every 128), round robin: {SESS_N * SESS_ROWS / wall_a:.1f} "
              f"appends/s ({wall_a:.3f} s, synchronised); {st_a['waves']} waves, "
              f"{wall_a / st_a['waves'] * 1e3:.4f} ms a wave (mean, WAL, checks and "
              f"snapshots included); host syncs a one-wave flush {flush_syncs}, the "
              f"wave alone {wave_syncs}; {st_a['resparsifies']} compactions, "
              f"{comp_a.rounds} SS rounds; launches {launches_a} (ingest and 16 "
              f"summaries); {st_a['snapshots']} snapshots, {snap['mean'] * 1e3:.4f} "
              f"ms each (mean), {snap_bytes} bytes; WAL {wal_bytes} bytes; B = 1 "
              f"replay of {four} equal bit for bit ({wall_1:.3f} s); routes: "
              f"{route['compaction_rows']} compaction rows, eps_hat err "
              f"{route['eps_hat_err']:.3g}, {route['same_picks']} of {SESS_N} "
              f"summaries the same picks, err {route['summary_err']:.3g}, explained "
              f"{route['explained']}; {hooks}", flush=True)
        out["a"] = {"appends_per_s": SESS_N * SESS_ROWS / wall_a, "wall_s": wall_a,
                    "waves": st_a["waves"], "ms_per_wave_mean": wall_a / st_a["waves"] * 1e3,
                    "flush_syncs": flush_syncs, "wave_syncs": wave_syncs,
                    "compactions": st_a["resparsifies"], "ss_rounds": comp_a.rounds,
                    "launches": launches_a, "snapshots": st_a["snapshots"],
                    "snapshot_ms_mean": snap["mean"] * 1e3, "snapshot_bytes": snap_bytes,
                    "wal_bytes": wal_bytes, "b1_replay_wall_s": wall_1, "route": route,
                    "busy_ms": prof.get("busy_ms"), "profiled_wall_ms": prof.get("wall_ms")}
        del comp_a

        # (b) durability: a crash mid-stream, two restarts, a torn WAL tail
        eng_b = api.sessions(cfg, str(root / "b"),
                             faults=FaultPlan({SESS_CRASH_AT: Fault("crash")}),
                             device="cuda")
        _open_all(eng_b, streams)
        try:
            _ingest(eng_b, streams)
            crashed = False
        except ServiceRestarted:
            crashed = True
        check(crashed, f"sessions (b): the crash at attempt {SESS_CRASH_AT} never fired")
        rec = api.sessions(cfg, str(root / "b"), device="cuda")
        check(rec.sessions() == sids, f"sessions (b): sessions lost: {rec.sessions()}")
        (done, t_rec) = _synced(lambda: {sid: int(rec.state(sid).sieve.t) for sid in sids})
        replayed = sum(e["replayed"] for e in rec.events if e["step"] == "rehydrate")
        _ingest(rec, streams, start=done)
        for sid in sids:
            _same_session("sessions (b) after the crash", rec, sid, states[sid],
                          summaries[sid])

        first4 = {s: streams[s] for s in sids[:4]}
        eng_r = api.sessions(cfg, str(root / "r"), device="cuda", faults=FaultPlan(
            {i: Fault("restart") for i in SESS_RESTARTS}))
        _open_all(eng_r, first4)
        _ingest(eng_r, first4)
        check(eng_r.stats()["restarts"] == len(SESS_RESTARTS),
              f"sessions (b): restarts {eng_r.stats()['restarts']}")
        for sid in first4:
            _same_session("sessions (b) after two restarts", eng_r, sid, states[sid],
                          summaries[sid])

        sid, rows = sids[0], streams[sids[0]]
        tcfg = SessionConfig(**{**SESS_CFG, "tolerate_torn_tail": True})
        half = api.sessions(tcfg, str(root / "t"), device="cuda")
        half.open_session(sid=sid, key=0)
        for r in range(300):
            half.append(sid, rows[r])
        half.flush()
        del half
        wal_path = root / "t" / sid / "wal.log"
        os.truncate(wal_path, os.path.getsize(wal_path) - 7)
        torn = api.sessions(tcfg, str(root / "t"), device="cuda")
        check(int(torn.state(sid).sieve.t) == 299, "sessions (b): the torn tail "
              "lost more than its record")
        (ev,) = [e for e in torn.events if e["step"] == "wal_truncate"]
        check(ev["dropped_bytes"] == 21 + 4 * F - 7
              and os.path.getsize(wal_path) == ev["valid_end"],
              f"sessions (b): wal_truncate {ev}")
        for r in range(299, SESS_ROWS):
            torn.append(sid, rows[r])
        torn.flush()
        del torn
        _same_session("sessions (b) after the torn tail", api.sessions(
            cfg, str(root / "t"), device="cuda"), sid, states[sid], summaries[sid])
        print(f"[{CARD[0]}] sessions (b): a crash at fault attempt {SESS_CRASH_AT} "
              f"after {sum(done.values())} applied elements; recovery of {SESS_N} "
              f"sessions by a fresh engine {t_rec * 1e3:.2f} ms ({replayed} elements "
              f"replayed after the snapshots), then the rest of the streams: every "
              f"state and summary equal to (a)'s bit for bit, no session lost; "
              f"restarts at attempts {SESS_RESTARTS} over 4 sessions, equal; a WAL "
              f"cut 7 bytes inside its last record recovered with tolerate_torn_tail "
              f"(wal_truncate dropped {ev['dropped_bytes']} bytes), {SESS_ROWS - 299} "
              f"later appends "
              f"survive a strict reopen, equal", flush=True)
        out["b"] = {"crash_at": SESS_CRASH_AT, "applied_at_crash": sum(done.values()),
                    "recovery_ms": t_rec * 1e3, "replayed": replayed,
                    "restarts": eng_r.stats()["restarts"], "torn_dropped": ev["dropped_bytes"]}

        # (c) the eviction ladder: 4 live sessions of 16
        eng_c = api.sessions(SessionConfig(**{**SESS_CFG, "max_live_sessions": 4}),
                             str(root / "c"), device="cuda")
        _open_all(eng_c, streams)
        zero()
        with _Compactions() as comp_c:
            _, wall_c = _synced(lambda: _ingest(eng_c, streams, block=SESS_BLOCK))
        launches_c = counts()
        st_c = _sess_fault_free("sessions (c)", eng_c)
        check(st_c["evictions"] > 0 and st_c["rehydrations"] > 0
              and st_c["live_sessions"] <= 4, f"sessions (c): ladder stats {st_c}")
        check(launches_c == {"ss_divergence": comp_c.rounds, "feature_gains": 0}
              and comp_c.rounds == out["a"]["ss_rounds"],
              f"sessions (c): launches {launches_c}, rounds {comp_c.rounds} (a: "
              f"{out['a']['ss_rounds']})")
        for sid in sids:
            _same_session("sessions (c) under eviction", eng_c, sid, states[sid])
        print(f"[{CARD[0]}] sessions (c), max_live_sessions = 4, {SESS_BLOCK} rows a "
              f"session at a time: {st_c['evictions']} evictions, "
              f"{st_c['rehydrations']} rehydrations, wall {wall_c:.3f} s; every "
              f"state equal to (a)'s bit for bit; launches {launches_c}", flush=True)
        out["c"] = {"evictions": st_c["evictions"], "rehydrations": st_c["rehydrations"],
                    "wall_s": wall_c, "launches": launches_c}

        # (d) traced, 4 sessions
        obs.reset()
        obs.configure(trace=True)
        try:
            eng_d = api.sessions(cfg, str(root / "d"), device="cuda")
            _open_all(eng_d, first4)
            zero()
            with _Compactions() as comp_d:
                _, wall_d = _synced(lambda: _ingest(eng_d, first4))
                summ_d = {s: eng_d.summary(s) for s in first4}
            launches_d = counts()
            rec_d = api.sessions(cfg, str(root / "d"), device="cuda")
            rec_d.state(sids[0])
        finally:
            obs.configure(trace=False)
        _sess_fault_free("sessions (d)", eng_d)
        check(launches_d == {"ss_divergence": comp_d.rounds, "feature_gains": K * 4},
              f"sessions (d): launches {launches_d}")
        for sid in first4:
            _same_session("sessions (d) traced", eng_d, sid, states[sid], summaries[sid])
            check(summ_d[sid].value == summaries[sid].value, "sessions (d): a summary "
                  "changed under tracing")
        tr = obs.get_tracer()
        names = {sp.name for sp in tr.spans()}
        want_spans = {"sessions.wave", "sessions.resparsify", "sessions.snapshot",
                      "sessions.recover"}
        check(want_spans <= names, f"sessions (d): spans {names} miss "
              f"{want_spans - names}")
        wave_ms = statistics.median(sp.wall_s * 1e3 for sp in tr.spans(name="sessions.wave"))
        obs.reset()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        wall = time.perf_counter() - t_phase
        print(f"[{CARD[0]}] sessions (d), traced (4 sessions): states and summaries "
              f"equal (a)'s bit for bit; spans {sorted(want_spans)} present; median "
              f"{wave_ms:.4f} ms a wave of 4 (sessions.wave, synchronised); wall "
              f"{wall_d:.3f} s; peak memory above the phase's start {peak:.1f} MiB; "
              f"the phase's wall {wall:.2f} s", flush=True)
        out["d"] = {"median_wave_ms": wave_ms, "wall_s": wall_d, "launches": launches_d}
        out.update(peak_mib=peak, phase_wall_s=wall)
    finally:
        tmp.cleanup()
    return out


def first_chunk_probe(warm_first: bool) -> dict:
    """The service phase's first coverage chunk in a fresh process, alone
    (``python3 chip_smoke.py --first-chunk cold|warmed``): a fresh service's
    first chunk (8 x 2^16 x 1024 views of a news day already on the card),
    its ``exec_s`` against the same chunk's ``summarize_batch`` between
    events just after, the lane's EWMA estimate after each of two chunks,
    and a second fresh service's first chunk.  ``warmed`` first pays, one
    at a time and timed to a synchronised card, what a process's first
    call pays once: the CUDA context, the caching allocator's 2 GiB segment
    for the stacked W, and the first use of each kernel and PyTorch
    operation (the same lane at 2^12 sentences a query, run twice)."""
    from repro_torch import api, news_day
    from repro_torch.serve import RunConfig, SummarizeRequest, build_batch_objective
    from repro_torch.serve import summarize_batch

    out = {"card": CARD[0], "mode": "warmed" if warm_first else "cold"}

    def synced(call):
        torch.cuda.synchronize()
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    if warm_first:
        out["context_s"] = synced(lambda: torch.zeros(1, device="cuda"))
    W = torch.from_numpy(news_day(0, LANE_B * LANE_N, F)).to("cuda")
    torch.cuda.synchronize()

    def cov(n):
        return [SummarizeRequest(k=K, seed=100 + b, features=W[b * n:(b + 1) * n])
                for b in range(LANE_B)]

    def core(reqs):
        fnb, _ = build_batch_objective(reqs, None, device="cuda")
        gens = [torch.Generator(device="cuda").manual_seed(q.seed) for q in reqs]
        return summarize_batch(fnb, K, gens, r=R, c=C)

    reqs = cov(LANE_N)
    if warm_first:
        out["stack_alloc_s"] = synced(lambda: torch.empty(
            (LANE_B, LANE_N, F), device="cuda").fill_(0.0))
        small = cov(1 << 12)
        out["small_first_s"] = synced(lambda: core(small))
        out["small_second_s"] = synced(lambda: core(small))
    svc = api.serve(RunConfig(max_batch=LANE_B), device="cuda")
    lane = svc._lane(reqs[0])
    first = svc.run(reqs)[0]
    est_first = svc._exec_est[(lane, 0)]
    _, ev_ms = _event_ms(lambda: core(reqs))
    second = svc.run(reqs)[0]
    est_second = svc._exec_est[(lane, 0)]
    fresh = api.serve(RunConfig(max_batch=LANE_B), device="cuda").run(reqs)[0]
    check(all(r.recovery is None and r.degradation is None
              for r in (first, second, fresh)), "first chunk probe: a recovery "
          "or degradation record")
    out.update(first_exec_s=first.exec_s, event_s=ev_ms / 1e3,
               ewma_after_first_s=est_first, second_exec_s=second.exec_s,
               ewma_after_second_s=est_second, fresh_service_exec_s=fresh.exec_s)
    print(f"[{CARD[0]}] first chunk probe ({out['mode']}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()
                      if isinstance(v, float)), flush=True)
    return out


# -- the examples: video summaries, KV pruning on qwen2-7b, SS-selected training

EX_FRAMES = 9721          # Table 2's longest video (benchmarks/table2_video.py:17-19)
EX_KV_FULL = ("--config", "full", "--prompt-len", "2048", "--budget", "512")
# the same at the reference's default budget (``KVSelectConfig``), which SS's
# |V'| of about 300 positions can fill: at 512 greedy runs out of V'
EX_KV_FULL_256 = EX_KV_FULL[:-1] + ("256",)
EX_KV_B, EX_KV_NEW = 2, 32     # qwen2-7b served as the other LMs (``_serve``)
EX_TRAIN_STEPS = 100


def _ex_kernels() -> dict:
    """The kernels the examples' paths launch, by record name."""
    from repro_torch.kernels import (
        feature_gains_kernel, flash_attention_bwd_kernel, flash_attention_kernel,
        ss_divergence_kernel,
    )

    return {"ss_divergence": ss_divergence_kernel, "feature_gains": feature_gains_kernel,
            "flash_attention": flash_attention_kernel,
            "flash_attention_bwd": flash_attention_bwd_kernel}


def _example(name: str, argv: list) -> tuple[dict, dict]:
    """``examples/<name>.py``'s ``main(argv)`` on the card, its asserts
    included and its output printed, with every count of ``_ex_kernels``
    set to 0 just before and read just after.  Returns (the results its
    ``main`` hands back, the launches: each kernel's and, for the flash
    kernels, ``<name>_tc``)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kernels = _ex_kernels()
    for k_ in kernels.values():
        k_.launches = 0
        if hasattr(k_, "launches_tc"):
            k_.launches_tc = 0
    print(f"$ python examples/{name}.py {' '.join(argv)}", flush=True)
    results = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    rc = mod.main(list(argv), results)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check(rc == 0, f"examples/{name}.py exited {rc}")
    launches = {n_: k_.launches for n_, k_ in kernels.items()}
    launches.update({f"{n_}_tc": k_.launches_tc for n_, k_ in kernels.items()
                     if hasattr(k_, "launches_tc")})
    print(f"examples/{name}.py on the card ({CARD[0]}): {wall:.2f} s; launches "
          + ", ".join(f"{n_} {v}" for n_, v in launches.items()), flush=True)
    results["wall_s"], results["launches"] = wall, launches
    return results, launches


def _ex_launched(label: str, launches: dict, names: tuple, none=()) -> None:
    """Each kernel of ``names`` launched on the example's path, those of
    ``none`` not once."""
    for n_ in names:
        check(launches[n_] > 0, f"{label}: {n_} was never launched")
    for n_ in none:
        check(launches[n_] == 0, f"{label}: {n_} launched {launches[n_]} times")


def _ex_video() -> dict:
    """``video_summarize_torch.py --frames 9721``: SS and greedy on the
    kernels; the plain backend under the same draws gives the same V' and
    picks, or each first differing decision is shown a near tie in float64
    (``_explain_ss``, ``_explain_greedy``); equal picks give f(S) within
    TOL."""
    from repro_torch.configs.paper_ss import DEFAULT

    res, launches = _example("video_summarize_torch",
                             ["--device", "cuda", "--frames", str(EX_FRAMES)])
    _ex_launched("video", launches, ("ss_divergence", "feature_gains"),
                 ("flash_attention", "flash_attention_bwd"))
    fn, k, par = res["fn"], res["k"], res["parity"]
    check(k == int(DEFAULT.summary_frac * EX_FRAMES) and par is not None,
          "video: the budget or the route comparison is missing")
    notes = {}
    if not par["greedy_v"]:
        notes["greedy_v"] = _explain_greedy("video greedy on V", fn, torch.ones(
            fn.n, dtype=torch.bool, device="cuda"), k)
    if not par["vprime"]:
        notes["vprime"], _ = _explain_ss(      # SS's draws: the example's --seed 0
            "video SS", fn, torch.Generator(device="cuda").manual_seed(0),
            r=DEFAULT.r, c=DEFAULT.c)
        check(notes["vprime"] is not None, "video: V' differs, but no prune cut "
              "differs in lockstep")
    elif not par["greedy_vprime"]:
        notes["greedy_vprime"] = _explain_greedy("video greedy on V'", fn,
                                                 res["ss"].vprime, k)
    for what, value, plain in (("greedy_v", res["full"].value, par["plain_values"][0]),
                               ("greedy_vprime", res["reduced"].value,
                                par["plain_values"][1])):
        if par[what] and (what == "greedy_v" or par["vprime"]):
            check(abs(float(value) - plain) <= TOL[torch.float32] * abs(plain),
                  f"video {what}: f(S) {float(value)} vs plain {plain}")
    for what, note in notes.items():
        print(f"video, kernel vs plain route, {what}: {note}", flush=True)
    f1 = res["f1"]
    check(all(0.0 <= v <= 1.0 for v in f1.values()) and math.isfinite(res["relative"])
          and 0 < res["vprime_size"] < EX_FRAMES, "video: a result is out of range")
    return {"frames": EX_FRAMES, "k": k, "vprime": res["vprime_size"],
            "relative": res["relative"], "f1": f1, "greedy_s": res["t_full"],
            "ss_greedy_s": res["t_ss"], "routes": {w: par[w] for w in (
                "vprime", "greedy_v", "greedy_vprime")},
            "near_ties": notes, "wall_s": res["wall_s"], "launches": launches}


def _ex_kv(argv: tuple, serve: bool, errs: dict) -> dict:
    """``serve_kv_pruning_torch.py`` (its assert: the service keeps the
    positions ``prune_kv`` keeps, kernel against kernel); ``serve``: its
    parameters (qwen2-7b at full width and depth) then serve the LM main
    path (``_serve``: TTFT, decode, peaks), are held to the plain attention
    route at every step (``_plain_route``) and give the flash kernels their
    shape (``_flash_at_shape``)."""
    from repro_torch.kernels import flash_route
    from repro_torch.models.layers import dtype_of, tree_leaves

    res, launches = _example("serve_kv_pruning_torch", ["--device", "cuda", *argv])
    cfg = res["cfg"]
    n_attn = cfg.num_layers
    tc = n_attn if flash_route(dtype_of(cfg.compute_dtype), cfg.head_dim) == "tc" else 0
    _ex_launched(f"KV {cfg.name}", launches,
                 ("ss_divergence", "feature_gains", "flash_attention"),
                 ("flash_attention_bwd",))
    check(launches["flash_attention"] == n_attn and launches["flash_attention_tc"] == tc,
          f"KV {cfg.name}: {launches['flash_attention']} flash launches "
          f"({launches['flash_attention_tc']} tensor-core), not one a layer of the "
          f"prefill ({n_attn}, {tc} tensor-core)")
    for name in ("ref", "out_ss", "out_random"):
        check(bool(torch.isfinite(res[name]).all()), f"KV {cfg.name}: {name} not finite")
    out = {"arch": cfg.name, "head_dim": cfg.head_dim, "dtype": cfg.compute_dtype,
           "prompt": int(res["tokens"].shape[1]), "budget": int(res["kept"].shape[1]),
           "vprime": [r.vprime_size for r in res["responses"]],
           "distinct_kept": [len(set(row.tolist())) for row in res["kept"]],
           "mse_ss": res["mse_ss"], "mse_random": res["mse_random"],
           "agree_ss": res["agree_ss"], "agree_random": res["agree_random"],
           "wall_s": res["wall_s"], "launches": launches}
    if not serve:
        return out
    params = res["params"]
    res.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    S = out["prompt"]
    run = _serve(cfg, params, EX_KV_B, S, EX_KV_NEW)
    seen = []
    rel = _plain_route(cfg, params, run["prompts"], run["toks"], run["step_logits"],
                       run["sc"].max_len, seen)
    out.update({k_: run[k_] for k_ in ("prefill_ms", "ttft_ms", "decode_ms_per_step",
                                       "tokens_per_s", "peak_gib", "prefill_peak_gib",
                                       "decode_peak_gib")}, plain_rel=rel,
               params=sum(t_.numel() for t_ in tree_leaves(params)))
    del run
    q, k, v = seen.pop()
    out["flash_at_shape"] = _flash_at_shape(cfg, q, k, v, 0, errs)
    del q, k, v, params
    torch.cuda.empty_cache()
    return out


def _ex_train() -> dict:
    """``train_lm_ss_torch.py --steps 100``, both selections, on the FFMA
    flash kernels (float32 at head_dim 32) forward and backward; SS keeps
    each pool of 32 whole (``ss_divergence`` never launched), greedy on the
    pool launches ``feature_gains``; the loss falls."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_example_")
    try:
        res, launches = _example("train_lm_ss_torch", [
            "--device", "cuda", "--steps", str(EX_TRAIN_STEPS), "--ckpt-root", root])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _ex_launched("train example", launches,
                 ("feature_gains", "flash_attention", "flash_attention_bwd"),
                 ("ss_divergence", "flash_attention_tc", "flash_attention_bwd_tc"))
    out = {"steps": EX_TRAIN_STEPS, "wall_s": res.pop("wall_s"),
           "launches": res.pop("launches")}
    for sel, r in res.items():
        check(r["config"].head_dim == 32 and r["steps_done"] == EX_TRAIN_STEPS,
              f"train example [{sel}]: not the head_dim-32 config or not every step")
        losses = [h["loss"] for h in r["history"]]
        check(all(map(math.isfinite, losses + [r["eval"]])) and losses[-1] < losses[0],
              f"train example [{sel}]: the loss did not fall ({losses})")
        out[sel] = {"losses": {h["step"]: h["loss"] for h in r["history"]},
                    "train": r["train"], "eval": r["eval"]}
    return out


def examples_phase(errs: dict) -> dict:
    """The three examples through their own ``main`` on a freed card
    (``_ex_video``; ``_ex_kv`` on the smoke config at head_dim 32, on
    qwen2-7b at full size, and on it again at the reference's budget 256;
    ``_ex_train``), each kernel's launches counted from 0 for each; every
    failure fails the run."""
    t0 = time.perf_counter()
    out = {"card": CARD[0]}
    torch.cuda.empty_cache()
    out["video"] = _ex_video()
    out["kv_smoke"] = _ex_kv(("--config", "smoke"), False, errs)
    torch.cuda.empty_cache()
    out["kv_full"] = _ex_kv(EX_KV_FULL, True, errs)
    out["kv_full_256"] = _ex_kv(EX_KV_FULL_256, False, errs)
    torch.cuda.empty_cache()
    out["train"] = _ex_train()
    out["phase_s"] = time.perf_counter() - t0
    print(f"examples phase: {out['phase_s']:.2f} s", flush=True)
    return out


# -- the roofline: each timed LM step beside its counted bound -----------------

# (arch, kind, batch, sequence): the steps the script times, at their own
# shapes: the prefill and a decode step of each served model (the decode
# against a cache of the prompt's depth; qwen2-7b's from the examples
# phase), the train step of each trained one (AdamW, remat "nothing", µ = 1,
# as run).
ROOFLINE_CELLS = tuple(
    [(LM_ARCH, kind, LM_B, LM_S) for kind in ("prefill", "decode")]
    + [(arch, kind, B, S) for arch, B, S in FAMILIES for kind in ("prefill", "decode")]
    + [(arch, "train", B, S) for arch, B, S, _ in TRAIN_RUNS]
    + [("qwen2-7b", kind, EX_KV_B, int(EX_KV_FULL[3])) for kind in ("prefill", "decode")])
ROOFLINE_SHARE_MAX = 1.05   # a step faster than its bound: the count is wrong
PEAK_TOL = 0.25             # the counted peak against max_memory_allocated
PROCS: list = []            # (process, output file) the script starts, cleared at its end


def count_cells(path: str) -> None:
    """``--count-roofline PATH``: each of ``ROOFLINE_CELLS`` counted on fake
    tensors (``repro_torch.launch.dryrun.run_cell``: FLOPs by dtype, bytes,
    the peak of live bytes, the bound), written to ``path`` as JSON.  Host
    work only: the script runs it in a process of its own, with the card
    hidden, while the card runs the other phases."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models import ShapeConfig

    def write(p: str, obj) -> None:
        Path(p + ".tmp").write_text(json.dumps(obj))
        os.replace(p + ".tmp", p)

    write(path + ".ranks.json", count_rank_cells())
    recs = [run_cell(arch, ShapeConfig(f"{kind}_{B}x{S}", S, B, kind))
            for arch, kind, B, S in ROOFLINE_CELLS]
    write(path, recs)
    write(path + ".pod.json", count_pod_cells())


# (d): two of the dry run's production cells, (arch, shape, multi_pod)
POD_CELLS = (("llama3.2-3b", "train_4k", False), ("qwen3-4b", "decode_32k", True))


def count_rank_cells() -> dict:
    """(c): the steps of part (b)'s ranks (sharded serving's prefill and
    first decode step, the llama step through ``launch/train.py --mesh
    2x2``) counted on a fake group of four: the same mesh, device type
    ("cuda", as the ranks') and configs.  Their collectives by op."""
    from repro_torch.launch import cost, steps
    from repro_torch.launch.mesh import fake_group, make_mesh
    from repro_torch.models import ShapeConfig
    from repro_torch.train import TrainConfig

    t = time.perf_counter()
    arch, B, S, opt, mu = LM_SH_RUNS["llama3.2-3b"]
    # launch/train.py's TrainConfig for part (b)'s llama run
    tc = TrainConfig(optimizer=opt, warmup_steps=max(2, LM_SH_STEPS // 10),
                     total_steps=LM_SH_STEPS, num_microbatches=mu, remat=LM_SH_REMAT)
    cells = {
        "prefill": (LM_ARCH, ShapeConfig("p", LM_SSH_S, LM_SSH_B, "prefill"), None),
        "decode": (LM_ARCH, ShapeConfig("d", LM_SSH_S + LM_SSH_DECODE, LM_SSH_B,
                                        "decode"), None),
        "train": (arch, ShapeConfig("t", S, B, "train"), tc)}
    out = {}
    with fake_group(LM_SH_RANKS):
        mesh = make_mesh((2, 2), ("data", "model"), "cuda")
        for name, (a, shp, tc_) in cells.items():
            cell = steps.build_cell(a, shp, _lm_config(a, LM_SH_LAYERS), mesh, tc=tc_)
            mode = cost.CostMode(cell.mode)
            rep = cost.count(cell, mode=mode)
            out[name] = {"collectives": _collective_table(mode.collectives),
                         "count_s": rep["count_s"]}
    return {"cells": out, "count_s": time.perf_counter() - t}


def count_pod_cells() -> dict:
    """(d): ``POD_CELLS`` on their production meshes (256 or 512 ranks of a
    fake group), as ``python -m repro_torch.launch.dryrun --mesh ...``
    counts them."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import fake_group, make_production_mesh

    out = []
    for arch, shape, multi in POD_CELLS:
        with fake_group(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi)
            rec = run_cell(arch, shape, mesh=mesh,
                           mesh_name="multipod_2x16x16" if multi else "single_16x16")
        rl, c = rec["roofline"], rec["cost"]
        out.append({"arch": arch, "shape": shape, "mesh": rec["mesh"],
                    "chips": rec["chips"], "compute_s": rl["compute_s"],
                    "memory_s": rl["memory_s"], "collective_s": rl["collective_s"],
                    "dominant": rl["dominant"], "bound_s": rl["step_time_lower_bound_s"],
                    "internode_fraction": c["internode_fraction"],
                    "collectives": c["collectives"],
                    "collective_counts": c["collective_counts"],
                    "collective_bytes_by_axis": c["collective_bytes_by_axis"],
                    "flops_per_chip": c["flops_per_chip"],
                    "bytes_per_chip": c["bytes_per_chip"],
                    "peak_gib": rec["memory"]["peak_bytes"] / 2**30,
                    "count_s": rec["count_s"], "meta": rec["meta"]})
    return {"cells": out}


def start_counter() -> tuple:
    """The counter's process (``count_cells``) and the file it writes."""
    import tempfile

    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_roofline_"), "cells.json")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--count-roofline", path],
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    PROCS.append((proc, path))
    COUNTER[:] = [path, proc]
    return proc, path


def roofline_phase(counter: tuple, lm: dict, families: dict, training: dict,
                   examples: dict) -> dict:
    """Each step of ``ROOFLINE_CELLS`` beside its bound: the counter's
    records (``start_counter``) with the times and peaks that the LM phases
    measured (``_serve``'s prefill and decode, qwen2-7b's in the examples
    phase, ``_train_main``'s median step); nothing more runs on the card.  Each line: the bound and what
    binds it, mfu (the model's FLOPs over the bf16 peak for the measured
    time), the share (bound / measured) and the counted peak against
    ``max_memory_allocated``.  Fails if a share exceeds
    ``ROOFLINE_SHARE_MAX`` or a counted peak is off by more than
    ``PEAK_TOL``."""
    from repro_torch.launch.roofline import mfu

    t = time.perf_counter()
    proc, path = counter
    rc = proc.wait(timeout=600)
    waited = time.perf_counter() - t
    check(rc == 0, f"the roofline counter exited {rc}")
    recs = json.loads(Path(path).read_text())
    measured = {(lm["arch"], "prefill"): (lm["prefill_ms"], lm["prefill_peak_gib"]),
                (lm["arch"], "decode"): (lm["decode_ms_per_step"], lm["decode_peak_gib"])}
    for arch, *_ in FAMILIES:
        f = families[arch]
        measured[arch, "prefill"] = (f["prefill_ms"], f["prefill_peak_gib"])
        measured[arch, "decode"] = (f["decode_ms_per_step"], f["decode_peak_gib"])
    for arch, *_ in TRAIN_RUNS:
        tr = training["train"][arch]
        measured[arch, "train"] = (tr["step_ms_median"], tr["peak_gib"])
    kv = examples["kv_full"]
    measured["qwen2-7b", "prefill"] = (kv["prefill_ms"], kv["prefill_peak_gib"])
    measured["qwen2-7b", "decode"] = (kv["decode_ms_per_step"], kv["decode_peak_gib"])
    rows, bad = [], []
    for rec, (arch, kind, B, S) in zip(recs, ROOFLINE_CELLS, strict=True):
        ms, peak_gib = measured[arch, kind]
        rl, mem = rec["roofline"], rec["memory"]
        bound_ms = rl["step_time_lower_bound_s"] * 1e3
        row = {
            "arch": arch, "kind": kind, "batch": B, "seq": S, "ms": ms,
            "bound_ms": bound_ms, "dominant": rl["dominant"],
            "compute_ms": rl["compute_s"] * 1e3, "memory_ms": rl["memory_s"] * 1e3,
            "share": bound_ms / ms,
            "mfu": mfu(rec["model_flops_total"], ms / 1e3),
            "flops": rec["cost"]["flops_per_chip"],
            "flops_by_dtype": rec["cost"]["flops_by_dtype"],
            "bytes": rec["cost"]["bytes_per_chip"],
            "attention_pairs": rec["cost"]["attention_pairs"],
            "model_flops": rec["model_flops_total"],
            "peak_gib": mem["peak_bytes"] / 2**30, "measured_peak_gib": peak_gib,
            "state_gib": mem["analytic_state_bytes"] / 2**30,
            "count_s": rec["count_s"], "meta": rec["meta"],
        }
        rows.append(row)
        print(f"roofline {arch} {kind} {B} x {S} ({CARD[0]}): measured {ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({row['dominant']}: compute "
              f"{row['compute_ms']:.4f}, memory {row['memory_ms']:.4f}), share "
              f"{row['share']:.4f}, mfu {row['mfu']:.4f}; peak counted "
              f"{row['peak_gib']:.2f} GiB, measured {peak_gib:.2f} GiB; "
              f"{row['flops']:.4g} FLOPs {row['flops_by_dtype']}, "
              f"{row['bytes']:.4g} bytes; counted in {row['count_s']:.2f} s",
              flush=True)
        if not (math.isfinite(bound_ms) and bound_ms > 0
                and row["share"] <= ROOFLINE_SHARE_MAX):
            bad.append(f"{arch} {kind}: share {row['share']:.4f}")
        if abs(row["peak_gib"] / peak_gib - 1) > PEAK_TOL:
            bad.append(f"{arch} {kind}: peak counted {row['peak_gib']:.2f} GiB, "
                       f"measured {peak_gib:.2f}")
        if kind == "train" and (rec["meta"]["optimizer"], rec["meta"]["remat"],
                                rec["meta"]["microbatches"]) != ("adamw", "nothing", 1):
            bad.append(f"{arch} train: the counted step is not the run's {rec['meta']}")
    check(not bad, "roofline: " + "; ".join(bad))
    pod = json.loads(Path(path + ".pod.json").read_text())
    for c in pod["cells"]:
        check(c["collective_s"] > 0 and c["flops_per_chip"] > 0
              and c["dominant"] in ("compute", "memory", "collective"),
              f"(d) {c['arch']} {c['shape']} on {c['mesh']}: {c}")
        print(f"(d) dry run {c['arch']} {c['shape']} on {c['mesh']} ({c['chips']} "
              f"ranks of a fake group, counted on this host): compute "
              f"{c['compute_s'] * 1e3:.4f} ms, memory {c['memory_s'] * 1e3:.4f} ms, "
              f"collective {c['collective_s'] * 1e3:.4f} ms ({c['dominant']}); "
              f"inter-node share {c['internode_fraction']:.4f}; collective bytes "
              f"{c['collectives']}; peak {c['peak_gib']:.2f} GiB; counted in "
              f"{c['count_s']:.2f} s", flush=True)
    DRYRUN.update(pod)
    print(f"roofline phase: {time.perf_counter() - t:.2f} s ({waited:.2f} s waiting "
          f"for the counter; counting took {sum(r['count_s'] for r in rows):.2f} s "
          "in its own process)", flush=True)
    return {"card": CARD[0], "cells": rows, "phase_s": time.perf_counter() - t,
            "wait_s": waited}


def sieve_record() -> dict:
    """The eighth record: ``sieve_gains``, timed at FeatureCoverage's shapes
    (the quickstart's and fig1's baseline), the other paths beside it;
    launches from the full-size legacy run on FeatureCoverage."""
    fc = SIEVE["paths"]["FeatureCoverage"]
    return {
        "name": "sieve_gains", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sieve_gains.cu",
        "replaces": "src/repro/core/sieve.py:229 (the lax.scan body of "
                    "sieve_extend; no TPU kernel)",
        "launches": SIEVE["launches"], "max_abs_err": max(SIEVE["errs"]),
        "ms": fc["ms"], "plain_ms": fc["plain_ms"], "bound_ms": fc["bound_ms"],
        "bound_by": fc["bound_by"], "library_ms": None,
        "full_tree_bound_ms": fc["full_tree_bound_ms"],
        "dense_bound_ms": fc["dense_bound_ms"], "paths": SIEVE["paths"],
        "ptxas": SIEVE["ptxas"], "sass": SIEVE["sass"],
        "runs": {k: {kk: vv for kk, vv in v.items() if kk != "sieve_gains"}
                 for k, v in SIEVE.items()
                 if k in ("FeatureCoverage", "path A", "path B")},
        "row_sieve": SIEVE["row_sieve"],
    }


def main() -> int:
    if "--count-roofline" in sys.argv:
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        count_cells(sys.argv[sys.argv.index("--count-roofline") + 1])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    T0[0] = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    if "--sharded-rank" in sys.argv:
        # one rank of sharded_phase's part (b), started by the script itself
        i = sys.argv.index("--sharded-rank")
        sharded_rank(int(sys.argv[i + 1]), sys.argv[i + 2], sys.argv[i + 3])
        return 0
    if "--lm-sharded-rank" in sys.argv:
        # one rank of lm_sharded_phase's part (b), started by the script itself
        i = sys.argv.index("--lm-sharded-rank")
        lm_sharded_rank(int(sys.argv[i + 1]), sys.argv[i + 2], sys.argv[i + 3])
        return 0
    from repro_torch.kernels import build, load_library

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    CARD[0] = smi
    if "--first-chunk" in sys.argv:
        # the service's first chunk in a fresh process, alone: no kernel
        # records and no result line
        mode = sys.argv[sys.argv.index("--first-chunk") + 1]
        check(mode in ("cold", "warmed"), f"--first-chunk {mode}: cold or warmed")
        build()
        load_library()
        print(json.dumps(first_chunk_probe(mode == "warmed")))
        return 0
    if "--lm-sharded" in sys.argv:
        # the LM sharding phase alone, after a plain run of (c) cut to 5
        # steps: no kernel records and no result line
        global TRAIN_STEPS
        build()
        load_library()
        TRAIN_STEPS = 5
        import tempfile

        from repro_torch import configs
        start_counter()              # (c)'s fake-group count
        arch, B, S, pool = TRAIN_RUNS[0]
        with tempfile.TemporaryDirectory() as tmp:
            plain = _train_main(configs.get(arch), tmp, B, S, pool)
        torch.cuda.empty_cache()
        print(json.dumps({"lm_sharded": lm_sharded_phase({"train": {arch: plain}})},
                         default=float))
        print(json.dumps({"lm_sharded_serve": SHARDED_SERVE}, default=float))
        return 0
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
    mark("build")
    # the LM steps' counts on fake tensors, host work in a process of its
    # own while the card runs the phases below (``roofline_phase``)
    counter = start_counter()

    # 3. kernel vs plain, and the small pipeline
    errs = {"ss_divergence": 0.0, "feature_gains": 0.0}
    sweep(errs)
    sparse_sweep(errs)
    route_check()
    small_pipeline()
    mark("FeatureCoverage sweeps and the small pipeline")

    # 4-7. the FeatureCoverage main path at full size, then stochastic and
    # lazy greedy on the same objective
    records = fc_path(errs)
    # the §3.4 post-reduction at 2^16 (PERF.md section 4 says why not 2^20)
    torch.cuda.empty_cache()
    records[1]["postreduce"] = postreduce_path()
    mark("postreduce")

    # 8-9. facility location: kernel vs plain, the small pipelines; the
    # other selectors at n = 4096 on all three objectives; the quickstart
    errs.update(fl_divergence=0.0, fl_gains=0.0, fl_stream_divergence=0.0,
                fl_stream_gains=0.0)
    torch.cuda.empty_cache()
    fl_sweep(errs)
    fl_small_pipelines()
    selectors_small()
    sieve_small()
    quickstart_phase()
    mark("FL sweeps, small pipelines and selectors, quickstart")

    # 10-11. path A and path B at full size, each on a freed card
    for path in (fl_dense_path, fl_stream_path):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        records += path(errs)
        mark(path.__name__)
    # 11b. sharded SS and greedy over torch.distributed: part (a) ran at one
    # rank on each path's objective; part (b), four ranks on the card
    torch.cuda.empty_cache()
    sharded = sharded_phase()
    mark("sharded_phase")
    # 12-13. flash attention: kernel vs plain, then the LM serving path
    errs["flash_attention"] = 0.0
    torch.cuda.empty_cache()
    flash_sweep(errs)
    torch.cuda.reset_peak_memory_stats()
    records.append(lm_path(errs))
    mark("lm_path")
    # 14. the other block types: olmoe, recurrentgemma, mamba2, each served
    # at full width and depth on a freed card
    families = lm_families_phase(errs)
    mark("lm_families_phase")
    records[-1]["at_recurrentgemma"] = families["recurrentgemma-2b"]["flash_at_shape"]
    records.append(sieve_record())
    # 15. training: the flash backward kernel, llama3.2-3b at full width and
    # depth through launch/train.py, checkpoints, the pipeline at scale
    torch.cuda.empty_cache()
    bwd_record, training = train_phase(errs)
    mark("train_phase")
    records.append(bwd_record)
    # 15b. LM training sharded over a DeviceMesh: one rank over NCCL at
    # full size against (c), four ranks sharing the card over gloo
    lm_sharded = lm_sharded_phase(training)
    mark("lm_sharded_phase")
    # 16. the examples through their own main: the video at 9721 frames, KV
    # pruning on qwen2-7b (smoke, full size at budgets 512 and 256),
    # SS-selected training
    examples = examples_phase(errs)
    mark("examples_phase")
    for r_ in records:
        r_["examples"] = {ex: v["launches"].get(r_["name"], 0)
                          for ex, v in examples.items() if isinstance(v, dict)}
        r_["lm_sharded"] = {
            "llama3.2-3b, 1 rank": lm_sharded["one_rank"]["launches"].get(r_["name"], 0),
            **{f"{arch}, 4 ranks (rank 0)": lm_sharded["four_ranks"][arch]["launches"]
               .get(r_["name"], 0) for arch in LM_SH_RUNS}}
        r_["sharded"] = {
            **{lab: v["launches"].get(r_["name"], 0)
               for lab, v in sharded.items() if lab in ("FeatureCoverage", "path A",
                                                         "path B")},
            **{f"{lab}, 4 ranks (rank 0)": v["launches"].get(r_["name"], 0)
               for lab, v in sharded["four_ranks"].items()}}
    flash = next(r_ for r_ in records if r_["name"] == "flash_attention")
    flash["at_qwen2_7b"] = examples["kv_full"]["flash_at_shape"]
    # 17. each timed LM step beside its bound (nothing more on the card)
    roof = roofline_phase(counter, flash["lm_path"], families, training, examples)
    mark("roofline_phase")
    # the lanes and the KV path held the kernels to their plain versions
    # after the records were made
    for r_ in records:
        r_["max_abs_err"] = max(r_["max_abs_err"], errs.get(r_["name"], 0.0))
    check(len(records) == 9 and all(
        math.isfinite(r_[k]) for r_ in records
        for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")),
        "a measurement is missing or not finite")
    check(math.isfinite(flash["library_ms"]), "flash: no library time")

    print(json.dumps({"lm_families": families}))
    print(json.dumps({"training": training}))
    print(json.dumps({"examples": examples}))
    print(json.dumps({"roofline": roof}))
    print(json.dumps({"sharded": {k: v for k, v in sharded.items()}},
                     default=float))
    print(json.dumps({"lm_sharded": lm_sharded}, default=float))
    print(json.dumps({"lm_sharded_serve": SHARDED_SERVE}, default=float))
    print(json.dumps({"dryrun": DRYRUN}, default=float))
    print(f"chip_smoke: {time.perf_counter() - T0[0]:.1f} s", flush=True)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import shutil

    try:
        rc = main()
    finally:
        for proc_, path_ in PROCS:
            if proc_.poll() is None:
                proc_.kill()
                proc_.wait()
            shutil.rmtree(os.path.dirname(path_), ignore_errors=True)
    sys.exit(rc)
