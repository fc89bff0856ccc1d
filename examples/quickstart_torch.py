"""Quickstart of the PyTorch/CUDA port: the paper on one card.

Builds a synthetic news day, runs greedy on the whole ground set, then
Submodular Sparsification (Algorithm 1) + greedy on the reduced set V', and
prints the utility ratio, the reduction and the certificate.  Then the
paper's other selectors on V (stochastic and lazy greedy), the streaming
baseline (sieve streaming), the one-call pipeline with the §3.4
improvements, one request through the summarization service's facade
(``repro_torch.api.summarize``, traced), a durable streaming session
(``repro_torch.api.sessions``: appends, a summary, and the same summary from
a reopened root), and matrix-free facility location.
On the card, SS and greedy run once more through the plain backend under
the same draws: the kernels must give the same V' and the same picks.  SS
and greedy also run through the sharded backend (``torch.distributed``, one
rank in a group the script opens and closes).

    PYTHONPATH=src python examples/quickstart_torch.py              # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # the host
"""

import argparse
import tempfile
import time

import numpy as np

import torch
import torch.distributed as dist

from repro_torch import (
    ShardedBackend,
    StreamingFacilityLocation,
    api,
    clustered_embeddings,
    feature_coverage_from_numpy,
    greedy,
    lazy_greedy,
    news_day,
    obs,
    sieve_streaming,
    ss_sparsify,
    stochastic_greedy,
    summarize,
)
from repro_torch.core import selection_bucket
from repro_torch.core.greedy import gumbel
from repro_torch.core.sparsify import max_rounds
from repro_torch.device import resolve_device

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
parser.add_argument("--n", type=int, default=4096, help="ground-set size")
args = parser.parse_args()
dev = resolve_device(args.device)
N, K = args.n, 10


def seeded(seed):
    return torch.Generator(device=dev).manual_seed(seed)


def timed(call):
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = call()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t


print(f"ground set: {N} sentences (synthetic NYT-like day) on {dev}")
fn = feature_coverage_from_numpy(news_day(seed=0, n_sentences=N, n_features=512),
                                 phi="sqrt", device=dev)  # f(S) = Σ_f sqrt(c_f(S))

# --- offline baseline: greedy on the full ground set -----------------------
full = greedy(fn, K)
print(f"greedy on V:        f(S) = {float(full.value):.4f}")

# --- the paper: SS (c=8, r=8) then greedy on V' -----------------------------
# greedy compacts V' into a |V'|-sized buffer (repro_torch.core.greedy).
ss = ss_sparsify(fn, seeded(0), r=8, c=8.0)
reduced = greedy(fn, K, alive=ss.vprime)
nv = int(ss.vprime.sum())
bucket = selection_bucket(N, nv)
sel_path = "full-width" if bucket is None else f"compact bucket={bucket}"
print(f"SS -> |V'| = {nv} ({100 * nv / N:.1f}% of V, {ss.rounds} rounds, "
      f"selection={sel_path})")
print(f"greedy on V':       f(S) = {float(reduced.value):.4f}  "
      f"(relative = {float(reduced.value / full.value):.4f})")
print(f"certificate eps^ = {float(ss.eps_hat):.4f}  "
      f"(Thm 2: f(S') >= (1-1/e)(f(S*) - 2k*eps))")

# --- backend parity: the kernels against the plain backend ------------------
if dev.type == "cuda":
    noise = torch.stack([gumbel(N, seeded(1), dev) for _ in range(max_rounds(N))])
    ss_k = ss_sparsify(fn, noise=noise)
    ss_p = ss_sparsify(fn, noise=noise, backend="reference")
    res_k = greedy(fn, K, alive=ss_k.vprime)
    res_p = greedy(fn, K, alive=ss_p.vprime, backend="reference")
    assert torch.equal(ss_k.vprime, ss_p.vprime)
    assert torch.equal(res_k.selected, res_p.selected)
    print(f"cuda vs reference:  |V'| = {int(ss_k.vprime.sum())} both, same "
          f"picks, f(S) = {float(res_k.value):.4f} / {float(res_p.value):.4f}")
else:
    print("cuda vs reference:  not run (the cuda backend needs a card)")

# --- the sharded backend: the whole SS and greedy loops over torch.distributed
# Every rank holds its block of V and makes the same call (SPMD); here one
# rank, in a group this script opens and closes itself (NCCL on the card,
# gloo on the host).  With more ranks, each passes its own process group.
dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                        store=dist.HashStore(), rank=0, world_size=1)
try:
    sharded = ShardedBackend()            # one "data" axis over the group
    ss_s = ss_sparsify(fn, seeded(0), r=8, c=8.0, backend=sharded)
    red_s = greedy(fn, K, alive=ss_s.vprime, backend=sharded)
finally:
    dist.destroy_process_group()
sharded_relative = float(red_s.value / full.value)
print(f"backend sharded:    |V'| = {int(ss_s.vprime.sum())} ({ss_s.rounds} rounds, "
      f"1 rank), f(S) = {float(red_s.value):.4f}  (relative = {sharded_relative:.4f})")
assert sharded_relative > 0.95

# --- the paper's other selectors on V ----------------------------------------
sg, wall = timed(lambda: stochastic_greedy(fn, K, seeded(2)))
print(f"stochastic greedy on V: f(S) = {float(sg.value):.4f}  (relative to "
      f"greedy {float(sg.value / full.value):.4f}, wall {wall:.4f} s)")
lz, wall = timed(lambda: lazy_greedy(fn, K))
print(f"lazy greedy on V:   f(S) = {float(lz.value):.4f}  "
      f"({lz.reevaluations} re-evaluations, wall {wall:.4f} s)")

# --- streaming baseline ------------------------------------------------------
sv, wall = timed(lambda: sieve_streaming(fn, K))
sieve_relative = float(sv.value / full.value)
print(f"sieve-streaming:    f(S) = {float(sv.value):.4f}  "
      f"(relative = {sieve_relative:.4f}, wall {wall:.4f} s)")

# --- one-call pipeline -------------------------------------------------------
res, _ = summarize(fn, K, seeded(0), preprune=True, importance=True)
print(f"summarize(+§3.4):   f(S) = {float(res.value):.4f}")

# --- one-call facade: the summarization service (repro_torch.api) -----------
# The service micro-batches requests into lanes (sync or async scheduler,
# per-request deadline_s, Ticket futures), retries, fails over to the plain
# route and isolates poisoned queries, walks a degradation ladder under
# deadline pressure (RunConfig.ladder), and takes a FaultPlan for chaos
# tests.  Tracing is on for this one request: the service records
# request.admit / queue.wait / chunk.exec spans and the core its
# ss.sparsify_batched / greedy.select_batched spans under them; results
# stay bit-identical (telemetry only observes outputs).
obs.configure(trace=True)
resp = api.summarize(fn.W, k=K, seed=0, device=dev)
obs.configure(trace=False)
assert torch.equal(resp.selected, reduced.selected)   # same seed, same picks
print(f"api.summarize:      f(S) = {resp.value:.4f}  "
      f"(|V'| = {resp.vprime_size}, batch {resp.batch_size}/"
      f"{resp.batch_bucket}, queue {resp.queue_delay_s * 1e3:.1f} ms)")
print(obs.trace_summary())               # the request's span tree

# --- durable streaming sessions (repro_torch.api) ----------------------------
# A session keeps a live summary over an unbounded stream of feature rows: a
# row sieve decides online what to keep, SS compacts the kept rows, greedy
# summarizes them.  With a root directory every append is in a write-ahead
# log before it is acknowledged, so a new engine on the same root (after a
# crash, say) recovers the session bit for bit.
rows = fn.W[:512].cpu().numpy()
with tempfile.TemporaryDirectory() as root:
    scfg = api.SessionConfig(k=K, n_features=rows.shape[1], buffer_cap=32,
                             resparsify_every=16, ss_r=2)
    eng = api.sessions(scfg, root, device=dev)
    sid = api.open_session(key=0, engine=eng)
    for row in rows:
        api.append(sid, row, engine=eng)     # returns its WAL sequence number
    s = api.summary(sid, engine=eng)         # greedy over the SS-pruned buffer
    again = api.summary(sid, engine=api.sessions(scfg, root, device=dev))
    assert np.array_equal(s.selected, again.selected) and s.value == again.value
print(f"api.sessions:       f(S) = {s.value:.4f} over {s.retained} retained of "
      f"{s.seen} rows ({s.resparsifies} SS compactions); the same summary after "
      f"reopening the root")

# --- matrix-free facility location round-trip --------------------------------
# StreamingFacilityLocation stores only (n, d) embeddings and computes
# similarity tiles on the fly: the objective for ground sets whose dense
# (n, n) similarity would not fit.
X = torch.from_numpy(clustered_embeddings(seed=0, n=N, d=16)).to(dev)
sfl = StreamingFacilityLocation.from_features(X, kernel="dot")
ss_fl = ss_sparsify(sfl, seeded(0), r=8, c=8.0)
red_fl = greedy(sfl, K, alive=ss_fl.vprime)
full_fl = greedy(sfl, K)
print(f"streaming FL:       f(S) = {float(red_fl.value):.4f}  "
      f"(relative = {float(red_fl.value / full_fl.value):.4f}, "
      f"|V'| = {int(ss_fl.vprime.sum())}, memory O(n*d) not O(n^2))")
assert float(red_fl.value / full_fl.value) > 0.9

assert float(reduced.value / full.value) > 0.95
print("OK: SS matches greedy at a fraction of the ground set.")
