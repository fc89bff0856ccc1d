"""Build the CUDA sources under ``kernels/csrc`` and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and includes no PyTorch
header, so ``nvcc`` compiles it in seconds.  The sources are compiled in
parallel, one ``nvcc`` each, for ``sm_90a`` (Hopper), then linked into
``build/repro_torch/libkernels.so`` under the repository root.  The library
is rebuilt when it is missing or older than a source, and loaded once per
process.  Anything that goes wrong raises: there is no fallback.

The wrappers share the rest of the C interface from here: the phi codes,
the input checks, and turning a returned ``cudaError_t`` into an error.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/_build.py -> repository root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libkernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME): the CUDA "
        "kernels of repro_torch need the CUDA toolkit to build"
    )


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; return their outputs, or raise with the
    output of any failure."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for c in cmds
    ]
    failed, outs = [], []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        outs.append(out)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return outs


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the shared library; return its path.
    ``ptxas`` reports each kernel's registers, shared memory and spills into
    ``<source stem>.ptxas.txt`` beside the library."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    lib = BUILD_DIR / LIB_NAME
    newest = max(p.stat().st_mtime for p in sources + headers)
    if not force and lib.exists() and lib.stat().st_mtime >= newest:
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        reports = _run_all([
            [nvcc, *ARCH, "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler",
             "-fPIC", "-c", str(s), "-o", str(o)]
            for s, o in zip(sources, objs)
        ])
        for s, text in zip(sources, reports):
            (BUILD_DIR / f"{s.stem}.ptxas.txt").write_text(text)
        staged = Path(tmp) / LIB_NAME
        _run_all([[nvcc, *ARCH, "-shared", "-o", str(staged),
                   *map(str, objs)]])
        # Atomic publish: a concurrent loader sees the old file or the new.
        os.replace(staged, lib)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ss_divergence_launch.argtypes = [
        p, i, ll, i,     # W, W is bf16, rows of W, F
        p, ll,           # cand_idx (or NULL), number of outputs
        p, p, p, i,      # CU, phi_cu, resid, r
        p, p, i,         # cap (or NULL), feat_w (or NULL), phi kind
        p,               # scratch: ss_scratch_floats(r, F, n_out) floats
        p, p,            # out, stream
    ]
    lib.ss_divergence_launch.restype = i
    lib.feature_gains_launch.argtypes = [
        p, i, ll, i,     # W, W is bf16, rows of W, F
        p, ll,           # cand_idx (or NULL), number of outputs
        p, p,            # c, phi_c (device scalar)
        p, p, i,         # cap (or NULL), feat_w (or NULL), phi kind
        p, p,            # out, stream
    ]
    lib.feature_gains_launch.restype = i
    lib.fl_divergence_launch.argtypes = [
        p, i, ll, ll,    # sim, sim is bf16, served rows ni, candidate columns n
        p, ll,           # cand_idx (or NULL), number of outputs
        p, p, i,         # MU, resid (or NULL: zeros), r
        i, i,            # probes per thread, passes: fl_probe_tile(r)
        i, p,            # row splits, their scratch (or NULL)
        p, p,            # out, stream
    ]
    lib.fl_divergence_launch.restype = i
    lib.fl_stream_launch.argtypes = [
        p, ll, i,        # Xs, served rows ni, d
        p, ll,           # Xc, candidate rows n
        p, ll,           # cand_idx (or NULL), number of outputs
        p, p, i,         # MU, resid (or NULL: zeros), r
        i, i,            # probes per thread, passes: fl_probe_tile(r)
        i, p,            # row splits, their scratch (or NULL)
        p, p,            # out, stream
    ]
    lib.fl_stream_launch.restype = i
    lib.flash_attention_launch.argtypes = [
        p, p, p, p,      # q, k, v, out
        i, i, i, i, i, i,  # inputs are bf16, B, S, H, KV, head_dim
        *[ll] * 12,      # (batch, seq, head) strides of q, k, v, out
        i, i,            # causal, window
        ctypes.c_float,  # scale
        p,               # stream
    ]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_tc_launch.argtypes = [
        p, p, p, p,      # q, k, v, out (bfloat16)
        i, i, i, i, i,   # B, S, H, KV, head_dim
        *[ll] * 12,      # (batch, seq, head) strides of q, k, v, out
        i, i,            # causal, window
        ctypes.c_float,  # scale
        p,               # stream
    ]
    lib.flash_attention_tc_launch.restype = i


def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernels' shared library (once)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    return _lib


# -- shared by the wrappers --------------------------------------------------

# Must match enum PhiKind in csrc/common.cuh.
PHI_CODES = {"sqrt": 0, "log1p": 1, "setcover": 2, "satcov": 3, "linear": 4}


def check_inputs(
    name: str,
    W: torch.Tensor,
    cand_idx: torch.Tensor | None,
    phi: str,
    cap: torch.Tensor | None,
    **f32: torch.Tensor | None,
) -> None:
    """Validate what both kernels take: a contiguous 2-D ``W`` in float32 or
    bfloat16, contiguous float32 side inputs and int64 ``cand_idx`` on W's
    device, a known phi, and a cap for satcov.  Raises on anything else."""
    if not isinstance(W, torch.Tensor) or W.dim() != 2:
        raise ValueError(f"{name}: W must be a 2-D tensor")
    if W.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: W must be float32 or bfloat16, got {W.dtype}")
    if W.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {W.device}")
    if phi not in PHI_CODES:
        raise ValueError(f"{name}: unknown phi {phi!r}")
    if phi == "satcov" and cap is None:
        raise ValueError(f"{name}: phi='satcov' needs cap")
    if W.shape[1] >= 2**31:
        raise ValueError(f"{name}: too many features ({W.shape[1]})")
    check_side(name, W, cand_idx, **f32, cap=cap)


def check_side(
    name: str,
    ref: torch.Tensor,
    cand_idx: torch.Tensor | None,
    **f32: torch.Tensor | None,
) -> None:
    """The main input ``ref`` and the side inputs of a kernel: all on ref's
    device and contiguous, the named ones float32, ``cand_idx`` a 1-D
    int64 tensor.  None stands for an absent optional input."""
    tensors = [("input", ref), ("cand_idx", cand_idx), *f32.items()]
    for arg, t in tensors:
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    for arg, t in f32.items():
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
    if cand_idx is not None and (cand_idx.dtype != torch.int64
                                 or cand_idx.dim() != 1):
        raise TypeError(f"{name}: cand_idx must be a 1-D int64 tensor")


def check_probes(name: str, MU: torch.Tensor, resid: torch.Tensor | None,
                 ni: int) -> int:
    """MU (r >= 1, ni) and resid (r,) of the facility-location kernels;
    returns r."""
    if MU.dim() != 2 or MU.shape[0] < 1 or MU.shape[1] != ni:
        raise ValueError(f"{name}: MU must be (r >= 1, {ni}), got {tuple(MU.shape)}")
    r = MU.shape[0]
    if r >= 2**31:
        raise ValueError(f"{name}: too many probes ({r})")
    if resid is not None and tuple(resid.shape) != (r,):
        raise ValueError(f"{name}: resid must be ({r},), got {tuple(resid.shape)}")
    return r


def row_splits(n_out: int, ni: int) -> int:
    """How the facility-location kernels split their ni served rows: a grid
    of ceil(n_out / 128) candidate blocks that fills the card is not split;
    a smaller one (later SS rounds, greedy over V') is split into enough
    row blocks for about 512 blocks, each over at least 512 rows
    (``csrc/fl_common.cuh``).  Returns the number of splits."""
    blocks = -(-n_out // 128)
    if blocks >= 256:
        return 1
    return max(1, min(-(-512 // blocks), ni // 512))


# The FeatureCoverage SS divergence kernel (csrc/ss_divergence.cu): its
# scratch.  Must match kBlockCands and kProbePass there.
SS_BLOCK_CANDS = 128
SS_PROBE_PASS = 32


def ss_scratch_floats(r: int, F: int, n_out: int) -> int:
    """Floats of scratch the SS divergence kernel takes for n_out outputs:
    the probe table CT (F x RP pairs), the per-probe offsets Q (RP), with RP
    = r rounded up to SS_PROBE_PASS, and a dense flag per block of
    SS_BLOCK_CANDS outputs (int32, last; written only when F is at most
    the sparse loop's widest, 8192)."""
    rp = -(-r // SS_PROBE_PASS) * SS_PROBE_PASS
    return 2 * F * rp + rp + -(-n_out // SS_BLOCK_CANDS)


# The many-probe tile of the facility-location kernels: threads along
# probes, and the most probes per thread of a template instance.  Must match
# kProbeThreads and kMaxPPT in csrc/fl_common.cuh.
FL_PROBE_THREADS = 16
FL_MAX_PPT = 10


class ProbeTile(NamedTuple):
    """How the facility-location kernels walk r probes: ``passes`` passes of
    FL_PROBE_THREADS x ``ppt`` probe slots."""

    ppt: int
    passes: int

    @property
    def slots(self) -> int:
        return FL_PROBE_THREADS * self.ppt * self.passes


def fl_probe_tile(r: int) -> ProbeTile:
    """The probe tile for r probes, a pure rule of r: the fewest passes of at
    most FL_PROBE_THREADS x FL_MAX_PPT slots, then the fewest probes per
    thread that cover r in that many equal passes.  128, 144 and 160 probes
    (SS at 2^16, 2^18 and 2^20 candidates) fill one pass with no pad slot;
    any r pads fewer than FL_PROBE_THREADS slots a pass on average."""
    if r < 1:
        raise ValueError(f"fl_probe_tile: r must be >= 1, got {r}")
    passes = -(-r // (FL_PROBE_THREADS * FL_MAX_PPT))
    return ProbeTile(-(-r // (FL_PROBE_THREADS * passes)), passes)


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer for ctypes (None becomes NULL)."""
    return None if t is None else t.data_ptr()


def raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {rc})")
