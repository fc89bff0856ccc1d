"""The port's side of ``tests/test_torch_dryrun_sharded.py``: one process
a rank of four, on the CPU over gloo.

    PYTHONPATH=src python tests/torch_dryrun_sharded_ranks.py RANK STORE INPUTS OUT

Each rank joins the group through the ``file://`` store STORE, reads the
shared inputs (parameters and tokens drawn by numpy), and runs the port's
sharded prefill and ``DECODE`` decode steps of each case of
``SERVE_CASES`` on (2, 2): parameters placed by ``param_spec_tree``, the
tokens by ``data_spec``, the cache made by prefill as ``cache_spec_tree``
splits it.  Rank 0 then runs each case on (1, 1) in a group of its own,
beside the unsharded calls.  Writes its results to OUT.  It imports
nothing of JAX.
"""

import dataclasses
import sys

import numpy as np
import torch
from torch_lm_sharded_ranks import flat, unflat

RANKS = 4
B, S, MAX_LEN, DECODE = 4, 16, 20, 2
#: case -> (arch, config overrides): smoke configs whose vocab divides 2;
#: recurrentgemma's local window (8) is shorter than the prompt, so its
#: prefill writes the ring buffer rolled; mamba2's cache is its final
#: state and conv tail, its decode the recurrence on each rank's heads
SERVE_CASES = {"llama": ("llama3.2-3b", {"vocab_size": 160}),
               "rgemma": ("recurrentgemma-2b", {"vocab_size": 212}),
               "mamba2": ("mamba2-780m", {"vocab_size": 212})}


def config(case: str):
    from repro_torch import configs

    arch, over = SERVE_CASES[case]
    return dataclasses.replace(configs.smoke(arch), **over)


def inputs() -> dict:
    """Parameters at the reference's init scales, a prompt and the decode
    tokens of each case, from numpy draws."""
    from repro_torch.models import abstract_params

    out = {}
    for i, case in enumerate(SERVE_CASES):
        cfg = config(case)
        rng = np.random.default_rng(100 + i)
        for name, t in flat(abstract_params(cfg)).items():
            shape = tuple(t.shape)
            if "tok" in name:
                a = rng.standard_normal(shape)
            elif "scale" in name or "_norm" in name:
                a = 1.0 + 0.2 * rng.standard_normal(shape)
            else:
                a = rng.standard_normal(shape) / np.sqrt(shape[-2] if len(shape) >= 2 else 1)
            out[f"{case}/params/{name}"] = a.astype(np.float32)
        out[f"{case}/tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        out[f"{case}/next"] = rng.integers(0, cfg.vocab_size, (DECODE, B, 1)).astype(np.int32)
    return out


def _whole(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy().copy()


def serve(case: str, mesh, arrays: dict, out: dict, tag: str) -> None:
    """Prefill and ``DECODE`` decode steps on ``mesh`` (None: unsharded);
    every rank records the logits and every cache leaf, whole."""
    import contextlib

    from repro_torch.convert import model_params_from_numpy
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.sharding import (
        data_spec,
        distribute,
        named,
        param_spec_tree,
        use_mesh,
    )

    cfg = config(case)
    params = model_params_from_numpy(unflat(arrays, f"{case}/params"), cfg, device="cpu")

    def place(t):
        return t if mesh is None else distribute(t, named(mesh, data_spec(mesh, t.shape)))

    if mesh is not None:
        params = distribute(params, named(mesh, param_spec_tree(cfg, params, mesh)))
    ctx = contextlib.nullcontext() if mesh is None else use_mesh(mesh)
    with torch.no_grad(), ctx:
        logits, cache = prefill(cfg, params, place(torch.from_numpy(arrays[f"{case}/tokens"])),
                                max_len=MAX_LEN)
        out[f"{tag}/prefill/logits"] = _whole(logits)
        for k, v in flat(cache).items():
            out[f"{tag}/prefill/cache/{k}"] = _whole(v)
        for i in range(DECODE):
            toks = place(torch.from_numpy(arrays[f"{case}/next"][i]))
            logits, cache = decode_step(cfg, params, toks, cache, S + i)
            out[f"{tag}/decode{i}/logits"] = _whole(logits)
        for k, v in flat(cache).items():
            out[f"{tag}/decode/cache/{k}"] = _whole(v)


def rank_side(rank: int, store: str, inp_path: str, out_path: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh, single_device_mesh

    arrays = dict(np.load(inp_path))
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=RANKS)
    mesh = make_test_mesh((2, 2), ("data", "model"), "cpu")
    out: dict = {}
    for case in SERVE_CASES:
        serve(case, mesh, arrays, out, case)
    dist.destroy_process_group()
    if rank == 0:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        one = single_device_mesh("cpu")
        for case in SERVE_CASES:
            serve(case, one, arrays, out, f"one/{case}/mesh")
            serve(case, None, arrays, out, f"one/{case}/plain")
        dist.destroy_process_group()
    np.savez(out_path, **out)


if __name__ == "__main__":
    rank_side(int(sys.argv[1]), *sys.argv[2:5])
