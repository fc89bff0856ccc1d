"""Atomic, optionally asynchronous checkpoints of a train state: the
counterpart of ``repro/train/checkpoint.py``, in its directory format.

* **Logical addressing** — each leaf is stored under its path in the tree,
  named as the reference's ``jax.tree_util.keystr`` names it
  (``['params']['blocks']['p0']['attn']['w_q']``), so a float32 train
  state written by either package restores in the other.
* **Atomicity** — writes go to ``<dir>/tmp.<step>`` and are renamed to
  ``step_<10 digits>`` only after an fsync'd ``COMMIT`` marker is written;
  restore ignores directories without it, so a preemption mid-write never
  corrupts the latest checkpoint.
* **Async** — ``save_async`` copies every leaf to host memory on the
  caller's thread, synchronised, before it returns (the optimizer updates
  the state in place, so a copy left for later would store the next
  step's values), and writes the files on a background thread.  ``wait()``
  joins it; the next save waits first.
* **GC** — the ``keep`` most recent checkpoints are retained.
* **Sharded states** — a state of DTensors (``train.shard_train_step``) is
  gathered leaf by leaf (``full_tensor``, on every rank) and rank 0 writes
  it in the same format; the other ranks wait at a barrier until the write
  has committed (``save``; after ``save_async``, in ``wait``).  ``restore``
  with ``shardings`` puts each leaf onto its mesh and placements, so a
  state saved on one mesh restores on another, or on none (elastic).

One ``arrays.npz`` holds the leaves.  bfloat16 leaves are stored as float32
(exact; numpy has no bfloat16), and ``restore`` casts every leaf to the
target state's dtype.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device


def _flatten_with_names(tree, prefix: str = ""):
    """(names, leaves) in the reference's order (dict keys sorted, as
    ``jax.tree_util`` flattens a dict)."""
    names, leaves = [], []
    for key in sorted(tree):
        v = tree[key]
        name = f"{prefix}['{key}']"
        if isinstance(v, dict):
            n, l_ = _flatten_with_names(v, name)
            names += n
            leaves += l_
        else:
            names.append(name)
            leaves.append(v)
    return names, leaves


def _unflatten(tree, it):
    return {k: _unflatten(v, it) if isinstance(v, dict) else next(it)
            for k, v in sorted(tree.items())}


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of the leaf, always a copy (``.cpu()`` of a CPU tensor is
    the tensor itself, which the next in-place update would change)."""
    t = t.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._sharded = False        # the pending save gathered DTensors
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def _gather(self, state) -> tuple[list, list, bool]:
        """(names, host copies, whether rank 0 alone writes): a state of
        DTensors is gathered on every rank."""
        names, leaves = _flatten_with_names(state)
        sharded = any(isinstance(t, DTensor) for t in leaves)
        return names, [_to_host(t) for t in leaves], sharded

    def save(self, step: int, state) -> str:
        names, host, sharded = self._gather(state)
        final = os.path.join(self.dir, f"step_{step:010d}")
        if not sharded or dist.get_rank() == 0:
            final = self._write(step, names, host)
        if sharded:
            dist.barrier()
        return final

    def save_async(self, step: int, state) -> None:
        self.wait()
        # on this thread, to completion: the state changes in place next step
        names, host, sharded = self._gather(state)
        self._sharded = sharded
        if not sharded or dist.get_rank() == 0:
            self._thread = threading.Thread(
                target=self._write, args=(step, names, host), daemon=True
            )
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            dist.barrier()

    def _write(self, step: int, names: list, leaves: list) -> str:
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        arrays = {}
        for i, (name, leaf) in enumerate(zip(names, leaves)):
            arrays[f"a{i}"] = leaf
            manifest["leaves"].append(
                {"name": name, "key": f"a{i}",
                 "shape": list(leaf.shape), "dtype": str(leaf.dtype)}
            )
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(
                os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True
            )

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in sorted(os.listdir(self.dir)):
            if d.startswith("step_") and os.path.exists(
                os.path.join(self.dir, d, "COMMIT")
            ):
                out.append(int(d[len("step_"):]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_shape, step: int | None = None, device="cuda",
                shardings=None):
        """Rebuild the state tree; returns (state, step).  ``state_shape``
        gives the structure, shapes and dtypes (``abstract_train_state``'s
        meta tensors, or a real state); every leaf is put on ``device`` (the
        card by default) in its target dtype, and with ``shardings`` (a
        parallel tree of ``NamedSharding``) onto its mesh and placements:
        the elastic restore, onto any mesh whose axes the rules name."""
        from repro_torch.models.sharding import distribute

        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        names, refs = _flatten_with_names(state_shape)
        shs = (_flatten_with_names(shardings)[1] if shardings is not None
               else [None] * len(names))
        with np.load(os.path.join(d, "arrays.npz")) as arrays:
            by_name = {leaf["name"]: leaf["key"] for leaf in manifest["leaves"]}
            missing = [n for n in names if n not in by_name]
            if missing:
                raise KeyError(f"checkpoint {d} missing leaves: {missing[:5]}...")
            out = []
            for name, ref, sh in zip(names, refs, shs):
                arr = arrays[by_name[name]]
                if tuple(arr.shape) != tuple(ref.shape):
                    raise ValueError(
                        f"{name}: checkpoint shape {arr.shape} != expected "
                        f"{tuple(ref.shape)}")
                # a copy (np.ascontiguousarray would make a 0-d leaf 1-d)
                t = torch.from_numpy(np.array(arr, order="C")).to(device=dev,
                                                                  dtype=ref.dtype)
                out.append(t if sh is None else distribute(t, sh))
        return _unflatten(state_shape, iter(out)), step
