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
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state) -> str:
        names, leaves = _flatten_with_names(state)
        return self._write(step, names, [_to_host(t) for t in leaves])

    def save_async(self, step: int, state) -> None:
        self.wait()
        names, leaves = _flatten_with_names(state)
        # on this thread, to completion: the state changes in place next step
        host = [_to_host(t) for t in leaves]
        self._thread = threading.Thread(
            target=self._write, args=(step, names, host), daemon=True
        )
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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

    def restore(self, state_shape, step: int | None = None, device="cuda"):
        """Rebuild the state tree; returns (state, step).  ``state_shape``
        gives the structure, shapes and dtypes (``abstract_train_state``'s
        meta tensors, or a real state); every leaf is put on ``device`` (the
        card by default) in its target dtype."""
        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        names, refs = _flatten_with_names(state_shape)
        with np.load(os.path.join(d, "arrays.npz")) as arrays:
            by_name = {leaf["name"]: leaf["key"] for leaf in manifest["leaves"]}
            missing = [n for n in names if n not in by_name]
            if missing:
                raise KeyError(f"checkpoint {d} missing leaves: {missing[:5]}...")
            out = []
            for name, ref in zip(names, refs):
                arr = arrays[by_name[name]]
                if tuple(arr.shape) != tuple(ref.shape):
                    raise ValueError(
                        f"{name}: checkpoint shape {arr.shape} != expected "
                        f"{tuple(ref.shape)}")
                # a copy (np.ascontiguousarray would make a 0-d leaf 1-d)
                out.append(torch.from_numpy(np.array(arr, order="C"))
                           .to(device=dev, dtype=ref.dtype))
        return _unflatten(state_shape, iter(out)), step
