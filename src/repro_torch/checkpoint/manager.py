"""Fault-tolerant checkpointing (the torch port of
``repro.checkpoint.manager``), in the reference's on-disk format, so a
checkpoint written by either package restores in the other:

  * one ``step_XXXXXXXX/`` directory per checkpoint:
      - ``manifest.json``  — flat keypath → {shape, dtype} + metadata
        (step, data-iterator state)
      - ``arrays.npz``     — one entry per leaf, keyed by the ``/``-joined
        key path
      - ``_COMMITTED``     — commit marker written *last*; restore ignores
        uncommitted (crashed mid-write) checkpoints
  * **async save**: the device → host copy happens synchronously,
    serialization runs on a background thread so the train loop continues.
  * **restore** into a target tree: each leaf goes to its target's device
    (or the given one) with the dtype it was saved with; given
    ``shardings``, each leaf is placed onto the current mesh — the elastic
    reshard: a checkpoint saved under one mesh restores under another.
  * **sharded state**: ``save`` gathers each DTensor leaf with
    ``full_tensor()``, a collective, so every rank calls ``save`` (on the
    calling thread, before the background write); rank 0 writes.
  * retention: keep the latest ``max_to_keep``.

bfloat16 leaves are refused on save: ``np.savez`` has no bfloat16, and the
reference's bfloat16 leaves do not round-trip through it either.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from ..models.layers import P, flatten_with_paths
from ..sharding.partitioning import distribute_tree, is_dtensor

__all__ = ["CheckpointManager"]


def _flatten(tree) -> dict:
    return {"/".join(str(k) for k in path): leaf for path, leaf in flatten_with_paths(tree)}


def _unflatten_like(tree, values: dict, prefix: tuple = ()):
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], values, prefix + (k,)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(t, values, prefix + (i,)) for i, t in enumerate(tree))
    return values["/".join(str(k) for k in prefix)]


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _to_host(key: str, v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            raise TypeError(f"checkpoint leaf {key!r} is bfloat16, which np.savez cannot "
                            "store; cast it to float32 before saving")
        return v.detach().cpu().numpy()
    return np.asarray(v)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save -------------------------------------------------------------------
    def save(self, step: int, state, extra: dict | None = None,
             blocking: bool = False):
        self.wait()  # one in-flight save at a time
        rank0 = _rank() == 0
        host_arrays = {}
        for k, v in _flatten(state).items():
            if is_dtensor(v):
                v = v.full_tensor()      # a collective: every rank gathers, rank 0 keeps it
            if rank0:
                host_arrays[k] = _to_host(k, v)
            del v
        if not rank0:
            return

        def write():
            path = os.path.join(self.dir, f"step_{step:08d}")
            tmp = path + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host_arrays)
            manifest = {
                "step": step,
                "extra": extra or {},
                "leaves": {
                    k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                    for k, v in host_arrays.items()
                },
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
                f.write("ok")
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            self._cleanup()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _cleanup(self):
        for s in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- restore -----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, name)
            if name.startswith("step_") and os.path.exists(os.path.join(full, "_COMMITTED")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target, device=None, shardings=None):
        """Rebuild ``target``-structured state (a tree of tensors or of
        :class:`~repro_torch.models.layers.P` specs): each leaf on
        ``device`` if given, else on its target tensor's device (the CPU
        for a spec), with the dtype it was saved with.  With ``shardings``
        (a tree of :class:`~repro_torch.sharding.NamedSharding` of the same
        structure) each leaf is then placed onto that sharding's mesh
        (``distribute_tree``: every rank keeps its shard of the array it
        read, with no collective), whatever mesh it was saved from."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        out = {}
        flat_sh = _flatten(shardings) if shardings is not None else None
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key, like in _flatten(target).items():
                arr = data[key]
                if tuple(arr.shape) != tuple(like.shape):
                    raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, "
                                     f"the target {tuple(like.shape)}")
                dev = device if device is not None else (
                    "cpu" if isinstance(like, P) or is_dtensor(like) or like.device.type == "meta"
                    else like.device)
                leaf = torch.from_numpy(np.array(arr)).to(dev)
                # placed leaf by leaf, so a rank holds one whole leaf at a time
                out[key] = leaf if shardings is None else distribute_tree(leaf, flat_sh[key])
        return _unflatten_like(target, out)

    def restore_manifest(self, step: int) -> dict:
        path = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        with open(path) as f:
            return json.load(f)
