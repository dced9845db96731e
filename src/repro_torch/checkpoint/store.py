"""Mesh-agnostic checkpointing with async save (fault tolerance substrate).

The port of the JAX package's ``repro.checkpoint.store``, in its file
format: ``step_%08d/arrays.npz`` holding ``leaf_0 ... leaf_{n-1}`` and
``manifest.json`` with ``step``, ``n_leaves``, ``treedef`` and ``dtypes``,
bf16 stored as its ``uint16`` bits. A tree is nested dicts, lists and
tuples of tensors (or numpy arrays), flattened as JAX flattens a pytree:
dict keys sorted, sequences in order. So a train state in the reference's
layout (:func:`repro_torch.convert.train_state_tree`) is written leaf for
leaf as the reference writes its own, and a checkpoint restores in either
package. bf16 goes to ``uint16`` and back through ``Tensor.view`` alone,
so no numpy bfloat16 type is needed. Saves snapshot the leaves to host
memory synchronously and write on a background thread (async
checkpointing); a write is atomic through a ``.tmp`` directory rename.
Retention keeps the newest ``keep`` steps.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["CheckpointConfig", "CheckpointStore"]


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str = "checkpoints"
    keep: int = 3
    async_save: bool = True


def _flatten(tree, is_leaf=lambda x: False) -> list:
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v, is_leaf)]
    return [tree]


def _is_sharding(x) -> bool:
    """A ``(mesh, spec)`` pair of a ``shardings`` tree."""
    return isinstance(x, tuple) and len(x) == 2 and hasattr(x[0], "mesh_dim_names")


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _treedef(tree) -> str:
    """The tree's structure as JAX prints a ``PyTreeDef``'s body."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as npz stores it, and its type's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.array(leaf)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, want: str | None) -> torch.Tensor:
    if want == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if want and str(a.dtype) != want:
        a = a.astype(want)
    return torch.from_numpy(np.array(a))


class CheckpointStore:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        os.makedirs(cfg.directory, exist_ok=True)
        self._pending: threading.Thread | None = None
        self._error: Exception | None = None

    # ------------------------------------------------------------------ save
    def _write(self, step: int, arrays: dict, dtypes: dict, treedef: str):
        final = os.path.join(self.cfg.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(arrays),
                       "treedef": treedef, "dtypes": dtypes}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._retain()

    def _write_async(self, *args):
        try:
            self._write(*args)
        except Exception as e:          # handed to the caller by wait()
            self._error = e

    def _retain(self):
        steps = self.all_steps()
        for s in steps[: -self.cfg.keep]:
            shutil.rmtree(os.path.join(self.cfg.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, step: int, state) -> None:
        """Snapshot ``state`` (the device-to-host copy happens now; the file
        write happens on a background thread when ``async_save``)."""
        self.wait()
        arrays, dtypes = {}, {}
        for i, leaf in enumerate(_flatten(state)):
            arrays[f"leaf_{i}"], dtypes[f"leaf_{i}"] = _to_host(leaf)
        args = (step, arrays, dtypes, f"PyTreeDef({_treedef(state)})")
        if self.cfg.async_save:
            self._pending = threading.Thread(target=self._write_async, args=args)
            self._pending.start()
        else:
            self._write(*args)

    def wait(self):
        """Wait for a pending write; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.cfg.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like_tree, step: int | None = None, shardings=None):
        """Restore into the structure of ``like_tree``: ``(tree, step)``,
        each leaf a CPU tensor in the type of ``like_tree``'s leaf, or
        ``(None, None)`` when there is no checkpoint. A leaf count or shape
        that differs from ``like_tree``'s raises ``ValueError``.

        ``shardings``, a tree matching ``like_tree`` whose leaves are
        ``(mesh, spec)`` pairs (a ``DeviceMesh`` and a
        :class:`repro_torch.parallel.P`), places each leaf as a DTensor
        holding this rank's shard, the elastic re-mesh path (the
        reference places each leaf by its ``NamedSharding``), on the
        mesh's device type."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.cfg.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        like = _flatten(like_tree)
        if manifest["n_leaves"] != len(like):
            raise ValueError(f"checkpoint step {step} has {manifest['n_leaves']} "
                             f"leaves, the tree to restore into {len(like)}")
        dtypes = manifest.get("dtypes", {})
        restored = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for i, l in enumerate(like):
                t = _from_host(data[f"leaf_{i}"], dtypes.get(f"leaf_{i}"))
                if tuple(t.shape) != tuple(l.shape):
                    raise ValueError(f"checkpoint step {step}: leaf {i} is "
                                     f"{tuple(t.shape)}, the tree's {tuple(l.shape)}")
                if isinstance(l, torch.Tensor):
                    t = t.to(l.dtype)
                restored.append(t)
        if shardings is not None:
            from ..parallel import distribute_tensor

            placed = _flatten(shardings, _is_sharding)
            if len(placed) != len(restored):
                raise ValueError(f"restore: {len(placed)} shardings for "
                                 f"{len(restored)} leaves")
            restored = [distribute_tensor(t, spec, mesh) for t, (mesh, spec)
                        in zip(restored, placed)]
        return _unflatten(like_tree, iter(restored)), step
