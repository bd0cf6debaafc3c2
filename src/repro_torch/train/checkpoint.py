"""Checkpoints in the reference's on-disk layout: counterpart of
``repro/train/checkpoint.py:29-174``.

Layout (one directory per step)::

    ckpt_dir/step_000123/
      METADATA.json          # step, treedef, n_leaves, index (+ extra keys)
      leaf_00000.npy ...     # one .npy per leaf

The leaves are numbered in ``jax.tree_util``'s order: a NamedTuple's fields
in order, a dict's keys sorted, a list's items in order.  For a
``TrainState(params, AdamWState(step, m, v))`` that is the params in
sorted-key order, then the step, then m, then v, as the reference writes
them, so a checkpoint written by either package restores into the other.
A save writes a ``.tmp`` directory and renames it into place, so a crash
mid-save never leaves a half-written latest checkpoint.  Restore reads the
leaves into the target's structure, checks their count and shapes, and puts
each on the target leaf's device in its dtype.  bf16 leaves, which numpy has
no type for, are written as f32 (exact) and cast back on restore.

Sharded state (DTensor leaves): a save gathers every DTensor leaf whole
(``full_tensor``, a collective over its mesh) on the calling thread, so that
every rank issues its collectives from one thread in one order; only the
gathered host arrays go to :class:`AsyncCheckpointer`'s worker thread.  The
mesh's first rank writes, and the others wait at a barrier over the mesh
(after a synchronous write, or in :meth:`AsyncCheckpointer.wait`).  The file
format is the same.  ``restore(..., shardings=)`` places each leaf straight
onto a mesh, which may differ from the one the checkpoint was saved from.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.parallel import sharding


def _flatten(tree) -> list:
    """The leaves of a tree of NamedTuples, dicts, lists and tuples, in
    ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _flatten(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _flatten(item)]
    return [tree]


def _unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` (an iterator) in order."""
    if isinstance(tree, dict):
        return {key: _unflatten(tree[key], leaves) for key in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(item, leaves) for item in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(item, leaves) for item in tree)
    return next(leaves)


def _describe(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{key!r}: {_describe(tree[key])}" for key in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(item) for item in tree)
        return f"{type(tree).__name__}({inner})" if hasattr(tree, "_fields") else f"[{inner}]"
    return "*"


def _to_host(leaf) -> np.ndarray:
    """A host copy of a leaf as a numpy array (bf16 as f32)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _mesh_of(leaves):
    """The mesh of the first DTensor among ``leaves`` (None if there is none)."""
    for leaf in leaves:
        if sharding.is_dtensor(leaf):
            return leaf.device_mesh
    return None


def _gather(tree):
    """(host copy of ``tree``, the mesh its DTensor leaves live on or None):
    each DTensor leaf gathered whole first, on the calling thread."""
    leaves = _flatten(tree)
    host = [_to_host(sharding.full_tensor(leaf)) for leaf in leaves]
    return _unflatten(tree, iter(host)), _mesh_of(leaves)


def _is_writer(mesh) -> bool:
    return mesh is None or int(mesh.mesh.flatten()[0]) == torch.distributed.get_rank()


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` waits until all have arrived: a barrier along
    each mesh dim in turn, which holds every rank until all have entered
    the first."""
    if mesh is None:
        return
    for dim in range(mesh.ndim):
        if mesh.size(dim) > 1:
            torch.distributed.barrier(group=mesh.get_group(dim))


def save(ckpt_dir: str, step: int, tree, extra_metadata: dict | None = None) -> str:
    """Synchronous checkpoint write.  Returns the checkpoint path.  With
    DTensor leaves every rank of their mesh calls it: the leaves are
    gathered, the first rank writes, all return after the write."""
    tree, mesh = _gather(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _is_writer(mesh):
        _write(final, step, tree, extra_metadata)
    _barrier(mesh)
    return final


def _write(final: str, step: int, tree, extra_metadata: dict | None) -> None:
    """Writes the host tree ``tree`` as checkpoint directory ``final``."""
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    index = []
    for i, leaf in enumerate(_flatten(tree)):
        arr = _to_host(leaf)
        name = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, name), arr)
        index.append({"file": name, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    meta = {
        "step": step,
        "treedef": _describe(tree),
        "n_leaves": len(index),
        "index": index,
        **(extra_metadata or {}),
    }
    with open(os.path.join(tmp, "METADATA.json"), "w") as fh:
        json.dump(meta, fh)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)


class AsyncCheckpointer:
    """Background-thread checkpoint writes with a completion barrier."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._mesh = None
        self._error: Exception | None = None
        self.last_path: str | None = None

    def save(self, step: int, tree, extra_metadata: dict | None = None):
        self.wait()
        # snapshot to host before returning: the caller may go on to replace
        # or overwrite the device tensors while the write runs
        host_tree, self._mesh = _gather(tree)
        final = os.path.join(self.ckpt_dir, f"step_{step:08d}")
        if not _is_writer(self._mesh):
            self.last_path = final
            return

        def work():
            try:
                _write(final, step, host_tree, extra_metadata)
                self.last_path = final
                self._gc()
            except Exception as e:  # surfaced at the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Returns once the last save is on disk (on every rank of a sharded
        save's mesh: the writer joins its thread, then all meet at the
        barrier, on the calling thread)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            _barrier(mesh)
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _gc(self):
        steps = list_steps(self.ckpt_dir)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, target_tree, step: int | None = None, shardings=None):
    """Restore into the structure of ``target_tree`` (the latest step unless
    ``step`` is given).  Returns (tree, metadata).  Each leaf lands on its
    target leaf's device in its dtype; a numpy target leaf gets a numpy array.

    ``shardings`` (optional, ``target_tree``'s structure with a
    :class:`repro_torch.parallel.sharding.Sharding` or None at each leaf)
    places each leaf straight onto that mesh: every rank reads the file and
    keeps its slice, nothing is sent.  Restoring a checkpoint saved on a
    (2, 2) mesh onto (1, 2), or onto no mesh, is just another ``shardings``;
    the target's leaves give only shapes and dtypes."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "METADATA.json")) as fh:
        meta = json.load(fh)
    leaves = _flatten(target_tree)
    if meta["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves; target expects "
            f"{len(leaves)} — architecture mismatch"
        )
    places = _flatten_shardings(target_tree, shardings)
    restored = []
    for i, (leaf, place) in enumerate(zip(leaves, places)):
        arr = np.load(os.path.join(path, meta["index"][i]["file"]))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != target {tuple(leaf.shape)}"
            )
        if place is not None:
            from torch.distributed.tensor import distribute_tensor

            full = torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
            restored.append(distribute_tensor(full, place.mesh, place.placements,
                                              src_data_rank=None))
        elif isinstance(leaf, torch.Tensor):
            restored.append(torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype))
        else:
            restored.append(arr.astype(leaf.dtype))
    return _unflatten(target_tree, iter(restored)), meta


def _flatten_shardings(target_tree, shardings) -> list:
    """The leaves of ``shardings`` in ``target_tree``'s leaf order (a
    :class:`Sharding` is a leaf there, not a tuple to descend into)."""
    if shardings is None or isinstance(shardings, sharding.Sharding):
        return [shardings] * len(_flatten(target_tree))
    if isinstance(target_tree, dict):
        return [x for key in sorted(target_tree)
                for x in _flatten_shardings(target_tree[key], shardings[key])]
    if isinstance(target_tree, (list, tuple)):
        return [x for t, sh in zip(target_tree, shardings)
                for x in _flatten_shardings(t, sh)]
    return [shardings]
