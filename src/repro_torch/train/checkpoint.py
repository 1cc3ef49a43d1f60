"""Checkpointing (port of ``repro/train/checkpoint.py``): atomic, in the
reference's on-disk format exactly, so either package reads the other's
checkpoints.

Layout:  <dir>/step_<n>/
           manifest.json    — step, leaf paths, shapes, dtypes
           <leaf-path>.npy  — one file per leaf (full logical array)

Leaf paths are the reference's ``jax.tree_util`` key paths: a NamedTuple
field is ``.name``, a dict key its string, an index its number, joined
with ``/`` (``.step``, ``.params/embed/tokens``, ``.opt/.m/...``); the file
is the path with ``/`` -> ``__`` plus ``.npy``.

* **atomic**  — written to step_<n>.tmp then renamed; a crash mid-save
  never corrupts the latest checkpoint; restore picks the newest complete
  manifest.
* **async**   — `AsyncSaver` copies the state to the host on the caller's
  thread and writes the files on a background thread.
* **bounded** — keep_last prunes old steps.
* **sharded** — a state of a sharded step (each rank its shards under
  the param rules, ``train/step.py``) is saved with ``mesh=`` and the
  params' ``specs=``: every rank takes part in gathering each leaf whole
  (`gather_whole`, over the axes its spec cuts), and rank 0 writes the
  full logical arrays, the reference's format.
* **elastic** — ``restore(..., mesh=)`` gives each rank its block of
  every leaf under the target mesh's specs (the partition rules on the
  leaf's full shape from the manifest), whatever mesh wrote it: the
  reference's reshard on restore.  Without a mesh every leaf is restored
  whole onto its template leaf's device and dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key-path entry, child) pairs in ``jax.tree_util``'s order and
    naming, or None for a leaf."""
    if _is_namedtuple(tree):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for key, child in kids:
        out.update(_flatten(child, f"{prefix}/{key}" if prefix else key))
    return out


def _rebuild(tree, fn, prefix: str = ""):
    """`tree`'s structure with each leaf replaced by ``fn(path, leaf)``."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    vals = [_rebuild(c, fn, f"{prefix}/{k}" if prefix else k)
            for k, c in kids]
    if _is_namedtuple(tree):
        return type(tree)(*vals)
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), vals))
    return type(tree)(vals)


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _param_path(name: str) -> Optional[str]:
    """The dotted param path of checkpoint leaf `name` (params and AdamW's
    m and v alike); None for the step."""
    for prefix in (".params/", ".opt/.m/", ".opt/.v/"):
        if name.startswith(prefix):
            return name[len(prefix):].replace("/", ".")
    return None


def leaf_spec(name: str, shape, mesh) -> tuple:
    """The filtered spec of checkpoint leaf `name` (of full `shape`) on
    `mesh`: the param rules for params and AdamW's m and v, replicated
    for the step (``core/partitioning.py``)."""
    from repro_torch.core import partitioning as part
    path = _param_path(name)
    if path is None:
        return ()
    return part.filter_spec(part.spec_for_param(path, len(shape)),
                            tuple(shape), mesh)


def gather_whole(state, mesh, specs):
    """The whole state from this rank's shards: each leaf of a sharded
    state (`specs`: the params' spec tree, which m and v share) gathered
    over the axes its spec cuts (``MeshContext.gather``).  Every rank of
    `mesh` must call it; every rank gets the whole state."""
    from repro_torch.models.common import MeshContext, entry_axes, get_path
    ctx = MeshContext(mesh, specs)

    def whole(name, leaf):
        path = _param_path(name)
        for d, entry in enumerate(() if path is None
                                  else get_path(specs, path)):
            if entry_axes(entry):
                leaf = ctx.gather(leaf, d, entry_axes(entry))
        return leaf

    return _rebuild(state, whole)


def _writer(mesh) -> bool:
    import torch.distributed as dist
    return mesh is None or dist.get_rank() == 0


def save(state, step: int, directory: str, keep_last: int = 3, *,
         mesh=None, specs=None) -> str:
    """Write `state` as step `step` (atomically); with `mesh` (and the
    params' `specs`), a sharded state gathered whole and written by rank
    0 (`gather_whole`), every rank returning once it is on disk."""
    if mesh is not None:
        import torch.distributed as dist
        whole = gather_whole(state, mesh, specs)
        path = (save(whole, step, directory, keep_last) if _writer(mesh)
                else os.path.join(directory, f"step_{step:08d}"))
        dist.barrier()           # written before any rank reads it back
        return path
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": int(step), "leaves": {}}
    for name, leaf in _flatten(state).items():
        arr = _to_numpy(leaf)
        fn = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][name] = {"file": fn, "shape": list(arr.shape),
                                    "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(directory, keep_last)
    return final


class AsyncSaver:
    """Snapshot on the caller thread, serialise on a background thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None

    def save(self, state, step: int, directory: str, keep_last: int = 3,
             *, mesh=None, specs=None):
        if mesh is not None:
            state = gather_whole(state, mesh, specs)
            if not _writer(mesh):
                return
        snapshot = _rebuild(state, lambda _, leaf: _to_numpy(leaf))
        self.wait()
        self._thread = threading.Thread(
            target=save, args=(snapshot, step, directory, keep_last),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(state_template, directory: str, step: Optional[int] = None, *,
            mesh=None):
    """Rebuild `state_template`'s tree from disk (the latest step unless
    `step` is given): each leaf a tensor on its template leaf's device,
    in its dtype.  With `mesh`, `state_template` holds this rank's shards
    and each leaf is its block under `leaf_spec` on `mesh` (the elastic
    reshard).  A shape that differs from the template's raises."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def load(name, tmpl):
        meta = manifest["leaves"][name]
        arr = np.load(os.path.join(d, meta["file"]))
        if mesh is not None:
            from repro_torch.core.partitioning import local_shard
            arr = local_shard(torch.from_numpy(arr),
                              leaf_spec(name, arr.shape, mesh), mesh)
        if list(arr.shape) != list(tmpl.shape):
            raise ValueError(f"{name}: ckpt shape {arr.shape} != "
                             f"template {tuple(tmpl.shape)}")
        return torch.as_tensor(arr).to(device=tmpl.device, dtype=tmpl.dtype,
                                       copy=True)

    return _rebuild(state_template, load)


def _prune(directory: str, keep_last: int):
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
