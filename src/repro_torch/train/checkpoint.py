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

The reference's elastic reshard on restore (``mesh``/``shardings``) waits
for Slice F3 (ROADMAP): here every leaf is restored onto its template
leaf's device and dtype.
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


def save(state, step: int, directory: str, keep_last: int = 3) -> str:
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

    def save(self, state, step: int, directory: str, keep_last: int = 3):
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


def restore(state_template, directory: str, step: Optional[int] = None):
    """Rebuild `state_template`'s tree from disk (the latest step unless
    `step` is given): each leaf a tensor on its template leaf's device,
    in its dtype.  A shape that differs from the template's raises."""
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
        if list(arr.shape) != list(tmpl.shape):
            raise ValueError(f"{name}: ckpt shape {arr.shape} != "
                             f"template {tuple(tmpl.shape)}")
        return torch.from_numpy(arr).to(device=tmpl.device,
                                        dtype=tmpl.dtype)

    return _rebuild(state_template, load)


def _prune(directory: str, keep_last: int):
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
