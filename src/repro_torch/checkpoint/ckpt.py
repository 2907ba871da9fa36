"""Checkpoint save/restore with async write + atomic commit.

Layout (the JAX package's, so each restores the other's):
         <dir>/step_<N>/
             arr_<i>.npy          one file per leaf, in the sorted dict-key
                                  order that ``jax.tree_util`` flattens in
             treedef.json         leaf count and step (the reference also
                                  writes its treedef's text; not read back)
             COMMIT               written LAST — a step without COMMIT is
                                  incomplete and ignored by discovery

A tree is a nested dict whose leaves are tensors, numpy arrays or Python
numbers. bfloat16 (which numpy has no type for) is saved as float32, which
is value-exact, and cast back on restore to the template leaf's dtype and
device. Async mode hands host copies to a writer thread so the train loop
never blocks on disk; ``wait()`` joins before the next save or exit.
Restart: ``latest_step`` scans for the newest committed step, so a job
killed mid-save restarts from the previous complete checkpoint.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from ..models.common import tree_leaves


def _to_numpy(x):
    """Host copy in an npy-round-trippable dtype (always a copy: the async
    writer must not observe later in-place updates of the live tree)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    return np.array(x)


def _unflatten(template, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(template)


def save_pytree(tree, directory, step: int):
    """Synchronous save with atomic commit marker."""
    d = Path(directory) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = [leaf for _, leaf in tree_leaves(tree)]
    for i, leaf in enumerate(flat):
        np.save(tmp / f"arr_{i}.npy", _to_numpy(leaf))
    (tmp / "treedef.json").write_text(json.dumps(
        {"paths": [p for p, _ in tree_leaves(tree)], "n_leaves": len(flat),
         "step": step}))
    if d.exists():
        shutil.rmtree(d)
    tmp.rename(d)
    (d / "COMMIT").write_text("ok")
    return d


def restore_pytree(template, directory, step: int):
    """Restore into the structure of ``template``: a tensor leaf of the
    template takes the saved values in its dtype on its device; any other
    leaf comes back as the saved numpy array."""
    d = Path(directory) / f"step_{step:08d}"
    if not (d / "COMMIT").exists():
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    out = []
    for i, (path, leaf) in enumerate(tree_leaves(template)):
        arr = np.load(d / f"arr_{i}.npy")
        if isinstance(leaf, torch.Tensor):
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"leaf {i} {path}: saved shape "
                                 f"{arr.shape} != template {tuple(leaf.shape)}")
            out.append(torch.from_numpy(arr).to(device=leaf.device,
                                                dtype=leaf.dtype))
        else:
            out.append(arr)
    return _unflatten(template, out)


def latest_step(directory) -> int | None:
    d = Path(directory)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*")
                   if (p / "COMMIT").exists())
    return steps[-1] if steps else None


class Checkpointer:
    """Async checkpointer: copy to the host on the caller thread (cheap),
    write on a background thread (slow)."""

    def __init__(self, directory, *, keep: int = 3):
        self.dir = Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save(self, tree, step: int, *, blocking: bool = False):
        self.wait()
        host = _unflatten(tree, [_to_numpy(x) for _, x in tree_leaves(tree)])

        def write():
            save_pytree(host, self.dir, step)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, template):
        step = latest_step(self.dir)
        if step is None:
            return None, None
        return restore_pytree(template, self.dir, step), step

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*")
                       if (p / "COMMIT").exists())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
