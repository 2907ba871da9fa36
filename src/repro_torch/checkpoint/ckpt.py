"""Checkpoint save/restore with async write + atomic commit, on one device
or on a mesh.

Layout (the JAX package's, so each restores the other's):
         <dir>/step_<N>/
             arr_<i>.npy          one file per leaf, whole, in the sorted
                                  dict-key order that ``jax.tree_util``
                                  flattens in
             treedef.json         leaf paths, leaf count and step (the
                                  reference writes its treedef's text; not
                                  read back)
             COMMIT               written LAST — a step without COMMIT is
                                  incomplete and ignored by discovery

A tree is a nested dict whose leaves are tensors, numpy arrays or Python
numbers. bfloat16 (which numpy has no type for) is saved as float32, which
is value-exact, and cast back on restore to the template leaf's dtype and
device. Async mode hands host copies to a writer thread so the train loop
never blocks on disk; ``wait()`` joins before the next save or exit (and
raises what the writer raised). Restart: ``latest_step`` scans for the
newest committed step, so a job killed mid-save restarts from the previous
complete checkpoint.

On a mesh (``Checkpointer(..., mesh=, specs=)``, ``mesh`` a
``launch/dist.ProcessMesh`` and ``specs`` the tree's specs) the tree holds
this rank's shards. Every rank calls ``save`` in the same order: each
leaf in turn is gathered over the groups that cut it, and rank 0 alone
copies it to the host and queues it for its writer thread, so one full
leaf is on a card at a time and the writer only ever holds host copies.
The files are those of one device: an int8 AdamW moment's codes are the
padded full row's and its scales the full row's (``optim/adamw.py:_Row``),
as the reference's ``np.array`` of its global leaf. A restore reads the
step that rank 0 finds, and each rank keeps its slice of each file
(``dist.shard`` of a memory-mapped array), so a checkpoint written on one
mesh shape restores on another, or on one device.
"""
from __future__ import annotations

import json
import queue
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from ..models.common import tree_leaves

WRITE_QUEUE = 2        # host copies of full leaves waiting for the writer


def _to_numpy(x):
    """Host copy in an npy-round-trippable dtype (always a copy: the async
    writer must not observe later in-place updates of the live tree)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()
    return np.array(x)


def _unflatten(template, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(template)


def _write(leaves, paths, directory, step: int):
    """Write ``leaves`` (an iterable, in the order of ``paths``) as
    ``step``, committing it last."""
    d = Path(directory) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    n = 0
    for i, leaf in enumerate(leaves):
        np.save(tmp / f"arr_{i}.npy", _to_numpy(leaf))
        n += 1
    if n != len(paths):
        raise ValueError(f"{n} leaves written for {len(paths)} paths")
    (tmp / "treedef.json").write_text(json.dumps(
        {"paths": list(paths), "n_leaves": n, "step": step}))
    if d.exists():
        shutil.rmtree(d)
    tmp.rename(d)
    (d / "COMMIT").write_text("ok")
    return d


def save_pytree(tree, directory, step: int):
    """Synchronous save with atomic commit marker."""
    flat = list(tree_leaves(tree))
    return _write((leaf for _, leaf in flat), [p for p, _ in flat],
                  directory, step)


def gathered_leaves(tree, specs, mesh):
    """(path, leaf) of a tree of this rank's shards in flatten order, each
    tensor gathered whole over the groups of ``mesh`` that cut it (its
    spec in ``specs``), one leaf at a time. Every rank must iterate it to
    the end, in step with the others."""
    spec_of = dict(tree_leaves(specs))
    for path, leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            with torch.no_grad():
                leaf = mesh.gather(leaf, spec_of[path]).detach()
        yield path, leaf


def restore_pytree(template, directory, step: int, *, specs=None,
                   mesh=None):
    """Restore into the structure of ``template``: a tensor leaf of the
    template takes the saved values in its dtype on its device; any other
    leaf comes back as the saved numpy array. With ``mesh`` (anything with
    the ``ax`` and ``coords`` of a ``launch/dist.ProcessMesh``) and
    ``specs``, each tensor leaf of the template is this rank's shard and
    takes its slice of the whole saved leaf (no collective)."""
    from ..launch.dist import shard
    d = Path(directory) / f"step_{step:08d}"
    if not (d / "COMMIT").exists():
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    spec_of = dict(tree_leaves(specs)) if mesh is not None else {}
    out = []
    for i, (path, leaf) in enumerate(tree_leaves(template)):
        f = d / f"arr_{i}.npy"
        if not isinstance(leaf, torch.Tensor):
            out.append(np.load(f))
            continue
        arr = np.load(f, mmap_mode="r" if mesh is not None else None)
        if mesh is not None:
            arr = shard(arr, spec_of[path], mesh.ax, mesh.coords)
        if tuple(arr.shape) != tuple(leaf.shape):
            where = " (this rank's slice)" if mesh is not None else ""
            raise ValueError(f"leaf {i} {path}: saved shape{where} "
                             f"{arr.shape} != template {tuple(leaf.shape)}")
        out.append(torch.from_numpy(np.array(arr)).to(device=leaf.device,
                                                     dtype=leaf.dtype))
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
    write on a background thread (slow). With ``mesh`` and ``specs`` the
    trees are this rank's shards (see the module's docstring); every rank
    calls ``save`` and ``restore_latest``, and rank 0 writes."""

    def __init__(self, directory, *, keep: int = 3, mesh=None, specs=None):
        if (mesh is None) != (specs is None):
            raise ValueError("a mesh checkpoint needs both mesh and specs")
        self.dir = Path(directory)
        self.keep = keep
        self.mesh, self.specs = mesh, specs
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    @property
    def writes(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _start(self, fn, blocking: bool):
        def run():
            try:
                fn()
            except Exception as e:           # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def save(self, tree, step: int, *, blocking: bool = False):
        self.wait()
        paths = [p for p, _ in tree_leaves(tree)]
        if self.mesh is None:
            host = [_to_numpy(x) for _, x in tree_leaves(tree)]
            self._start(lambda: self._write(iter(host), paths, step),
                        blocking)
            return
        q = queue.Queue(maxsize=WRITE_QUEUE) if self.writes else None
        if self.writes:
            self._start(lambda: self._write(
                (q.get() for _ in paths), paths, step), False)
        for _, full in gathered_leaves(tree, self.specs, self.mesh):
            if q is not None:
                # blocks while the writer is WRITE_QUEUE leaves behind; a
                # writer that failed drains the queue (see _write)
                q.put(_to_numpy(full))
            del full
        if blocking:
            self.wait()

    def _write(self, leaves, paths, step):
        try:
            _write(leaves, paths, self.dir, step)
        finally:
            for _ in leaves:           # unblock a producer after a failure
                pass
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, template):
        """(the newest committed step restored into ``template``, its
        step), or (None, None). On a mesh every rank restores the step
        that rank 0 finds."""
        if self.mesh is None:
            step = latest_step(self.dir)
        else:
            step = self.mesh.broadcast_object(
                latest_step(self.dir) if self.mesh.rank == 0 else None)
        if step is None:
            return None, None
        return restore_pytree(template, self.dir, step, specs=self.specs,
                              mesh=self.mesh), step

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*")
                       if (p / "COMMIT").exists())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
