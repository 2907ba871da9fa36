"""Dry run of the port: every (arch x shape) cell traced as one rank of the
production mesh, (16, 16) or (2, 16, 16), on the meta device. No card.

The reference (``src/repro/launch/dryrun.py``) lowers and compiles each
cell's step on placeholder host devices and reads XLA's memory and cost
analyses and the compiled HLO. The port's numbers come from what its step
does on the card, played by one rank at an interior coordinate of a
``"fake"`` process group (``torch.distributed``'s, no communication) with
every tensor on the meta device:

  * the rank's arguments from ``launch/steps.py:input_specs`` (its shards
    of the parameters and the AdamW state, its rows of the batch);
  * the parameters and the state made, and the step run, inside
    ``MemTracker``: ``temp_bytes`` is its peak less the state it holds;
  * the step under ``FlopCounterMode`` (the aten matmul family) and a
    dispatch mode that sums each op's input and output bytes (eager, op by
    op, no fusion);
  * each hand-written kernel (``kernels/swa.py``, ``kernels/ssd.py``)
    through the wrappers of the route the card would take, with their
    checks and allocations and no launch, and its work from the formula
    that ``chip_smoke.py``'s bound reads, in ``repro_torch/tally.py``;
  * each collective of ``launch/dist.py`` at its call: kind, operand bytes
    (the reference's convention) and group.

``dot_flops`` is the matmul family plus the kernels' FLOPs. A decode
cell traces one step, one token a sequence (``make_serve_step(mesh=)`` at
the last position of its cache, every slot valid): its FLOPs, bytes,
collectives and peak are those of one token. The reference's skip rule
carries over: ``long_500k`` of a full-attention arch (``LONG_SKIP``) is
``skipped``. ``launch/roofline.py`` turns the records into H100 time
terms.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape train_4k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --driver
                          # one subprocess a cell, half the cores at once

Records go to ``results/dryrun_torch/<arch>__<shape>[_mp].json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as tdist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves

from .. import tally
from ..configs import LONG_SKIP, SHAPES, ShapeSpec
from ..models.common import ModelConfig
from .steps import (abstract_leaves, effective_config, input_specs,
                    materialize, step_fn)

REPO = Path(__file__).resolve().parents[3]
RESULTS = REPO / "results" / "dryrun_torch"
META = torch.device("meta")
SKIP_REASON = ("full-attention arch; long_500k requires sub-quadratic "
               "attention (DESIGN.md §4)")
BYTES_NOTE = "eager, op by op, no fusion: each op's inputs and outputs"


# ---------------------------------------------------------------------------
# One rank of a fake world
# ---------------------------------------------------------------------------
def _register_fake_backend():
    """Registers torch's ``"fake"`` process-group backend (collectives that
    move nothing), which a module of torch's own tests defines; raises a
    clear error on a build of torch without it."""
    try:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            f"build of torch ({torch.__version__}) lacks") from e


@contextlib.contextmanager
def fake_world(world: int, rank: int):
    """A ``"fake"`` default process group of ``world`` ranks, this process
    playing ``rank``; destroyed on the way out. A default group that
    already exists is an error, not a thing to reuse."""
    if tdist.is_initialized():
        raise RuntimeError("a default process group already exists; the "
                           "dry run makes its own fake one")
    _register_fake_backend()
    tdist.init_process_group("fake", store=tdist.HashStore(), rank=rank,
                             world_size=world)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def meta_mesh(shape, axes):
    """A ``launch/mesh.Mesh`` of meta slots."""
    from .mesh import make_mesh
    return make_mesh(shape, axes, devices=[META] * int(np.prod(shape)))


def interior_rank(shape) -> int:
    """The rank at the middle coordinate of every axis."""
    return int(np.ravel_multi_index(tuple(n // 2 for n in shape), shape))


def production_axes(mesh_shape) -> tuple:
    return (("pod", "data", "model") if len(mesh_shape) == 3
            else ("data", "model"))


class OpBytes(TorchDispatchMode):
    """Sums each op's tensor input and output bytes; a view and an
    uninitialised allocation move none."""
    _FREE = {torch.ops.aten.empty.memory_format,
             torch.ops.aten.empty_like.default,
             torch.ops.aten.empty_strided.default,
             torch.ops.aten.new_empty.default,
             torch.ops.aten.new_empty_strided.default}

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func not in self._FREE and not getattr(func, "is_view", False):
            self.total += sum(t.numel() * t.element_size() for t in
                              pytree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def _storage_bytes(tree) -> int:
    seen, total = set(), 0
    for t in pytree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in seen:          # the storage, not a view
                seen.add(st._cdata)
                total += st.nbytes()
    return total


def _as_leaves(out):
    """A step's output as plain tensors (an int8 leaf as its parts)."""
    from ..models.quant import QuantizedArray
    return [x for t in pytree_leaves(out)
            for x in ((t.q, t.s) if isinstance(t, QuantizedArray) else (t,))]


def evaluate(cfg: ModelConfig, shape: ShapeSpec, mesh_shape) -> dict:
    """The step of ``shape`` of the rank at the interior coordinate of a
    mesh of ``mesh_shape`` (axes ``("data", "model")``, or ``("pod",
    "data", "model")`` for three dims) on meta tensors: its memory, FLOPs,
    bytes, collectives and kernel calls; a decode shape's step is one
    token's, at the cache's last position."""
    mesh_shape = tuple(int(n) for n in mesh_shape)
    axes = production_axes(mesh_shape)
    world = int(np.prod(mesh_shape))
    rank = interior_rank(mesh_shape)
    mesh = meta_mesh(mesh_shape, axes)
    args = input_specs(cfg, shape, mesh)
    arg_bytes = sum(leaf.nbytes for a in args
                    for _, leaf in abstract_leaves(a))
    rec = {"mesh": "x".join(map(str, mesh_shape)), "n_devices": world,
           "rank": rank, "coords": dict(zip(axes, (int(i) for i in
                                                   np.unravel_index(
                                                       rank, mesh_shape))))}
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from .dist import process_mesh
    if shape.step == "decode":
        params_spec, token_spec, _, cache_spec = args
        state_specs = [params_spec, cache_spec]
        # the global token, untracked: the step cuts the rank's rows
        batch = [torch.empty(token_spec.shape, dtype=token_spec.dtype,
                             device=META), shape.seq_len - 1]
        batch_bytes = token_spec.nbytes

        def call(fn, state):
            return fn(state[0], *batch, state[1])
    else:
        *state_specs, batch_spec = args
        # the global batch, untracked: the step cuts the rank's rows from it
        batch = {k: torch.empty(v.shape, dtype=v.dtype, device=META)
                 for k, v in batch_spec.items()}
        batch_bytes = sum(v.nbytes for v in batch_spec.values())

        def call(fn, state):
            return fn(*state, batch)
    with fake_world(world, rank):
        pm = process_mesh(mesh, rank)
        fn, donate = step_fn(cfg, shape, pm)
        mt = MemTracker()
        with mt:
            state = [materialize(a) for a in state_specs]
            # the donated arguments: (params, opt_state) or the cache
            donated = state if shape.step == "train" else state[1:]
            state_bytes = _storage_bytes(state)
            with FlopCounterMode(display=False) as fc, OpBytes() as ob, \
                    tally.counting() as counted:
                t0 = time.perf_counter()
                with torch.set_grad_enabled(shape.step == "train"):
                    out = call(fn, state)
                trace_s = time.perf_counter() - t0
        peak = mt.get_tracker_snapshot("peak").get(META, {}).get("Total", 0)
        by_axis = pm.collectives_by_axis(counted)
    kflops = counted.kernel_totals("flops")
    rec.update(
        status="ok", trace_s=round(trace_s, 3),
        memory={"argument_bytes": arg_bytes,
                "output_bytes": _storage_bytes(_as_leaves(out)),
                "alias_bytes": _storage_bytes(donated) if donate else 0,
                "temp_bytes": peak - state_bytes,
                "peak_bytes": peak + batch_bytes},
        collectives=counted.by_kind(), collectives_by_axis=by_axis,
        dot_flops=float(fc.get_total_flops()) + sum(kflops.values()),
        aten_dot_flops=float(fc.get_total_flops()),
        kernel_calls=counted.kernel_totals("calls"), kernel_flops=kflops,
        kernel_bytes=counted.kernel_totals("bytes"),
        bytes_accessed=float(ob.total + sum(
            counted.kernel_totals("bytes").values())),
        bytes_accessed_note=BYTES_NOTE)
    return rec


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------
def run_cell(arch: str, shape_name: str, multi_pod: bool, *, save=True,
             override_cfg=None, tag="", mesh_shape=None):
    """The record of one (arch, shape) cell on the production mesh, or on
    a (data, model) ``mesh_shape`` of the caller's (single pod only)."""
    from ..configs import get_config
    shape = SHAPES[shape_name]
    base = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod}
    if shape_name == "long_500k" and arch in LONG_SKIP:
        rec = {**base, "status": "skipped", "reason": SKIP_REASON}
        print(f"[dryrun] {arch} {shape_name}: skipped", flush=True)
        if save:
            _save(rec, tag)
        return rec
    if mesh_shape is not None:
        assert not multi_pod and len(mesh_shape) == 2
        grid = tuple(mesh_shape)
    else:
        grid = (2, 16, 16) if multi_pod else (16, 16)
    cfg = override_cfg or get_config(arch)
    rec = {**base, **evaluate(cfg, shape, grid)}
    rec["effective_config"] = {
        k: getattr(effective_config(cfg, shape), k)
        for k in ("attention", "window", "n_layers", "grad_accum",
                  "opt_state_dtype", "serve_quant")}
    mem = rec["memory"]
    print(f"[dryrun] {arch} {shape_name} {rec['mesh']}: {rec['status']} "
          + (f"trace {rec['trace_s']:.1f}s dot_flops={rec['dot_flops']:.4e} "
             f"temp={mem['temp_bytes']} " if rec["status"] == "ok" else "")
          + f"args={mem['argument_bytes']}", flush=True)
    if save:
        _save(rec, tag)
    return rec


def _cell_path(arch, shape_name, multi_pod, tag=""):
    sfx = "_mp" if multi_pod else ""
    t = f"_{tag}" if tag else ""
    return RESULTS / f"{arch}__{shape_name}{sfx}{t}.json"


def _save(rec, tag=""):
    RESULTS.mkdir(parents=True, exist_ok=True)
    p = _cell_path(rec["arch"], rec["shape"], rec["multi_pod"], tag)
    p.write_text(json.dumps(rec, indent=1))


def _drive(cell):
    """One cell in a fresh subprocess; an error record if it fails."""
    a, s, mp = cell
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
           "--shape", s] + (["--multi-pod"] if mp else [])
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=str(REPO),
                       env=env)
    if r.returncode != 0:
        err = (r.stderr or "")[-2000:]
        _save({"arch": a, "shape": s, "multi_pod": mp, "status": "error",
               "error": err})
        print(f"[dryrun] FAIL {a} {s}: {err[-400:]}", flush=True)
    else:
        print(r.stdout.strip(), f"({time.perf_counter() - t0:.0f}s)",
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--driver", action="store_true",
                    help="run each cell in a fresh subprocess (isolates "
                         "failures)")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        from ..configs import ARCHS
        cells = [(a, s, mp) for a in ARCHS for s in SHAPES
                 for mp in (False, True)]
        todo = [c for c in cells if args.force or not _cell_path(*c).exists()]
        print(f"[dryrun] {len(todo)}/{len(cells)} cells to run", flush=True)
        if args.driver:
            with ThreadPoolExecutor(max(1, (os.cpu_count() or 2) // 2)
                                    ) as pool:
                list(pool.map(_drive, todo))
        else:
            for a, s, mp in todo:
                try:
                    run_cell(a, s, mp)
                except Exception:
                    _save({"arch": a, "shape": s, "multi_pod": mp,
                           "status": "error",
                           "error": traceback.format_exc()[-2000:]})
                    traceback.print_exc()
        return

    rec = run_cell(args.arch, args.shape, args.multi_pod)
    if rec.get("status") == "error":
        sys.exit(1)


if __name__ == "__main__":
    main()
