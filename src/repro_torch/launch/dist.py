"""The SPMD runtime of the port: one process per slot of a ``Mesh``.

The reference trains on a mesh through jax's SPMD runtime: GSPMD places
each parameter by its ``PartitionSpec`` and inserts the collectives, and
two algorithms (the vocab-parallel loss, expert-parallel MoE) are written
out with ``shard_map``. This module does that job for the port with
``torch.distributed``:

  * ``launch`` runs a function in one process per slot of a mesh (or,
    under ``torchrun``, in this process): NCCL when the slots are cards,
    gloo only when the caller names the CPU. A mesh with more slots than
    visible cards raises, and so does a backend that fails to start;
    nothing falls back to the CPU.
  * ``ProcessMesh`` is one rank's view: its coordinates, one process group
    for ``model`` and one for the data axes (``data`` may span
    ``("pod", "data")``), and the collectives, each with the backward that
    the layout needs (``psum``, ``enter``, ``pmax``, ``pmean``,
    ``axis_index``, ``all_gather``; for tensor parallelism over ``model``,
    ``models/tp.py``: ``take``, an all-to-all of asked columns,
    ``allsum`` and ``own``; for the sharded decode, without a gradient,
    ``recut`` and ``reduce_scatter``).
  * ``shard``/``unshard``/``local_shape`` cut a full tensor by a spec
    (``models/common.py``) and put it back, on the host; ``shard_init``
    draws a parameter tree one full leaf at a time and keeps the rank's
    slice; ``per_card_bytes`` counts what a card holds, from the specs.
  * Each collective is counted at its call (kind, operand bytes, group)
    while a dry run's tally is open (``repro_torch/tally.py``,
    ``launch/dryrun.py``); ``ProcessMesh.collectives_by_axis`` names the
    groups.

The gradient rules follow from one convention: compute that is replicated
over an axis gives every rank of it the same cotangent. So a ``psum``'s
backward is the identity, a gather over ``model`` (replicated compute)
hands each rank its own slice of the cotangent, and a gather over the data
axes, whose ranks computed on other batch rows, reduce-scatters (sums)
it. A leaf that the data axes do not cut enters through ``enter`` over
data, so its gradient is summed over the batch shards. Summing over
``model`` instead would double every such gradient at tp 2. Work that is
split over ``model`` (each rank its own heads) is partial: what feeds it
from replicated compute sums its cotangents over ``model`` (``enter``,
``take``'s backward, ``allsum``), and what it hands back to replicated
compute is summed once in the forward (``psum``).
"""
from __future__ import annotations

import dataclasses
import os
import queue
import traceback

import numpy as np
import torch
import torch.distributed as tdist

from .. import tally
from ..models.common import AxisEnv, ParamDecl, tree_map
from .mesh import Mesh, make_mesh

DATA, MODEL = "data", "model"       # the two process groups of a rank
HOST = "127.0.0.1"                  # the launcher's rendezvous store


# ---------------------------------------------------------------------------
# Specs on the host
# ---------------------------------------------------------------------------
def _names(entry) -> tuple:
    return () if entry is None else (
        tuple(entry) if isinstance(entry, tuple) else (entry,))


def _split(entry, ax: AxisEnv) -> int:
    return int(np.prod([ax.size(n) for n in _names(entry)], dtype=np.int64))


def local_shape(shape, spec, ax: AxisEnv) -> tuple:
    """The shape of one shard of a ``shape`` leaf cut by ``spec``."""
    out = list(shape)
    for i, e in enumerate(spec):
        n = _split(e, ax)
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {e} ({n} ways)")
        out[i] //= n
    return tuple(out)


def _index(entry, ax: AxisEnv, coords: dict) -> int:
    """The row-major index of ``coords`` over the axes of a spec entry."""
    idx = 0
    for n in _names(entry):
        idx = idx * ax.size(n) + int(coords.get(n, 0))
    return idx


def shard(full, spec, ax: AxisEnv, coords: dict):
    """The slice of ``full`` (a tensor or array) that the rank at
    ``coords`` (axis name -> index) holds under ``spec``."""
    loc = local_shape(full.shape, spec, ax)
    for i, e in enumerate(spec):
        if e is not None:
            k = _index(e, ax, coords)
            full = full[(slice(None),) * i + (slice(k * loc[i],
                                                    (k + 1) * loc[i]),)]
    return full


def unshard(shards, coords, spec, ax: AxisEnv):
    """The full tensor from the shards of every rank (``coords`` beside
    each), the way back of ``shard``."""
    full_shape = [s * _split(e, ax) for s, e in
                  zip(shards[0].shape, tuple(spec) + (None,) *
                      (shards[0].dim() - len(spec)))]
    out = shards[0].new_empty(full_shape)
    for s, c in zip(shards, coords):
        shard(out, spec, ax, c).copy_(s)
    return out


def shard_init(decls, generator, device, dtype, ax: AxisEnv, coords: dict):
    """``common.init_params`` for one rank: each leaf is drawn whole on
    ``device`` (the same draws as the unsharded init, in its order) and
    only this rank's slice is kept, so one full leaf is resident at a
    time."""
    from ..models.common import _materialize

    def one(d: ParamDecl):
        full = _materialize(d, generator, device, dtype)
        return shard(full, d.spec, ax, coords).clone()

    return tree_map(one, decls)


def per_card_bytes(decls, ax: AxisEnv, default_dtype) -> int:
    """Bytes one card holds of a declaration tree at the axis sizes of
    ``ax``: each leaf's shard made on the meta device (nothing is
    allocated)."""
    from ..models.common import tree_leaves
    total = 0
    for _, d in tree_leaves(decls):
        t = torch.empty(local_shape(d.shape, d.spec, ax), device="meta",
                        dtype=d.dtype or default_dtype)
        total += t.numel() * t.element_size()
    return total


# ---------------------------------------------------------------------------
# Collectives with their backward
# ---------------------------------------------------------------------------
def _all_reduce(x, group, op=tdist.ReduceOp.SUM):
    x = x.contiguous().clone()
    if tally.active():
        tally.collective("all-reduce", x.numel() * x.element_size(), group,
                         tdist.get_world_size(group))
    tdist.all_reduce(x, op=op, group=group)
    return x


def _gather(x, group, n: int, dim: int):
    # all_gather_single is all_gather_into_tensor's newer name
    fn = getattr(tdist, "all_gather_single", None) \
        or tdist.all_gather_into_tensor
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    # the input's bytes: the output's over the group
    tally.collective("all-gather", xt.numel() * xt.element_size(), group, n)
    fn(out, xt, group=group)
    # in the leaf's own layout, so that a product reads it as it reads an
    # unsharded leaf
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(g, group, n: int, dim: int):
    fn = getattr(tdist, "reduce_scatter_single", None) \
        or tdist.reduce_scatter_tensor
    gt = g.movedim(dim, 0).contiguous()
    out = gt.new_empty((gt.shape[0] // n,) + tuple(gt.shape[1:]))
    # the input's bytes: the output's times the group
    tally.collective("reduce-scatter", gt.numel() * gt.element_size(),
                     group, n)
    fn(out, gt, op=tdist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


class _Psum(torch.autograd.Function):
    """Sum over a group; the backward is the identity (the consumers are
    replicated over the group, so the cotangent is already the same on
    every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """Megatron's f: the identity, whose backward sums over the group
    (an input replicated over the group feeds per-rank partial work)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllSum(torch.autograd.Function):
    """Sum over a group whose consumers are per-rank partial work (a sum
    of squares over a feature dim cut over ``model``): the backward sums
    the ranks' partial cotangents too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Own(torch.autograd.Function):
    """This rank's slice (of ``n``) of a tensor that the group holds
    replicated; the backward gathers the slices' cotangents, so the
    replicated producer gets the whole cotangent on every rank."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        w = x.shape[dim] // n
        return x.narrow(dim, index * w, w).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.n, ctx.dim), None, None, None, None


def _all_to_all(x, group, out_sizes, in_sizes):
    """``all_to_all_single`` along dim 0 with these split sizes (rows to
    and from each rank of the group)."""
    out = x.new_empty((sum(out_sizes),) + tuple(x.shape[1:]))
    tally.collective("all-to-all", x.numel() * x.element_size(), group,
                     len(in_sizes))
    tdist.all_to_all_single(out, x.contiguous(), out_sizes, in_sizes,
                            group=group)
    return out


def _pieces(ranges, lo: int, hi: int):
    """The parts of ``ranges`` ((start, stop) pairs, in order) inside
    [lo, hi)."""
    return [(max(a, lo), min(b, hi)) for a, b in ranges
            if max(a, lo) < min(b, hi)]


class _Take(torch.autograd.Function):
    """Each rank's own columns of a leaf that the group cuts along ``dim``
    (rank r holds [r*w, (r+1)*w) of it): ``ranges[j]``, (start, stop)
    pairs of the whole dim in the order rank j wants them, which may
    repeat or skip columns. One all-to-all of only the asked columns;
    its backward is the transposed all-to-all, each rank adding what it
    gets into its shard's columns, so a column that several ranks took
    sums their (partial) cotangents."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim, ranges):
        w = x.shape[dim]
        base = index * w
        send = [_pieces(ranges[j], base, base + w) for j in range(n)]
        recv = [_pieces(ranges[index], r * w, (r + 1) * w) for r in range(n)]
        xt = x.movedim(dim, 0)
        parts = [xt[a - base:b - base] for sj in send for a, b in sj]
        got = _all_to_all(torch.cat(parts) if parts else xt[:0], group,
                          [_width(p) for p in recv],
                          [_width(p) for p in send])
        segs = _layout(recv, ranges[index], w)
        ctx.group, ctx.dim, ctx.w, ctx.base = group, dim, w, base
        ctx.send, ctx.recv, ctx.segs = send, recv, segs
        return torch.cat([got[o:o + k] for o, k in segs]).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        gt = g.movedim(ctx.dim, 0)
        # the cotangent of each received row, back where it came from
        buf = gt.new_empty((sum(k for _, k in ctx.segs),) + gt.shape[1:])
        i = 0
        for o, k in ctx.segs:
            buf[o:o + k] = gt[i:i + k]
            i += k
        back = _all_to_all(buf, ctx.group, [_width(p) for p in ctx.send],
                           [_width(p) for p in ctx.recv])
        gx = back.new_zeros((ctx.w,) + tuple(back.shape[1:]))
        i = 0
        for sj in ctx.send:
            for a, b in sj:
                gx[a - ctx.base:b - ctx.base] += back[i:i + b - a]
                i += b - a
        return gx.movedim(0, ctx.dim), None, None, None, None, None


def _width(pieces) -> int:
    return sum(b - a for a, b in pieces)


def _layout(recv, ranges, w: int) -> list:
    """Where each piece of the taken output lies in the received buffer,
    (offset, rows) in output order: each asked range in turn, its pieces
    by source rank. The buffer holds each source's pieces in range
    order, the sources one after another."""
    start = np.concatenate([[0], np.cumsum([_width(p) for p in recv])])
    pos, segs = [0] * len(recv), []
    for a, b in ranges:
        for r in range(len(recv)):
            lo, hi = max(a, r * w), min(b, (r + 1) * w)
            if lo < hi:
                segs.append((int(start[r]) + pos[r], hi - lo))
                pos[r] += hi - lo
    return segs


class _AllGather(torch.autograd.Function):
    """Tiled gather along ``dim``. Backward: reduce-scatter (sum) when the
    group's ranks computed on other rows (``reduce``), else the rank's own
    slice of the cotangent, which replicated compute made the same on
    every rank."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim, reduce):
        ctx.group, ctx.n, ctx.index, ctx.dim, ctx.reduce = (
            group, n, index, dim, reduce)
        ctx.local = x.shape[dim]
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            gx = _reduce_scatter(g, ctx.group, ctx.n, ctx.dim)
        else:
            gx = g.narrow(ctx.dim, ctx.index * ctx.local, ctx.local)
        return gx, None, None, None, None, None


# ---------------------------------------------------------------------------
# One rank's view of the mesh
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh:
    """This process's slot of an SPMD world laid over ``mesh``.

    ``groups`` maps ``"data"`` and ``"model"`` to (process group, the
    group's global ranks in axis order). ``split_data`` says whether the
    batch is cut over the data axes (``for_batch``); when it is not, the
    data ranks compute the same rows and the data axes behave like
    ``model``: no sum over them."""
    mesh: Mesh
    ax: AxisEnv
    rank: int
    coords: dict               # axis name -> this rank's index
    device: torch.device
    groups: dict
    split_data: bool = True

    def key(self, axis) -> str:
        """``"model"`` or ``"data"`` for a spec entry or an axis name."""
        if axis == self.ax.model or axis == MODEL:
            return MODEL
        if axis == DATA or axis == self.ax.dp or (
                isinstance(axis, tuple) and axis == self.ax.data):
            return DATA
        raise ValueError(f"{axis!r} names neither the model axis "
                         f"{self.ax.model!r} nor the data axes "
                         f"{self.ax.data}")

    def size(self, axis) -> int:
        return len(self.groups[self.key(axis)][1])

    def axis_index(self, axis) -> int:
        return self.groups[self.key(axis)][1].index(self.rank)

    def for_batch(self, b: int) -> "ProcessMesh":
        """This view for a global batch of ``b`` rows: split over the data
        axes when ``b`` divides (the reference's ``_batch_spec``), else
        replicated."""
        return dataclasses.replace(self, split_data=b % self.size(DATA) == 0)

    def batch_shard(self, t):
        """This rank's rows of a global batch tensor."""
        if not self.split_data:
            return t
        n = t.shape[0] // self.size(DATA)
        i = self.axis_index(DATA)
        return t[i * n:(i + 1) * n]

    def broadcast_object(self, obj):
        """Global rank 0's ``obj`` (picklable), on every rank of the
        world."""
        box = [obj]
        tdist.broadcast_object_list(box, src=0)
        return box[0]

    # -- collectives ------------------------------------------------------
    def psum(self, x, axis):
        return _Psum.apply(x, self.groups[self.key(axis)][0])

    def enter(self, x, axis):
        return _Enter.apply(x, self.groups[self.key(axis)][0])

    def pmax(self, x, axis):
        """Max over the axis; no gradient."""
        return _all_reduce(x.detach(), self.groups[self.key(axis)][0],
                           tdist.ReduceOp.MAX)

    def reduce(self, x, axis):
        """Sum over the axis, outside autograd (a backward's own sum)."""
        return _all_reduce(x, self.groups[self.key(axis)][0])

    def pmean(self, x, axis):
        return self.psum(x, axis) / self.size(axis)

    def all_gather(self, x, axis, dim: int):
        k = self.key(axis)
        group, ranks = self.groups[k]
        return _AllGather.apply(x, group, len(ranks),
                                ranks.index(self.rank), dim,
                                k == DATA and self.split_data)

    def allsum(self, x, axis):
        """Sum over the axis, forward and backward (``_AllSum``)."""
        return _AllSum.apply(x, self.groups[self.key(axis)][0])

    def own(self, x, axis, dim: int):
        """This rank's slice of a tensor replicated over the axis
        (``_Own``)."""
        group, ranks = self.groups[self.key(axis)]
        return _Own.apply(x, group, len(ranks), ranks.index(self.rank),
                          dim % x.dim())

    def take(self, x, axis, dim: int, ranges):
        """The columns ``ranges[axis_index]`` of a leaf that the axis cuts
        along ``dim`` (``x`` the rank's shard), where ``ranges`` lists, for
        every rank of the axis, the (start, stop) pairs of the whole dim
        it wants, in order (``_Take``: one all-to-all)."""
        group, ranks = self.groups[self.key(axis)]
        ranges = tuple(tuple((int(a), int(b)) for a, b in rj)
                       for rj in ranges)
        return _Take.apply(x, group, len(ranks), ranks.index(self.rank),
                           dim % x.dim(), ranges)

    def recut(self, x, axis, split_dim: int, cat_dim: int):
        """``x`` cut into the group's size along ``split_dim``, piece j sent
        to rank j (one all-to-all), and the pieces received from the
        ranks joined in rank order along ``cat_dim``: the tensor the group
        holds cut along ``cat_dim`` comes back cut along ``split_dim``. No
        gradient (the decode step's re-cuts)."""
        group, ranks = self.groups[self.key(axis)]
        n = len(ranks)
        if n == 1:
            return x
        w = x.shape[split_dim] // n
        got = _all_to_all(x.movedim(split_dim, 0), group, [w] * n, [w] * n)
        return torch.cat(got.movedim(0, split_dim).chunk(n, dim=split_dim),
                         dim=cat_dim)

    def reduce_scatter(self, x, axis, dim: int):
        """The sum over the axis of ``x``, of which each rank keeps its
        slice along ``dim``. No gradient."""
        group, ranks = self.groups[self.key(axis)]
        if len(ranks) == 1:
            return x
        return _reduce_scatter(x, group, len(ranks), dim)

    def spec_axes(self, spec) -> tuple:
        """The groups (``"data"``, ``"model"``) that cut a leaf."""
        return tuple(sorted({self.key(e) for e in spec if e is not None}))

    def gather(self, t, spec, axes=(DATA, MODEL)):
        """A leaf's shard gathered over the groups in ``axes`` that cut it.
        A gather that covers the data axes enters a leaf that they do not
        cut over data, so that its gradient sums over the batch shards."""
        for dim, e in enumerate(spec):
            if e is not None and self.key(e) in axes:
                t = self.all_gather(t, e, dim)
        if (DATA in axes and self.split_data
                and DATA not in self.spec_axes(spec)):
            t = self.enter(t, DATA)
        return t

    def gather_tree(self, tree, specs, axes=(DATA, MODEL)):
        return tree_map(lambda t, s: self.gather(t, s, axes), tree, specs)

    def collectives_by_axis(self, counted: "tally.Tally") -> dict:
        """A tally's collectives by the group they ran over (``"data"``,
        ``"model"``) and kind: {axis: {kind: {"count", "bytes",
        "group_size"}}}."""
        name = {id(g): k for k, (g, _) in self.groups.items()}
        out = {}
        for (kind, group), v in counted.collectives.items():
            e = out.setdefault(name[id(group)], {}).setdefault(
                kind, {"count": 0, "bytes": 0,
                       "group_size": v["group_size"]})
            e["count"] += v["count"]
            e["bytes"] += v["bytes"]
        return out


def process_mesh(mesh: Mesh, rank: int) -> ProcessMesh:
    """Rank ``rank``'s view of ``mesh`` in the current default process
    group. Every rank creates every group, in the same order, as
    ``torch.distributed.new_group`` needs."""
    from ..models.common import axis_env_for_mesh
    ax = axis_env_for_mesh(mesh)
    shape = mesh.devices.shape
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    mi = mesh.axis_names.index(ax.model) if ax.model in mesh.axis_names \
        else None
    # model groups: one per data coordinate; data groups: one per model index
    by_model = (np.moveaxis(ranks, mi, -1).reshape(-1, shape[mi])
                if mi is not None else ranks.reshape(-1, 1))
    groups = {}
    for kind, rows in ((MODEL, by_model), (DATA, by_model.T)):
        for row in rows:
            members = [int(r) for r in row]
            g = tdist.new_group(members)
            if rank in members:
                groups[kind] = (g, members)
    coords = dict(zip(mesh.axis_names,
                      (int(i) for i in np.unravel_index(rank, shape))))
    return ProcessMesh(mesh, ax, rank, coords, mesh.devices.flat[rank],
                       groups)


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------
def _build_mesh(shape, axes, on_cpu: bool) -> Mesh:
    n = int(np.prod(shape))
    if on_cpu:
        return make_mesh(shape, axes, devices=[torch.device("cpu")] * n)
    return make_mesh(shape, axes)


def _run_rank(rank, world, port, shape, axes, on_cpu, fn, args):
    """One rank: its process group rendezvous at the launcher's store on
    ``port`` (``None``: the ``torchrun`` environment)."""
    mesh = _build_mesh(shape, axes, on_cpu)
    kw = {"init_method": "env://"} if port is None else {
        "store": tdist.TCPStore(HOST, port, world, is_master=False)}
    if not on_cpu:
        dev = mesh.devices.flat[rank]
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    tdist.init_process_group("gloo" if on_cpu else "nccl", world_size=world,
                             rank=rank, **kw)
    try:
        out = fn(process_mesh(mesh, rank), *args)
        tdist.barrier()
        return out
    finally:
        tdist.destroy_process_group()


def _worker(rank, world, port, shape, axes, on_cpu, fn, args, q):
    try:
        q.put((rank, True, _run_rank(rank, world, port, shape, axes,
                                     on_cpu, fn, args)))
    except BaseException:          # the parent raises it with the traceback
        q.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def mesh_shape(text: str) -> tuple:
    """``--mesh DxM`` of the launchers: (D, M)."""
    import argparse
    try:
        d, m = (int(n) for n in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--mesh {text!r}: expected DxM, e.g. 2x2") from None
    return d, m


def launch(fn, shape, axes=("data", "model"), *args, device=None,
           timeout: float = 3600.0):
    """``fn(process_mesh, *args)`` on every slot of a mesh of ``shape``
    over ``axes``; returns the ranks' results in rank order.

    ``device=None`` (or ``"cuda"``) puts slot i on card i over NCCL and
    raises when there are fewer cards than slots; ``"cpu"`` puts every
    slot on the CPU over gloo. Under ``torchrun`` (``RANK`` and
    ``WORLD_SIZE`` set) this process is one rank: it runs its own slot
    and returns a one-element list. Otherwise one process is spawned a
    slot. ``fn`` and ``args`` must pickle."""
    shape = tuple(int(n) for n in shape)
    world = int(np.prod(shape))
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"device {device!r}: a mesh runs on cards "
                             "(NCCL) or on the CPU (gloo)")
        _build_mesh(shape, axes, False)        # raises with too few cards
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world:
            raise RuntimeError(f"WORLD_SIZE {os.environ['WORLD_SIZE']} for "
                               f"a mesh of {world} slots")
        return [_run_rank(int(os.environ["RANK"]), world, None, shape,
                          axes, on_cpu, fn, args)]
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    # the launcher holds the rendezvous store on a port the system gives
    # it, so no other socket can take the port before the ranks start
    store = tdist.TCPStore(HOST, 0, world, is_master=True,
                           wait_for_workers=False)
    procs = [ctx.Process(target=_worker, args=(r, world, store.port, shape,
                                               axes, on_cpu, fn, args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    try:
        while len(results) + len(errors) < world:
            try:
                rank, ok, out = q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"mesh {shape}: {world - len(results)} "
                                   f"ranks gave no result in {timeout} s")
            (results if ok else errors)[rank] = out
            if errors:
                break
    finally:
        for p in procs:
            if errors or len(results) < world:
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():           # no rank outlives its launch
                p.kill()
                p.join()
    if errors:
        rank = min(errors)
        raise RuntimeError(f"rank {rank} of mesh {shape} failed:\n"
                           f"{errors[rank]}")
    return [results[r] for r in range(world)]
