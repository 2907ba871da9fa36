"""Tensor parallelism over the ``model`` axis, Megatron style, for the
layers of the LM zoo (attention, MLA, the gated FFN, the Mamba2 mixer).

On a mesh whose model axis has ``tp`` > 1 ranks (``launch/dist.py``), a
layer body gets its leaves gathered over the data axes only
(``lm._Leaves``) and splits its products over ``model``:

  * a column-parallel input projection (``column_parallel``) gives each
    rank its own heads (or its own FFN columns) from the replicated input;
    its backward sums the ranks' partial input cotangents over ``model``
    (Megatron's f, fused into the product);
  * a row-parallel output projection (``row_parallel``), whose partial
    product is summed over ``model`` (Megatron's g: its consumers are
    replicated), so the residual leaves the layer replicated over
    ``model``.

A bfloat16 product keeps its partial sums in float32 on both sums and
rounds once after them, as one device's product rounds once after its
float32 accumulation; so the mesh's losses stay those of one device to
bfloat16's last bits, not to a rounding of each rank's part.

How a rank gets the leaves it computes with (``take``):

  * the stored shard itself where the reference's spec cuts exactly the
    rank's columns: wq and wo by heads, w_uk/w_uv, out_proj, wk/wv where
    the KV heads divide;
  * one all-to-all of the asked columns where the stored cut is not the
    rank's (``dist.ProcessMesh.take``, whose backward sums): wi =
    [gate | up], whose stored shards cut the concatenation (at tp 2 rank
    0 holds all of gate), mamba's in_proj = [z | x | B | C | dt] (its own
    z, x and dt heads and the whole of B and C), wk/wv where the KV heads
    do not divide (only the KV heads the rank's query heads read);
  * a leaf that ``model`` does not cut but that feeds per-rank work
    (q_norm/k_norm, MLA's latent path, mamba's conv, A_log, D, dt_bias
    and norm) enters over ``model``, then the rank slices its part, so its
    gradient sums the ranks' partial work.

Everything between the products is per-rank partial work, B and
C of the mixer included: each rank projects and convolves them whole, and
its gradients of them count its own heads only. A layer whose heads (or
d_ff) do not divide over ``model`` gathers its leaves over ``model`` as
well and computes replicated (``whole``), as the reference's
``heads_constraint`` leaves such a layer to XLA. Between the layer bodies
of a training step the residual is cut over ``model`` along d
(``lm._blocks``), so each checkpoint keeps a 1/tp slice of it.
"""
from __future__ import annotations

import torch

MODEL = "model"


def tp_mesh(mesh):
    """``mesh`` when its model axis has more than one rank, else None."""
    return mesh if mesh is not None and mesh.size(MODEL) > 1 else None


def whole(mesh, p: dict, decls: dict) -> dict:
    """Every leaf of ``p`` (gathered over data) gathered over ``model``
    too, where its spec cuts it: replicated compute."""
    return {k: mesh.gather(v, decls[k].spec, (MODEL,)) for k, v in
            p.items()}


def _cut(mesh, spec, dim: int) -> bool:
    return dim < len(spec) and spec[dim] is not None \
        and mesh.key(spec[dim]) == MODEL


def take(mesh, t, spec, dim: int, ranges_of):
    """This rank's columns of a leaf ``t`` (gathered over data; ``spec``
    its unstacked spec) along ``dim``: the (start, stop) pairs
    ``ranges_of(j)`` of the whole dim, in order, for the rank at model
    index j. The stored shard when it is exactly those columns; one
    all-to-all when ``model`` cuts the dim otherwise; else (a leaf
    replicated over ``model``) its slices after ``enter``."""
    tp = mesh.size(MODEL)
    ranges = [list(ranges_of(j)) for j in range(tp)]
    if _cut(mesh, spec, dim):
        w = t.shape[dim]
        if all(ranges[j] == [(j * w, (j + 1) * w)] for j in range(tp)):
            return t
        return mesh.take(t, MODEL, dim, ranges)
    t = replicated(mesh, t)
    mine = ranges[mesh.axis_index(MODEL)]
    if mine == [(0, t.shape[dim])]:
        return t
    return torch.cat([t.narrow(dim, a, b - a) for a, b in mine], dim=dim)


def replicated(mesh, t):
    """A leaf that ``model`` does not cut, entering per-rank work: a
    float32 copy of a low-precision leaf enters over ``model``, so the
    ranks' partial gradients are summed in float32 and round once, at the
    leaf's cast."""
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return mesh.enter(t, MODEL)


def proj(mesh, x, w):
    """x @ w; with ``mesh`` the column-parallel product of x, replicated
    over ``model``, and this rank's columns w (``column_parallel``)."""
    return x @ w if mesh is None else column_parallel(mesh, x, w)


def block(j: int, width: int, offset: int = 0):
    """The j-th ``width`` columns after ``offset``."""
    return (offset + j * width, offset + (j + 1) * width)


def kv_heads(n_heads: int, n_kv: int, tp: int, j: int) -> list:
    """The KV heads that the query heads of model rank ``j`` read, one
    entry a local KV head: each head once where the rank's query heads
    fall in equal runs over consecutive KV heads (GQA with local groups),
    else one entry a query head (a KV head repeated for each)."""
    hl, g = n_heads // tp, n_heads // n_kv
    per_q = [(j * hl + i) // g for i in range(hl)]
    lo, hi = per_q[0], per_q[-1] + 1
    n = hi - lo
    if hl % n == 0 and all(k - lo == i // (hl // n)
                           for i, k in enumerate(per_q)):
        return list(range(lo, hi))
    return per_q


def merge(ranges) -> list:
    """Adjacent (start, stop) pairs joined: [(0, 4), (4, 8)] -> [(0, 8)]."""
    out = []
    for a, b in ranges:
        if out and out[-1][1] == a:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _mm32(a, b):
    """a @ b (2-D, bfloat16) kept in float32: ``torch.mm``'s ``out_dtype``
    on a card or on meta tensors; float32 operands, which hold bfloat16
    values exactly, on the CPU."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    return torch.mm(a, b, out_dtype=torch.float32)


class _ColumnProduct(torch.autograd.Function):
    """x @ w for x replicated over ``model`` and w this rank's columns:
    Megatron's f fused with the product. The backward sums the ranks'
    partial dx over ``model``; a bfloat16 dx is summed in float32 and
    rounds once, as one device's product rounds once."""

    @staticmethod
    def forward(ctx, x, w, mesh):
        ctx.save_for_backward(x, w)
        ctx.mesh = mesh
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = g2 @ w.T if x.dtype == torch.float32 else _mm32(g2, w.T)
        dx = ctx.mesh.reduce(dx, MODEL).to(x.dtype).reshape(x.shape)
        dw = x.reshape(-1, x.shape[-1]).T @ g2
        return dx, dw, None


def column_parallel(mesh, x, w):
    """The column-parallel input projection x @ w of this rank's columns
    w, x replicated over ``model`` (``_ColumnProduct``)."""
    return _ColumnProduct.apply(x, w, mesh)


class _PartialProduct(torch.autograd.Function):
    """h @ w for a bfloat16 h and w, kept in float32 (``_mm32``). Its
    backward rounds the cotangent back to h's dtype, which holds it
    exactly when the consumer rounds to that dtype, and forms dh and dw
    as one device's product does."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        out = _mm32(h.reshape(-1, h.shape[-1]), w)
        return out.reshape(*h.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(h.dtype)
        dh = (g2 @ w.T).reshape(h.shape)
        dw = h.reshape(-1, h.shape[-1]).T @ g2
        return dh, dw


def row_parallel(mesh, h, w):
    """The row-parallel output projection: this rank's partial h @ w
    summed over ``model``. A low-precision product is summed in float32
    and rounds once after the sum, as one device's product rounds once
    after its float32 accumulation."""
    if h.dtype == torch.float32:
        return mesh.psum(h @ w, MODEL)
    return mesh.psum(_PartialProduct.apply(h, w), MODEL).to(h.dtype)
