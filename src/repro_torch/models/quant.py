"""Int8 weight quantization for serving.

Decode steps are memory-bound on weight reads; storing the big projection
matrices as int8 (+ a per-matrix absmax scale over the last two dims)
halves the bytes a step must read from memory. ``QuantizedArray``'s
``.to(dtype)`` dequantizes, so every consumption site (they all read
weights as ``p[...].to(cfg.cdtype)``) works unchanged, and its keepdims
scale makes stacked-layer leaves sliceable by the layer loop's ``t[i]``.
It is a leaf of ``models.common.tree_map``/``tree_leaves``, which recurse
into dicts only.

The weight is dequantized on each use into a compute-dtype copy; there
is no fused int8 GEMM yet. Serving paths only (``launch/serve.py
--int8``). ``abstract_quantize_params`` gives the dry run's abstract
serving tree (``launch/steps.py:abstract_state``'s leaves).

On a mesh (``quantize_params(..., mesh=, decls=)``) each rank quantizes
its shard with the global leaf's scale: its own absmax over the last two
dims, taken to the max over the groups that cut those dims, so the
gathered codes and scales are those of ``quantize`` of the whole leaf.
Every rank holds the whole scale, as the dry run's abstract tree does
(``local_scale`` gives the slice that a shard's codes read).
"""
from __future__ import annotations

import torch


class QuantizedArray:
    """int8 values + broadcastable absmax scale; dequantizes on .to."""

    def __init__(self, q, s):
        self.q = q
        self.s = s

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.dim()

    @property
    def dtype(self):
        return torch.int8

    def to(self, dtype):
        return self.q.to(dtype) * self.s.to(dtype)

    def __getitem__(self, idx):
        # slicing a stacked-layer leaf keeps scales aligned (keepdims shape)
        return QuantizedArray(self.q[idx], self.s[idx])

    def __repr__(self):
        return (f"QuantizedArray(q={tuple(self.q.shape)}, "
                f"s={tuple(self.s.shape)})")


def _scale_axes(ndim: int) -> tuple:
    return tuple(range(max(ndim - 2, 0), ndim))


def quantize(w) -> QuantizedArray:
    w = w.float()
    s = torch.amax(w.abs(), dim=_scale_axes(w.dim()), keepdim=True)
    s = s.clamp_min(1e-8) / 127.0
    # torch.round rounds half to even, as jnp.round does
    q = torch.round(w / s).clamp(-127, 127).to(torch.int8)
    return QuantizedArray(q, s)


def _eligible(path, leaf) -> bool:
    """Quantize big >=2-D projection weights; keep norms, embeddings and the
    lm head full precision (embedding dequant would materialize the full
    table per lookup)."""
    if set(path) & {"embedding", "lm_head"}:
        return False
    shape = tuple(getattr(leaf, "shape", ()))
    if len(shape) < 2:
        return False
    # matrix-like last two dims (excludes stacked per-layer vectors, whose
    # keepdims scale would break the layer loop's leading-axis slicing)
    if min(shape[-2:]) < 128:
        return False
    return shape[-1] * shape[-2] >= (1 << 15)


def quantize_params(params, path=(), *, mesh=None, decls=None):
    """Concrete params -> serving tree with eligible leaves quantized. With
    ``mesh`` (a ``launch/dist.ProcessMesh``) ``params`` are the rank's
    shards of ``decls`` (whose global shapes pick the eligible leaves),
    each quantized by ``quantize_shard``."""
    if isinstance(params, dict):
        return {k: quantize_params(v, path + (k,), mesh=mesh,
                                   decls=None if decls is None else decls[k])
                for k, v in params.items()}
    if mesh is None:
        return quantize(params) if _eligible(path, params) else params
    if not _eligible(path, decls):
        return params
    return quantize_shard(params, decls.spec, mesh)


def quantize_shard(w, spec, mesh) -> QuantizedArray:
    """A rank's shard ``w`` of a leaf cut by ``spec`` over ``mesh``,
    quantized as ``quantize`` quantizes the whole leaf: the absmax over the
    last two dims is the max over the groups that cut them, and the scale
    is gathered whole over the groups that cut the leading dims. One
    leading slice (a stacked layer) at a time is widened to float32."""
    spec = tuple(spec) + (None,) * (w.dim() - len(spec))
    last = [e for e in spec[-2:] if e is not None]
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(tuple(w.shape[:-2]) + (1, 1), dtype=torch.float32,
                    device=w.device)
    for i in range(w.shape[0] if w.dim() > 2 else 1):
        wi = (w[i] if w.dim() > 2 else w).float()
        si = torch.amax(wi.abs(), dim=_scale_axes(wi.dim()), keepdim=True)
        for e in last:
            si = mesh.pmax(si, e)
        si = si.clamp_min(1e-8) / 127.0
        qi = torch.round(wi / si).clamp(-127, 127).to(torch.int8)
        if w.dim() > 2:
            q[i], s[i] = qi, si
        else:
            q, s = qi, si
    for dim, e in enumerate(spec[:-2]):
        if e is not None:
            s = mesh.all_gather(s, e, dim)
    return QuantizedArray(q, s)


def local_scale(s, spec, mesh, shape):
    """The slice of a whole scale ``s`` that a shard of ``shape`` (cut by
    ``spec`` over ``mesh``) reads: each leading dim that the spec still
    cuts, narrowed to the rank's index."""
    for dim, e in enumerate(tuple(spec)[:-2]):
        if e is not None and s.shape[dim] > 1:
            n = shape[dim]
            s = s.narrow(dim, mesh.axis_index(e) * n, n)
    return s


def abstract_quantize_params(abstract_params, path=()):
    """An abstract parameter tree (``launch/steps.py:AbstractLeaf`` leaves)
    -> the abstract serving tree, for the dry run: each eligible leaf a
    ``QuantizedArray`` of int8 codes cut like the leaf and a float32 scale
    (1 on the last two dims) that every rank holds whole."""
    if isinstance(abstract_params, dict):
        return {k: abstract_quantize_params(v, path + (k,))
                for k, v in abstract_params.items()}
    leaf = abstract_params
    if not _eligible(path, leaf):
        return leaf
    axes = _scale_axes(len(leaf.shape))
    s_shape = tuple(1 if i in axes else d for i, d in enumerate(leaf.shape))
    return QuantizedArray(
        type(leaf).of(leaf.shape, torch.int8, leaf.spec, leaf.ax),
        type(leaf).of(s_shape, torch.float32, (), leaf.ax))
