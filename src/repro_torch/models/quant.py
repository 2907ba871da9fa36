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


def quantize_params(params, path=()):
    """Concrete params -> serving tree with eligible leaves quantized."""
    if isinstance(params, dict):
        return {k: quantize_params(v, path + (k,)) for k, v in params.items()}
    return quantize(params) if _eligible(path, params) else params


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
