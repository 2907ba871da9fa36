"""Error-feedback top-k gradient compression for cross-pod reduction.

Used on the slow inter-node link: each step only the top-k fraction of
gradient magnitude is exchanged; the residual is accumulated locally and
added to the next step's gradient (error feedback, Stich et al.), which
preserves convergence while cutting inter-node traffic by ~1/ratio. As
in the JAX package, no collective ships it: nothing there calls it, so
the port keeps the function alone.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.common import tree_map


@dataclasses.dataclass(frozen=True)
class CompressionState:
    residual: dict  # tree matching grads


def init_compression(grads_like):
    return CompressionState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def _topk_mask(x, ratio: float):
    flat = x.abs().reshape(-1)
    k = max(1, int(flat.shape[0] * ratio))
    # the k-th largest magnitude; every entry tied with it is kept, as the
    # reference's ``>= jax.lax.top_k(...)[0][-1]`` keeps them
    thresh = torch.topk(flat, k, sorted=True).values[-1]
    return (x.abs() >= thresh).to(x.dtype)


def topk_compress_update(grads, state: CompressionState, *,
                         ratio: float = 0.05):
    """Returns (sparse_grads_to_allreduce, new_state).

    The caller all-reduces the returned (mostly-zero) tensor over the
    inter-node group; compression happens before the collective so the
    wire volume is what a sparse encoding would ship.
    """
    def one(g, r):
        acc = g.float() + r
        sent = acc * _topk_mask(acc, ratio)
        return sent, acc - sent

    outs = tree_map(one, grads, state.residual)
    return (tree_map(lambda o: o[0], outs),
            CompressionState(residual=tree_map(lambda o: o[1], outs)))
