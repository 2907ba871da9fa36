"""Public wrappers around the kernels, in the model zoo's layouts.

``swa_attention_op`` takes (B, S, H, D) activations and hands the kernel
(B, H, S, D) views of them, without a copy. The sparse operand is converted to blocked-ELL on the host once and kept on
the device (``BlockedEll``): the paper's pre-loaded static graph data. The
GCN/GIN models and the serving pipeline multiply by it for every request.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .spmm import csr_to_blocked_ell, spmm_blocked_ell, to_blocked_ell
from .swa import swa_attention


def swa_attention_op(q, k, v, *, window: int, scale: float):
    """Sliding-window attention, model layout: q (B,S,H,D), k/v (B,S,KV,D)
    -> (B,S,H,D)."""
    o = swa_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      window=window, scale=scale)
    return o.transpose(1, 2)


@dataclasses.dataclass
class BlockedEll:
    """A blocked-ELL matrix on one device: blocks (nbr, ell, bm, bk) fp32,
    idx (nbr, ell) int32, logical shape (nbr*bm, K)."""
    blocks: torch.Tensor
    idx: torch.Tensor
    shape: tuple

    @classmethod
    def from_numpy(cls, blocks: np.ndarray, idx: np.ndarray, k: int, *,
                   device=None) -> "BlockedEll":
        dev = resolve_device(device)
        nbr, _, bm, bk = blocks.shape
        if k % bk or (idx.size and (idx.min() < 0 or idx.max() >= k // bk)):
            raise ValueError("idx out of range for K / bk column blocks")
        return cls(torch.from_numpy(np.ascontiguousarray(blocks)).to(dev),
                   torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(dev),
                   (nbr * bm, k))

    @classmethod
    def from_csr(cls, csr, bm: int = 16, bk: int = 16, *,
                 device=None) -> "BlockedEll":
        blocks, idx = csr_to_blocked_ell(csr, bm, bk)
        return cls.from_numpy(blocks, idx, csr.shape[1], device=device)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return spmm_blocked_ell(self.blocks, self.idx, x)


def spmm_op(a_dense: np.ndarray, x: torch.Tensor, *, bm: int = 128,
            bk: int = 128) -> torch.Tensor:
    """SpMM with host-side blocked-ELL conversion (one-time; callers that
    multiply repeatedly keep a ``BlockedEll`` instead)."""
    blocks, idx = to_blocked_ell(np.asarray(a_dense), bm, bk)
    a = BlockedEll.from_numpy(blocks, idx, a_dense.shape[1], device=x.device)
    return a @ x
