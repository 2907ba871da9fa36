"""Public wrappers around the kernels, in the model zoo's layouts.

``swa_attention_op`` takes (B, S, H, D) activations and hands the kernel
(B, H, S, D) views of them, without a copy. A sparse operand is converted
once and kept on the device: the paper's pre-loaded static graph data.
``CsrOperand`` (int32 CSR, the row-wise CSR kernel) is the one the GCN/GIN
models and the serving pipeline multiply by for every request;
``BlockedEll`` is the TPU kernel's literal operand, on the blocked-ELL
kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .spmm import (INT32_MAX, csr_to_blocked_ell, spmm_blocked_ell,
                   spmm_csr_rows, to_blocked_ell)
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


@dataclasses.dataclass
class CsrOperand:
    """A CSR matrix on one device, as the row-wise CSR kernel reads it:
    indptr (M+1,) int32, indices (nnz,) int32, values (nnz,) float32,
    logical shape (M, K)."""
    indptr: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor
    shape: tuple

    @classmethod
    def from_numpy(cls, indptr, indices, values, shape, *,
                   device=None) -> "CsrOperand":
        dev = resolve_device(device)
        M, K = shape
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        nnz = len(indices)
        if nnz > INT32_MAX or K > INT32_MAX or M > INT32_MAX:
            raise ValueError(f"nnz {nnz} or shape {tuple(shape)} does not "
                             "fit int32")
        if indptr.shape != (M + 1,) or len(values) != nnz \
                or (M and (indptr[0] != 0 or indptr[-1] != nnz
                           or np.any(np.diff(indptr) < 0))):
            raise ValueError("indptr, indices and values do not form a CSR "
                             f"matrix of shape {tuple(shape)}")
        if nnz and (indices.min() < 0 or indices.max() >= K):
            raise ValueError(f"column index out of range for K = {K}")
        return cls(torch.from_numpy(indptr.astype(np.int32)).to(dev),
                   torch.from_numpy(indices.astype(np.int32)).to(dev),
                   torch.from_numpy(np.asarray(values, np.float32)).to(dev),
                   (M, K))

    @classmethod
    def from_csr(cls, csr, *, device=None) -> "CsrOperand":
        """The port's int64 ``sparse.CSR``, converted once (entries kept as
        they are, in their order)."""
        return cls.from_numpy(csr.indptr.cpu().numpy(),
                              csr.indices.cpu().numpy(),
                              csr.data.cpu().numpy(), csr.shape,
                              device=device)

    @classmethod
    def from_blocked_ell(cls, blocks, idx, k: int, *,
                         device=None) -> "CsrOperand":
        """Compact the TPU kernel's operand, blocks (nbr, ell, bm, bk) and
        idx (nbr, ell) as numpy arrays, to the non-zeros of its tiles in
        row, then column, order. Entries that two tiles of a block-row give
        the same (row, column) are summed, as the TPU kernel sums them."""
        blocks = np.asarray(blocks, np.float32)
        idx = np.asarray(idx)
        nbr, ell, bm, bk = blocks.shape
        if idx.shape != (nbr, ell) or k % bk or (
                idx.size and (idx.min() < 0 or idx.max() >= k // bk)):
            raise ValueError("idx does not match blocks or is out of range "
                             "for K / bk column blocks")
        r, e, i, j = np.nonzero(blocks)
        rows = r.astype(np.int64) * bm + i
        cols = idx[r, e].astype(np.int64) * bk + j
        key, inv = np.unique(rows * k + cols, return_inverse=True)
        vals = np.zeros(len(key), np.float32)
        np.add.at(vals, inv, blocks[r, e, i, j])
        M = nbr * bm
        indptr = np.zeros(M + 1, np.int64)
        np.add.at(indptr, key // k + 1, 1)
        return cls.from_numpy(np.cumsum(indptr), key % k, vals, (M, k),
                              device=device)

    @property
    def nnz(self) -> int:
        return int(self.indices.numel())

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.indptr, self.indices, self.values))

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 2 or x.shape[0] != self.shape[1]:
            raise ValueError(f"x {tuple(x.shape)} does not fit A "
                             f"{self.shape}")
        return spmm_csr_rows(self.indptr, self.indices, self.values, x)


def spmm_op(a_dense: np.ndarray, x: torch.Tensor, *, bm: int = 128,
            bk: int = 128) -> torch.Tensor:
    """SpMM with host-side blocked-ELL conversion (one-time; callers that
    multiply repeatedly keep a ``BlockedEll`` instead)."""
    blocks, idx = to_blocked_ell(np.asarray(a_dense), bm, bk)
    a = BlockedEll.from_numpy(blocks, idx, a_dense.shape[1], device=x.device)
    return a @ x
