"""Sparse matrix formats.

CSR is the exchange format (matches the paper's Sextans input); the Hopper
kernel consumes blocked-ELL (see kernels/spmm.py). ``random_graph_csr``
generates Table-I-like synthetic graphs (uniform edges + self loops,
degree-normalized values — the GCN Â matrix) with the same numpy stream as
the JAX package, so both build the same graph from the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class CSR:
    """Row-compressed sparse matrix (tensors on one device)."""
    indptr: torch.Tensor    # (M+1,) int64
    indices: torch.Tensor   # (nnz,) int64
    data: torch.Tensor      # (nnz,) float
    shape: tuple

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def sparsity(self) -> float:
        return 1.0 - self.nnz / (self.shape[0] * self.shape[1])


def _csr(indptr, indices, data, shape, device) -> CSR:
    dev = resolve_device(device)
    return CSR(torch.as_tensor(np.asarray(indptr, np.int64), device=dev),
               torch.as_tensor(np.asarray(indices, np.int64), device=dev),
               torch.as_tensor(np.asarray(data), device=dev), tuple(shape))


def csr_from_dense(a: np.ndarray, *, device=None) -> CSR:
    M, K = a.shape
    rows, cols = np.nonzero(a)
    indptr = np.zeros(M + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return _csr(np.cumsum(indptr), cols, a[rows, cols].astype(a.dtype),
                (M, K), device)


def csr_to_dense(a: CSR) -> np.ndarray:
    M, K = a.shape
    indptr = a.indptr.cpu().numpy()
    rows = np.repeat(np.arange(M), np.diff(indptr))
    out = np.zeros((M, K), np.float32)
    out[rows, a.indices.cpu().numpy()] = a.data.cpu().numpy()
    return out


def random_graph_csr(n_vertices: int, n_edges: int, *, seed: int = 0,
                     normalized: bool = True, device=None) -> CSR:
    """Synthetic graph adjacency (+ self loops), GCN-normalized:
    Â = D^-1/2 (I + A) D^-1/2. Returns CSR of Â."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges)
    dst = rng.integers(0, n_vertices, n_edges)
    # + self loops, dedup
    src = np.concatenate([src, np.arange(n_vertices)])
    dst = np.concatenate([dst, np.arange(n_vertices)])
    key = src.astype(np.int64) * n_vertices + dst
    key = np.unique(key)
    src, dst = (key // n_vertices).astype(np.int32), (key % n_vertices).astype(np.int32)
    deg = np.bincount(src, minlength=n_vertices).astype(np.float32)
    if normalized:
        dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
        val = dinv[src] * dinv[dst]
    else:
        val = np.ones_like(src, np.float32)
    order = np.lexsort((dst, src))
    src, dst, val = src[order], dst[order], val[order]
    indptr = np.zeros(n_vertices + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return _csr(indptr, dst, val.astype(np.float32),
                (n_vertices, n_vertices), device)
