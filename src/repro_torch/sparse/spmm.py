"""SpMM entry points over the CSR substrate.

``spmm_csr`` is the plain gather/``index_add_`` path: the oracle for the
GNN models and the plain-path GCN that the serving check compares with.
The hand-written blocked-ELL kernel (kernels/spmm.py) is the GCN's SpMM.

On the card ``index_add_`` accumulates with atomics, so the order of each
row's sum changes from run to run; comparisons with it use a float32
tolerance (1e-4 for one SpMM, 1e-3 for a whole GCN), never equality.
"""
from __future__ import annotations

import torch

from .formats import CSR


def spmm_csr(a: CSR, x: torch.Tensor) -> torch.Tensor:
    """Â @ X via row-expand + gather + index_add_. x: (K, N) -> (M, N)."""
    M = a.shape[0]
    rows = torch.repeat_interleave(
        torch.arange(M, device=x.device), torch.diff(a.indptr),
        output_size=a.nnz)
    gathered = x[a.indices] * a.data[:, None]
    out = torch.zeros((M, x.shape[1]), dtype=gathered.dtype, device=x.device)
    return out.index_add_(0, rows, gathered)


def spmm_dense_ref(a_dense, x):
    a = torch.as_tensor(a_dense)
    return a @ torch.as_tensor(x, device=a.device)
