"""Oracles for the kernels (the allclose targets)."""
from __future__ import annotations

import torch


def spmm_ref(blocks, idx, x):
    """Blocked-ELL -> dense scatter in float64, then matmul. Matches
    spmm_blocked_ell. Returns a float64 tensor on the CPU."""
    blocks = torch.as_tensor(blocks).detach().cpu().double()
    idx = torch.as_tensor(idx).detach().cpu().long()
    x = torch.as_tensor(x).detach().cpu().double()
    nbr, ell, bm, bk = blocks.shape
    K, N = x.shape
    nbc = K // bk
    dense = torch.zeros((nbr, nbc, bm, bk), dtype=torch.float64)
    rows = torch.arange(nbr)[:, None].expand(nbr, ell)
    dense.index_put_((rows.reshape(-1), idx.reshape(-1)),
                     blocks.reshape(-1, bm, bk), accumulate=True)
    a = dense.permute(0, 2, 1, 3).reshape(nbr * bm, K)
    return a @ x
