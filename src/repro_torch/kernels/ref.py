"""Oracles for the kernels (the allclose targets)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def swa_attention_ref(q, k, v, *, window: int, scale: float):
    """Banded causal attention, materialized (the JAX package's
    ``kernels/ref.py:swa_attention_ref``). q: (B,H,S,D); k,v: (B,KV,S,D).
    float32 math, output in q's dtype."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    pos = torch.arange(S, device=q.device)
    rel = pos[:, None] - pos[None, :]
    valid = (rel >= 0) & (rel < window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(valid, p, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    out = out / p.sum(-1).clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


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
