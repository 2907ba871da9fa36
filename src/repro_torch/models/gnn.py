"""GNN case-study models (paper §IV-A): GCN [25] and GIN [2] in PyTorch.

Both are 2-layer, hidden 128 (the paper's benchmark setting). Each layer is
the kernel chain the DYPE scheduler reasons about:
  GCN layer:  X' = Â X Θ            -> SpMM (Â X) then GeMM (· Θ)
  GIN layer:  X' = MLP(A' X)        -> SpMM then ``mlp_layers`` GeMMs

The adjacency is an operand prepared once on the device (the paper's
pre-loaded static graph): a ``CsrOperand``, whose SpMM is the hand-written
row-wise CSR kernel, or a ``BlockedEll``, on the blocked-ELL kernel (each
kernel's plain version on CPU tensors). The GeMMs are ``torch.matmul``.

Parameters are lists of dicts shaped like the JAX package's
(``[{"theta": (d_in, hidden)}]`` for GCN, ``[{"mlp": [...], "eps": e}]``
for GIN); ``*_params_from_numpy`` carries the reference's weights across.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..kernels import BlockedEll, CsrOperand


def _normal(shape, scale, generator, device):
    g = generator if generator is not None else torch.Generator()
    w = torch.randn(shape, generator=g, dtype=torch.float32) * scale
    return w.to(resolve_device(device))


def init_gcn_params(feature_len: int, hidden: int = 128, layers: int = 2, *,
                    generator: torch.Generator | None = None, device=None):
    """Glorot-scaled normal weights, drawn on the CPU from ``generator``
    (a CPU ``torch.Generator``) and moved to ``device``."""
    params = []
    d_in = feature_len
    for _ in range(layers):
        scale = (2.0 / (d_in + hidden)) ** 0.5
        params.append({"theta": _normal((d_in, hidden), scale, generator,
                                        device)})
        d_in = hidden
    return params


def init_gin_params(feature_len: int, hidden: int = 128, layers: int = 2,
                    mlp_layers: int = 2, *,
                    generator: torch.Generator | None = None, device=None):
    params = []
    d_in = feature_len
    for _ in range(layers):
        mlp = []
        for _ in range(mlp_layers):
            scale = (2.0 / (d_in + hidden)) ** 0.5
            mlp.append(_normal((d_in, hidden), scale, generator, device))
            d_in = hidden
        params.append({"mlp": mlp, "eps": 0.0})
    return params


def gcn_params_from_numpy(params, *, device=None):
    dev = resolve_device(device)
    return [{"theta": torch.tensor(np.asarray(p["theta"], np.float32),
                                   device=dev)} for p in params]


def gin_params_from_numpy(params, *, device=None):
    dev = resolve_device(device)
    return [{"mlp": [torch.tensor(np.asarray(w, np.float32), device=dev)
                     for w in p["mlp"]],
             "eps": float(np.asarray(p["eps"]))} for p in params]


class GCN(nn.Module):
    """2-layer GCN inference: relu between layers (Kipf & Welling)."""

    def __init__(self, params):
        super().__init__()
        self.thetas = nn.ParameterList(
            nn.Parameter(p["theta"], requires_grad=False) for p in params)

    def forward(self, a: CsrOperand | BlockedEll,
                x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, theta in enumerate(self.thetas):
            h = a @ h                        # SpMM_i (the operand's kernel)
            h = h @ theta                    # GeMM_i
            if i < len(self.thetas) - 1:
                h = torch.relu(h)
        return h


class GIN(nn.Module):
    """GIN: X' = MLP((1+eps) X + A X); with self-loop-augmented A' this is
    the SpMM + MLP chain of §IV-A."""

    def __init__(self, params):
        super().__init__()
        self.mlps = nn.ModuleList()
        self.eps = [float(p["eps"]) for p in params]
        for p in params:
            mlp = nn.ParameterList(nn.Parameter(w, requires_grad=False)
                                   for w in p["mlp"])
            self.mlps.append(mlp)

    def forward(self, a: CsrOperand | BlockedEll,
                x: torch.Tensor) -> torch.Tensor:
        h = x
        for mlp, eps in zip(self.mlps, self.eps):
            z = a @ h + eps * h                     # SpMM (A' = A + (1+eps)I)
            for m, w in enumerate(mlp):
                z = z @ w                           # GeMM chain (MLP)
                if m < len(mlp) - 1:
                    z = torch.relu(z)
            h = z
        return h
