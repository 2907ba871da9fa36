"""Workload description: chains of compute kernels with data-dependent
characteristics (dims, sparsity) — the scheduler's unit of work.

Builders reproduce the paper's two case studies:
  * GNN inference (GCN / GIN) over the Table-I datasets
  * sliding-window-attention transformers (BigBird setting, 32 layers)
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

FP = 4  # fp32 bytes (paper uses FP32 on both device types)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str
    kind: str          # 'spmm' | 'gemm' | 'win_attn'
    # dims (by kind):
    #   spmm: M x K sparse (nnz) times K x N dense
    #   gemm: M x K times K x N
    #   win_attn: seq_len, window w, model dim d, heads h
    M: int = 0
    K: int = 0
    N: int = 0
    nnz: int = 0
    seq_len: int = 0
    w: int = 0
    d: int = 0
    heads: int = 8

    # ---- derived characteristics ----
    @property
    def flops(self) -> float:
        if self.kind == "spmm":
            return 2.0 * self.nnz * self.N
        if self.kind == "gemm":
            return 2.0 * self.M * self.K * self.N
        if self.kind == "win_attn":
            # SDDMM + softmax + SpMM over the banded mask
            return 2.0 * 2 * self.seq_len * self.w * self.d + 5.0 * self.seq_len * self.w
        raise ValueError(self.kind)

    @property
    def sparsity(self) -> float:
        if self.kind == "spmm":
            return 1.0 - self.nnz / max(self.M * self.K, 1)
        if self.kind == "win_attn":
            return 1.0 - self.w / max(self.seq_len, 1)
        return 0.0

    @property
    def bytes_in(self) -> float:
        """Dynamic input bytes (the tensor streamed from the previous stage).
        Static data (graph structure, weights) is pre-loaded (§II-B)."""
        if self.kind == "spmm":
            return FP * self.K * self.N
        if self.kind == "gemm":
            return FP * self.M * self.K
        if self.kind == "win_attn":
            return FP * self.seq_len * self.d
        raise ValueError(self.kind)

    @property
    def bytes_out(self) -> float:
        if self.kind == "spmm":
            return FP * self.M * self.N
        if self.kind == "gemm":
            return FP * self.M * self.N
        if self.kind == "win_attn":
            return FP * self.seq_len * self.d
        raise ValueError(self.kind)

    @property
    def gflop(self) -> float:
        if self.kind == "spmm":  # paper's Eq. 7 definition
            return (2.0 * self.nnz * self.N - self.M * self.N) * 1e-9
        return self.flops * 1e-9

    @property
    def arm(self) -> float:
        """Arithmetic intensity (paper's Eq. 7 feature)."""
        if self.kind == "spmm":
            return self.gflop * 1e9 / (8.0 * (self.nnz + self.M * self.N))
        return self.flops / (8.0 * (self.bytes_in + self.bytes_out) / FP)


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    kernels: tuple

    def __len__(self):
        return len(self.kernels)

    def __iter__(self):
        return iter(self.kernels)

    def __getitem__(self, i):
        return self.kernels[i]


# ---------------------------------------------------------------------------
# Table I datasets
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GraphDataset:
    name: str
    vertices: int
    edges: int
    feature_len: int

    @property
    def sparsity(self) -> float:
        return 1.0 - self.edges / (self.vertices ** 2)


DATASETS = {
    "S1": GraphDataset("synthetic-1", 230_000, 120_000_000, 600),
    "S2": GraphDataset("synthetic-2", 230_000, 15_000_000, 600),
    "S3": GraphDataset("synthetic-3", 700_000, 15_000_000, 300),
    "S4": GraphDataset("synthetic-4", 3_500_000, 5_000_000, 20),
    "OA": GraphDataset("ogbn-arxiv", 170_000, 1_100_000, 128),
    "OP": GraphDataset("ogbn-products", 2_400_000, 61_000_000, 100),
}


# ---------------------------------------------------------------------------
# Workload builders
# ---------------------------------------------------------------------------
def gcn_workload(ds: GraphDataset, hidden: int = 128, layers: int = 2) -> Workload:
    """X' = Â X Θ per layer: SpMM then GeMM."""
    ks = []
    feat = ds.feature_len
    for layer in range(1, layers + 1):
        ks.append(KernelSpec(f"SpMM{layer}", "spmm", M=ds.vertices, K=ds.vertices,
                             N=feat, nnz=ds.edges + ds.vertices))  # +self loops
        ks.append(KernelSpec(f"GeMM{layer}", "gemm", M=ds.vertices, K=feat, N=hidden))
        feat = hidden
    return Workload(f"GCN-{ds.name}", tuple(ks))


def gin_workload(ds: GraphDataset, hidden: int = 128, layers: int = 2,
                 mlp_layers: int = 2) -> Workload:
    """X' = MLP(A' X) per layer: SpMM then `mlp_layers` GeMMs."""
    ks = []
    feat = ds.feature_len
    for layer in range(1, layers + 1):
        ks.append(KernelSpec(f"SpMM{layer}", "spmm", M=ds.vertices, K=ds.vertices,
                             N=feat, nnz=ds.edges + ds.vertices))
        for m in range(1, mlp_layers + 1):
            ks.append(KernelSpec(f"GeMM{layer}.{m}", "gemm",
                                 M=ds.vertices, K=feat, N=hidden))
            feat = hidden
    return Workload(f"GIN-{ds.name}", tuple(ks))


def swa_transformer_workload(seq_len: int, w: int, *, layers: int = 32,
                             d: int = 512, heads: int = 8,
                             ffn_mult: int = 4) -> Workload:
    """BigBird-setting sliding-window transformer (paper §IV-B): per layer
    QKV projection, windowed attention, output projection, FFN (2 GeMMs)."""
    ks = []
    for layer in range(1, layers + 1):
        ks.append(KernelSpec(f"QKV{layer}", "gemm", M=seq_len, K=d, N=3 * d))
        ks.append(KernelSpec(f"WinAttn{layer}", "win_attn", seq_len=seq_len,
                             w=w, d=d, heads=heads))
        ks.append(KernelSpec(f"Proj{layer}", "gemm", M=seq_len, K=d, N=d))
        ks.append(KernelSpec(f"FFN{layer}.1", "gemm", M=seq_len, K=d, N=ffn_mult * d))
        ks.append(KernelSpec(f"FFN{layer}.2", "gemm", M=seq_len, K=ffn_mult * d, N=d))
    return Workload(f"SWA-T-s{seq_len}-w{w}", tuple(ks))
