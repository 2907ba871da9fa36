"""Analytic hardware oracle — the stand-in for "measure the kernel on real
hardware" (paper §V step 1).

The paper's MI210/U280 testbed is not at hand, so the ground-truth kernel
latencies are produced by an analytic device simulator built from the published device
constants (Table II, §III-A, Sextans [30], SWAT [6], FPGA-GEMM [31]) plus
*non-linear* efficiency curves and deterministic quantization/jitter effects.
The oracle plays two roles, exactly mirroring the paper's methodology:

  1. generate the synthetic benchmark points used to FIT the §V linear
     regression models (``perf_model.fit_models``), and
  2. act as the "actual measured performance" when evaluating how often the
     estimation error makes the scheduler pick a sub-optimal schedule
     (Table III reproduction in ``benchmarks/table3_accuracy.py``).

The non-linearities (occupancy/wave quantization, sparsity-dependent gather
efficiency, small-transfer overheads) are what the linear models cannot fully
capture — they produce the few-percent residuals that drive Table III.

The ``"H100"`` role models the port's own kernels on an NVIDIA H100 SXM5
in float32 (``KernelSpec``'s FP = 4): B1 (``csrc/spmm_csr_rows.cu``) for
spmm, cuBLAS SGEMM with TF32 off for gemm, and B2's float32 route
(``csrc/swa_attention.cu``) on the band only for win_attn. Its constants
are the data sheet's; its efficiency curves are fitted to the card's
times at DyPe's own kernel specs (``chip_smoke.py`` phase 18 (b), PERF.md
§5). Like the other roles it is closed-form and reads no hardware.
"""
from __future__ import annotations

import hashlib
import math

from .workload import KernelSpec

# ---------------------------------------------------------------------------
# Published device constants
# ---------------------------------------------------------------------------
# AMD Instinct MI210 (§III-A, public datasheet)
MI210_FP32_MATRIX = 45.3e12     # FLOP/s, matrix pipes
MI210_FP32_VECTOR = 22.6e12     # FLOP/s, vector pipes
MI210_HBM_BW = 1.6e12           # B/s HBM2e

# AMD Alveo U280 (§V constants)
SEXTANS_F = 215e6               # Hz   (Sextans, customized: +N_M, no alpha/beta)
SEXTANS_NM = 640                # MAC units
SWAT_F = 421e6                  # Hz
SWAT_T_PIPE = 201               # cycles per token (w=1024 basis)
SWAT_T_INIT = 904               # pipeline fill cycles
FPGA_GEMM_PEAK = 0.6e12         # FLOP/s fp32 — FPGA'20 systolic GEMM [31]
FPGA_HBM_BW = 460e9             # B/s HBM2

# NVIDIA H100 SXM5 (NVIDIA's H100 Tensor Core GPU data sheet)
H100_FP32 = 67e12               # FLOP/s, float32 outside the tensor cores
H100_HBM_BW = 3.35e12           # B/s HBM3
H100_L2 = 50e6                  # bytes of L2
H100_SLAB = 128                 # B1's output columns a warp covers per pass

_LAUNCH_GPU = 8e-6              # kernel launch overhead (s)
_LAUNCH_FPGA = 25e-6            # XRT enqueue overhead (s)


def _jitter(tag: str, *vals, amp: float = 0.04) -> float:
    """Deterministic pseudo-measurement noise: +/- amp, stable across calls.
    Models run-to-run variance + un-modeled micro-architectural effects."""
    h = hashlib.md5(("|".join([tag] + [f"{v:.6g}" for v in vals])).encode())
    u = int.from_bytes(h.digest()[:8], "big") / 2**64
    return 1.0 + amp * (2.0 * u - 1.0)


def _ceil_to(x: float, q: float) -> float:
    return math.ceil(x / q) * q


# ---------------------------------------------------------------------------
# GPU kernels (MI210)
# ---------------------------------------------------------------------------
def gpu_spmm(k: KernelSpec) -> float:
    """rocsparse_spmm (CSR x dense). Heavily memory/gather bound; efficiency
    degrades with sparsity (random row gathers) and improves with N (row
    reuse). Roofline over compute + touched bytes with non-linear efficiency.
    """
    # touched bytes: CSR (8B idx+val per nnz), gathered dense rows (nnz*N*4
    # with temporal-locality reuse growing with average degree), output M*N*4
    deg = k.nnz / max(k.M, 1)
    reuse = deg / (deg + 32.0)          # hot-row caching at high density
    gather = 0.25 + 0.75 * (1.0 - reuse)   # floor: mandatory compulsory misses
    bytes_touched = 8.0 * k.nnz + 4.0 * k.nnz * k.N * gather \
        + 4.0 * k.M * k.N
    mem_eff = 0.18 + 0.62 * reuse       # random gathers waste HBM bandwidth
    t_mem = bytes_touched / (MI210_HBM_BW * mem_eff)
    # compute: vector pipes (no MFMA for rocsparse), low utilization
    comp_eff = 0.25 + 0.15 * min(1.0, k.N / 512.0)
    t_cmp = k.flops / (MI210_FP32_VECTOR * comp_eff)
    # short-row latency/occupancy bound: row-per-wavefront dispatch exposes
    # per-row launch + pointer-chase latency when rows are short (the
    # well-known rocsparse csrmm pathology on highly sparse matrices)
    t_lat = 12e-9 * k.M
    # wave quantization on M
    waves = _ceil_to(k.M, 104 * 256) / max(k.M, 1)
    t = max(t_mem, t_cmp) * min(waves, 1.4) + t_lat + _LAUNCH_GPU
    return t * _jitter("gpu_spmm", k.M, k.N, k.nnz)


def gpu_gemm(k: KernelSpec) -> float:
    """rocblas_sgemm. MFMA pipes; efficiency depends on tile alignment and
    problem size (small K/N underutilize)."""
    flops = 2.0 * k.M * k.K * k.N
    size_eff = min(1.0, (k.M * k.K * k.N) ** (1 / 3) / 1500.0)
    align_eff = 0.95 if (k.N % 64 == 0 and k.K % 64 == 0) else 0.8
    eff = (0.30 + 0.55 * size_eff) * align_eff
    t_cmp = flops / (MI210_FP32_MATRIX * eff)
    bytes_t = 4.0 * (k.M * k.K + k.K * k.N + k.M * k.N)
    t_mem = bytes_t / (MI210_HBM_BW * 0.75)
    return max(t_cmp, t_mem) + _LAUNCH_GPU * _jitter("gpu_gemm", k.M, k.K, k.N)


def gpu_win_attn(k: KernelSpec) -> float:
    """Sliding-window attention on GPU: the paper models it as DENSE attention
    (§V: HF/XFormers SWA kernels only save memory, not time)."""
    s, d, h = k.seq_len, k.d, k.heads
    flops = 4.0 * s * s * d + 5.0 * s * s * h
    t_cmp = flops / (MI210_FP32_MATRIX * 0.5)
    # S matrix materialization: write + 2 reads (softmax, SV)
    bytes_t = 3.0 * 4.0 * h * s * s + 4.0 * 3 * s * d
    t_mem = bytes_t / (MI210_HBM_BW * 0.8)
    return max(t_cmp, t_mem) + 3 * _LAUNCH_GPU * _jitter("gpu_attn", s, d)


# ---------------------------------------------------------------------------
# FPGA kernels (U280)
# ---------------------------------------------------------------------------
def fpga_spmm(k: KernelSpec) -> float:
    """Customized Sextans [30]: t = (nnz + 13 M) N / (F * N_M) — deterministic
    dataflow; mild HBM-channel imbalance as the only non-ideality."""
    cycles = (k.nnz + 13.0 * k.M) * k.N / SEXTANS_NM
    t = cycles / SEXTANS_F
    imbalance = _jitter("fpga_spmm_imb", k.M, k.nnz, amp=0.02)
    return t * imbalance + _LAUNCH_FPGA


def fpga_gemm(k: KernelSpec) -> float:
    """FPGA'20 communication-avoiding systolic GEMM [31] — fp32 peak ~0.6
    TFLOP/s; tile-quantization on M,N."""
    flops = 2.0 * k.M * k.K * k.N
    mq = _ceil_to(k.M, 256) / max(k.M, 1)
    nq = _ceil_to(k.N, 256) / max(k.N, 1)
    t_cmp = flops * mq * nq / FPGA_GEMM_PEAK
    t_mem = 4.0 * (k.M * k.K + k.K * k.N + k.M * k.N) / (FPGA_HBM_BW * 0.8)
    return max(t_cmp, t_mem) + _LAUNCH_FPGA * _jitter("fpga_gemm", k.M, k.N)


def fpga_win_attn(k: KernelSpec) -> float:
    """SWAT [6]: t = (seq_len * t_pipe + t_init) * (w/1024) / F — deterministic
    streaming systolic design."""
    cycles = (k.seq_len * SWAT_T_PIPE + SWAT_T_INIT) * (k.w / 1024.0)
    return cycles / SWAT_F * _jitter("swat", k.seq_len, k.w, amp=0.015) \
        + _LAUNCH_FPGA


# ---------------------------------------------------------------------------
# GPU kernels (H100, the port's own). The efficiency constants are fitted
# to the card's CUDA-event times at the six Table-I GCN specs and the two
# SWA-T specs (chip_smoke.py phase 18 (b); NVIDIA H100 80GB HBM3, power
# limit 700 W; PERF.md §5): B1's two terms and the launch by least squares
# in relative error, SGEMM's two by the smallest RMS log error, B2's as the
# geometric mean of its two specs'. A bytes-bound SGEMM runs at the share
# of the HBM rate that phase 18 (a)'s on-card copy reached (2,990 GB/s).
# ---------------------------------------------------------------------------
_H100_SPMM_BW_EFF = 0.826       # share of HBM rate B1's traffic reaches
_H100_SPMM_ROW = 0.333e-9       # s a (row, slab): a warp's pointer chase
_H100_GEMM_EFF = 0.72           # SGEMM's share of the float32 peak, deep K
_H100_GEMM_K_HALF = 44.5        # K at which SGEMM reaches half of that
_H100_GEMM_BW_EFF = 0.89        # measured copy rate over the HBM rate
_H100_ATTN_EFF = 0.461          # B2's float32 FMA share of the peak
_H100_ATTN_TILE = 128           # B2's key tile: keys computed past the band
_LAUNCH_H100 = 8.1e-6           # one launch, fitted with B1's terms (s)


def h100_spmm_bytes(k: KernelSpec) -> float:
    """HBM bytes of B1 on a CSR of uniformly scattered columns: indptr,
    indices and values once, each nnz's gathered 4N-byte row of X unless
    L2 (50 MB) still holds it (a share min(1, L2 / |X|) does), every
    touched row of X at least once, and the output once."""
    x_bytes = 4.0 * k.K * k.N
    hit = min(1.0, H100_L2 / max(x_bytes, 1.0))
    gathered = max(4.0 * k.nnz * k.N * (1.0 - hit),
                   min(x_bytes, 4.0 * k.nnz * k.N))
    return 8.0 * k.nnz + 4.0 * (k.M + 1) + gathered + 4.0 * k.M * k.N


def h100_spmm(k: KernelSpec) -> float:
    """B1, ``csrc/spmm_csr_rows.cu``: one warp a row, lanes on a 128-column
    slab as float4, N > 128 in slab passes. Bound by bytes (its FMA is
    under 1% of the float32 peak's time), at the share of the HBM rate
    that its scattered 512-byte gathers reach, plus a term a (row, slab)
    for the pointer chase of a warp (indptr, indices, X) that short rows
    cannot hide."""
    t_mem = h100_spmm_bytes(k) / (H100_HBM_BW * _H100_SPMM_BW_EFF)
    slabs = math.ceil(k.N / H100_SLAB)
    t_row = _H100_SPMM_ROW * k.M * slabs
    t = t_mem + t_row + _LAUNCH_H100
    return t * _jitter("h100_spmm", k.M, k.N, k.nnz)


def h100_gemm(k: KernelSpec) -> float:
    """cuBLAS SGEMM with TF32 off, as the port runs the dense stages: 2MKN
    over the float32 peak at an efficiency that grows with the depth K
    (the tall-skinny products of a GCN layer), or the bytes of A, B and C
    over the HBM rate, whichever is longer."""
    flops = 2.0 * k.M * k.K * k.N
    eff = _H100_GEMM_EFF * k.K / (k.K + _H100_GEMM_K_HALF)
    t_cmp = flops / (H100_FP32 * eff)
    bytes_t = 4.0 * (k.M * k.K + k.K * k.N + k.M * k.N)
    t_mem = bytes_t / (H100_HBM_BW * _H100_GEMM_BW_EFF)
    return (max(t_cmp, t_mem) + _LAUNCH_H100) \
        * _jitter("h100_gemm", k.M, k.K, k.N)


def h100_win_attn(k: KernelSpec) -> float:
    """B2's float32 route, ``csrc/swa_attention.cu``, on the band only: q.k
    and p.v, 4 d FLOPs a pair over the heads, and about five FLOPs a pair
    a head for the exponential and the running max and sum, on the CUDA
    cores' float32 FMA. The (query, key) pairs it computes a head: each
    query tile of 128 rows reads the window's keys plus one tile's
    overhang, and the first window of queries sees fewer keys (causal)."""
    s, w = k.seq_len, min(k.w, k.seq_len)
    pairs = s * (w + _H100_ATTN_TILE) - w * w / 2.0
    flops = 4.0 * pairs * k.d + 5.0 * pairs * k.heads
    t_cmp = flops / (H100_FP32 * _H100_ATTN_EFF)
    return (t_cmp + _LAUNCH_H100) * _jitter("h100_attn", k.seq_len, k.w,
                                            k.d)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
_TABLE = {
    ("GPU", "spmm"): gpu_spmm,
    ("GPU", "gemm"): gpu_gemm,
    ("GPU", "win_attn"): gpu_win_attn,
    ("FPGA", "spmm"): fpga_spmm,
    ("FPGA", "gemm"): fpga_gemm,
    ("FPGA", "win_attn"): fpga_win_attn,
    ("H100", "spmm"): h100_spmm,
    ("H100", "gemm"): h100_gemm,
    ("H100", "win_attn"): h100_win_attn,
}


def measure(kernel: KernelSpec, dev_name: str) -> float:
    """Ground-truth single-device execution time (seconds)."""
    try:
        fn = _TABLE[(dev_name, kernel.kind)]
    except KeyError:
        raise ValueError(f"no oracle for {kernel.kind} on {dev_name}") from None
    return fn(kernel)


def measure_multi(kernel: KernelSpec, dev_name: str, n: int) -> float:
    """n-device operator parallelism: rows/sequence split with a gather/scatter
    merge cost and an efficiency tail (imperfect splits)."""
    if n <= 1:
        return measure(kernel, dev_name)
    import dataclasses
    if kernel.kind == "win_attn":
        sub = dataclasses.replace(kernel, seq_len=math.ceil(kernel.seq_len / n))
    else:
        sub = dataclasses.replace(
            kernel, M=math.ceil(kernel.M / n),
            nnz=math.ceil(kernel.nnz / n))
    t = measure(sub, dev_name)
    split_eff = 1.0 + 0.03 * (n - 1)   # merge/imbalance tail
    return t * split_eff
