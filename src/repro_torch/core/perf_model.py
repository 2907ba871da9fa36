"""Kernel performance models (paper §V).

Two-step methodology, faithful to the paper:
  1. generate synthetic inputs spanning the characteristic space and
     "benchmark" them (here: against the analytic hardware oracle standing in
     for the real MI210/U280 — see ``hw_oracle.py``),
  2. fit a linear regression per (kernel kind, device type) over engineered
     features. Analytic FPGA formulas (Sextans / SWAT) enter as *features* of
     the regression, exactly as §V prescribes for "specialized estimation".

Feature sets (Eq. 7/8/9):
  SpMM/GPU      t = C1*N + C2*nnz + C3*GFLOP + C4*arm
  SpMM/FPGA     t = C * (nnz + 13M) N / (F * N_M * 1e3)
  GeMM/GPU      t = C1*K + C2*N + C3*MN + C4*MK + C5*KN + C6*MKN + b
  GeMM/FPGA     analytic [31] feature + MN tail
  win/FPGA      t = C * (seq_len*t_pipe + t_init) * (w/1024) / F
  win/GPU       dense-attention features (paper: SWA-on-GPU ~ dense)

The H100 role (the port's own kernels, ``hw_oracle.h100_*``) is appended
after these six, so that ``fit_models`` draws the six shared models'
points first, from the same generator, and fits them exactly as before:
  SpMM/H100     B1's HBM bytes, (row, slab) count, output and nnz terms
  GeMM/H100     GeMM/GPU's features
  win/H100      banded features (s*w*d, s*w*h, s*d, and w*w*d for the
                causal start): B2 runs the band only
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np

from . import hw_oracle
from .workload import KernelSpec

# ---------------------------------------------------------------------------
# feature engineering
# ---------------------------------------------------------------------------
def _f_spmm_gpu(k: KernelSpec):
    # Eq. 7 features (N, nnz, GFLOP, arm) + the "more detailed
    # characteristics" §V prescribes for complex kernels: gather-traffic
    # roofline terms (nnz*N scaled by a degree-based locality proxy, M*N
    # output stream) — non-linear combinations of shape and sparsity.
    deg = k.nnz / max(k.M, 1)
    return [k.N, k.nnz, k.gflop, k.arm,
            k.nnz * k.N * 1e-9,
            k.nnz * k.N / (1.0 + deg / 32.0) * 1e-9,
            k.M * k.N * 1e-9, k.M * 1e-6, 1.0]


def _f_spmm_fpga(k: KernelSpec):
    # the Sextans analytic estimate as the single feature (+bias)
    base = (k.nnz + 13.0 * k.M) * k.N / (hw_oracle.SEXTANS_F / 1e6
                                         * hw_oracle.SEXTANS_NM * 1e3)
    return [base * 1e-6, 1.0]   # base is in us-scale; normalize to s-scale


def _f_gemm_gpu(k: KernelSpec):
    return [k.K, k.N, k.M * k.N, k.M * k.K, k.K * k.N, k.M * k.K * k.N, 1.0]


def _f_gemm_fpga(k: KernelSpec):
    # architecture formula as feature ([31] is tile-quantized on M, N)
    mq = math.ceil(k.M / 256) * 256
    nq = math.ceil(k.N / 256) * 256
    base = 2.0 * mq * k.K * nq / hw_oracle.FPGA_GEMM_PEAK
    return [base, k.M * k.N * 1e-9, 1.0]


def _f_win_fpga(k: KernelSpec):
    base = (k.seq_len * hw_oracle.SWAT_T_PIPE + hw_oracle.SWAT_T_INIT) \
        * (k.w / 1024.0) / hw_oracle.SWAT_F
    return [base, 1.0]


def _f_win_gpu(k: KernelSpec):
    s, d, h = k.seq_len, k.d, k.heads
    return [s * s * d, s * s * h, s * d, 1.0]


def _f_spmm_h100(k: KernelSpec):
    slabs = math.ceil(k.N / hw_oracle.H100_SLAB)
    return [hw_oracle.h100_spmm_bytes(k) * 1e-12, k.M * slabs * 1e-9,
            k.M * k.N * 1e-12, k.nnz * 1e-9, 1e-6]


def _f_win_h100(k: KernelSpec):
    s, w, d, h = k.seq_len, min(k.w, k.seq_len), k.d, k.heads
    return [s * w * d * 1e-12, s * w * h * 1e-12, s * d * 1e-9,
            w * w * d * 1e-12, 1e-6]


FEATURES = {
    ("GPU", "spmm"): _f_spmm_gpu,
    ("FPGA", "spmm"): _f_spmm_fpga,
    ("GPU", "gemm"): _f_gemm_gpu,
    ("FPGA", "gemm"): _f_gemm_fpga,
    ("GPU", "win_attn"): _f_win_gpu,
    ("FPGA", "win_attn"): _f_win_fpga,
    ("H100", "spmm"): _f_spmm_h100,
    ("H100", "gemm"): _f_gemm_gpu,
    ("H100", "win_attn"): _f_win_h100,
}


# ---------------------------------------------------------------------------
# synthetic training-set generation (paper §V step 1)
# ---------------------------------------------------------------------------
def _synthetic_kernels(kind: str, rng: np.random.Generator, n: int = 256):
    ks = []
    for _ in range(n):
        if kind == "spmm":
            M = int(10 ** rng.uniform(4.5, 6.8))
            N = int(rng.choice([16, 20, 32, 64, 100, 128, 300, 600]))
            deg = 10 ** rng.uniform(0.1, 2.9)   # avg degree spans the space
            nnz = max(int(M * deg), M)
            ks.append(KernelSpec("syn", "spmm", M=M, K=M, N=N, nnz=nnz))
        elif kind == "gemm":
            M = int(10 ** rng.uniform(3.0, 6.8))
            K = int(rng.choice([16, 20, 32, 64, 100, 128, 300, 512, 600, 2048]))
            N = int(rng.choice([64, 128, 256, 512, 1536, 2048]))
            ks.append(KernelSpec("syn", "gemm", M=M, K=K, N=N))
        else:
            s = int(rng.choice([1024, 2048, 4096, 8192, 12288, 16384]))
            w = int(rng.choice([512, 1024, 2048, 4096]))
            if w > s:
                w = s
            ks.append(KernelSpec("syn", "win_attn", seq_len=s, w=w, d=512))
    return ks


@dataclasses.dataclass
class LinearModel:
    coef: np.ndarray
    feats: callable
    rel_rmse: float = 0.0

    def predict(self, k: KernelSpec) -> float:
        return float(max(np.dot(self.coef, self.feats(k)), 1e-7))


def fit_models(seed: int = 0) -> dict:
    """Fit every (device, kind) model on oracle-benchmarked synthetic points.
    Non-negative-ish least squares in log-free space; returns dict of models."""
    rng = np.random.default_rng(seed)
    models = {}
    for (dev, kind), feat in FEATURES.items():
        kernels = _synthetic_kernels(kind, rng)
        X = np.array([feat(k) for k in kernels], dtype=np.float64)
        y = np.array([hw_oracle.measure(k, dev) for k in kernels])
        # weighted LS in relative space: divide rows by y to minimize
        # relative (not absolute) error — small kernels matter for scheduling
        w = 1.0 / np.maximum(y, 1e-7)
        coef, *_ = np.linalg.lstsq(X * w[:, None], y * w, rcond=None)
        pred = np.maximum(X @ coef, 1e-7)
        rel = float(np.sqrt(np.mean(((pred - y) / y) ** 2)))
        models[(dev, kind)] = LinearModel(coef, feat, rel)
    return models


# ---------------------------------------------------------------------------
# f_perf — the scheduler's stage-time estimator
# ---------------------------------------------------------------------------
class PerfModel:
    """Estimates execution time of a group of kernels on ``n`` devices of one
    type (the paper's f_perf), including the gather/scatter cost of splitting
    an operator across devices (§II-B: incorporated into f_perf).

    ``host`` (a ``device.HostProfile``, optional) scales every kernel time
    by the hosting machine's per-device factor — the fitted models describe
    the *baseline* hardware; the profile says how one cluster host deviates
    from it. ``with_host`` derives a scaled view sharing the (expensive to
    fit) regression models, so per-host schedulers stay cheap to build."""

    def __init__(self, models: dict | None = None, *, oracle: bool = False,
                 host=None):
        self.oracle = oracle
        self.models = models if (models or oracle) else fit_models()
        self.host = host if (host is not None
                             and not host.is_uniform) else None
        # per-device-name factor memo: kernel_time is the DP's innermost
        # loop, and HostProfile.device_scale builds a dict per call
        self._host_scales: dict = {}

    def with_host(self, host) -> "PerfModel":
        """A host-scaled view of this model (shared fitted coefficients).
        A uniform (or None) profile returns ``self`` unchanged."""
        if host is None or host.is_uniform:
            return self
        return PerfModel(self.models, oracle=self.oracle, host=host)

    def _host_scale(self, dev_name: str) -> float:
        s = self._host_scales.get(dev_name)
        if s is None:
            s = self._host_scales[dev_name] = self.host.device_scale(
                dev_name)
        return s

    def kernel_time(self, k: KernelSpec, dev, n: int) -> float:
        """Time of one kernel on n devices of type ``dev`` (DeviceType)."""
        scale = (self._host_scale(dev.name)
                 if self.host is not None else 1.0)
        role = dev.perf_key or dev.name
        if self.oracle:
            return scale * hw_oracle.measure_multi(k, role, n)
        if n <= 1:
            return scale * self.models[(role, k.kind)].predict(k)
        if k.kind == "win_attn":
            sub = dataclasses.replace(k, seq_len=math.ceil(k.seq_len / n))
        else:
            sub = dataclasses.replace(k, M=math.ceil(k.M / n),
                                      nnz=math.ceil(k.nnz / n))
        t = self.models[(role, k.kind)].predict(sub)
        return scale * t * (1.0 + 0.03 * (n - 1))

    def group_time(self, kernels, dev, n: int) -> float:
        """Sequential execution of a kernel group on the same n devices.
        Row-split operator parallelism keeps per-device outputs disjoint, so
        no intra-stage gather is needed — distribution of the stage input is
        the inter-stage transfer (already charged at pool-aggregate
        bandwidth by f_comm); the per-device split-efficiency tail in
        ``kernel_time`` covers merge/imbalance (§II-B gather-scatter)."""
        return sum(self.kernel_time(k, dev, n) for k in kernels)

    # prefix-sum acceleration for the DP (group_time additive part)
    def prefix_table(self, wl, dev, n_max: int) -> dict:
        """pref[n][i] = sum of kernel_time(wl[0:i]) on n devices."""
        out = {}
        for n in range(1, n_max + 1):
            acc, pref = 0.0, [0.0]
            for k in wl:
                acc += self.kernel_time(k, dev, n)
                pref.append(acc)
            out[n] = pref
        return out
