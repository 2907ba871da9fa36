"""System specification: device types, counts, interconnect (Table II + §III).

Two instantiations ship:
  * the paper's GPU+FPGA testbed (3x U280 + 2x MI210) as ``paper_system``;
    schedules made on it are comparable across implementations of the
    scheduler;
  * a node of NVIDIA H100 SXM5 cards over NVLink 4 as ``h100_system``: a
    sparse pool and a dense pool of the same card (the pools differ by
    the kernels they run, not by silicon), priced by the ``"H100"`` role
    of ``hw_oracle`` (the port's own kernels on the card).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceType:
    name: str
    # dynamic power (W) per kernel kind while executing
    dyn_power: dict
    static_power: float            # W at idle
    transfer_power: float          # W during data transfers
    link_bw: float                 # GB/s per device to the interconnect
    mem_gb: float = 8.0
    perf_key: str = ""             # perf-model role ('' -> use name); a
                                   # pool may reuse another pool's models
                                   # (both H100 pools take the "H100" role)

    def dynamic(self, kind: str) -> float:
        return self.dyn_power.get(kind, self.dyn_power.get("*", 100.0))


@dataclasses.dataclass(frozen=True)
class HostProfile:
    """Per-host performance model: how one *host* (a cluster worker peer)
    deviates from the baseline hardware the kernel perf models were fitted
    against. The paper's heterogeneity argument (§I) is about unequal
    devices; at cluster scale the host itself is a second axis of
    inequality — an older PCIe generation, a downclocked card batch, a
    NUMA-hostile board — and the DP only makes meaningful placement
    decisions if that shows up in f_perf/f_comm.

    All factors are dimensionless multipliers against the fitted models:

      * ``compute_scale`` — every stage execution time on this host is
        multiplied by it (> 1.0 = slower host). Applies on top of the
        per-device factors below.
      * ``bw_scale``      — the host's effective interconnect bandwidth is
        multiplied by it (< 1.0 = narrower links; transfer times divide).
      * ``device_scales`` — per device-type extra multipliers, as a tuple
        of ``(device_name, factor)`` pairs (tuple, not dict, so profiles
        stay hashable and usable as DP-cache keys): e.g. a host whose
        FPGAs run a degraded shell while its GPUs are healthy.

    Frozen + hashable: schedulers cache solved pipelines per profile.
    ``UNIFORM`` (all factors 1.0) is the implicit profile of every host
    when heterogeneity is not configured — code paths must be bit-identical
    to the profile-free behavior in that case.
    """
    name: str = "uniform"
    compute_scale: float = 1.0
    bw_scale: float = 1.0
    device_scales: tuple = ()      # ((device name, factor), ...)

    @property
    def is_uniform(self) -> bool:
        return (self.compute_scale == 1.0 and self.bw_scale == 1.0
                and all(f == 1.0 for _, f in self.device_scales))

    def device_scale(self, dev_name: str) -> float:
        """Execution-time multiplier for one device type on this host."""
        return self.compute_scale * dict(self.device_scales).get(dev_name,
                                                                 1.0)

    def effective_period(self, pipeline) -> float:
        """This host's pipeline period for an already-solved pipeline:
        each stage's exec time scales by the device factor, its transfer
        times by 1/bw_scale, and the period is the max stage total — the
        cheap placement/steal heuristic (exact times come from re-solving
        the DP under ``PerfModel.with_host``). ``pipeline`` is duck-typed
        (``scheduler.Pipeline``); times are simulated seconds."""
        return max((s.t_exec * self.device_scale(s.dev.name)
                    + (s.t_in + s.t_out) / self.bw_scale
                    for s in pipeline.stages), default=0.0)

    def to_dict(self) -> dict:
        """JSON-friendly form (cluster event log, CLI round-trips)."""
        d = {"name": self.name, "compute_scale": self.compute_scale,
             "bw_scale": self.bw_scale}
        if self.device_scales:
            d["device_scales"] = dict(self.device_scales)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "HostProfile":
        return cls(d.get("name", "uniform"),
                   float(d.get("compute_scale", 1.0)),
                   float(d.get("bw_scale", 1.0)),
                   tuple(sorted(d.get("device_scales", {}).items())))


#: The profile of a host indistinguishable from the model baseline.
UNIFORM_HOST = HostProfile()


def relative_profile(truth: HostProfile, belief: HostProfile,
                     name: str = "relative") -> HostProfile:
    """The profile mapping a *belief*-scaled schedule onto *truth* physics:
    applying it (``scheduler.apply_profile``) to a schedule whose stage
    times already reflect ``belief`` yields the times ``truth`` would
    produce — ``rel.device_scale(d) == truth.device_scale(d) /
    belief.device_scale(d)`` for every device type, and likewise for
    bandwidth. Identity (uniform) when belief matches truth, so a worker
    whose controller already knows its physics rescales nothing. This is
    what lets a cluster worker *be* slow (ground truth injected at the
    edge) while the control plane's belief starts uniform and must be
    learned (``repro.fleet.OnlineHostEstimator``)."""
    devs = ({d for d, _ in truth.device_scales}
            | {d for d, _ in belief.device_scales})
    cs = truth.compute_scale / belief.compute_scale
    scales = tuple(sorted(
        (d, (truth.device_scale(d) / belief.device_scale(d)) / cs)
        for d in devs))
    return HostProfile(name, cs, truth.bw_scale / belief.bw_scale, scales)


@dataclasses.dataclass(frozen=True)
class Interconnect:
    name: str
    scale: float                   # bandwidth multiplier over PCIe 4.0
    p2p: bool = True
    base_latency: float = 10e-6    # per-transfer setup latency (s)
    cpu_latency: float = 100e-6    # extra when staging through CPU memory


# Table II + §III-A numbers
MI210 = DeviceType(
    name="GPU",
    dyn_power={"spmm": 300.0, "gemm": 300.0, "win_attn": 300.0, "*": 300.0},
    static_power=45.0, transfer_power=150.0,
    link_bw=31.52, mem_gb=64.0)

U280 = DeviceType(
    name="FPGA",
    dyn_power={"spmm": 55.0, "win_attn": 50.2, "gemm": 60.0, "*": 55.0},
    static_power=19.5, transfer_power=30.0,
    link_bw=15.76, mem_gb=8.0)

# NVIDIA H100 SXM5 80GB. Figures cited from NVIDIA's H100 Tensor Core GPU
# data sheet ("data sheet"), or measured on one card by chip_smoke.py phase
# 18 (a) (NVIDIA H100 80GB HBM3, power limit 700.00 W; PERF.md §5): the
# median of nvidia-smi's power.draw over 2 s of a loop. Powers follow the
# energy model's split (energy_model.py): static_power is the idle draw,
# charged for the whole period; dyn_power and transfer_power are the draw
# above idle while a kind's port kernel (B1 at ogbn-arxiv, SGEMM 8192^3
# with TF32 off, B2's float32 route at SWA-T's 16,384 x 1,024), or a
# pinned host-card copy loop, runs. link_bw keeps the module's convention:
# the PCIe 4.0 x16 figure (MI210's 31.52 GB/s), which an Interconnect's
# scale projects.
_H100 = dict(
    dyn_power={"spmm": 552.4, "gemm": 626.4, "win_attn": 512.4,
               "*": 626.4},                 # measured, above idle
    static_power=71.5,                      # measured idle draw
    transfer_power=67.4,                    # measured, above idle
    link_bw=31.52,                          # PCIe 4.0 x16 convention
    mem_gb=80.0,                            # data sheet
    perf_key="H100")
H100_SPARSE = DeviceType(name="H100_SPARSE", **_H100)
H100_DENSE = DeviceType(name="H100_DENSE", **_H100)

INTERCONNECTS = {
    "pcie4": Interconnect("PCIe4.0", 1.0),
    "pcie5": Interconnect("PCIe5.0", 2.0),
    "cxl3": Interconnect("CXL3.0", 4.0),
    # NVLink 4: 450 GB/s each way a GPU (data sheet: 900 GB/s
    # bidirectional) over link_bw's PCIe 4.0 figure; point to point, no
    # PCIe root complex (the scheduler's conflict model leaves it out).
    # Latencies: the class defaults, not measured (one card)
    "nvlink4": Interconnect("NVLink4", 450.0 / 31.52),
}


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """Counts per device type + interconnect. dev_a is the 'accelerator for
    irregular kernels' pool (FPGA), dev_b the dense pool (GPU). ``extra``
    holds any further (DeviceType, count) pools beyond the paper's two; the
    DP scheduler iterates ``pools`` so >2-pool systems reuse Algorithm 1."""
    dev_a: DeviceType
    n_a: int
    dev_b: DeviceType
    n_b: int
    interconnect: Interconnect
    extra: tuple = ()              # ((DeviceType, count), ...)

    @property
    def pools(self) -> tuple:
        """Ordered (DeviceType, count) pools — a, b, then extras."""
        return ((self.dev_a, self.n_a), (self.dev_b, self.n_b)) \
            + tuple(self.extra)

    @property
    def types(self):
        return {dev.name: (dev, n) for dev, n in self.pools}

    def with_counts(self, n_a: int, n_b: int,
                    extra_counts=None) -> "SystemSpec":
        """New per-pool counts; ``extra_counts=None`` keeps the extra pools
        unchanged, otherwise it must name a count for every extra pool (a
        short vector would silently drop pools)."""
        if extra_counts is None:
            extra = self.extra
        else:
            if len(extra_counts) != len(self.extra):
                raise ValueError(
                    f"extra_counts has {len(extra_counts)} entries for "
                    f"{len(self.extra)} extra pools")
            extra = tuple((dev, c)
                          for (dev, _), c in zip(self.extra, extra_counts))
        return dataclasses.replace(self, n_a=n_a, n_b=n_b, extra=extra)

    def with_extra(self, *pools) -> "SystemSpec":
        """Add extra device pools: with_extra((MI210, 2), ...)."""
        return dataclasses.replace(self, extra=self.extra + tuple(pools))

    def with_interconnect(self, ic: str) -> "SystemSpec":
        return dataclasses.replace(self, interconnect=INTERCONNECTS[ic])


def paper_system(interconnect: str = "pcie4") -> SystemSpec:
    """The paper's testbed: 3x U280 + 2x MI210."""
    return SystemSpec(dev_a=U280, n_a=3, dev_b=MI210, n_b=2,
                      interconnect=INTERCONNECTS[interconnect])


def h100_system(n_sparse: int = 3, n_dense: int = 2) -> SystemSpec:
    """An H100 node as two heterogeneous pools over NVLink 4: ``n_sparse``
    cards in the irregular-kernel pool (dev_a) and ``n_dense`` in the dense
    pool (dev_b), the counts of the paper's testbed by default."""
    return SystemSpec(dev_a=H100_SPARSE, n_a=n_sparse, dev_b=H100_DENSE,
                      n_b=n_dense, interconnect=INTERCONNECTS["nvlink4"])

