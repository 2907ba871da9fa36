"""Baseline schedulers (paper §VI-A).

  * GPU-only / FPGA-only       — single device type, rest removed
  * theoretical-additive       — sum of homogeneous throughputs, averaged
                                 energy efficiency
  * static                     — manually-tuned fixed schedule: stages split
                                 at kernel-kind boundaries, sparse kinds on
                                 FPGAs, dense kinds on GPUs, device counts
                                 divided evenly across same-type stages
  * FleetRec*                  — DYPE's DP constrained to a fixed kind->type
                                 mapping (device counts stay flexible),
                                 as implemented in the paper
"""
from __future__ import annotations

from .comm_model import transfer_time
from .device import SystemSpec
from .perf_model import PerfModel
from .scheduler import (Pipeline, ScheduleResult, Scheduler, Stage,
                        evaluate_assignment, result_of)
from .workload import Workload

SPARSE_KINDS = {"spmm", "win_attn"}     # FPGA-friendly (irregular) kinds


def preferred_type(kernel, system: SystemSpec) -> str:
    """The conventional manual mapping: irregular kernels -> FPGA pool,
    dense kernels -> GPU pool."""
    return system.dev_a.name if kernel.kind in SPARSE_KINDS else system.dev_b.name


# ---------------------------------------------------------------------------
def gpu_only(wl: Workload, system: SystemSpec, perf: PerfModel,
             mode: str = "perf") -> ScheduleResult:
    sched = Scheduler(system.with_counts(0, system.n_b), perf)
    return sched.schedule(wl, mode)


def fpga_only(wl: Workload, system: SystemSpec, perf: PerfModel,
              mode: str = "perf") -> ScheduleResult:
    sched = Scheduler(system.with_counts(system.n_a, 0), perf)
    return sched.schedule(wl, mode)


def theoretical_additive(wl: Workload, system: SystemSpec, perf: PerfModel,
                         mode: str = "perf"):
    """Sum of homogeneous throughputs; average of energy efficiencies."""
    a = fpga_only(wl, system, perf, mode)
    b = gpu_only(wl, system, perf, mode)
    thp = a.throughput + b.throughput
    eff = 0.5 * (a.energy_efficiency + b.energy_efficiency)
    return {"throughput": thp, "energy_efficiency": eff,
            "energy": 1.0 / eff if eff > 0 else float("inf")}


def pingpong_schedule(wl: Workload, system: SystemSpec,
                      perf: PerfModel) -> ScheduleResult:
    """Static two-pool offload for deep alternating chains (the paper's
    SWAT-hybrid transformer setup): GPUs own every dense kernel, FPGAs own
    every irregular kernel, activations ping-pong between the pools each
    layer. Requests pipeline across the pools, so the period is the busier
    pool's per-inference time including its share of the transfers."""
    pools = {system.dev_a.name: (system.dev_a, system.n_a),
             system.dev_b.name: (system.dev_b, system.n_b)}
    t_exec = {n: 0.0 for n in pools}
    parts = {n: [] for n in pools}
    for k in wl:
        t = preferred_type(k, system)
        dev, n = pools[t]
        dt = perf.kernel_time(k, dev, n)
        t_exec[t] += dt
        parts[t].append((k.kind, dt))
    # every type boundary moves the activation across PCIe
    comm = 0.0
    for a, b in zip(wl.kernels, wl.kernels[1:]):
        ta, tb = preferred_type(a, system), preferred_type(b, system)
        if ta != tb:
            comm += transfer_time(a.bytes_out, pools[ta][0], pools[ta][1],
                                  pools[tb][0], pools[tb][1],
                                  system.interconnect)
    stages = []
    for name, (dev, n) in pools.items():
        if parts[name] and n > 0:
            stages.append(Stage(0, len(wl), dev, n, t_exec[name],
                                tuple(parts[name]), t_in=comm))
    period = max(s.total for s in stages)
    pipe = Pipeline(tuple(stages), period,
                    sorted(s.total for s in stages)[-2] if len(stages) > 1
                    else 0.0)
    e_busy = sum(s.n * (sum(s.dev.dynamic(kd) * t for kd, t in s.exec_parts)
                        + s.dev.transfer_power * s.t_in) for s in stages)
    n_static = sum(s.n * s.dev.static_power for s in stages)
    pipe = Pipeline(tuple(stages), period, pipe.inner, e_busy, n_static)
    return result_of(pipe, "static")


def static_schedule(wl: Workload, system: SystemSpec,
                    perf: PerfModel) -> ScheduleResult:
    """The manually-tuned static baseline: fixed stages at kind-preference
    boundaries, fixed even device split (ad-hoc, like Fig. 2a). Deep
    alternating chains (transformers) fall back to the two-pool ping-pong
    offload — the paper's static transformer setup."""
    # segment the chain wherever the preferred device type changes
    segs = []
    for i, k in enumerate(wl):
        t = preferred_type(k, system)
        if segs and segs[-1][2] == t:
            segs[-1] = (segs[-1][0], i + 1, t)
        else:
            segs.append((i, i + 1, t))
    if len(segs) > system.n_a + system.n_b:
        return pingpong_schedule(wl, system, perf)
    # distribute each pool evenly over its stages (first stages get the
    # remainder — the manual tuner's usual choice)
    per_type = {}
    for i0, i1, t in segs:
        per_type.setdefault(t, []).append((i0, i1))
    counts = {system.dev_a.name: system.n_a, system.dev_b.name: system.n_b}
    alloc = {}
    for t, spans in per_type.items():
        n, m = counts[t], len(spans)
        if n < m:
            # fewer devices than stages: merge is impossible in a static
            # plan — round-robin share (device time-multiplexed), modeled
            # as 1 device per stage with the pool oversubscribed
            base, extra = 1, 0
        else:
            base, extra = divmod(n, m)
        for idx, span in enumerate(spans):
            alloc[span] = (t, base + (1 if idx < extra else 0))
    assignment = [(i0, i1, alloc[(i0, i1)][0], alloc[(i0, i1)][1])
                  for i0, i1, _ in segs]
    pipe = evaluate_assignment(wl, assignment, system, perf)
    return result_of(pipe, "static")


def fleetrec(wl: Workload, system: SystemSpec, perf: PerfModel,
             mode: str = "perf") -> ScheduleResult:
    """FleetRec*: DYPE's DP with the device TYPE fixed per kernel (counts
    flexible) — the paper implements it exactly this way. On transformers
    the type constraint makes a linear pipeline infeasible (more stages
    than devices), and FleetRec degenerates to the static ping-pong — the
    paper's §VI-C observation."""
    def constraint(dev_name, kernel):
        return dev_name == preferred_type(kernel, system)
    sched = Scheduler(system, perf, constraint=constraint)
    try:
        return sched.schedule(wl, mode)
    except RuntimeError:
        return pingpong_schedule(wl, system, perf)
