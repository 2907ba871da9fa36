"""Serving telemetry: latency percentiles, throughput, energy per request,
reschedule counts — the numbers a production router is judged by.

Pure-python accumulation (no numpy dependency on the hot path); percentile
uses the nearest-rank method so small samples behave predictably in tests.
"""
from __future__ import annotations

import dataclasses
import json
import math

from .request import Request


def percentile(xs, p: float) -> float:
    """Nearest-rank percentile; 0 for an empty sample."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = max(0, min(len(s) - 1, math.ceil(p / 100.0 * len(s)) - 1))
    return s[k]


def union_coverage(intervals) -> float:
    """Total length covered by a set of (start, end) intervals, overlaps
    merged — the 'wall time' denominator of the overlap ratios (also used
    by the cluster controller's cross-worker overlap)."""
    covered = 0.0
    lo = hi = None
    for t0, f in sorted(intervals):
        if lo is None:
            lo, hi = t0, f
        elif t0 > hi:
            covered += hi - lo
            lo, hi = t0, f
        else:
            hi = max(hi, f)
    return covered + ((hi - lo) if lo is not None else 0.0)


@dataclasses.dataclass
class MetricsSnapshot:
    completed: int
    dropped: int
    p50_latency: float         # s (simulated clock)
    p99_latency: float         # s
    throughput: float          # completed requests / sim second
    energy_per_req: float      # J
    deadline_miss_rate: float
    reschedules: dict          # reason -> count
    mode_switches: int
    overlap_ratio: float = 0.0     # pipeline busy-time / wall-time (>1 =>
    #                                concurrent cell execution)
    measured_stage_s: float = 0.0  # total backend-measured stage seconds
    requeued: int = 0              # requests re-queued after a lost batch
    #                                (worker death); they complete later
    steals: int = 0                # batches migrated to a dry worker by
    #                                the cluster controller's work stealing
    # scheduler self-metrics (repro.obs): wall-clock milliseconds per
    # placement decision (Engine.submit — DP lookup/solve + backend
    # dispatch), the overhead HTS warns becomes the bottleneck at scale.
    # Wall times are machine noise, so they are excluded from equality —
    # replay-determinism tests compare snapshots across runs.
    place_ms_p50: float = dataclasses.field(default=0.0, compare=False)
    place_ms_p99: float = dataclasses.field(default=0.0, compare=False)
    placements: int = 0            # dispatch decisions measured
    # repro.energy: fleet power draw sampled by the ParetoGovernor each
    # tick (simulated watts from resident cells' operating points — fully
    # deterministic, so they DO participate in replay equality), plus the
    # J/req alias and the governor's operating-point switch count
    watts_mean: float = 0.0
    watts_p95: float = 0.0
    joules_per_req: float = 0.0    # == energy_per_req (bench column name)
    opoint_switches: int = 0
    # repro.tenancy: in-flight batches evicted for higher-priority pressure
    # (their requests re-queued, nothing dropped) and the per-tenant
    # breakdown — tenant name -> row dict (completed/dropped/p50/p99/
    # deadline_miss_rate/joules_per_req/preempted). Simulated-clock
    # quantities only, so both participate in replay equality.
    preemptions: int = 0           # batches evicted
    preempted_requests: int = 0    # requests those batches carried
    tenants: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.as_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "MetricsSnapshot":
        return cls(**json.loads(s))


class ServingMetrics:
    def __init__(self):
        self.latencies: list[float] = []
        self.energies: list[float] = []
        self.completed = 0
        self.dropped = 0
        self.deadline_misses = 0
        self.t_first = None
        self.t_last = 0.0
        # per-batch execution intervals (simulated seconds) for the overlap
        # ratio, and backend-measured stage seconds (the feedback path)
        self._exec_intervals: list[tuple[float, float]] = []
        self.measured_stage_s = 0.0
        self.stage_observations = 0
        self.requeued = 0
        self.steals = 0
        # wall seconds per placement decision (repro.obs self-metrics)
        self.place_s: list[float] = []
        # (t, watts) samples recorded by the ParetoGovernor after each
        # tick's budget enforcement (simulated, deterministic)
        self.power_samples: list[tuple[float, float]] = []
        # repro.tenancy: preempted-batch counters and per-tenant ledgers
        # (tenant name -> accumulator dict); untenanted requests ("") stay
        # out of the per-tenant breakdown
        self.preemptions = 0
        self.preempted_requests = 0
        self.tenant_stats: dict[str, dict] = {}

    def _tacc(self, tenant: str) -> dict:
        acc = self.tenant_stats.get(tenant)
        if acc is None:
            acc = self.tenant_stats[tenant] = {
                "latencies": [], "energies": [], "completed": 0,
                "dropped": 0, "misses": 0, "preempted": 0}
        return acc

    def record_power(self, t: float, watts: float) -> None:
        """One fleet power sample (watts on the simulated clock) from the
        governor's post-enforcement tick."""
        self.power_samples.append((t, watts))

    def record_placement(self, wall_s: float) -> None:
        """Wall-clock cost of one dispatch decision (DP lookup/solve +
        cell acquire + backend submit), recorded by the Router."""
        self.place_s.append(wall_s)

    def record_dispatch(self, t0: float, finish: float) -> None:
        """One batch executed on some cell over simulated [t0, finish]."""
        self._exec_intervals.append((t0, finish))

    def record_stage_times(self, measured) -> None:
        """Backend-measured per-stage seconds from a CompletionReport."""
        self.measured_stage_s += sum(measured)
        self.stage_observations += len(measured)

    @property
    def overlap_ratio(self) -> float:
        """Total pipeline busy-time over wall-time, where wall-time is the
        union coverage of the execution intervals (time at least one cell
        was executing). 1.0 = fully serialized; > 1.0 = cells executed
        concurrently (the multi-pipeline / async-dispatch win)."""
        if not self._exec_intervals:
            return 0.0
        busy = sum(f - t0 for t0, f in self._exec_intervals)
        covered = union_coverage(self._exec_intervals)
        return busy / covered if covered > 0 else 0.0

    def record_completion(self, req: Request) -> None:
        self.completed += 1
        self.latencies.append(req.latency)
        self.energies.append(req.energy)
        missed = req.deadline is not None and req.finish > req.deadline
        if missed:
            self.deadline_misses += 1
        if self.t_first is None:
            self.t_first = req.arrival
        self.t_last = max(self.t_last, req.finish)
        if req.tenant:
            acc = self._tacc(req.tenant)
            acc["completed"] += 1
            acc["latencies"].append(req.latency)
            acc["energies"].append(req.energy)
            if missed:
                acc["misses"] += 1

    def record_drop(self, n: int = 1, tenant: str = "") -> None:
        self.dropped += n
        if tenant:
            self._tacc(tenant)["dropped"] += n

    def record_preempt(self, n: int, *, t0: float | None = None,
                       now: float | None = None, tenant: str = "") -> None:
        """One in-flight batch of ``n`` requests evicted by the Router's
        priority preemption (the requests re-queue — not drops). The
        partial execution [t0, now) still occupied its cell, so it enters
        the overlap-ratio intervals like any other busy time."""
        self.preemptions += 1
        self.preempted_requests += n
        if tenant:
            self._tacc(tenant)["preempted"] += n
        if t0 is not None and now is not None and now > t0:
            self._exec_intervals.append((t0, now))

    def record_requeue(self, n: int = 1) -> None:
        """Requests whose batch was lost with a dead worker and returned
        to the queue (they are NOT drops — they complete later)."""
        self.requeued += n

    def record_steal(self, n: int = 1) -> None:
        """Batches the cluster controller migrated to a dry worker."""
        self.steals += n

    @property
    def p50(self) -> float:
        return percentile(self.latencies, 50)

    @property
    def p99(self) -> float:
        return percentile(self.latencies, 99)

    @property
    def throughput(self) -> float:
        if self.t_first is None:
            return 0.0
        span = self.t_last - self.t_first
        return self.completed / span if span > 0 else 0.0

    @property
    def energy_per_req(self) -> float:
        return (sum(self.energies) / len(self.energies)
                if self.energies else 0.0)

    def snapshot(self, events=()) -> MetricsSnapshot:
        """``events``: the DynamicScheduler's RescheduleEvent log."""
        reasons: dict[str, int] = {}
        for e in events:
            reasons[e.reason] = reasons.get(e.reason, 0) + 1
        return MetricsSnapshot(
            completed=self.completed,
            dropped=self.dropped,
            p50_latency=self.p50,
            p99_latency=self.p99,
            throughput=self.throughput,
            energy_per_req=self.energy_per_req,
            deadline_miss_rate=(self.deadline_misses / self.completed
                                if self.completed else 0.0),
            reschedules=reasons,
            mode_switches=reasons.get("objective", 0),
            overlap_ratio=round(self.overlap_ratio, 6),
            measured_stage_s=round(self.measured_stage_s, 9),
            requeued=self.requeued,
            steals=self.steals,
            place_ms_p50=round(percentile(self.place_s, 50) * 1e3, 6),
            place_ms_p99=round(percentile(self.place_s, 99) * 1e3, 6),
            placements=len(self.place_s),
            watts_mean=round(
                (sum(w for _, w in self.power_samples)
                 / len(self.power_samples)) if self.power_samples else 0.0,
                6),
            watts_p95=round(percentile(
                [w for _, w in self.power_samples], 95), 6),
            joules_per_req=round(self.energy_per_req, 9),
            opoint_switches=reasons.get("opoint", 0),
            preemptions=self.preemptions,
            preempted_requests=self.preempted_requests,
            tenants={
                name: {
                    "completed": acc["completed"],
                    "dropped": acc["dropped"],
                    "preempted": acc["preempted"],
                    "p50_latency": round(
                        percentile(acc["latencies"], 50), 9),
                    "p99_latency": round(
                        percentile(acc["latencies"], 99), 9),
                    "deadline_miss_rate": (
                        round(acc["misses"] / acc["completed"], 9)
                        if acc["completed"] else 0.0),
                    "joules_per_req": round(
                        sum(acc["energies"]) / len(acc["energies"])
                        if acc["energies"] else 0.0, 9),
                }
                for name, acc in sorted(self.tenant_stats.items())
            },
        )
