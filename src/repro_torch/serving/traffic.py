"""Deterministic traffic simulator: the request streams a production
deployment actually sees, compressed into a reproducible generator.

Scenarios expressible here (all seed-deterministic):
  * Poisson arrivals modulated by a diurnal load curve (cosine day/night,
    peak at t=0) — the paper's peak/off-peak objective-switch example,
  * bursty windows (scripted rate multipliers) riding on the curve,
  * irregular GNN/LLM request mixes — each arrival samples a workload
    whose characteristic signature drives the data-aware scheduler,
  * mid-stream device failure / repair (`PoolEvent`), exercising the
    resize -> reschedule -> continue path.

The sim owns the clock: fixed ticks, Poisson(rate*tick) arrivals placed
uniformly inside the tick, all randomness from one seeded numpy Generator.
Two runs with the same seed and config produce byte-identical telemetry —
which is what makes the end-to-end serving tests assertable.
"""
from __future__ import annotations

import dataclasses
import json
import math

import numpy as np

from ..core.workload import DATASETS, KernelSpec, Workload, gcn_workload, \
    swa_transformer_workload
from .request import Request
from .router import Router


@dataclasses.dataclass(frozen=True)
class MixItem:
    name: str
    kind: str                      # 'gnn' | 'llm'
    weight: float
    wl: Workload


@dataclasses.dataclass(frozen=True)
class PoolEvent:
    t: float
    action: str                    # 'fail' | 'join'
    dev: str                       # device-type name ('FPGA' / 'GPU' ...)
    count: int = 1


@dataclasses.dataclass(frozen=True)
class Burst:
    t0: float
    t1: float
    factor: float                  # rate multiplier inside [t0, t1)


def named_workload(name: str) -> Workload:
    """Workload by catalog name — the compact-trace vocabulary.

    Converted real traces (``tools/convert_trace.py``) record each arrival
    as a *name* instead of a full kernel chain, which keeps a multi-
    thousand-row excerpt checked into the repo small. ``from_record``
    resolves a missing ``kernels`` field through this catalog. Fixed names
    match ``default_mix``; ``llm-swa-<seq>`` is parametric on the raw
    sequence length. Unknown names raise ``ValueError`` (the trace edge
    tests pin this) — a silent default would replay the wrong signature."""
    if name == "gcn-arxiv":
        return gcn_workload(DATASETS["OA"])
    if name == "gcn-products":
        return gcn_workload(DATASETS["OP"])
    if name == "llm-swa-1k":
        return swa_transformer_workload(1024, 512, layers=2)
    if name == "llm-swa-4k":
        return swa_transformer_workload(4096, 512, layers=2)
    if name.startswith("llm-swa-"):
        tail = name[len("llm-swa-"):]
        if tail.isdigit():
            return swa_transformer_workload(int(tail), 512, layers=2)
    raise ValueError(f"unknown workload name: {name!r}")


def default_mix(*, llm_layers: int = 2) -> tuple:
    """Mixed irregular traffic: two GNN graph sizes + two LLM sequence
    regimes. Signatures differ across all four, so a stream over this mix
    exercises multi-schedule serving."""
    return (
        MixItem("gcn-arxiv", "gnn", 0.45, gcn_workload(DATASETS["OA"])),
        MixItem("gcn-products", "gnn", 0.20, gcn_workload(DATASETS["OP"])),
        MixItem("llm-swa-1k", "llm", 0.25,
                swa_transformer_workload(1024, 512, layers=llm_layers)),
        MixItem("llm-swa-4k", "llm", 0.10,
                swa_transformer_workload(4096, 512, layers=llm_layers)),
    )


@dataclasses.dataclass
class TimelinePoint:
    t: float
    rate: float
    queue_depth: int
    mode: str
    completed: int


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One recorded arrival: when it came, what it looked like. Carries the
    full kernel chain so replay reconstructs the exact characteristic
    signature the scheduler saw."""
    t: float
    kind: str                      # 'gnn' | 'llm' | ...
    wl: Workload
    deadline: float | None = None
    tenant: str = ""               # multi-tenant serving: owning tenant

    def to_record(self) -> dict:
        rec = {"t": round(self.t, 9), "kind": self.kind,
               "name": self.wl.name,
               "kernels": [dataclasses.asdict(k) for k in self.wl]}
        if self.deadline is not None:
            rec["deadline"] = round(self.deadline, 9)
        if self.tenant:
            rec["tenant"] = self.tenant
        return rec

    @classmethod
    def from_record(cls, rec: dict) -> "Arrival":
        if "kernels" in rec:
            wl = Workload(rec["name"],
                          tuple(KernelSpec(**k) for k in rec["kernels"]))
        else:
            # compact converted-trace row: resolve the kernel chain from
            # the workload catalog, keeping the recorded name so a
            # to_jsonl round-trip is stable
            wl = Workload(rec["name"], tuple(named_workload(rec["name"])))
        return cls(rec["t"], rec.get("kind", ""), wl, rec.get("deadline"),
                   rec.get("tenant", ""))


class TrafficSim:
    def __init__(self, *, seed: int = 0, duration: float = 60.0,
                 peak_rate: float = 8.0, trough_rate: float = 0.5,
                 day: float = 60.0, tick: float = 0.05,
                 deadline_slack: float | None = 30.0,
                 mix=None, bursts: tuple = (), events: tuple = (),
                 sample_every: float = 1.0, trace=None,
                 snapshot_every: float | None = None,
                 tenants: tuple = ()):
        self.seed = seed
        self.duration = duration
        # recorded-arrival replay: when ``trace`` (a sequence of Arrival) is
        # set, run() feeds exactly those arrivals instead of sampling the
        # Poisson/diurnal process — cluster-log replay through the router.
        self.trace = (tuple(sorted(trace, key=lambda a: a.t))
                      if trace is not None else None)
        self._trace_i = 0
        self.last_trace: list[Arrival] = []   # arrivals of the last run()
        self.peak_rate = peak_rate
        self.trough_rate = trough_rate
        self.day = day
        self.tick = tick
        self.deadline_slack = deadline_slack
        self.mix = tuple(mix) if mix is not None else default_mix()
        self.bursts = tuple(bursts)
        self.events = tuple(sorted(events, key=lambda e: e.t))
        self.sample_every = sample_every
        self.timeline: list[TimelinePoint] = []
        # periodic MetricsSnapshot cadence (sim seconds): every window the
        # run appends one cumulative snapshot to ``snapshots`` — the rows
        # the smoke benchmark persists (and round-trips through
        # ``MetricsSnapshot.to_json``). None = final snapshot only.
        self.snapshot_every = snapshot_every
        self.snapshots: list = []
        w = np.asarray([m.weight for m in self.mix], dtype=float)
        self._cum = np.cumsum(w / w.sum())
        # multi-tenant sampling: each arrival is attributed to a tenant
        # with probability proportional to its rate share, and inherits the
        # tenant's deadline SLO. The tenant draw is a *separate* RNG stream
        # position taken only when tenants are configured, so untenanted
        # runs keep the historical byte-identical arrival sequence.
        self.tenants = tuple(tenants)
        if self.tenants:
            s = np.asarray([max(sp.share, 1e-9) for sp in self.tenants],
                           dtype=float)
            self._tcum = np.cumsum(s / s.sum())
        else:
            self._tcum = None

    # -- the load curve -------------------------------------------------------
    def rate(self, t: float) -> float:
        """Diurnal cosine (peak at t=0, trough at day/2) times any active
        burst multiplier."""
        phase = 0.5 * (1.0 + math.cos(2.0 * math.pi * t / self.day))
        r = self.trough_rate + (self.peak_rate - self.trough_rate) * phase
        for b in self.bursts:
            if b.t0 <= t < b.t1:
                r *= b.factor
        return r

    def _pick(self, u: float) -> MixItem:
        return self.mix[int(np.searchsorted(self._cum, u, side="right"))]

    # -- trace recording / replay ---------------------------------------------
    def _tick_arrivals(self, rng, t: float, lam: float) -> list[Arrival]:
        """Arrivals inside [t, t+tick): sampled from the load curve, or cut
        from the recorded trace when replaying."""
        if self.trace is not None:
            out = []
            while (self._trace_i < len(self.trace)
                   and self.trace[self._trace_i].t < t + self.tick):
                a = self.trace[self._trace_i]
                self._trace_i += 1
                if a.t >= t:
                    out.append(a)
            return out
        n = int(rng.poisson(lam * self.tick))
        if not n:
            return []
        offs = np.sort(rng.uniform(0.0, self.tick, n))
        picks = rng.random(n)
        tpicks = rng.random(n) if self.tenants else None
        out = []
        for i, (off, u) in enumerate(zip(offs, picks)):
            item = self._pick(u)
            at = t + float(off)
            tenant, slo = "", None
            if tpicks is not None:
                spec = self.tenants[int(np.searchsorted(
                    self._tcum, tpicks[i], side="right"))]
                tenant, slo = spec.name, spec.slo
            if slo is not None:
                ddl = at + slo
            else:
                ddl = (None if self.deadline_slack is None
                       else at + self.deadline_slack)
            out.append(Arrival(at, item.kind, item.wl, ddl, tenant))
        return out

    def to_jsonl(self, path) -> None:
        """Write the arrival trace (replay source if set, else the arrivals
        recorded by the last ``run``) as one JSON record per line."""
        arrivals = self.trace if self.trace is not None else self.last_trace
        with open(path, "w") as f:
            for a in arrivals:
                f.write(json.dumps(a.to_record()) + "\n")

    @classmethod
    def from_jsonl(cls, path, **kw) -> "TrafficSim":
        """Replay a recorded arrival trace (t, workload kind, kernel sizes)
        through the simulator. ``duration`` defaults to just past the last
        recorded arrival so the whole trace plays out."""
        arrivals = []
        with open(path) as f:
            for line in f:
                if line.strip():
                    arrivals.append(Arrival.from_record(json.loads(line)))
        arrivals.sort(key=lambda a: a.t)   # tolerate out-of-order records
        if not arrivals:
            raise ValueError(f"empty arrival trace: {path}")
        if "duration" not in kw:
            last = arrivals[-1].t if arrivals else 0.0
            kw["duration"] = last + kw.get("tick", 0.05)
        return cls(trace=arrivals, **kw)

    # -- the drive loop -------------------------------------------------------
    def run(self, router: Router, *, drain: bool = True):
        """Drive ``router`` through the whole stream; returns the final
        ``MetricsSnapshot``. The router's watermark policy is anchored to
        the provisioned peak rate so utilization = offered / peak."""
        router.provisioned_capacity = self.peak_rate
        rng = np.random.default_rng(self.seed)
        self.last_trace = []
        self._trace_i = 0
        rid = 0
        t = 0.0
        ev_i = 0
        next_sample = 0.0
        self.snapshots = []
        next_snap = self.snapshot_every
        while t < self.duration:
            while ev_i < len(self.events) and self.events[ev_i].t <= t:
                ev = self.events[ev_i]
                ev_i += 1
                if ev.action == "fail":
                    router.on_failure(ev.dev, ev.count)
                elif ev.action == "join":
                    router.on_join(ev.dev, ev.count)
                else:
                    raise ValueError(ev.action)
            lam = self.rate(t)
            for a in self._tick_arrivals(rng, t, lam):
                self.last_trace.append(a)
                router.submit(Request(rid, a.wl, a.t, deadline=a.deadline,
                                      kind=a.kind, tenant=a.tenant), a.t)
                rid += 1
            t += self.tick
            router.step(t)
            if t >= next_sample:
                self.timeline.append(TimelinePoint(
                    round(t, 6), lam, len(router.queue), router.dyn.mode,
                    router.metrics.completed))
                next_sample += self.sample_every
            if next_snap is not None and t >= next_snap:
                self.snapshots.append(
                    router.metrics.snapshot(router.dyn.events))
                next_snap += self.snapshot_every
        if drain:
            router.drain(self.duration)
        if next_snap is not None:
            self.snapshots.append(router.metrics.snapshot(router.dyn.events))
        return router.metrics.snapshot(router.dyn.events)
