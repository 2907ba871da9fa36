"""Elastic runtime: device-pool changes -> reschedule -> redeploy.

Ties together the fault-tolerance pieces:
  * ``on_failure`` / ``on_join`` shrink/grow the device pool and re-run the
    DYPE DP through the DynamicScheduler (the paper's scheduler reacting to
    system change instead of data change),
  * ``execute`` feeds the backend-*measured* per-stage seconds of every
    CompletionReport into the straggler monitor, so persistent drift on
    real (or replayed) hardware demotes a device after repeated strikes —
    no manual ``observe_stage_time`` calls needed,
  * for training jobs, redeployment = rebuild the mesh on the surviving
    hosts and restore the latest committed checkpoint (checkpoint/ckpt.py);
    for inference pipelines, redeployment = apply the new stage assignment.

The decision loop is pure host-side control logic — no device state — so it is
directly portable to a real cluster controller.
"""
from __future__ import annotations

import dataclasses

from ..core.dynamic import DynamicScheduler
from ..core.workload import Workload
from .backend import AnalyticBackend, CompletionReport, ExecutionBackend
from .straggler import ProbationTracker, StragglerMonitor


@dataclasses.dataclass
class PoolState:
    n_a: int
    n_b: int

    @staticmethod
    def manages(system, dev_name: str) -> bool:
        """Elastic events manage the two primary pools; extra SystemSpec
        pools have no resize hook (DynamicScheduler.resize is a/b-only)."""
        return dev_name in (system.dev_a.name, system.dev_b.name)

    def adjust(self, system, dev_name: str, delta: int) -> None:
        """Apply a signed capacity change to the named device pool."""
        if dev_name == system.dev_a.name:
            self.n_a = max(self.n_a + delta, 0)
        elif dev_name == system.dev_b.name:
            self.n_b = max(self.n_b + delta, 0)
        else:
            raise ValueError(f"{dev_name!r} is not an elastic-managed pool "
                             f"({system.dev_a.name}/{system.dev_b.name})")

    def count_of(self, system, dev_name: str) -> int:
        if dev_name == system.dev_a.name:
            return self.n_a
        if dev_name == system.dev_b.name:
            return self.n_b
        raise ValueError(f"{dev_name!r} is not an elastic-managed pool")


class ElasticRuntime:
    def __init__(self, dyn: DynamicScheduler, wl: Workload, *,
                 backend: ExecutionBackend | None = None,
                 probation: ProbationTracker | None = None):
        self.dyn = dyn
        self.wl = wl
        self.backend = backend or AnalyticBackend()
        self.pool = PoolState(dyn.system.n_a, dyn.system.n_b)
        # optional speculative re-admission of demoted devices: after
        # `probation.clean_epochs` healthy reports the device rejoins at
        # reduced weight (tightened straggler thresholds); None = demotion
        # is permanent (the pre-probation behavior)
        self.probation = probation
        self.log: list[str] = []
        self._redeploy()               # initial deploy, same path as re-deploys

    def _redeploy(self):
        self.schedule = self.dyn.submit(self.wl)
        self.handle = self.backend.prepare(self.schedule, self.wl,
                                           epoch=self.dyn.epoch)
        stages = self.schedule.pipeline.stages
        scales = ([self.probation.threshold_factor(s.dev.name)
                   for s in stages] if self.probation is not None else None)
        self.monitor = StragglerMonitor(
            len(stages), baselines=[s.total for s in stages],
            threshold_scales=scales)
        self.log.append(f"redeploy -> {self.schedule.mnemonic} "
                        f"thp={self.schedule.throughput:.2f}/s")
        return self.schedule

    def execute(self, n_requests: int = 1, t0: float = 0.0, *,
                feedback: bool = True) -> CompletionReport:
        """Run a batch through the execution backend on the active handle.
        A stale handle means a resize/objective flip happened outside the
        on_failure/on_join hooks — reschedule and redeploy before running
        (the old schedule's stage/device assignment no longer exists).

        With ``feedback`` (default) the report's backend-*measured*
        per-stage seconds are fed into the straggler monitor — persistent
        drift demotes a device and reschedules without any manual
        ``observe_stage_time`` calls (the closed measurement loop). Only
        simulated-clock measurements are fed: a wall-clock backend's
        (torch) times are incommensurate with the monitor's model-scale
        baselines (``ExecutionBackend.measured_sim_clock``). Times are
        seconds; the runtime is single-threaded host control logic."""
        if self.handle.stale(self.dyn.epoch):
            self._redeploy()
        report = self.backend.execute(self.handle, n_requests, t0)
        if feedback and self.backend.measured_sim_clock:
            n_stages = len(self.schedule.pipeline.stages)
            demoted = False
            for stage, t in enumerate(report.measured[:n_stages]):
                if self.observe_stage_time(stage, t) is not None:
                    demoted = True
                    break              # demotion rebuilt schedule + monitor
            if not demoted and self.probation is not None:
                # a fully healthy report counts as one clean epoch toward
                # re-admitting demoted devices at reduced weight
                self.probation.readmit_due(
                    lambda dev: PoolState.manages(self.dyn.system, dev),
                    self.on_join, self.log)
        return report

    def submit(self, n_requests: int = 1, t0: float = 0.0):
        """Non-blocking variant of ``execute``: returns the backend's
        ``BackendFuture``. Measured-time feedback is the caller's job here
        (feed ``future.result().measured`` through ``observe_stage_time``)
        because the report does not exist until the future resolves."""
        if self.handle.stale(self.dyn.epoch):
            self._redeploy()
        return self.backend.submit(self.handle, n_requests, t0)

    def on_failure(self, dev_name: str, count: int = 1):
        """A device dropped out (hardware fault / preemption)."""
        self.pool.adjust(self.dyn.system, dev_name, -count)
        self.log.append(f"failure: -{count} {dev_name}")
        self.dyn.resize(self.pool.n_a, self.pool.n_b)
        return self._redeploy()

    def on_join(self, dev_name: str, count: int = 1):
        """Capacity added back (repair / scale-out)."""
        self.pool.adjust(self.dyn.system, dev_name, count)
        self.log.append(f"join: +{count} {dev_name}")
        self.dyn.resize(self.pool.n_a, self.pool.n_b)
        return self._redeploy()

    def observe_stage_time(self, stage: int, t: float):
        """Feed measured stage times; persistent straggler -> demote the
        slowest device of that stage's pool and reschedule."""
        if self.monitor.observe(stage, t):
            dev = self.schedule.pipeline.stages[stage].dev.name
            self.log.append(f"straggler flagged on stage {stage} ({dev})")
            if not PoolState.manages(self.dyn.system, dev):
                self.log.append(f"no elastic hook for pool {dev}; "
                                f"straggler flag recorded only")
                return None
            if self.probation is not None:
                self.probation.handle_demotion(dev, self.log)
            return self.on_failure(dev, 1)
        return None

    def on_data_drift(self, wl: Workload):
        """New input characteristics (the paper's headline mechanism)."""
        self.wl = wl
        old = self.schedule.mnemonic
        self.schedule = self.dyn.submit(wl)
        if self.schedule.mnemonic != old:
            self.monitor = StragglerMonitor(
                len(self.schedule.pipeline.stages),
                baselines=[s.total for s in self.schedule.pipeline.stages])
            self.log.append(f"data drift: {old} -> {self.schedule.mnemonic}")
        return self.schedule
