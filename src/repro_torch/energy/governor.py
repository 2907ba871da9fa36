"""ParetoGovernor: continuous operating-point control on the DP frontier.

Replaces the ``LoadWatermarkPolicy``'s binary perf/energy flip with a
*monotone frontier walk*: each tick, the governor reads the
``ArrivalForecaster``'s per-signature demand and pins every signature to
the **lowest-energy** operating point whose aggregate throughput
(point throughput x serving replicas) still clears the forecast demand
plus a headroom factor. Upshifts (toward the perf endpoint) apply
immediately — never serve a rush under-provisioned; downshifts are gated
by a hysteresis band (the cheaper point must clear demand with *extra*
margin) so the frontier walk cannot flap between adjacent rungs on
forecast noise.

On top of demand tracking sits the fleet ``PowerBudget``: when the
modeled fleet draw exceeds the cap in force, the governor force-downshifts
the **coldest** cells first (lowest smoothed arrival rate, ties broken on
the signature itself) one rung at a time until the fleet fits — hot cells
keep their throughput for as long as the budget allows.

Operating-point changes flow through ``DynamicScheduler.set_target``:
an epoch bump invalidates resident pipeline handles, and the next submit
re-prepares the cell under the new point via the standard per-host DP
re-solve — exactly the path pool resizes and mode flips already take.
Every decision is appended as a derived ``opoint`` event, and every tick
as a ``power`` sample, to the cluster event log, so a recorded capped run
replays byte-identically (all inputs — forecast state, frontier, budget —
are deterministic functions of the arrival stream and the script).

Units: watts and joules per ``core.energy_model``; time is the simulated
clock. The energy SLO is J/request (== J/inference at the serving batch
granularity).
"""
from __future__ import annotations

import zlib

from ..cluster.events import ClusterEvent, ClusterEventLog
from ..core.dynamic import signature
from .frontier import FrontierCache

_LOCAL_WID = "local"


def sig_tag(sig) -> str:
    """A short, deterministic display tag for a workload signature (the
    dashboard's per-cell operating-point label): leading kernel kind plus
    a CRC of the full signature."""
    kind = sig[0][0] if sig else "-"
    return f"{kind}#{zlib.crc32(repr(sig).encode()) & 0xffff:04x}"


class ParetoGovernor:
    def __init__(self, *, interval: float = 1.0, headroom: float = 1.1,
                 hysteresis: float = 0.25, budget=None,
                 energy_slo_j: float | None = None):
        assert interval > 0 and headroom >= 1.0 and hysteresis >= 0.0
        self.interval = interval       # decision cadence (sim seconds)
        self.headroom = headroom       # capacity must clear demand x this
        self.hysteresis = hysteresis   # extra margin required to downshift
        self.budget = budget           # PowerBudget | None
        self.energy_slo_j = energy_slo_j
        self.router = None
        self.ctrl = None
        self.forecaster = None
        self.frontiers: FrontierCache | None = None
        self.events = ClusterEventLog()   # local-mode event sink
        self._idx: dict = {}           # sig -> current frontier index
        self._last_tick = -float("inf")
        self._pool = None              # full pool counts, resize detection
        # dashboard-facing state (last completed tick)
        self.last_watts = 0.0
        self.last_cap: float | None = None
        self.last_downshifts = 0
        self.points: dict = {}         # sig -> current OperatingPoint

    # -- wiring ----------------------------------------------------------------
    def attach(self, router, controller=None):
        """Wire into a serving Router (and optionally a cluster
        Controller) as a clock hook. Setting ``router.governor`` stands
        the watermark policy's mode flip down; arrivals keep feeding the
        policy's forecaster, which the governor reads."""
        fc = getattr(router.policy, "forecaster", None)
        if fc is None:
            raise ValueError("ParetoGovernor needs a policy with an "
                             "ArrivalForecaster (serve: --forecast-horizon)")
        self.router = router
        self.ctrl = controller
        self.forecaster = fc
        self.frontiers = FrontierCache(router.dyn)
        router.governor = self
        router.clock_hooks.append(self.tick)
        if controller is not None and self.budget is not None:
            controller.power_budget = self.budget
        return self

    def _log(self):
        return self.ctrl.events if self.ctrl is not None else self.events

    # -- per-signature capacity model ------------------------------------------
    def _replica_hosts(self) -> dict:
        """sig -> worker ids serving its cell (latest-epoch cell wins);
        local mode serves everything on the one in-process 'worker'."""
        if self.ctrl is None:
            return {}
        best: dict = {}
        for hid, (_s, wl, ep) in self.ctrl._cells.items():
            sig = signature(wl)
            if sig not in best or (ep, hid) > best[sig]:
                best[sig] = (ep, hid)
        out = {}
        for sig, (_ep, hid) in best.items():
            hosts = self.ctrl.replica_hosts(hid)
            if hosts:
                out[sig] = hosts
        return out

    # -- frontier selection ----------------------------------------------------
    def _allowed(self, front):
        """The SLO-feasible slice of a frontier (energy per inference at
        or under the SLO); empty-safe — when even the energy endpoint
        violates the SLO, that endpoint is the least-bad choice."""
        if self.energy_slo_j is None:
            return front, False
        ok = tuple(p for p in front if p.energy <= self.energy_slo_j)
        if not ok:
            return (front[-1],), True
        return ok, len(ok) != len(front)

    @staticmethod
    def _cheapest_clearing(points, need: float, replicas: int):
        """Lowest-energy point whose aggregate throughput clears
        ``need``; the fastest available point when none does."""
        for p in reversed(points):     # cheapest (highest idx) first
            if p.throughput * replicas >= need - 1e-12:
                return p
        return points[0]

    def _desired(self, front, demand: float, replicas: int, cur):
        """The hysteresis-banded target point: immediate upshift, gated
        downshift. Returns (point, reason)."""
        allowed, slo_bound = self._allowed(front)
        need = demand * self.headroom
        want = self._cheapest_clearing(allowed, need, replicas)
        reason = ("slo" if slo_bound and want.idx
                  != self._cheapest_clearing(front, need, replicas).idx
                  else "demand")
        if cur is None or want.idx < cur:
            return want, reason        # upshift / first sighting: take it
        if want.idx > cur:
            # downshift only with hysteresis margin to spare
            strict = self._cheapest_clearing(
                allowed, need * (1.0 + self.hysteresis), replicas)
            if strict.idx > cur:
                return strict, reason
        return None, reason            # hold the current rung

    # -- the decision tick -----------------------------------------------------
    def tick(self, now: float):
        if now - self._last_tick < self.interval - 1e-9:
            return None
        self._last_tick = now
        fc = self.forecaster
        if not fc.warmed_up:
            return None
        dyn = self.router.dyn
        pool = tuple(cnt for _, cnt in dyn.system.pools)
        if pool != self._pool:         # elastic resize: fronts are stale
            self.frontiers.invalidate()
            self._idx.clear()
            self.points.clear()
            self._pool = pool
        replica_hosts = self._replica_hosts()
        # frontiers live on the Engine's fair-share sub-pool — the pool
        # admission actually schedules cells on — so the frac knob and the
        # running schedules agree on the same throughput denominator
        share = self.router.engine._share_cap()

        tracked = []                   # (sig, front, replicas, hosts)
        for sig, wl in fc.signatures():
            try:
                front = self.frontiers.frontier(wl, pool=share)
            except RuntimeError:
                # infeasible under the share cap: admission would fall
                # back to the full pool, so the frontier does too
                try:
                    front = self.frontiers.frontier(wl)
                except RuntimeError:
                    front = ()
            if not front:
                continue
            hosts = replica_hosts.get(sig, (_LOCAL_WID,))
            tracked.append((sig, front, hosts))

        # 1) demand pass: per-signature hysteresis-banded frontier walk —
        #    PLANNED only; nothing is applied until the budget pass has
        #    had its say, so a demand upshift the cap would immediately
        #    claw back never costs an epoch bump
        plan: dict = {}                # sig -> [planned idx, reason]
        for sig, front, hosts in tracked:
            demand = fc.sig_forecast(now, sig)
            cur = self._idx.get(sig)
            pt, reason = self._desired(front, demand, len(hosts), cur)
            plan[sig] = [pt.idx if pt is not None else cur, reason]

        # 2) budget pass: while the planned assignment busts the cap,
        #    claw the *coldest* signature (lowest smoothed rate, ties on
        #    the signature) down one rung at a time
        cap = self.budget.cap(now) if self.budget is not None else None
        downshifts = 0
        worker_watts = self._worker_watts(tracked, plan)
        if cap is not None:
            while sum(worker_watts.values()) > cap + 1e-9:
                cold = None
                for sig, front, _hosts in tracked:
                    if plan[sig][0] >= len(front) - 1:
                        continue       # already at the energy endpoint
                    key = (fc.sig_rate(sig), sig)
                    if cold is None or key < cold[0]:
                        cold = (key, sig, front)
                if cold is None:
                    break              # nothing left to shed
                _key, sig, front = cold
                plan[sig] = [plan[sig][0] + 1, "cap"]
                downshifts += 1
                worker_watts = self._worker_watts(tracked, plan)

        # 3) apply the diff: one set_target (epoch bump) per signature
        #    whose final rung moved
        for sig, front, _hosts in tracked:
            idx, reason = plan[sig]
            if idx != self._idx.get(sig):
                self._apply(now, sig, front[idx], reason)

        # 4) publish: power sample, budget headroom, dashboard state
        fleet = round(sum(worker_watts.values()), 9)
        self.last_watts, self.last_cap = fleet, cap
        self.last_downshifts = downshifts
        self._log().append(ClusterEvent(now, "power", "", {
            "watts": fleet, "cap": cap, "downshifts": downshifts}))
        self.router.metrics.record_power(now, fleet)
        if self.budget is not None:
            n_active = (len(self.ctrl.active_workers())
                        if self.ctrl is not None else 1)
            self.budget.note(worker_watts, n_active)
        if self.router.tracer.enabled:
            self.router.tracer.instant("governor", "power", now,
                                       watts=fleet, cap=cap,
                                       downshifts=downshifts)
        return None

    def _worker_watts(self, tracked, plan) -> dict:
        """Modeled per-worker draw under a planned assignment: each
        serving replica of a signature's cell runs at the signature's
        planned operating point (its rating — energy x throughput)."""
        out: dict = {}
        for sig, front, hosts in tracked:
            pt = front[plan[sig][0]]
            for wid in hosts:
                out[wid] = out.get(wid, 0.0) + pt.watts
        return out

    def _apply(self, now: float, sig, pt, reason: str) -> None:
        """Move one signature to frontier point ``pt``: pin the target
        (epoch bump -> handle invalidation -> lazy DP re-prepare) and
        record the derived event."""
        self.router.dyn.set_target(sig, pt.frac)
        self._idx[sig] = pt.idx
        self.points[sig] = pt
        self._log().append(ClusterEvent(now, "opoint", "", {
            "sig": str(sig), "idx": pt.idx, "frac": pt.frac,
            "watts": round(pt.watts, 9), "reason": reason}))
        if self.router.tracer.enabled:
            self.router.tracer.instant("governor", "opoint", now,
                                       sig=sig_tag(sig), idx=pt.idx,
                                       frac=pt.frac, reason=reason)
