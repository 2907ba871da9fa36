"""The streaming request router: queue -> batcher -> DynamicScheduler ->
ExecutionBackend, with elastic pool events and objective switching.

This is the serving-side control loop the paper's §II sketches around the
traffic-forecasting example. Per cycle (``step``, one call per simulated
tick, single-threaded) it:

  1. expires hopeless queued requests (deadline passed while waiting),
  2. updates the perf/energy objective from the load-watermark policy and
     pushes it into ``DynamicScheduler.set_mode`` (a mode change bumps the
     scheduler epoch, invalidating every resident pipeline handle; the next
     batch reschedules under the new objective),
  3. forms signature batches and *submits* them to the ``Engine`` without
     blocking (``ExecutionBackend.submit`` -> ``BackendFuture``): the loop
     keeps admitting and batching while up to one in-flight batch per
     resident cell executes on its disjoint device subset,
  4. reaps *ready* completions — simulated finish at or before ``now`` —
     in timestamp order and applies each ``CompletionReport`` to its
     requests and the metrics — and feeds the report's backend-*measured*
     per-stage seconds (not the DP estimates) into the owning cell's
     ``StragglerMonitor``, closing the paper's measurement loop: a
     genuinely slow device accumulates strikes, gets demoted, and forces
     a reschedule end-to-end.

Reaping is **deferred across control cycles**: a batch whose simulated
finish lies beyond ``now`` stays in flight and is reaped at the *start*
of the first later cycle that passes it (before any dispatching), so a
slow in-flight batch never delays dispatch of other cells and a torch
backend's device work overlaps as many host cycles as it needs.
``drain`` delivers everything at stream end.

``async_mode=False`` degrades step 3/4 to blocking per-batch dispatch
(identical completion ordering and telemetry when no straggler fires —
asserted by tests; with live straggler feedback the sync path may demote
one batch earlier inside a cycle). The Router itself contains no execution
math; analytic, real-pipeline (torch), trace-replay, and multi-host
cluster execution all sit behind the ``ExecutionBackend`` protocol.

Elastic events mirror ``runtime.elastic.ElasticRuntime``: ``on_failure`` /
``on_join`` shrink/grow the pool via ``DynamicScheduler.resize``, and
measured stage times feed the owning cell's StragglerMonitor whose
persistent flags demote a device (with optional speculative re-admission
after a clean probation window — ``ProbationTracker``). A cluster
controller attaches through exactly these hooks plus ``clock_hooks``
(called with ``now`` each cycle): a worker lost to a heartbeat miss
arrives as ``on_failure`` per device pool, and its in-flight batches are
delivered with ``report=None`` — the Router re-queues their requests at
the front of the queue, so a mid-stream worker kill loses zero requests.
The router differs from ElasticRuntime in serving *many* workload
signatures concurrently instead of one pinned workload. All times are
simulated-clock seconds.
"""
from __future__ import annotations

import dataclasses
import time as _time

from ..core.dynamic import DynamicScheduler
from ..obs.trace import NULL_TRACER
from ..runtime.backend import ExecutionBackend, pipeline_fill  # noqa: F401
from ..runtime.elastic import PoolState
from ..runtime.straggler import ProbationTracker, WallClockCalibrator
from .batcher import Batch, SignatureBatcher
from .engine import Engine
from .metrics import ServingMetrics
from .policy import LoadWatermarkPolicy
from .request import Request, RequestQueue


@dataclasses.dataclass
class DispatchRecord:
    """One batch handed to the Engine (recorded at submit time; ``t0`` and
    ``finish`` are simulated seconds from the schedule model)."""
    t0: float
    sig: tuple
    mnemonic: str
    mode: str
    n: int
    finish: float
    cell: int = -1                 # engine cell id that served the batch
    devices: dict = dataclasses.field(default_factory=dict)


class Router:
    """Single-threaded serving control loop. ``async_mode`` selects
    non-blocking submit + end-of-cycle reap (default) vs blocking per-batch
    dispatch; both drive every batch through the same Engine/backend path.
    """

    def __init__(self, dyn: DynamicScheduler, *,
                 queue: RequestQueue | None = None,
                 batcher: SignatureBatcher | None = None,
                 policy: LoadWatermarkPolicy | None = None,
                 metrics: ServingMetrics | None = None,
                 backend: ExecutionBackend | None = None,
                 engine: Engine | None = None,
                 max_cells: int = 2,
                 async_mode: bool = True,
                 probation: ProbationTracker | None = None,
                 calibrator: WallClockCalibrator | None = None,
                 estimator=None,
                 tracer=None,
                 tenancy=None):
        self.dyn = dyn
        self.async_mode = async_mode
        # repro.tenancy.TenantManager, when multi-tenant: priority bands +
        # WFQ state shared with a TenantBatcher, and the preemption policy
        # (_preempt_pass). None = single-tenant, zero new behavior.
        self.tenancy = tenancy
        self.queue = queue or RequestQueue()
        self.batcher = batcher or SignatureBatcher()
        self.policy = policy or LoadWatermarkPolicy(
            initial_mode=dyn.mode)
        self.metrics = metrics or ServingMetrics()
        # speculative re-admission of straggler-demoted devices (None =
        # demotion is permanent); the tracker outlives individual cells
        self.probation = probation
        # wall->sim calibration for wall-clock backends (torch): when set,
        # measured times are rescaled per (cell, executing worker) and fed
        # to the straggler monitors; None keeps them telemetry-only (the
        # pre-calibration behavior)
        self.calibrator = calibrator
        # fleet.OnlineHostEstimator: learns per-host profiles from the
        # measured/expected gap in each report, and *gates* host-mismatched
        # reports away from the straggler monitors (host-level slowness is
        # not a per-device straggler). Usually installed via
        # ``estimator.attach(router, controller)``.
        self.estimator = estimator
        # span bus (repro.obs.Tracer): every request gets a root span on
        # trace "r<rid>"; router housekeeping (placement, mode flips,
        # demotions) lands on the "router" trace. Spans are derived
        # outputs only — nothing below reads tracer state back — so
        # tracing never perturbs scheduling decisions or replay.
        self.tracer = tracer or NULL_TRACER
        self.engine = engine or Engine(dyn, backend, max_cells=max_cells,
                                       probation=probation,
                                       tracer=self.tracer)
        if self.tracer.enabled and not self.engine.tracer.enabled:
            self.engine.tracer = self.tracer   # caller-supplied engine
        # steals reported by the cluster controller during the engine
        # submit underway (on_steal fires inside ExecutionBackend.submit);
        # _dispatch drains them onto the submitting batch's request traces
        self._pending_steals: list[tuple] = []
        self._now = 0.0                # last control-cycle sim time
        self.pool = PoolState(dyn.system.n_a, dyn.system.n_b)
        self.dispatches: list[DispatchRecord] = []
        self.log: list[str] = []
        # called with ``now`` at the top of every control cycle (step and
        # each drain iteration); a cluster controller registers its tick
        # here. A hook may return the next sim time it needs to run —
        # drain's event-driven clock jumps there (failure detection fires
        # even when no serving event is due).
        self.clock_hooks: list = []
        self._capacity = 0.0           # requests/s of the last schedule
        # watermark reference: requests/s the deployment is provisioned for
        # (peak traffic). When unset, the last schedule's throughput is used.
        self.provisioned_capacity: float | None = None
        # repro.energy.ParetoGovernor, when attached: it owns the
        # objective (continuous per-cell operating points), so the binary
        # watermark flip in ``step`` stands down while arrivals keep
        # feeding the policy's forecaster
        self.governor = None

    # -- execution state (delegated to the Engine) ----------------------------
    @property
    def busy_until(self) -> float:
        return self.engine.busy_until

    @property
    def monitor(self):
        """StragglerMonitor of the most recently dispatched cell."""
        cell = self.engine.last_cell
        return cell.monitor if cell is not None else None

    # -- ingress --------------------------------------------------------------
    def submit(self, req: Request, now: float) -> bool:
        """Admit one request at simulated time ``now`` (seconds). Returns
        False (and counts a drop) when the queue is full or the deadline
        cannot survive the Engine's signature-aware wait estimate."""
        self.policy.observe_arrival(now, wl=req.wl)
        if self.tenancy is not None and req.tenant:
            req.priority = self.tenancy.priority(req.tenant)
        est = self.engine.est_wait(now, req.wl)
        tr = self.tracer
        if tr.enabled:
            tr.open_root(f"r{req.rid}", "request", req.arrival)
        ok = self.queue.admit(req, now, est_wait=est)
        if not ok:
            self.metrics.record_drop(tenant=req.tenant)
            if tr.enabled:
                tr.instant(f"r{req.rid}", "reject", now,
                           est_wait=round(est, 9))
                tr.close_root(f"r{req.rid}", now, status="rejected")
        elif tr.enabled:
            tr.instant(f"r{req.rid}", "admit", now, kind=req.kind,
                       est_wait=round(est, 9))
        # priority admission may have evicted lower-class queued requests
        # to make room: account them as drops (they were counted admitted)
        for victim in self.queue.take_displaced():
            self.batcher.forget([victim])
            self.metrics.record_drop(tenant=victim.tenant)
            if tr.enabled:
                tr.instant(f"r{victim.rid}", "displace", now,
                           by=req.tenant or req.rid)
                tr.close_root(f"r{victim.rid}", now, status="displaced")
        return ok

    # -- elastic events (runtime/elastic.py semantics) ------------------------
    def _elastic_managed(self, dev_name: str, what: str) -> bool:
        if PoolState.manages(self.dyn.system, dev_name):
            return True
        # extra SystemSpec pools have no resize hook (DynamicScheduler.resize
        # is a/b-only); log the event instead of crashing the stream
        self.log.append(f"ignoring {what} on unmanaged pool {dev_name}")
        return False

    def on_failure(self, dev_name: str, count: int = 1):
        """``count`` devices of pool ``dev_name`` dropped out: shrink the
        pool, bump the scheduler epoch, invalidate every resident cell.
        In-flight batches still drain (their devices stay booked via the
        engine's busy floor) and are reaped normally."""
        if not self._elastic_managed(dev_name, "failure"):
            return
        self.pool.adjust(self.dyn.system, dev_name, -count)
        self.log.append(f"failure: -{count} {dev_name}")
        self.dyn.resize(self.pool.n_a, self.pool.n_b)   # epoch bump
        self.engine.invalidate()

    def on_join(self, dev_name: str, count: int = 1):
        """``count`` devices of pool ``dev_name`` (re)joined: grow the
        pool and reschedule (mirror image of ``on_failure``)."""
        if not self._elastic_managed(dev_name, "join"):
            return
        self.pool.adjust(self.dyn.system, dev_name, count)
        self.log.append(f"join: +{count} {dev_name}")
        self.dyn.resize(self.pool.n_a, self.pool.n_b)   # epoch bump
        self.engine.invalidate()

    def on_profile(self, wid: str, profile) -> None:
        """Cluster-controller notification: worker ``wid``'s host profile
        changed (an ``OnlineHostEstimator`` publication). The controller
        already pruned its host-adjusted schedules; invalidating the
        resident cells forces the next batches through fresh placement +
        per-host DP re-solves under the learned physics. With live
        migration (``--migrate``) the backend has already moved the
        affected cells to better hosts via a drain-to-replica -> retire
        handoff, so the cells stay resident — no invalidation, no cold
        restart."""
        self.log.append(f"learned profile for {wid}: "
                        f"x{profile.compute_scale:g} compute, "
                        f"x{profile.bw_scale:g} bw")
        if getattr(self.engine.backend, "handles_migration", False):
            self.log.append(f"cells on {wid} migrating live (no invalidate)")
            return
        self.engine.invalidate()

    def on_replicas(self, hid: int, wids: tuple) -> None:
        """Cluster-controller notification: the serving replica set of
        backend cell ``hid`` changed (promotion, migration, retirement, or
        a replica host's death). Re-keys the owning engine cell's
        per-replica busy clocks so admission sees the new capacity —
        ``Cell.set_replicas`` keeps dropped replicas' in-flight work
        visible through the drain floor."""
        for cell in self.engine.cells.values():
            payload = cell.handle.payload
            if (isinstance(payload, tuple) and len(payload) == 2
                    and payload[1] == hid):
                cell.set_replicas(wids)
                self.log.append(
                    f"cell {cell.cid} replicas -> {list(wids)}")
                break

    def prewarm(self, wl, now: float) -> bool:
        """Admit a resident cell for ``wl`` ahead of demand (autoscaler
        pre-warming); returns True if a new cell deployed."""
        ok = self.engine.prewarm(wl, now)
        if ok:
            self.log.append(f"prewarm cell for {wl.name}")
            if self.tracer.enabled:
                self.tracer.instant("router", "prewarm", now, wl=wl.name)
        return ok

    def on_steal(self, frm: str, to: str, n: int):
        """Cluster-controller notification: a pending batch of ``n``
        requests bound for worker ``frm`` was stolen by (migrated to) the
        dry worker ``to``. Telemetry only — the batch's completion flows
        back through the normal reap path; the controller records the
        decision in its event log for replay."""
        self.metrics.record_steal()
        self.log.append(f"steal: batch of {n} {frm} -> {to}")
        if self.tracer.enabled:
            # fires inside the engine submit; _dispatch attributes it to
            # the submitting batch's request traces
            self._pending_steals.append((frm, to, n))

    def observe_stage_time(self, stage: int, t: float, cell: int | None = None):
        """Measured stage time from the executor; a persistent straggler
        demotes one device of that stage's pool (capacity loss) and forces
        a reschedule — same policy as ElasticRuntime. With a
        ``ProbationTracker`` the demotion is provisional: a clean
        probation window re-admits the device at reduced weight, and a
        relapse bans it for good.

        ``cell`` names the engine cell (``DispatchRecord.cell``) whose
        pipeline produced the measurement — required for correct
        attribution when several cells serve concurrently. Without it the
        observation falls to the cell that dispatched last."""
        target = self.engine.cell_by_id(cell) if cell is not None \
            else self.engine.last_cell
        if target is None:
            return False
        if stage >= len(target.schedule.pipeline.stages):
            return False
        if target.monitor.observe(stage, t):
            dev = target.schedule.pipeline.stages[stage].dev.name
            self.log.append(f"straggler flagged on stage {stage} ({dev})")
            if not PoolState.manages(self.dyn.system, dev):
                # extra SystemSpec pools have no elastic resize hook yet:
                # record the flag but keep serving at full capacity
                self.log.append(f"no elastic hook for pool {dev}; "
                                f"straggler flag recorded only")
                return False
            if self.probation is not None:
                self.probation.handle_demotion(dev, self.log)
            self.on_failure(dev, 1)
            if self.tracer.enabled:
                self.tracer.instant("router", "demote", self._now,
                                    stage=stage, dev=dev)
            return True
        return False

    # -- the serving cycle ----------------------------------------------------
    def capacity(self) -> float:
        return self.provisioned_capacity or self._capacity

    def _ready(self, now: float):
        return lambda sig, grp: self.engine.ready(grp[0].wl, now)

    def _run_hooks(self, now: float) -> list[float]:
        """Run the attached clock hooks (cluster controller ticks etc.);
        returns any wake-up times they request."""
        wakeups = []
        for hook in self.clock_hooks:
            w = hook(now)
            if w is not None:
                wakeups.append(w)
        return wakeups

    def step(self, now: float) -> list[Request]:
        """Run one control cycle at sim time ``now``; returns the requests
        that completed this cycle. The cycle opens by reaping every ready
        completion *deferred from earlier cycles* (simulated finish <=
        ``now``) so freed cells can be re-dispatched immediately — a slow
        in-flight batch defers across cycles instead of stalling the loop.
        Then every dispatchable batch is *submitted* without blocking (a
        torch backend's device work for several cells overlaps here, and
        with the rest of the loop); batches finishing beyond ``now`` stay
        in flight for a later cycle (or ``drain``)."""
        self._now = now
        self._run_hooks(now)
        done: list[Request] = list(self._reap(upto=now, at=now))
        dead = self.queue.expire(now)
        if dead:
            for req in dead:
                self.metrics.record_drop(tenant=req.tenant)
            self.batcher.forget(dead)
            if self.tracer.enabled:
                for req in dead:
                    self.tracer.instant(f"r{req.rid}", "expire", now)
                    self.tracer.close_root(f"r{req.rid}", now,
                                           status="expired")
        if self.governor is None:
            mode = self.policy.update(now, self.capacity())
            if mode != self.dyn.mode:
                self.log.append(
                    f"mode -> {mode} "
                    f"(rate={self.policy.offered_rate(now):.2f}/s)")
                self.dyn.set_mode(mode)                 # epoch bump
                if self.tracer.enabled:
                    self.tracer.instant("router", "mode", now, mode=mode)
        self._preempt_pass(now)
        while True:
            batch = self.batcher.next_batch(self.queue, now,
                                            ready=self._ready(now))
            if batch is None:
                break
            done.extend(self._dispatch(batch, now))
        return done

    # -- tenancy preemption ---------------------------------------------------
    def _preempt_pass(self, now: float) -> None:
        """Evict lower-priority in-flight batches when higher-priority
        groups are dispatchable but blocked on occupied capacity. The
        victim's requests re-queue at the front of *their own* priority
        band (``RequestQueue.requeue``) — the worker-loss drain-and-
        requeue discipline applied voluntarily, so nothing is dropped.
        No-op unless a ``TenantManager`` with ``preempt`` is attached and
        the batcher exposes ``blocked_pressure`` (a ``TenantBatcher``)."""
        ten = self.tenancy
        if ten is None or not ten.preempt:
            return
        pressure = getattr(self.batcher, "blocked_pressure", None)
        if pressure is None:
            return
        ready = self._ready(now)
        # each round evicts at most one batch; bounded by the in-flight set
        for _ in range(len(self.engine.inflight)):
            blocked = pressure(self.queue, now, ready)
            if blocked is None:
                return
            prio, sig = blocked[0], blocked[1]
            for victim in self._preempt_victims(prio, sig, now):
                batch = victim.batch
                if not self.engine.preempt(victim, now):
                    continue           # unsafe to cancel; try the next
                self.queue.requeue(batch.requests)
                self.batcher.forget(batch.requests)
                self.metrics.record_preempt(
                    len(batch.requests), t0=victim.t0, now=now,
                    tenant=batch.requests[0].tenant)
                self.log.append(
                    f"preempt: batch of {len(batch.requests)} "
                    f"({batch.requests[0].tenant or 'default'}) evicted "
                    f"for band-{prio} pressure")
                if self.tracer.enabled:
                    for req in batch.requests:
                        self.tracer.instant(f"r{req.rid}", "preempt", now,
                                            cell=victim.cell.cid)
                break
            else:
                return                 # no evictable victim: stop pushing

    def _preempt_victims(self, prio: int, sig, now: float) -> list:
        """In-flight batches evictable for band-``prio`` pressure on
        signature ``sig``, best victim first: only batches *holding the
        blocked signature's cell* (evicting an unrelated cell's batch
        throws work away without unblocking anything), strictly lower
        class, still unfinished, and not past the starvation bound (an
        aged batch finally executing is protected — repeated eviction
        would livelock the lowest class). Latest finish first, so
        not-yet-started stacked batches (zero wasted work) go before
        half-done ones.

        Victim scope follows why the group is blocked: when the blocked
        signature has a *resident* cell, only batches on that cell help
        (evicting an unrelated cell's batch throws work away without
        unblocking anything); when it has none — cell capacity itself is
        the bottleneck — any cell's lower-priority batch is in scope,
        since draining a cell is what lets the engine admit the new
        signature."""
        ten = self.tenancy
        cell = self.engine.cells.get((sig, self.dyn.mode))
        cands = []
        for inf in self.engine.inflight:
            if cell is not None and inf.cell is not cell:
                continue               # not occupying the blocked cell
            reqs = inf.batch.requests
            vprio = max(ten.priority(r.tenant) for r in reqs)
            if vprio <= prio:
                continue
            if inf.finish <= now:
                continue               # already complete; reap, don't evict
            head = min(r.arrival for r in reqs)
            if ten.promoted(reqs[0].tenant, head, now):
                continue
            cands.append((vprio, inf.finish, inf.seq, inf))
        cands.sort(key=lambda c: (-c[0], -c[1], -c[2]))
        return [c[3] for c in cands]

    def _dispatch(self, batch: Batch, t0: float) -> list[Request]:
        """All execution goes through the Engine -> ExecutionBackend; the
        Router records the dispatch *decision* at submit time (both
        modes, lost-or-not — ``dispatches`` is a decision log) and applies
        the CompletionReport to requests, metrics, and straggler monitors
        at reap time. Async mode returns [] here — completions surface
        via ``_reap``; sync mode blocks on the future, and a batch lost
        with its worker (report None) re-queues exactly like the async
        path."""
        solves0 = self.dyn.dp_solves
        w0 = _time.perf_counter()
        inf = self.engine.submit(batch, t0)
        wall = _time.perf_counter() - w0
        # placement-decision latency (DP lookup/solve + cell acquire +
        # backend dispatch) — the scheduler self-metric HTS warns becomes
        # the bottleneck at scale
        self.metrics.record_placement(wall)
        bid = len(self.dispatches)
        self._record_dispatch(inf.cell, batch, inf.t0, inf.finish)
        tr = self.tracer
        if tr.enabled:
            cache_hit = self.dyn.dp_solves == solves0
            wall_ms = round(wall * 1e3, 6)
            tr.instant("router", "place", inf.t0, bid=bid,
                       cell=inf.cell.cid, n=len(batch),
                       wall_ms=wall_ms, cache_hit=cache_hit)
            for req in batch.requests:
                trc = f"r{req.rid}"
                tr.child(trc, "batch", req.arrival, inf.t0, bid=bid)
                tr.instant(trc, "solve", inf.t0,
                           cache_hit=cache_hit, wall_ms=wall_ms)
                tr.instant(trc, "submit", inf.t0, cell=inf.cell.cid,
                           bid=bid, finish=round(inf.finish, 9))
            for frm, to, _n in self._pending_steals:
                for req in batch.requests:
                    tr.instant(f"r{req.rid}", "steal", inf.t0,
                               frm=frm, to=to)
        self._pending_steals.clear()
        if self.async_mode:
            return []
        cell, report = self.engine.resolve(inf)
        return self._apply_report(cell, batch, report, at=inf.t0)

    def _record_dispatch(self, cell, batch: Batch, t0: float,
                         finish: float) -> None:
        """Log one dispatch decision (its ``finish`` is the schedule
        model's prediction — a batch later lost with its worker keeps the
        record but never the metrics). The batch's busy interval enters
        the metrics only when its report is applied (``_apply_report``) —
        a lost batch never executed, so it must not inflate the overlap
        ratio."""
        res = cell.schedule
        self._capacity = res.throughput
        self.dispatches.append(DispatchRecord(
            t0, batch.sig, res.mnemonic, res.mode, len(batch),
            finish, cell=cell.cid, devices=dict(cell.devices)))

    def _apply_report(self, cell, batch: Batch, report,
                      at: float | None = None) -> list[Request]:
        """Deliver one CompletionReport: stamp the requests, update the
        metrics, and feed the backend-*measured* per-stage seconds into the
        owning cell's StragglerMonitor (the measurement loop).

        ``report=None`` means the batch was LOST — its worker died before
        finishing. The requests are returned to the front of the queue
        (they were admitted once; a worker failure must not turn into
        silent request loss) and re-dispatch onto the surviving pool."""
        if report is None:
            self.queue.requeue(batch.requests)
            self.metrics.record_requeue(len(batch.requests))
            self.log.append(f"lost batch of {len(batch.requests)} "
                            f"(worker died); re-queued")
            if self.tracer.enabled:
                t = at if at is not None else self._now
                for req in batch.requests:
                    self.tracer.instant(f"r{req.rid}", "requeue", t,
                                        cell=cell.cid)
            return []
        self.metrics.record_dispatch(report.t0, report.finish)
        for req, fin in zip(batch.requests, report.finishes):
            req.start = report.t0
            req.finish = fin
            req.energy = report.energy_per_req
            self.metrics.record_completion(req)
        if self.tracer.enabled:
            for req in batch.requests:
                trc = f"r{req.rid}"
                self.tracer.instant(trc, "reap", req.finish,
                                    cell=cell.cid, worker=report.worker)
                self.tracer.close_root(trc, req.finish,
                                       status="completed")
        self.metrics.record_stage_times(report.measured)
        demoted = self._feed_measured(cell, report)
        if not demoted and self.probation is not None:
            # a fully healthy report = one clean epoch toward re-admitting
            # demoted devices (speculative re-admission, reduced weight)
            self.probation.readmit_due(
                lambda dev: PoolState.manages(self.dyn.system, dev),
                self.on_join, self.log)
        return batch.requests

    def _feed_measured(self, cell, report) -> bool:
        """Route measured stage seconds to the cell that produced them;
        returns True if a straggler demotion fired. Measurements on the
        simulated clock feed the monitors directly. A wall-clock backend's
        (torch) times are on a different scale from the model baselines
        and, async, absorb unrelated host latency — raw, they would demote
        healthy devices, so without a ``WallClockCalibrator`` they stay
        telemetry-only; with one they are rescaled per (cell, stage) onto
        the simulated clock first (None during warmup = skip), which is
        what lets real measurements drive demotion too. Cells evicted or
        invalidated while their batch was in flight are skipped (their
        schedule no longer exists); a straggler demotion mid-report
        invalidates the engine, so feeding stops there."""
        if self.engine.cell_by_id(cell.cid) is not cell:
            return False
        stages = cell.schedule.pipeline.stages
        n_stages = len(stages)
        measured = report.measured[:n_stages]
        if (self.estimator is not None
                and self.engine.backend.measured_sim_clock):
            # feed the host estimator; a report mismatched against its
            # belief expectations is *withheld* from the straggler
            # monitors — an undeclared 60x-slow host must become a
            # learned profile, not a cascade of per-device demotions.
            # (Wall-clock backends feed the estimator through the
            # calibrator instead, after wall->sim rescaling.)
            if self.estimator.observe_report(report):
                return False
        if not self.engine.backend.measured_sim_clock:
            if self.calibrator is None:
                return False
            # key per (cell, EXECUTING worker): a stolen batch's wall
            # times come from the thief's hardware, and judging them
            # against the owner's locked scale would flag the hosts'
            # relative speed as drift (the old roadmap caveat — closed
            # now that reports carry the executing worker id)
            measured = self.calibrator.calibrate(
                (cell.cid, report.worker), measured,
                [s.total for s in stages],
                [s.dev.name for s in stages])
            if measured is None:
                return False           # still warming up on this cell
        for stage, t in enumerate(measured):
            if self.observe_stage_time(stage, t, cell=cell.cid):
                return True
        return False

    def _reap(self, upto: float | None = None,
              at: float | None = None) -> list[Request]:
        """Resolve in-flight batches (all of them, or those with simulated
        finish <= ``upto``) in timestamp order and deliver their reports.
        ``at`` is the control-cycle sim time, used to stamp requeue spans
        for lost batches (their report carries no finish)."""
        done: list[Request] = []
        for cell, batch, report in self.engine.reap(upto):
            done.extend(self._apply_report(cell, batch, report, at=at))
        return done

    def drain(self, now: float, *, horizon: float = 1e9) -> list[Request]:
        """Serve out the backlog after the arrival stream ends — queued
        requests AND every batch still in flight (deferred reaping leaves
        unfinished batches across cycles; they all deliver here).

        Underfull signature groups age out at ``max_wait`` as usual; any
        request still queued when the clock reaches ``horizon`` is flushed
        as a partial batch at the horizon instead of being silently
        stranded — every admitted request gets a completion (late ones
        count as deadline misses in the metrics, not as vanished work).
        The clock is event-driven: it jumps to the next group aging out,
        cell draining, in-flight finish, or clock-hook wake-up (a cluster
        failure detector's next heartbeat deadline) — so a worker killed
        during the drain is still detected, its lost batches re-queued,
        and the re-queued requests served before the drain returns. The
        reap clock may pass ``horizon``; the horizon bounds *dispatch*
        times only."""
        done: list[Request] = []
        t = now
        while len(self.queue) or self.engine.inflight:
            self._now = t
            wakeups = self._run_hooks(t)
            # deliver every batch the clock has passed before handing its
            # cell more work; a lost batch re-fills the queue right here
            done.extend(self._reap(upto=t, at=t))
            if not len(self.queue):
                if not self.engine.inflight:
                    break
                # nothing queued: jump to the next in-flight finish or
                # hook wake-up (failure detection of a silent worker)
                cands = [i.finish for i in self.engine.inflight] + wakeups
                nxt = min((c for c in cands if c > t), default=None)
                if nxt is None:        # pragma: no cover - detector stall
                    break
                t = nxt
                continue
            if t >= horizon:
                # horizon flush: force out every remaining group, partial
                # or not; cells serialize naturally via their busy clocks
                batch = self.batcher.next_batch(self.queue, float("inf"))
                if batch is None:       # pragma: no cover - queue nonempty
                    break
                done.extend(self._dispatch(batch, max(t, horizon)))
                continue
            self._preempt_pass(t)
            batch = self.batcher.next_batch(self.queue, t,
                                            ready=self._ready(t))
            if batch is not None:
                done.extend(self._dispatch(batch, t))
                continue
            # nothing dispatchable at t: advance to the next event — the
            # oldest group head aging past max_wait, a cell draining, an
            # in-flight batch finishing, or a hook wake-up
            cands = list(wakeups)
            oldest = self.queue.oldest
            if oldest is not None:
                cands.append(oldest.arrival + self.batcher.max_wait)
            nf = self.engine.next_free(t)
            if nf is not None:
                cands.append(nf)
            cands.extend(i.finish for i in self.engine.inflight)
            nxt = min((c for c in cands if c > t), default=horizon)
            t = min(horizon, nxt)
        done.extend(self._reap(at=t))
        return done
