"""The cluster controller: worker registry, host-aware cell placement,
work stealing, heartbeat failure detection, and the event log that makes
it all replayable.

Dask's scheduler/worker split (and HTS's scheduler-bottleneck argument) is
the blueprint: the controller owns *no* execution — it registers worker
peers, routes prepared pipelines and batch submissions to them over
``comms.Channel``s, and watches heartbeats. What it adds on top of the
single-host serving stack:

  * **heterogeneity** (docs/heterogeneity.md): every worker carries a
    ``HostProfile``; cells place by effective throughput (weighted by the
    host's pipeline period), each cell's schedule is re-solved for its
    owning host's physics (``HostPlanner``), and the host-adjusted
    schedule is what the worker times, the Engine's busy clocks advance
    by, and the straggler baselines are built from — a *known*-slow host
    is planned around, never misdiagnosed,
  * **work stealing** (``steal=True``): a pending batch bound for a slow
    host migrates at submit time to a dry, sub-pool-fitting, strictly
    faster peer; the decision is a derived ``steal`` event, re-derived
    identically on replay,
  * the failure story: every worker heartbeats its busy clock and
    measured-stage totals on the simulated clock; a worker silent for
    longer than ``hb_timeout`` is declared **lost**; its device sub-pool
    converts into per-pool ``on_failure`` events on the attached
    listeners (the serving ``Router`` or an ``ElasticRuntime``), which
    shrink the DP pool and reschedule onto the survivors; its in-flight
    submissions are marked failed, so the Engine's reap surfaces them as
    lost batches and the Router re-queues their requests (at-least-once
    delivery; zero lost requests),
  * everything — registrations (with profiles), scripted kills/joins/
    latency injections, steal decisions, heartbeat-miss detections,
    failure conversions — lands in a ``ClusterEventLog`` that round-trips
    through JSONL and replays deterministically (``events.py``).

Clock domains: all scheduling/telemetry times are **simulated seconds**
(the serving stack's shared clock). The only wall-clock state is the
remote-worker path (``add_remote_worker``): RPC waits are bounded by
``rpc_timeout`` *wall* seconds, because a real child process answers on
its own schedule. Threading: every method on ``Controller`` (and on
``HostPlanner``) is controller-thread-only — the single host control
loop that pumps ``tick(now)`` via ``Router.clock_hooks``; there are no
locks and no cross-thread calls. Fully deterministic over the in-process
transport.
"""
from __future__ import annotations

import dataclasses
import time as _time

from ..core.device import UNIFORM_HOST, HostProfile
from ..core.dynamic import signature
from ..core.scheduler import Scheduler, apply_profile
from ..obs.trace import NULL_TRACER
from ..runtime.backend import (ExecutionBackend, WorkerLost, _analytic_report,
                               make_backend)
from ..serving.metrics import union_coverage
from .comms import ChannelClosed, inproc_pair
from .events import ClusterEvent, ClusterEventLog
from .worker import InProcPeer, WorkerCore


@dataclasses.dataclass
class WorkerLink:
    """Controller-side record of one worker peer. ``alive`` is the
    *controller's view* (flips on declare_lost); the peer's ``failed``
    flag is the simulated ground truth a crash script sets — the gap
    between the two is exactly the detection latency. ``peer`` is None
    for a *remote* worker (a real process behind an ``MpChannel``): the
    controller then has nothing to pump in-process and instead requests
    heartbeats over the wire. ``profile`` is the host's performance model
    (``core.device.HostProfile``); ``busy_est`` is the controller's
    deterministic estimate of when this worker's last accepted batch
    finishes (simulated seconds, updated at submit time — fresher than
    the heartbeat-carried busy clock, and the input to the work-stealing
    dry-worker test). All fields are controller-thread state."""
    wid: str
    pool: dict                     # device name -> count this worker owns
    peer: InProcPeer | None        # None = remote (mp) worker
    chan: object                   # controller end of the channel pair
    profile: HostProfile = UNIFORM_HOST
    learned: bool = False          # profile published by the estimator
    parked: bool = False           # autoscaler drained it (alive, no cells)
    alive: bool = True
    last_hb: float = 0.0           # sim time of the last heartbeat received
    hb_ping: float = 0.0           # sim time of the last hb request (remote)
    last_recv_wall: float = 0.0    # wall time of the last message (remote)
    busy_est: float = 0.0          # sim finish of the last accepted batch
    assignments: int = 0           # cells ever placed here (round-robin key)
    sids: set = dataclasses.field(default_factory=set)   # in-flight submits
    stats: dict = dataclasses.field(default_factory=dict)
    # completed busy intervals (t0, finish); in-flight ones wait in
    # pending_intervals keyed by sid until their report lands — a batch
    # lost with the worker contributes only up to the last heartbeat
    intervals: list = dataclasses.field(default_factory=list)
    pending_intervals: dict = dataclasses.field(default_factory=dict)


class HostPlanner:
    """Host-aware re-solver for the controller: given a baseline schedule
    and the owning host's ``HostProfile``, re-run the DP under that host's
    physics (``Scheduler(host=...)``) on the *device budget the baseline
    schedule claimed* — the Engine booked those devices, so the host-
    optimized split may regroup stages freely but never grabs capacity the
    placement did not account for. Schedulers are cached per (budget,
    profile); ``perf`` defaults to a freshly fitted ``PerfModel`` but
    should be shared with the serving stack's model when available (the
    fit is the expensive part). Controller-thread-only, like everything
    the controller calls."""

    def __init__(self, system, perf=None):
        self.system = system
        self._perf = perf
        self._scheds: dict = {}

    @property
    def perf(self):
        if self._perf is None:
            from ..core.perf_model import PerfModel
            self._perf = PerfModel()
        return self._perf

    def __call__(self, schedule, workload, profile: HostProfile,
                 pool_cap: dict | None = None):
        """``pool_cap`` (a ``{device: count}`` sub-pool) additionally
        clamps the budget to what a *different* host actually has — the
        replica-deploy path, where the destination's sub-pool may be
        smaller than the one the baseline schedule was solved on. The
        re-solve then finds the best stage split that fits there (or
        raises ``RuntimeError`` when the workload cannot run on the
        clamped pool at all)."""
        used = schedule.pipeline.devices_used()
        counts = tuple(used.get(dev.name, 0) for dev, _ in self.system.pools)
        if pool_cap is not None:
            counts = tuple(min(c, pool_cap.get(dev.name, 0))
                           for c, (dev, _) in zip(counts, self.system.pools))
        key = (counts, profile)
        s = self._scheds.get(key)
        if s is None:
            sub = self.system.with_counts(counts[0], counts[1],
                                          extra_counts=counts[2:] or None)
            s = Scheduler(sub, self.perf, host=profile)
            self._scheds[key] = s
        return s.schedule(workload, schedule.mode)


class Controller:
    def __init__(self, *, hb_interval: float = 1.0, hb_timeout: float = 3.0,
                 script=(), backend_factory=None, profiles=None,
                 truth_profiles=None, steal: bool = False,
                 host_aware: bool = True, planner=None,
                 steal_margin: float = 0.05, rpc_timeout: float = 30.0,
                 replicate_hot: int = 0, migrate: bool = False):
        self.hb_interval = hb_interval
        self.hb_timeout = hb_timeout
        self.script = tuple(sorted(script, key=lambda e: e.t))
        self._script_i = 0
        self.backend_factory = backend_factory   # for scripted 'join' events
        # heterogeneity + stealing policy (see docs/heterogeneity.md):
        #   profiles    - default HostProfile per worker id (used when
        #                 add_worker is not given one explicitly)
        #   host_aware  - True: place by effective throughput and re-solve
        #                 each cell's DP for its host; False: legacy
        #                 device-count placement with the host's physics
        #                 merely *applied* to the baseline split
        #   steal       - migrate a pending batch to a dry, strictly
        #                 faster worker at submit time
        #   steal_margin- minimum relative period advantage before a steal
        #                 fires (hysteresis against equal-host flapping)
        #   planner     - host-aware re-solver (a HostPlanner); without
        #                 one, host-aware mode degrades to apply_profile
        #   truth_profiles - GROUND TRUTH physics per worker id, injected
        #                 into the WorkerCore and *never* consulted by the
        #                 control plane (learned-fleet experiments: the
        #                 host is slow, the operator declared nothing —
        #                 the OnlineHostEstimator must discover it)
        self.profiles = dict(profiles or {})
        self.truth_profiles = dict(truth_profiles or {})
        self.steal = steal
        self.host_aware = host_aware
        self.planner = planner
        self.steal_margin = steal_margin
        self.rpc_timeout = rpc_timeout     # wall seconds (remote links only)
        # hot-cell replication + live migration (docs/cluster.md):
        #   replicate_hot - keep the forecaster's hottest cells resident on
        #                 up to N distinct workers (0/1 = off); batches
        #                 route to the replica that can start earliest
        #   migrate     - a learned-profile publication moves affected
        #                 cells to a better host with a drain-to-replica ->
        #                 retire handoff instead of epoch-bump invalidation
        #   forecaster  - the ArrivalForecaster driving the hot set (wired
        #                 by LocalCluster.attach from the router's policy);
        #                 a deterministic function of the arrival stream,
        #                 so every replicate/migrate/retire decision is a
        #                 *derived* event and replays byte-identically
        self.replicate_hot = replicate_hot
        self.migrate = migrate
        self.forecaster = None
        # fleet power budget (repro_torch.energy): set by ParetoGovernor.attach
        # when a --power-cap-w is in force. Placement and replica ranking
        # prefer workers with watts headroom under their equal share; the
        # governor enforces the cap itself by downshifting cold cells.
        self.power_budget = None
        # span bus (repro_torch.obs): control-plane telemetry — heartbeats,
        # deploys, steals, worker loss — on "w:<wid>" traces. Spans are
        # derived outputs only (never inputs), so the event log and its
        # replay are byte-identical with tracing on or off.
        self.tracer = NULL_TRACER
        self.links: dict[str, WorkerLink] = {}
        self.listeners: list = []      # on_failure/on_join duck-typed targets
        self.events = ClusterEventLog()
        self.now = 0.0
        self._next_hid = 0
        self._next_sid = 0
        self._pending: dict[int, object] = {}    # sid -> CompletionReport
        self._accepted: dict[int, tuple] = {}    # sid -> simulated finishes
        self._failed: set[int] = set()           # sids lost with their worker
        self._sid_wid: dict[int, str] = {}
        self._sid_finish: dict[int, float] = {}
        self._sid_hid: dict[int, tuple] = {}     # sid -> (hid, batch size)
        self._cells: dict[int, tuple] = {}   # hid -> (schedule, wl, epoch)
        self._adjusted: dict[tuple, object] = {}   # (hid, wid) -> schedule
        # replica bookkeeping: every cell has a replica list (primary
        # first) — length 1 until a replication pass promotes it.
        self._replicas: dict[int, list[str]] = {}      # hid -> [wid, ...]
        self._retiring: set[tuple] = set()             # (hid, wid) draining
        self._replica_busy: dict[tuple, float] = {}    # (hid, wid) -> finish

    # -- registry -------------------------------------------------------------
    def _register(self, wid: str, pool: dict, peer, chan,
                  profile: HostProfile | None, t: float,
                  announce: bool) -> WorkerLink:
        if wid in self.links:
            raise ValueError(f"worker {wid!r} already registered")
        profile = profile or self.profiles.get(wid) or UNIFORM_HOST
        link = WorkerLink(wid, dict(pool), peer, chan, profile=profile,
                          last_hb=t,
                          last_recv_wall=(_time.monotonic()
                                          if peer is None else 0.0))
        self.links[wid] = link
        detail = {"pool": dict(pool)}
        if not profile.is_uniform:
            detail["profile"] = profile.to_dict()
        self.events.append(ClusterEvent(t, "register", wid, detail))
        if self.tracer.enabled:
            self.tracer.instant(f"w:{wid}", "register", t, pool=dict(pool))
        if announce:
            for dev, cnt in sorted(pool.items()):
                for lst in self.listeners:
                    lst.on_join(dev, cnt)
        return link

    def add_worker(self, wid: str, pool: dict,
                   backend: ExecutionBackend | None = None, *,
                   t: float = 0.0, announce: bool = False,
                   profile: HostProfile | None = None) -> WorkerLink:
        """Register an in-process worker peer owning ``pool``. With
        ``announce`` (live scale-out) the pool is delivered to the
        listeners as ``on_join`` events — the initial fleet is registered
        silently because the scheduler's SystemSpec already counts it.
        ``profile`` (default: the controller's ``profiles`` map, else
        uniform) is the host's performance model; the control plane bakes
        it into every schedule sent to this worker — the worker executes
        what it is given verbatim."""
        profile = profile or self.profiles.get(wid) or UNIFORM_HOST
        core = WorkerCore(wid, pool, backend, hb_interval=self.hb_interval,
                          profile=profile,
                          truth_profile=self.truth_profiles.get(wid))
        core.tracer = self.tracer
        ctrl_end, worker_end = inproc_pair()
        return self._register(wid, dict(pool), InProcPeer(core, worker_end),
                              ctrl_end, profile, t, announce)

    def add_remote_worker(self, wid: str, pool: dict, chan, *,
                          t: float = 0.0, announce: bool = False,
                          profile: HostProfile | None = None) -> WorkerLink:
        """Register a *remote* worker — a real process speaking the worker
        protocol over ``chan`` (e.g. ``comms.mp_worker``'s ``MpChannel``).
        The controller cannot pump a remote peer in-process, so it requests
        heartbeats over the wire each ``hb_interval`` and falls back to
        blocking ``recv_wait`` (bounded by ``rpc_timeout`` wall seconds)
        where the in-process path relies on a synchronous pump (submit
        acks, resolve). Timing of a remote worker is wall-clock territory:
        it is protocol-compatible, not simulation-deterministic."""
        return self._register(wid, dict(pool), None, chan, profile, t,
                              announce)

    def alive_workers(self) -> list[WorkerLink]:
        return [l for l in self.links.values() if l.alive]

    def active_workers(self) -> list[WorkerLink]:
        """Alive and not parked — the placement/steal candidate set."""
        return [l for l in self.links.values() if l.alive and not l.parked]

    @property
    def measured_sim_clock(self) -> bool:
        """Sim-clock measurements iff every worker's local backend reports
        them — mixed fleets degrade to wall-clock semantics (telemetry
        only), matching ``ExecutionBackend.measured_sim_clock``. Remote
        workers are trusted to run the default (sim-clock) backend; route
        wall-clock remotes through a ``WallClockCalibrator`` instead."""
        links = self.links.values()
        return all(l.peer.core.backend.measured_sim_clock
                   for l in links if l.peer is not None)

    # -- the control tick (wired into Router.clock_hooks) ---------------------
    def tick(self, now: float) -> float | None:
        """Advance the control plane to simulated time ``now``: apply due
        script events, pump every worker (message delivery + heartbeats),
        and declare lost any worker silent past ``hb_timeout``. Returns
        the next time something is scheduled to happen (earliest possible
        detection deadline) so event-driven callers (Router.drain) can
        jump straight to it."""
        self.now = max(self.now, now)
        while (self._script_i < len(self.script)
               and self.script[self._script_i].t <= now):
            self._apply(self.script[self._script_i], now)
            self._script_i += 1
        self.replicate_hot_cells(now)
        if self._retiring:
            self._retire_pass(now)
        for link in list(self.links.values()):
            if (link.peer is None and link.alive
                    and now - max(link.last_hb, link.hb_ping)
                    >= self.hb_interval):
                # remote peers can't be pumped: ask for a heartbeat
                link.hb_ping = now
                self._send(link, {"op": "hb", "now": now})
            self._pump(link, now)
        for link in list(self.links.values()):
            # tolerance: event-driven callers jump the clock to exactly
            # last_hb + hb_timeout; float subtraction must not stall there
            if link.alive and now - link.last_hb >= self.hb_timeout - 1e-9:
                if (link.peer is None and _time.monotonic()
                        - link.last_recv_wall < self.rpc_timeout):
                    # remote peer: its heartbeat reply needs a wall-clock
                    # round-trip the simulated clock knows nothing about —
                    # a sim-clock jump (event-driven drain) must not
                    # declare a responsive process dead; require genuine
                    # wire silence of rpc_timeout wall seconds as well
                    continue
                self.declare_lost(link.wid, now, via="heartbeat")
        deadlines = [l.last_hb + self.hb_timeout
                     for l in self.links.values() if l.alive]
        if self._script_i < len(self.script):
            deadlines.append(self.script[self._script_i].t)
        return min(deadlines) if deadlines else None

    def _apply(self, ev: ClusterEvent, now: float) -> None:
        # input events are recorded at their *scripted* time (ev.t), not
        # the tick they were applied on — replaying the recorded log must
        # re-apply them on the same tick-grid slot, not one tick later
        if ev.kind == "kill":
            link = self.links[ev.worker]
            if link.peer is not None:
                link.peer.fail()
            else:
                # remote worker: the closest deterministic analog of a
                # crash is cutting the pipe — sends start failing
                # silently and no further replies arrive, so the
                # heartbeat/rpc detectors take over
                link.chan.close()
            self.events.append(ClusterEvent(ev.t, "kill", ev.worker,
                                            dict(ev.detail)))
        elif ev.kind == "join":
            backend = (self.backend_factory()
                       if self.backend_factory is not None else None)
            self.add_worker(ev.worker, dict(ev.detail["pool"]), backend,
                            t=now, announce=True)
            self.events.append(ClusterEvent(ev.t, "join", ev.worker,
                                            dict(ev.detail)))
        elif ev.kind == "latency":
            link = self.links[ev.worker]
            self._send(link, {"op": "latency", "factor": ev.detail["factor"]})
            self.events.append(ClusterEvent(ev.t, "latency", ev.worker,
                                            dict(ev.detail)))
        else:
            raise ValueError(f"not a scriptable event kind: {ev.kind!r}")

    def _send(self, link: WorkerLink, msg: dict) -> None:
        """Send one message, tolerating a hung-up remote peer (its death
        is the failure detector's business, not the sender's)."""
        try:
            link.chan.send(msg)
        except ChannelClosed:
            pass

    def _handle_msg(self, link: WorkerLink, msg: dict) -> None:
        """Apply one worker->controller message to controller state.
        Controller-thread-only, like every method on this class."""
        if link.peer is None:
            link.last_recv_wall = _time.monotonic()
        op = msg["op"]
        if op == "heartbeat":
            link.last_hb = msg["t"]
            link.stats = {k: msg[k] for k in
                          ("busy_until", "done", "stage_s", "inflight")}
            if self.tracer.enabled:
                self.tracer.instant(f"w:{link.wid}", "hb", msg["t"],
                                    **link.stats)
        elif op == "report":
            self._pending[msg["sid"]] = msg["report"]
            link.sids.discard(msg["sid"])
            iv = link.pending_intervals.pop(msg["sid"], None)
            if iv is not None:
                link.intervals.append(iv)   # executed to completion
        elif op == "accepted":
            self._accepted[msg["sid"]] = msg["finishes"]
        elif op == "prepared":
            pass                        # placement already booked the cell
        else:                           # pragma: no cover - protocol guard
            raise ValueError(f"unexpected worker message {op!r}")

    def _pump(self, link: WorkerLink, now: float) -> None:
        if link.peer is not None:
            link.peer.pump(now)        # no-op if the peer crashed
        try:
            while (msg := link.chan.recv()) is not None:
                self._handle_msg(link, msg)
        except ChannelClosed:          # remote process hung up; the
            pass                       # heartbeat timeout will notice

    def _await(self, link: WorkerLink, pred, timeout: float | None = None):
        """Block on a *remote* link (wall clock, bounded) until ``pred()``
        holds, feeding received messages through ``_handle_msg``. The
        in-process transport never needs this — its peer answers within
        the same pump — so callers guard on ``link.peer is None``."""
        deadline = _time.monotonic() + (self.rpc_timeout
                                        if timeout is None else timeout)
        while not pred():
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                return pred()
            try:
                msg = link.chan.recv_wait(remaining)
            except ChannelClosed:
                return pred()
            if msg is not None:
                self._handle_msg(link, msg)
        return True

    # -- failure detection ----------------------------------------------------
    def declare_lost(self, wid: str, now: float, *, via: str) -> None:
        """Flip a worker to lost (idempotent): record the heartbeat-miss,
        fail its in-flight submissions (their futures raise ``WorkerLost``
        at reap — the Router re-queues those batches), and hand its device
        sub-pool to the listeners as per-pool failures."""
        link = self.links[wid]
        if not link.alive:
            return
        link.alive = False
        self.events.append(ClusterEvent(
            now, "heartbeat-miss", wid,
            {"via": via, "last_hb": round(link.last_hb, 9)}))
        if self.tracer.enabled:
            self.tracer.instant(f"w:{wid}", "lost", now, via=via,
                                last_hb=round(link.last_hb, 9),
                                inflight=len(link.sids))
        self._failed.update(link.sids)
        link.sids.clear()
        # lost batches executed only until the worker's last sign of life:
        # clamp their busy intervals so the cross-worker overlap does not
        # count execution that never happened
        for t0, fin in link.pending_intervals.values():
            if link.last_hb > t0:
                link.intervals.append((t0, min(fin, link.last_hb)))
        link.pending_intervals.clear()
        # a dead host hosts no replicas: strip it from every replica set
        # (the survivors keep serving; if it was the primary the next
        # replica in list order inherits that role)
        for hid, reps in self._replicas.items():
            if wid in reps:
                reps.remove(wid)
                self._notify_replicas(hid)
        self._retiring = {(h, w) for h, w in self._retiring if w != wid}
        self._replica_busy = {k: v for k, v in self._replica_busy.items()
                              if k[1] != wid}
        if link.parked:
            # a parked worker's pool already left the listeners' view at
            # park time; converting it again would double-shrink the DP
            return
        for dev, cnt in sorted(link.pool.items()):
            self.events.append(ClusterEvent(now, "failure", wid,
                                            {"dev": dev, "count": cnt}))
            for lst in self.listeners:
                lst.on_failure(dev, cnt)

    # -- learned fleet model (repro_torch.fleet) ------------------------------
    def set_learned_profile(self, wid: str, profile: HostProfile,
                            now: float) -> None:
        """Publish an estimator-learned ``HostProfile`` for worker ``wid``:
        from here on it flows into placement, DP re-solves, and steal
        decisions exactly as a declared profile does. The decision lands
        in the event log as a *derived* ``learned-profile`` event (not an
        input kind): a replayed run re-runs the estimator over the same
        reports and re-derives the identical publication. Listeners get
        ``on_profile`` so the serving Router can invalidate cells planned
        under the stale belief."""
        link = self.links[wid]
        link.profile = profile
        link.learned = True
        self.events.append(ClusterEvent(now, "learned-profile", wid,
                                        {"profile": profile.to_dict()}))
        if self.tracer.enabled:
            self.tracer.instant(f"w:{wid}", "learned", now,
                                **profile.to_dict())
        # every schedule baked under the stale belief is wrong for this
        # worker now; drop them so re-prepares and steals re-bake
        self._adjusted = {k: v for k, v in self._adjusted.items()
                          if k[1] != wid}
        if self.migrate:
            # live migration instead of epoch-bump invalidation: every
            # cell whose primary is the re-profiled worker moves to the
            # best host for it via a drain-to-replica -> retire handoff
            # (the Router sees on_replicas updates, never a cold cell)
            for hid in sorted(self._replicas):
                reps = self._replicas[hid]
                if not reps or reps[0] != wid or hid not in self._cells:
                    continue
                dest = self._best_host(hid, exclude=(wid,))
                if dest is not None:
                    base = self._cells[hid][0]
                    if (dest.profile.effective_period(base.pipeline)
                            < link.profile.effective_period(base.pipeline)
                            * (1.0 - self.steal_margin)):
                        self.migrate_cell(hid, dest.wid, now,
                                          reason="learned-profile")
        for lst in self.listeners:
            hook = getattr(lst, "on_profile", None)
            if hook is not None:
                hook(wid, profile)

    def set_parked(self, wid: str, parked: bool, now: float, *,
                   reason: str = "") -> bool:
        """Autoscaler elastic path: park (drain) or unpark one worker.
        Parking removes the worker from placement/steal candidacy and
        hands its device pool to the listeners as failures (the DP shrinks
        and reschedules — same path as a lost worker, minus the lost
        batches); unparking is the mirror-image join. The worker itself
        stays alive and heartbeating, so unparking is instant. Emitted as
        a derived ``autoscale`` event — replays re-derive it. Returns
        False when already in the requested state (or dead)."""
        link = self.links[wid]
        if not link.alive or link.parked == parked:
            return False
        link.parked = parked
        detail = {"action": "park" if parked else "unpark"}
        if reason:
            detail["reason"] = reason
        self.events.append(ClusterEvent(now, "autoscale", wid, detail))
        if self.tracer.enabled:
            self.tracer.instant(f"w:{wid}", "autoscale", now, **detail)
        for dev, cnt in sorted(link.pool.items()):
            for lst in self.listeners:
                (lst.on_failure if parked else lst.on_join)(dev, cnt)
        return True

    def steal_wait_bound(self, wid: str, hid: int, now: float,
                         est: float) -> float:
        """Steal-aware admission bound (pre-work for hot-cell replicas):
        ``Engine.est_wait`` assumes the owning worker executes the next
        batch, but with stealing enabled a dry, strictly faster peer would
        take it at submit time — the queue wait behind the owner's busy
        clock collapses. Uses the same ``_steal_target`` predicate (and
        therefore the *learned* host scales once published), so admission
        stops over-rejecting behind a discovered-slow owner."""
        if not self.steal or est <= 0.0:
            return est
        link = self.links.get(wid)
        if link is None or not link.alive or hid not in self._cells:
            return est
        if self._steal_target(link, hid, now) is not None:
            return 0.0
        return est

    # -- execution plane (called by ClusterBackend) ---------------------------
    def place(self, schedule) -> str:
        """Pick the worker to own a new cell: prefer workers whose own
        sub-pool covers the schedule's device counts, then pick by
        *effective throughput* — least weighted load first, where a
        worker's weight per cell is its host-effective pipeline period
        (``HostProfile.effective_period``; a 2x-slow host counts double).
        On a homogeneous fleet this reduces exactly to the deterministic
        least-assigned round-robin (cells spread across workers, which is
        where the cross-worker overlap comes from); with ``host_aware``
        off, the legacy device-count round-robin is used regardless of
        profiles. Falls back to any alive worker when no sub-pool fits
        (the schedule was solved on the global pool; timing is
        model-driven either way). Parked (autoscaler-drained) workers are
        excluded while any unparked worker is alive."""
        alive = self.active_workers() or self.alive_workers()
        if not alive:
            raise WorkerLost("no alive workers to place on")
        need = schedule.pipeline.devices_used()
        fits = [l for l in alive
                if all(l.pool.get(d, 0) >= c for d, c in need.items())]
        # power-budget headroom (repro_torch.energy): workers already drawing
        # past their equal share of the fleet cap sort last — a new cell
        # lands where there are watts to spare. Deterministic: the budget
        # state is the governor's last published (derived) tick.
        if self.power_budget is not None:
            hot = lambda l: (self.power_budget.worker_headroom(  # noqa: E731
                self.now, l.wid) < 0.0,)
        else:
            hot = lambda l: ()                                  # noqa: E731
        if self.host_aware:
            key = lambda l: (hot(l)                             # noqa: E731
                             + ((l.assignments + 1)
                                * l.profile.effective_period(
                                    schedule.pipeline),
                                l.wid))
        else:
            key = lambda l: hot(l) + (l.assignments, l.wid)     # noqa: E731
        link = min(fits or alive, key=key)
        link.assignments += 1
        return link.wid

    def _host_schedule(self, link: WorkerLink, schedule, workload):
        """The physical schedule worker ``link`` will run for this cell.
        Uniform host: the baseline schedule, untouched (bit-identical
        homogeneous behavior). Non-uniform host: with ``host_aware`` and a
        planner, the DP re-solves under the host's scaled perf/comm models
        (possibly a different stage split); otherwise the baseline split
        with the host's physics applied (``apply_profile``) — in both
        cases the returned stage times are that host's truth, which is
        what its reports, the Engine's busy clocks, and the straggler
        baselines all see."""
        prof = link.profile
        if prof.is_uniform:
            return schedule
        if self.host_aware and self.planner is not None:
            return self.planner(schedule, workload, prof)
        return apply_profile(schedule, prof)

    def prepare(self, schedule, workload, epoch: int) -> tuple:
        """Place a new cell and deploy it on the chosen worker; returns
        ``(wid, hid, deployed_schedule)`` where the deployed schedule is
        the host-adjusted one the worker will actually time against."""
        w0 = _time.perf_counter()
        wid = self.place(schedule)
        hid = self._next_hid
        self._next_hid += 1
        link = self.links[wid]
        # an epoch bump invalidates every engine cell, so cells prepared
        # under older epochs can never be submitted to again — prune
        # their steal bookkeeping (within-epoch LRU churn is retained;
        # a cell-release message is not part of the protocol yet)
        stale = [h for h, (_s, _w, ep) in self._cells.items()
                 if ep < epoch]
        if stale:
            for h in stale:
                del self._cells[h]
                self._replicas.pop(h, None)
            self._adjusted = {k: v for k, v in self._adjusted.items()
                              if k[0] in self._cells}
            self._retiring = {k for k in self._retiring
                              if k[0] in self._cells}
            self._replica_busy = {k: v for k, v in self._replica_busy.items()
                                  if k[0] in self._cells}
        self._cells[hid] = (schedule, workload, epoch)
        self._replicas[hid] = [wid]
        adj = self._host_schedule(link, schedule, workload)
        self._adjusted[(hid, wid)] = adj
        # the prepare message carries the controller's *belief* profile so
        # a truth-injected worker can rescale belief -> truth physics
        self._send(link, {"op": "prepare", "hid": hid, "schedule": adj,
                          "workload": workload, "epoch": epoch,
                          "profile": link.profile})
        self._pump(link, self.now)
        if self.tracer.enabled:
            self.tracer.instant(
                f"w:{wid}", "deploy", self.now, hid=hid,
                mnemonic=adj.mnemonic, epoch=epoch,
                wall_ms=round(1e3 * (_time.perf_counter() - w0), 6))
        return wid, hid, adj

    # -- work stealing ---------------------------------------------------------
    def _steal_target(self, owner: WorkerLink, hid: int,
                      t0: float) -> WorkerLink | None:
        """A dry, strictly faster worker to run this pending batch, or
        None. ``dry`` = the controller's busy estimate says the worker has
        nothing running at ``t0`` (simulated seconds); ``strictly
        faster`` = its host-effective period for this cell's baseline
        pipeline beats the owner's by at least ``steal_margin`` — equal
        hosts never steal (no flapping), and a batch is never migrated
        *to* a slower host. Deterministic: inputs are the controller's
        own bookkeeping, so a replayed run steals identically."""
        base, _wl, _ep = self._cells[hid]
        need = base.pipeline.devices_used()
        owner_p = owner.profile.effective_period(base.pipeline)
        best, best_p = None, None
        for wid in sorted(self.links):
            l = self.links[wid]
            if l is owner or not l.alive or l.parked:
                continue
            if (hid, wid) in self._retiring:
                continue               # draining to retire: no new work
            if l.busy_est > t0 + 1e-9:
                continue               # not dry: it has its own work
            if not all(l.pool.get(d, 0) >= c for d, c in need.items()):
                continue
            p = l.profile.effective_period(base.pipeline)
            if p >= owner_p * (1.0 - self.steal_margin):
                continue               # not meaningfully faster
            if best is None or p < best_p:
                best, best_p = l, p
        return best

    def _replica_schedule(self, link: WorkerLink, hid: int):
        """The schedule ``link`` would run for a replica of cell ``hid``,
        or None when it cannot host one. A sub-pool that covers the
        baseline's device budget gets the normal host-adjusted schedule;
        a *smaller* sub-pool gets a DP re-solve clamped to what the host
        actually has (``HostPlanner(pool_cap=...)``) — slower than the
        primary's split, but real added capacity. Deterministic: a pure
        function of controller state."""
        base, workload, _ep = self._cells[hid]
        need = base.pipeline.devices_used()
        if all(link.pool.get(d, 0) >= c for d, c in need.items()):
            return self._host_schedule(link, base, workload)
        if self.planner is None:
            return None
        try:
            return self.planner(base, workload, link.profile,
                                pool_cap=link.pool)
        except RuntimeError:
            return None                # infeasible on the clamped pool

    def _deploy_cell(self, link: WorkerLink, hid: int) -> None:
        """Prepare cell ``hid`` on ``link`` (idempotent per host): solve
        the host-adjusted schedule, cache it in ``_adjusted``, and send a
        normal ``prepare``. Stealing, replication, and migration all
        deploy through here."""
        if (hid, link.wid) in self._adjusted:
            return
        base, workload, epoch = self._cells[hid]
        adj = self._replica_schedule(link, hid)
        if adj is None:
            adj = self._host_schedule(link, base, workload)
        self._adjusted[(hid, link.wid)] = adj
        self._send(link, {"op": "prepare", "hid": hid, "schedule": adj,
                          "workload": workload, "epoch": epoch,
                          "profile": link.profile})
        self._pump(link, self.now)

    def _migrate(self, hid: int, owner: WorkerLink, thief: WorkerLink,
                 t0: float, n: int) -> None:
        """Deploy cell ``hid`` on ``thief`` (once; re-steals reuse the
        prepared handle) and record the steal decision. The event is
        *derived* — not an input kind — so a replayed run re-derives the
        identical steal sequence from the same controller state."""
        self._deploy_cell(thief, hid)
        self.events.append(ClusterEvent(t0, "steal", thief.wid,
                                        {"from": owner.wid, "hid": hid,
                                         "n": n}))
        if self.tracer.enabled:
            self.tracer.instant(f"w:{thief.wid}", "steal", t0,
                                frm=owner.wid, hid=hid, n=n)
        for lst in self.listeners:
            hook = getattr(lst, "on_steal", None)
            if hook is not None:
                hook(owner.wid, thief.wid, n)

    # -- hot-cell replication + live migration ---------------------------------
    def replica_hosts(self, hid: int) -> tuple:
        """Worker ids currently *serving* cell ``hid`` (primary first):
        retiring, parked, and dead hosts are excluded — what replica-aware
        dispatch, admission bounds, and the Engine's per-replica clocks
        may route to."""
        out = []
        for w in self._replicas.get(hid, ()):
            if (hid, w) in self._retiring:
                continue
            l = self.links.get(w)
            if l is None or not l.alive or l.parked:
                continue
            out.append(w)
        return tuple(out)

    def _notify_replicas(self, hid: int) -> None:
        hosts = self.replica_hosts(hid)
        for lst in self.listeners:
            hook = getattr(lst, "on_replicas", None)
            if hook is not None:
                hook(hid, hosts)

    def _best_host(self, hid: int, exclude=()) -> WorkerLink | None:
        """The fastest active worker that could host a replica of cell
        ``hid``: a sub-pool that covers the baseline's device budget runs
        the host-adjusted schedule, a smaller one a pool-clamped DP
        re-solve (``_replica_schedule``) — ranked by the host-effective
        period of the schedule it would *actually* run, ties by wid.
        Deterministic over controller state only."""
        best, best_key = None, None
        for wid in sorted(self.links):
            if wid in exclude:
                continue
            l = self.links[wid]
            if not l.alive or l.parked or (hid, wid) in self._retiring:
                continue
            sched = self._replica_schedule(l, hid)
            if sched is None:
                continue
            over = (self.power_budget is not None
                    and self.power_budget.worker_headroom(self.now, wid)
                    < 0.0)
            key = (over, l.profile.effective_period(sched.pipeline), wid)
            if best is None or key < best_key:
                best, best_key = l, key
        return best

    def replicate_hot_cells(self, now: float) -> None:
        """Promote the forecaster's hottest cells to ``replicate_hot``
        replicas on distinct workers; drain replicas of cells that left
        the hot set. Runs inside ``tick`` (and from the autoscaler right
        after a pre-warm, so a freshly admitted hot cell replicates ahead
        of the peak) — every decision is a pure function of controller +
        forecaster state (both deterministic replays of the arrival/event
        streams), so ``replicate`` events are derived and re-derive
        identically."""
        f = self.forecaster
        if (self.replicate_hot < 2 or f is None
                or not getattr(f, "warmed_up", False)):
            return
        wanted = {s for s, _wl in f.hot_signatures(1)}
        hot = {hid for hid, (_s, wl, _e) in self._cells.items()
               if signature(wl) in wanted}
        for hid in sorted(hot):
            reps = self._replicas.get(hid)
            if reps is None:
                continue
            for w in reps:
                # hot again while draining: reinstate instead of paying a
                # retire + re-prepare round trip
                if (hid, w) in self._retiring:
                    self._retiring.discard((hid, w))
                    self._notify_replicas(hid)
            while len(reps) < self.replicate_hot:
                dest = self._best_host(hid, exclude=reps)
                if dest is None:
                    break
                self._deploy_cell(dest, hid)
                reps.append(dest.wid)
                self.events.append(ClusterEvent(now, "replicate", dest.wid,
                                                {"hid": hid,
                                                 "n": len(reps)}))
                if self.tracer.enabled:
                    self.tracer.instant(f"w:{dest.wid}", "replicate", now,
                                        hid=hid, n=len(reps))
                self._notify_replicas(hid)
        for hid, reps in self._replicas.items():
            if hid in hot or len(reps) < 2:
                continue
            for w in reps[1:]:
                if (hid, w) not in self._retiring:
                    self._retiring.add((hid, w))
                    self._notify_replicas(hid)

    def _retire_pass(self, now: float) -> None:
        """Dismiss drained replicas: a retiring (hid, wid) whose
        per-replica clock has passed has no in-flight work left — its
        held reports were all due by now — so the worker can free the
        handle. New work stopped routing there the moment it entered
        ``_retiring`` (see ``replica_hosts``/``_steal_target``), which is
        what makes the handoff zero-drop."""
        for hid, w in sorted(self._retiring):
            if self._replica_busy.get((hid, w), 0.0) > now + 1e-9:
                continue               # still draining in-flight batches
            link = self.links.get(w)
            if link is not None and link.alive:
                self._send(link, {"op": "retire", "hid": hid})
                self._pump(link, now)
            self._retiring.discard((hid, w))
            reps = self._replicas.get(hid)
            if reps is not None and w in reps:
                reps.remove(w)
            self._adjusted.pop((hid, w), None)
            self._replica_busy.pop((hid, w), None)
            self.events.append(ClusterEvent(now, "retire", w, {"hid": hid}))
            if self.tracer.enabled:
                self.tracer.instant(f"w:{w}", "retire", now, hid=hid)
            self._notify_replicas(hid)

    def migrate_cell(self, hid: int, to_wid: str, now: float, *,
                     reason: str = "") -> None:
        """Live migration: deploy cell ``hid`` on ``to_wid``, make it the
        primary, and drain every other host of the cell to retirement.
        New batches route to the new primary immediately (replica-aware
        dispatch); batches in flight on the old hosts finish and report
        normally — the handoff drops nothing, unlike an epoch bump which
        would invalidate the resident cell. Derived ``migrate`` event."""
        link = self.links[to_wid]
        self._deploy_cell(link, hid)
        reps = self._replicas.setdefault(hid, [])
        old = [w for w in reps if w != to_wid]
        self._replicas[hid] = [to_wid] + old
        for w in old:
            self._retiring.add((hid, w))
        frm = old[0] if old else ""
        self.events.append(ClusterEvent(now, "migrate", to_wid,
                                        {"from": frm, "hid": hid,
                                         "reason": reason}))
        if self.tracer.enabled:
            self.tracer.instant(f"w:{to_wid}", "migrate", now, frm=frm,
                                hid=hid, reason=reason)
        self._notify_replicas(hid)

    def _route_replica(self, wid: str, hid: int, t0: float) -> str:
        """Replica-aware dispatch: among the cell's serving replicas,
        pick the one that can start this batch earliest (its per-replica
        clock), ties broken by host speed then wid. Falls back to the
        caller's target when the cell is unreplicated or nothing else
        serves."""
        reps = self.replica_hosts(hid)
        if not reps or (len(reps) == 1 and reps[0] == wid):
            return wid
        base = self._cells[hid][0]
        best, best_key = wid, None
        for w in reps:
            l = self.links[w]
            key = (max(self._replica_busy.get((hid, w), 0.0), t0),
                   l.profile.effective_period(base.pipeline), w)
            if best_key is None or key < best_key:
                best, best_key = w, key
        return best

    def worker_of(self, sid: int) -> str | None:
        """The worker an unresolved submission was routed to — the
        *executing* host (replica routing and stealing both already
        applied). The ClusterBackend stamps it onto the future so the
        Engine can advance the right per-replica clock."""
        return self._sid_wid.get(sid)

    def submit(self, wid: str, hid: int, schedule, n: int,
               t0: float) -> tuple[int, tuple]:
        """Route one batch to its owning worker; returns ``(sid,
        simulated finishes)``. With ``steal`` enabled, a pending batch
        bound for a slower host migrates to a dry, strictly faster peer
        first (see ``_steal_target``) — the steal is per-batch, so the
        cell's *placement* is untouched and re-evaluates at the next
        epoch bump. A live worker acknowledges immediately (``accepted``
        carries the simulated finishes the Engine's busy clocks need) but
        *holds the report* until the simulated clock passes the batch's
        finish — unfinished work dies with a crashed worker. A silent
        worker gets analytic placeholder finishes (from the worker's own
        host-adjusted schedule): its batch is doomed to the
        ``WorkerLost`` -> re-queue path anyway, the placeholder only
        keeps the cell's busy clock advancing deterministically."""
        reps = self._replicas.get(hid, ())
        if hid in self._cells and reps and (len(reps) > 1
                                            or wid not in reps):
            # >1 replicas: pick the earliest per-replica clock. A stale
            # handle whose worker no longer serves the cell (retired
            # after a migration, or declared lost) re-routes to whoever
            # does — never to a freed handle or a dead host.
            wid = self._route_replica(wid, hid, t0)
        link = self.links[wid]
        if self.steal and link.alive and hid in self._cells:
            thief = self._steal_target(link, hid, t0)
            if thief is not None:
                self._migrate(hid, link, thief, t0, n)
                link, wid = thief, thief.wid
        sid = self._next_sid
        self._next_sid += 1
        self._sid_wid[sid] = wid
        self._sid_hid[sid] = (hid, n)
        sched = self._adjusted.get((hid, wid), schedule)
        if not link.alive:
            # already declared lost (a stale cell routed here): fail the
            # submission immediately — declare_lost has already run, so
            # nothing else will, and an un-failed sid would strand its
            # batch in the Engine's inflight forever
            self._failed.add(sid)
            finishes = _analytic_report(sched, n, t0).finishes
            self._sid_finish[sid] = max(finishes) if finishes else t0
            return sid, finishes
        link.sids.add(sid)
        self._send(link, {"op": "submit", "hid": hid, "sid": sid, "n": n,
                          "t0": t0})
        self._pump(link, self.now)
        if link.peer is None and sid not in self._accepted:
            self._await(link, lambda: sid in self._accepted)
        acked = self._accepted.pop(sid, None)
        finishes = acked or _analytic_report(sched, n, t0).finishes
        finish = max(finishes) if finishes else t0
        self._sid_finish[sid] = finish
        if acked is not None:
            # unacknowledged batches (worker already dead) never execute —
            # they must not count as busy time in the overlap telemetry;
            # acknowledged ones count as busy only once their report
            # arrives (or, lost mid-flight, up to the last heartbeat)
            link.pending_intervals[sid] = (t0, finish)
            link.busy_est = max(link.busy_est, finish)
            if hid in self._replicas:
                # per-replica drain clock: retire waits for this
                self._replica_busy[(hid, wid)] = max(
                    self._replica_busy.get((hid, wid), 0.0), finish)
        return sid, finishes

    def ready(self, sid: int, at: float | None = None) -> bool:
        """Can ``resolve(sid)`` deliver without waiting on an unresponsive
        worker? (Report arrived, or the worker was declared lost.)
        ``at`` is the batch's simulated finish: the reap loop only asks
        once the clock has passed it, so the owner may be pumped up to
        that time — which releases the held report even when no clock
        hook drives the controller (an unattached ClusterBackend)."""
        if sid in self._pending or sid in self._failed:
            return True
        if at is not None:
            link = self.links.get(self._sid_wid.get(sid))
            if link is not None and link.alive:
                self._pump(link, max(self.now, at))
        return sid in self._pending or sid in self._failed

    def resolve(self, sid: int):
        """Deliver the report for one submission, or raise ``WorkerLost``.
        The blocking path pumps the owner up to the batch's simulated
        finish (releasing its held report); an answer still missing then
        means the peer died between heartbeats — an RPC timeout is as
        good a failure detector as a missed heartbeat (dask does the
        same), so the worker is declared lost on the spot."""
        if sid in self._failed:
            self._failed.discard(sid)
            wid = self._sid_wid.get(sid)
            self._done(sid)
            raise WorkerLost(f"submission {sid} lost with worker {wid}")
        rep = self._pending.pop(sid, None)
        if rep is not None:
            self._done(sid)
            return rep
        wid = self._sid_wid.get(sid)
        link = self.links.get(wid)
        if link is not None and link.alive:
            self._pump(link, max(self.now, self._sid_finish.get(sid, 0.0)))
            if link.peer is None and sid not in self._pending:
                # remote peer: its report travels a real pipe — block up
                # to rpc_timeout wall seconds before declaring it dead
                self._await(link, lambda: sid in self._pending)
            rep = self._pending.pop(sid, None)
            if rep is not None:
                self._done(sid)
                return rep
            self.declare_lost(wid, self.now, via="rpc")
        self._failed.discard(sid)
        self._done(sid)
        raise WorkerLost(f"submission {sid} lost with worker {wid}")

    def cancel(self, sid: int, now: float) -> bool:
        """Preemption support (tenancy): withdraw an accepted-but-
        unfinished submission from its worker. Returns False when it is
        too late to cancel — the report was already delivered (the batch
        finished) or the submission died with its worker (the
        ``WorkerLost`` -> re-queue path owns those requests; cancelling
        too would double-deliver them).

        On success the worker rolls back the batch's counters (the
        ``cancel`` op), the controller's busy estimates and per-replica
        drain clocks recompute from the *remaining* in-flight work, the
        partial execution [t0, now) is kept in the busy intervals, and a
        derived ``preempt`` event is recorded — controller bookkeeping is
        deterministic, so replays re-derive the identical cancellation."""
        wid = self._sid_wid.get(sid)
        link = self.links.get(wid) if wid is not None else None
        if link is None:
            return False
        if link.alive:
            # release anything already due — a report whose simulated
            # finish has passed must win over a late preemption
            self._pump(link, now)
        if sid in self._pending or sid in self._failed:
            return False
        hid, n = self._sid_hid.get(sid, (None, 0))
        if link.alive:
            self._send(link, {"op": "cancel", "sid": sid, "now": now})
            self._pump(link, now)
        link.sids.discard(sid)
        iv = link.pending_intervals.pop(sid, None)
        if iv is not None and now > iv[0]:
            link.intervals.append((iv[0], min(iv[1], now)))
        link.busy_est = max(
            (f for _t0, f in link.pending_intervals.values()),
            default=min(link.busy_est, now))
        if hid is not None and (hid, wid) in self._replica_busy:
            rem = [self._sid_finish.get(s, 0.0)
                   for s, (h, _n) in self._sid_hid.items()
                   if s != sid and h == hid and self._sid_wid.get(s) == wid
                   and s not in self._pending and s not in self._failed]
            rb = max(rem, default=0.0)
            if rb > now + 1e-9:
                self._replica_busy[(hid, wid)] = rb
            else:
                self._replica_busy.pop((hid, wid), None)
        self.events.append(ClusterEvent(now, "preempt", wid,
                                        {"hid": hid, "n": n}))
        if self.tracer.enabled:
            self.tracer.instant(f"w:{wid}", "preempt", now, hid=hid, n=n)
        self._done(sid)
        return True

    def _done(self, sid: int) -> None:
        self._sid_wid.pop(sid, None)
        self._sid_finish.pop(sid, None)
        self._sid_hid.pop(sid, None)

    # -- telemetry ------------------------------------------------------------
    def cross_worker_overlap(self) -> float:
        """Sum of per-worker busy coverage over the union coverage of all
        workers: 1.0 = at most one worker executing at any simulated
        instant, > 1.0 = genuinely concurrent cross-host execution.
        Within-worker cell concurrency is collapsed first (per-worker
        union), so this isolates the *cluster* win from the Engine's
        single-host overlap. In-flight batches on live workers count
        (they will complete); lost ones were clamped at declare_lost."""
        def ivs(link):
            return list(link.intervals) + list(
                link.pending_intervals.values())
        per_worker = sum(union_coverage(ivs(l))
                         for l in self.links.values())
        total = union_coverage([iv for l in self.links.values()
                                for iv in ivs(l)])
        return per_worker / total if total > 0 else 0.0

    def describe(self) -> list[str]:
        out = []
        for wid, l in sorted(self.links.items()):
            state = "alive" if l.alive else "LOST"
            if l.alive and l.parked:
                state = "parked"
            prof = ("" if l.profile.is_uniform
                    else f" profile={l.profile.name}"
                    + (" (learned)" if l.learned else ""))
            out.append(f"{wid} [{state}] pool={l.pool}{prof} "
                       f"cells={l.assignments} stats={l.stats}")
        return out


def split_pool(system, n_workers: int) -> list[dict]:
    """Partition a SystemSpec's device pools across ``n_workers`` hosts,
    round-robin per device so counts stay within one of each other (the
    paper system over 2 workers: {FPGA:2, GPU:1} + {FPGA:1, GPU:1})."""
    assert n_workers >= 1
    pools: list[dict] = [{} for _ in range(n_workers)]
    for dev, cnt in system.pools:
        for i in range(cnt):
            w = pools[i % n_workers]
            w[dev.name] = w.get(dev.name, 0) + 1
    return [p for p in pools if p]     # drop empty when workers > devices


class LocalCluster:
    """Convenience builder: N in-process workers splitting ``system``'s
    device pool, a controller watching them, and a ``ClusterBackend``
    facade for the Engine. ``backend`` names the per-worker local
    ExecutionBackend (string for ``make_backend``, a zero-arg factory, or
    a shared instance); ``script`` is a sequence of input ClusterEvents
    (kill/join/latency) — e.g. the replay of a recorded event log.

    Heterogeneity knobs (all default to the homogeneous behavior):

      * ``profiles`` — per-worker ``HostProfile``s, as a dict keyed by
        worker id (``"w0"``...). Values may be profiles or bare floats (a
        float ``f`` is shorthand for ``HostProfile(compute_scale=f)``).
      * ``truth_profiles`` — same shape, but injected as GROUND TRUTH
        physics into the worker cores while the control plane's belief
        stays at ``profiles`` (default uniform). The learned-fleet
        experiments: a 60x host exists physically, nothing declared it —
        ``repro_torch.fleet.OnlineHostEstimator`` has to discover it.
      * ``host_aware`` — place cells by effective throughput and re-solve
        each cell's DP for its owning host (False: legacy device-count
        placement; the slow host still *runs* slow — its physics are
        applied to the baseline split — it is merely planned around as if
        it were healthy. That is the host-oblivious baseline the
        benchmarks compare against).
      * ``steal`` — controller-side work stealing at submit time.
      * ``perf`` — the fitted ``PerfModel`` to re-solve with (share the
        serving stack's instance; fitting is the expensive part).
      * ``replicate_hot`` — keep the forecaster's hottest cell resident
        on up to N distinct workers; batches route to the replica that
        can start earliest (0/1 = off; needs a router whose policy has
        an ``ArrivalForecaster``).
      * ``migrate`` — learned-profile publications move affected cells
        live (drain-to-replica -> retire) instead of invalidating them.
    """

    def __init__(self, system, n_workers: int = 2, *,
                 backend="analytic", backend_kw: dict | None = None,
                 hb_interval: float = 1.0, hb_timeout: float = 3.0,
                 script=(), profiles=None, truth_profiles=None,
                 steal: bool = False, host_aware: bool = True, perf=None,
                 replicate_hot: int = 0, migrate: bool = False):
        if isinstance(backend, str):
            name, kw = backend, dict(backend_kw or {})
            factory = lambda: make_backend(name, **kw)   # noqa: E731
        elif callable(backend):
            factory = backend
        else:
            factory = lambda: backend                    # noqa: E731

        def as_profiles(d, tag=""):
            return {wid: (p if isinstance(p, HostProfile)
                          else HostProfile(f"{wid}{tag}-x{p:g}",
                                           compute_scale=float(p)))
                    for wid, p in (d or {}).items()}
        self.controller = Controller(
            hb_interval=hb_interval, hb_timeout=hb_timeout, script=script,
            backend_factory=factory, profiles=as_profiles(profiles),
            truth_profiles=as_profiles(truth_profiles, "-true"),
            steal=steal, host_aware=host_aware,
            planner=HostPlanner(system, perf) if host_aware else None,
            replicate_hot=replicate_hot, migrate=migrate)
        for i, pool in enumerate(split_pool(system, n_workers)):
            self.controller.add_worker(f"w{i}", pool, factory())

    def backend(self):
        from ..runtime.backend import ClusterBackend
        return ClusterBackend(self.controller)

    def attach(self, router):
        """Wire the cluster into a serving Router: the controller ticks
        with the router's control cycle, and worker loss/join feeds the
        router's elastic hooks. A traced router's span bus propagates to
        the controller and every in-process worker core, so one sink
        sees the whole story (request spans + control-plane spans)."""
        router.clock_hooks.append(self.controller.tick)
        self.controller.listeners.append(router)
        if self.controller.forecaster is None:
            # hot-cell replication reads the policy's ArrivalForecaster —
            # the single deterministic arrival feed — when one is wired
            self.controller.forecaster = getattr(router.policy,
                                                 "forecaster", None)
        if router.tracer.enabled and not self.controller.tracer.enabled:
            self.controller.tracer = router.tracer
            for link in self.controller.links.values():
                if link.peer is not None:
                    link.peer.core.tracer = router.tracer
        return router

    @property
    def events(self) -> ClusterEventLog:
        return self.controller.events

    def cross_worker_overlap(self) -> float:
        return self.controller.cross_worker_overlap()
