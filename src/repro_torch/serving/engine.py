"""Engine: multi-pipeline concurrency over one device pool.

The Router used to serialize every batch behind a single ``busy_until`` —
one pipeline at a time, even when two signature cells' schedules fit on
disjoint device subsets. The Engine partitions the pool instead: each hot
signature cell gets its own *resident* ``PipelineHandle`` prepared by the
``ExecutionBackend``, scheduled by the DP on a sub-pool carved out of the
free devices, with per-cell busy clocks so cells serve concurrently.

Residency policy:
  * a cell is keyed by (workload signature, objective mode); at most
    ``max_cells`` are resident;
  * admission schedules on the free sub-pool, capped at a fair share
    (ceil(count / max_cells)) so one hot cell cannot starve the others;
  * capacity accounting mirrors ``runtime.elastic.PoolState``: allocated =
    the devices the cell's schedule actually uses, freed on eviction;
  * eviction is LRU among idle cells; when nothing is idle the youngest-
    to-free cell is evicted at its drain time (the dispatch waits for it);
  * any resize / objective flip bumps the DynamicScheduler epoch, which
    lazily invalidates every resident handle (drift lands in a different
    cell key by construction).

Each cell owns a StragglerMonitor baselined on its schedule's stage times,
so measured stage times feed back per pipeline, not per router.

Async dispatch: ``submit`` hands a batch to the backend without
blocking (``ExecutionBackend.submit`` -> ``BackendFuture``) and tracks it
in ``inflight``; the control loop keeps admitting and batching while the
substrate executes, then ``reap`` resolves completions in simulated-
timestamp order. At most one batch is in flight per resident cell — the
cell's busy clock advances at submit time (simulated finishes are known
immediately), so ``ready`` filters a busy cell's next batch until the loop
has reaped it. ``dispatch`` is the synchronous adapter (submit + reap one).

Threading model: the Engine is single-threaded host control logic — all
concurrency is either simulated (per-cell busy clocks on the shared
simulated clock, in seconds) or delegated to the backend's device-async
dispatch. No locks, no cross-thread state.
"""
from __future__ import annotations

import dataclasses
import math

from ..core.dynamic import DynamicScheduler, signature
from ..obs.trace import NULL_TRACER
from ..runtime.backend import (AnalyticBackend, BackendFuture,
                               CompletionReport, ExecutionBackend,
                               PipelineHandle, WorkerLost)
from ..runtime.straggler import ProbationTracker, StragglerMonitor


@dataclasses.dataclass
class Cell:
    """One resident signature cell: a deployed pipeline on a device subset.
    The handle carries the scheduler epoch it was prepared under
    (``handle.stale(...)`` is the invalidation check).

    Busy time is kept per *replica*: ``clocks`` maps replica id (a cluster
    worker id, or the ``None`` sentinel while unreplicated) to that
    replica's busy clock. A single-clock cell behaves exactly like the
    legacy scalar ``busy_until``; a replicated cell (the controller's
    ``on_replicas`` notifications re-key the dict via ``set_replicas``)
    admits one batch in flight *per replica* — which is the whole
    throughput win of hot-cell replication."""
    cid: int
    key: tuple                     # (workload signature, mode)
    handle: PipelineHandle
    devices: dict                  # dev name -> count allocated
    monitor: StragglerMonitor
    clocks: dict = dataclasses.field(
        default_factory=lambda: {None: 0.0})   # replica id -> busy clock
    drain_floor: float = 0.0       # dropped replicas still draining
    last_used: float = 0.0
    dispatches: int = 0

    @property
    def schedule(self):
        return self.handle.schedule

    @property
    def epoch(self) -> int:
        return self.handle.epoch

    @property
    def busy_until(self) -> float:
        """Earliest time a new batch could start: the least-loaded
        replica's clock (the one clock, while unreplicated)."""
        return min(self.clocks.values())

    @busy_until.setter
    def busy_until(self, value: float) -> None:
        # scalar-compat: writing the legacy attribute sets every replica
        for k in self.clocks:
            self.clocks[k] = value

    @property
    def drain_until(self) -> float:
        """When the cell's devices are fully quiet: every replica's clock
        has passed, including replicas dropped while mid-batch."""
        return max(max(self.clocks.values()), self.drain_floor)

    def advance(self, rep, finish: float):
        """Charge a dispatched batch's finish to replica ``rep``. An
        unknown id (unreplicated cell, or a stolen batch executing on a
        non-replica peer) charges the least-loaded replica — exactly the
        legacy single-clock behavior when only one clock exists. Returns
        the replica key actually charged, so preemption can later roll
        exactly that clock back."""
        if rep not in self.clocks:
            rep = min(self.clocks, key=lambda k: (self.clocks[k], str(k)))
        self.clocks[rep] = max(self.clocks[rep], finish)
        return rep

    def set_replicas(self, reps) -> None:
        """Re-key the busy clocks to the serving replica set (primary
        first). The first replica inherits the unreplicated clock; a
        replica leaving the set keeps its in-flight work visible through
        ``drain_floor`` until it drains. An empty set (nothing serving —
        e.g. mid-failure) is ignored; the failure path invalidates."""
        reps = list(reps)
        if not reps:
            return
        old = dict(self.clocks)
        if None in old:
            old[reps[0]] = max(old.get(reps[0], 0.0), old.pop(None))
        new = {r: old.pop(r, 0.0) for r in reps}
        if old:
            self.drain_floor = max(self.drain_floor, max(old.values()))
        self.clocks = new


@dataclasses.dataclass
class InFlight:
    """One submitted-but-unreaped batch. ``seq`` is the submission index —
    the reap order is (simulated finish, seq), which makes completion
    delivery deterministic even when two batches finish at the same
    simulated instant."""
    seq: int
    cell: Cell
    batch: object
    future: BackendFuture
    rep: object = None             # replica key charged at submit time

    @property
    def t0(self) -> float:
        return self.future.t0

    @property
    def finish(self) -> float:
        return self.future.finish


class Engine:
    def __init__(self, dyn: DynamicScheduler,
                 backend: ExecutionBackend | None = None, *,
                 max_cells: int = 2,
                 probation: ProbationTracker | None = None,
                 tracer=None):
        assert max_cells >= 1
        self.dyn = dyn
        self.backend = backend or AnalyticBackend()
        self.max_cells = max_cells
        # span bus (repro.obs): cell admissions/evictions land on the
        # "engine" trace; NULL (zero-cost) unless the Router wires one in
        self.tracer = tracer or NULL_TRACER
        # when set, stages placed on a probation (re-admitted) device pool
        # get tightened straggler thresholds in new cells' monitors
        self.probation = probation
        self.cells: dict[tuple, Cell] = {}
        self.last_cell: Cell | None = None
        self.log: list[str] = []
        self.evictions = 0
        self._next_cid = 0
        self.inflight: list[InFlight] = []
        self._next_seq = 0
        # occupancy floor: when invalidation (resize / mode flip) drops a
        # cell mid-batch, its devices stay physically busy until the batch
        # drains — new admissions must not double-count that capacity
        self.busy_floor = 0.0

    # -- capacity accounting --------------------------------------------------
    def allocated(self) -> dict:
        used: dict = {}
        for c in self.cells.values():
            for name, n in c.devices.items():
                used[name] = used.get(name, 0) + n
        return used

    def free(self) -> tuple:
        """Per-pool free counts (SystemSpec.pools order, all pools) after
        resident-cell allocations."""
        used = self.allocated()
        return tuple(cnt - used.get(dev.name, 0)
                     for dev, cnt in self.dyn.system.pools)

    def _share_cap(self) -> tuple:
        """Fair-share cap per cell: a single cell may claim at most
        ceil(pool / max_cells) of each device type."""
        counts = (cnt for _, cnt in self.dyn.system.pools)
        if self.max_cells <= 1:
            return tuple(counts)
        return tuple(math.ceil(c / self.max_cells) for c in counts)

    def _fits_free(self, need: dict) -> bool:
        free = dict(zip((dev.name for dev, _ in self.dyn.system.pools),
                        self.free()))
        return all(free.get(name, 0) >= n for name, n in need.items())

    # -- residency ------------------------------------------------------------
    def _sweep_stale(self):
        epoch = self.dyn.epoch
        stale = [k for k, c in self.cells.items() if c.handle.stale(epoch)]
        for k in stale:
            c = self.cells.pop(k)
            self.busy_floor = max(self.busy_floor, c.drain_until)
            if self.last_cell is c:
                self.last_cell = None
            self.log.append(f"cell {c.cid} invalidated (epoch)")

    def cell_by_id(self, cid: int) -> Cell | None:
        for c in self.cells.values():
            if c.cid == cid:
                return c
        return None

    def invalidate(self):
        """Drop every resident handle (callers: explicit redeploys). Busy
        cells' drain times survive as the occupancy floor."""
        if self.cells:
            self.busy_floor = max(
                self.busy_floor,
                max(c.drain_until for c in self.cells.values()))
            self.log.append(f"invalidate: {len(self.cells)} cells dropped")
        self.cells.clear()
        self.last_cell = None

    def _evict_one(self, t: float) -> float:
        """Evict one cell; returns the time its devices are free (== ``t``
        for an idle cell, its drain time otherwise)."""
        idle = [c for c in self.cells.values() if c.drain_until <= t]
        if idle:
            victim = min(idle, key=lambda c: (c.last_used, c.cid))
            t_free = t
        else:
            victim = min(self.cells.values(),
                         key=lambda c: (c.drain_until, c.cid))
            t_free = victim.drain_until
            # the victim's devices stay busy until it drains; the floor
            # keeps other admissions from landing on them early
            self.busy_floor = max(self.busy_floor, t_free)
        del self.cells[victim.key]
        if self.last_cell is victim:
            self.last_cell = None
        self.evictions += 1
        self.log.append(
            f"evict cell {victim.cid} ({victim.schedule.mnemonic}, "
            f"{victim.dispatches} batches)")
        if self.tracer.enabled:
            self.tracer.instant("engine", "cell-evict", t_free,
                                cid=victim.cid,
                                dispatches=victim.dispatches)
        return max(t, t_free)

    def _admit(self, wl, key, t: float) -> tuple[Cell, float]:
        # schedule on the STABLE fair-share cap, not the instantaneous free
        # vector: the DP cache is keyed by (sig, mode, pool), and a pool
        # that churns with residual allocations would fragment it into a
        # fresh solve per admission ("DP solves stay rare" is the point of
        # signature cells)
        try:
            res = self.dyn.submit(wl, pool=self._share_cap())
        except RuntimeError:
            # infeasible under the cap (e.g. needs more memory than the
            # share allows): fall back to the full pool, which requires
            # draining the engine
            while self.cells:
                t = self._evict_one(t)
            res = self.dyn.submit(wl)
        need = dict(res.pipeline.devices_used())
        while len(self.cells) >= self.max_cells or not self._fits_free(need):
            t = self._evict_one(t)
        t = max(t, self.busy_floor)
        handle = self.backend.prepare(res, wl, epoch=self.dyn.epoch)
        # monitor baselines come from the handle's schedule, not the DP's:
        # a cluster backend may hand back a *host-adjusted* schedule (the
        # owning worker's physics, possibly a different stage split), and
        # judging that host's measurements against the baseline-host
        # estimates would flag every known-slow host as a straggler
        stages = handle.schedule.pipeline.stages
        scales = ([self.probation.threshold_factor(s.dev.name)
                   for s in stages] if self.probation is not None else None)
        cell = Cell(
            cid=self._next_cid, key=key, handle=handle,
            devices=need,
            monitor=StragglerMonitor(len(stages),
                                     baselines=[s.total for s in stages],
                                     threshold_scales=scales),
            last_used=t)
        self._next_cid += 1
        self.cells[key] = cell
        self.log.append(
            f"admit cell {cell.cid} {handle.schedule.mnemonic} "
            f"({res.mode}) on {cell.devices}")
        if self.tracer.enabled:
            self.tracer.instant("engine", "cell-admit", t, cid=cell.cid,
                                mnemonic=handle.schedule.mnemonic,
                                mode=res.mode, devices=dict(need))
        return cell, t

    def _acquire(self, wl, t: float) -> tuple[Cell, float]:
        self._sweep_stale()
        key = (signature(wl), self.dyn.mode)
        cell = self.cells.get(key)
        if cell is not None:
            return cell, t
        return self._admit(wl, key, t)

    def prewarm(self, wl, now: float) -> bool:
        """Admit a resident cell for ``wl`` at ``now`` without dispatching
        anything (autoscaler pre-warming ahead of a forecast peak): the
        DP solve + backend prepare happen off the critical path, so the
        peak's first batch finds a deployed pipeline. Deliberately
        non-disruptive — returns False instead of evicting live cells,
        waiting on drains, or forcing a full-pool reschedule."""
        self._sweep_stale()
        key = (signature(wl), self.dyn.mode)
        if key in self.cells:
            return False
        if self.busy_floor > now or len(self.cells) >= self.max_cells:
            return False
        if not self.dyn.feasible(wl, self._share_cap()):
            return False
        need = self.dyn.peek(wl, self._share_cap()).pipeline.devices_used()
        if not self._fits_free(need):
            return False
        self._admit(wl, key, now)
        return True

    # -- dispatch -------------------------------------------------------------
    def ready(self, wl, now: float) -> bool:
        """Can a batch of ``wl`` start executing at ``now`` (resident cell
        idle, or admissible without waiting on a busy cell)?"""
        self._sweep_stale()
        key = (signature(wl), self.dyn.mode)
        cell = self.cells.get(key)
        if cell is not None:
            return cell.busy_until <= now
        if self.busy_floor > now:
            return False               # invalidated pipelines still draining
        if not self.dyn.feasible(wl, self._share_cap()):
            # needs the full pool: dispatchable once no cell is mid-batch
            # (the admit path drains the engine first); vacuously true when
            # no cells are resident
            return all(c.drain_until <= now for c in self.cells.values())
        if len(self.cells) >= self.max_cells and not any(
                c.drain_until <= now for c in self.cells.values()):
            return False
        need = self.dyn.peek(wl, self._share_cap()).pipeline.devices_used()
        if self._fits_free(need):
            return True
        # not enough free capacity: admissible only if idle cells can be
        # evicted now (approximate — dispatch may still wait if they don't
        # free enough, which is bounded by the cells' drain times)
        return any(c.drain_until <= now for c in self.cells.values())

    def submit(self, batch, now: float) -> InFlight:
        """Non-blocking dispatch: hand ``batch`` to its signature cell's
        backend (``ExecutionBackend.submit``) and track it in ``inflight``.
        Execution starts at ``now`` (simulated seconds) unless the cell, or
        the capacity it must wait for, is busy. The cell's busy clock
        advances immediately from the future's simulated finish, so
        ``ready`` keeps a second batch off the cell until the caller reaps
        — the one-in-flight-per-cell invariant."""
        cell, t0 = self._acquire(batch.wl, now)
        t0 = max(t0, cell.busy_until)
        # _acquire swept stale cells, so the handle's epoch is current here
        future = self.backend.submit(cell.handle, batch, t0)
        # charge the replica that will execute (cluster futures carry the
        # routed worker id); unreplicated cells keep their single clock
        rep = cell.advance(getattr(future, "worker", None), future.finish)
        cell.last_used = t0
        cell.dispatches += 1
        self.last_cell = cell
        inf = InFlight(self._next_seq, cell, batch, future, rep=rep)
        self._next_seq += 1
        self.inflight.append(inf)
        return inf

    def reap(self, upto: float | None = None) -> list:
        """Resolve in-flight batches in simulated-timestamp order (finish,
        then submission seq) and return ``(cell, batch, report)`` triples.
        ``upto`` limits the reap to batches whose simulated finish is at or
        before that time; None (default) reaps everything due — ``result()``
        blocks on any backend still executing real work. Futures that are
        not ``ready()`` (a cluster worker gone silent but not yet declared
        lost by the failure detector) are deferred to a later reap rather
        than hanging the control loop.

        A future that resolves to ``WorkerLost`` is delivered as ``(cell,
        batch, None)`` — the batch died with its worker; the Router
        re-queues its requests. Batches leave ``inflight`` only after
        their future resolves: if a resolve raises anything else (device
        OOM, runtime error), every undelivered batch — including already-
        resolved ones, whose reports are cached — survives for the next
        reap instead of being stranded."""
        due = [i for i in self.inflight
               if (upto is None or i.finish <= upto) and i.future.ready()]
        due.sort(key=lambda i: (i.finish, i.seq))
        out = []
        for i in due:
            try:
                report = i.future.result()
            except WorkerLost:
                report = None          # lost batch: deliver for re-queueing
            out.append((i.cell, i.batch, report))
        for i in due:
            self.inflight.remove(i)
        return out

    def resolve(self, inf: InFlight) -> tuple[Cell, CompletionReport]:
        """Block for one in-flight batch's report (None if the executing
        worker died — the blocking path uses the backend's RPC failure
        detection rather than waiting for a heartbeat miss) and retire it
        from ``inflight``. Leaves other callers' batches untouched (and
        this one too, should its resolve raise something unexpected)."""
        try:
            report = inf.future.result()
        except WorkerLost:
            report = None
        self.inflight.remove(inf)
        return inf.cell, report

    def dispatch(self, batch, now: float) -> tuple[Cell, CompletionReport]:
        """Synchronous adapter: submit ``batch`` and block for its report."""
        return self.resolve(self.submit(batch, now))

    def preempt(self, inf: InFlight, now: float) -> bool:
        """Cancel one in-flight batch (tenancy preemption) and roll its
        cell's replica clock back so higher-priority work can start
        immediately. The caller re-queues ``inf.batch.requests`` — this is
        the drain-and-requeue discipline of the worker-loss path, applied
        voluntarily, so nothing is dropped.

        Returns False when cancellation is unsafe and the batch must be
        left to finish: its completion report was already delivered (or it
        died with its worker — the loss path owns the requeue then), its
        replica clock was re-keyed away by a replica-set change, or a
        later batch has stacked behind it on the same clock (rolling back
        mid-stack would let new work double-book the replica)."""
        if inf not in self.inflight:
            return False
        cell, key = inf.cell, inf.rep
        if key not in cell.clocks:
            return False
        if cell.clocks[key] > inf.finish + 1e-9:
            return False
        cancel = getattr(self.backend, "cancel", None)
        if cancel is not None and not cancel(inf.future, now):
            return False
        self.inflight.remove(inf)
        # the replica is busy until the latest *remaining* batch charged to
        # it finishes (an earlier, still-running batch keeps it occupied),
        # floored at now — never into the past
        rem = [i.finish for i in self.inflight
               if i.cell is cell and i.rep == key]
        cell.clocks[key] = max([now] + rem)
        n = len(inf.batch.requests)
        self.log.append(
            f"preempt cell {cell.cid}: batch of {n} cancelled at {now:.3f}")
        if self.tracer.enabled:
            self.tracer.instant("engine", "preempt", now, cid=cell.cid,
                                n=n, seq=inf.seq)
        return True

    # -- clocks (admission control + drain pacing) ----------------------------
    def est_wait(self, now: float, wl=None) -> float:
        """Estimated wait in simulated seconds before a new batch could
        start. With ``wl`` the
        estimate is signature-aware: a request whose own resident cell is
        busy waits for *that* cell even if others are idle (its batch can
        only run there), which keeps deadline admission honest."""
        self._sweep_stale()
        floor = max(0.0, self.busy_floor - now)
        if wl is not None:
            cell = self.cells.get((signature(wl), self.dyn.mode))
            if cell is not None:
                est = max(floor, cell.busy_until - now)
                # steal-aware bound: when the backend is a cluster with
                # work stealing, a busy owner's pending batch may migrate
                # to a dry, strictly-faster peer immediately — charging
                # the owner's full busy clock over-rejects deadline
                # admissions the thief would have served in time
                bound = getattr(self.backend, "est_wait_bound", None)
                if bound is not None and est > floor:
                    est = max(floor, bound(cell.handle, now, est))
                return est
        if not self.cells:
            return floor
        idle = any(c.busy_until <= now for c in self.cells.values())
        room = len(self.cells) < self.max_cells
        if wl is not None:
            # signature-aware admission estimate: free capacity only helps
            # if this workload's cap-schedule actually fits it
            try:
                need = self.dyn.peek(
                    wl, self._share_cap()).pipeline.devices_used()
            except RuntimeError:
                # needs the full pool: every resident cell must drain first
                return max(floor,
                           max(c.drain_until
                               for c in self.cells.values()) - now)
            if idle or (room and self._fits_free(need)):
                return floor
        elif idle or (room and any(f > 0 for f in self.free())):
            return floor
        return max(floor,
                   min(c.busy_until for c in self.cells.values()) - now)

    def next_free(self, t: float) -> float | None:
        """Earliest capacity-release time strictly after ``t`` (a replica
        clock, a cell's drain floor, or the invalidated-pipeline floor);
        None if everything is idle."""
        later = [clk for c in self.cells.values()
                 for clk in (*c.clocks.values(), c.drain_floor)
                 if clk > t]
        if self.busy_floor > t:
            later.append(self.busy_floor)
        return min(later) if later else None

    @property
    def busy_until(self) -> float:
        return max((c.drain_until for c in self.cells.values()),
                   default=self.busy_floor)
