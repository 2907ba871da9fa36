"""Dynamic, data-aware rescheduling (paper §I/§II: "automatically partitions,
deploys, and reschedules execution when necessary by dynamically analyzing
the characteristics of the input data").

``DynamicScheduler`` wraps the DP scheduler with:
  * input-characteristic tracking — each incoming request/batch is summarized
    (nnz, dims, seq_len, window); schedules are cached per quantized
    characteristic signature, so steady streams pay the DP cost once;
  * drift detection — when characteristics move outside the signature cell of
    the active schedule, the DP re-runs and the pipeline is re-deployed;
  * elastic pool changes — device failures / additions call ``resize`` which
    invalidates the cache and reschedules (the runtime's fault-tolerance
    hooks call this, see runtime/elastic.py);
  * objective changes at runtime (e.g. traffic-forecasting: perf mode at
    peak hours, energy mode off-peak — the paper's §II example).
"""
from __future__ import annotations

import dataclasses
import math

from .device import SystemSpec
from .perf_model import PerfModel
from .scheduler import ScheduleResult, Scheduler
from .workload import Workload


def signature(wl: Workload, *, log_quant: float = 0.25) -> tuple:
    """Quantized characteristic signature: kernel kinds + log-quantized dims.
    Two workloads with the same signature share a schedule."""
    sig = []
    for k in wl:
        dims = (k.M, k.K, k.N, k.nnz, k.seq_len, k.w)
        q = tuple(0 if d <= 0 else round(math.log10(d) / log_quant)
                  for d in dims)
        sig.append((k.kind,) + q)
    return tuple(sig)


@dataclasses.dataclass
class RescheduleEvent:
    step: int
    # 'drift' | 'resize' | 'objective' | 'opoint' | 'initial'
    reason: str
    mnemonic: str
    throughput: float


class DynamicScheduler:
    def __init__(self, system: SystemSpec, perf: PerfModel,
                 mode: str = "perf"):
        self.system = system
        self.perf = perf
        self.mode = mode
        self._sched = Scheduler(system, perf)
        self._sub_scheds: dict = {}   # (pool counts, HostProfile|None) ->
        #                               Scheduler on that sub-pool/host
        self._cache: dict = {}
        self.active: ScheduleResult | None = None
        self._active_sig = None
        self.events: list[RescheduleEvent] = []
        self._step = 0
        self.dp_solves = 0      # actual Scheduler.schedule invocations
        # epoch bumps on every resize / objective flip; execution backends
        # stamp it into their PipelineHandles so a stale handle (prepared
        # under an older pool or objective) is detected and re-prepared.
        self.epoch = 0
        # set by set_mode/set_target: the event it appended plus the workload
        # signature that was active, so the next submit of the *same* workload
        # fills in that event instead of appending a duplicate 'drift'.
        self._pending_event: RescheduleEvent | None = None
        self._pending_wsig = None
        # continuous per-signature operating points (repro.energy): wsig ->
        # throughput fraction in (0, 1]. A targeted signature schedules via
        # the balanced-mode frontier walk at that fraction instead of the
        # global binary mode; 1.0 == the perf endpoint.
        self.targets: dict = {}

    def _scheduler_for(self, pool, host=None):
        """Scheduler on the full system (pool=None) or on a per-pool-count
        sub-pool of it — how the serving Engine carves disjoint device
        subsets for concurrently-resident signature cells. ``host`` (a
        ``HostProfile``) selects a host-aware scheduler whose solved times
        are that host's physics (cluster placement re-solves)."""
        if pool is None and host is None:
            return self._sched
        s = self._sub_scheds.get((pool, host))
        if s is None:
            sub = self.system if pool is None else self.system.with_counts(
                pool[0], pool[1], extra_counts=pool[2:] or None)
            s = Scheduler(sub, self.perf, host=host)
            self._sub_scheds[(pool, host)] = s
        return s

    def _full_counts(self) -> tuple:
        return tuple(cnt for _, cnt in self.system.pools)

    def _norm_pool(self, pool):
        """Clamp a per-pool-count vector to the system; pad short vectors
        with full capacity; None == the full pool."""
        if pool is None:
            return None
        full = self._full_counts()
        if len(pool) > len(full):
            raise ValueError(f"pool vector {pool} names {len(pool)} pools; "
                             f"the system has {len(full)}")
        pool = tuple(min(p, c) for p, c in zip(pool, full))
        pool += full[len(pool):]
        return None if pool == full else pool

    def _selector(self, wsig):
        """What the signature schedules under: its pinned operating point
        (``("op", frac)``, the governor's continuous knob) when one is
        set, else the global binary mode. The selector sits in the cache
        key where the mode used to, so each operating point is its own
        cached schedule cell."""
        frac = self.targets.get(wsig)
        return self.mode if frac is None else ("op", frac)

    def _lookup(self, wl, sig, pool, host=None):
        res = self._cache.get(sig)
        if res is None:
            sel = sig[1]
            sched = self._scheduler_for(pool, host)
            if isinstance(sel, tuple):          # ("op", frac)
                res = sched.schedule(wl, "balanced", balanced_frac=sel[1])
            else:
                res = sched.schedule(wl, sel)
            self._cache[sig] = res
            self.dp_solves += 1
        return res

    def peek(self, wl: Workload, pool: tuple | None = None,
             host=None) -> ScheduleResult:
        """The schedule ``submit`` would return, without the event/active
        bookkeeping — for feasibility probes (Engine.ready) that must not
        pollute the reschedule log. Shares the cache with ``submit``.
        ``host`` asks for the host-aware solve (``HostProfile``); schedules
        are cached per (signature, mode-or-opoint, pool, host) cell."""
        pool = self._norm_pool(pool)
        host = None if (host is None or host.is_uniform) else host
        wsig = signature(wl)
        return self._lookup(wl, (wsig, self._selector(wsig), pool, host),
                            pool, host)

    def feasible(self, wl: Workload, pool: tuple | None = None) -> bool:
        """Can ``wl`` be scheduled on ``pool`` at all (device types allowed,
        memory fits)?"""
        try:
            self.peek(wl, pool)
            return True
        except RuntimeError:
            return False

    # -- the per-request entry point -----------------------------------------
    def submit(self, wl: Workload, pool: tuple | None = None) -> ScheduleResult:
        """Called with the *observed* characteristics of the next input.
        Returns the schedule to run it under, rescheduling on drift.
        ``pool`` restricts the schedule to a sub-pool of the system: one
        count per device pool, in ``SystemSpec.pools`` order (a 2-tuple on
        the paper system; short vectors leave trailing pools at full
        capacity). Used by the Engine to co-locate signature cells;
        schedules are cached per (signature, mode, pool) cell."""
        self._step += 1
        pool = self._norm_pool(pool)
        wsig = signature(wl)
        # submit always plans host-free
        sig = (wsig, self._selector(wsig), pool, None)
        if sig == self._active_sig and self.active is not None:
            return self.active
        res = self._lookup(wl, sig, pool)
        first = self.active is None
        self.active, self._active_sig = res, sig
        if self._pending_event is not None and wsig == self._pending_wsig:
            # the 'objective' event already records why we rescheduled;
            # complete it with the outcome rather than logging a fake drift
            self._pending_event.mnemonic = res.mnemonic
            self._pending_event.throughput = res.throughput
        else:
            reason = "initial" if first else "drift"
            self.events.append(RescheduleEvent(self._step, reason,
                                               res.mnemonic, res.throughput))
        self._pending_event = self._pending_wsig = None
        return res

    # -- elastic pool changes --------------------------------------------------
    def resize(self, n_a: int, n_b: int):
        """Device failure / addition: rebuild the scheduler on the new pool
        and force a reschedule of the active workload."""
        self.system = self.system.with_counts(n_a, n_b)
        self._sched = Scheduler(self.system, self.perf)
        self._sub_scheds.clear()
        self._cache.clear()
        self.epoch += 1
        sig = self._active_sig
        self._active_sig = None
        self._pending_event = self._pending_wsig = None
        if sig is not None:
            self.events.append(RescheduleEvent(self._step, "resize", "-", 0.0))

    def set_mode(self, mode: str):
        if mode != self.mode:
            self.mode = mode
            self.epoch += 1
            prev = self._active_sig
            self._active_sig = None
            ev = RescheduleEvent(self._step, "objective", "-", 0.0)
            self.events.append(ev)
            if prev is not None:
                self._pending_event, self._pending_wsig = ev, prev[0]

    def set_target(self, wsig, frac: float | None) -> bool:
        """Pin one signature to a continuous operating point: schedule it
        at the lowest-energy frontier point whose throughput is >= ``frac``
        of the maximum (``frac=1.0`` is the perf endpoint, ``frac->0`` the
        energy endpoint). ``None`` clears the pin (back to the global
        mode). The fraction is quantized so the governor's float math maps
        to a finite set of cache cells. A change bumps the epoch —
        resident handles for the signature go stale and re-prepare under
        the new point through the same invalidation path resize/set_mode
        use. Returns True when the target actually changed."""
        if frac is not None:
            frac = round(min(1.0, max(frac, 1e-3)), 3)
        if self.targets.get(wsig) == frac:
            return False
        if frac is None:
            self.targets.pop(wsig, None)
        else:
            self.targets[wsig] = frac
        self.epoch += 1
        prev = self._active_sig
        self._active_sig = None
        ev = RescheduleEvent(self._step, "opoint", "-", 0.0)
        self.events.append(ev)
        if prev is not None and prev[0] == wsig:
            self._pending_event, self._pending_wsig = ev, wsig
        return True
