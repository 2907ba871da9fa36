"""The worker peer: owns a device sub-pool, runs a local ExecutionBackend,
answers controller messages, and emits heartbeats carrying its busy clock
and cumulative measured stage seconds.

``WorkerCore`` is transport-agnostic — a pure message handler — so the
same logic backs both substrates:

  * **in-process** (``InProcPeer``): the controller pumps the core inside
    the single host control loop; execution timing stays on the shared
    simulated clock and the whole cluster is deterministic.
  * **multiprocessing** (``worker_main``): the identical handler loop in a
    real child process behind a pipe (see ``comms.mp_worker``).

The worker deliberately knows nothing about scheduling: it receives
already-solved ``ScheduleResult``s to ``prepare`` and batch submissions to
run — HTS's split, with the DP and all placement policy living at the
controller/Engine layer. Its local backend may be analytic, replay, or
torch (``ExecutionBackend`` protocol), so a cluster can mix simulated
workers with ones doing real device work.

Message vocabulary (dicts; ``op`` selects):

  controller -> worker                      worker -> controller
  ------------------------------------      --------------------------------
  prepare {hid, schedule, workload, epoch}  prepared {hid, wid}
  submit  {hid, sid, n, t0}                 accepted {sid, wid, finishes}
  latency {factor}                          report {sid, wid, report, due}
  retire  {hid}                             pong {wid, echo}
  ping    {echo?}                           heartbeat {wid, t, busy_until,
  hb      {now}                                        done, stage_s, inflight}
  cancel  {sid, now}
  stop    {}

``cancel`` withdraws an accepted submission before its simulated finish
(tenancy preemption): the worker rolls back the batch's counters and the
in-process peer drops its held report — as if the batch never ran. The
controller only sends it when the report has not been released yet.

A ``submit`` answers twice: ``accepted`` immediately (the simulated
finishes the busy clocks need) and the full ``report`` stamped with
``due`` = the batch's simulated finish. The in-process peer *holds* the
report until the simulated clock passes ``due`` — work a worker has not
finished when it crashes dies with it, exactly like a real host — while
the multiprocessing worker sends it straight away (a real process's
report exists when it is computed; that transport is wall-clock anyway).
"""
from __future__ import annotations

import dataclasses

from ..core.device import UNIFORM_HOST, relative_profile
from ..core.scheduler import apply_profile
from ..obs.trace import NULL_TRACER
from ..runtime.backend import AnalyticBackend, ExecutionBackend


class WorkerCore:
    """Single worker's state machine; all of its clocks (``busy_until``,
    report finishes, heartbeat stamps) are **simulated seconds** — the
    transport decides whether delivery is simulation-deterministic
    (in-process) or wall-clock (multiprocessing). ``pool`` maps
    device-type name to the count this worker physically owns (the
    controller uses it for placement/steal fit and converts it into
    ``on_failure`` events if the worker is lost). ``latency_factor``
    scales *measured* stage times only — the report's simulated
    completion clock is never touched, so latency injection perturbs the
    straggler/feedback path without breaking the cluster-vs-local
    ordering parity. ``profile`` is this host's ``HostProfile``; the
    worker never applies it itself (see ``__init__``). Driven by exactly
    one loop (the controller's pump, or ``worker_main``'s recv loop) —
    no methods are safe to call from a second thread."""

    def __init__(self, wid: str, pool: dict, backend: ExecutionBackend
                 | None = None, *, hb_interval: float = 1.0, profile=None,
                 truth_profile=None):
        self.wid = wid
        self.pool = dict(pool)
        self.backend = backend or AnalyticBackend()
        self.hb_interval = hb_interval
        # this host's performance model (core.device.HostProfile). The
        # worker does NOT apply it itself: the control plane bakes the
        # profile into every schedule it deploys here (host-aware re-solve
        # or apply_profile), and the worker times whatever it is given —
        # one source of physical truth, no double scaling. Carried for
        # identity/telemetry and for transports that inspect the core.
        self.profile = profile
        # GROUND TRUTH physics the controller may not know about
        # (learned-fleet experiments: ``--true-host-profiles`` injects a
        # slow host the operator never declared). When set, every deployed
        # schedule is rescaled from the controller's *belief* (sent along
        # in the prepare message) onto this truth before it is prepared:
        # execution, finishes, and measured times are physical, while the
        # belief expectations still ride in ``stage_expected`` — the
        # measured/expected gap is exactly what the OnlineHostEstimator
        # learns from. None (the default, and whenever belief == truth)
        # keeps the verbatim-execution contract above bit-identical.
        self.truth_profile = truth_profile
        # span bus (repro_torch.obs): set by the controller when the serving
        # stack runs traced; stays NULL (zero-cost) otherwise. A remote
        # (multiprocessing) worker keeps NULL — its spans would live in
        # the child process; the controller-side deploy/heartbeat spans
        # cover that transport.
        self.tracer = NULL_TRACER
        self.handles: dict[int, object] = {}    # hid -> PipelineHandle
        self._beliefs: dict[int, object] = {}   # hid -> deployed schedule
        self.latency_factor = 1.0
        self.busy_until = 0.0                   # max simulated finish seen
        self.done = 0                           # requests completed
        self.stage_s = 0.0                      # sum of measured stage secs
        self._last_hb: float | None = None
        # unfinished submissions, for cancel rollback: sid -> (simulated
        # finish, n, measured stage seconds). Pruned once finished.
        self._submits: dict[int, tuple] = {}

    # -- message handling -----------------------------------------------------
    def handle(self, msg: dict) -> list[dict]:
        """Process one controller message; returns the replies to send."""
        op = msg["op"]
        if op == "prepare":
            sched = msg["schedule"]
            self._beliefs[msg["hid"]] = sched
            self.handles[msg["hid"]] = self.backend.prepare(
                self._physical(sched, msg.get("profile")), msg["workload"],
                epoch=msg.get("epoch", 0))
            return [{"op": "prepared", "hid": msg["hid"], "wid": self.wid}]
        if op == "submit":
            handle = self.handles[msg["hid"]]
            rep = self.backend.execute(handle, msg["n"], msg["t0"])
            # stamp the *executing* host: a stolen batch runs here, not
            # on its cell's owner — measured-time consumers (the wall
            # calibrator) attribute by this id, not by placement. The
            # belief expectations come from the schedule the controller
            # deployed to *this* worker (not the cell owner's), so the
            # estimator attributes measured/expected ratios correctly.
            belief = self._beliefs.get(msg["hid"])
            expected = (tuple((s.dev.name, s.t_exec, s.t_in + s.t_out)
                              for s in belief.pipeline.stages)
                        if belief is not None else ())
            rep = dataclasses.replace(
                rep, worker=self.wid, stage_expected=expected,
                measured_stage_times=(tuple(
                    self.latency_factor * t for t in rep.measured)
                    if self.latency_factor != 1.0
                    else rep.measured_stage_times))
            if self.tracer.enabled:
                self.tracer.child(f"w:{self.wid}", "exec", msg["t0"],
                                  rep.finish, sid=msg["sid"], n=msg["n"],
                                  hid=msg["hid"])
            self.busy_until = max(self.busy_until, rep.finish)
            self.done += msg["n"]
            self.stage_s += sum(rep.measured)
            self._submits[msg["sid"]] = (rep.finish, msg["n"],
                                         sum(rep.measured))
            return [{"op": "accepted", "sid": msg["sid"], "wid": self.wid,
                     "finishes": rep.finishes},
                    {"op": "report", "sid": msg["sid"], "wid": self.wid,
                     "report": rep, "due": rep.finish}]
        if op == "cancel":
            # tenancy preemption: undo an unfinished submission's effect on
            # this worker's counters (the batch never completed here)
            rec = self._submits.pop(msg["sid"], None)
            if rec is not None:
                fin, n, stage_sum = rec
                self.done -= n
                self.stage_s -= stage_sum
                now = msg.get("now", 0.0)
                self.busy_until = max(
                    (f for f, _n, _s in self._submits.values()),
                    default=min(self.busy_until, now))
            return []
        if op == "latency":
            self.latency_factor = float(msg["factor"])
            return []
        if op == "retire":
            # drop a drained replica: the controller guarantees nothing is
            # in flight for this hid here, so releasing the handle is safe
            self.handles.pop(msg["hid"], None)
            self._beliefs.pop(msg["hid"], None)
            return []
        if op == "ping":
            return [{"op": "pong", "wid": self.wid, "echo": msg.get("echo")}]
        if op == "hb":                           # forced heartbeat (mp poll)
            self._last_hb = msg.get("now", 0.0)
            return [self._heartbeat_msg(self._last_hb)]
        if op == "stop":
            return []
        raise ValueError(f"unknown op {op!r}")

    def _physical(self, sched, belief_profile):
        """The schedule this host will *physically* run: the deployed
        (belief-scaled) schedule rescaled onto the injected ground truth.
        Without a ``truth_profile`` — every production path — the deployed
        schedule is returned untouched (verbatim execution); when the
        controller's belief already equals the truth the relative profile
        is uniform and ``apply_profile`` is likewise the identity."""
        if self.truth_profile is None:
            return sched
        rel = relative_profile(self.truth_profile,
                               belief_profile or UNIFORM_HOST)
        return apply_profile(sched, rel)

    # -- heartbeats -----------------------------------------------------------
    def _heartbeat_msg(self, now: float) -> dict:
        return {"op": "heartbeat", "wid": self.wid, "t": now,
                "busy_until": self.busy_until, "done": self.done,
                "stage_s": round(self.stage_s, 9),
                "inflight": 0}

    def heartbeat(self, now: float) -> dict | None:
        """The heartbeat due at simulated time ``now``, or None when the
        last one is younger than ``hb_interval``."""
        if self._last_hb is not None and now - self._last_hb < self.hb_interval:
            return None
        self._last_hb = now
        if self._submits:
            # finished submissions can no longer be cancelled: drop their
            # rollback records (memory hygiene on long streams)
            self._submits = {s: v for s, v in self._submits.items()
                             if v[0] > now}
        return self._heartbeat_msg(now)


class InProcPeer:
    """In-process worker runtime: a ``WorkerCore`` plus its channel end.
    The controller calls ``pump(now)`` each control cycle — the peer
    drains its inbox through the core, sends replies, and emits a
    heartbeat when one is due. A reply stamped with a ``due`` time (a
    batch report, due at its simulated finish) is *held* until the clock
    passes it: the simulated worker has not finished that work yet, so a
    crash before ``due`` loses it. ``fail()`` simulates the crash: the
    peer stops handling messages, heartbeating, and releasing held
    reports (its inbox silently fills) — exactly the silence the
    controller's failure detector must notice."""

    def __init__(self, core: WorkerCore, chan):
        self.core = core
        self.chan = chan
        self.failed = False
        self._held: list = []          # (due, seq, reply), release-ordered
        self._held_seq = 0

    def fail(self) -> None:
        self.failed = True

    def pump(self, now: float) -> None:
        if self.failed:
            return
        while (msg := self.chan.recv()) is not None:
            if msg.get("op") == "cancel":
                # a cancelled batch's report must never deliver: drop the
                # held copy before the core rolls its counters back
                sid = msg["sid"]
                self._held = [h for h in self._held
                              if not (h[2].get("op") == "report"
                                      and h[2].get("sid") == sid)]
            for rep in self.core.handle(msg):
                due = rep.get("due")
                if due is not None and due > now:
                    self._held.append((due, self._held_seq, rep))
                    self._held_seq += 1
                else:
                    self.chan.send(rep)
        if self._held:
            self._held.sort()
            while self._held and self._held[0][0] <= now:
                self.chan.send(self._held.pop(0)[2])
        hb = self.core.heartbeat(now)
        if hb is not None:
            self.chan.send(hb)


def worker_main(conn, wid: str, pool: dict, backend: str = "analytic",
                backend_kw: dict | None = None) -> None:
    """Entry point of a multiprocessing worker (see ``comms.mp_worker``):
    the same ``WorkerCore`` behind a blocking pipe loop. Exits on
    ``{"op": "stop"}`` or when the controller end hangs up."""
    from ..runtime.backend import make_backend

    core = WorkerCore(wid, pool, make_backend(backend, **(backend_kw or {})))
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if msg.get("op") == "stop":
            break
        for rep in core.handle(msg):
            rep.pop("due", None)       # real process: report exists now
            conn.send(rep)
    conn.close()
