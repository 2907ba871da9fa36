"""FleetView: scheduler self-metrics aggregated live from the span bus.

A ``TraceSink`` that keeps ring buffers instead of a file: per-worker
heartbeat history (busy clock, cumulative measured stage seconds, done
counts), liveness, and the scheduler's own decision counters (steals,
requeues, demotions, mode switches, placement wall latency, DP cache
hits). The dashboard reads it each refresh; nothing else in the stack
ever reads it back (spans stay derived-only — the determinism contract).

Occupancy is computed from the heartbeat stream the way an operator
would: the delta of a worker's cumulative ``stage_s`` over the ring
window, divided by the window's span — the fraction of recent simulated
time the worker spent executing stages. ``backlog_s`` is how far its
busy clock runs ahead of now. Workers on a single-host run (no cluster)
simply never appear; the dashboard then shows the engine's cells only.
"""
from __future__ import annotations

import collections

from .trace import TraceSink


class FleetView(TraceSink):
    def __init__(self, ring: int = 120):
        self.ring = ring
        # wid -> deque of (t, busy_until, done, stage_s, inflight)
        self.hb: dict[str, collections.deque] = {}
        self.alive: dict[str, bool] = {}
        self.exec_batches: dict[str, int] = {}
        self.steals = 0
        self.requeues = 0                  # requests re-queued (lost batch)
        self.demotions = 0                 # straggler demotions fired
        self.mode_switches = 0
        self.mode = ""
        self.placements = 0
        self.dp_cache_hits = 0
        self.place_wall_ms = collections.deque(maxlen=ring)
        # fleet management (repro_torch.fleet)
        self.learned: dict[str, dict] = {}   # wid -> last published profile
        self.parked: dict[str, bool] = {}
        self.autoscale_actions = 0
        self.prewarms = 0
        # hot-cell replication + live migration (docs/cluster.md)
        self.replicas: dict[int, set] = {}   # hid -> serving worker ids
        self.retiring: dict[int, set] = {}   # hid -> hosts draining out
        self.replications = 0
        self.migrations = 0
        self.retires = 0
        # energy governance (repro_torch.energy): the governor's power
        # samples ((t, watts, cap) per tick) and per-cell operating-point
        # indices
        self.power: collections.deque = collections.deque(maxlen=ring)
        self.opoints: dict[str, int] = {}    # sig tag -> frontier index
        self.opoint_switches = 0
        self.cap_downshifts = 0

    # -- TraceSink ------------------------------------------------------------
    def emit(self, rec: dict) -> None:
        name = rec.get("name")
        trace = rec.get("trace", "")
        if name == "hb":
            wid = trace[2:]                # "w:<wid>"
            q = self.hb.setdefault(wid,
                                   collections.deque(maxlen=self.ring))
            q.append((rec["t0"], rec.get("busy_until", 0.0),
                      rec.get("done", 0), rec.get("stage_s", 0.0),
                      rec.get("inflight", 0)))
            self.alive.setdefault(wid, True)
        elif name == "exec":
            wid = trace[2:]
            self.alive.setdefault(wid, True)
            self.exec_batches[wid] = self.exec_batches.get(wid, 0) + 1
        elif name == "steal" and trace.startswith("w:"):
            # the controller's batch-level decision (the Router's
            # per-request steal children would overcount)
            self.steals += 1
        elif name == "requeue":
            self.requeues += 1
        elif name == "demote":
            self.demotions += 1
        elif name == "mode":
            self.mode_switches += 1
            self.mode = rec.get("mode", self.mode)
        elif name == "place":
            self.placements += 1
            if rec.get("cache_hit"):
                self.dp_cache_hits += 1
            w = rec.get("wall_ms")
            if w is not None:
                self.place_wall_ms.append(w)
        elif name == "lost":
            self.alive[trace[2:]] = False
        elif name == "register":
            self.alive.setdefault(trace[2:], True)
        elif name == "learned" and trace.startswith("w:"):
            self.learned[trace[2:]] = {
                k: v for k, v in rec.items()
                if k in ("compute_scale", "bw_scale", "device_scales")}
        elif name == "autoscale" and trace.startswith("w:"):
            action = rec.get("action", "")
            if action in ("park", "unpark"):
                self.parked[trace[2:]] = action == "park"
                self.autoscale_actions += 1
        elif name == "prewarm":
            self.prewarms += 1
        elif name == "deploy" and trace.startswith("w:"):
            hid = rec.get("hid")
            if hid is not None:
                self.replicas.setdefault(hid, set()).add(trace[2:])
        elif name == "replicate" and trace.startswith("w:"):
            self.replications += 1
            hid = rec.get("hid")
            if hid is not None:
                self.replicas.setdefault(hid, set()).add(trace[2:])
                self.retiring.get(hid, set()).discard(trace[2:])
        elif name == "migrate" and trace.startswith("w:"):
            self.migrations += 1
            hid = rec.get("hid")
            if hid is not None:
                reps = self.replicas.setdefault(hid, set())
                reps.add(trace[2:])
                frm = rec.get("frm")
                if frm:
                    reps.discard(frm)
                    self.retiring.setdefault(hid, set()).add(frm)
        elif name == "retire" and trace.startswith("w:"):
            self.retires += 1
            hid = rec.get("hid")
            if hid is not None:
                self.replicas.get(hid, set()).discard(trace[2:])
                self.retiring.get(hid, set()).discard(trace[2:])
        elif name == "power" and trace == "governor":
            self.power.append((rec["t0"], rec.get("watts", 0.0),
                               rec.get("cap")))
            self.cap_downshifts += rec.get("downshifts", 0)
        elif name == "opoint" and trace == "governor":
            self.opoint_switches += 1
            self.opoints[rec.get("sig", "?")] = rec.get("idx", 0)

    # -- queries --------------------------------------------------------------
    def fleet_watts(self) -> float:
        """The governor's last power sample (0 before its first tick)."""
        return self.power[-1][1] if self.power else 0.0

    def power_cap(self) -> float | None:
        """The cap in force at the last power sample (None = uncapped)."""
        return self.power[-1][2] if self.power else None

    @property
    def replicated_cells(self) -> int:
        """Cells currently served by two or more hosts."""
        return sum(1 for reps in self.replicas.values() if len(reps) >= 2)

    def replica_count(self, wid: str) -> int:
        """Cells this worker currently serves a replica of."""
        return sum(1 for reps in self.replicas.values() if wid in reps)

    def occupancy(self, wid: str, now: float) -> float:
        """Fraction of the recent heartbeat window the worker spent
        executing (cumulative stage_s delta over the window), clamped to
        [0, 1]. Falls back to its busy clock vs ``now`` when the window
        is a single sample."""
        q = self.hb.get(wid)
        if not q:
            return 0.0
        t0, _, _, s0, _ = q[0]
        t1, busy, _, s1, _ = q[-1]
        if t1 - t0 > 1e-9:
            return max(0.0, min(1.0, (s1 - s0) / (t1 - t0)))
        return 1.0 if busy > now else 0.0

    def backlog(self, wid: str, now: float) -> float:
        """Seconds the worker's busy clock runs ahead of ``now``."""
        q = self.hb.get(wid)
        return max(0.0, q[-1][1] - now) if q else 0.0

    def worker_rows(self, now: float) -> list[dict]:
        """One dashboard row per known worker, sorted by id."""
        rows = []
        for wid in sorted(set(self.hb) | set(self.alive)):
            q = self.hb.get(wid)
            learned = self.learned.get(wid)
            rows.append({
                "wid": wid,
                "alive": self.alive.get(wid, True),
                "parked": self.parked.get(wid, False),
                "busy_frac": round(self.occupancy(wid, now), 4),
                "backlog_s": round(self.backlog(wid, now), 3),
                "done": q[-1][2] if q else 0,
                "batches": self.exec_batches.get(wid, 0),
                "replicas": self.replica_count(wid),
                "retiring": sum(1 for hosts in self.retiring.values()
                                if wid in hosts),
                "last_hb": round(q[-1][0], 3) if q else None,
                # learned compute scale (None until the estimator publishes)
                "learned_scale": (learned.get("compute_scale")
                                  if learned else None),
            })
        return rows
