"""Cluster events: the recordable, replayable timeline of control-plane
happenings — worker registration, scripted kills and joins, latency
injection, heartbeat-miss detections, and the per-pool failure events the
controller converts them into.

Mirrors ``TrafficSim.to_jsonl``/``from_jsonl`` for arrivals: a live run
*records* everything it observed; ``ClusterEventLog.from_jsonl(path)
.script()`` extracts just the **input** events (kill / join / latency —
the things an operator or chaos harness injected) so a fresh cluster
re-derives the detections and failure cascade from scratch. A recorded
worker-kill mid-diurnal-stream therefore replays as a deterministic test
case: same stream + same script ⇒ byte-identical event log and telemetry.

All times are simulated-clock seconds (the same clock the serving stack
runs on).
"""
from __future__ import annotations

import dataclasses
import json

#: Event kinds an operator/script *injects* (everything else is derived by
#: the controller and re-derived on replay).
INPUT_KINDS = ("kill", "join", "latency")


@dataclasses.dataclass(frozen=True)
class ClusterEvent:
    """One control-plane event at simulated time ``t``.

    Kinds:
      * ``register``       — worker joined the cluster (detail: pool)
      * ``kill``           — scripted crash: worker stops responding
      * ``join``           — scripted scale-out: a new worker registers
                             live (detail: pool)
      * ``latency``        — scripted slowdown: the worker's measured
                             stage times are scaled (detail: factor)
      * ``heartbeat-miss`` — controller declared the worker lost (detail:
                             via = 'heartbeat' | 'rpc', last_hb)
      * ``failure``        — one per device pool of a lost worker, as
                             handed to the listeners' ``on_failure``
      * ``steal``          — the controller migrated a pending batch to a
                             dry, faster worker (``worker`` = the thief;
                             detail: from, hid, n). Derived, not input:
                             a replay re-derives the identical steal
                             sequence from the same controller state.
      * ``learned-profile``— the OnlineHostEstimator published a learned
                             ``HostProfile`` for the worker (detail:
                             profile dict). Derived: a replay re-runs the
                             estimator over the same reports and
                             re-publishes identically.
      * ``autoscale``      — a PredictiveAutoscaler decision (detail:
                             action = 'park' | 'unpark' | 'prewarm',
                             optional reason/sig). Derived from the
                             forecast, which is a deterministic function
                             of the arrival stream.
      * ``replicate``      — the controller promoted a hot cell onto an
                             additional worker (``worker`` = the new
                             replica host; detail: hid, n = replica count
                             after the promotion). Derived from the
                             forecaster's hot set + controller placement
                             state, both deterministic on replay.
      * ``migrate``        — live migration: a cell's primary moved to a
                             new host with a drain-to-replica handoff
                             (``worker`` = the destination; detail:
                             from, hid, reason). Derived.
      * ``retire``         — a drained replica was dismissed from its
                             host (``worker`` = the host giving the
                             replica up; detail: hid). Derived: the
                             drain clock is controller bookkeeping.
      * ``opoint``         — the ParetoGovernor moved a signature cell
                             to a different operating point on its DP
                             frontier (detail: sig, idx, frac, watts,
                             reason = 'demand' | 'cap' | 'slo').
                             Derived from the arrival forecast +
                             frontier, both deterministic on replay.
      * ``power``          — a fleet power-budget sample/enforcement by
                             the governor (detail: watts, cap,
                             downshifts). Derived: watts come from the
                             resident cells' operating points via the
                             energy model, never from hardware.
      * ``preempt``        — the Router evicted a lower-priority in-flight
                             batch for higher-priority tenant pressure;
                             the controller withdrew the submission from
                             its worker (``worker`` = the host that was
                             executing; detail: hid, n = batch size).
                             Derived: preemption decisions are a
                             deterministic function of queue + in-flight
                             state, so a replay re-derives the identical
                             eviction sequence.
    """
    t: float
    kind: str
    worker: str = ""
    detail: dict = dataclasses.field(default_factory=dict)

    def to_record(self) -> dict:
        return {"t": round(self.t, 9), "kind": self.kind,
                "worker": self.worker, **self.detail}

    @classmethod
    def from_record(cls, rec: dict) -> "ClusterEvent":
        rec = dict(rec)
        t = rec.pop("t")
        kind = rec.pop("kind")
        worker = rec.pop("worker", "")
        return cls(t, kind, worker, rec)


class ClusterEventLog:
    """Append-only event log with JSONL round-trip."""

    def __init__(self, events=()):
        self.events: list[ClusterEvent] = list(events)

    def append(self, ev: ClusterEvent) -> None:
        self.events.append(ev)

    def __len__(self):
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def kinds(self) -> list[str]:
        return [e.kind for e in self.events]

    def script(self) -> tuple:
        """The input events only (kill/join/latency), for replay: feed
        them to a fresh ``Controller(script=...)`` and it re-derives the
        registrations, detections, and failure cascade."""
        return tuple(e for e in self.events if e.kind in INPUT_KINDS)

    def to_jsonl(self, path) -> None:
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e.to_record()) + "\n")

    @classmethod
    def from_jsonl(cls, path) -> "ClusterEventLog":
        events = []
        with open(path) as f:
            for line in f:
                if line.strip():
                    events.append(ClusterEvent.from_record(json.loads(line)))
        return cls(events)
