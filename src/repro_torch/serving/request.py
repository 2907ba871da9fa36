"""Request abstraction + admission-controlled queue.

A serving request carries the *observed* characteristics of one input
(its ``Workload``) — exactly what ``DynamicScheduler.submit`` consumes —
plus arrival time and an optional deadline. The queue is the front door of
the serving stack: it bounds memory (max depth), rejects requests whose
deadline is already hopeless, and expires requests that aged out while
waiting. All times are simulated-clock seconds (floats) so the whole stack
is deterministic and unit-testable; a real deployment feeds wall-clock.
"""
from __future__ import annotations

import collections
import dataclasses

from ..core.workload import Workload


@dataclasses.dataclass
class Request:
    rid: int
    wl: Workload
    arrival: float
    deadline: float | None = None   # absolute sim time; None = best effort
    kind: str = ""                  # workload family tag ('gnn', 'llm', ...)
    tenant: str = ""                # tenant class name ("" = untenanted)
    priority: int = 0               # priority band (0 = highest)
    # filled in by the router when the request completes
    start: float = 0.0
    finish: float = 0.0
    energy: float = 0.0

    @property
    def latency(self) -> float:
        return self.finish - self.arrival

    def feasible(self, now: float) -> bool:
        return self.deadline is None or now < self.deadline


@dataclasses.dataclass
class AdmissionStats:
    admitted: int = 0
    rejected_full: int = 0
    rejected_deadline: int = 0
    expired: int = 0
    displaced: int = 0   # admitted, then evicted by a higher-priority admit

    @property
    def rejected(self) -> int:
        return self.rejected_full + self.rejected_deadline


class RequestQueue:
    """FIFO with admission control. ``max_depth`` bounds the backlog; a
    request whose deadline has already passed (or would pass before the
    estimated queue drain, when the caller supplies ``est_wait``) is
    rejected at the door instead of wasting a schedule slot."""

    def __init__(self, max_depth: int = 1024):
        self.max_depth = max_depth
        self._q: collections.deque[Request] = collections.deque()
        self.stats = AdmissionStats()
        # requests evicted by priority displacement, awaiting the Router's
        # drop accounting (take_displaced) — see admit()
        self._displaced: list[Request] = []

    def __len__(self):
        return len(self._q)

    def __iter__(self):
        return iter(self._q)

    def admit(self, req: Request, now: float, est_wait: float = 0.0) -> bool:
        if len(self._q) >= self.max_depth:
            # Priority admission: a full queue evicts the youngest queued
            # request of the weakest strictly-lower band before turning a
            # higher-priority request away. The victim surfaces through
            # take_displaced() so the Router can account it as a drop.
            victim = self._displace_victim(req)
            if victim is None:
                self.stats.rejected_full += 1
                return False
            if req.deadline is not None and now + est_wait >= req.deadline:
                self.stats.rejected_deadline += 1
                return False   # hopeless anyway: don't evict for nothing
            self._q = collections.deque(
                r for r in self._q if r is not victim)
            self._displaced.append(victim)
            self.stats.displaced += 1
        if req.deadline is not None and now + est_wait >= req.deadline:
            self.stats.rejected_deadline += 1
            return False
        self.stats.admitted += 1
        self._q.append(req)
        return True

    def _displace_victim(self, req: Request) -> Request | None:
        worst = None
        for r in self._q:
            if r.priority <= req.priority:
                continue
            if worst is None or (r.priority, r.arrival, r.rid) > (
                    worst.priority, worst.arrival, worst.rid):
                worst = r
        return worst

    def take_displaced(self) -> list[Request]:
        """Drain requests evicted by priority displacement since the last
        call. They were counted ``admitted``; the caller must count them
        dropped so the admitted == completed + dropped ledger balances."""
        out, self._displaced = self._displaced, []
        return out

    def expire(self, now: float) -> list[Request]:
        """Drop queued requests whose deadline passed while waiting."""
        dead = [r for r in self._q if not r.feasible(now)]
        if dead:
            gone = set(id(r) for r in dead)
            self._q = collections.deque(
                r for r in self._q if id(r) not in gone)
            self.stats.expired += len(dead)
        return dead

    def take(self, reqs) -> None:
        """Remove ``reqs`` (claimed by a batch) from the queue."""
        gone = set(id(r) for r in reqs)
        self._q = collections.deque(r for r in self._q if id(r) not in gone)

    def requeue(self, reqs) -> None:
        """Return already-admitted requests to the queue — their batch was
        lost with a dead worker or preempted. No admission re-check (they
        were admitted once; bouncing them now would turn a worker failure
        into silent request loss) and no depth bound (they were counted
        against it at admission). Original arrival times are kept.

        Placement is priority-band aware: each returned request goes to
        the *front of its own band* — ahead of queued peers of the same
        or lower class (it is the oldest work there) but never ahead of a
        strictly higher-priority class, so a preempted low-priority batch
        cannot jump the line past waiting high-priority requests. With
        uniform priorities (the single-tenant default) this degenerates
        to the historical front-of-queue insert. (``ServingMetrics.requeued``
        is the counter — the Router bumps it alongside this call.)"""
        ret = collections.deque(reqs)
        if not ret:
            return
        merged: collections.deque[Request] = collections.deque()
        for cur in self._q:
            while ret and ret[0].priority <= cur.priority:
                merged.append(ret.popleft())
            merged.append(cur)
        merged.extend(ret)
        self._q = merged

    @property
    def oldest(self) -> Request | None:
        return self._q[0] if self._q else None
