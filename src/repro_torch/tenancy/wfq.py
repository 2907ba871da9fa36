"""Weighted fair queueing state + preemption policy for tenant classes.

The ``TenantManager`` is the one mutable piece of tenancy state shared by
the ``TenantBatcher`` (dispatch ordering) and the ``Router`` (preemption
rights). It keeps a per-tenant *virtual time* in units of requests per
share: every batch formed for tenant ``t`` advances ``vtime[t]`` by
``n / share``, so within a priority band the tenant with the smallest
virtual time — the one furthest behind its weighted allocation — goes
next. Across bands, priority is strict, softened only by the starvation
bound: a group that has waited longer than ``starve_after`` is *promoted*
to the top band for dispatch ordering, which bounds the lowest class's
queueing delay. Promotion grants ordering, never preemption rights — an
aged bronze group dispatches ahead of young gold work but cannot evict
gold's in-flight batches, and an aged bronze batch already executing is
itself protected from further preemption (no livelock by repeated
eviction).

Everything here is driven purely off the simulated clock and queue
contents, so tenant-aware runs stay byte-identical under record/replay.
"""
from __future__ import annotations

from .spec import DEFAULT_TENANT, TenantSpec


class TenantManager:
    def __init__(self, specs: tuple[TenantSpec, ...] = (), *,
                 preempt: bool = True, starve_after: float = 4.0):
        self.specs = {s.name: s for s in specs}
        self.preempt = preempt
        self.starve_after = float(starve_after)
        self.vtime: dict[str, float] = {s.name: 0.0 for s in specs}

    def spec(self, name: str) -> TenantSpec:
        return self.specs.get(name, DEFAULT_TENANT)

    def priority(self, name: str) -> int:
        return self.spec(name).priority

    def share(self, name: str) -> float:
        return max(self.spec(name).share, 1e-9)

    def charge(self, name: str, n: int) -> None:
        """Advance ``name``'s virtual time by ``n`` requests of service.

        Charged at batch *formation* (not completion) so a tenant cannot
        burst ahead of its share by stacking in-flight batches."""
        self.vtime[name] = self.vtime.get(name, 0.0) + n / self.share(name)

    def promoted(self, name: str, head_arrival: float, now: float) -> bool:
        """Starvation bound: has this tenant's oldest queued request aged
        past ``starve_after``? Promoted groups sort into the top band."""
        return now - head_arrival >= self.starve_after

    def order_band(self, name: str, head_arrival: float, now: float) -> int:
        prio = self.priority(name)
        if prio > 0 and self.promoted(name, head_arrival, now):
            return 0
        return prio
