"""Tenant-aware batching: tenant-pure batches, priority + WFQ ordering.

``TenantBatcher`` extends the signature batcher with one stronger
invariant and one different ordering:

  * **No cross-tenant mixing.** Groups are keyed ``(tenant, signature)``
    instead of signature alone, so a batch never mixes priority bands —
    preempting a batch then only ever displaces one tenant's work (the
    rule "no cross-tenant batch mixing across priority bands", held at
    tenant granularity, which is strictly stronger).
  * **Dispatch order is (band, vtime, head arrival)** — strict priority
    bands first (with starvation-bound promotion, see
    :class:`~repro_torch.tenancy.wfq.TenantManager`), weighted fair queueing
    virtual time within a band, oldest head arrival as the tiebreak.

``blocked_pressure`` is the preemption trigger the Router polls: the
highest-priority group that is ready to dispatch (full or aged) but
blocked only by executor availability. Its *actual* priority is reported
— an aged, promotion-ordered bronze group exerts no preemption pressure.
"""
from __future__ import annotations

from ..serving.batcher import Batch, SignatureBatcher

from .wfq import TenantManager


class TenantBatcher(SignatureBatcher):
    def __init__(self, manager: TenantManager, max_batch: int = 16,
                 max_wait: float = 0.25):
        super().__init__(max_batch=max_batch, max_wait=max_wait)
        self.manager = manager

    def tenant_groups(self, queue):
        by_key: dict[tuple, list] = {}
        for req in queue:
            by_key.setdefault((req.tenant, self._sig(req)), []).append(req)
        return by_key

    def _order_key(self, now: float):
        man = self.manager

        def key(item):
            (tenant, sig), grp = item
            head = grp[0].arrival
            band = man.order_band(tenant, head, now)
            return (band, man.vtime.get(tenant, 0.0), head, tenant, sig)

        return key

    def next_batch(self, queue, now: float, ready=None):
        by_key = self.tenant_groups(queue)
        if not by_key:
            return None
        for (tenant, sig), grp in sorted(by_key.items(),
                                         key=self._order_key(now)):
            full = len(grp) >= self.max_batch
            aged = now - grp[0].arrival >= self.max_wait
            if not (full or aged):
                if ready is None:
                    return None
                continue
            if ready is not None and not ready(sig, grp):
                continue
            picked = grp[: self.max_batch]
            queue.take(picked)
            self.forget(picked)
            self.manager.charge(tenant, len(picked))
            return Batch(sig, picked)
        return None

    def blocked_pressure(self, queue, now: float, ready):
        """The strongest dispatchable-but-blocked group, or None.

        Returns ``(priority, sig, grp)`` for the highest-*actual*-priority
        group that is full/aged yet fails the executor ``ready`` gate —
        i.e. the group whose only obstacle is occupied capacity. The
        Router uses this to decide whether evicting a lower-priority
        in-flight batch would let higher-priority work run."""
        best = None
        for (tenant, sig), grp in self.tenant_groups(queue).items():
            full = len(grp) >= self.max_batch
            aged = now - grp[0].arrival >= self.max_wait
            if not (full or aged):
                continue
            if ready(sig, grp):
                continue
            prio = self.manager.priority(tenant)
            rank = (prio, grp[0].arrival, tenant, sig)
            if best is None or rank < best[0]:
                best = (rank, prio, sig, grp)
        if best is None:
            return None
        return best[1], best[2], best[3]
