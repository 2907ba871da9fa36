"""Fleet power budget: a watts cap the ``ParetoGovernor`` enforces and
the cluster ``Controller`` consults for placement headroom.

Units follow ``core.energy_model``: watts throughout, simulated-clock
seconds for schedule times. The cap is a step function of simulated time
(``cap_schedule`` overrides — the chaos/property tests randomize these),
partitioned *equally* across the controller's active workers: a worker's
share is ``cap / n_active``, and placement prefers workers still under
their share. All watts here are *modeled* (operating-point energy x
throughput), never measured hardware — that is what makes every budget
decision a derived, byte-identically replayable event.
"""
from __future__ import annotations


class PowerBudget:
    """A fleet-wide cap in watts, with optional scheduled re-caps.

    ``cap_schedule`` is an iterable of ``(t, cap_w)`` pairs: from
    simulated time ``t`` onward the cap is ``cap_w`` (step function;
    the base ``cap_w`` applies before the first step). The governor
    publishes per-worker draw via ``note`` each tick; ``Controller.place``
    and ``Controller._best_host`` read ``worker_headroom`` to steer new
    cells and replicas toward workers with watts to spare.
    """

    def __init__(self, cap_w: float, *, cap_schedule=()):
        self.base_cap = float(cap_w)
        self.cap_schedule = tuple(sorted(
            (float(t), float(c)) for t, c in cap_schedule))
        #: wid -> modeled watts, published by the governor after each
        #: tick's enforcement pass (empty until the first tick)
        self.worker_watts: dict[str, float] = {}
        self._n_workers = 1

    def cap(self, now: float) -> float:
        """The cap in force at simulated time ``now``."""
        cap = self.base_cap
        for t, c in self.cap_schedule:
            if now + 1e-12 < t:
                break
            cap = c
        return cap

    def note(self, watts_by_worker: dict, n_workers: int | None = None):
        """Governor tick: publish the post-enforcement per-worker draw
        (and the active-worker count the equal partition divides by)."""
        self.worker_watts = dict(watts_by_worker)
        if n_workers:
            self._n_workers = n_workers

    def fleet_watts(self) -> float:
        return sum(self.worker_watts.values())

    def share(self, now: float) -> float:
        """One worker's equal slice of the fleet cap."""
        return self.cap(now) / max(1, self._n_workers)

    def headroom(self, now: float) -> float:
        """Fleet-level watts to spare (negative = over cap)."""
        return self.cap(now) - self.fleet_watts()

    def worker_headroom(self, now: float, wid: str) -> float:
        """Watts worker ``wid`` has left under its equal share."""
        return self.share(now) - self.worker_watts.get(wid, 0.0)

    def over(self, now: float) -> bool:
        return self.fleet_watts() > self.cap(now) + 1e-9
