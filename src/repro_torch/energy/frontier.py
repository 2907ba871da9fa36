"""Operating-point frontier: ``Scheduler.pareto()`` materialized into the
discrete, ordered menu the ``ParetoGovernor`` walks at runtime.

The DP scheduler exposes a *strictly* monotone Pareto front per workload
signature (descending throughput, descending energy/inference — see
``Scheduler.pareto``). This module turns each front entry into an
``OperatingPoint`` with the derived quantities the governor trades on:

  * ``watts``  — steady-state power of one serving replica at that point,
    ``energy [J/inf] x throughput [inf/s]`` (see
    ``core.energy_model.pipeline_power`` for the unit conventions);
  * ``frac``   — the point's throughput as a *floor*-quantized fraction of
    the front's maximum. Feeding ``frac`` to
    ``DynamicScheduler.set_target`` makes the balanced-mode DP selection
    (min energy subject to ``throughput >= frac x max``) re-derive exactly
    this point, so the governor's choice and the scheduler's cache agree
    on one schedule. Floor (not round) quantization keeps the chosen
    point itself feasible at its own fraction.

Index 0 is always the perf endpoint (``frac == 1.0``); the last index is
the energy endpoint. Downshifting = moving to a higher index.

Fronts are cached per ``(signature, pool, host-profile)`` — the same cell
key the DynamicScheduler caches schedules under — so a steady fleet pays
the endpoint enumeration once per cell, not once per tick.
"""
from __future__ import annotations

import dataclasses
import math

from ..core.dynamic import signature

#: frac quantization grid (must match DynamicScheduler.set_target's
#: round(..., 3) so floor-quantized values survive the round-trip)
FRAC_GRID = 1000


def quantize_frac(ratio: float) -> float:
    """Floor-quantize a throughput ratio onto the grid ``set_target``
    rounds to. Floor, not round: rounding up could demand more throughput
    than the point itself delivers, bouncing the balanced-mode selection
    to a faster, hungrier point."""
    return max(1.0 / FRAC_GRID, math.floor(ratio * FRAC_GRID) / FRAC_GRID)


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One rung of a signature's Pareto frontier (per serving replica)."""
    idx: int              # 0 = perf endpoint; increasing = cheaper/slower
    frac: float           # set_target knob reproducing this point
    throughput: float     # inferences / s
    energy: float         # J / inference
    watts: float          # energy x throughput (steady-state draw)
    devices: int          # devices the pipeline occupies
    mnemonic: str

    def dominates(self, other: "OperatingPoint") -> bool:
        return (self.throughput >= other.throughput
                and self.energy <= other.energy
                and (self.throughput > other.throughput
                     or self.energy < other.energy))


def materialize(scheduler, wl) -> tuple:
    """The workload's frontier as an ordered ``OperatingPoint`` tuple
    (index 0 = perf endpoint). Empty when the workload has no feasible
    pipeline on the scheduler's pool."""
    front = scheduler.pareto(wl)
    if not front:
        return ()
    max_thp = front[0]["throughput"]
    pts = []
    for i, d in enumerate(front):
        thp, e = d["throughput"], d["energy"]
        frac = 1.0 if i == 0 else quantize_frac(thp / max_thp)
        pts.append(OperatingPoint(
            idx=i, frac=frac, throughput=thp, energy=max(0.0, e),
            watts=max(0.0, e) * thp, devices=d["devices"],
            mnemonic=d["mnemonic"]))
    return tuple(pts)


class FrontierCache:
    """Per-(signature, pool, host) memo of materialized frontiers, built
    lazily from a ``DynamicScheduler``'s underlying DP scheduler. The
    host key is the ``HostProfile`` (hashable dataclass) or None, exactly
    mirroring the DynamicScheduler's schedule-cache cell key."""

    def __init__(self, dyn):
        self.dyn = dyn
        self._fronts: dict = {}

    def invalidate(self) -> None:
        """Pool resize / profile relearn: every cached front is stale."""
        self._fronts.clear()

    def frontier(self, wl, pool=None, host=None) -> tuple:
        pool = self.dyn._norm_pool(pool)
        host = None if (host is None or host.is_uniform) else host
        key = (signature(wl), pool, host)
        front = self._fronts.get(key)
        if front is None:
            sched = self.dyn._scheduler_for(pool, host)
            front = materialize(sched, wl)
            self._fronts[key] = front
        return front
