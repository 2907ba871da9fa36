"""PredictiveAutoscaler: act on the forecast instead of the damage.

Three actions, all taken *ahead* of load off the ``ArrivalForecaster``
and all emitted as derived cluster events (replay re-derives them):

  * **cell pre-warming** — when forecast utilization approaches the
    serving watermark, the hottest signature cells are admitted to the
    Engine before their next batch arrives, so the peak's first requests
    skip the DP-solve + deploy latency instead of paying it at the worst
    moment.
  * **elastic worker scaling** — through the existing join/leave listener
    path: a worker is *parked* (its device pool leaves the DP, placement
    and steal skip it; the peer stays alive and heartbeating) when the
    forecast says the fleet is oversized, and unparked the moment the
    forecast crosses back up — capacity returns before the peak, not
    after the queue has built.
  * **mode pre-flip** — not here: wiring the forecaster into
    ``LoadWatermarkPolicy`` makes the perf/energy watermark comparison
    itself look-ahead (the policy flips ~horizon seconds earlier); the
    autoscaler only handles the actions the policy can't take.

Hysteresis: scaling actions respect a ``cooldown`` (a forecast
oscillating around a threshold cannot park/unpark every tick), parking
requires a *dry* worker (nothing in flight), and ``min_active`` workers
always stay unparked. Single-threaded, driven as a Router clock hook.
"""
from __future__ import annotations

from .forecast import ArrivalForecaster


class PredictiveAutoscaler:
    def __init__(self, forecaster: ArrivalForecaster, *,
                 prewarm: int = 1, up: float = 0.7, down: float = 0.25,
                 cooldown: float = 10.0, min_active: int = 1,
                 interval: float = 1.0):
        assert down < up
        self.forecaster = forecaster
        self.prewarm = prewarm         # hot signatures to keep resident
        self.up = up                   # forecast util to scale up at
        self.down = down               # forecast util to scale down at
        self.cooldown = cooldown       # min seconds between scale actions
        self.min_active = min_active
        self.interval = interval       # decision cadence (sim seconds)
        self.router = None
        self.controller = None
        self.actions: list[tuple] = []     # (t, action, wid/sig)
        self.last_util = 0.0
        self._last_tick = -float("inf")
        self._last_scale = -float("inf")

    def attach(self, router, controller):
        """Wire into a serving Router + cluster Controller as a clock
        hook (the same cadence the controller ticks on)."""
        self.router = router
        self.controller = controller
        router.clock_hooks.append(self.tick)
        return self

    # -- the decision tick -----------------------------------------------------
    def tick(self, now: float):
        if now - self._last_tick < self.interval - 1e-9:
            return None
        self._last_tick = now
        cap = self.router.capacity()
        if cap <= 0 or not self.forecaster.warmed_up:
            return None
        util = self.forecaster.forecast(now) / cap
        self.last_util = util
        if self.prewarm and util >= self.up:
            self._prewarm_hot(now)
        if now - self._last_scale >= self.cooldown - 1e-9:
            if util >= self.up:
                self._unpark_one(now, util)
            elif util <= self.down:
                self._park_one(now, util)
        return None

    def _prewarm_hot(self, now: float) -> None:
        warmed = False
        for sig, wl in self.forecaster.hot_signatures(self.prewarm):
            if self.router.prewarm(wl, now):
                warmed = True
                self.actions.append((now, "prewarm", sig))
                ctrl = self.controller
                if ctrl is not None:
                    from ..cluster.events import ClusterEvent
                    ctrl.events.append(ClusterEvent(
                        now, "autoscale", "",
                        {"action": "prewarm", "sig": str(sig)}))
        if warmed and self.controller is not None:
            # pre-warming targets *replicas* too: a freshly admitted hot
            # cell fans out to its replica set now, ahead of the peak,
            # instead of waiting for the controller's next tick
            hook = getattr(self.controller, "replicate_hot_cells", None)
            if hook is not None:
                hook(now)

    def _unpark_one(self, now: float, util: float) -> None:
        parked = sorted(l.wid for l in self.controller.links.values()
                        if l.alive and l.parked)
        if parked and self.controller.set_parked(
                parked[0], False, now, reason=f"util={util:.2f}"):
            self.actions.append((now, "unpark", parked[0]))
            self._last_scale = now

    def _park_one(self, now: float, util: float) -> None:
        active = [l for l in self.controller.links.values()
                  if l.alive and not l.parked]
        if len(active) <= self.min_active:
            return
        # only a dry worker parks (nothing in flight, busy clock passed);
        # highest id first, so the founding workers are the last to go
        cands = sorted((l.wid for l in active
                        if not l.sids and l.busy_est <= now + 1e-9),
                       reverse=True)
        if cands and self.controller.set_parked(
                cands[0], True, now, reason=f"util={util:.2f}"):
            self.actions.append((now, "park", cands[0]))
            self._last_scale = now
