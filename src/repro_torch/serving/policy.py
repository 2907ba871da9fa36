"""Load-watermark objective policy (paper §II traffic-forecasting example:
perf mode at peak hours, energy mode off-peak).

Load is measured as offered request rate over a sliding window, normalized
by the active schedule's sustainable throughput — i.e. utilization of the
pipeline. Two watermarks with hysteresis prevent mode thrash at the
boundary (every flip costs a reschedule + redeploy):

    util >= high_watermark  ->  'perf'   (serve the peak)
    util <= low_watermark   ->  'energy' (burn less off-peak)
    in between              ->  keep the current mode

Two optional upgrades:

  * ``forecaster`` (an ``ArrivalForecaster``) makes the policy
    *look-ahead*: the watermark comparison runs on the forecast rate at
    ``now + horizon`` instead of the trailing-window rate, so on a
    diurnal rising edge the flip to perf lands roughly one horizon
    *before* the measured rate crosses — the peak is served in the right
    mode from its first request. Arrivals observed here are forwarded,
    so the policy stays the single arrival feed.
  * ``cooldown`` bounds the flip rate outright: after any flip, further
    flips are suppressed for ``cooldown`` seconds. Watermark hysteresis
    handles a *noisy* utilization; the cooldown handles an *oscillating*
    one that genuinely crosses both watermarks faster than a
    reschedule + redeploy can pay for itself.
"""
from __future__ import annotations

import collections


class LoadWatermarkPolicy:
    def __init__(self, *, low: float = 0.3, high: float = 0.7,
                 window: float = 60.0, initial_mode: str = "perf",
                 forecaster=None, cooldown: float = 0.0):
        assert low < high, (low, high)
        self.low = low
        self.high = high
        self.window = window
        self.mode = initial_mode
        self.forecaster = forecaster
        self.cooldown = cooldown
        self._arrivals: collections.deque[float] = collections.deque()
        self.switches: list[tuple[float, str]] = []   # (t, new_mode)
        self._last_flip = -float("inf")

    def observe_arrival(self, t: float, wl=None) -> None:
        self._arrivals.append(t)
        if self.forecaster is not None:
            self.forecaster.observe(t, wl=wl)

    def offered_rate(self, now: float) -> float:
        """Arrivals per second over the trailing window."""
        w = self._arrivals
        while w and w[0] < now - self.window:
            w.popleft()
        span = min(self.window, now) or self.window
        return len(w) / span if span > 0 else 0.0

    def update(self, now: float, capacity: float) -> str:
        """``capacity``: requests/s the active schedule sustains (pipeline
        throughput). Returns the objective mode to serve under."""
        if capacity <= 0 or now < self.window:
            # no meaningful rate estimate until one full window has elapsed;
            # switching on a sliver of history just thrashes at startup
            return self.mode
        if self.forecaster is not None and self.forecaster.warmed_up:
            rate = self.forecaster.forecast(now)
        else:
            rate = self.offered_rate(now)
        util = rate / capacity
        new = self.mode
        if util >= self.high:
            new = "perf"
        elif util <= self.low:
            new = "energy"
        if new != self.mode and now - self._last_flip >= self.cooldown:
            self.mode = new
            self._last_flip = now
            self.switches.append((now, new))
        return self.mode
