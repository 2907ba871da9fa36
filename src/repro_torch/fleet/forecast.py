"""ArrivalForecaster: short-horizon look-ahead on the offered-rate curve.

The ``LoadWatermarkPolicy`` is threshold-*reactive*: it flips perf/energy
mode only after the trailing-window rate has already crossed a watermark,
so every diurnal peak is served in the wrong mode for one detection lag
(and every flip costs a reschedule + redeploy mid-rush). The paper's §II
traffic-forecasting example is predictive; this module supplies the
forecast.

Mechanism: arrivals are bucketed on a fixed ``dt`` grid and smoothed
with Holt's double exponential smoothing — a level (EWMA of the bucket
rate) plus a trend (EWMA of the level's slope). The ``horizon``-ahead
forecast is ``level + trend * horizon``: on the rising edge of a diurnal
curve the trend is positive, so the forecast crosses the high watermark
roughly ``horizon`` seconds before the measured rate does — mode flips,
cell pre-warms, and worker unparks all happen *ahead* of the load. The
per-signature split (EWMA of each signature's bucket share, with a
sample workload kept per signature) is what lets the autoscaler pre-warm
the right cells, not just more cells.

Deterministic: state is a pure function of the observed arrival times
(bucket grid, not wall clock), so every decision taken on a forecast is
a *derived* event that replays identically. Single-threaded, driven by
the host control loop.
"""
from __future__ import annotations


class ArrivalForecaster:
    def __init__(self, *, horizon: float = 5.0, dt: float = 1.0,
                 alpha: float = 0.35, beta: float = 0.15,
                 warmup_buckets: int = 3):
        assert horizon >= 0.0 and dt > 0.0
        self.horizon = horizon
        self.dt = dt
        self.alpha = alpha                 # level smoothing
        self.beta = beta                   # trend smoothing
        self.warmup_buckets = warmup_buckets
        self.level: float | None = None    # requests/s
        self.trend = 0.0                   # requests/s per second
        self._t0 = 0.0                     # current bucket start
        self._n = 0                        # arrivals in current bucket
        self._buckets = 0                  # closed buckets so far
        # signature -> (rate EWMA over buckets, current-bucket count)
        self._sig_rate: dict = {}
        self._sig_n: dict = {}
        self._sig_wl: dict = {}            # signature -> sample workload

    # -- ingest ----------------------------------------------------------------
    def observe(self, t: float, wl=None, sig=None) -> None:
        """One arrival at simulated time ``t``; ``wl`` (plus its
        precomputed ``sig``nature, when the caller has one) feeds the
        per-signature heat ranking for cell pre-warming."""
        self._roll(t)
        self._n += 1
        if sig is None and wl is not None:
            from ..core.dynamic import signature
            sig = signature(wl)
        if sig is not None:
            self._sig_n[sig] = self._sig_n.get(sig, 0) + 1
            if wl is not None:
                self._sig_wl.setdefault(sig, wl)

    def _roll(self, now: float) -> None:
        """Close every bucket the clock has passed (empty ones included —
        silence is evidence of a falling rate, not missing data)."""
        while now >= self._t0 + self.dt:
            rate = self._n / self.dt
            if self.level is None:
                self.level = rate
            else:
                prev = self.level
                self.level = (self.alpha * rate
                              + (1 - self.alpha)
                              * (self.level + self.trend * self.dt))
                self.trend = (self.beta * (self.level - prev) / self.dt
                              + (1 - self.beta) * self.trend)
            for sig in set(self._sig_rate) | set(self._sig_n):
                r = self._sig_n.get(sig, 0) / self.dt
                old = self._sig_rate.get(sig, r)
                self._sig_rate[sig] = (self.alpha * r
                                       + (1 - self.alpha) * old)
            self._sig_n = {}
            self._n = 0
            self._t0 += self.dt
            self._buckets += 1

    # -- queries ---------------------------------------------------------------
    @property
    def warmed_up(self) -> bool:
        return self._buckets >= self.warmup_buckets

    def forecast(self, now: float, horizon: float | None = None) -> float:
        """Forecast offered rate (requests/s) at ``now + horizon``. Until
        the warmup buckets close it degrades to the current level (no
        trend extrapolation off a sliver of history)."""
        self._roll(now)
        if self.level is None:
            return 0.0
        if not self.warmed_up:
            return max(0.0, self.level)
        h = self.horizon if horizon is None else horizon
        return max(0.0, self.level + self.trend * h)

    def sig_rate(self, sig) -> float:
        """Smoothed arrival rate (requests/s) of one signature — the
        heat the governor ranks cells by (coldest downshift first)."""
        return self._sig_rate.get(sig, 0.0)

    def sig_forecast(self, now: float, sig,
                     horizon: float | None = None) -> float:
        """Per-signature forecast rate: the total ``forecast`` scaled by
        the signature's smoothed share of the offered load. The split is
        assumed stationary over the horizon (the trend lives in the
        total), which is exactly the assumption ``hot_signatures``'s
        ranking already makes."""
        total = self.forecast(now, horizon)
        if total <= 0.0:
            return 0.0
        rates = sum(self._sig_rate.values())
        if rates <= 0.0:
            return 0.0
        return total * self._sig_rate.get(sig, 0.0) / rates

    def signatures(self) -> list[tuple]:
        """Every (signature, sample workload) the stream has shown us,
        sorted by signature — the deterministic iteration order the
        ParetoGovernor walks when assigning operating points."""
        return [(sig, self._sig_wl[sig]) for sig in sorted(self._sig_wl)]

    def hot_signatures(self, k: int = 2) -> list[tuple]:
        """Top-``k`` (signature, sample workload) by smoothed arrival
        rate — the cells worth pre-warming ahead of a peak. Ties break on
        the signature itself, so the ranking is deterministic."""
        ranked = sorted(self._sig_rate.items(),
                        key=lambda it: (-it[1], it[0]))
        out = []
        for sig, _ in ranked[:k]:
            wl = self._sig_wl.get(sig)
            if wl is not None:
                out.append((sig, wl))
        return out
