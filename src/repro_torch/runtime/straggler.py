"""Straggler mitigation: per-stage EWMA timing monitor.

At 1000-node scale, persistent stragglers (bad HBM, thermal throttle,
noisy neighbor) show up as one pipeline stage's time drifting above its
schedule estimate. The monitor keeps an EWMA per stage and flags a stage
whose smoothed time exceeds ``threshold`` x its baseline for ``patience``
consecutive observations; the elastic runtime treats a flagged device pool
as reduced capacity and re-runs the DYPE DP (the paper's dynamicity applied
to system health, not just input data).

Observations are backend-*measured* per-stage seconds
(``CompletionReport.measured``), fed at reap time by the serving Router
(one observation per stage per completed batch) or by
``ElasticRuntime.execute`` — not the DP's analytic estimates, which are
only the baselines drift is judged against. The monitor is plain
single-threaded state driven by the host control loop; it is not
thread-safe and never blocks."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StageStat:
    ewma: float = 0.0
    baseline: float = 0.0
    strikes: int = 0
    n: int = 0


class StragglerMonitor:
    def __init__(self, n_stages: int, *, alpha: float = 0.2,
                 threshold: float = 1.5, patience: int = 3,
                 warmup: int = 5, baselines=None, threshold_scales=None):
        """``baselines``: per-stage expected times in seconds (e.g. the
        DYPE schedule's estimates). When given, drift is judged against the
        schedule's expectation immediately — no warmup against possibly-
        already-slow hardware. ``threshold_scales`` (optional, one float
        per stage) tightens/loosens the flag threshold per stage — the
        probation path re-admits a demoted device on a shorter leash by
        scaling its stages' thresholds below 1.0."""
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.threshold_scales = (tuple(threshold_scales)
                                 if threshold_scales is not None else None)
        self.stats = [StageStat() for _ in range(n_stages)]
        if baselines is not None:
            self.warmup = 0
            for s, b in zip(self.stats, baselines):
                s.baseline = float(b)
        else:
            self.warmup = warmup

    def observe(self, stage: int, t: float) -> bool:
        """Record one measured stage time (seconds); returns True if the
        stage is now flagged as a persistent straggler."""
        s = self.stats[stage]
        s.n += 1
        if s.n == 1:
            # start the EWMA from the schedule's expectation when we have
            # one, so a single spike decays instead of sticking
            s.ewma = ((1 - self.alpha) * s.baseline + self.alpha * t
                      if s.baseline > 0 else t)
        else:
            s.ewma = (1 - self.alpha) * s.ewma + self.alpha * t
        if s.n <= self.warmup:
            s.baseline = s.ewma
            return False
        if s.baseline <= 0:
            s.baseline = s.ewma
            return False
        thr = self.threshold
        if self.threshold_scales is not None and stage < len(
                self.threshold_scales):
            thr *= self.threshold_scales[stage]
        if s.ewma > thr * s.baseline:
            s.strikes += 1
        else:
            s.strikes = 0
            # slow baseline adaptation to genuine workload drift
            s.baseline = 0.95 * s.baseline + 0.05 * s.ewma
        return s.strikes >= self.patience

    def flagged(self):
        """Stage indices currently at or past the strike patience."""
        return [i for i, s in enumerate(self.stats)
                if s.strikes >= self.patience]


class WallClockCalibrator:
    """Rescales a wall-clock backend's measured stage times onto the
    simulated clock so they can drive straggler demotion (closing the
    ``measured_sim_clock`` gap: torch measurements were telemetry-only).

    The problem: torch reports *real wall seconds* per stage — a different
    scale from the schedule's simulated-second baselines, and a stage
    timed on the host clock may also hold host work (DP solves, other
    cells' first-use kernel builds) that ran between submit and reap.
    Judging raw wall times against model baselines would demote healthy
    devices.

    The fix is per-(cell, stage) calibration: skip the first ``skip``
    reports (first-use build dominated), average the next ``warmup`` reports'
    wall time per stage, and lock a per-stage scale

        scale[s] = mean_wall[s] / (baseline[s] * host_scale(stage dev))

    where ``host_scale`` comes from the host's ``HostProfile`` (a known-
    slow host's longer wall times are *expected*, not drift — without the
    profile term a 2x host would eat half the straggler headroom).
    Afterwards ``calibrate`` returns ``measured[s] / scale[s]``: on a
    healthy pipeline that reproduces the simulated baselines, and a stage
    that genuinely slows down by 4x wall-clock comes back as 4x its
    baseline — exactly what the ``StragglerMonitor`` knows how to judge.
    Stage-0 host-latency contamination is absorbed into stage 0's scale,
    so only *drift relative to the calibrated wall behavior* flags.

    Keyed per (engine cell id, executing worker id) by the Router —
    ``CompletionReport.worker`` is stamped by the executing host, so a
    stolen batch that ran on a different (differently-fast) host than
    the placement calibrates its own scale instead of polluting the
    owner's. Eviction/re-admission rebuilds the cell and restarts
    calibration (a fresh payload is coming). The key is opaque to
    the calibrator itself. Plain single-threaded state driven by the
    host control loop, like the monitor. Returns None while calibrating
    (callers skip the feed).

    With an ``estimator`` (``fleet.OnlineHostEstimator``), calibrated
    stage times are also forwarded as host observations keyed by the
    executing worker (``key[1]`` under the Router's (cell, worker)
    convention). Note the division of labor: the locked scale *absorbs*
    whatever host slowness existed during warmup, so on this wall-clock
    path the estimator only sees **post-calibration drift** — a host
    that degrades after deployment — while the sim-clock report path
    (``estimator.observe_report``) sees absolute truth-vs-belief ratios
    from the first report."""

    def __init__(self, *, warmup: int = 3, skip: int = 1, host=None,
                 estimator=None):
        assert warmup >= 1 and skip >= 0
        self.warmup = warmup
        self.skip = skip
        self.host = host               # optional core.device.HostProfile
        self.estimator = estimator     # optional fleet.OnlineHostEstimator
        self._state: dict = {}         # key -> [n_seen, per-stage sums|None]

    def _expected(self, baselines, stage_devs) -> list:
        """Per-stage expected wall seconds: the simulated baseline scaled
        by the host profile (identity without one)."""
        if self.host is None or stage_devs is None:
            return [max(b, 1e-12) for b in baselines]
        return [max(b, 1e-12) * self.host.device_scale(d)
                for b, d in zip(baselines, stage_devs)]

    def calibrate(self, key, measured, baselines,
                  stage_devs=None) -> tuple | None:
        """Feed one report's measured wall stage times for cell ``key``;
        returns simulated-clock-equivalent stage times once calibrated,
        None while still warming up. ``baselines`` are the schedule's
        per-stage simulated seconds; ``stage_devs`` the per-stage device
        names (for the host-profile term)."""
        st = self._state.setdefault(key, [0, None])
        st[0] += 1
        if st[0] <= self.skip:
            return None
        if st[0] <= self.skip + self.warmup:
            if st[1] is None:
                st[1] = [0.0] * len(measured)
            for i, t in enumerate(measured[:len(st[1])]):
                st[1][i] += t
            if st[0] < self.skip + self.warmup:
                return None
            # lock the per-stage scales now that the window is full
            exp = self._expected(baselines, stage_devs)
            st[1] = [max(s / self.warmup, 1e-12) / e
                     for s, e in zip(st[1], exp)]
        scales = st[1]
        out = tuple(t / s for t, s in zip(measured, scales))
        if self.estimator is not None and stage_devs is not None:
            wid = key[1] if isinstance(key, tuple) and len(key) > 1 else ""
            # whole-stage attribution (wall times carry no exec/transfer
            # split); a mismatch here means the host drifted after its
            # scale locked — withhold from the monitors like the sim path
            if self.estimator.observe_stages(wid, stage_devs,
                                             baselines, out):
                return None
        return out


class ProbationTracker:
    """Speculative re-admission of demoted devices (ROADMAP item).

    Demotion is capacity loss; a *transient* straggler (thermal spike,
    noisy neighbor that moved away) should not shrink the pool forever.
    The tracker keeps per-device-pool probation state across reschedules
    (monitors are rebuilt per schedule, so this must live one level up,
    in the Router/ElasticRuntime):

      * ``on_demotion(dev)`` — a device of pool ``dev`` was demoted.
        First offense: it enters the waiting room. If it was *already*
        re-admitted on probation, it is banned — flapping demote/re-admit
        cycles converge instead of oscillating. Returns False once banned.
      * ``on_clean()`` — one healthy completion (a report that fed the
        monitors without flagging anything) elapsed; after
        ``clean_epochs`` of these, a waiting device is due back. Returns
        the devices to re-admit (callers hand them to ``on_join``).
      * ``threshold_factor(dev)`` — re-admitted devices run at *reduced
        weight*: stages scheduled on them get their straggler threshold
        scaled by ``threshold_scale`` (< 1.0 = a shorter leash), so a
        still-sick device is re-demoted quickly — and then banned.
    """

    def __init__(self, clean_epochs: int = 8, threshold_scale: float = 0.75):
        assert clean_epochs >= 1
        assert 0.0 < threshold_scale <= 1.0
        self.clean_epochs = clean_epochs
        self.threshold_scale = threshold_scale
        # dev -> [clean epochs so far, devices demoted from that pool]:
        # several devices of one pool can demote during the window; each
        # must be re-admitted (on_clean repeats the pool per device)
        self.waiting: dict[str, list] = {}
        self.on_probation: set[str] = set()  # re-admitted, reduced weight
        self.banned: set[str] = set()        # flagged again on probation

    def on_demotion(self, dev: str) -> bool:
        """Record a demotion; returns False when the device is now banned
        (it relapsed on probation — do not re-admit it again)."""
        if dev in self.on_probation:
            self.on_probation.discard(dev)
            self.banned.add(dev)
            return False
        if dev in self.banned:
            return False
        if dev in self.waiting:
            # another device of the same pool: one more to re-admit, and
            # the clean window restarts (the pool just proved unhealthy)
            self.waiting[dev][0] = 0
            self.waiting[dev][1] += 1
        else:
            self.waiting[dev] = [0, 1]
        return True

    def on_clean(self) -> list[str]:
        """Count one clean epoch; returns the devices whose probation
        window just completed, one entry per demoted device (callers
        hand each entry to ``on_join(dev, 1)``)."""
        due = []
        for dev in sorted(self.waiting):
            self.waiting[dev][0] += 1
            if self.waiting[dev][0] >= self.clean_epochs:
                _, count = self.waiting.pop(dev)
                self.on_probation.add(dev)
                due.extend([dev] * count)
        return due

    def threshold_factor(self, dev: str) -> float:
        return self.threshold_scale if dev in self.on_probation else 1.0

    # -- shared Router / ElasticRuntime integration ---------------------------
    def handle_demotion(self, dev: str, log: list) -> None:
        """Record a demotion and log a relapse-ban (the one policy both
        the Router and ElasticRuntime apply before their ``on_failure``)."""
        if not self.on_demotion(dev):
            log.append(f"{dev} relapsed on probation; demoted for good")

    def readmit_due(self, manages, on_join, log: list) -> None:
        """Re-admit every device whose probation window just completed:
        one ``on_join(dev, 1)`` per demoted device, skipping pools the
        caller's elastic hooks don't manage (``manages(dev) -> bool``)."""
        for dev in self.on_clean():
            if manages(dev):
                log.append(f"probation: re-admitting {dev} "
                           f"at reduced weight")
                on_join(dev, 1)
