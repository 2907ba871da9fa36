"""OnlineHostEstimator: learn each host's ``HostProfile`` from the
measured stream instead of being told (``--host-profiles``).

DyPe's core claim is that schedules should be *discovered from
measurement*, not configured by hand — yet the cluster layer still makes
operators declare per-host scales while every ``CompletionReport``
already carries the signal: the worker measured its stage times against
physical truth, and ``stage_expected`` records what the controller's
belief predicted for the same stages. The measured/expected gap per
stage is a linear function of exactly the unknowns a ``HostProfile``
holds:

    measured[s] = exec_expected[s] * r_dev(s)  +  xfer_expected[s] * u

where ``r_dev`` is the host's execution-time ratio (truth/belief) for
the stage's device type and ``u`` the transfer-time ratio
(belief_bw / truth_bw). The estimator accumulates per-worker stage
observations and solves the ridge least-squares system over
(one ratio per device type seen, plus ``u``), with the prior pulling
every unknown toward 1.0 — the "this host matches my belief" null
hypothesis. Confidence comes from the usual stderr of the LS solution:
a profile is *published* only once every evidenced unknown has at least
``min_obs`` observations and a relative stderr at or under ``rel_tol``,
AND the estimate deviates from belief beyond ``dead_band`` — a healthy
fleet (ratios pinned at 1.0) never publishes anything.

Publication composes the learned ratios over the current belief (so the
loop also tracks *drift* of an already-declared or already-learned
profile) and resets the worker's observations: the next reports are
judged against the new belief, whose ratios should sit at 1.0.

The second job is **straggler gating**: while a host-level mismatch is
in flight (a 60x measured/expected ratio on every stage), feeding those
measurements to the per-stage ``StragglerMonitor``s would demote every
device on the host — the wrong diagnosis at the wrong granularity.
``observe_report`` returns True for a mismatched report; the Router
withholds exactly those from the monitors until the learned profile
lands (after which ratios return to ~1.0 and per-stage straggler
detection resumes, now against host-correct baselines).

Everything here is a deterministic function of the report stream, so
learned-profile publications are *derived* cluster events: replaying a
recorded run re-derives byte-identical decisions.

Plain single-threaded state driven by the host control loop, like the
monitors it gates.
"""
from __future__ import annotations

import collections
import dataclasses
import math

from ..core.device import UNIFORM_HOST, HostProfile

#: Solver key for the shared transfer-ratio unknown (not a device name).
_BW = "~bw"


def _gauss(m: list, b: list) -> list:
    """Solve ``m x = b`` in place (partial pivoting); tiny k (<= #device
    types + 1), so no numerics library needed."""
    k = len(b)
    for col in range(k):
        piv = max(range(col, k), key=lambda r: abs(m[r][col]))
        if abs(m[piv][col]) < 1e-30:
            continue                     # ridge keeps this unreachable
        m[col], m[piv] = m[piv], m[col]
        b[col], b[piv] = b[piv], b[col]
        inv = 1.0 / m[col][col]
        for r in range(k):
            if r == col:
                continue
            f = m[r][col] * inv
            if f == 0.0:
                continue
            for c in range(col, k):
                m[r][c] -= f * m[col][c]
            b[r] -= f * b[col]
    return [b[i] / m[i][i] if abs(m[i][i]) > 1e-30 else 1.0
            for i in range(k)]


@dataclasses.dataclass
class HostEstimate:
    """One worker's solved state: ``ratios[dev]`` is the estimated
    truth/belief execution-time ratio per device type, ``bw_ratio`` the
    transfer-time ratio (belief_bw / truth_bw; 1.0 and ``bw_evidence``
    False when no stage carried transfer time). ``rel_err`` is the max
    relative stderr over evidenced unknowns — the confidence bound the
    publish gate checks."""
    wid: str
    ratios: dict
    bw_ratio: float
    bw_evidence: bool
    n: int
    rel_err: float
    converged: bool


class OnlineHostEstimator:
    def __init__(self, *, min_obs: int = 4, rel_tol: float = 0.15,
                 dead_band: float = 0.10, ridge: float = 1e-6,
                 max_obs: int = 512):
        self.min_obs = min_obs
        self.rel_tol = rel_tol
        self.dead_band = dead_band
        self.ridge = ridge
        self.max_obs = max_obs
        # wid -> deque of (dev, exec_expected, xfer_expected, measured)
        self._obs: dict[str, collections.deque] = {}
        self._dirty: set[str] = set()
        self._cache: dict[str, HostEstimate] = {}
        self.beliefs: dict[str, HostProfile] = {}
        self.published: dict[str, HostProfile] = {}
        self.gated = 0                 # reports withheld from the monitors

    # -- ingest ----------------------------------------------------------------
    def observe_report(self, report) -> bool:
        """Feed one ``CompletionReport`` (sim-clock measurements); returns
        True when the report is *mismatched* against its belief
        expectations — the caller should withhold it from the straggler
        monitors, because host-level slowness explains the drift."""
        wid = getattr(report, "worker", "")
        expected = getattr(report, "stage_expected", ())
        if not wid or not expected:
            return False
        return self._ingest(wid, [(d, e, x, m) for (d, e, x), m
                                  in zip(expected, report.measured)])

    def observe_stages(self, wid: str, stage_devs, expected,
                       measured) -> bool:
        """Feed calibrated per-stage times with total-seconds expectations
        (the ``WallClockCalibrator`` path — no exec/transfer split, so the
        whole stage is attributed to execution). Same return contract as
        ``observe_report``."""
        if not wid:
            return False
        return self._ingest(wid, [(d, e, 0.0, m) for d, e, m
                                  in zip(stage_devs, expected, measured)])

    def _ingest(self, wid: str, rows) -> bool:
        q = self._obs.setdefault(
            wid, collections.deque(maxlen=self.max_obs))
        mismatch = False
        for dev, e, x, m in rows:
            tot = e + x
            if tot <= 1e-12:
                continue               # degenerate stage: no signal
            q.append((dev, float(e), float(x), float(m)))
            ratio = m / tot
            if not (1.0 / (1.0 + self.dead_band) <= ratio
                    <= 1.0 + self.dead_band):
                mismatch = True
        if rows:
            self._dirty.add(wid)
        if mismatch:
            self.gated += 1
        return mismatch

    # -- solve -----------------------------------------------------------------
    def estimate(self, wid: str) -> HostEstimate | None:
        """Current least-squares solution for one worker (cached until new
        observations arrive); None before any usable observation."""
        if wid not in self._dirty and wid in self._cache:
            return self._cache[wid]
        obs = self._obs.get(wid)
        if not obs:
            return None
        est = self._solve(wid, list(obs))
        self._cache[wid] = est
        self._dirty.discard(wid)
        return est

    def _solve(self, wid: str, obs: list) -> HostEstimate:
        devs = sorted({d for d, _, _, _ in obs})
        unknowns = devs + [_BW]
        k = len(unknowns)
        idx = {u: i for i, u in enumerate(unknowns)}
        m = [[0.0] * k for _ in range(k)]
        b = [0.0] * k
        counts = {u: 0 for u in unknowns}
        for dev, e, x, y in obs:
            i, j = idx[dev], k - 1
            m[i][i] += e * e
            m[i][j] += e * x
            m[j][i] += e * x
            m[j][j] += x * x
            b[i] += e * y
            b[j] += x * y
            counts[dev] += 1
            if x > 1e-12:
                counts[_BW] += 1
        # ridge prior toward 1.0 ("host matches belief"), scaled to the
        # normal matrix so it regularizes without biasing strong evidence;
        # it also pins unevidenced unknowns (no transfer stages) at 1.0
        lam = self.ridge * max(max(m[i][i] for i in range(k)), 1e-12)
        for i in range(k):
            m[i][i] += lam
            b[i] += lam
        theta = _gauss([row[:] for row in m], b[:])
        sse = 0.0
        for dev, e, x, y in obs:
            pred = e * theta[idx[dev]] + x * theta[k - 1]
            sse += (y - pred) ** 2
        sigma2 = sse / max(len(obs) - k, 1)
        errs = {}
        for u, i in idx.items():
            ei = [0.0] * k
            ei[i] = 1.0
            z = _gauss([row[:] for row in m], ei)
            errs[u] = math.sqrt(max(sigma2 * z[i], 0.0))
        evidenced = [u for u in unknowns if counts[u] >= self.min_obs]
        rel = max((errs[u] / max(abs(theta[idx[u]]), 1e-12)
                   for u in evidenced), default=math.inf)
        bw_evidence = counts[_BW] >= self.min_obs
        converged = (all(counts[d] >= self.min_obs for d in devs)
                     and bool(devs) and rel <= self.rel_tol)
        return HostEstimate(
            wid=wid,
            ratios={d: theta[idx[d]] for d in devs},
            bw_ratio=theta[k - 1], bw_evidence=bw_evidence,
            n=len(obs), rel_err=rel, converged=converged)

    # -- publish gate ----------------------------------------------------------
    def publishable(self, wid: str) -> HostProfile | None:
        """The learned ``HostProfile`` ready to publish for ``wid``, or
        None: requires a converged estimate that deviates from the current
        belief beyond ``dead_band`` (so a healthy fleet never publishes,
        and a just-published profile goes quiet until genuine new drift).
        The returned profile is the estimate composed over the belief —
        absolute truth physics, directly comparable to a declared
        profile."""
        est = self.estimate(wid)
        if est is None or not est.converged:
            return None
        off = any(abs(r - 1.0) > self.dead_band
                  for r in est.ratios.values())
        if est.bw_evidence and abs(est.bw_ratio - 1.0) > self.dead_band:
            off = True
        if not off:
            return None
        belief = self.beliefs.get(wid, UNIFORM_HOST)
        scales = {d: r * belief.device_scale(d)
                  for d, r in est.ratios.items()}
        # unobserved device types keep the belief's behavior
        for d, _ in belief.device_scales:
            scales.setdefault(d, belief.device_scale(d))
        bw = (belief.bw_scale / est.bw_ratio if est.bw_evidence
              else belief.bw_scale)
        vals = list(scales.values())
        # statistically indistinguishable per-device ratios collapse to a
        # uniform compute scale (the common uniformly-slow-host case)
        if vals and max(vals) - min(vals) <= 1e-3 * max(vals):
            return HostProfile(
                f"{wid}-learned", sum(vals) / len(vals), bw, ())
        cs = belief.compute_scale        # fallback for never-seen devices
        return HostProfile(
            f"{wid}-learned", cs, bw,
            tuple(sorted((d, v / cs) for d, v in scales.items())))

    def poll(self) -> list[tuple[str, HostProfile]]:
        """Every worker with a publishable profile right now (sorted by
        id, so publication order is deterministic)."""
        out = []
        for wid in sorted(self._obs):
            prof = self.publishable(wid)
            if prof is not None:
                out.append((wid, prof))
        return out

    def note_published(self, wid: str, profile: HostProfile) -> None:
        """The profile went live: it becomes the belief (the controller
        re-bakes schedules under it), and the evidence window resets —
        post-publication reports are expected back at ratio 1.0."""
        self.beliefs[wid] = profile
        self.published[wid] = profile
        self._obs.pop(wid, None)
        self._cache.pop(wid, None)
        self._dirty.discard(wid)

    # -- wiring ----------------------------------------------------------------
    def attach(self, router, controller):
        """Close the loop on a serving Router + cluster Controller: seed
        beliefs from the controller's registered (declared) profiles,
        register as the Router's estimator (report feed + straggler
        gating), and append a clock hook that pushes converged profiles
        through ``Controller.set_learned_profile`` — from where they flow
        into placement, DP re-solves, and steal decisions exactly like
        declared profiles."""
        for wid, link in controller.links.items():
            self.beliefs.setdefault(wid, link.profile)
        router.estimator = self

        def publish_tick(now: float):
            for wid, prof in self.poll():
                controller.set_learned_profile(wid, prof, now)
                self.note_published(wid, prof)
        router.clock_hooks.append(publish_tick)
        return self
