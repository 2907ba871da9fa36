"""The port's fleet management (``repro_torch/fleet/``: forecaster,
online host estimator, predictive autoscaler) against the reference's
(tests/test_fleet.py): each function fed the same inputs in both
packages gives the same answer, and the serving scenarios that use them
give the same cluster event log, byte for byte."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from replay_harness import Scenario
from cluster_harness import (assert_same_as_reference, pkg, replay, run,
                             snap_fields)

def fresh_dyn(p):
    return p.core.DynamicScheduler(p.core.paper_system("pcie4"), p.perf,
                                   mode="perf")


def oa(p):
    return p.core.gcn_workload(p.core.DATASETS["OA"])


def both(fn):
    """``fn(package)`` for the port and the reference."""
    return fn(pkg("repro_torch")), fn(pkg("repro"))


# ---------------------------------------------------------------------------
# relative_profile: the truth-vs-belief composition the workers apply
# ---------------------------------------------------------------------------
def test_relative_profile_composition_matches_reference():
    def stages(p):
        d = p.core.device
        truth = d.HostProfile("t", compute_scale=60.0, bw_scale=0.5,
                              device_scales=(("GPU", 2.0),))
        belief = d.HostProfile("b", compute_scale=4.0)
        assert d.relative_profile(truth, truth).is_uniform
        base = fresh_dyn(p).peek(oa(p))
        via = p.core.scheduler.apply_profile(
            p.core.scheduler.apply_profile(base, belief),
            d.relative_profile(truth, belief))
        return [(s.t_exec, s.t_in, s.t_out) for s in via.pipeline.stages]
    got, want = both(stages)
    assert got == want


# ---------------------------------------------------------------------------
# OnlineHostEstimator: solver, publish gate, dead band
# ---------------------------------------------------------------------------
def _feed(est, wid, *, r_gpu=1.0, r_fpga=1.0, u=1.0, n=6):
    """n synthetic two-stage observations with known ratios (as in
    tests/test_fleet.py)."""
    for i in range(n):
        e_g, x_g = 0.02 + 0.001 * i, 0.02 + 0.01 * (i % 2)
        e_f, x_f = 0.05 + 0.002 * i, 0.03 + 0.015 * (i % 3 == 0)
        est._ingest(wid, [("GPU", e_g, x_g, e_g * r_gpu + x_g * u),
                          ("FPGA", e_f, x_f, e_f * r_fpga + x_f * u)])


def _estimate(est, wid):
    e = est.estimate(wid)
    prof = est.publishable(wid)
    return (None if e is None else dataclasses.asdict(e),
            None if prof is None else prof.to_dict(), est.gated)


@pytest.mark.parametrize("ratios", [
    dict(r_gpu=60.0, r_fpga=60.0, u=2.0),      # exact recovery, bw term
    dict(r_gpu=6.0, r_fpga=1.0),               # per-device ratios
    dict(),                                    # healthy: never publishes
    dict(r_gpu=1.05, r_fpga=1.05, u=1.05),     # inside the dead band
])
def test_estimator_matches_reference(ratios):
    def estimate(p):
        est = p.fleet.OnlineHostEstimator()
        _feed(est, "w1", **ratios)
        return _estimate(est, "w1")
    got, want = both(estimate)
    assert got == want
    e, prof, gated = got
    assert e["converged"]
    if ratios.get("r_gpu", 1.0) > 2:
        assert prof is not None
        if ratios.get("r_fpga") == 60.0:
            assert prof["compute_scale"] == pytest.approx(60.0, rel=1e-3)
            assert prof["bw_scale"] == pytest.approx(0.5, rel=1e-2)
    else:
        assert prof is None and gated == 0


def test_estimator_composes_over_a_declared_belief_as_reference():
    def estimate(p):
        est = p.fleet.OnlineHostEstimator()
        est.beliefs["w1"] = p.core.HostProfile("b", compute_scale=2.0)
        _feed(est, "w1", r_gpu=60.0, r_fpga=60.0)
        return _estimate(est, "w1")
    got, want = both(estimate)
    assert got == want
    assert got[1]["compute_scale"] == pytest.approx(120.0, rel=1e-3)


def test_estimator_gates_mismatched_reports_as_reference():
    def gate(p):
        est = p.fleet.OnlineHostEstimator()
        out = [est._ingest("w1", [("GPU", 0.02, 0.0, 1.2)]),      # 60x
               est._ingest("w0", [("GPU", 0.02, 0.0, 0.0201)]), est.gated]
        _feed(est, "w1", r_gpu=60.0, r_fpga=60.0)
        prof = est.publishable("w1")
        est.note_published("w1", prof)
        out += [est.beliefs["w1"] is prof, est.estimate("w1"),
                prof.to_dict(), est.poll()]
        return out
    got, want = both(gate)
    assert got == want
    assert got[:3] == [True, False, 1] and got[4] is None


def test_calibrator_forwards_drift_to_estimator_as_reference():
    def drift(p):
        est = p.fleet.OnlineHostEstimator(min_obs=2)
        cal = p.runtime.WallClockCalibrator(warmup=1, skip=0, estimator=est)
        base, devs, key = [0.02, 0.05], ["FPGA", "GPU"], (0, "w1")
        return [cal.calibrate(key, [0.04, 0.10], base, devs),
                cal.calibrate(key, [0.04, 0.10], base, devs), est.gated,
                cal.calibrate(key, [0.08, 0.20], base, devs), est.gated]
    got, want = both(drift)
    assert got == want
    assert got[0] == pytest.approx((0.02, 0.05)) and got[3:] == [None, 1]


# ---------------------------------------------------------------------------
# ArrivalForecaster and the look-ahead policy
# ---------------------------------------------------------------------------
def _ramp(duration=40.0, slope=0.25):
    out, t = [], 1.0
    while t < duration:
        t += 1.0 / max(slope * t, 0.1)
        out.append(t)
    return out


def test_forecaster_tracks_ramp_and_ranks_signatures_as_reference():
    def track(p):
        fc = p.fleet.ArrivalForecaster(horizon=5.0)
        for t in _ramp():
            fc.observe(t)
        wl_l = p.core.swa_transformer_workload(1024, 512, layers=2)
        fc2 = p.fleet.ArrivalForecaster()
        for t in (1.0, 1.2, 1.4, 2.0, 3.0, 4.0, 5.0):
            fc2.observe(t, wl=oa(p))
        for t in (1.5, 3.5):
            fc2.observe(t, wl=wl_l)
        return ([fc.level, fc.trend, fc.warmed_up, fc.forecast(40.0),
                 fc.forecast(40.0, horizon=10.0)],
                [(sig, wl.name, fc2.sig_rate(sig), fc2.sig_forecast(6.0, sig))
                 for sig, wl in fc2.hot_signatures(2)])
    got, want = both(track)
    assert got == want
    (level, trend, warm, ahead, _), hot = got
    assert warm and trend > 0 and ahead > level
    assert hot and hot[0][1] == oa(pkg("repro_torch")).name


def test_lookahead_policy_flips_before_reactive_as_reference():
    arrivals = _ramp(duration=60.0)

    def flips(p):
        def first_perf(policy):
            fed = 0
            for now in range(1, 61):
                while fed < len(arrivals) and arrivals[fed] <= now:
                    policy.observe_arrival(arrivals[fed])
                    fed += 1
                policy.update(float(now), capacity=10.0)
                if policy.mode == "perf":
                    return now
            return None
        P = p.serving.LoadWatermarkPolicy
        return (first_perf(P(window=10.0, initial_mode="energy")),
                first_perf(P(window=10.0, initial_mode="energy",
                             forecaster=p.fleet.ArrivalForecaster(
                                 horizon=5.0))))
    got, want = both(flips)
    assert got == want
    assert got[1] < got[0]


# ---------------------------------------------------------------------------
# the serving loop: discovery, autoscaling, steal bound
# ---------------------------------------------------------------------------
SATURATING = dict(peak=24.0, trough=2.0)


def test_undeclared_slow_host_discovered_as_reference(tmp_path):
    sc = Scenario(truth=(("w1", 60.0),), learn=True, steal=True,
                  **SATURATING)
    ref, port = assert_same_as_reference(sc, tmp_path)
    prof = port.est.published.get("w1")
    assert prof is not None
    assert prof.to_dict() == ref.est.published["w1"].to_dict()
    assert prof.compute_scale == pytest.approx(60.0, rel=0.15)
    assert port.est.gated == ref.est.gated > 0
    learned = [e for e in port.cluster.events if e.kind == "learned-profile"]
    assert len(learned) == 1 and learned[0].worker == "w1"
    assert not any("straggler" in line for line in port.router.log)


def test_healthy_fleet_learning_is_a_noop_as_reference(tmp_path):
    sc = Scenario(**SATURATING)
    plain = run("repro_torch", sc)
    _, port = assert_same_as_reference(
        dataclasses.replace(sc, learn=True), tmp_path)
    assert snap_fields(port) == snap_fields(plain)
    assert port.est.published == {} and port.est.gated == 0


def test_autoscaler_parks_and_unparks_as_reference(tmp_path):
    sc = Scenario(autoscale=True, duration=30.0, **SATURATING)
    ref, port = assert_same_as_reference(sc, tmp_path)
    evs = [e for e in port.cluster.events if e.kind == "autoscale"]
    actions = [(e.detail["action"], e.worker) for e in evs]
    assert ("park", "w1") in actions and ("unpark", "w1") in actions
    assert port.scaler.actions == ref.scaler.actions
    assert port.scaler.last_util == ref.scaler.last_util
    assert not port.cluster.controller.links["w1"].parked
    for e in evs:                      # derived, never input
        assert e not in port.cluster.events.script()


def test_learned_autoscale_run_replays_byte_identically(tmp_path):
    sc = Scenario(truth=(("w1", 60.0),), learn=True, steal=True,
                  autoscale=True, cooldown=5.0, duration=30.0, **SATURATING)
    _, port = assert_same_as_reference(sc, tmp_path)
    kinds = port.cluster.events.kinds()
    assert "learned-profile" in kinds and "autoscale" in kinds
    assert port.cluster.events.script() == ()
    replay(sc, port, tmp_path)


def _busy_owner(p, steal):
    ctrl = p.cluster.Controller(
        profiles={"w0": p.core.HostProfile("s", 60.0)}, steal=steal,
        host_aware=False)
    for wid in ("w0", "w1"):
        ctrl.add_worker(wid, {"FPGA": 2, "GPU": 2},
                        p.runtime.AnalyticBackend())
    return ctrl


def test_steal_wait_bound_as_reference():
    def bounds(p):
        dyn = fresh_dyn(p)
        res = dyn.submit(oa(p))
        out = []
        for steal in (True, False):
            backend = p.runtime.ClusterBackend(_busy_owner(p, steal))
            handle = backend.prepare(res, oa(p), epoch=dyn.epoch)
            backend.submit(handle, 4, 0.0)
            out.append((handle.payload[0],
                        backend.est_wait_bound(handle, 0.5, 12.3)))
        return out
    got, want = both(bounds)
    assert got == want == [("w0", 0.0), ("w0", 12.3)]


def test_engine_est_wait_uses_steal_bound_as_reference():
    def waits(p):
        ctrl = _busy_owner(p, True)
        sv = p.serving
        router = sv.Router(fresh_dyn(p),
                           backend=p.runtime.ClusterBackend(ctrl),
                           batcher=sv.SignatureBatcher(max_batch=8,
                                                       max_wait=0.25),
                           policy=sv.LoadWatermarkPolicy(window=10.0))
        batch = type("B", (), {"wl": oa(p), "requests": [],
                               "__len__": lambda s: 4})()
        inf = router.engine.submit(batch, 0.0)
        inf.cell.busy_until = 5.0
        stolen = router.engine.est_wait(0.5, oa(p))
        ctrl.steal = False
        return stolen, router.engine.est_wait(0.5, oa(p))
    got, want = both(waits)
    assert got == want
    assert got[0] == 0.0 and got[1] == pytest.approx(4.5)


def test_learned_profile_places_like_declared_as_reference():
    def places(p):
        res = fresh_dyn(p).submit(oa(p))
        declared = p.cluster.Controller(
            profiles={"w1": p.core.HostProfile("s", 60.0)})
        learned = p.cluster.Controller()
        for ctrl in (declared, learned):
            ctrl.add_worker("w0", {"FPGA": 2, "GPU": 1},
                            p.runtime.AnalyticBackend())
            ctrl.add_worker("w1", {"FPGA": 1, "GPU": 1},
                            p.runtime.AnalyticBackend())
        learned.set_learned_profile(
            "w1", p.core.HostProfile("w1-learned", 60.0), 1.0)
        return ([learned.place(res) for _ in range(4)],
                [declared.place(res) for _ in range(4)],
                learned.events.kinds())
    got, want = both(places)
    assert got == want
    assert got[0] == got[1] and "learned-profile" in got[2]
