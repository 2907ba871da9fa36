"""The port's energy governance (``repro_torch/energy/``: frontier
materialization, fleet power budget, Pareto governor) against the
reference's (tests/test_energy.py). Every watt and joule here is the DyPe
energy model's, on the simulated clock, in both packages."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from replay_harness import Scenario
from cluster_harness import assert_same_as_reference, pkg, replay

SWA_4K = (4096, 256)


def both(fn):
    """``fn(package)`` for the port and the reference."""
    return fn(pkg("repro_torch")), fn(pkg("repro"))


def fresh_dyn(p):
    return p.core.DynamicScheduler(p.core.paper_system("pcie4"), p.perf,
                                   mode="perf")


def share_pool(p, max_cells: int = 2) -> tuple:
    """The Engine's fair-share sub-pool, where serving frontiers live."""
    return tuple(math.ceil(c / max_cells)
                 for _, c in p.core.paper_system("pcie4").pools)


@pytest.fixture(scope="module")
def fronts():
    """The swa-4k frontier on the fair-share pool, from each package (the
    DP solves behind it take seconds, so the tests below share it)."""
    def front(p):
        wl = p.core.swa_transformer_workload(*SWA_4K)
        return p.energy.materialize(
            fresh_dyn(p)._scheduler_for(share_pool(p), None), wl)
    return dict(zip(("port", "ref"), both(front)))


def test_quantize_frac_matches_reference():
    ratios = (1.0, 0.999, 0.91149, 0.5004, 1e-9, 0.0, 2.5, 0.123456)
    got = [pkg("repro_torch").energy.quantize_frac(r) for r in ratios]
    assert got == [pkg("repro").energy.quantize_frac(r) for r in ratios]
    for r, q in zip(ratios, got):
        if r > 1.0:                    # above the grid: passed through
            continue
        assert q == round(min(1.0, max(q, 1e-3)), 3)
        assert q <= max(r, 1e-3) + 1e-12


def test_materialize_matches_reference(fronts):
    port, ref = fronts["port"], fronts["ref"]
    assert [dataclasses.astuple(p) for p in port] == \
        [dataclasses.astuple(p) for p in ref]
    assert len(port) >= 3 and port[0].frac == 1.0
    for a, b in zip(port, port[1:]):
        assert a.throughput > b.throughput and a.energy > b.energy
    for p in port:
        assert p.watts == pytest.approx(max(0.0, p.energy) * p.throughput)


def test_operating_point_dominates_as_reference():
    def dom(p):
        OP = p.energy.OperatingPoint
        a = OP(0, 1.0, 10.0, 5.0, 50.0, 3, "m")
        b = OP(1, 0.9, 9.0, 6.0, 54.0, 3, "m")
        return a.dominates(b), b.dominates(a), a.dominates(a)
    got, want = both(dom)
    assert got == want == (True, False, False)


def test_frontier_cache_keys_and_invalidation_as_reference():
    def cache(p):
        c = p.energy.FrontierCache(fresh_dyn(p))
        wl = p.core.gcn_workload(p.core.DATASETS["OA"])
        f1 = c.frontier(wl, pool=share_pool(p))
        same = c.frontier(wl, pool=share_pool(p)) is f1
        full = c.frontier(wl)
        c.invalidate()
        f2 = c.frontier(wl, pool=share_pool(p))
        return (same, full is f1, f2 is f1, f2 == f1,
                [dataclasses.astuple(x) for x in f1 + full])
    got, want = both(cache)
    assert got == want
    assert got[:4] == (True, False, False, True)


def test_set_target_pins_frontier_point_as_reference(fronts):
    def pin(p, front):
        dyn = fresh_dyn(p)
        wl = p.core.swa_transformer_workload(*SWA_4K)
        sig = p.core.signature(wl)
        cheap = front[-1]
        e0 = dyn.epoch
        out = [dyn.set_target(sig, cheap.frac), dyn.epoch - e0]
        res = dyn.submit(wl, pool=share_pool(p))
        out += [res.throughput, res.energy]
        out += [dyn.set_target(sig, None),
                dyn.submit(wl, pool=share_pool(p)).throughput]
        return out
    got = pin(pkg("repro_torch"), fronts["port"])
    assert got == pin(pkg("repro"), fronts["ref"])
    cheap = fronts["port"][-1]
    assert got[:2] == [True, 1]
    assert got[2] == pytest.approx(cheap.throughput)
    assert got[3] == pytest.approx(cheap.energy)
    assert got[5] == pytest.approx(fronts["port"][0].throughput)


def test_power_budget_matches_reference():
    def budget(p):
        b = p.energy.PowerBudget(1000.0, cap_schedule=((10.0, 600.0),
                                                       (20.0, 1200.0)))
        out = [b.cap(t) for t in (0.0, 10.0, 19.9, 25.0)]
        b.note({"w0": 300.0, "w1": 400.0}, n_workers=2)
        out += [b.fleet_watts(), b.headroom(0.0), b.over(10.0), b.over(0.0),
                b.share(0.0), b.worker_headroom(0.0, "w0"),
                b.worker_headroom(0.0, "w9")]
        return out
    got, want = both(budget)
    assert got == want == [1000.0, 600.0, 600.0, 1200.0, 700.0, 300.0,
                           True, False, 500.0, 200.0, 500.0]


def _front(p, energies=(5.0, 5.0, 5.0), watts=(50.0, 40.0, 30.0)):
    OP = p.energy.OperatingPoint
    return (OP(0, 1.0, 10.0, energies[0], watts[0], 3, "a"),
            OP(1, 0.8, 8.0, energies[1], watts[1], 3, "b"),
            OP(2, 0.6, 6.0, energies[2], watts[2], 2, "c"))


def _choice(pt_reason):
    pt, reason = pt_reason
    return (None if pt is None else pt.idx, reason)


@pytest.mark.parametrize("case", ["demand", "hysteresis", "slo"])
def test_governor_choice_matches_reference(case):
    """The cheapest clearing point, the hysteresis band on downshifts and
    the energy SLO filter (tests/test_energy.py's three decision tests),
    over a grid of demands, replica counts and current rungs."""
    def choices(p):
        G = p.energy.ParetoGovernor
        if case == "demand":
            g, front = G(headroom=1.0, hysteresis=0.0), _front(p)
        elif case == "hysteresis":
            g, front = G(headroom=1.0, hysteresis=0.5), _front(p)
        else:
            g = G(headroom=1.0, energy_slo_j=6.0)
            front = _front(p, (9.0, 6.0, 4.0), (90.0, 48.0, 24.0))
        return [_choice(g._desired(front, demand=d, replicas=r, cur=c))
                for d in (1.0, 4.0, 5.0, 7.5, 9.0, 9.5, 99.0)
                for r in (1, 2) for c in (None, 0, 2)]
    got, want = both(choices)
    assert got == want
    at = {(d, r, c): x for (d, r, c), x in zip(
        [(d, r, c) for d in (1.0, 4.0, 5.0, 7.5, 9.0, 9.5, 99.0)
         for r in (1, 2) for c in (None, 0, 2)], got)}
    if case == "demand":
        assert at[5.0, 1, None] == (2, "demand")
        assert at[9.0, 1, None][0] == 0 and at[99.0, 1, None][0] == 0
    elif case == "hysteresis":
        assert at[7.5, 1, 0][0] is None        # held by the band
        assert at[4.0, 1, 0][0] == 2 and at[9.0, 1, 2][0] == 0
    else:
        assert at[9.5, 1, None] == (1, "slo")


def test_sig_tag_matches_reference():
    def tags(p):
        return [p.energy.governor.sig_tag(p.core.signature(wl)) for wl in (
            p.core.gcn_workload(p.core.DATASETS["OA"]),
            p.core.swa_transformer_workload(1024, 512, layers=2))]
    got, want = both(tags)
    assert got == want


def test_governor_requires_forecaster():
    p = pkg("repro_torch")
    router = p.serving.Router(
        fresh_dyn(p), batcher=p.serving.SignatureBatcher(max_batch=4,
                                                         max_wait=0.25),
        policy=p.serving.LoadWatermarkPolicy(window=10.0))
    with pytest.raises(ValueError):
        p.energy.ParetoGovernor().attach(router)


def test_governed_local_run_matches_reference():
    """A governed single-host run on swa-4k traffic under a binding 360 W
    cap: equal snapshot fields and governor events in both packages; the
    sampled watts respect the cap."""
    def serve(p):
        sv = p.serving
        router = sv.Router(
            fresh_dyn(p), batcher=sv.SignatureBatcher(max_batch=16,
                                                      max_wait=0.25),
            policy=sv.LoadWatermarkPolicy(
                window=10.0, forecaster=p.fleet.ArrivalForecaster()))
        gov = p.energy.ParetoGovernor(budget=p.energy.PowerBudget(360.0))
        gov.attach(router)
        mix = (sv.MixItem("llm-swa-4k", "llm", 1.0,
                          p.core.swa_transformer_workload(*SWA_4K)),)
        snap = sv.TrafficSim(seed=3, duration=20.0, day=20.0,
                             peak_rate=16.0, trough_rate=16.0,
                             mix=mix).run(router)
        d = dataclasses.asdict(snap)
        for k in ("place_ms_p50", "place_ms_p99"):
            d.pop(k)
        return d, [dataclasses.astuple(e) for e in gov.events]
    (snap, events), want = both(serve)
    assert (snap, events) == want
    power = [e for e in events if e[1] == "power"]
    assert power and all(e[3]["watts"] <= 360.0 + 1e-9 for e in power)
    assert snap["watts_p95"] <= 360.0 + 1e-9
    assert snap["opoint_switches"] == sum(1 for e in events
                                          if e[1] == "opoint") > 0


@pytest.mark.parametrize("backend", ["analytic", "torch"])
def test_governed_cluster_matches_reference_and_replays(backend, tmp_path):
    """The documented governor command's stack (``--governor
    --forecast-horizon 5 --power-cap-w 700 --energy-slo-j 30``) on a
    2-worker cluster with a kill: the event log byte-identical to the
    reference's, on the analytic and the CPU torch backend, and the
    port's recording replays byte for byte."""
    from repro.cluster import ClusterEvent
    kw = (dict(backend="torch", backend_kw={"device": "cpu"})
          if backend == "torch" else {})
    sc = Scenario(governor=True, forecast=True, power_cap=700.0,
                  energy_slo=30.0, script=(ClusterEvent(9.0, "kill", "w1"),))
    ref, port = assert_same_as_reference(sc, tmp_path, **kw)
    kinds = port.cluster.events.kinds()
    assert "power" in kinds and "opoint" in kinds and "failure" in kinds
    assert port.snap.watts_mean == ref.snap.watts_mean > 0
    assert port.snap.joules_per_req == ref.snap.joules_per_req
    assert port.gov.last_cap == ref.gov.last_cap == 700.0
    replay(sc, port, tmp_path, **kw)
