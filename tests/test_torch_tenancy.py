"""The port's multi-tenant serving (``repro_torch/tenancy/``) and the
launcher's ``--tenants`` against the reference (tests/test_tenancy.py,
the tenant cells of benchmarks/scenario_matrix.py, docs/tenancy.md).

Each check gives the same inputs to both packages and compares the
results exactly: parsed specs, batch order and WFQ clocks, queue
admission, tenanted arrivals sample for sample, and whole tenanted
cluster runs (``cluster_harness.run``: byte-identical event JSONL,
equal snapshots but the wall-clock placement times, equal sorted
latencies). The torch backend runs with ``device="cpu"``; the ``cuda``
twins run the tenanted stream on the card and skip here."""
import dataclasses
import gc
import weakref
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from replay_harness import Scenario
from cluster_harness import (TENANTS_SLO, TORCH_CPU, _cli, _minus,
                             assert_same_as_reference,
                             delivered_nothing_cancelled, pkg)

REPO = Path(__file__).resolve().parent.parent
ROOTS = ("repro", "repro_torch")
#: benchmarks/scenario_matrix.py:48-52
TENANTS = "gold:0:1,bronze:2:3"


def both(fn):
    """``fn(package)`` on the reference and on the port; equal results."""
    ref, port = (fn(pkg(root)) for root in ROOTS)
    assert port == ref
    return port


def _req(p, rid, tenant, prio, arrival, deadline=None):
    return p.serving.Request(rid, p.serving.named_workload("gcn-arxiv"),
                             arrival, deadline=deadline, tenant=tenant,
                             priority=prio)


def _fill(p, queue, tenant, prio, n, t0=0.0, rid0=0, dt=0.001):
    for i in range(n):
        assert queue.admit(_req(p, rid0 + i, tenant, prio, t0 + i * dt), t0)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------
def test_parse_tenants_matches_reference():
    specs = ("gold:0:1:2.5,bronze:2:4", "t:1::", "t:1:2::7.5",
             " a:0 , b:1:2 ,", TENANTS, TENANTS_SLO)
    got = both(lambda p: [tuple(dataclasses.astuple(s)
                                for s in p.tenancy.parse_tenants(spec))
                          for spec in specs])
    spec_t = pkg("repro_torch").tenancy.TenantSpec
    assert pkg("repro_torch").tenancy.parse_tenants(specs[0]) == (
        spec_t("gold", 0, 1.0, 2.5), spec_t("bronze", 2, 4.0))
    assert got[1] == (("t", 1, 1.0, None, None),)
    assert got[2][0][4] == 7.5
    assert dataclasses.astuple(pkg("repro_torch").tenancy.DEFAULT_TENANT) \
        == dataclasses.astuple(pkg("repro").tenancy.DEFAULT_TENANT)


@pytest.mark.parametrize("bad", ["", "gold", ":0", "a:0,a:1", "a:x",
                                 "a:0:y"])
def test_parse_tenants_rejects_as_the_reference(bad):
    def err(p):
        with pytest.raises(ValueError) as e:
            p.tenancy.parse_tenants(bad)
        return str(e.value)
    both(err)


# ---------------------------------------------------------------------------
# dispatch ordering
# ---------------------------------------------------------------------------
def test_priority_ordering_under_contention_matches_reference():
    """Strict bands: young gold goes ahead of older bronze."""
    def order(p):
        man, bat = p.tenancy.build_tenancy(
            p.tenancy.parse_tenants("gold:0,bronze:2"))
        q = p.serving.RequestQueue()
        _fill(p, q, "bronze", 2, 4, t0=0.0, rid0=0)
        _fill(p, q, "gold", 0, 4, t0=0.5, rid0=100)
        return [[(r.rid, r.tenant) for r in bat.next_batch(q, 1.0).requests]
                for _ in range(2)], dict(man.vtime)
    batches, vtime = both(order)
    assert [t for _, t in batches[0]] == ["gold"] * 4
    assert [t for _, t in batches[1]] == ["bronze"] * 4
    assert vtime == {"gold": 4.0, "bronze": 4.0}


def test_wfq_shares_within_band_match_reference():
    """Same band, shares 1:3: the share-3 tenant forms 3x the batches."""
    def order(p):
        man, bat = p.tenancy.build_tenancy(
            p.tenancy.parse_tenants("a:0:1,b:0:3"))
        q = p.serving.RequestQueue()
        _fill(p, q, "a", 0, 64, t0=0.0, rid0=0)
        _fill(p, q, "b", 0, 192, t0=0.01, rid0=1000)
        seq = [bat.next_batch(q, now=10.0).requests[0].tenant
               for _ in range(8)]
        return seq, dict(man.vtime)
    seq, vtime = both(order)
    assert seq == ["a", "b", "b", "b", "a", "b", "b", "b"]
    assert vtime["a"] == pytest.approx(32.0)
    assert vtime["b"] == pytest.approx(32.0)


def test_no_cross_tenant_batch_mixing_matches_reference():
    def batches(p):
        man, bat = p.tenancy.build_tenancy(
            p.tenancy.parse_tenants("gold:0,bronze:2"))
        q = p.serving.RequestQueue()
        _fill(p, q, "gold", 0, 5, t0=0.0, rid0=0)
        _fill(p, q, "bronze", 2, 5, t0=0.0, rid0=100)
        out = []
        while len(q):
            out.append([(r.rid, r.tenant)
                        for r in bat.next_batch(q, now=1.0).requests])
        return out
    out = both(batches)
    assert all(len({t for _, t in b}) == 1 for b in out)
    assert [b[0][1] for b in out] == ["gold", "bronze"]


def test_starvation_promotion_is_ordering_only_as_the_reference():
    """An aged bronze group outranks young gold for dispatch but keeps its
    actual priority: it exerts no preemption pressure."""
    def probe(p):
        man, bat = p.tenancy.build_tenancy(
            p.tenancy.parse_tenants("gold:0,bronze:2"), starve_after=4.0)
        bands = (man.order_band("bronze", head_arrival=0.0, now=5.0),
                 man.order_band("bronze", head_arrival=0.0, now=3.0),
                 man.priority("bronze"), man.promoted("gold", 0.0, 5.0))
        q = p.serving.RequestQueue()
        _fill(p, q, "bronze", 2, 4, t0=0.0, rid0=0)
        _fill(p, q, "gold", 0, 4, t0=4.8, rid0=100)
        first = [r.tenant for r in bat.next_batch(q, now=5.0).requests]
        q2 = p.serving.RequestQueue()
        _fill(p, q2, "bronze", 2, 4, t0=0.0, rid0=200)
        prio, sig, grp = bat.blocked_pressure(q2, now=5.0,
                                              ready=lambda s, g: False)
        none = bat.blocked_pressure(q2, now=0.1, ready=lambda s, g: False)
        return bands, first, prio, [r.rid for r in grp], none
    bands, first, prio, rids, none = both(probe)
    assert bands == (0, 2, 2, True)
    assert first == ["bronze"] * 4
    assert prio == 2 and rids == [200, 201, 202, 203] and none is None


# ---------------------------------------------------------------------------
# admission: displacement + band-aware requeue
# ---------------------------------------------------------------------------
def test_priority_displacement_on_full_queue_matches_reference():
    def admit(p):
        q = p.serving.RequestQueue(max_depth=3)
        _fill(p, q, "bronze", 2, 3, t0=0.0, rid0=0)
        steps = [q.admit(_req(p, 100, "gold", 0, 1.0), now=1.0),
                 [r.rid for r in q.take_displaced()],
                 [r.rid for r in q.take_displaced()],
                 sorted(r.rid for r in q),
                 q.admit(_req(p, 101, "bronze", 2, 1.1), now=1.1),
                 q.admit(_req(p, 102, "gold", 0, 1.2, deadline=1.2),
                         now=1.2)]
        return steps, dataclasses.asdict(q.stats)
    steps, stats = both(admit)
    assert steps == [True, [2], [], [0, 1, 100], False, False]
    assert stats["displaced"] == 1 and stats["rejected_full"] == 1
    assert stats["rejected_deadline"] == 1


def test_requeue_preempted_batch_stays_behind_higher_band_as_reference():
    def requeue(p):
        q = p.serving.RequestQueue()
        _fill(p, q, "gold", 0, 2, t0=1.0, rid0=0)
        _fill(p, q, "bronze", 2, 1, t0=1.2, rid0=100)
        q.requeue([_req(p, 50, "bronze", 2, 0.5),
                   _req(p, 51, "bronze", 2, 0.6)])
        q2 = p.serving.RequestQueue()
        _fill(p, q2, "", 0, 2, t0=1.0, rid0=0)
        q2.requeue([_req(p, 50, "", 0, 0.5)])
        return [r.rid for r in q], [r.rid for r in q2]
    assert both(requeue) == ([0, 1, 50, 51, 100], [50, 0, 1])


def test_tenanted_arrivals_match_reference_sample_for_sample():
    """The tenant draw is a separate RNG position taken only when tenants
    are configured: the same seed gives the same arrivals, tenants and
    SLO deadlines in both packages, and an untenanted stream the same
    arrivals as before."""
    def arrivals(p, spec):
        specs = p.tenancy.parse_tenants(spec) if spec else ()
        sim = p.serving.TrafficSim(seed=0, duration=30.0, peak_rate=10.0,
                                   tenants=specs, deadline_slack=0.8)
        out = []
        for seed in range(4):
            rng = np.random.default_rng(seed)
            for t in np.arange(0.0, 3.0, sim.tick):
                out += [a.to_record() for a in
                        sim._tick_arrivals(rng, float(t), 40.0)]
        return out
    tenanted = both(lambda p: arrivals(p, TENANTS_SLO))
    plain = both(lambda p: arrivals(p, ""))
    assert {a["tenant"] for a in tenanted} == {"gold", "bronze"}
    gold = [a for a in tenanted if a["tenant"] == "gold"]
    assert all(a["deadline"] == pytest.approx(a["t"] + 2.5) for a in gold)
    assert all("tenant" not in a for a in plain)


# ---------------------------------------------------------------------------
# end to end: tenanted cluster runs through both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["analytic", "torch"])
def test_preemption_drains_without_dropping_matches_reference(backend,
                                                              tmp_path):
    """Preempted batches drain and requeue: with no SLOs every admitted
    request completes, in both packages alike, on either backend."""
    sc = Scenario(tenants="gold:0:1,bronze:2:9", duration=8.0, peak=20.0,
                  trough=16.0, use_swa_mix=True, starve_after=15.0)
    _, port = assert_same_as_reference(
        sc, tmp_path, **(TORCH_CPU if backend == "torch" else {}))
    assert port.snap.preemptions > 0
    assert port.snap.preempted_requests > 0
    assert port.snap.dropped == 0
    assert "preempt" in port.cluster.events.kinds()
    delivered_nothing_cancelled(port)


def test_per_tenant_slo_accounting_matches_reference(tmp_path):
    sc = Scenario(tenants=TENANTS_SLO, duration=8.0, peak=20.0, trough=16.0,
                  use_swa_mix=True, starve_after=15.0)
    _, port = assert_same_as_reference(sc, tmp_path)
    rows = port.snap.tenants
    assert set(rows) == {"gold", "bronze"}
    assert sum(t["completed"] for t in rows.values()) == port.snap.completed
    assert sum(t["dropped"] for t in rows.values()) == port.snap.dropped
    assert sum(t["preempted"] for t in rows.values()) == \
        port.snap.preempted_requests
    for t in rows.values():
        assert 0.0 <= t["deadline_miss_rate"] <= 1.0
        assert t["p99_latency"] >= t["p50_latency"] >= 0.0
        assert t["joules_per_req"] >= 0.0
    assert rows["gold"]["completed"] > 0


def test_lowest_class_starvation_bound_matches_reference(tmp_path):
    """Gold floods 90% of arrivals; promotion bounds bronze's tail."""
    base = dict(tenants="gold:0:9,bronze:2:1", duration=8.0, peak=20.0,
                trough=16.0, use_swa_mix=True)
    _, bounded = assert_same_as_reference(Scenario(**base, starve_after=2.0),
                                          tmp_path)
    _, starved = assert_same_as_reference(
        Scenario(**base, starve_after=1000.0), tmp_path)
    b = bounded.snap.tenants["bronze"]
    s = starved.snap.tenants["bronze"]
    assert b["completed"] > 0
    assert b["p99_latency"] <= s["p99_latency"]
    assert b["p99_latency"] <= 2.0 + 6.0


def test_untenanted_stack_reports_no_tenant_rows_as_reference(tmp_path):
    _, port = assert_same_as_reference(
        Scenario(duration=4.0, peak=8.0, trough=4.0), tmp_path)
    assert port.snap.tenants == {}
    assert port.snap.preemptions == 0


# ---------------------------------------------------------------------------
# the local torch backend: a preempted batch's future is dropped unread
# ---------------------------------------------------------------------------
#: phase 11's stream (chip_smoke.py STREAM_ARGV) with the TENANTS_SLO grid
TENANT_STREAM = ["--stream", "--duration", "120", "--day", "120",
                 "--peak-rate", "10", "--trough-rate", "0.5", "--fail-at",
                 "40", "--rejoin-at", "80", "--fail-count", "2",
                 "--calibrate-wall", "4", "--seed", "0", "--tenants",
                 TENANTS_SLO]


def _local_torch_tenanted(device, monkeypatch):
    """The tenanted phase-11 stream on the local torch backend; returns
    (snapshot, the calibrator, each future's weakref and whether it was
    resolved, the analytic run's snapshot)."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.runtime import TorchPipelineBackend

    futures = []
    real_submit = TorchPipelineBackend.submit

    def recording_submit(self, handle, batch, t0):
        fut = real_submit(self, handle, batch, t0)
        futures.append(fut)
        return fut

    monkeypatch.setattr(TorchPipelineBackend, "submit", recording_submit)
    argv = TENANT_STREAM + ["--backend", "torch"] + (
        ["--device", device] if device else [])
    router, _, snap, _ = serve_cli.run_stream(serve_cli.parse_args(argv))
    monkeypatch.undo()
    resolved = [f.done() for f in futures]
    refs = [weakref.ref(f) for f in futures]
    futures.clear()
    gc.collect()
    _, _, a_snap, _ = serve_cli.run_stream(serve_cli.parse_args(
        TENANT_STREAM))
    return router, snap, refs, resolved, a_snap


def _check_dropped_futures(router, snap, refs, resolved, a_snap):
    assert snap.preemptions == a_snap.preemptions >= 1
    assert snap.completed == a_snap.completed
    assert snap.tenants == a_snap.tenants
    unread = [r for r, done in zip(refs, resolved) if not done]
    # one unread future for each preempted batch, and none kept alive
    assert len(unread) == snap.preemptions
    assert all(r() is None for r in unread)
    # every other batch's future was resolved, so the calibrator (fed
    # from resolved reports only) never read a preempted one
    assert sum(resolved) == len(router.dispatches) - snap.preemptions
    fed = sum(st[0] for st in router.calibrator._state.values())
    assert 0 < fed <= sum(resolved)


def test_local_torch_preemption_drops_its_future_unread(monkeypatch):
    _check_dropped_futures(*_local_torch_tenanted("cpu", monkeypatch))


# ---------------------------------------------------------------------------
# the CLI: --tenants
# ---------------------------------------------------------------------------
AZURE = ["--stream", "--trace-in",
         str(REPO / "examples" / "traces" / "azure_llm_excerpt.jsonl")]


@pytest.mark.parametrize("argv", [
    pytest.param(AZURE + ["--tenants", TENANTS], id="documented"),
    pytest.param(TENANT_STREAM, id="phase-11-stream"),
    pytest.param(TENANT_STREAM + ["--no-preempt", "--starve-after", "2"],
                 id="no-preempt"),
])
def test_cli_tenants_matches_reference(argv):
    """The documented tenancy command (docs/tenancy.md:136-138), the
    phase-11 stream under the TENANTS_SLO grid and its no-preemption
    twin: the port's analytic and torch-CPU runs print what the
    reference prints, but for the wall lines and the backend's name."""
    ref = _cli("repro", tuple(argv))
    analytic = _cli("repro_torch", tuple(argv))
    on_torch = _cli("repro_torch", tuple(argv + ["--backend", "torch",
                                                 "--device", "cpu"]))
    assert _minus(analytic) == _minus(ref)
    assert _minus(on_torch) == _minus(ref)
    assert any(line.startswith("[serve] tenant gold:") for line in on_torch)
    preempts = [line for line in on_torch
                if line.startswith("[serve] preemptions=")]
    assert len(preempts) == ("--no-preempt" not in argv)
    if argv[:3] == AZURE:
        assert "[serve] completed=2000 dropped=0 thp=35.04 req/s" in on_torch


@pytest.mark.parametrize("extra", [
    ["--no-preempt"], ["--tenants", "gold"], ["--tenants", "a:0,a:1"],
    ["--tenants", "a:x"],
])
def test_cli_tenant_checks_match_reference(extra, capsys):
    argv = ["--stream", "--duration", "5"] + extra
    for root in ROOTS:
        with pytest.raises(SystemExit) as e:
            _cli(root, tuple(argv))
        assert e.value.code == 2
    errors = [line.split("error:")[1]
              for line in capsys.readouterr().err.splitlines()
              if "error:" in line]
    assert len(errors) == 2 and errors[0] == errors[1]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_local_tenanted_stream_matches_analytic(cuda, monkeypatch):
    from repro_torch.kernels import spmm_csr_rows
    spmm_csr_rows.launches = 0
    router, *rest = _local_torch_tenanted(None, monkeypatch)
    assert router.engine.backend.device.type == "cuda"
    assert spmm_csr_rows.launches > 0
    _check_dropped_futures(router, *rest)


@pytest.mark.cuda
def test_cuda_tenanted_cluster_matches_reference(cuda, tmp_path):
    from repro_torch.kernels import spmm_csr_rows
    spmm_csr_rows.launches = 0
    sc = Scenario(tenants=TENANTS, duration=8.0, peak=24.0, trough=16.0,
                  use_energy_mix=True, n_workers=3,
                  kill_groups=((4.0, ("w1", "w2")),))
    _, port = assert_same_as_reference(sc, tmp_path, backend="torch")
    assert spmm_csr_rows.launches > 0
    for link in port.cluster.controller.links.values():
        assert link.peer.core.backend.device.type == "cuda"
    delivered_nothing_cancelled(port)
