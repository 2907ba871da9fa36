"""The port's multi-host control plane (``repro_torch/cluster/``,
``runtime/backend.py:ClusterBackend``) and ``launch/serve.py --stream
--cluster`` against the reference (tests/test_cluster.py,
test_hetero_cluster.py, test_replication.py, test_replay_properties.py).

The same scenario (``replay_harness.Scenario``: seed, pool, script,
traffic) goes through both packages' full stacks, built by one function
from either package's modules. Control-plane outputs are compared
exactly: the cluster event log's JSONL bytes and the ``MetricsSnapshot``
fields (but the wall-clock placement times, and on the torch backend the
measured stage seconds, which are real seconds there). The port's torch
backend runs with ``device="cpu"``; its ``cuda`` tests run the same
cluster on the card and skip here."""
import contextlib
import dataclasses
import functools
import importlib
import io
import re
import sys

import pytest

torch = pytest.importorskip("torch")

from replay_harness import Scenario

import repro.launch.serve as ref_serve_cli
from repro_torch.launch import serve as serve_cli

JOIN_POOL = {"FPGA": 1, "GPU": 1}


# ---------------------------------------------------------------------------
# one function builds the stack of either package
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def pkg(root: str):
    """The modules of one package (``repro`` or ``repro_torch``) that a
    serving + cluster stack is built from, and one fitted PerfModel."""
    mods = {n: importlib.import_module(f"{root}.{n}")
            for n in ("core", "cluster", "fleet", "energy", "serving",
                      "runtime", "tenancy", "obs")}
    mods["perf"] = mods["core"].PerfModel()
    return type(root, (), mods)


def mixes(p):
    core, MixItem = p.core, p.serving.MixItem
    oa = core.gcn_workload(core.DATASETS["OA"])
    return {
        "hot": (MixItem("gcn-arxiv", "gnn", 0.90, oa),
                MixItem("llm-swa-1k", "llm", 0.10,
                        core.swa_transformer_workload(1024, 512,
                                                      layers=2))),
        "energy": (MixItem("llm-swa-4k", "llm", 0.75,
                           core.swa_transformer_workload(4096, 256)),
                   MixItem("gcn-arxiv", "gnn", 0.25, oa)),
        "swa": (MixItem("llm-swa-4k", "llm", 1.0,
                        core.swa_transformer_workload(4096, 256)),),
    }


@dataclasses.dataclass
class Run:
    cluster: object
    router: object
    snap: object
    est: object = None
    scaler: object = None
    gov: object = None


def run(root: str, sc: Scenario, *, script=None, backend="analytic",
        backend_kw=None, calibrate: int = 0) -> Run:
    """``replay_harness.run_scenario`` on either package, tenancy and
    rack-scoped kill groups included. ``script`` overrides ``sc.script``
    (a recorded script already holds the kill groups' events);
    ``backend`` and ``backend_kw`` name each worker's local backend."""
    p = pkg(root)
    cl, fl, en, sv, rt = p.cluster, p.fleet, p.energy, p.serving, p.runtime
    if script is None:
        # the record run expands each kill group into simultaneous kills,
        # in replay_harness.run_scenario's order
        script = tuple(sorted(
            tuple(sc.script) + tuple(
                cl.ClusterEvent(t, "kill", w)
                for t, wids in sc.kill_groups for w in wids),
            key=lambda e: e.t))
    script = tuple(script)
    # the scenario's events are the reference's dataclass; rebuild them
    script = tuple(cl.ClusterEvent(e.t, e.kind, e.worker, dict(e.detail))
                   for e in script)
    system = p.core.paper_system("pcie4")
    cluster = cl.LocalCluster(
        system, sc.n_workers, backend=backend, backend_kw=backend_kw,
        profiles=dict(sc.profiles) or None,
        truth_profiles=dict(sc.truth) or None, steal=sc.steal,
        host_aware=sc.host_aware, perf=p.perf,
        replicate_hot=sc.replicate_hot, migrate=sc.migrate,
        hb_interval=sc.hb_interval, hb_timeout=sc.hb_timeout, script=script)
    need_fc = (sc.autoscale or sc.forecast or sc.replicate_hot >= 2
               or sc.governor)
    fc = fl.ArrivalForecaster() if need_fc else None
    est = fl.OnlineHostEstimator() if sc.learn else None
    specs = p.tenancy.parse_tenants(sc.tenants) if sc.tenants else ()
    if specs:
        manager, batcher = p.tenancy.build_tenancy(
            specs, preempt=sc.preempt, starve_after=sc.starve_after,
            max_batch=16, max_wait=sc.max_wait)
    else:
        manager = None
        batcher = sv.SignatureBatcher(max_batch=16, max_wait=sc.max_wait)
    router = sv.Router(
        p.core.DynamicScheduler(system, p.perf, mode="perf"),
        batcher=batcher,
        policy=sv.LoadWatermarkPolicy(window=sc.policy_window,
                                      forecaster=fc, cooldown=sc.cooldown),
        backend=cluster.backend(), async_mode=sc.async_mode,
        calibrator=(rt.WallClockCalibrator(warmup=calibrate, estimator=est)
                    if calibrate else None),
        tenancy=manager)
    cluster.attach(router)
    scaler = gov = None
    if est is not None:
        est.attach(router, cluster.controller)
    if sc.autoscale:
        scaler = fl.PredictiveAutoscaler(fc).attach(router,
                                                   cluster.controller)
    if sc.governor:
        budget = (en.PowerBudget(sc.power_cap, cap_schedule=sc.cap_schedule)
                  if sc.power_cap is not None else None)
        gov = en.ParetoGovernor(budget=budget, energy_slo_j=sc.energy_slo)
        gov.attach(router, cluster.controller)
    mix = (mixes(p)["hot"] if sc.use_hot_mix else
           mixes(p)["energy"] if sc.use_energy_mix else
           mixes(p)["swa"] if sc.use_swa_mix else None)
    sim = sv.TrafficSim(seed=sc.seed, duration=sc.duration, day=sc.duration,
                        peak_rate=sc.peak, trough_rate=sc.trough, mix=mix,
                        deadline_slack=sc.deadline_slack, tenants=specs,
                        bursts=tuple(sv.Burst(*b) for b in sc.bursts))
    snap = sim.run(router)
    return Run(cluster, router, snap, est, scaler, gov)


def log_bytes(r: Run, path) -> bytes:
    r.cluster.events.to_jsonl(path)
    return path.read_bytes()


def snap_fields(r: Run, *, measured: bool = True) -> dict:
    """The snapshot's fields but the wall-clock placement times; without
    ``measured``, also without the backend-measured stage seconds."""
    d = dataclasses.asdict(r.snap)
    for k in ("place_ms_p50", "place_ms_p99") + (
            () if measured else ("measured_stage_s",)):
        d.pop(k)
    return d


def assert_no_lost_requests(r: Run, *, dropped_ok: bool = False) -> None:
    """Every admitted request completed or dropped, nothing left queued or
    in flight; with ``dropped_ok`` False (no deadlines, no tenant
    admission control) nothing dropped either."""
    q = r.router.queue
    assert q.stats.admitted == r.snap.completed + r.snap.dropped
    if not dropped_ok:
        assert r.snap.dropped == 0
    assert len(q) == 0 and r.router.engine.inflight == []


def may_drop(sc: Scenario) -> bool:
    """Deadlines or tenant admission control may drop requests."""
    return bool(sc.tenants) or sc.deadline_slack is not None


def assert_same_as_reference(sc: Scenario, tmp_path, **kw) -> tuple:
    """The port's run of ``sc`` (with ``kw``'s backend) against the
    reference's analytic run: byte-identical event JSONL, equal snapshot
    fields and sorted latencies, zero lost requests on both."""
    ref = run("repro", sc)
    port = run("repro_torch", sc, **kw)
    assert_no_lost_requests(ref, dropped_ok=may_drop(sc))
    assert_no_lost_requests(port, dropped_ok=may_drop(sc))
    assert log_bytes(port, tmp_path / "port.jsonl") == \
        log_bytes(ref, tmp_path / "ref.jsonl")
    measured = kw.get("backend", "analytic") == "analytic"
    assert snap_fields(port, measured=measured) == \
        snap_fields(ref, measured=measured)
    assert sorted(port.router.metrics.latencies) == \
        sorted(ref.router.metrics.latencies)
    return ref, port


def replay(sc: Scenario, r: Run, tmp_path, **kw) -> Run:
    """Rerun ``sc`` in the port from ``r``'s recorded input script and
    hold the replay's log bytes and snapshot to the recording's."""
    cl = pkg("repro_torch").cluster
    path = tmp_path / "record.jsonl"
    recorded = log_bytes(r, path)
    script = cl.ClusterEventLog.from_jsonl(path).script()
    assert all(e.kind in cl.INPUT_KINDS for e in script)
    again = run("repro_torch", sc, script=script, **kw)
    assert_no_lost_requests(again, dropped_ok=may_drop(sc))
    assert log_bytes(again, tmp_path / "replay.jsonl") == recorded
    measured = kw.get("backend", "analytic") == "analytic"
    assert snap_fields(again, measured=measured) == \
        snap_fields(r, measured=measured)
    return again


TORCH_CPU = dict(backend="torch", backend_kw={"device": "cpu"})
def kill_scenario(t=6.0, **kw):
    from repro.cluster import ClusterEvent
    return Scenario(script=(ClusterEvent(t, "kill", "w1"),), **kw)


# ---------------------------------------------------------------------------
# events, transports, pool split, worker core
# ---------------------------------------------------------------------------
def _log_of(root):
    cl = pkg(root).cluster
    return cl.ClusterEventLog([
        cl.ClusterEvent(0.0, "register", "w0", {"pool": {"FPGA": 2}}),
        cl.ClusterEvent(6.0, "kill", "w0"),
        cl.ClusterEvent(7.5, "heartbeat-miss", "w0",
                        {"via": "heartbeat", "last_hb": 6.0}),
        cl.ClusterEvent(8.0, "latency", "w1", {"factor": 4.0}),
        cl.ClusterEvent(9.0, "join", "wj0", {"pool": dict(JOIN_POOL)}),
        cl.ClusterEvent(9.5, "steal", "w0", {"from": "w1", "sid": 3}),
    ])


def test_event_log_jsonl_roundtrip_and_script_keeps_input_kinds(tmp_path):
    log = _log_of("repro_torch")
    path = tmp_path / "events.jsonl"
    log.to_jsonl(path)
    back = pkg("repro_torch").cluster.ClusterEventLog.from_jsonl(path)
    assert list(back) == list(log)
    assert back.script() == (log.events[1], log.events[3], log.events[4])
    assert all(e.kind in pkg("repro_torch").cluster.INPUT_KINDS
               for e in back.script())
    ref_path = tmp_path / "ref.jsonl"
    _log_of("repro").to_jsonl(ref_path)
    assert path.read_bytes() == ref_path.read_bytes()
    assert pkg("repro_torch").cluster.INPUT_KINDS == \
        pkg("repro").cluster.INPUT_KINDS


def test_inproc_channel_fifo_roundtrip():
    a, b = pkg("repro_torch").cluster.inproc_pair()
    for i in range(3):
        a.send({"op": "ping", "echo": i})
    assert b.poll()
    assert [b.recv()["echo"] for _ in range(3)] == [0, 1, 2]
    assert b.recv() is None and not b.poll()
    b.send({"op": "pong"})
    assert a.recv()["op"] == "pong"


@pytest.mark.parametrize("n_workers", [1, 2, 3, 5, 8])
def test_split_pool_matches_reference(n_workers):
    got = pkg("repro_torch").cluster.split_pool(
        pkg("repro_torch").core.paper_system("pcie4"), n_workers)
    assert got == pkg("repro").cluster.split_pool(
        pkg("repro").core.paper_system("pcie4"), n_workers)
    if n_workers == 2:
        assert got == [{"FPGA": 2, "GPU": 1}, {"FPGA": 1, "GPU": 1}]


def _plain(reply: dict) -> dict:
    """A worker reply with its report as a plain dict."""
    return {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for k, v in reply.items()}


def _core_replies(root, truth):
    p = pkg(root)
    core_mod = p.core
    wl = core_mod.gcn_workload(core_mod.DATASETS["OA"])
    res = core_mod.DynamicScheduler(core_mod.paper_system("pcie4"), p.perf,
                                    mode="perf").submit(wl)
    truth_p = (core_mod.HostProfile("t", compute_scale=truth)
               if truth else None)
    core = p.cluster.WorkerCore("w", {"FPGA": 3, "GPU": 2},
                                truth_profile=truth_p)
    msgs = [{"op": "prepare", "hid": 0, "schedule": res, "workload": wl,
             "epoch": 0},
            {"op": "submit", "hid": 0, "sid": 0, "n": 2, "t0": 0.0},
            {"op": "latency", "factor": 4.0},
            {"op": "submit", "hid": 0, "sid": 1, "n": 3, "t0": 0.5},
            {"op": "hb", "now": 0.6},
            {"op": "cancel", "sid": 1, "now": 0.6},
            {"op": "hb", "now": 0.7},
            {"op": "ping", "echo": 7},
            {"op": "retire", "hid": 0},
            {"op": "stop"}]
    out = [[_plain(r) for r in core.handle(m)] for m in msgs]
    out.append([core.heartbeat(5.0), core.heartbeat(5.5)])
    return out, (core.busy_until, core.done, core.stage_s, core.handles)


@pytest.mark.parametrize("truth", [None, 60.0])
def test_worker_core_replies_match_reference(truth):
    """prepare / submit / latency / heartbeat / cancel / ping / retire
    through the port's WorkerCore and the reference's: equal replies,
    reports field for field, and equal counters after."""
    got, state = _core_replies("repro_torch", truth)
    want, ref_state = _core_replies("repro", truth)
    assert got == want
    assert state == ref_state
    assert got[1][1]["report"]["finishes"] == got[1][0]["finishes"]
    # latency injection scales the measured times only
    assert got[3][1]["report"]["measured_stage_times"] == pytest.approx(
        tuple(4.0 * t for t in got[3][1]["report"]["stage_times"]))


def test_worker_unknown_op_raises():
    core = pkg("repro_torch").cluster.WorkerCore("w", {"GPU": 1})
    with pytest.raises(ValueError, match="unknown op"):
        core.handle({"op": "bogus"})


# ---------------------------------------------------------------------------
# serving scenarios: the port against the reference
# ---------------------------------------------------------------------------
def test_kill_worker_mid_stream_matches_reference(tmp_path):
    sc = kill_scenario()
    ref, port = assert_same_as_reference(sc, tmp_path)
    kinds = port.cluster.events.kinds()
    assert "heartbeat-miss" in kinds and "failure" in kinds
    assert port.snap.requeued > 0
    assert port.cluster.cross_worker_overlap() == \
        ref.cluster.cross_worker_overlap() > 1.0
    assert any(e.reason == "resize" for e in port.router.dyn.events)
    assert port.cluster.events.script() == \
        tuple(pkg("repro_torch").cluster.ClusterEvent(e.t, e.kind, e.worker)
              for e in sc.script)


@pytest.mark.parametrize("backend", ["analytic", "torch"])
def test_record_then_replay_is_byte_identical(backend, tmp_path):
    kw = TORCH_CPU if backend == "torch" else {}
    sc = kill_scenario(steal=True, profiles=(("w0", 4.0),))
    r = run("repro_torch", sc, **kw)
    assert_no_lost_requests(r)
    replay(sc, r, tmp_path, **kw)


def _fixed_scripts():
    from repro.cluster import ClusterEvent
    return {
        "mixed": Scenario(
            script=(ClusterEvent(2.0, "latency", "w0", {"factor": 2.0}),
                    ClusterEvent(5.0, "join", "wj0",
                                 {"pool": dict(JOIN_POOL)}),
                    ClusterEvent(8.0, "kill", "w1")),
            steal=True, duration=14.0),
        "latency": Scenario(
            script=(ClusterEvent(0.0, "latency", "w0", {"factor": 4.0}),
                    ClusterEvent(0.0, "latency", "w1", {"factor": 4.0}))),
        "join": Scenario(
            script=(ClusterEvent(3.0, "join", "wj0",
                                 {"pool": dict(JOIN_POOL)}),)),
        "kill-late": kill_scenario(19.8),
        "power-capped": Scenario(
            governor=True, power_cap=750.0, cap_schedule=((12.0, 1200.0),),
            use_energy_mix=True, peak=64.0, trough=8.0, duration=18.0,
            script=(ClusterEvent(9.0, "kill", "w1"),)),
        "replicated": Scenario(replicate_hot=2, use_hot_mix=True, peak=64.0,
                               trough=8.0, duration=18.0),
    }


@pytest.mark.parametrize("name", sorted(_fixed_scripts()))
def test_fixed_scripts_match_reference_and_replay(name, tmp_path):
    """The fixed schedules of tests/test_replay_properties.py (kill, join,
    latency, power cap, replication) through both packages, then the
    port's record -> replay (test_torch_energy.py replays a capped run)."""
    sc = _fixed_scripts()[name]
    _, port = assert_same_as_reference(sc, tmp_path)
    if name != "power-capped":         # its DP frontiers take ~7 s a run
        replay(sc, port, tmp_path)
    if name == "latency":
        assert any("straggler flagged" in line for line in port.router.log)


@pytest.mark.parametrize("host_aware,steal",
                         [(True, False), (True, True), (False, True),
                          (False, False)])
def test_host_profiles_placement_and_steal_match_reference(
        host_aware, steal, tmp_path):
    """A declared 60x host (docs/heterogeneity.md), host-aware or
    oblivious, with and without stealing, on saturating traffic."""
    sc = Scenario(profiles=(("w1", 60.0),), host_aware=host_aware,
                  steal=steal, peak=24.0, trough=2.0)
    _, port = assert_same_as_reference(sc, tmp_path)
    steals = [e for e in port.cluster.events if e.kind == "steal"]
    assert len(steals) == port.snap.steals
    if steal and not host_aware:
        assert port.snap.steals > 5


def test_host_aware_placement_prefers_fast_worker():
    for root in ("repro", "repro_torch"):
        p = pkg(root)
        res = p.core.DynamicScheduler(p.core.paper_system("pcie4"), p.perf,
                                      mode="perf").submit(
            p.core.gcn_workload(p.core.DATASETS["OA"]))
        seqs = []
        for host_aware in (True, False):
            ctrl = p.cluster.Controller(
                profiles={"w1": p.core.HostProfile("slow-3x", 3.0)},
                host_aware=host_aware)
            ctrl.add_worker("w0", {"FPGA": 2, "GPU": 1},
                            p.runtime.AnalyticBackend())
            ctrl.add_worker("w1", {"FPGA": 1, "GPU": 1},
                            p.runtime.AnalyticBackend())
            seqs.append([ctrl.place(res) for _ in range(4)])
        assert seqs == [["w0", "w0", "w0", "w1"], ["w0", "w1", "w0", "w1"]]


@pytest.mark.parametrize("migrate", [False, True])
def test_replication_and_migration_match_reference(migrate, tmp_path):
    """Hot-cell replication, and live migration off a host learned slow
    (docs/cluster.md), through both packages."""
    sc = Scenario(replicate_hot=2, migrate=migrate, use_hot_mix=True,
                  truth=(("w1", 60.0),) if migrate else (),
                  learn=migrate, forecast=True, peak=64.0, trough=8.0,
                  duration=18.0)
    _, port = assert_same_as_reference(sc, tmp_path)
    kinds = port.cluster.events.kinds()
    assert "replicate" in kinds
    if migrate:
        assert "learned-profile" in kinds


@pytest.mark.parametrize("backend", ["analytic", "torch"])
def test_rack_kill_under_tenancy_matches_reference_and_replays(backend,
                                                               tmp_path):
    """The correlated-failure cell of benchmarks/scenario_matrix.py: two of
    three workers die at once under tenanted traffic; the kill group
    expands to simultaneous kill events in both packages, and the port's
    recorded log replays byte for byte."""
    kw = TORCH_CPU if backend == "torch" else {}
    sc = Scenario(tenants="gold:0:1,bronze:2:3", duration=8.0, peak=24.0,
                  trough=16.0, use_energy_mix=True, n_workers=3,
                  kill_groups=((4.0, ("w1", "w2")),))
    _, port = assert_same_as_reference(sc, tmp_path, **kw)
    kinds = port.cluster.events.kinds()
    assert kinds.count("kill") == 2 and "failure" in kinds
    assert set(port.snap.tenants) == {"gold", "bronze"}
    replay(sc, port, tmp_path, **kw)


# ---------------------------------------------------------------------------
# the port's torch backend behind the cluster (CPU here)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["kill", "steal"])
def test_torch_cpu_cluster_matches_reference_analytic(name, tmp_path):
    """Every worker a TorchPipelineBackend on the CPU: the event log is
    byte-identical to the reference's analytic one, and every report is
    measured."""
    sc = (kill_scenario() if name == "kill" else
          Scenario(profiles=(("w1", 60.0),), steal=True, peak=24.0,
                   trough=2.0))
    _, port = assert_same_as_reference(sc, tmp_path, **TORCH_CPU)
    for link in port.cluster.controller.links.values():
        be = link.peer.core.backend
        assert be.name == "torch" and be.device.type == "cpu"
        assert (link.peer.core.stage_s > 0) == (link.peer.core.done > 0)
    assert port.snap.measured_stage_s > 0
    assert not port.cluster.controller.measured_sim_clock


def test_torch_cluster_latency_injection_demotes_with_calibrated_wall():
    """Latency injection scales real seconds on the torch backend: with a
    wall calibrator (locked before the slowdown) the straggler monitors
    see it and a device is demoted, as the analytic cluster does without
    one (tests/test_cluster.py). Two signatures keep both cells resident,
    so their scales lock before t = 10."""
    from repro.cluster import ClusterEvent
    sc = Scenario(script=(ClusterEvent(10.0, "latency", "w0",
                                       {"factor": 50.0}),
                          ClusterEvent(10.0, "latency", "w1",
                                       {"factor": 50.0})),
                  duration=30.0, peak=8.0, trough=8.0, use_hot_mix=True)
    r = run("repro_torch", sc, calibrate=2, **TORCH_CPU)
    assert_no_lost_requests(r)
    assert any("straggler flagged" in line for line in r.router.log)
    assert any(e.reason == "resize" for e in r.router.dyn.events)


def test_local_cluster_torch_takes_the_device_of_backend_kw():
    p = pkg("repro_torch")
    cluster = p.cluster.LocalCluster(p.core.paper_system("pcie4"), 2,
                                     backend="torch",
                                     backend_kw={"device": "cpu"})
    assert [link.peer.core.backend.device.type
            for link in cluster.controller.links.values()] == ["cpu", "cpu"]
    assert isinstance(cluster.backend(), p.runtime.ClusterBackend)
    assert "cluster" not in p.runtime.backend.BACKENDS


def test_local_cluster_torch_without_a_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    p = pkg("repro_torch")
    with pytest.raises(RuntimeError, match="CUDA device"):
        p.cluster.LocalCluster(p.core.paper_system("pcie4"), 2,
                               backend="torch")


def _mp_roundtrip(backend_kw):
    """ping, prepare and a submit of 2 through a spawned worker process
    running the port's torch backend; returns the report, the analytic
    report of the same schedule and the child's exit code."""
    p = pkg("repro_torch")
    wl = p.core.gcn_workload(p.core.DATASETS["OA"])
    dyn = p.core.DynamicScheduler(p.core.paper_system("pcie4"), p.perf,
                                  mode="perf")
    res = dyn.submit(wl)
    chan, proc = p.cluster.mp_worker("mp0", {"FPGA": 3, "GPU": 2},
                                     backend="torch", backend_kw=backend_kw)
    try:
        chan.send({"op": "ping", "echo": 42})
        pong = chan.recv_wait(timeout=120.0)
        assert pong == {"op": "pong", "wid": "mp0", "echo": 42}
        chan.send({"op": "prepare", "hid": 0, "schedule": res,
                   "workload": wl, "epoch": dyn.epoch})
        assert chan.recv_wait(timeout=60.0)["op"] == "prepared"
        chan.send({"op": "submit", "hid": 0, "sid": 7, "n": 2, "t0": 1.0})
        acc = chan.recv_wait(timeout=60.0)
        assert acc["op"] == "accepted" and len(acc["finishes"]) == 2
        rep = chan.recv_wait(timeout=60.0)
        assert rep["op"] == "report" and rep["sid"] == 7
        assert "due" not in rep
        chan.send({"op": "stop"})
    finally:
        proc.join(timeout=60.0)
        if proc.is_alive():            # pragma: no cover - hang guard
            proc.terminate()
    local = p.runtime.AnalyticBackend()
    want = local.execute(local.prepare(res, wl), 2, 1.0)
    return rep["report"], want, proc.exitcode


def test_mp_worker_torch_cpu_roundtrip():
    rep, want, code = _mp_roundtrip({"device": "cpu"})
    assert rep.finishes == want.finishes
    assert rep.stage_times == want.stage_times
    assert rep.worker == "mp0"
    assert len(rep.measured_stage_times) == len(want.stage_times)
    assert all(t > 0 for t in rep.measured_stage_times)
    assert code == 0


# ---------------------------------------------------------------------------
# the CLI: serve --stream --cluster, the documented commands
# ---------------------------------------------------------------------------
BASE = ["--stream", "--duration", "120", "--day", "120", "--peak-rate", "10",
        "--trough-rate", "0.5", "--calibrate-wall", "4", "--seed", "0"]
DOCUMENTED = {
    "kill": ["--cluster", "2", "--kill-worker", "40"],
    "steal": ["--cluster", "2", "--host-profiles", "w1=60", "--steal"],
    "replicate": ["--cluster", "2", "--replicate-hot", "2",
                  "--forecast-horizon", "5", "--migrate"],
    "learn": ["--cluster", "2", "--peak-rate", "24", "--true-host-profiles",
              "w1=60", "--learn-profiles", "--steal"],
    "autoscale": ["--cluster", "2", "--autoscale", "--forecast-horizon", "5",
                  "--mode-cooldown", "5"],
    "governor": ["--duration", "60", "--cluster", "2", "--governor",
                 "--forecast-horizon", "5", "--power-cap-w", "700",
                 "--energy-slo-j", "30"],
}


@functools.lru_cache(maxsize=None)
def _cli(root: str, argv: tuple) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if root == "repro":
            saved = sys.argv
            sys.argv = ["serve"] + list(argv)
            try:
                ref_serve_cli.main()
            finally:
                sys.argv = saved
        else:
            serve_cli.main(list(argv))
    return tuple(out.getvalue().splitlines())


def _minus(lines, *, measured=True):
    """The output but its lines that hold "wall" or the backend's name,
    and, without ``measured``, with the workers' measured stage seconds
    blanked (real seconds on the torch backend)."""
    out = [line for line in lines
           if "wall" not in line and "backend=" not in line]
    if not measured:
        out = [re.sub(r"'stage_s': [0-9.e+-]+", "'stage_s': *", line)
               for line in out]
    return out


@pytest.mark.parametrize("name", sorted(DOCUMENTED))
def test_cli_documented_command_matches_reference(name, tmp_path):
    argv = BASE + DOCUMENTED[name]
    if name == "kill":
        argv = argv + ["--record-cluster-events", str(tmp_path / "e.jsonl")]
    port = _cli("repro_torch", tuple(argv))
    ref = _cli("repro", tuple(argv))
    assert port[0] == ref[0] == \
        "[serve] backend=cluster max_cells=2 dispatch=async"
    assert _minus(port) == _minus(ref)
    assert any(line.startswith("[serve] cluster: 2 workers") for line in port)
    assert any("event t=" in line for line in port)
    done = next(line for line in port if line.startswith("[serve] completed="))
    assert "dropped=0" in done


@pytest.mark.parametrize("name", ["kill", "steal", "replicate", "autoscale",
                                  "governor"])
def test_cli_torch_cpu_cluster_matches_analytic(name, tmp_path):
    """``--backend torch --device cpu`` on a cluster prints what the
    analytic backend prints, but for the wall lines and the workers'
    measured stage seconds; the recorded event logs are byte-identical,
    and a replay of the torch log on torch records it again."""
    paths = {k: tmp_path / f"{k}.jsonl" for k in ("a", "t", "r")}
    argv = BASE + DOCUMENTED[name]
    analytic = _cli("repro_torch", tuple(
        argv + ["--record-cluster-events", str(paths["a"])]))
    torch_out = _cli("repro_torch", tuple(
        argv + ["--backend", "torch", "--device", "cpu",
                "--record-cluster-events", str(paths["t"])]))

    def strip(lines, path):
        return [line for line in _minus(lines, measured=False)
                if line != f"[serve] cluster events -> {path}"]
    assert strip(torch_out, paths["t"]) == strip(analytic, paths["a"])
    assert paths["t"].read_bytes() == paths["a"].read_bytes()
    if name == "kill":
        assert any(line.startswith("[serve] requeued=")
                   for line in torch_out)
        # the recorded log holds the kill: replay it without --kill-worker
        plain = BASE + ["--cluster", "2"]
        _cli("repro_torch", tuple(
            plain + ["--backend", "torch", "--device", "cpu",
                     "--replay-cluster-events", str(paths["t"]),
                     "--record-cluster-events", str(paths["r"])]))
        assert paths["r"].read_bytes() == paths["t"].read_bytes()


def test_cli_learned_profiles_on_torch_lose_no_request():
    """The learned-profile command on the torch backend learns from real
    seconds, so what it publishes may differ from the analytic run (ROADMAP
    C); no request is lost either way."""
    argv = BASE + DOCUMENTED["learn"]
    out = _cli("repro_torch", tuple(argv + ["--backend", "torch",
                                            "--device", "cpu"]))
    analytic = _cli("repro_torch", tuple(argv))
    done = [next(line for line in lines
                 if line.startswith("[serve] completed=")).split()[1:3]
            for lines in (out, analytic)]
    assert done[0] == done[1] and done[0][1] == "dropped=0"
    assert any(line.startswith(("[serve] learned profile",
                                "[serve] learned profiles:"))
               for line in out)


def test_cli_kill_worker_on_one_worker_raises_as_the_reference():
    argv = BASE + ["--cluster", "1", "--kill-worker", "40"]
    with pytest.raises(SystemExit, match="empty the fleet"):
        _cli("repro", tuple(argv))
    with pytest.raises(SystemExit, match="empty the fleet"):
        _cli("repro_torch", tuple(argv))


@pytest.mark.parametrize("extra", [
    ["--kill-worker", "40"], ["--steal"], ["--learn-profiles"],
    ["--replicate-hot", "2"], ["--governor"],
    ["--cluster", "2", "--replicate-hot", "2"],
    ["--power-cap-w", "700"], ["--cluster", "2", "--host-profiles", "w1"],
])
def test_cli_flag_checks_match_reference(extra, capsys):
    argv = BASE + extra
    for root in ("repro", "repro_torch"):
        with pytest.raises(SystemExit) as e:
            _cli(root, tuple(argv))
        assert e.value.code == 2
    errors = [line.split("error:")[1]
              for line in capsys.readouterr().err.splitlines()
              if "error:" in line]
    assert len(errors) == 2 and errors[0] == errors[1]


def test_cli_cluster_torch_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve_cli.main(BASE + ["--cluster", "2", "--backend", "torch"])


def test_parse_host_profiles_matches_reference():
    spec = "w1=4, w2=2:0.5,"
    got = serve_cli.parse_host_profiles(spec)
    want = ref_serve_cli.parse_host_profiles(spec)
    assert {k: v.to_dict() for k, v in got.items()} == \
        {k: v.to_dict() for k, v in want.items()}
    for bad in ("w1", "=4", "w1=0", "w1=x"):
        with pytest.raises(ValueError, match="bad --host-profiles entry"):
            serve_cli.parse_host_profiles(bad)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_local_cluster_torch_matches_reference_analytic(cuda, tmp_path):
    from repro_torch.kernels import spmm_csr_rows
    spmm_csr_rows.launches = 0
    _, port = assert_same_as_reference(kill_scenario(), tmp_path,
                                       backend="torch")
    assert spmm_csr_rows.launches > 0
    for link in port.cluster.controller.links.values():
        assert link.peer.core.backend.device.type == "cuda"


@pytest.mark.cuda
def test_cuda_mp_worker_torch_roundtrip(cuda):
    rep, want, code = _mp_roundtrip(None)
    assert rep.finishes == want.finishes
    assert all(t > 0 for t in rep.measured_stage_times)
    assert code == 0
