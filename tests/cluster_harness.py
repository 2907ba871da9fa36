"""Shared helpers of the port's cluster tests (tests/test_torch_cluster*.py):
one function builds the serving + cluster stack of either package
(``repro`` or ``repro_torch``) from the same ``replay_harness.Scenario``,
the comparisons of a port run with the reference's, the fixed scenario
tables, the spawned torch worker's round trip, and the serve CLI run in
process with its documented cluster commands and the check of the
torch CLI against the analytic one. Not collected by pytest.

``pkg`` and ``_cli`` cache their results per process: the tests that
share a ``_cli`` run (the documented "learn" command) live in one file,
so that ``--dist loadfile`` runs them on one worker."""
import contextlib
import dataclasses
import functools
import importlib
import io
import re
import sys

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
#: benchmarks/scenario_matrix.py:48-52, with SLOs
TENANTS_SLO = "gold:0:1:2.5,bronze:2:9:15"


def delivered_nothing_cancelled(r) -> None:
    """No cancelled batch's report reached the controller: nothing is left
    pending there or held in a live worker's outbox after the drain."""
    ctrl = r.cluster.controller
    assert ctrl._pending == {}
    for link in ctrl.links.values():
        if link.alive:
            assert link.peer._held == []


def kill_scenario(t=6.0, **kw):
    from repro.cluster import ClusterEvent
    return Scenario(script=(ClusterEvent(t, "kill", "w1"),), **kw)


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


# The check of tests/test_torch_cluster*.py::test_cli_torch_cpu_cluster_
# matches_analytic, whose five commands run on torch's default threads
# (with one, the calibrated stage times met the load of other workers and
# flagged stragglers the analytic run has not) and so take long: its cases
# are spread over three files, each of which calls this.
def cli_torch_cpu_cluster_matches_analytic(name, tmp_path):
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
