"""The port's observability (``repro_torch/obs/``: trace, schema, FleetView,
dashboard) and the launcher's ``--trace-out``/``--dashboard*`` against
the reference (tests/test_obs.py, docs/observability.md).

Each check builds the same serving stack from either package (one
function, ``stack``), runs the same seeded traffic, and compares the
outputs exactly. What is masked, and why:

* every span's ``w0``/``w1`` and a ``place`` span's ``wall_ms``: wall
  clock, never equal between two runs;
* a frame's ``place_ms_p50``/``place_ms_p99``: wall-clock placement
  latency (``dashboard.py:build_frame``);
* on torch workers, a heartbeat span's ``stage_s`` and a frame worker
  row's ``busy_frac`` (``FleetView.occupancy`` reads ``stage_s``): real
  seconds on the device, where the analytic backend reports simulated
  ones. ``backlog_s`` reads the simulated busy clock and is compared.

The torch backend runs with ``device="cpu"``; the ``cuda`` twin runs the
observability quickstart on the card and skips here."""
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from cluster_harness import _cli, _minus, pkg

REPO = Path(__file__).resolve().parent.parent
ROOTS = ("repro", "repro_torch")
WALL_KEYS = ("w0", "w1", "wall_ms")
FRAME_WALL = ("place_ms_p50", "place_ms_p99")


def stack(root, *, sinks=(), tracer=None, cluster=False, script=(),
          profiles=None, steal=False, host_aware=True, backend="analytic",
          backend_kw=None, forecaster=False):
    """One package's Router (local, or behind a 2-worker LocalCluster as
    tests/test_obs.py builds it) with ``tracer``, else a Tracer over
    ``sinks``, else (no sinks) the router's default tracer."""
    p = pkg(root)
    system = p.core.paper_system("pcie4")
    if tracer is None and sinks:
        tracer = pkg(root).obs.Tracer(*sinks)
    fc = p.fleet.ArrivalForecaster() if forecaster else None
    lc = None
    kw = {}
    if cluster:
        lc = p.cluster.LocalCluster(
            system, 2, profiles=profiles, steal=steal, host_aware=host_aware,
            perf=p.perf, hb_interval=0.5, hb_timeout=1.5,
            backend=backend, backend_kw=backend_kw,
            script=tuple(p.cluster.ClusterEvent(*e) for e in script))
        kw["backend"] = lc.backend()
    router = p.serving.Router(
        p.core.DynamicScheduler(system, p.perf, mode="perf"),
        batcher=p.serving.SignatureBatcher(max_batch=16, max_wait=0.25),
        policy=p.serving.LoadWatermarkPolicy(window=10.0, forecaster=fc),
        tracer=tracer, **kw)
    if lc is not None:
        lc.attach(router)
    return lc, router


def sim(root, seed=3, duration=20.0, peak=8.0, trough=0.5, **kw):
    return pkg(root).serving.TrafficSim(seed=seed, duration=duration,
                                        day=duration, peak_rate=peak,
                                        trough_rate=trough, **kw)


def traced(root, *, sim_kw=None, extra_sinks=(), **kw):
    """A traced run; returns (records, cluster, router, snapshot)."""
    sink = pkg(root).obs.MemorySink()
    lc, router = stack(root, sinks=(sink,) + tuple(extra_sinks), **kw)
    snap = sim(root, **(sim_kw or {})).run(router)
    router.tracer.flush(router.metrics.t_last)
    return sink.records, lc, router, snap


def masked(records, *, measured=True):
    """Span records without their wall-clock fields; without ``measured``,
    also without the heartbeats' measured stage seconds."""
    drop = WALL_KEYS + (() if measured else ("stage_s",))
    return [{k: v for k, v in r.items() if k not in drop} for r in records]


def snap_fields(snap):
    d = dataclasses.asdict(snap)
    for k in FRAME_WALL:
        d.pop(k)
    return d


def mask_frame(frame, *, measured=True):
    f = {k: v for k, v in frame.items() if k not in FRAME_WALL}
    if not measured:
        f["workers"] = [{k: v for k, v in w.items() if k != "busy_frac"}
                        for w in frame["workers"]]
    return f


def both_traced(**kw):
    """The same traced run in both packages: equal masked spans and
    snapshots. Returns the two (records, cluster, router, snapshot)."""
    ref = traced("repro", **kw)
    port = traced("repro_torch", **kw)
    assert masked(port[0]) == masked(ref[0])
    assert snap_fields(port[3]) == snap_fields(ref[3])
    return ref, port


def validate_both(records):
    """The port's schema.validate and the reference's on one stream."""
    got = pkg("repro_torch").obs.validate(records)
    assert got == pkg("repro").obs.validate(records)
    return got


def spans_of(records, trace):
    return [r for r in records if r["trace"] == trace]


STEAL_HEAVY = dict(cluster=True, sim_kw=dict(peak=24.0, trough=2.0),
                   profiles={"w1": 60.0}, steal=True, host_aware=False)


# ---------------------------------------------------------------------------
# zero-cost disabled
# ---------------------------------------------------------------------------
def test_disabled_tracer_emits_zero_spans_as_reference():
    for root in ROOTS:
        o = pkg(root).obs
        sink = o.MemorySink()
        _, router = stack(root, tracer=o.Tracer(sink, enabled=False))
        sim(root).run(router)
        router.tracer.flush(router.metrics.t_last)
        assert sink.records == []
        assert stack(root, sinks=())[1].tracer is o.NULL_TRACER
        assert o.NULL_TRACER.sinks == [] and not o.NULL_TRACER.enabled


# ---------------------------------------------------------------------------
# schema: the port's validate against the reference's
# ---------------------------------------------------------------------------
def test_schema_constants_match_reference():
    r, p = pkg("repro").obs, pkg("repro_torch").obs
    assert p.REQUIRED_KEYS == r.REQUIRED_KEYS
    assert p.REQUEST_CHAIN == r.REQUEST_CHAIN
    sch = sys.modules["repro_torch.obs.schema"]
    ref_sch = sys.modules["repro.obs.schema"]
    assert (sch.STATUSES, sch.EPS) == (ref_sch.STATUSES, ref_sch.EPS)


def _corrupt(records, how):
    recs = [dict(r) for r in records]
    chain = [r for r in recs if r["name"] == "solve"]
    if how == "missing-key":
        del recs[0]["t1"]
    elif how == "span-not-int":
        recs[0]["span"] = "x"
    elif how == "parent-not-int":
        recs[0]["parent"] = 1.5
    elif how == "t1-before-t0":
        recs[0]["t1"] = recs[0]["t0"] - 1.0
    elif how == "duplicate-span":
        recs.append(dict(recs[0]))
    elif how == "unknown-parent":
        chain[0]["parent"] = 10 ** 9
    elif how == "two-roots":
        chain[0]["parent"] = None
    elif how == "bad-status":
        root = next(r for r in recs if r["name"] == "request")
        root["status"] = "lost"
    elif how == "out-of-order":
        chain[0]["t0"] = -1.0
    elif how == "missing-chain":
        recs.remove(chain[0])
    return recs


@pytest.mark.parametrize("how", [
    "clean", "missing-key", "span-not-int", "parent-not-int", "t1-before-t0",
    "duplicate-span", "unknown-parent", "two-roots", "bad-status",
    "out-of-order", "missing-chain"])
def test_validate_matches_reference_on_clean_and_broken_traces(how):
    """One traced stream, clean or broken in one way: the two validators
    give the same errors and stats."""
    records = traced("repro", sim_kw=dict(duration=6.0))[0]
    errors, stats = validate_both(_corrupt(records, how))
    assert (errors == []) == (how in ("clean", "missing-chain"))
    if how == "missing-chain":
        assert stats["coverage"] < 1.0


# ---------------------------------------------------------------------------
# coverage + causal ordering on the local and cluster paths
# ---------------------------------------------------------------------------
def test_local_diurnal_trace_schema_valid_full_coverage_as_reference():
    _, (records, _, _, snap) = both_traced()
    errors, stats = validate_both(records)
    assert errors == []
    assert stats["coverage"] == 1.0
    assert stats["request_statuses"].get("completed") == snap.completed
    for name in ("request", "admit", "solve", "submit", "reap"):
        assert stats["names"].get(name, 0) >= snap.completed


def test_traced_jsonl_round_trips_through_check_trace(tmp_path):
    """The port's JsonlTraceSink file: the port's read_jsonl gives the
    records the reference's gives, both validate it, and the reference's
    CI gate (tools/check_trace.py) accepts it."""
    path = tmp_path / "spans.jsonl"
    ref_path = tmp_path / "ref.jsonl"
    for root, out in (("repro_torch", path), ("repro", ref_path)):
        _, router = stack(root, sinks=(pkg(root).obs.JsonlTraceSink(out),))
        sim(root, duration=10.0).run(router)
        router.tracer.flush(router.metrics.t_last)
    records = pkg("repro_torch").obs.read_jsonl(path)
    assert records == pkg("repro").obs.read_jsonl(path)
    assert masked(records) == masked(pkg("repro").obs.read_jsonl(ref_path))
    errors, stats = validate_both(records)
    assert errors == [] and stats["coverage"] == 1.0
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "check_trace.py"),
         str(path), "--min-coverage", "0.99"],
        capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stdout


def test_rejected_and_expired_requests_close_their_roots_as_reference():
    _, (records, *_) = both_traced(
        sim_kw=dict(peak=24.0, trough=2.0, deadline_slack=0.4))
    errors, stats = validate_both(records)
    assert errors == []
    statuses = stats["request_statuses"]
    assert statuses.get("rejected", 0) + statuses.get("expired", 0) > 0
    assert "unfinished" not in statuses


# ---------------------------------------------------------------------------
# parent/child integrity across the steal and requeue paths
# ---------------------------------------------------------------------------
def test_steal_spans_parented_inside_request_traces_as_reference():
    _, (records, _, _, snap) = both_traced(**STEAL_HEAVY)
    assert snap.steals > 5
    errors, stats = validate_both(records)
    assert errors == [] and stats["coverage"] == 1.0
    per_req = [r for r in records if r["name"] == "steal"
               and r["trace"].startswith("r") and r["trace"][1:].isdigit()]
    assert per_req
    for s in per_req:
        root = [r for r in spans_of(records, s["trace"])
                if r["parent"] is None]
        assert len(root) == 1 and s["parent"] == root[0]["span"]
        assert s["frm"] != s["to"]
    assert len([r for r in records if r["name"] == "steal"
                and r["trace"].startswith("w:")]) == snap.steals


@pytest.mark.parametrize("backend", ["analytic", "torch"])
def test_requeue_spans_parented_and_requests_complete_as_reference(backend):
    kw = dict(cluster=True, script=((6.0, "kill", "w1"),))
    ref = traced("repro", **kw)
    if backend == "torch":
        kw.update(backend="torch", backend_kw={"device": "cpu"})
    records, _, _, snap = traced("repro_torch", **kw)
    assert masked(records, measured=False) == masked(ref[0], measured=False)
    assert snap.requeued > 0 and snap.dropped == 0
    errors, stats = validate_both(records)
    assert errors == [] and stats["coverage"] == 1.0
    requeues = [r for r in records if r["name"] == "requeue"]
    assert requeues
    for rq in requeues:
        trace = spans_of(records, rq["trace"])
        root = [r for r in trace if r["parent"] is None]
        assert len(root) == 1 and rq["parent"] == root[0]["span"]
        assert root[0]["status"] == "completed"
        reaps = [r["t0"] for r in trace if r["name"] == "reap"]
        assert reaps and max(reaps) >= rq["t0"]


# ---------------------------------------------------------------------------
# derived-not-input: replay determinism with tracing enabled
# ---------------------------------------------------------------------------
def test_traced_steal_heavy_run_replays_bit_identically(tmp_path):
    (_, ref_cluster, _, _), (records, cluster, _, snap) = \
        both_traced(**STEAL_HEAVY)
    path = tmp_path / "events.jsonl"
    cluster.events.to_jsonl(path)
    ref_cluster.events.to_jsonl(tmp_path / "ref.jsonl")
    assert path.read_bytes() == (tmp_path / "ref.jsonl").read_bytes()
    cl = pkg("repro_torch").cluster
    script = tuple((e.t, e.kind, e.worker, e.detail)
                   for e in cl.ClusterEventLog.from_jsonl(path).script())
    kw = dict(STEAL_HEAVY, script=script)
    records2, cluster2, _, snap2 = traced("repro_torch", **kw)
    assert snap2 == snap
    cluster2.events.to_jsonl(tmp_path / "replay.jsonl")
    assert (tmp_path / "replay.jsonl").read_bytes() == path.read_bytes()
    assert masked(records2) == masked(records)
    # an untraced replay records the same bytes too
    kw.pop("sim_kw")
    cluster3, router3 = stack("repro_torch", **kw)
    assert sim("repro_torch", peak=24.0, trough=2.0).run(router3) == snap
    cluster3.events.to_jsonl(tmp_path / "untraced.jsonl")
    assert (tmp_path / "untraced.jsonl").read_bytes() == path.read_bytes()


def test_tracing_does_not_change_simulated_telemetry():
    _, (_, _, _, traced_snap) = both_traced(cluster=True)
    _, router = stack("repro_torch", sinks=(), cluster=True)
    assert sim("repro_torch").run(router) == traced_snap


# ---------------------------------------------------------------------------
# worker-id stamping
# ---------------------------------------------------------------------------
def test_completion_reports_stamp_executing_worker_as_reference():
    _, (records, *_) = both_traced(cluster=True)
    workers = {r["worker"] for r in records if r["name"] == "reap"}
    assert workers == {"w0", "w1"}


def test_stolen_batch_reap_names_the_thief_as_reference():
    _, (records, _, _, snap) = both_traced(**STEAL_HEAVY)
    stolen = {r["trace"]: r["to"] for r in records if r["name"] == "steal"
              and r["trace"].startswith("r") and r["trace"][1:].isdigit()}
    checked = 0
    for trace, thief in stolen.items():
        reaps = [r for r in spans_of(records, trace) if r["name"] == "reap"]
        if len(reaps) == 1:
            assert reaps[0]["worker"] == thief
            checked += 1
    assert checked > 0


@pytest.mark.parametrize("backend", ["analytic", "torch"])
def test_local_backend_reports_carry_empty_worker_id(backend):
    p = pkg("repro_torch")
    wl = p.core.gcn_workload(p.core.DATASETS["OA"])
    res = p.core.DynamicScheduler(p.core.paper_system("pcie4"), p.perf,
                                  mode="perf").submit(wl)
    be = (p.runtime.AnalyticBackend() if backend == "analytic" else
          p.runtime.TorchPipelineBackend(device="cpu"))
    assert be.execute(be.prepare(res, wl), 4, 0.0).worker == ""


# ---------------------------------------------------------------------------
# MetricsSnapshot JSON round-trip + placement self-metrics
# ---------------------------------------------------------------------------
def test_metrics_snapshot_json_round_trip_as_reference():
    snaps = {}
    for root in ROOTS:
        _, router = stack(root, sinks=())
        snap = sim(root, duration=10.0).run(router)
        clone = type(snap).from_json(snap.to_json())
        assert clone == snap and clone.as_dict() == snap.as_dict()
        assert json.loads(snap.to_json())["placements"] == snap.placements
        snaps[root] = {k: v for k, v in json.loads(snap.to_json()).items()
                       if k not in FRAME_WALL}
    assert snaps["repro_torch"] == snaps["repro"]


def test_placement_latency_populates_snapshot():
    _, router = stack("repro_torch", sinks=())
    snap = sim("repro_torch", duration=10.0).run(router)
    assert snap.placements == len(router.dispatches) > 0
    assert 0.0 < snap.place_ms_p50 <= snap.place_ms_p99


def test_traffic_sim_periodic_snapshots_as_reference():
    rows = {}
    for root in ROOTS:
        _, router = stack(root, sinks=())
        s = sim(root, snapshot_every=5.0)
        final = s.run(router)
        assert len(s.snapshots) >= 4 and s.snapshots[-1] == final
        rows[root] = [snap_fields(x) for x in s.snapshots]
    assert rows["repro_torch"] == rows["repro"]
    counts = [r["completed"] for r in rows["repro_torch"]]
    assert counts == sorted(counts)


# ---------------------------------------------------------------------------
# FleetView + dashboard
# ---------------------------------------------------------------------------
def _fleet_state(fleet, now):
    return {"rows": fleet.worker_rows(now), "alive": dict(fleet.alive),
            "counters": {k: getattr(fleet, k) for k in (
                "steals", "requeues", "demotions", "mode_switches", "mode",
                "placements", "dp_cache_hits", "autoscale_actions",
                "prewarms", "replications", "migrations", "retires",
                "opoint_switches", "cap_downshifts")},
            "replicas": {h: sorted(w) for h, w in fleet.replicas.items()},
            "learned": fleet.learned, "power": list(fleet.power),
            "opoints": fleet.opoints}


def test_fleetview_fed_the_same_spans_matches_reference():
    """The reference's span stream of a steal-heavy run fed to both
    FleetViews: every counter, row and query equal."""
    records, _, router, snap = traced("repro", **STEAL_HEAVY)
    now = router.metrics.t_last
    views = {}
    for root in ROOTS:
        fleet = pkg(root).obs.FleetView(ring=40)
        for rec in records:
            fleet.emit(rec)
        views[root] = _fleet_state(fleet, now)
        assert fleet.fleet_watts() == 0.0 and fleet.power_cap() is None
        assert fleet.occupancy("nobody", now) == 0.0
    assert views["repro_torch"] == views["repro"]
    assert views["repro_torch"]["counters"]["steals"] == snap.steals > 0


def test_fleetview_counters_match_telemetry_as_reference():
    fleets = {root: pkg(root).obs.FleetView() for root in ROOTS}
    ref = traced("repro", extra_sinks=(fleets["repro"],), **STEAL_HEAVY)
    records, _, router, snap = traced(
        "repro_torch", extra_sinks=(fleets["repro_torch"],), **STEAL_HEAVY)
    assert masked(records) == masked(ref[0])
    fleet = fleets["repro_torch"]
    now = router.metrics.t_last
    assert _fleet_state(fleet, now) == _fleet_state(fleets["repro"], now)
    assert fleet.steals == snap.steals > 0
    assert fleet.alive == {"w0": True, "w1": True}
    rows = fleet.worker_rows(now)
    assert [r["wid"] for r in rows] == ["w0", "w1"]
    assert all(r["alive"] and 0.0 <= r["busy_frac"] <= 1.0 for r in rows)
    assert fleet.placements == len(router.dispatches)
    assert fleet.dp_cache_hits <= fleet.placements


def test_fleetview_marks_dead_worker_lost_as_reference():
    rows = {}
    for root in ROOTS:
        fleet = pkg(root).obs.FleetView()
        _, router = stack(root, sinks=(fleet,), cluster=True,
                          script=((6.0, "kill", "w1"),))
        sim(root).run(router)
        assert fleet.alive == {"w0": True, "w1": False}
        rows[root] = fleet.worker_rows(router.metrics.t_last)
    assert rows["repro_torch"] == rows["repro"]
    assert {r["wid"]: r["alive"] for r in rows["repro_torch"]} == \
        {"w0": True, "w1": False}


def _frames(root, **kw):
    fleet = pkg(root).obs.FleetView()
    _, router = stack(root, sinks=(fleet,), cluster=True, **kw)
    sim(root).run(router)
    return pkg(root).obs.build_frame(router.metrics.t_last, router, fleet)


def test_dashboard_frame_render_and_html_match_reference():
    frame = _frames("repro_torch")
    ref = _frames("repro")
    assert mask_frame(frame) == mask_frame(ref)
    for key in ("t", "mode", "completed", "p50_ms", "p99_ms",
                "dp_per_1k_req", "place_ms_p50", "place_ms_p99",
                "steals", "workers", "stragglers", "probation"):
        assert key in frame
    assert len(frame["workers"]) == 2
    o, r = pkg("repro_torch").obs, pkg("repro").obs
    # the same frame renders to the same text and the same page
    text = o.render_frame(frame)
    assert text == r.render_frame(frame)
    assert "[dash]" in text and "w0" in text and "w1" in text
    html = o.dashboard_html([ref, frame])
    assert html == r.dashboard_html([ref, frame])
    assert html.startswith("<!DOCTYPE html>") and "/*FRAMES*/" not in html
    assert json.loads(html.split("const FRAMES = ", 1)[1]
                      .split(";\n", 1)[0])[1] == frame


def test_dashboard_frame_without_fleet_is_local_only_as_reference():
    frames = {}
    for root in ROOTS:
        _, router = stack(root, sinks=())
        sim(root, duration=10.0).run(router)
        frames[root] = pkg(root).obs.build_frame(router.metrics.t_last, router)
        assert frames[root]["workers"] == []
        assert frames[root]["completed"] == router.metrics.completed
    assert mask_frame(frames["repro_torch"]) == mask_frame(frames["repro"])
    assert pkg("repro_torch").obs.render_frame(frames["repro_torch"])


def _governed(root):
    p = pkg(root)
    fleet = pkg(root).obs.FleetView()
    lc, router = stack(root, sinks=(fleet,), cluster=True, forecaster=True)
    gov = p.energy.ParetoGovernor(budget=p.energy.PowerBudget(750.0))
    gov.attach(router, lc.controller)
    mix = (p.serving.MixItem("llm-swa-4k", "llm", 1.0,
                             p.core.swa_transformer_workload(4096, 256)),)
    sim(root, peak=16.0, trough=16.0, mix=mix).run(router)
    router.tracer.flush(router.metrics.t_last)
    return fleet, gov, pkg(root).obs.build_frame(router.metrics.t_last, router,
                                             fleet)


def test_dashboard_power_tile_from_governed_run_as_reference():
    fleet, gov, frame = _governed("repro_torch")
    ref_fleet, _, ref_frame = _governed("repro")
    assert mask_frame(frame) == mask_frame(ref_frame)
    assert list(fleet.power) == list(ref_fleet.power)
    assert fleet.power and fleet.fleet_watts() > 0.0
    assert fleet.power_cap() == 750.0
    assert fleet.opoints and fleet.opoint_switches > 0
    assert frame["watts"] == gov.last_watts
    assert frame["power_cap"] == 750.0
    assert frame["opoints"] and frame["opoint_switches"] > 0
    text = pkg("repro_torch").obs.render_frame(frame)
    assert text == pkg("repro").obs.render_frame(frame)
    assert "power=" in text and "cap=750" in text
    html = pkg("repro_torch").obs.dashboard_html([frame])
    assert html == pkg("repro").obs.dashboard_html([frame])
    assert "opoint" in html.lower()


def test_dashboard_server_serves_pushed_frames_on_localhost():
    """``DashboardServer(port=0)`` on 127.0.0.1: the page embeds the pushed
    frame, ``/events`` streams it as a server-sent event, then close."""
    frame = _frames("repro_torch")
    server = pkg("repro_torch").obs.DashboardServer(port=0)
    try:
        assert server.url == f"http://127.0.0.1:{server.port}/"
        assert server.port > 0
        server.push(frame)
        with urllib.request.urlopen(server.url, timeout=10) as resp:
            page = resp.read().decode()
        assert page == pkg("repro_torch").obs.dashboard_html([frame])
        with urllib.request.urlopen(server.url + "events", timeout=10) as r:
            assert r.headers["Content-Type"] == "text/event-stream"
            line = r.readline().decode()
        assert line.startswith("data: ")
        assert json.loads(line[len("data: "):]) == frame
    finally:
        server.close()
    assert server._closing


# ---------------------------------------------------------------------------
# the CLI: the observability quickstart (docs/observability.md:29-34)
# ---------------------------------------------------------------------------
QUICKSTART = ["--stream", "--duration", "60", "--cluster", "2",
              "--host-profiles", "w1=60", "--steal", "--peak-rate", "24",
              "--dashboard", "--dashboard-every", "5"]


def _minus_dash(lines, *, measured=True):
    """``_minus`` of the cluster tests, the frames' wall-clock placement
    line blanked, and without ``measured`` each worker row's occupancy."""
    out = [re.sub(r"place p50=[0-9.]+ms p99=[0-9.]+ms", "place *", line)
           for line in _minus(lines, measured=measured)]
    if not measured:
        out = [re.sub(r"\|[^|]*\| +[0-9.]+% busy", "|*| busy", line)
               for line in out]
    return out


def _html_frames(path):
    html = Path(path).read_text()
    return json.loads(html.split("const FRAMES = ", 1)[1].split(";\n", 1)[0])


@pytest.mark.parametrize("backend", ["analytic", "torch"])
def test_cli_observability_quickstart_matches_reference(backend, tmp_path):
    """The quickstart on both packages: equal output but for the wall
    lines, the trace validates at coverage 1.0 in both packages, and the
    HTML's frames are equal but for the masked fields."""
    def files(tag):
        return [str(tmp_path / f"{tag}.jsonl"), str(tmp_path / f"{tag}.html")]

    def argv(tag):
        spans, html = files(tag)
        return tuple(QUICKSTART + ["--trace-out", spans, "--dashboard-html",
                                   html])
    measured = backend == "analytic"
    extra = () if measured else ("--backend", "torch", "--device", "cpu")
    ref = _cli("repro", argv("ref"))
    port = _cli("repro_torch", argv("port") + extra)

    def strip(lines, tag):
        spans, html = files(tag)
        return [line for line in _minus_dash(lines, measured=measured)
                if line not in (f"[serve] trace spans -> {spans}",
                                f"[serve] dashboard html -> {html}")]
    assert strip(port, "port") == strip(ref, "ref")
    assert sum(line.startswith("[dash] t=") for line in port) == 13
    records = pkg("repro_torch").obs.read_jsonl(files("port")[0])
    errors, stats = validate_both(records)
    assert errors == [] and stats["coverage"] == 1.0
    ref_records = pkg("repro").obs.read_jsonl(files("ref")[0])
    assert masked(records, measured=measured) == \
        masked(ref_records, measured=measured)
    frames = _html_frames(files("port")[1])
    assert len(frames) == 13
    assert [mask_frame(f, measured=measured) for f in frames] == \
        [mask_frame(f, measured=measured)
         for f in _html_frames(files("ref")[1])]


def test_cli_dashboard_flags_print_frames_without_a_cluster():
    """A local stream with ``--dashboard``: frames every 5 s and a final
    one, the same text as the reference's but the wall lines."""
    argv = ("--stream", "--duration", "20", "--day", "20", "--dashboard")
    port, ref = _cli("repro_torch", argv), _cli("repro", argv)
    assert _minus_dash(port) == _minus_dash(ref)
    assert sum(line.startswith("[dash] t=") for line in port) == 6


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_observability_quickstart_matches_analytic(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import spmm_csr_rows
    from repro_torch.launch import serve as serve_cli
    spmm_csr_rows.launches = 0
    outs = {}
    for backend in ("analytic", "torch"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            serve_cli.main(QUICKSTART + [
                "--backend", backend,
                "--trace-out", str(tmp_path / f"{backend}.jsonl"),
                "--record-cluster-events", str(tmp_path / f"{backend}.e")])
        outs[backend] = [line for line in out.getvalue().splitlines()
                         if str(tmp_path) not in line]
    assert spmm_csr_rows.launches > 0
    assert _minus_dash(outs["torch"], measured=False) == \
        _minus_dash(outs["analytic"], measured=False)
    assert (tmp_path / "torch.e").read_bytes() == \
        (tmp_path / "analytic.e").read_bytes()
    errors, stats = pkg("repro_torch").obs.validate(
        pkg("repro_torch").obs.read_jsonl(tmp_path / "torch.jsonl"))
    assert errors == [] and stats["coverage"] == 1.0
