"""The port's serving stack (``repro_torch/serving/``, ``obs/trace.py`` and
``launch/serve.py --stream``) against the reference's own checks
(tests/test_serving.py), plus parity with the reference:

* the same TrafficSim stream through the reference's Router on
  ``PallasPipelineBackend`` (interpret) and through the port's Router on
  the CPU torch backend: equal sorted latencies, completed count,
  reschedules and reschedule events (tests/test_backend.py's comparison);
* the same stream through both packages on the analytic backend: equal
  snapshots;
* ``repro_torch.launch.serve --stream``: ``--backend torch --device cpu``
  prints what ``--backend analytic`` prints, but for the lines that carry
  wall-clock numbers and the backend's name."""
import contextlib
import dataclasses
import io
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core import (DynamicScheduler as RefDynamicScheduler,
                        PerfModel as RefPerfModel,
                        paper_system as ref_paper_system)
from repro.runtime import PallasPipelineBackend
from repro.serving import (LoadWatermarkPolicy as RefPolicy,
                           PoolEvent as RefPoolEvent, Router as RefRouter,
                           SignatureBatcher as RefBatcher,
                           TrafficSim as RefTrafficSim)
from repro_torch.core import (DATASETS, DynamicScheduler, PerfModel,
                              gcn_workload, paper_system, signature,
                              swa_transformer_workload)
from repro_torch.launch import serve as serve_cli
from repro_torch.obs import MemorySink, NULL_TRACER, Tracer
from repro_torch.runtime import TorchPipelineBackend
from repro_torch.serving import (Burst, LoadWatermarkPolicy, MixItem,
                                 PoolEvent, Request, RequestQueue, Router,
                                 ServingMetrics, SignatureBatcher,
                                 TrafficSim, default_mix, percentile)

REPO = Path(__file__).resolve().parent.parent
WL_A = gcn_workload(DATASETS["OA"])
WL_B = gcn_workload(DATASETS["OP"])


def fresh_router(**policy_kw):
    dyn = DynamicScheduler(paper_system("pcie4"), PerfModel(), mode="perf")
    kw = dict(low=0.3, high=0.7, window=10.0)
    kw.update(policy_kw)
    return Router(dyn, batcher=SignatureBatcher(max_batch=8, max_wait=0.25),
                  policy=LoadWatermarkPolicy(**kw))


def req(rid, wl, t, deadline=None):
    return Request(rid, wl, t, deadline=deadline)


# ---------------------------------------------------------------------------
# RequestQueue admission control
# ---------------------------------------------------------------------------
def test_queue_rejects_when_full():
    q = RequestQueue(max_depth=2)
    assert q.admit(req(0, WL_A, 0.0), 0.0)
    assert q.admit(req(1, WL_A, 0.0), 0.0)
    assert not q.admit(req(2, WL_A, 0.0), 0.0)
    assert q.stats.rejected_full == 1
    assert len(q) == 2


def test_queue_rejects_hopeless_deadline():
    q = RequestQueue()
    assert not q.admit(req(0, WL_A, 0.0, deadline=1.0), 0.0, est_wait=2.0)
    assert q.stats.rejected_deadline == 1
    assert q.admit(req(1, WL_A, 0.0, deadline=1.0), 0.0, est_wait=0.5)


def test_queue_expires_aged_requests():
    q = RequestQueue()
    q.admit(req(0, WL_A, 0.0, deadline=1.0), 0.0)
    q.admit(req(1, WL_A, 0.0, deadline=5.0), 0.0)
    dead = q.expire(2.0)
    assert [r.rid for r in dead] == [0]
    assert [r.rid for r in q] == [1]
    assert q.stats.expired == 1


# ---------------------------------------------------------------------------
# SignatureBatcher grouping
# ---------------------------------------------------------------------------
def test_batches_are_signature_homogeneous():
    q = RequestQueue()
    b = SignatureBatcher(max_batch=8, max_wait=0.0)
    for i in range(6):
        q.admit(req(i, WL_A if i % 2 == 0 else WL_B, i * 0.01), i * 0.01)
    batches = b.drain(q, 1.0)
    assert len(batches) == 2
    for batch in batches:
        sigs = {signature(r.wl) for r in batch.requests}
        assert sigs == {batch.sig}
    assert len(q) == 0


def test_batcher_oldest_first_and_max_batch():
    q = RequestQueue()
    b = SignatureBatcher(max_batch=2, max_wait=0.0)
    q.admit(req(0, WL_B, 0.5), 0.5)
    for i in range(1, 4):
        q.admit(req(i, WL_A, 0.0 + i * 1e-3), 0.0)
    assert [r.rid for r in b.next_batch(q, 1.0).requests] == [1, 2]
    assert [r.rid for r in b.next_batch(q, 1.0).requests] == [3]


def test_batcher_waits_for_fill_or_age():
    q = RequestQueue()
    b = SignatureBatcher(max_batch=4, max_wait=1.0)
    q.admit(req(0, WL_A, 0.0), 0.0)
    assert b.next_batch(q, 0.5) is None
    assert len(q) == 1
    got = b.next_batch(q, 1.5)
    assert got is not None and len(got) == 1


def test_batcher_sig_cache_evicted_on_expiry():
    r = fresh_router()
    r.submit(req(0, WL_A, 0.0, deadline=1.0), 0.0)
    r.step(0.1)
    assert len(r.queue) == 1
    r.step(2.0)
    assert len(r.queue) == 0
    assert r.metrics.dropped == 1
    assert r.batcher._sig_cache == {}


# ---------------------------------------------------------------------------
# watermark policy + metrics helpers
# ---------------------------------------------------------------------------
def test_watermark_hysteresis():
    p = LoadWatermarkPolicy(low=0.3, high=0.7, window=1.0,
                            initial_mode="perf")
    cap = 10.0
    for t in [1.0 + i * 0.1 for i in range(10)]:
        p.observe_arrival(t)
    assert p.update(2.0, cap) == "perf"
    for t in (2.5, 2.6, 2.7, 2.8, 2.9):
        p.observe_arrival(t)
    assert p.update(2.9, cap) == "perf"
    assert p.update(10.0, cap) == "energy"
    for t in [10.2 + i * 0.2 for i in range(5)]:
        p.observe_arrival(t)
    assert p.update(11.0, cap) == "energy"
    assert [m for _, m in p.switches] == ["energy"]


def test_watermark_warmup_guard():
    p = LoadWatermarkPolicy(low=0.3, high=0.7, window=10.0,
                            initial_mode="perf")
    assert p.update(0.1, 10.0) == "perf"
    assert p.switches == []


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert percentile(xs, 50) == 50
    assert percentile(xs, 99) == 99
    assert percentile([], 99) == 0.0
    assert percentile([7.0], 50) == 7.0


def test_metrics_deadline_misses():
    m = ServingMetrics()
    r1 = req(0, WL_A, 0.0, deadline=1.0)
    r1.finish = 2.0
    r2 = req(1, WL_A, 0.0, deadline=5.0)
    r2.finish = 2.0
    m.record_completion(r1)
    m.record_completion(r2)
    snap = m.snapshot()
    assert snap.completed == 2
    assert snap.deadline_miss_rate == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# Router elastic/straggler integration
# ---------------------------------------------------------------------------
def test_router_straggler_demotes_device():
    r = fresh_router()
    r.submit(req(0, WL_B, 0.0), 0.0)
    r.step(1.0)
    stage0 = r.dyn.active.pipeline.stages[0]
    pool0 = r.pool.n_a if stage0.dev.name == "FPGA" else r.pool.n_b
    for _ in range(10):
        if r.observe_stage_time(0, 3.0 * max(stage0.total, 1e-9)):
            break
    pool1 = r.pool.n_a if stage0.dev.name == "FPGA" else r.pool.n_b
    assert pool1 == pool0 - 1
    assert any("straggler" in line for line in r.log)
    r.submit(req(1, WL_B, 2.0), 2.0)
    assert [x.rid for x in r.step(3.0)] == [0]
    assert [x.rid for x in r.drain(3.0)] == [1]


def test_router_monitor_follows_schedule_identity():
    r = fresh_router()
    r.submit(req(0, WL_A, 0.0), 0.0)
    r.step(1.0)
    m1 = r.monitor
    llm = swa_transformer_workload(1024, 512, layers=2)
    r.submit(req(1, llm, 1.0), 1.0)
    r.step(2.0)
    assert r.monitor is not m1
    assert [s.baseline for s in r.monitor.stats] == pytest.approx(
        [s.total for s in r.dyn.active.pipeline.stages])


def test_drain_flushes_partial_batches_at_horizon():
    r = fresh_router()
    r.batcher.max_wait = 10.0
    r.submit(req(0, WL_A, 0.0, deadline=50.0), 0.0)
    r.submit(req(1, WL_B, 0.0), 0.0)
    done = r.drain(0.0, horizon=1.0)
    assert {x.rid for x in done} == {0, 1}
    assert len(r.queue) == 0
    assert all(d.t0 >= 1.0 for d in r.dispatches)


# ---------------------------------------------------------------------------
# TrafficSim determinism and record/replay
# ---------------------------------------------------------------------------
def sim_config(seed, events=()):
    return TrafficSim(seed=seed, duration=30.0, day=30.0, peak_rate=6.0,
                      trough_rate=0.5, events=events,
                      bursts=(Burst(5.0, 7.0, 2.0),))


def test_trafficsim_deterministic_under_fixed_seed():
    snaps, timelines = [], []
    for _ in range(2):
        sim = sim_config(seed=123)
        snaps.append(sim.run(fresh_router()))
        timelines.append(sim.timeline)
    assert snaps[0] == snaps[1]
    assert timelines[0] == timelines[1]


def test_trafficsim_seed_changes_stream():
    assert sim_config(seed=1).run(fresh_router()) != \
        sim_config(seed=2).run(fresh_router())


def test_default_mix_is_the_four_signatures():
    assert [m.name for m in default_mix()] == [
        "gcn-arxiv", "gcn-products", "llm-swa-1k", "llm-swa-4k"]


def test_trafficsim_jsonl_roundtrip(tmp_path):
    sim = sim_config(seed=9)
    sim.run(fresh_router())
    path = tmp_path / "trace.jsonl"
    sim.to_jsonl(path)
    replay = TrafficSim.from_jsonl(path, peak_rate=sim.peak_rate)
    assert len(replay.trace) == len(sim.last_trace) > 0
    for a, b in zip(replay.trace, sim.last_trace):
        assert a.t == pytest.approx(b.t)
        assert a.kind == b.kind
        assert signature(a.wl) == signature(b.wl)
        assert a.deadline == pytest.approx(b.deadline)
    snap2 = replay.run(fresh_router())
    assert snap2.completed + snap2.dropped == len(replay.trace)
    path2 = tmp_path / "trace2.jsonl"
    replay.to_jsonl(path2)
    assert path.read_text() == path2.read_text()


def test_checked_in_sample_trace_replays():
    sample = REPO / "examples" / "traces" / "sample_mixed.jsonl"
    sim = TrafficSim.from_jsonl(sample, peak_rate=5.0)
    assert len(sim.trace) > 0
    snap = sim.run(fresh_router())
    assert snap.completed == len(sim.trace)


def test_llm_only_stream_uses_transformer_schedules():
    mix = (MixItem("llm-1k", "llm", 0.5,
                   swa_transformer_workload(1024, 512, layers=2)),
           MixItem("llm-4k", "llm", 0.5,
                   swa_transformer_workload(4096, 512, layers=2)))
    r = fresh_router()
    sim = TrafficSim(seed=3, duration=20.0, day=20.0, peak_rate=6.0,
                     trough_rate=1.0, mix=mix)
    snap = sim.run(r)
    assert snap.completed > 20
    assert len({d.sig for d in r.dispatches}) == 2
    assert r.dyn.dp_solves <= 6


def test_streaming_end_to_end_with_failure_and_rejoin():
    """Mixed stream with a trough and a mid-stream failure on the CPU torch
    backend: two schedules at least, a perf -> energy flip, a resize, and
    no schedule with more than one FPGA while two of three are down."""
    fail_t, rejoin_t = 20.0, 40.0
    dyn = DynamicScheduler(paper_system("pcie4"), PerfModel(), mode="perf")
    r = Router(dyn, batcher=SignatureBatcher(max_batch=8, max_wait=0.25),
               policy=LoadWatermarkPolicy(low=0.3, high=0.7, window=10.0),
               backend=TorchPipelineBackend(device="cpu"))
    sim = TrafficSim(seed=7, duration=60.0, day=60.0, peak_rate=8.0,
                     trough_rate=0.4,
                     events=(PoolEvent(fail_t, "fail", "FPGA", 2),
                             PoolEvent(rejoin_t, "join", "FPGA", 2)))
    snap = sim.run(r)
    assert len({d.mnemonic for d in r.dispatches}) >= 2
    assert "energy" in [m for _, m in r.policy.switches]
    assert any(e.reason == "resize" for e in r.dyn.events)
    during = [d for d in r.dispatches if fail_t <= d.t0 < rejoin_t]
    assert during and [d for d in r.dispatches if d.t0 >= rejoin_t]
    for d in during:
        assert "2F" not in d.mnemonic and "3F" not in d.mnemonic
    assert len(r.queue) == 0 and snap.completed > 100
    assert snap.measured_stage_s > 0.0


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------
def test_tracer_spans_cover_every_completed_request():
    sink = MemorySink()
    r = Router(DynamicScheduler(paper_system("pcie4"), PerfModel(),
                                mode="perf"),
               batcher=SignatureBatcher(max_batch=8, max_wait=0.25),
               tracer=Tracer(sink))
    snap = TrafficSim(seed=5, duration=6.0, day=6.0, peak_rate=4.0,
                      trough_rate=1.0).run(r)
    r.tracer.flush(r.metrics.t_last)
    names = {rec["name"] for rec in sink.records}
    assert {"admit", "submit", "reap"} <= names
    roots = {rec["trace"] for rec in sink.records
             if rec["parent"] is None and rec["trace"].startswith("r")}
    assert len(roots) >= snap.completed > 0
    assert NULL_TRACER.enabled is False


# ---------------------------------------------------------------------------
# parity with the reference's serving stack
# ---------------------------------------------------------------------------
def _events(dyn):
    return [dataclasses.astuple(e) for e in dyn.events]


def test_router_stream_parity_reference_pallas_vs_port_torch():
    """The same TrafficSim through the reference's Router on the Pallas
    interpret backend and through the port's Router on the CPU torch
    backend."""
    ref = RefRouter(RefDynamicScheduler(ref_paper_system("pcie4"),
                                        RefPerfModel(), mode="perf"),
                    batcher=RefBatcher(max_batch=8, max_wait=0.25),
                    policy=RefPolicy(window=10.0),
                    backend=PallasPipelineBackend(mode="interpret",
                                                  act_dim=4, act_batch=2))
    ref_snap = RefTrafficSim(seed=5, duration=6.0, day=6.0, peak_rate=4.0,
                             trough_rate=1.0).run(ref)
    port = Router(DynamicScheduler(paper_system("pcie4"), PerfModel(),
                                   mode="perf"),
                  batcher=SignatureBatcher(max_batch=8, max_wait=0.25),
                  policy=LoadWatermarkPolicy(window=10.0),
                  backend=TorchPipelineBackend(device="cpu", act_dim=4,
                                               act_batch=2))
    snap = TrafficSim(seed=5, duration=6.0, day=6.0, peak_rate=4.0,
                      trough_rate=1.0).run(port)
    assert sorted(port.metrics.latencies) == sorted(ref.metrics.latencies)
    assert port.metrics.completed == ref.metrics.completed > 0
    assert snap.reschedules == ref_snap.reschedules
    assert _events(port.dyn) == _events(ref.dyn)


def test_stream_snapshot_parity_with_reference_analytic():
    """Both packages on the analytic backend, with a failure and a rejoin:
    the whole snapshot but its wall-clock placement times is equal."""
    def strip(snap):
        d = dataclasses.asdict(snap)
        for k in ("place_ms_p50", "place_ms_p99"):
            d.pop(k)
        return d
    kw = dict(seed=7, duration=30.0, day=30.0, peak_rate=8.0,
              trough_rate=0.4)
    ref = RefRouter(RefDynamicScheduler(ref_paper_system("pcie4"),
                                        RefPerfModel(), mode="perf"))
    ref_snap = RefTrafficSim(events=(RefPoolEvent(10.0, "fail", "FPGA", 2),
                                     RefPoolEvent(20.0, "join", "FPGA", 2)),
                             **kw).run(ref)
    port = Router(DynamicScheduler(paper_system("pcie4"), PerfModel(),
                                   mode="perf"))
    snap = TrafficSim(events=(PoolEvent(10.0, "fail", "FPGA", 2),
                              PoolEvent(20.0, "join", "FPGA", 2)),
                      **kw).run(port)
    assert strip(snap) == strip(ref_snap)
    assert _events(port.dyn) == _events(ref.dyn)
    assert port.log == ref.log


# ---------------------------------------------------------------------------
# the CLI: serve --stream
# ---------------------------------------------------------------------------
STREAM_ARGS = ["--stream", "--duration", "40", "--day", "40", "--fail-at",
               "10", "--rejoin-at", "25", "--fail-count", "2"]


def _serve(*extra):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_cli.main(STREAM_ARGS + list(extra))
    return out.getvalue().splitlines()


def _minus_wall(lines, backend):
    """The output but its wall-clock lines (stream wall, placement wall,
    and the busy/wall line with the measured stage seconds), with the
    backend's name blanked."""
    return [line.replace(f"backend={backend} ", "backend=* ")
            for line in lines if "wall" not in line]


def test_cli_stream_torch_cpu_matches_analytic():
    torch_out = _serve("--backend", "torch", "--device", "cpu")
    analytic_out = _serve("--backend", "analytic")
    assert torch_out[0].startswith("[serve] backend=torch ")
    assert any(line.startswith("[serve] completed=") for line in torch_out)
    assert any("resize" in line for line in torch_out)
    assert _minus_wall(torch_out, "torch") == \
        _minus_wall(analytic_out, "analytic")
    assert len(_minus_wall(torch_out, "torch")) == len(torch_out) - 3


def test_cli_stream_is_deterministic_and_records_a_replayable_trace(
        tmp_path):
    arrivals, spans = tmp_path / "a.jsonl", tmp_path / "s.jsonl"
    first = _serve("--seed", "3", "--record-trace", str(arrivals),
                   "--trace-out", str(spans))
    again = _serve("--seed", "3")
    assert [line for line in _minus_wall(first, "analytic")
            if not line.startswith(("[serve] arrival trace ->",
                                    "[serve] trace spans ->"))] == \
        _minus_wall(again, "analytic")
    assert f"[serve] arrival trace -> {arrivals}" in first
    recs = [json.loads(line) for line in spans.read_text().splitlines()]
    assert recs and all("trace" in rec for rec in recs)
    replayed = _serve("--replay-trace", str(arrivals), "--backend", "torch",
                      "--device", "cpu")
    done = [line for line in first if line.startswith("[serve] completed=")]
    assert done == [line for line in replayed
                    if line.startswith("[serve] completed=")]


def test_cli_rejects_what_is_not_ported():
    with pytest.raises(SystemExit):
        serve_cli.main(["--duration", "1"])   # decode mode without --arch
    with pytest.raises(SystemExit):
        serve_cli.main(STREAM_ARGS + ["--device", "cpu"])


@pytest.mark.parametrize("backend", ["analytic", "torch"])
def test_cli_trace_in_prints_the_tenant_lines_of_the_reference(
        backend, monkeypatch):
    """The converted trace's rows carry tenants, so without ``--tenants``
    the summary still ends with one ``tenant`` line per row of the
    snapshot, as the reference's (src/repro/launch/serve.py:356-365)."""
    import repro.launch.serve as ref_serve_cli
    argv = ["--stream", "--trace-in",
            str(REPO / "examples" / "traces" / "azure_llm_excerpt.jsonl")]
    out = io.StringIO()
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    with contextlib.redirect_stdout(out):
        ref_serve_cli.main()
    ref = out.getvalue().splitlines()
    port_argv = argv + (["--backend", "torch", "--device", "cpu"]
                        if backend == "torch" else [])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_cli.main(port_argv)
    port = out.getvalue().splitlines()
    assert _minus_wall(port, backend) == _minus_wall(ref, "analytic")
    tenants = [line for line in port if line.startswith("[serve] tenant ")]
    assert [line.split(":")[0] for line in tenants] == [
        "[serve] tenant bronze", "[serve] tenant gold"]
    assert "completed=1492" in tenants[0] and "completed=508" in tenants[1]
