"""The port's multi-host control plane (``repro_torch/cluster/``,
``runtime/backend.py:ClusterBackend``) against the reference
(tests/test_cluster.py, test_hetero_cluster.py, test_replication.py,
test_replay_properties.py): the event log, transports, pool split and
worker core, and the serving scenarios (kills, joins, latency, stealing,
replication, a rack kill under tenancy) through both packages.

The same scenario (``replay_harness.Scenario``: seed, pool, script,
traffic) goes through both packages' full stacks, built by one function
from either package's modules (``cluster_harness.run``). Control-plane
outputs are compared exactly: the cluster event log's JSONL bytes and the
``MetricsSnapshot`` fields (but the wall-clock placement times, and on the
torch backend the measured stage seconds, which are real seconds there).
The port's torch backend runs with ``device="cpu"``, on one torch thread
(``torch_threads``). The torch backend behind the cluster is in
tests/test_torch_cluster_torch.py, the CLI in
tests/test_torch_cluster_cli.py; the torch CLI's check against the
analytic one runs its five commands across the three files."""
import pytest

torch = pytest.importorskip("torch")

from cluster_harness import (TORCH_CPU, _core_replies, _fixed_scripts, _log_of,
                             assert_no_lost_requests, assert_same_as_reference,
                             cli_torch_cpu_cluster_matches_analytic,
                             kill_scenario, pkg, replay, run)
from replay_harness import Scenario
from torch_threads import (default_torch_threads,  # noqa: F401
                           one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ---------------------------------------------------------------------------
# events, transports, pool split, worker core
# ---------------------------------------------------------------------------
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

@pytest.mark.parametrize("name", ["kill"])
def test_cli_torch_cpu_cluster_matches_analytic(name, tmp_path,
                                                default_torch_threads):
    """``cluster_harness.cli_torch_cpu_cluster_matches_analytic``: the
    torch CLI against the analytic one, for the documented kill (and
    its replay); the other commands are in test_torch_cluster_cli.py
    and test_torch_cluster_torch.py."""
    cli_torch_cpu_cluster_matches_analytic(name, tmp_path)
