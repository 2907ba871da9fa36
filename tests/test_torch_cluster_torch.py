"""The port's torch backend behind its cluster (``repro_torch/cluster/``
with ``TorchPipelineBackend`` workers): on the CPU, the event log
byte-identical to the reference's analytic one, latency injection seen
through a wall calibrator, the device a local cluster takes, and a spawned
worker process; its ``cuda`` tests run the same cluster and worker on the
card and skip here; two of the documented commands on ``--backend torch
--device cpu`` print what the analytic backend prints. Built with
``cluster_harness``, as tests/test_torch_cluster.py."""
import pytest

torch = pytest.importorskip("torch")

from cluster_harness import (TORCH_CPU, _mp_roundtrip, assert_no_lost_requests,
                             assert_same_as_reference,
                             cli_torch_cpu_cluster_matches_analytic,
                             kill_scenario, pkg, run)
from replay_harness import Scenario
from torch_threads import (default_torch_threads,  # noqa: F401
                           one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


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


def test_mp_worker_torch_cpu_roundtrip():
    rep, want, code = _mp_roundtrip({"device": "cpu"})
    assert rep.finishes == want.finishes
    assert rep.stage_times == want.stage_times
    assert rep.worker == "mp0"
    assert len(rep.measured_stage_times) == len(want.stage_times)
    assert all(t > 0 for t in rep.measured_stage_times)
    assert code == 0

@pytest.mark.parametrize("name", ["steal", "governor"])
def test_cli_torch_cpu_cluster_matches_analytic(name, tmp_path,
                                                default_torch_threads):
    """``cluster_harness.cli_torch_cpu_cluster_matches_analytic``: the
    torch CLI against the analytic one, for the steal and governor
    commands; the others are in test_torch_cluster.py and
    test_torch_cluster_cli.py."""
    cli_torch_cpu_cluster_matches_analytic(name, tmp_path)


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
