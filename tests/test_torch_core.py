"""The port's copy of the DYPE core makes the same schedules as the
reference on the paper's system (3x U280 + 2x MI210, PCIe4)."""
import pytest

pytest.importorskip("torch")

import repro.core as ref
import repro_torch.core as port

WORKLOADS = ([("gcn", name) for name in sorted(ref.DATASETS)]
             + [("gin", name) for name in sorted(ref.DATASETS)]
             + [("swa", (4096, 512)), ("swa", (16384, 1024))])


def _workload(core, kind, arg):
    if kind == "swa":
        return core.swa_transformer_workload(*arg, layers=4)
    builder = core.gcn_workload if kind == "gcn" else core.gin_workload
    return builder(core.DATASETS[arg])


def _summary(result):
    stages = tuple((s.i0, s.i1, s.dev.name, s.n)
                   for s in result.pipeline.stages)
    return (result.mnemonic, stages, result.pipeline.period, result.energy,
            result.throughput)


@pytest.fixture(scope="module")
def models():
    return ref.PerfModel(), port.PerfModel()


@pytest.mark.parametrize("mode", ["perf", "energy", "balanced"])
@pytest.mark.parametrize("kind,arg", WORKLOADS, ids=str)
def test_dynamic_scheduler_matches_reference(models, kind, arg, mode):
    ref_pm, port_pm = models
    r = ref.DynamicScheduler(ref.paper_system("pcie4"), ref_pm, mode=mode)
    p = port.DynamicScheduler(port.paper_system("pcie4"), port_pm, mode=mode)
    assert _summary(p.submit(_workload(port, kind, arg))) == \
        _summary(r.submit(_workload(ref, kind, arg)))


def test_drift_reschedules_like_reference(models):
    """The serving driver's drift step: 8x the edges on the same graph."""
    ref_pm, port_pm = models
    out = []
    for core, pm in ((ref, ref_pm), (port, port_pm)):
        dyn = core.DynamicScheduler(core.paper_system("pcie4"), pm,
                                    mode="perf")
        ds = core.DATASETS["OA"]
        first = dyn.submit(core.gcn_workload(ds)).mnemonic
        dense = core.GraphDataset("x8", ds.vertices, 8 * ds.edges, 128)
        second = dyn.submit(core.gcn_workload(dense)).mnemonic
        out.append((first, second, [e.reason for e in dyn.events]))
    assert out[0] == out[1]


def test_port_keeps_no_tpu_pools():
    """The port drops the TPU pools and adds the H100 node's NVLink 4."""
    assert not hasattr(port, "tpu_system")
    assert "ici" not in port.INTERCONNECTS
    assert set(ref.INTERCONNECTS) - {"ici"} | {"nvlink4"} == \
        set(port.INTERCONNECTS)
