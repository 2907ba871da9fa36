"""The multi-card mesh mode of the port's pipeline (``launch/mesh.py``,
``runtime/pipeline_exec.py`` with a mesh, ``TorchPipelineBackend``'s
``mode="mesh"``), on meshes of CPU slots.

The reference's own multi-device tests (tests/test_dynamic_runtime.py:75-160)
fail on this tree's jax, so the port's mesh is held to what they compare
against: the sequential ``einsum`` at 1e-5, and OA's ``finishes`` equal to
the analytic backend's. Also: the mesh executor equals the single-device
executor bit for bit, ``mode="mesh"`` raises without enough cards and no
mesh, ``"auto"`` runs the chain on the CPU, and the production mesh raises
with too few devices."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (DATASETS, DynamicScheduler, PerfModel,
                              gcn_workload, h100_system, paper_system)
from repro_torch.launch.mesh import (Mesh, cpu_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.launch.serve_pipeline import serve
from repro_torch.runtime import (AnalyticBackend, GroupedPipelineExecutor,
                                 PipelineExecutor, StageChain,
                                 TorchPipelineBackend)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")
WL_A = gcn_workload(DATASETS["OA"])


def cpu_slots(n, axes=("stage",)):
    return make_mesh((n,), axes, devices=[CPU] * n)


def _case(n_stages, seed=0):
    rng = np.random.default_rng(seed)
    ws = torch.from_numpy(rng.normal(size=(n_stages, 16, 16))
                          .astype(np.float32) * 0.1)
    micro = torch.from_numpy(rng.normal(size=(5, 8, 16)).astype(np.float32))
    exp = micro
    for s in range(n_stages):
        exp = torch.einsum("mbf,fg->mbg", exp, ws[s]) + 1.0
    return [lambda p, x: x @ p["w"] + 1.0] * n_stages, {"w": ws}, micro, exp


@pytest.fixture(scope="module")
def oa_schedule():
    dyn = DynamicScheduler(paper_system("pcie4"), PerfModel())
    return dyn, dyn.submit(WL_A)


def test_pipeline_executor_multi_device():
    fns, params, micro, exp = _case(4)
    ex = PipelineExecutor(fns, params, (8, 16), mesh=cpu_slots(4))
    out = ex(micro)
    assert float((out - exp).abs().max()) < 1e-5


def test_grouped_pipeline_executor_multi_device():
    """DP-sized stage groups (2, 1, 1) on 4 slots: the group heads chain
    the stage functions like a sequential reference."""
    fns, params, micro, exp = _case(3)
    ex = GroupedPipelineExecutor(fns, params, (8, 16), (2, 1, 1),
                                 mesh=cpu_slots(4))
    assert ex.heads == (0, 2, 3) and ex.stage_devices == (CPU,) * 3
    out = ex(micro)
    assert float((out - exp).abs().max()) < 1e-5


@pytest.mark.parametrize("groups", [None, (2, 1, 1), (1, 3, 1)])
def test_mesh_executor_equals_the_single_device_executor(groups):
    fns, params, micro, _ = _case(3, seed=1)
    if groups is None:
        one = PipelineExecutor(fns, params, (8, 16), device="cpu")
        mesh = PipelineExecutor(fns, params, (8, 16), mesh=cpu_slots(3))
    else:
        one = GroupedPipelineExecutor(fns, params, (8, 16), groups,
                                      device="cpu")
        mesh = GroupedPipelineExecutor(fns, params, (8, 16), groups,
                                       mesh=cpu_slots(sum(groups)))
    assert torch.equal(mesh(micro), one(micro))


def test_mesh_slot_count_must_match_the_pipeline():
    fns, params, _, _ = _case(3)
    with pytest.raises(ValueError, match="slots"):
        PipelineExecutor(fns, params, (8, 16), mesh=cpu_slots(4))
    with pytest.raises(ValueError, match="slots"):
        GroupedPipelineExecutor(fns, params, (8, 16), (2, 1, 1),
                                mesh=cpu_slots(3))


def test_backend_mesh_mode_multi_device(oa_schedule):
    """The DP's OA schedule lowered onto the grouped executor with slot
    groups sized by Stage.n; completion times equal the analytic model's."""
    dyn, res = oa_schedule
    be = TorchPipelineBackend(mode="mesh", act_dim=4, act_batch=2,
                              device="cpu", mesh=cpu_slots(8))
    h = be.prepare(res, WL_A, epoch=dyn.epoch)
    assert isinstance(h.payload, GroupedPipelineExecutor)
    assert h.payload.group_sizes == tuple(
        s.n for s in res.pipeline.stages)
    rep = be.execute(h, 3, 0.0)
    ana = AnalyticBackend()
    assert rep.finishes == ana.execute(ana.prepare(res, WL_A), 3, 0.0).finishes
    assert rep.wall > 0.0
    assert len(rep.measured) == len(res.pipeline.stages)
    # the stages overlap: the wall is shared by the schedule's stage weights
    est = rep.stage_times
    assert rep.measured == pytest.approx(
        tuple(rep.wall * e / sum(est) for e in est))
    # the same proxy stages as the chain, one microbatch a round
    chain = TorchPipelineBackend(mode="chain", act_dim=4, act_batch=2,
                                 device="cpu").prepare(res, WL_A).payload
    m = be._micro(3)
    torch.testing.assert_close(h.payload(m), chain(m), atol=1e-6, rtol=1e-6)


def test_backend_mesh_mode_on_groups_of_several_cards():
    """OP on the H100 node is 2H3H, stage groups of 2 and 3 cards: the
    second head sits on slot 2, and the outputs match the chain's."""
    wl = gcn_workload(DATASETS["OP"])
    dyn = DynamicScheduler(h100_system(), PerfModel())
    res = dyn.submit(wl)
    sizes = tuple(s.n for s in res.pipeline.stages)
    assert sizes == (2, 3)
    be = TorchPipelineBackend(mode="mesh", act_dim=4, act_batch=2,
                              device="cpu", mesh=cpu_slots(5))
    h = be.prepare(res, wl, epoch=dyn.epoch)
    assert h.payload.group_sizes == sizes
    assert h.payload.heads == (0, 2)
    chain = TorchPipelineBackend(mode="chain", act_dim=4, act_batch=2,
                                 device="cpu").prepare(res, wl).payload
    m = be._micro(5)
    torch.testing.assert_close(h.payload(m), chain(m), atol=1e-6, rtol=1e-6)


def test_mesh_mode_raises_without_cards_or_a_mesh(oa_schedule):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    dyn, res = oa_schedule
    be = TorchPipelineBackend(mode="mesh", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        be.prepare(res, WL_A, epoch=dyn.epoch)
    small = TorchPipelineBackend(mode="mesh", device="cpu",
                                 mesh=cpu_slots(1))
    with pytest.raises(ValueError, match="needs 2 devices"):
        small.prepare(res, WL_A, epoch=dyn.epoch)


def test_auto_runs_the_chain_on_the_cpu(oa_schedule):
    dyn, res = oa_schedule
    assert len(res.pipeline.stages) > 1
    for mesh in (None, cpu_slots(8)):
        be = TorchPipelineBackend(mode="auto", device="cpu", mesh=mesh)
        assert isinstance(be.prepare(res, WL_A).payload, StageChain)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_raises_with_too_few_devices(multi_pod):
    if torch.cuda.is_available() and torch.cuda.device_count() >= 512:
        pytest.skip("enough cards for the production mesh")
    with pytest.raises(RuntimeError, match="needs (256|512) CUDA devices"):
        make_production_mesh(multi_pod=multi_pod)


def test_meshes_of_explicit_slots():
    m = make_mesh((2, 3), ("data", "model"), devices=["cpu"] * 6)
    assert isinstance(m, Mesh) and m.shape == {"data": 2, "model": 3}
    assert m.slots("model") == (CPU,) * 3
    assert cpu_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((4,), ("stage",), devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            make_mesh((1,), ("stage",))
        with pytest.raises(RuntimeError, match="CUDA device"):
            make_mesh((1,), ("stage",), devices=["cuda"])


def test_serve_pipeline_on_a_mesh_equals_one_device():
    """The GCN's four stages on four slots, scheduled on the H100 node."""
    kw = dict(scale=0.006024, device="cpu", system=h100_system())
    one = serve("OA", 3, **kw)
    mesh = serve("OA", 3, mesh=cpu_slots(4), **kw)
    assert torch.equal(mesh.out, one.out) and mesh.max_err < 1e-3
    assert one.plan.pipeline.stages[0].dev.name.startswith("H100")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_one_card_mesh_equals_the_single_card_executor(cuda,
                                                            oa_schedule):
    """Four slots that are all one card: the handovers are same-card
    copies, so the GCN's output equals the single-card executor's bit for
    bit; the mesh backend's finishes equal the analytic ones."""
    kw = dict(scale=0.006024, device=cuda, system=h100_system())
    mesh = make_mesh((4,), ("stage",), devices=[cuda] * 4)
    assert torch.equal(serve("OA", 3, mesh=mesh, **kw).out,
                       serve("OA", 3, **kw).out)
    dyn, res = oa_schedule
    be = TorchPipelineBackend(mode="mesh", device=cuda, mesh=mesh)
    rep = be.execute(be.prepare(res, WL_A), 3, 0.0)
    ana = AnalyticBackend()
    assert rep.finishes == ana.execute(ana.prepare(res, WL_A), 3, 0.0).finishes
