"""The port's H100 system model (``core/device.py:h100_system``, the
``"H100"`` role of ``core/hw_oracle.py`` and ``core/perf_model.py``) and
the N-pool DP held to the reference's:

* a third pool with the H100's figures, built as a ``DeviceType`` in both
  packages (``perf_key="GPU"``, so both price it with the same models), on
  the paper's system: the schedules of all 42 cases (3 modes x GCN and GIN
  on the six Table-I datasets and the two SWA-T workloads) equal;
* the reference's three-pool checks (tests/test_three_pool.py), its TPU
  system check (tests/test_system.py) and its extra-pool engine, router and
  pool-state checks (tests/test_backend.py), with the H100 pools;
* ``fit_models``: the six shared models bit-identical to the reference's,
  the H100 models within a stated relative RMS error of the oracle."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as ref
import repro_torch.core as port
from repro_torch.core import (DATASETS, H100_DENSE, H100_SPARSE,
                              DynamicScheduler, Scheduler,
                              gcn_workload, h100_system, hw_oracle,
                              paper_system, swa_transformer_workload)
from repro_torch.runtime import AnalyticBackend, PoolState
from repro_torch.serving import Engine, Request, Router

from test_torch_core import WORKLOADS, _summary, _workload
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WL_A = gcn_workload(DATASETS["OA"])
WL_L = swa_transformer_workload(1024, 512, layers=2)
# the H100 models' relative RMS error against the oracle on fit_models'
# synthetic points: the oracle's +-4% jitter alone is 2.3% RMS
H100_REL_RMSE = {"spmm": 0.03, "gemm": 0.03, "win_attn": 0.03}


def _h100_pool(core):
    """A third pool with the H100's figures that borrows the paper's dense
    role, built in either package."""
    figures = {f.name: getattr(H100_DENSE, f.name)
               for f in dataclasses.fields(H100_DENSE)}
    figures.update(name="H100_GPU", dyn_power=dict(H100_DENSE.dyn_power),
                   perf_key="GPU")
    return core.DeviceType(**figures)


@pytest.fixture(scope="module")
def models():
    return ref.PerfModel(), port.PerfModel()


@pytest.fixture(scope="module")
def perf(models):
    return models[1]


@pytest.fixture(scope="module")
def three_pool():
    # the paper's testbed (3 FPGA + 2 GPU) plus 2 H100_DENSE cards, priced
    # by their own "H100" role
    return paper_system("pcie4").with_extra((H100_DENSE, 2))


@pytest.mark.parametrize("mode", ["perf", "energy", "balanced"])
@pytest.mark.parametrize("kind,arg", WORKLOADS, ids=str)
def test_three_pool_dp_matches_reference(models, kind, arg, mode):
    ref_pm, port_pm = models
    r = ref.DynamicScheduler(ref.paper_system("pcie4").with_extra(
        (_h100_pool(ref), 2)), ref_pm, mode=mode)
    p = port.DynamicScheduler(port.paper_system("pcie4").with_extra(
        (_h100_pool(port), 2)), port_pm, mode=mode)
    assert _summary(p.submit(_workload(port, kind, arg))) == \
        _summary(r.submit(_workload(ref, kind, arg)))


# ---------------------------------------------------------------------------
# tests/test_three_pool.py with the H100 as the third pool
# ---------------------------------------------------------------------------
def test_three_pool_submit_end_to_end(perf, three_pool):
    dyn = DynamicScheduler(three_pool, perf, mode="perf")
    res = dyn.submit(WL_A)
    stages = res.pipeline.stages
    assert stages[0].i0 == 0 and stages[-1].i1 == len(WL_A)
    assert all(a.i1 == b.i0 for a, b in zip(stages, stages[1:]))
    used = res.pipeline.devices_used()
    for dev, cnt in three_pool.pools:
        assert used.get(dev.name, 0) <= cnt, dev.name
    assert res.throughput > 0 and res.energy > 0
    assert dyn.submit(WL_A) is res
    r2 = dyn.submit(WL_L)
    assert r2 is not res
    dyn.set_mode("energy")
    r3 = dyn.submit(WL_A)
    assert r3.mode == "energy"
    assert r3.energy <= res.energy + 1e-12


def test_third_pool_only_adds_options(perf, three_pool):
    base = Scheduler(paper_system("pcie4"), perf).schedule(WL_A, "perf")
    sched3 = Scheduler(three_pool, perf)
    best3 = sched3.schedule(WL_A, "perf")
    assert best3.throughput >= base.throughput - 1e-9
    eps = sched3.endpoints(WL_A)
    assert all(len(counts) == 3 for counts, _, _ in eps)
    assert any(counts[2] > 0 for counts, _, _ in eps)


def test_three_pool_resize_keeps_extra_pool(perf, three_pool):
    dyn = DynamicScheduler(three_pool, perf, mode="perf")
    dyn.submit(WL_A)
    dyn.resize(0, 0)                    # both primary pools fail
    res = dyn.submit(WL_A)              # the H100 pool keeps serving
    assert all(s.dev.name == "H100_DENSE" for s in res.pipeline.stages)
    assert res.pipeline.devices_used().get("H100_DENSE", 0) <= 2


# ---------------------------------------------------------------------------
# tests/test_system.py:121 for h100_system
# ---------------------------------------------------------------------------
def test_h100_system_scheduling(perf):
    """The same DP schedules an H100 node (a sparse and a dense pool of the
    card over NVLink 4): no PCIe root-complex conflict model, and a
    schedule for OA on the H100 role's models."""
    system = h100_system(n_sparse=3, n_dense=2)
    assert (system.dev_a, system.n_a, system.dev_b, system.n_b) == \
        (H100_SPARSE, 3, H100_DENSE, 2)
    assert system.interconnect is port.INTERCONNECTS["nvlink4"]
    sched = Scheduler(system, perf)
    assert not sched.conflict
    r = sched.schedule(WL_A, "perf")
    assert r.throughput > 0 and r.pipeline.stages
    assert {s.dev.name for s in r.pipeline.stages} <= {"H100_SPARSE",
                                                       "H100_DENSE"}
    # priced by the H100 role: each stage's time is the H100 models'
    for s in r.pipeline.stages:
        assert s.t_exec == pytest.approx(sum(
            perf.kernel_time(WL_A[i], s.dev, s.n) for i in range(s.i0, s.i1)))


def test_nvlink4_is_point_to_point_over_the_pcie4_figure():
    ic = port.INTERCONNECTS["nvlink4"]
    assert ic.p2p and not ic.name.startswith(("PCIe", "CXL"))
    # 450 GB/s a direction a GPU, in link_bw's PCIe 4.0 x16 convention
    assert H100_DENSE.link_bw * ic.scale == pytest.approx(450.0)
    assert H100_SPARSE.perf_key == H100_DENSE.perf_key == "H100"


# ---------------------------------------------------------------------------
# tests/test_backend.py's extra-pool checks with the H100 pool
# ---------------------------------------------------------------------------
class FakeBatch:
    def __init__(self, wl, n):
        self.wl = wl
        self.n = n

    def __len__(self):
        return self.n


def test_engine_does_not_oversubscribe_extra_pools(perf, three_pool):
    dyn = DynamicScheduler(three_pool, perf, mode="perf")
    eng = Engine(dyn, AnalyticBackend(), max_cells=2)
    eng.dispatch(FakeBatch(WL_A, 2), 0.0)
    eng.dispatch(FakeBatch(WL_L, 2), 0.0)
    used = eng.allocated()
    for dev, cnt in three_pool.pools:
        assert used.get(dev.name, 0) <= cnt, (dev.name, used)


def test_router_ignores_elastic_events_on_extra_pools(perf, three_pool):
    dyn = DynamicScheduler(three_pool, perf, mode="perf")
    r = Router(dyn)
    r.submit(Request(0, WL_A, 0.0), 0.0)
    r.step(1.0)
    epoch = dyn.epoch
    r.on_failure("H100_DENSE", 1)       # no ValueError, no resize
    assert dyn.epoch == epoch
    assert any("unmanaged" in line for line in r.log)
    r.on_join("H100_DENSE", 1)
    assert dyn.epoch == epoch


def test_pool_state_rejects_unmanaged_pool_names(three_pool):
    pool = PoolState(three_pool.n_a, three_pool.n_b)
    with pytest.raises(ValueError):
        pool.adjust(three_pool, "H100_DENSE", -1)
    assert pool.n_a == three_pool.n_a and pool.n_b == three_pool.n_b
    assert not PoolState.manages(three_pool, "H100_DENSE")
    assert PoolState.manages(three_pool, "FPGA")


# ---------------------------------------------------------------------------
# the oracle role and the fitted models
# ---------------------------------------------------------------------------
def test_fit_models_keeps_the_shared_models_and_fits_h100(models):
    ref_models, port_models = (pm.models for pm in models)
    assert set(port_models) == set(ref_models) | {
        ("H100", "spmm"), ("H100", "gemm"), ("H100", "win_attn")}
    for key, m in ref_models.items():
        assert np.array_equal(port_models[key].coef, m.coef), key
        assert port_models[key].rel_rmse == m.rel_rmse, key
    for kind, bound in H100_REL_RMSE.items():
        assert port_models[("H100", kind)].rel_rmse < bound, kind


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_h100_oracle_is_closed_form_and_positive(name):
    for k in list(gcn_workload(DATASETS[name]))[:2] + [WL_L[1]]:
        t = hw_oracle.measure(k, "H100")
        assert 0 < t < 1.0 and t == hw_oracle.measure(k, "H100")
        # operator parallelism keeps measure_multi's formula
        assert hw_oracle.measure_multi(k, "H100", 2) < t


def test_h100_win_attn_prices_the_band_only():
    """Doubling the sequence at a fixed window about doubles B2's time; the
    MI210 curve, which prices dense attention, about quadruples."""
    short, long_ = (swa_transformer_workload(s, 512)[1]
                    for s in (8192, 16384))
    h100 = hw_oracle.measure(long_, "H100") / hw_oracle.measure(short,
                                                                "H100")
    mi210 = hw_oracle.measure(long_, "GPU") / hw_oracle.measure(short, "GPU")
    assert 1.8 < h100 < 2.2 and mi210 > 3.5


def test_cli_stream_over_nvlink4_torch_cpu_matches_analytic():
    """``serve --stream --interconnect nvlink4`` (the paper's pools over
    NVLink 4, through INTERCONNECTS): the torch backend on the CPU prints
    what the analytic one prints, but its wall lines."""
    import contextlib
    import io

    from repro_torch.launch import serve as serve_cli

    def run(*extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            serve_cli.main(["--stream", "--duration", "40", "--day", "40",
                            "--interconnect", "nvlink4", *extra])
        return [line.replace(f"backend={extra[1]} ", "backend=* ")
                for line in out.getvalue().splitlines()
                if "wall" not in line]

    analytic = run("--backend", "analytic")
    assert any(line.startswith("[serve] completed=") for line in analytic)
    assert run("--backend", "torch", "--device", "cpu") == analytic
