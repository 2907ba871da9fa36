"""The TENANTS_SLO grid of benchmarks/scenario_matrix.py through both
packages, on the analytic and the torch-CPU backends (the rest of the
port's multi-tenant serving is in tests/test_torch_tenancy.py; this case
is its own file, so that ``--dist loadfile`` runs it beside the others)."""
import pytest

torch = pytest.importorskip("torch")

from cluster_harness import (TENANTS_SLO, TORCH_CPU,
                             assert_same_as_reference,
                             delivered_nothing_cancelled, replay)
from replay_harness import Scenario


@pytest.mark.parametrize("backend", ["analytic", "torch"])
def test_preemption_heavy_grid_replays_byte_identically(backend, tmp_path):
    """The TENANTS_SLO grid of benchmarks/scenario_matrix.py:_mt_cells and
    its no-preemption twin through both packages; the port's preempting
    run replays its recorded log byte for byte; the benchmark's gates
    (gold p99 at most half the twin's, bronze goodput >= 0.7) hold."""
    kw = TORCH_CPU if backend == "torch" else {}
    base = dict(tenants=TENANTS_SLO, duration=12.0, peak=20.0, trough=16.0,
                use_swa_mix=True, starve_after=15.0)
    sc = Scenario(**base)
    _, pre = assert_same_as_reference(sc, tmp_path, **kw)
    assert pre.snap.preemptions > 0
    again = replay(sc, pre, tmp_path, **kw)
    assert again.snap.tenants == pre.snap.tenants
    delivered_nothing_cancelled(pre)
    _, twin = assert_same_as_reference(Scenario(**base, preempt=False),
                                       tmp_path, **kw)
    assert twin.snap.preemptions == 0
    g_pre, g_twin = (r.snap.tenants["gold"] for r in (pre, twin))
    b_pre, b_twin = (r.snap.tenants["bronze"] for r in (pre, twin))
    assert g_pre["p99_latency"] <= 0.5 * g_twin["p99_latency"]
    assert b_pre["completed"] / b_twin["completed"] >= 0.70
