"""A whole run of each cell on the CPU at the program's smoke sizes (the
harness's look for a card skipped): the result line's shape, the module
set, and ``correct`` false when the timed path is broken underneath or
the control stands in for the program."""
import json
import subprocess
import sys
import time

import pytest
import torch

import control
import harness
from conftest import SMOKE_MIX, smoke_cell

SEED = 2 ** 33 + 17
CELLS = list(SMOKE_MIX)


def _run(name, wrap=None, seed=SEED):
    cell = smoke_cell(name, **SMOKE_MIX[name])
    return harness.run_cell(cell, seed, 0.2, False, device="cpu",
                            t0=time.perf_counter(), wrap_step=wrap)


@pytest.mark.parametrize("name", CELLS)
def test_line_shape(name):
    line = _run(name)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    cell = harness.load_cell(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = line["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(cell.limits)
    json.dumps(line)


@pytest.mark.parametrize("name,fault", [
    (c, f) for c in CELLS
    for f in control.FAULTS[harness.load_cell(c).mix["kind"]]])
def test_a_fault_is_not_correct(name, fault):
    kind = harness.load_cell(name).mix["kind"]
    assert _run(name, control.FAULTS[kind][fault])["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_the_control_separates(name):
    """At the smoke sizes the control's numbers sit lower than at the
    cell's own (where ``calibrate.py`` read them against the limits); it
    still reads at least three times the program's on one of them."""
    cell = smoke_cell(name, **SMOKE_MIX[name])
    seeds = (SEED, SEED + 1, SEED + 2)
    prog = [_run(name, seed=s)["checks"] for s in seeds]
    ctl = [_run(name, lambda _step: control.control_step(cell),
                seed=s)["checks"] for s in seeds]
    assert any(min(c[k]["value"] for c in ctl)
               >= 3 * max(p[k]["value"] for p in prog) for k in prog[0])


def test_the_prompt_level_control_separates():
    """The prefill control read on the prompts a run checks, without a
    window (as ``calibrate.py`` reads it), is the control step's answer
    to each and separates from the program as a control run does."""
    name = "mamba2-780m.prefill-20x32k"
    cell = smoke_cell(name, **SMOKE_MIX[name])
    seeds = (SEED, SEED + 1, SEED + 2)
    prog = max(_run(name, seed=s)["checks"]["logit_err"]["value"]
               for s in seeds)
    drv = harness.driver("prefill").Driver(cell, SEED, torch.device("cpu"))
    got = control.prefill_control_numbers(drv)
    i, r = drv.served()[-1]
    whole = control.control_step(cell)(
        drv.params, {"tokens": drv.pool[i % len(drv.pool)]})
    assert torch.equal(drv.answer(i, r), whole[r, -1])
    ctl = [control.prefill_control_numbers(harness.driver("prefill").Driver(
        cell, s, torch.device("cpu")))["logit_err"] for s in seeds]
    assert set(got) == {"logit_err"} and got["logit_err"] == ctl[0]
    assert min(ctl) >= 3 * prog


def test_launch_counters_find_the_programs_entries():
    from repro_torch.kernels import ssd
    got = harness.launch_counters()
    assert got["ssd.ssd_chunked"] == ssd.ssd_chunked.launches
    assert all(isinstance(n, int) for n in got.values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.load_cell(name)
    line = harness.run_cell(cell, SEED, 1.0, False, device="cuda",
                            t0=time.perf_counter(),
                            wrap_step=lambda _step: control.control_step(
                                cell))
    assert line["correct"] is False


def test_a_run_loads_no_jax():
    code = (
        "import sys, time; sys.path[:0] = ['perfbench', 'perfbench/tests',"
        " 'src']; import torch; torch.set_num_threads(2);"
        " import harness, conftest;"
        " n = 'mamba2-780m.prefill-20x32k';"
        " c = conftest.smoke_cell(n, **conftest.SMOKE_MIX[n]);"
        " harness.run_cell(c, 1, 0.1, False, device='cpu',"
        " t0=time.perf_counter());"
        " print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))
    assert "repro_torch" in mods
    assert not mods & set(harness.FORBIDDEN)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mamba2-780m.prefill-20x32k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_trace_reduction():
    import devtrace
    t = devtrace.Trace(
        ops=[("ssd_chunk_out", 10, 20), ("sm90_xmma_gemm", 15, 30),
             ("elementwise", 40, 50)],
        ranges=[("perfbench.window", 0, 100), ("perfbench.step", 5, 35),
                ("perfbench.sync", 35, 100)],
        window=(0, 100))
    assert t.busy_s == pytest.approx(30e-6)
    assert t.seconds(devtrace.is_ssd) == pytest.approx(10e-6)
    assert t.seconds(devtrace.is_gemm) == pytest.approx(15e-6)
    gaps = dict(t.idle_gaps())
    assert gaps == pytest.approx({"sync": 50e-6, "window": 10e-6,
                                  "step": 10e-6})
    assert t.top_ops()[0][0] == "sm90_xmma_gemm"
