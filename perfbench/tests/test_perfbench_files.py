"""Every cell, configuration, traffic mix, limit file and metric of
BENCHMARK.json loads by name, and the file keeps the contract's shape."""
import json
import re

import pytest

import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads(cell):
    c = harness.load_cell(cell)
    assert c.chips == 1
    assert c.mix["kind"] in ("prefill", "train")
    harness.driver(c.mix["kind"]).Driver
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
    assert set(c.limits) and all(v > 0 for v in c.limits.values())


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_builds_the_programs_config(cfg):
    from repro_torch.models.common import ModelConfig
    body = json.loads((harness.ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"]
    assert set(cfg["reduced"]) <= set(body)
    ModelConfig(**body["as_run"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_has_a_family_module(cfg):
    import families
    body = json.loads((harness.ROOT / cfg["file"]).read_text())
    fam = families.load(body["as_run"]["family"])
    for fn in ("layout", "layers", "forward_flops", "ssd_calls", "dims"):
        assert callable(getattr(fam, fn)), fn


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))


def test_names_and_units():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("path", sorted(harness.HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    import ast
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        for n in names:
            assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)
