"""The benchmark's CPU tests: ``pytest perfbench/tests`` from the root of
the checkout. They import the harness (``perfbench/``) and the program
(``src/``) side by side; tests marked ``cuda`` decide inside the test
whether a card exists."""
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
for p in (ROOT / "src", HERE.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def configs() -> list:
    """The configurations' files, as BENCHMARK.json names them."""
    import harness
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    return [json.loads((harness.ROOT / c["file"]).read_text())
            for c in bench["configs"]]


def smoke_cell(name: str, **mix):
    """``name``'s cell with the program's smoke configuration of its
    architecture as run and its traffic mix cut to ``mix``."""
    import dataclasses

    import harness
    from repro_torch.configs import get_smoke
    cell = harness.load_cell(name)
    arch = cell.as_run["name"]
    cell.config = dict(cell.config,
                       as_run=dataclasses.asdict(get_smoke(arch)))
    cell.mix = dict(cell.mix, **mix)
    return cell


SMOKE_MIX = {
    "mamba2-780m.prefill-20x32k": dict(batch=4, seq_len=256, pool=2,
                                      check_rows=4),
    "mamba2-780m.train-16x4k": dict(batch=4, seq_len=128, pool=4,
                                    reference_rows=2),
}
