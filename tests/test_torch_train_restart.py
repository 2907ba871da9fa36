"""The port's training loop restarted from its checkpoints on the CPU:
``launch/train.py``'s loop replays an uninterrupted run's losses and
parameters bit for bit after a crash, and ``examples/train_e2e_torch.py``
reports its restart replay exact. (The rest of the training path is in
tests/test_torch_train.py.)
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs
from repro_torch.launch import train as train_cli
from repro_torch.models.common import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent


def test_train_loop_restart_replays_bit_for_bit(tmp_path):
    """Checkpoints at steps 2 and 4, a crash after step 5, a restart to 8:
    steps 5..7 equal an uninterrupted run's losses and parameters bit for
    bit."""
    cfg = tconfigs.get_smoke("qwen3-4b").replace(attention="swa", window=32)
    kw = dict(batch=2, seq=128, ckpt_every=2, device="cpu")
    whole = train_cli.train(cfg, steps=8, **kw)
    first = train_cli.train(cfg, steps=6, ckpt_dir=tmp_path, **kw)
    again = train_cli.train(cfg, steps=8, ckpt_dir=tmp_path, **kw)
    assert again.start == 5
    assert [first.losses[s] for s in range(6)] == \
        [whole.losses[s] for s in range(6)]
    assert [again.losses[s] for s in range(5, 8)] == \
        [whole.losses[s] for s in range(5, 8)]
    for (_, a), (_, b) in zip(tree_leaves(again.params),
                              tree_leaves(whole.params)):
        assert torch.equal(a, b)
    assert whole.launches == {s: {} for s in range(8)}   # plain on the CPU
    assert all(np.isfinite(list(whole.grad_norms.values())))


def test_example_train_e2e_torch_restart_on_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, str(REPO / "examples" / "train_e2e_torch.py"),
         "--steps", "24", "--ckpt-every", "8", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "restart replay exact on 3 overlap steps" in r.stdout
