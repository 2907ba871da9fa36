"""The port's training loop restarted from its checkpoints on the CPU:
``launch/train.py``'s loop replays an uninterrupted run's losses and
parameters bit for bit after a crash, ``examples/train_e2e_torch.py``
reports its restart replay exact, and a checkpoint written on one device
restores into the shards of any mesh shape. (The rest of the training
path is in tests/test_torch_train.py; the restart on a (2, 2) gloo world
is in tests/test_torch_dist.py.)
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


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_one_device_checkpoint_restores_on_a_mesh(tmp_path, shape):
    """qwen3-8b smoke (fsdp, int8 AdamW moments) trained 3 steps on one
    device with a checkpoint at step 2: restored into the shards of every
    rank of a ``shape`` (data, model) mesh (``restore_pytree`` with the
    specs of ``model_decls``/``opt_state_decls`` at the mesh's sizes; no
    collective), each rank's leaves have the local shapes and dtypes, and
    put back together (``dist.unshard``) they are the one-device restore
    bit for bit, the int8 codes as the padded full rows."""
    import types
    from repro_torch.checkpoint import restore_pytree
    from repro_torch.launch.dist import local_shape, unshard
    from repro_torch.models.common import AxisEnv, param_specs, tree_map
    from repro_torch.models.lm import model_decls
    from repro_torch.optim import AdamWConfig, opt_state_decls
    cfg = tconfigs.get_smoke("qwen3-8b").replace(fsdp=True,
                                                 opt_state_dtype="int8")
    res = train_cli.train(cfg, steps=3, batch=2, seq=64, ckpt_every=2,
                          ckpt_dir=tmp_path, device="cpu")
    one = restore_pytree({"opt": res.opt, "params": res.params, "step": 0},
                         tmp_path, 2)
    ax = AxisEnv(sizes=dict(zip(("data", "model"), shape)))
    pdecls = model_decls(cfg, ax)
    decls = {"opt": opt_state_decls(pdecls, AdamWConfig(
        state_dtype="int8")), "params": pdecls}
    specs = {**tree_map(lambda d: d.spec, decls), "step": ()}
    template = {**tree_map(lambda d: torch.zeros(
        local_shape(d.shape, d.spec, ax), dtype=d.dtype or cfg.pdtype),
        decls), "step": 0}
    coords = [{"data": i, "model": j} for i in range(shape[0])
              for j in range(shape[1])]
    ranks = [restore_pytree(template, tmp_path, 2, specs=specs,
                            mesh=types.SimpleNamespace(ax=ax, coords=c))
             for c in coords]
    flat = [dict(tree_leaves(r)) for r in ranks]
    spec_of, like = dict(tree_leaves(specs)), dict(tree_leaves(template))
    cut = set()
    for path, want in tree_leaves(one):
        if not isinstance(want, torch.Tensor):
            assert all(int(f[path]) == 2 for f in flat)
            continue
        for f in flat:
            assert f[path].shape == like[path].shape, path
            assert f[path].dtype == like[path].dtype, path
        cut |= {e for e in spec_of[path] if e is not None}
        got = unshard([f[path] for f in flat], coords, spec_of[path], ax)
        assert torch.equal(got, want), path
    assert cut == {"data", "model"}        # leaves cut over both groups


def test_example_train_e2e_torch_restart_on_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, str(REPO / "examples" / "train_e2e_torch.py"),
         "--steps", "24", "--ckpt-every", "8", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "restart replay exact on 3 overlap steps" in r.stdout
