"""The port's token stream and checkpointing vs the JAX reference:
``synthetic_batch`` bit for bit, the prefetching ``TokenStream`` and its
seek after a restore, save/restore exact in every dtype the training state
holds (bf16 through float32), the async ``Checkpointer`` (commit marker,
discovery, garbage collection), and checkpoints crossing between the two
packages in both directions (the same on-disk layout and leaf order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import (Checkpointer, latest_step, restore_pytree,
                                    save_pytree)
from repro_torch.data import TokenStream, synthetic_batch


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    from repro import checkpoint, data
    return jax, checkpoint, data


def _state(seed=0):
    """A train-state-like tree: bf16 params, float32 and int8 moments, an
    int32 step tensor and a Python int, nested dicts in unsorted order."""
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 6, generator=g).bfloat16(),
                       "b": torch.randn(6, generator=g)},
            "opt": {"mu": {"codes": torch.randint(-127, 128, (4, 256),
                                                  dtype=torch.int8,
                                                  generator=g),
                           "scale": torch.rand(4, 1, generator=g)},
                    "step": torch.tensor(7, dtype=torch.int32)},
            "step": 12}


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)
    else:
        assert int(np.asarray(b)) == a


@pytest.mark.parametrize("step", [0, 1, 17])
def test_synthetic_batch_is_the_reference_bit_for_bit(jref, step):
    ours = synthetic_batch(step, 4, 64, 1000, seed=99)
    theirs = jref[2].synthetic_batch(step, 4, 64, 1000, seed=99)
    for k in ("tokens", "labels"):
        assert ours[k].dtype == theirs[k].dtype == np.int32
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_token_stream_prefetches_and_seeks_after_a_restore():
    stream = TokenStream(2, 32, 500, device="cpu").start(0)
    try:
        for step in range(3):
            b = stream.get(step)
            ref = synthetic_batch(step, 2, 32, 500)
            assert b["tokens"].dtype == torch.int32
            assert b["tokens"].device.type == "cpu"
            np.testing.assert_array_equal(b["tokens"].numpy(), ref["tokens"])
            np.testing.assert_array_equal(b["labels"].numpy(), ref["labels"])
        # a restore sends the loop back: the stream builds the asked step
        b = stream.get(1)
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      synthetic_batch(1, 2, 32, 500)["tokens"])
    finally:
        stream.stop()
    resumed = TokenStream(2, 32, 500, device="cpu").start(5)
    try:
        np.testing.assert_array_equal(resumed.get(5)["tokens"].numpy(),
                                      synthetic_batch(5, 2, 32, 500)["tokens"])
    finally:
        resumed.stop()


def test_save_restore_exact(tmp_path):
    state = _state()
    d = save_pytree(state, tmp_path, 12)
    assert (d / "COMMIT").exists() and latest_step(tmp_path) == 12
    out = restore_pytree(_state(seed=1), tmp_path, 12)
    _equal(state, out)
    # sorted key order: opt.mu.codes, opt.mu.scale, opt.step, params.b,
    # params.w (bf16, through float32 on disk), step
    assert np.load(d / "arr_0.npy").dtype == np.int8
    assert np.load(d / "arr_4.npy").dtype == np.float32
    assert int(np.load(d / "arr_5.npy")) == 12
    with pytest.raises(FileNotFoundError):
        restore_pytree(state, tmp_path, 13)


def test_checkpointer_async_commit_and_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    state = _state()
    for step in (10, 20, 30):
        ck.save(state, step)
        state["params"]["b"].add_(1.0)       # after save: not observed
    ck.wait()
    assert latest_step(tmp_path) == 30
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000020", "step_00000030"]
    out, step = ck.restore_latest(_state(seed=3))
    assert step == 30
    torch.testing.assert_close(out["params"]["b"],
                               state["params"]["b"] - 1.0, atol=0, rtol=0)
    (tmp_path / "step_00000040").mkdir()     # no COMMIT: ignored
    assert latest_step(tmp_path) == 30
    assert Checkpointer(tmp_path / "none").restore_latest(state) == (None,
                                                                      None)


def test_reference_checkpoint_restores_into_the_port(jref, tmp_path):
    """The reference's ``save_pytree`` (leaves in ``jax.tree_util`` order,
    bf16 upcast to float32) restores into the port's template: values
    exact, dtypes the template's."""
    jax, checkpoint, _ = jref
    jnp = jax.numpy
    state = _state()
    ref_tree = jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else t.numpy().dtype)
        if isinstance(t, torch.Tensor) else t, state)
    checkpoint.save_pytree(ref_tree, tmp_path, 5)
    out = restore_pytree(_state(seed=2), tmp_path, 5)
    _equal(state, out)


def test_port_checkpoint_restores_into_the_reference(jref, tmp_path):
    jax, checkpoint, _ = jref
    jnp = jax.numpy
    state = _state()
    save_pytree(state, tmp_path, 6)
    template = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.bfloat16
                                                if t.dtype == torch.bfloat16
                                                else t.numpy().dtype)
                            if isinstance(t, torch.Tensor) else t, state)
    out = checkpoint.restore_pytree(template, tmp_path, 6)
    np.testing.assert_array_equal(
        np.asarray(out["params"]["w"], np.float32),
        state["params"]["w"].float().numpy())
    np.testing.assert_array_equal(np.asarray(out["opt"]["mu"]["codes"]),
                                  state["opt"]["mu"]["codes"].numpy())
    assert int(np.asarray(out["step"])) == 12
