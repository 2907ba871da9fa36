"""The port's optimizer substrate vs the JAX reference: AdamW in each state
dtype over three steps, int8 blockwise quantization, the cosine schedule
and error-feedback top-k compression.

The reference runs op by op (eagerly), as the port does, on the same numpy
inputs. Tolerances: float32 parameters within 1e-6 relative (the global
norm and the bias corrections' powers are computed in another order or
library, so an ulp may differ); bfloat16 at one bf16 ulp; the int8 codes
and scales equal (the gradients are kept under the clip, so the moments
do not depend on the norm, and every bfloat16 op rounds where the
reference's does); ``tests/test_optim.py``'s 1e-6 and 1e-5 for the top-k
compression.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models.common import ParamDecl, init_params, tree_leaves
from repro_torch.optim import (AdamWConfig, CompressionState, adamw_init,
                               adamw_update, cosine_schedule,
                               init_compression, opt_state_decls,
                               topk_compress_update)
from repro_torch.optim.adamw import (BLOCK, dequantize_blockwise,
                                     global_norm, quantize_blockwise)

SHAPES = {"a": (3, 300), "b": {"c": (2, 4, 260), "d": (7,)}}


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    from repro import optim
    from repro.optim import adamw
    return jax, optim, adamw


def _tree(rng, shapes, scale):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (scale * rng.normal(size=shapes)).astype(np.float32)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


def _leaves(tree):
    return [v for _, v in tree_leaves(tree)]


def _run_both(jref, state_dtype, param_dtype, steps=3):
    jax, optim, _ = jref
    jnp = jax.numpy
    rng = np.random.default_rng(0)
    p0 = _tree(rng, SHAPES, 1.0)
    gs = [_tree(rng, SHAPES, 0.01) for _ in range(steps)]   # norm < clip
    cfg = AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    jd = jnp.bfloat16 if param_dtype == torch.bfloat16 else jnp.float32
    rp = _map(lambda a: jnp.asarray(a).astype(jd), p0)
    ropt = optim.adamw_init(rp, optim.AdamWConfig(lr=1e-2,
                                                  state_dtype=state_dtype))
    tp = _map(lambda a: torch.from_numpy(a).to(param_dtype), p0)
    topt = adamw_init(tp, cfg)
    for i, g in enumerate(gs):
        lr_scale = 0.3 + 0.2 * i
        rp, ropt, rgn = optim.adamw_update(
            rp, _map(lambda a: jnp.asarray(a).astype(jd), g), ropt,
            optim.AdamWConfig(lr=1e-2, state_dtype=state_dtype), lr_scale)
        tp, topt, tgn = adamw_update(
            tp, _map(lambda a: torch.from_numpy(a).to(param_dtype), g),
            topt, cfg, lr_scale)
        np.testing.assert_allclose(float(tgn), float(rgn), rtol=1e-6)
    assert int(topt["step"]) == int(ropt["step"]) == steps
    return rp, ropt, tp, topt


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_three_steps_match_reference_float32_params(jref, state_dtype):
    rp, ropt, tp, topt = _run_both(jref, state_dtype, torch.float32)
    for r, t in zip(jref[0].tree.leaves(rp), _leaves(tp)):
        np.testing.assert_allclose(_np(t), _np(r), rtol=1e-6, atol=1e-7)
    _check_moments(jref, state_dtype, ropt, topt)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_three_steps_match_reference_bf16_params(jref, state_dtype):
    rp, ropt, tp, topt = _run_both(jref, state_dtype, torch.bfloat16)
    for r, t in zip(jref[0].tree.leaves(rp), _leaves(tp)):
        assert t.dtype == torch.bfloat16
        r, t = _np(r), _np(t)
        assert (np.abs(t - r) <= 2 ** -7 * np.abs(r)).all()   # one ulp
    _check_moments(jref, state_dtype, ropt, topt)


def _check_moments(jref, state_dtype, ropt, topt):
    jax = jref[0]
    for name in ("mu", "nu"):
        rl = jax.tree.leaves(ropt[name])
        # int8 {"codes", "scale"} leaves flatten in sorted key order
        tl = _leaves(topt[name])
        assert len(tl) == len(rl)
        if state_dtype == "int8":
            for r, t in zip(rl, tl):
                if t.dtype == torch.int8:
                    np.testing.assert_array_equal(t.numpy(), np.asarray(r))
                else:
                    np.testing.assert_array_equal(t.numpy(),
                                                  np.asarray(r, np.float32))
        elif state_dtype == "bfloat16":
            for r, t in zip(rl, tl):
                r, t = _np(r), _np(t)
                assert (np.abs(t - r) <= 2 ** -7 * np.abs(r)).all()
        else:
            for r, t in zip(rl, tl):
                np.testing.assert_allclose(_np(t), _np(r), rtol=1e-6,
                                           atol=1e-12)


def test_update_in_pieces_equals_the_whole(monkeypatch):
    """The update takes one layer of a stacked leaf, or PIECE elements of a
    2-D leaf, at a time: the same bits as one piece, in every dtype."""
    from repro_torch.optim import adamw
    for state_dtype in ("float32", "bfloat16", "int8"):
        outs = []
        for piece in (1 << 26, 300):
            monkeypatch.setattr(adamw, "PIECE", piece)
            p = _map(torch.from_numpy, _tree(np.random.default_rng(1),
                                             SHAPES, 1.0))
            g = _map(torch.from_numpy, _tree(np.random.default_rng(2),
                                             SHAPES, 0.5))
            cfg = AdamWConfig(state_dtype=state_dtype)
            opt = adamw_init(p, cfg)
            for _ in range(2):
                p, opt, _ = adamw_update(p, g, opt, cfg, 0.7)
            outs.append(_leaves(p) + _leaves(opt["mu"]) + _leaves(opt["nu"]))
        for a, b in zip(*outs):
            assert torch.equal(a, b)


def test_quantize_blockwise_matches_reference(jref):
    _, _, adamw = jref
    x = np.random.default_rng(1).normal(size=(3, 700)).astype(np.float32)
    x[0, :5] = [0.5, -0.5, 1.5, 2.5, 0.0]        # halves: round to even
    for round_up in (False, True):
        rc, rs = adamw.quantize_blockwise(x, round_up=round_up)
        tc, ts = quantize_blockwise(torch.from_numpy(x), round_up=round_up)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
        back = dequantize_blockwise(tc, ts, x.shape)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(adamw.dequantize_blockwise(
                rc, rs, x.shape)))
        assert back.shape == x.shape
    tc, ts = quantize_blockwise(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and tc.shape == (3, 768)
    assert ts.shape == (3, 768 // BLOCK)
    rel = float((dequantize_blockwise(tc, ts, x.shape)
                 - torch.from_numpy(x)).abs().max() / np.abs(x).max())
    assert rel < 0.02


def test_opt_state_decls_match_reference(jref):
    jax, optim, _ = jref
    from repro.models.common import ParamDecl as RDecl
    shapes = {"w": (4, 300), "s": {"b": (2, 3, 16)}}
    rd = _map(lambda s: RDecl(s, jax.sharding.PartitionSpec()), shapes)
    td = _map(lambda s: ParamDecl(s), shapes)
    for sd in ("float32", "bfloat16", "int8"):
        r = optim.opt_state_decls(rd, optim.AdamWConfig(state_dtype=sd))
        t = opt_state_decls(td, AdamWConfig(state_dtype=sd))
        rl = jax.tree.leaves(r, is_leaf=lambda x: isinstance(x, RDecl))
        tl = _leaves(t)
        assert [tuple(d.shape) for d in tl] == [tuple(d.shape) for d in rl]
        assert [str(d.dtype).split(".")[-1] for d in tl] == \
            [np.dtype(d.dtype).name for d in rl]
        z = init_params(t, None, "cpu")
        assert int(z["step"]) == 0 and z["step"].dtype == torch.int32


def test_cosine_schedule_matches_reference(jref):
    jax, optim, _ = jref
    for step in [0, 1, 50, 99, 100, 101, 2500, 9999, 10000, 12000]:
        r = float(optim.cosine_schedule(jax.numpy.int32(step)))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            t = cosine_schedule(s)
            assert t.dtype == torch.float32
            assert float(t) == pytest.approx(r, rel=1e-6, abs=1e-7)
    for kw in ({"warmup": 10, "total": 100}, {"min_ratio": 0.0}):
        for step in (0, 5, 10, 55, 100, 200):
            assert float(cosine_schedule(step, **kw)) == pytest.approx(
                float(optim.cosine_schedule(jax.numpy.int32(step), **kw)),
                rel=1e-6, abs=1e-7)


def test_global_norm_matches_reference(jref):
    jax, _, adamw = jref
    tree = _tree(np.random.default_rng(4), SHAPES, 1.0)
    r = adamw.global_norm(_map(jax.numpy.asarray, tree))
    t = global_norm(_map(torch.from_numpy, tree))
    assert float(t) == pytest.approx(float(r), rel=1e-6)


@pytest.mark.parametrize("ratio", [0.1, 0.05])
def test_topk_compression_matches_reference(jref, ratio):
    jax, optim, _ = jref
    rng = np.random.default_rng(2)
    g = {"w": rng.normal(size=(64, 64)).astype(np.float32),
         "s": {"v": rng.normal(size=(100,)).astype(np.float32)}}
    g["w"][0, :8] = 3.0                      # ties at the top
    rs = optim.init_compression(_map(jax.numpy.asarray, g))
    ts = init_compression(_map(torch.from_numpy, g))
    assert isinstance(ts, CompressionState)
    for step in range(3):
        gi = g if step == 0 else _map(lambda a: 0.5 * a, g)
        rsend, rs = optim.topk_compress_update(
            _map(jax.numpy.asarray, gi), rs, ratio=ratio)
        tsend, ts = topk_compress_update(_map(torch.from_numpy, gi), ts,
                                         ratio=ratio)
        for a, b in zip(_leaves(tsend), jax.tree.leaves(rsend)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        for a, b in zip(_leaves(ts.residual), jax.tree.leaves(rs.residual)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_topk_compression_error_feedback():
    """``tests/test_optim.py``'s property on the port: ~ratio of the entries
    sent, nothing lost, the residual flushed by zero gradients."""
    grads = {"w": torch.from_numpy(np.random.default_rng(2).normal(
        size=(64, 64)).astype(np.float32))}
    state = init_compression(grads)
    send, state = topk_compress_update(grads, state, ratio=0.1)
    assert 0.05 < float((send["w"] != 0).float().mean()) < 0.2
    torch.testing.assert_close(send["w"] + state.residual["w"], grads["w"],
                               atol=1e-6, rtol=0)
    total = send["w"]
    for _ in range(40):
        send, state = topk_compress_update({"w": torch.zeros(64, 64)}, state,
                                           ratio=0.1)
        total = total + send["w"]
    torch.testing.assert_close(total + state.residual["w"], grads["w"],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_reduces_quadratic_loss(state_dtype):
    target = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 300)).astype(np.float32))
    params = {"w": torch.zeros((4, 300))}
    cfg = AdamWConfig(lr=5e-2, weight_decay=0.0, state_dtype=state_dtype)
    opt = adamw_init(params, cfg)
    losses = []
    for _ in range(60):
        w = params["w"].clone().requires_grad_()
        loss = ((w - target) ** 2).mean()
        loss.backward()
        params, opt, _ = adamw_update(params, {"w": w.grad}, opt, cfg, 1.0)
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.25 * losses[0]
