"""Port Multi-head Latent Attention (``models/mla.py``, deepseek v2/v3) vs
the JAX reference: declarations, the expanded full-sequence path
(``mla_train``), the absorbed decode step and its latent cache, and the
absorbed decode against the port's own expanded path.

Weights are the reference's ``init_params(PRNGKey(0))`` of the MLA
declarations, carried as numpy; the norm scales, which it sets to 1, are
redrawn so that a dropped norm would show. Inputs are numpy draws from a
seed; the reference runs compiled. Tolerances: float32 1e-5
(``tests/test_torch_lm.py``'s attention), the decode step 2e-5
(``tests/test_torch_decode.py``'s), bfloat16 2e-2 of the largest output;
the absorbed decode against the expanded path 1e-5 of the largest output
(the same function, products in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs
from repro_torch.models import mla as tmla
from repro_torch.models.common import tree_leaves, tree_map


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import repro.configs as configs
    import repro.models as models
    from repro.models import mla
    return jax, configs, models, mla


def _cfgs(jref, dtype="float32", arch="deepseek-v2-236b", **kw):
    _, configs, _, _ = jref
    kw = {"param_dtype": dtype, "compute_dtype": dtype, **kw}
    return (configs.get_smoke(arch).replace(**kw),
            tconfigs.get_smoke(arch).replace(**kw))


def _params(jref, rcfg, cfg, seed=0):
    """(reference MLA params as jnp arrays, the same in the port)."""
    jax, _, models, mla = jref
    tree = jax.tree.map(np.asarray, models.init_params(
        mla.mla_decls(rcfg, models.CPU_AXES), jax.random.PRNGKey(seed),
        rcfg.pdtype))
    rng = np.random.default_rng(seed + 1)
    for k in ("kv_norm", "q_norm"):
        if k in tree:
            tree[k] = (1 + 0.2 * rng.normal(size=tree[k].shape)).astype(
                tree[k].dtype)
    ours = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        cfg.pdtype), tree)
    return jax.tree.map(jax.numpy.asarray, tree), ours


def _x(cfg, B, S, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _share(out, exp):
    return float(np.abs(out - exp).max() / np.abs(exp).max())


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
@pytest.mark.parametrize("get", ["get_smoke", "get_config"])
@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "wq"])
def test_mla_decls_match_reference(jref, arch, get, q_lora):
    _, configs, models, mla = jref
    rcfg = getattr(configs, get)(arch)
    cfg = getattr(tconfigs, get)(arch)
    if not q_lora:
        rcfg, cfg = rcfg.replace(q_lora_rank=0), cfg.replace(q_lora_rank=0)
    for stack in (None, 3):
        exp = {p: tuple(d.shape) for p, d in tree_leaves(
            mla.mla_decls(rcfg, models.CPU_AXES, stack))}
        out = {p: tuple(d.shape) for p, d in tree_leaves(
            tmla.mla_decls(cfg, stack))}
        assert out == exp
        assert ("['wq_a']" in out) == q_lora


@pytest.mark.parametrize("kw", [{}, {"v_head_dim": 24}, {"q_lora_rank": 0}],
                         ids=["v-padded", "v-unpadded", "no-q-lora"])
def test_mla_train_matches_reference(jref, kw):
    """The smoke config's v_head_dim (16) is below nope + rope (24), so v
    is padded; the cases also take it unpadded and q without the LoRA."""
    jax, _, _, mla = jref
    rcfg, cfg = _cfgs(jref, **kw)
    rp, tp = _params(jref, rcfg, cfg)
    x = _x(cfg, 2, 96)
    pos = np.broadcast_to(np.arange(96), (2, 96))
    exp = jax.jit(lambda p, xx, ps: mla.mla_train(p, xx, ps, rcfg))(
        rp, jax.numpy.asarray(x), jax.numpy.asarray(pos))
    with torch.inference_mode():
        out = tmla.mla_train(tp, torch.from_numpy(x), torch.from_numpy(
            np.ascontiguousarray(pos)), cfg)
    assert out.shape == (2, 96, cfg.d_model)
    np.testing.assert_allclose(_np(out), _np(exp), atol=1e-5, rtol=1e-5)


def test_mla_train_matches_reference_bf16(jref):
    jax, _, _, mla = jref
    rcfg, cfg = _cfgs(jref, "bfloat16")
    rp, tp = _params(jref, rcfg, cfg)
    x = _x(cfg, 2, 96)
    pos = np.broadcast_to(np.arange(96), (2, 96))
    exp = jax.jit(lambda p, xx, ps: mla.mla_train(p, xx, ps, rcfg))(
        rp, jax.numpy.asarray(x, rcfg.cdtype), jax.numpy.asarray(pos))
    with torch.inference_mode():
        out = tmla.mla_train(tp, torch.from_numpy(x).to(torch.bfloat16),
                             torch.from_numpy(np.ascontiguousarray(pos)), cfg)
    assert out.dtype == torch.bfloat16
    assert _share(_np(out), _np(exp)) <= 2e-2


def _decode(step, params, xs, cache, to_np):
    outs = []
    for pos in range(xs.shape[1]):
        y, cache = step(params, xs[:, pos:pos + 1], pos, cache)
        outs.append(to_np(y)[:, 0])
    return np.stack(outs, 1), cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_step_matches_reference(jref, dtype):
    """10 steps from position 0 against a latent cache of 16: the outputs
    and the cache the reference returns (the port writes it in place)."""
    jax, _, _, mla = jref
    jnp = jax.numpy
    rcfg, cfg = _cfgs(jref, dtype)
    rp, tp = _params(jref, rcfg, cfg)
    x = _x(cfg, 2, 10, seed=2)
    rstep = jax.jit(lambda p, xx, pos, c: mla.mla_decode_step(
        p, xx, pos, c, rcfg))
    exp, rcache = _decode(
        lambda p, xx, pos, c: rstep(p, xx, jnp.int32(pos), c), rp,
        jnp.asarray(x, rcfg.cdtype), mla.init_mla_cache(rcfg, 2, 16), _np)
    with torch.inference_mode():
        cache = tmla.init_mla_cache(cfg, 2, 16, device="cpu")
        out, tcache = _decode(
            lambda p, xx, pos, c: tmla.mla_decode_step(p, xx, pos, c, cfg),
            tp, torch.from_numpy(x).to(cfg.cdtype), cache, _np)
    assert tcache is cache
    if dtype == "float32":
        np.testing.assert_allclose(out, exp, atol=2e-5, rtol=2e-5)
        for k in ("c_kv", "k_rope"):
            np.testing.assert_allclose(_np(tcache[k]), _np(rcache[k]),
                                       atol=2e-5, rtol=2e-5)
    else:
        assert _share(out, exp) <= 2e-2
    assert not tcache["c_kv"][:, 10:].any()


def test_init_mla_cache_matches_reference(jref):
    _, _, _, mla = jref
    for dtype in ("float32", "bfloat16"):
        rcfg, cfg = _cfgs(jref, dtype)
        exp = mla.init_mla_cache(rcfg, 3, 7)
        out = tmla.init_mla_cache(cfg, 3, 7, device="cpu")
        assert out.keys() == exp.keys()
        for k in out:
            assert tuple(out[k].shape) == exp[k].shape
            assert str(out[k].dtype).removeprefix("torch.") == \
                str(exp[k].dtype)
            assert not out[k].any()


@pytest.mark.parametrize("kw", [{}, {"q_lora_rank": 0}],
                         ids=["q_lora", "wq"])
def test_absorbed_decode_matches_expanded_path(jref, kw):
    """The absorption (W_uk folded into q, W_uv after the softmax, scores
    against the latent) is the expanded attention's function: the port's
    decode of 48 positions against its own ``mla_train`` at each."""
    rcfg, cfg = _cfgs(jref, **kw)
    _, tp = _params(jref, rcfg, cfg, seed=4)
    x = torch.from_numpy(_x(cfg, 2, 48, seed=5))
    with torch.inference_mode():
        pre = tmla.mla_train(tp, x, torch.arange(48).expand(2, 48), cfg)
        dec, _ = _decode(
            lambda p, xx, pos, c: tmla.mla_decode_step(p, xx, pos, c, cfg),
            tp, x, tmla.init_mla_cache(cfg, 2, 48, device="cpu"), _np)
    assert _share(dec, _np(pre)) <= 1e-5
