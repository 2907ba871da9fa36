"""Port hybrid family (zamba2: one shared attention block before every two
mamba blocks, pattern "amm") vs the JAX reference: declarations, the
forward (prefill) pass, the caches and the decode step, and the prefill
driver on the CPU.

Weights are the reference's ``init_params(PRNGKey(0))`` carried with
``lm_params_from_numpy`` (SSM scalars drawn, see ``lm_decode_harness``);
tokens are drawn with numpy from a seed. The smoke config has one
macro-block; the cases with ``n_layers=6`` have two, so that the shared
block's weights serve twice. Tolerances: the forward's logits 1e-4 in
float32 (``tests/test_torch_ssm.py``'s prefill parity); the decode step
2e-5 in float32 (``tests/test_torch_decode.py``'s); in bfloat16 both
within 2e-2 of the largest logit (``tests/test_torch_lm.py``'s) of the
reference evaluated op by op, as ``tests/test_torch_ssm.py`` holds the
bfloat16 mamba2 prefill (see the tests); the port's decode against its
own prefill 1e-4 of the largest logit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lm_decode_harness as h
from repro_torch import configs as tconfigs
from repro_torch.launch.serve_prefill import serve_prefill
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import (init_params, lm, lm_params_from_numpy,
                                model_decls, param_count)
from repro_torch.models.common import tree_leaves


@pytest.fixture(scope="module")
def jref():
    return h.load_jref()


def _cfgs(jref, dtype="float32", **kw):
    kw = {"param_dtype": dtype, "compute_dtype": dtype, **kw}
    return (jref.configs.get_smoke("zamba2-7b").replace(**kw),
            tconfigs.get_smoke("zamba2-7b").replace(**kw))


def test_decls_match_reference(jref):
    """Every leaf's path and shape, at the smoke size and at full size."""
    for get in ("get_smoke", "get_config"):
        rcfg = getattr(jref.configs, get)("zamba2-7b")
        cfg = getattr(tconfigs, get)("zamba2-7b")
        exp = {p: tuple(d.shape) for p, d in tree_leaves(
            jref.models.model_decls(rcfg, jref.models.CPU_AXES))}
        out = {p: tuple(d.shape) for p, d in tree_leaves(model_decls(cfg))}
        assert out == exp
        assert param_count(model_decls(cfg)) == jref.models.param_count(
            jref.models.model_decls(rcfg, jref.models.CPU_AXES))
    decls = model_decls(tconfigs.get_config("zamba2-7b"))
    assert sorted(decls) == ["embedding", "final_norm", "lm_head", "mamba0",
                             "mamba1", "shared_attn"]
    assert decls["mamba0"]["mix"]["in_proj"].shape[0] == 27
    assert decls["shared_attn"]["attn"]["wq"].shape == (3584, 3584)


def test_lm_params_from_numpy_checks_the_hybrid_tree(jref):
    rcfg, cfg = _cfgs(jref)
    tree = h.ref_params(jref, rcfg)
    mix = tree["mamba1"]["mix"]
    mix["out_proj"] = mix["out_proj"][..., :1]
    with pytest.raises(ValueError, match="mamba1"):
        lm_params_from_numpy(tree, cfg, device="cpu")
    del tree["shared_attn"]
    with pytest.raises(ValueError, match="mismatch"):
        lm_params_from_numpy(tree, cfg, device="cpu")


def _ref_logits(jref, rcfg, params, toks):
    jnp = jref.jnp
    hid, _ = jref.models.forward(params, jnp.asarray(toks), rcfg,
                                 jref.models.CPU_AXES, None)
    return np.asarray(jref.models.layers.logits_from_hidden(
        hid, params, rcfg), np.float32)


@pytest.mark.parametrize("n_layers", [3, 6])
def test_forward_matches_reference(jref, n_layers):
    rcfg, cfg = _cfgs(jref, n_layers=n_layers)
    rp, tp = h.carried(jref, rcfg, cfg)
    toks = h.tokens(cfg, 2, 64)
    exp = _ref_logits(jref, rcfg, rp, toks)
    out = h.port_prefill_logits(cfg, tp, toks)
    np.testing.assert_allclose(out, exp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n_layers", [3, 6])
def test_forward_matches_reference_bf16(jref, n_layers):
    """Held to the reference evaluated op by op (``jax.disable_jit``),
    which rounds to bfloat16 after every op as the port does. Compiled,
    XLA keeps float32 inside its fusions: on these cases the compiled
    reference differs from its own op-by-op evaluation by 4.4% (3 layers)
    and 6.3% (6 layers) of the largest logit, so 2e-2 against it would
    fail the reference against itself."""
    rcfg, cfg = _cfgs(jref, "bfloat16", n_layers=n_layers)
    rp, tp = h.carried(jref, rcfg, cfg)
    toks = h.tokens(cfg, 2, 64)
    with jref.jax.disable_jit():
        exp = _ref_logits(jref, rcfg, rp, toks)
    out = h.port_prefill_logits(cfg, tp, toks)
    assert np.isfinite(out).all()
    assert h.share_of_max(out, exp) <= 2e-2


def test_prefill_step_matches_reference(jref):
    rcfg, cfg = _cfgs(jref, n_layers=6)
    rp, tp = h.carried(jref, rcfg, cfg)
    toks = h.tokens(cfg, 2, 64)
    exp = jref.steps.make_prefill_step(rcfg, jref.models.CPU_AXES, None)(
        rp, {"tokens": jref.jnp.asarray(toks)})
    with torch.inference_mode():
        out = make_prefill_step(cfg, device="cpu")(tp, {"tokens": toks})
    assert out.shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp, np.float32),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference(jref, dtype):
    rcfg, cfg = _cfgs(jref, dtype, n_layers=6)
    exp = dict(tree_leaves(jref.models.init_cache(rcfg, 2, 16)))
    out = dict(tree_leaves(lm.init_cache(cfg, 2, 16, device="cpu")))
    assert out.keys() == exp.keys()
    assert sorted(out) == sorted(
        f"['{s}']['{k}']" for s, ks in (("attn", "kv"),
                                        ("mamba0", ("conv", "ssm")),
                                        ("mamba1", ("conv", "ssm")))
        for k in ks)
    for p, t in out.items():
        assert tuple(t.shape) == exp[p].shape, p
        assert str(t.dtype).removeprefix("torch.") == str(exp[p].dtype), p
        assert not t.any()


@pytest.mark.parametrize("n_layers", [3, 6])
def test_decode_step_matches_reference(jref, n_layers):
    """8 steps from position 0, teacher-forced: logits at 2e-5, greedy
    tokens equal."""
    rcfg, cfg = _cfgs(jref, n_layers=n_layers)
    rp, tp = h.carried(jref, rcfg, cfg)
    toks = h.tokens(cfg, 2, 8)
    exp = h.ref_decode_logits(jref, rcfg, rp, toks, 16)
    out = h.port_decode_logits(cfg, tp, toks, 16)
    np.testing.assert_allclose(out, exp, atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(out.argmax(-1), exp.argmax(-1))


@pytest.mark.parametrize("n_layers", [3, 6])
def test_decode_step_matches_reference_bf16(jref, n_layers):
    """Held to the reference evaluated op by op, as the bfloat16 forward
    is (the compiled reference differs from it by 1.8% and 3.2% of the
    largest logit here)."""
    rcfg, cfg = _cfgs(jref, "bfloat16", n_layers=n_layers)
    rp, tp = h.carried(jref, rcfg, cfg)
    toks = h.tokens(cfg, 2, 8)
    with jref.jax.disable_jit():
        exp = h.ref_decode_logits(jref, rcfg, rp, toks, 16)
    out = h.port_decode_logits(cfg, tp, toks, 16)
    assert np.isfinite(out).all()
    assert h.share_of_max(out, exp) <= 2e-2


def test_decode_matches_own_prefill():
    """The port's teacher-forced decode against its own prefill of the
    same 64 tokens, at every position (float32, two macro-blocks)."""
    cfg = tconfigs.get_smoke("zamba2-7b").replace(
        n_layers=6, param_dtype="float32", compute_dtype="float32")
    params = init_params(model_decls(cfg), torch.Generator().manual_seed(0),
                         "cpu", torch.float32)
    toks = h.tokens(cfg, 2, 64, seed=3)
    dec = h.port_decode_logits(cfg, params, toks, 64)
    pre = h.port_prefill_logits(cfg, params, toks)
    assert h.share_of_max(dec, pre) <= 1e-4


def test_serve_prefill_zamba2_smoke_on_cpu(capsys):
    res = serve_prefill("zamba2-7b", shape="prefill_32k", smoke=True,
                        batch=2, prompt_len=64, device="cpu")
    assert res.cfg.family == "hybrid"
    assert res.logits.shape == (2, 1, res.cfg.padded_vocab)
    assert torch.isfinite(res.logits).all()
    assert (res.launches, res.ssd_launches) == (0, 0)   # plain versions ran
    assert "SSD state 16" in capsys.readouterr().out
    with torch.inference_mode():
        again = make_prefill_step(res.cfg, device="cpu")(
            res.params, {"tokens": res.tokens})
    torch.testing.assert_close(again, res.logits, atol=0, rtol=0)
