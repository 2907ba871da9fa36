"""Port dense-LM prefill slice vs the JAX reference: configs, layers,
attention, the whole prefill step, and the serving driver on the CPU.

Inputs and weights are made with numpy from a seed (or drawn by the
reference's ``init_params``) and handed to both packages. Tolerances: the
layers and attention 1e-5 in float32 (the same math, sums in another
order); the prefill logits 1e-4 in float32 (two layers of it) and, in
bfloat16, 2e-2 of the logits' largest magnitude. The port rounds to
bfloat16 after every op, as the reference's jaxpr states; compiled, XLA
keeps float32 inside its fusions, and one-ulp differences spread through
two layers: on the qwen3 smoke case the reference compiled and the
reference evaluated op by op (``jax.disable_jit``) differ by 0.047 in
logits of magnitude up to 3.4, so an elementwise 2e-2 would fail the
reference against itself.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs
from repro_torch.launch.serve_prefill import serve_prefill
from repro_torch.launch.steps import effective_config, make_prefill_step
from repro_torch.models import (init_params, lm_params_from_numpy,
                                model_decls, param_count)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import repro.configs as configs
    import repro.models as models
    from repro.launch import steps
    from repro.models import attention, layers
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, configs=configs, models=models,
        steps=steps, attention=attention, layers=layers)


def _cfgs(jref, arch="qwen3-4b", **kw):
    """(reference config, port config) of one smoke arch, float32."""
    kw = {"param_dtype": "float32", "compute_dtype": "float32", **kw}
    return (jref.configs.get_smoke(arch).replace(**kw),
            tconfigs.get_smoke(arch).replace(**kw))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _weights(rng, decls_or_shapes):
    return {k: (rng.normal(size=s) / np.sqrt(s[0] if len(s) > 1 else 1))
            .astype(np.float32) for k, s in decls_or_shapes.items()}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_configs_match_reference(jref, arch):
    assert tconfigs.ARCHS == jref.configs.ARCHS
    for get in ("get_config", "get_smoke"):
        ours = getattr(tconfigs, get)(arch)
        theirs = getattr(jref.configs, get)(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        for s in jref.configs.SHAPES.values():
            ts = tconfigs.SHAPES[s.name]
            assert dataclasses.asdict(ts) == dataclasses.asdict(s)
            assert dataclasses.asdict(effective_config(ours, ts)) == \
                dataclasses.asdict(jref.steps.effective_config(theirs, s))


def test_shape_tables_match_reference(jref):
    assert tconfigs.LONG_SKIP == jref.configs.LONG_SKIP
    assert tconfigs.LONG_VIA_SWA == jref.configs.LONG_VIA_SWA
    assert tconfigs.cells() == jref.configs.cells()
    cfg = effective_config(tconfigs.get_config("qwen3-4b"),
                           tconfigs.SHAPES["long_500k"])
    assert (cfg.attention, cfg.window) == ("swa", 4096)
    assert cfg.pdtype == torch.bfloat16


@pytest.mark.parametrize("arch,count", [("qwen3-4b", 4_412_079_616),
                                        ("mamba2-780m", 780_382_464)])
def test_param_count_and_decls_match_reference(jref, arch, count):
    cfg = tconfigs.get_config(arch)
    ref_decls = jref.models.model_decls(jref.configs.get_config(arch),
                                        jref.models.CPU_AXES)
    assert param_count(model_decls(cfg)) == \
        jref.models.param_count(ref_decls) == count
    shapes = {jref.jax.tree_util.keystr(p): tuple(d.shape) for p, d in
              jref.jax.tree_util.tree_flatten_with_path(
                  ref_decls, is_leaf=lambda x: hasattr(x, "spec"))[0]}
    from repro_torch.models.common import tree_leaves
    assert {p: tuple(d.shape) for p, d in tree_leaves(model_decls(cfg))} \
        == shapes


def test_init_params_rule():
    cfg = tconfigs.get_smoke("qwen3-4b").replace(d_ff=4096)
    gen = torch.Generator().manual_seed(0)
    p = init_params(model_decls(cfg), gen, "cpu", torch.float32)
    assert torch.equal(p["final_norm"], torch.ones(cfg.d_model))
    assert torch.equal(p["layers"]["attn"]["q_norm"],
                       torch.ones((cfg.n_layers, cfg.head_dim)))
    wi = p["layers"]["ffn"]["wi"]                   # fan_in = d_model
    std = 1 / np.sqrt(cfg.d_model)
    assert wi.shape == (cfg.n_layers, cfg.d_model, 2 * cfg.d_ff)
    assert wi.abs().max() <= 3 * std * (1 + 1e-6)
    # a normal truncated at 3 sigma has std 0.98658 sigma
    assert abs(float(wi.std()) / std - 0.98658) < 0.01
    again = init_params(model_decls(cfg), torch.Generator().manual_seed(0),
                        "cpu", torch.bfloat16)
    assert again["layers"]["ffn"]["wi"].dtype == torch.bfloat16
    torch.testing.assert_close(again["layers"]["ffn"]["wi"].float(), wi,
                               atol=0, rtol=2 ** -8)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rms_norm_matches_reference(jref):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 64)).astype(np.float32) * 3
    s = rng.normal(size=(64,)).astype(np.float32)
    exp = jref.layers.rms_norm(jref.jnp.asarray(x), jref.jnp.asarray(s),
                               1e-6, offset=1.0)
    out = tlayers.rms_norm(_t(x), _t(s), 1e-6, offset=1.0)
    np.testing.assert_allclose(_np(out), _np(exp), atol=1e-5, rtol=1e-5)


def test_apply_rope_matches_reference(jref):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(64) * 7, (2, 64)).astype(np.int32)
    exp = jref.layers.apply_rope(jref.jnp.asarray(x), jref.jnp.asarray(pos),
                                 1e6)
    out = tlayers.apply_rope(_t(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(_np(out), _np(exp), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_ffn_apply_matches_reference(jref, act):
    rcfg, cfg = _cfgs(jref, activation=act)
    rng = np.random.default_rng(2)
    p = _weights(rng, {"wi": (64, 256), "wo": (128, 64)})
    x = rng.normal(size=(2, 16, 64)).astype(np.float32)
    exp = jref.layers.ffn_apply({k: jref.jnp.asarray(v) for k, v in
                                 p.items()}, jref.jnp.asarray(x), rcfg)
    out = tlayers.ffn_apply({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    np.testing.assert_allclose(_np(out), _np(exp), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_gate_rounds_like_reference_in_bf16(jref, act):
    """jax.nn.silu / jax.nn.gelu on bfloat16 round after every op; the
    port's gate does the same, bit for bit."""
    jax, jnp = jref.jax, jref.jnp
    rng = np.random.default_rng(7)
    g, u = (rng.normal(size=(4096,)).astype(np.float32) * 3 for _ in "gu")
    jg, ju = (jnp.asarray(a).astype(jnp.bfloat16) for a in (g, u))
    exp = ju * (jax.nn.gelu(jg) if act == "geglu" else jax.nn.silu(jg))
    out = tlayers._gate(act, _t(u, torch.bfloat16), _t(g, torch.bfloat16))
    np.testing.assert_array_equal(_np(out), _np(exp.astype(jnp.float32)))


@pytest.mark.parametrize("arch,softcap", [("qwen3-4b", 0.0),
                                          ("gemma-2b", 30.0)])
def test_embed_and_logits_match_reference(jref, arch, softcap):
    """Embedding (gemma: sqrt(d) scale, tied unembedding) and logits, with
    and without a logit softcap."""
    rcfg, cfg = _cfgs(jref, arch, logit_softcap=softcap)
    rng = np.random.default_rng(3)
    V, d = cfg.padded_vocab, cfg.d_model
    p = _weights(rng, {"embedding": (V, d), "lm_head": (d, V)})
    tokens = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jp = {k: jref.jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    x_exp = jref.layers.embed_apply(jp, jref.jnp.asarray(tokens), rcfg)
    x = tlayers.embed_apply(tp, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(_np(x), _np(x_exp), atol=1e-5, rtol=1e-5)
    h = rng.normal(size=(2, 8, d)).astype(np.float32) * 4
    exp = jref.layers.logits_from_hidden(jref.jnp.asarray(h), jp, rcfg)
    out = tlayers.logits_from_hidden(_t(h), tp, cfg)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(exp), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _attn_params(rng, cfg):
    d, qd, kvd, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    p = _weights(rng, {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd),
                       "wo": (qd, d)})
    p["q_norm"] = (1 + 0.1 * rng.normal(size=(hd,))).astype(np.float32)
    p["k_norm"] = (1 + 0.1 * rng.normal(size=(hd,))).astype(np.float32)
    return p


@pytest.mark.parametrize("window", [128, 512])
def test_attention_train_matches_reference(jref, window):
    """window 128 < S: the banded path (kernel op, plain on the CPU);
    window 512 >= S: the flash (causal) branch."""
    rcfg, cfg = _cfgs(jref)
    rng = np.random.default_rng(4)
    p = _attn_params(rng, cfg)
    x = rng.normal(size=(2, 256, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(256), (2, 256)).astype(np.int32)
    exp = jref.attention.attention_train(
        {k: jref.jnp.asarray(v) for k, v in p.items()}, jref.jnp.asarray(x),
        jref.jnp.asarray(pos), rcfg, window=window)
    out = tattn.attention_train({k: _t(v) for k, v in p.items()}, _t(x),
                                torch.from_numpy(pos), cfg, window=window)
    np.testing.assert_allclose(_np(out), _np(exp), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S,window", [(256, 64), (384, 192)])
def test_swa_window_not_a_multiple_of_128_matches_reference(jref, S, window):
    """A window that divides S but is not a multiple of the kernels' 128-row
    tile: on the CPU the port takes it, as the reference's model
    ``swa_attention`` does (the CUDA kernels refuse it, see
    tests/test_torch_swa.py)."""
    rng = np.random.default_rng(S + window)
    q = rng.normal(size=(1, S, 4, 64)).astype(np.float32)
    k = rng.normal(size=(1, S, 2, 64)).astype(np.float32)
    v = rng.normal(size=(1, S, 2, 64)).astype(np.float32)
    exp = jref.attention.swa_attention(
        *(jref.jnp.asarray(a) for a in (q, k, v)), window=window, scale=0.125)
    out = tattn.swa_attention(_t(q), _t(k), _t(v), window=window, scale=0.125)
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_reference(jref, causal):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 96, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 96, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 96, 2, 16)).astype(np.float32)
    jq, jk, jv = (jref.jnp.asarray(a) for a in (q, k, v))
    exp = jref.attention.flash_attention(jq, jk, jv, scale=0.25,
                                         causal=causal, block_k=64)
    out = tattn.flash_attention(_t(q), _t(k), _t(v), scale=0.25,
                                causal=causal, block_k=64)
    np.testing.assert_allclose(_np(out), _np(exp), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the slice as a whole: the prefill step
# ---------------------------------------------------------------------------
def _prefill_pair(jref, rcfg, cfg, S=512, B=2):
    jax = jref.jax
    ref_params = jref.models.init_params(
        jref.models.model_decls(rcfg, jref.models.CPU_AXES),
        jax.random.PRNGKey(0), rcfg.pdtype)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)
    exp = jref.steps.make_prefill_step(rcfg, jref.models.CPU_AXES, None)(
        ref_params, {"tokens": jref.jnp.asarray(tokens)})
    params = lm_params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                                  device="cpu")
    with torch.inference_mode():
        out = make_prefill_step(cfg, device="cpu")(params,
                                                   {"tokens": tokens})
    assert out.shape == (B, 1, cfg.padded_vocab)
    assert out.dtype == torch.float32
    return _np(out), _np(exp)


@pytest.mark.parametrize("arch,kw", [
    ("qwen3-4b", {}),
    ("qwen3-4b", {"qk_norm": False}),
    ("gemma-2b", {}),                  # embed_scale, tied, geglu, MQA
], ids=["qwen3-f32", "qwen3-no-qk-norm", "gemma-style"])
def test_prefill_step_matches_reference(jref, arch, kw):
    rcfg, cfg = _cfgs(jref, arch, attention="swa", window=128, **kw)
    out, exp = _prefill_pair(jref, rcfg, cfg)
    np.testing.assert_allclose(out, exp, atol=1e-4, rtol=1e-4)


def test_prefill_step_matches_reference_bf16(jref):
    """Reference parameters in bfloat16 go bfloat16 -> float32 ->
    bfloat16, which is exact."""
    rcfg, cfg = _cfgs(jref, attention="swa", window=128,
                      param_dtype="bfloat16", compute_dtype="bfloat16")
    out, exp = _prefill_pair(jref, rcfg, cfg)
    assert np.isfinite(out).all()
    assert np.abs(out - exp).max() <= 2e-2 * np.abs(exp).max()


def test_lm_params_from_numpy_checks_the_tree():
    cfg = tconfigs.get_smoke("qwen3-4b")
    p = init_params(model_decls(cfg), torch.Generator(), "cpu")
    tree = {"embedding": p["embedding"].float().numpy()}
    with pytest.raises(ValueError, match="mismatch"):
        lm_params_from_numpy(tree, cfg, device="cpu")


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b",
                                  "seamless-m4t-large-v2", "paligemma-3b"])
def test_unported_families_raise(arch):
    """Every family of the reference is ported now: these archs build, and
    only a family that no package knows raises, at declaration and when
    the prefill step is built."""
    cfg = tconfigs.get_smoke(arch)
    assert model_decls(cfg)
    make_prefill_step(cfg, device="cpu")
    bad = cfg.replace(family=f"not-{cfg.family}")
    with pytest.raises(ValueError, match=bad.family):
        model_decls(bad)
    with pytest.raises(ValueError, match=bad.family):
        make_prefill_step(bad, device="cpu")


def test_serve_prefill_smoke_on_cpu():
    res = serve_prefill(smoke=True, batch=2, prompt_len=256, window=128,
                        device="cpu")
    assert (res.cfg.attention, res.cfg.window) == ("swa", 128)
    assert res.logits.shape == (2, 1, res.cfg.padded_vocab)
    assert torch.isfinite(res.logits).all()
    assert res.launches == 0                        # the plain version ran
    with torch.inference_mode():
        again = make_prefill_step(res.cfg, device="cpu")(
            res.params, {"tokens": res.tokens})
    torch.testing.assert_close(again, res.logits, atol=0, rtol=0)
    assert torch.equal(res.next_tokens, res.logits[:, -1].argmax(-1))
