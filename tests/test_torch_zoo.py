"""The rest of the LM zoo in the port vs the JAX reference: the moe family
(deepseek: MLA attention, leading dense layers, routed and shared
experts), the encdec family (seamless: a bidirectional encoder, a decoder
with cross-attention) and the vlm family (paligemma: projected image
prefix embeddings before the text). For each: the declarations and
parameter counts at smoke and full size, the forward (prefill) pass,
``encode``, the caches, the decode step against the reference's and
against the port's own prefill, the prefill step, the prefill driver and
the decode CLI on the CPU, and int8 serving weights.

The reference runs under a (1, 1) ("data", "model") mesh of automatic
axes (its MoE layer is a ``shard_map``; under explicit axes its jitted
decode step refuses the cache update), compiled, but for the bfloat16
moe forward (see the test). Weights are its ``init_params(PRNGKey(0))``
carried with ``lm_params_from_numpy``, with every leaf it initialises to
ones (the norm scales) redrawn as 1 + 0.2 * normal so that a dropped or
misplaced norm would show. Tokens, prefix embeddings and source frames
are numpy draws from a seed. Tolerances: the logits 1e-4 in float32
(``tests/test_torch_lm.py``'s prefill parity); the decode step 2e-5 in
float32 (``tests/test_torch_decode.py``'s); in bfloat16 within 2e-2 of the
largest logit (``tests/test_torch_lm.py``'s); the port's decode against
its own prefill 1e-4 of the largest logit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lm_decode_harness as h
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.serve_prefill import serve_prefill
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import (init_params, lm, lm_params_from_numpy,
                                model_decls, param_count, quant)
from repro_torch.models.common import tree_leaves

ZOO = ["deepseek-v2-236b", "deepseek-v3-671b", "seamless-m4t-large-v2",
       "paligemma-3b"]
COUNTS = {"deepseek-v2-236b": 235_741_434_880,
          "deepseek-v3-671b": 671_026_404_352,
          "seamless-m4t-large-v2": 2_034_886_656,
          "paligemma-3b": 2_511_153_152}


@pytest.fixture(scope="module")
def jref():
    ns = h.load_jref()
    ns.mesh = ns.jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        ns.jax.sharding.AxisType.Auto,) * 2)
    ns.ax = ns.models.axis_env_for_mesh(ns.mesh)
    return ns


def _cfgs(jref, arch, dtype="float32", **kw):
    kw = {"param_dtype": dtype, "compute_dtype": dtype, **kw}
    return (jref.configs.get_smoke(arch).replace(**kw),
            tconfigs.get_smoke(arch).replace(**kw))


def _carried(jref, rcfg, cfg, seed=0):
    """(reference params as jnp arrays, the same params in the port)."""
    jax = jref.jax
    tree = jax.tree.map(np.asarray, jref.models.init_params(
        jref.models.model_decls(rcfg, jref.ax), jax.random.PRNGKey(seed),
        rcfg.pdtype))
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(
        lambda a: (1 + 0.2 * rng.normal(size=a.shape)).astype(a.dtype)
        if a.ndim <= 2 and (a == 1).all() else a, tree)
    return (jax.tree.map(jref.jnp.asarray, tree),
            lm_params_from_numpy(tree, cfg, device="cpu"))


def _extras(cfg, B, S, seed=0):
    """The family's extra inputs as numpy: the vlm's prefix embeddings,
    the encdec's source frames (S of them)."""
    rng = np.random.default_rng(seed + 7)
    if cfg.family == "vlm":
        return {"prefix_embeds": rng.normal(
            size=(B, cfg.prefix_tokens, cfg.frontend_dim)).astype(np.float32)}
    if cfg.family == "encdec":
        return {"src_frames": rng.normal(
            size=(B, S, cfg.d_model)).astype(np.float32)}
    return {}


def _ref_hidden(jref, rcfg, rp, toks, extras):
    jnp, m = jref.jnp, jref.models
    kw = {}
    if "prefix_embeds" in extras:
        kw["prefix_embeds"] = jnp.asarray(extras["prefix_embeds"])
    if "src_frames" in extras:
        kw["enc_out"] = m.encode(rp, jnp.asarray(extras["src_frames"]), rcfg,
                                 jref.ax, jref.mesh)
    hid, _ = m.forward(rp, jnp.asarray(toks), rcfg, jref.ax, jref.mesh, **kw)
    return hid


def _ref_logits(jref, rcfg, rp, toks, extras):
    fn = jref.jax.jit(lambda p, t, e: jref.models.layers.logits_from_hidden(
        _ref_hidden(jref, rcfg, p, t, e), p, rcfg))
    return np.asarray(fn(rp, toks, extras), np.float32)


def _port_logits(cfg, tp, toks, extras):
    kw = {}
    with torch.inference_mode():
        if "prefix_embeds" in extras:
            kw["prefix_embeds"] = torch.from_numpy(extras["prefix_embeds"])
        if "src_frames" in extras:
            kw["enc_out"] = lm.encode(
                tp, torch.from_numpy(extras["src_frames"]), cfg)
        hid = lm.forward(tp, torch.from_numpy(toks), cfg, **kw)
        return h.logits_from_hidden(hid, tp, cfg).float().numpy()


# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ZOO)
def test_decls_and_param_count_match_reference(jref, arch):
    """Every leaf's path and shape, and the parameter count, at the smoke
    size and at full size (declarations only: nothing is materialised)."""
    for get in ("get_smoke", "get_config"):
        rd = jref.models.model_decls(getattr(jref.configs, get)(arch),
                                     jref.models.CPU_AXES)
        td = model_decls(getattr(tconfigs, get)(arch))
        assert {p: tuple(d.shape) for p, d in tree_leaves(td)} == \
            {p: tuple(d.shape) for p, d in tree_leaves(rd)}
        assert param_count(td) == jref.models.param_count(rd)
    assert param_count(model_decls(tconfigs.get_config(arch))) == \
        COUNTS[arch]


def test_full_size_layouts():
    ds = model_decls(tconfigs.get_config("deepseek-v2-236b"))
    assert ds["dense_layers"]["ffn"]["wi"].shape == (1, 5120, 2 * 12288)
    assert ds["moe_layers"]["ffn"]["wi"].shape == (59, 160, 5120, 3072)
    assert ds["moe_layers"]["attn"]["w_uk"].shape == (59, 512, 128, 128)
    sm = model_decls(tconfigs.get_config("seamless-m4t-large-v2"))
    assert sorted(sm) == ["dec_layers", "embedding", "enc_final_norm",
                          "enc_layers", "final_norm", "lm_head"]
    assert sm["dec_layers"]["xattn"]["wk"].shape == (24, 1024, 1024)
    pg = model_decls(tconfigs.get_config("paligemma-3b"))
    assert pg["vision_proj"].shape == (1152, 2048)
    assert "lm_head" not in pg                           # tied


def test_unknown_family_raises():
    cfg = tconfigs.get_smoke("qwen3-4b").replace(family="nope")
    with pytest.raises(ValueError, match="nope"):
        model_decls(cfg)
    with pytest.raises(ValueError, match="nope"):
        lm.init_cache(cfg, 1, 8, device="cpu")


# ---------------------------------------------------------------------------
# forward, encode, prefill step
# ---------------------------------------------------------------------------
FORWARD_CASES = [
    ("deepseek-v2-236b", {}),
    ("deepseek-v3-671b", {}),               # 1 dense + 2 MoE layers
    ("seamless-m4t-large-v2", {}),
    ("paligemma-3b", {}),
    ("paligemma-3b", {"attention": "swa", "window": 32}),
]
FORWARD_IDS = ["deepseek-v2", "deepseek-v3", "seamless", "paligemma",
               "paligemma-swa"]


@pytest.mark.parametrize("arch,kw", FORWARD_CASES, ids=FORWARD_IDS)
def test_forward_matches_reference(jref, arch, kw):
    rcfg, cfg = _cfgs(jref, arch, **kw)
    rp, tp = _carried(jref, rcfg, cfg)
    S = 56 if cfg.family == "vlm" else 64       # the vlm's 8 + 56 = 64
    toks = h.tokens(cfg, 2, S)
    ex = _extras(cfg, 2, 48)
    exp = _ref_logits(jref, rcfg, rp, toks, ex)
    out = _port_logits(cfg, tp, toks, ex)
    assert out.shape == (2, 64 if cfg.family == "vlm" else S,
                         cfg.padded_vocab)
    np.testing.assert_allclose(out, exp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "seamless-m4t-large-v2",
                                  "paligemma-3b"])
def test_forward_matches_reference_bf16(jref, arch):
    """The moe family is held to the reference evaluated op by op
    (``jax.disable_jit``), which rounds the router's logits to bfloat16
    as the port does: compiled, XLA keeps them in float32, some tokens
    pick other experts, and the compiled reference differs from its own
    op-by-op run by 24% of the largest logit here (the port: 0.03%)."""
    rcfg, cfg = _cfgs(jref, arch, "bfloat16")
    rp, tp = _carried(jref, rcfg, cfg)
    toks = h.tokens(cfg, 2, 56)
    ex = _extras(cfg, 2, 40)
    if cfg.family == "moe":
        with jref.jax.disable_jit():
            exp = np.asarray(jref.models.layers.logits_from_hidden(
                _ref_hidden(jref, rcfg, rp, toks, ex), rp, rcfg), np.float32)
    else:
        exp = _ref_logits(jref, rcfg, rp, toks, ex)
    out = _port_logits(cfg, tp, toks, ex)
    assert np.isfinite(out).all()
    assert h.share_of_max(out, exp) <= 2e-2


def test_encode_matches_reference(jref):
    """The encoder is bidirectional: a change to the last frame moves the
    first position's output."""
    rcfg, cfg = _cfgs(jref, "seamless-m4t-large-v2")
    rp, tp = _carried(jref, rcfg, cfg)
    fr = _extras(cfg, 2, 40)["src_frames"]
    exp = jref.jax.jit(lambda p, f: jref.models.encode(
        p, f, rcfg, jref.ax, jref.mesh))(rp, fr)
    with torch.inference_mode():
        out = lm.encode(tp, torch.from_numpy(fr), cfg)
        fr2 = fr.copy()
        fr2[:, -1] += 1
        moved = lm.encode(tp, torch.from_numpy(fr2), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=1e-5,
                               rtol=1e-5)
    assert (moved[:, 0] - out[:, 0]).abs().max() > 1e-3


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "seamless-m4t-large-v2",
                                  "paligemma-3b"])
def test_prefill_step_matches_reference(jref, arch):
    rcfg, cfg = _cfgs(jref, arch)
    rp, tp = _carried(jref, rcfg, cfg)
    toks = h.tokens(cfg, 2, 32)
    ex = _extras(cfg, 2, 24)
    batch = {"tokens": toks, **ex}
    exp = jref.jax.jit(jref.steps.make_prefill_step(rcfg, jref.ax, jref.mesh))(
        rp, {k: jref.jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        out = make_prefill_step(cfg, device="cpu")(tp, batch)
    assert out.shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp, np.float32),
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# caches and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,kw", [
    ("deepseek-v2-236b", {}), ("seamless-m4t-large-v2", {}),
    ("paligemma-3b", {}), ("paligemma-3b", {"attention": "swa",
                                            "window": 8})],
    ids=["deepseek", "seamless", "paligemma", "paligemma-ring"])
def test_init_cache_matches_reference(jref, arch, kw):
    for dtype in ("float32", "bfloat16"):
        rcfg, cfg = _cfgs(jref, arch, dtype, **kw)
        exp = dict(tree_leaves(jref.models.init_cache(rcfg, 2, 16)))
        out = dict(tree_leaves(lm.init_cache(cfg, 2, 16, device="cpu")))
        assert out.keys() == exp.keys()
        for p, t in out.items():
            assert tuple(t.shape) == exp[p].shape, p
            assert str(t.dtype).removeprefix("torch.") == \
                str(exp[p].dtype), p
            assert not t.any()


def _enc_out(cfg, B, L, seed=0):
    return np.random.default_rng(seed + 11).normal(
        size=(B, L, cfg.d_model)).astype(np.float32)


def _ref_decode(jref, rcfg, rp, toks, L, enc_out=None):
    jnp = jref.jnp
    step = jref.jax.jit(lambda p, t, pos, c: jref.models.decode_step(
        p, t, pos, c, rcfg, jref.ax, jref.mesh))
    cache = jref.models.init_cache(rcfg, toks.shape[0], L)
    if enc_out is not None:
        cache["enc_out"] = jnp.asarray(enc_out, rcfg.cdtype)
    out = []
    for pos in range(toks.shape[1]):
        logits, cache = step(rp, jnp.asarray(toks[:, pos:pos + 1]),
                             jnp.int32(pos), cache)
        out.append(np.asarray(logits[:, 0], np.float32))
    return np.stack(out, 1)


def _port_decode(cfg, tp, toks, L, enc_out=None):
    out = []
    with torch.inference_mode():
        cache = lm.init_cache(cfg, toks.shape[0], L, device="cpu")
        if enc_out is not None:
            cache["enc_out"].copy_(torch.from_numpy(enc_out))
        t = torch.from_numpy(toks)
        for pos in range(toks.shape[1]):
            logits, cache = lm.decode_step(tp, t[:, pos:pos + 1], pos, cache,
                                           cfg)
            out.append(logits[:, 0].float().numpy())
    return np.stack(out, 1)


DECODE_CASES = [
    ("deepseek-v2-236b", {}),
    ("deepseek-v3-671b", {}),
    ("seamless-m4t-large-v2", {}),
    ("paligemma-3b", {"attention": "swa", "window": 4}),   # the ring wraps
]
DECODE_IDS = ["deepseek-v2", "deepseek-v3", "seamless", "paligemma-ring"]


@pytest.mark.parametrize("arch,kw", DECODE_CASES, ids=DECODE_IDS)
def test_decode_step_matches_reference(jref, arch, kw):
    """8 steps from position 0, teacher-forced, against caches of 12
    positions (the encdec's encoder output a numpy draw): logits at 2e-5,
    greedy tokens equal."""
    rcfg, cfg = _cfgs(jref, arch, **kw)
    rp, tp = _carried(jref, rcfg, cfg)
    toks = h.tokens(cfg, 2, 8)
    enc = _enc_out(cfg, 2, 12) if cfg.family == "encdec" else None
    exp = _ref_decode(jref, rcfg, rp, toks, 12, enc)
    out = _port_decode(cfg, tp, toks, 12, enc)
    np.testing.assert_allclose(out, exp, atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(out.argmax(-1), exp.argmax(-1))


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "seamless-m4t-large-v2",
                                  "paligemma-3b"])
def test_decode_step_matches_reference_bf16(jref, arch):
    rcfg, cfg = _cfgs(jref, arch, "bfloat16")
    rp, tp = _carried(jref, rcfg, cfg)
    toks = h.tokens(cfg, 2, 8)
    enc = _enc_out(cfg, 2, 12) if cfg.family == "encdec" else None
    exp = _ref_decode(jref, rcfg, rp, toks, 12, enc)
    out = _port_decode(cfg, tp, toks, 12, enc)
    assert np.isfinite(out).all()
    assert h.share_of_max(out, exp) <= 2e-2


def test_moe_decode_small_capacity_still_correct(jref):
    """The reference's ``tests/test_perf_features.py:124``: deepseek-v3's
    smoke decode at position 3 of a 32-position cache, 2 tokens a step
    (cpe falls to the alignment floor), held to the reference."""
    rcfg, cfg = _cfgs(jref, "deepseek-v3-671b", "bfloat16")
    rp, tp = _carried(jref, rcfg, cfg)
    tok = h.tokens(cfg, 2, 1, seed=1)
    exp, _ = jref.models.decode_step(
        rp, jref.jnp.asarray(tok), jref.jnp.int32(3),
        jref.models.init_cache(rcfg, 2, 32), rcfg, jref.ax, jref.mesh)
    with torch.inference_mode():
        out, _ = lm.decode_step(tp, torch.from_numpy(tok), 3,
                                lm.init_cache(cfg, 2, 32, device="cpu"), cfg)
    assert torch.isfinite(out).all()
    assert h.share_of_max(out.numpy(), np.asarray(exp, np.float32)) <= 2e-2


@pytest.mark.parametrize("arch,kw", [
    ("deepseek-v3-671b", {"capacity_factor": 8.0}),
    ("paligemma-3b", {"attention": "swa", "window": 16})],
    ids=["deepseek", "paligemma-ring"])
def test_decode_matches_own_prefill(arch, kw):
    """The port's teacher-forced decode of 48 tokens against its own
    prefill at every position (float32): the absorbed MLA decode against
    the expanded flash path, the ring against the banded attention. The
    deepseek case's capacity factor keeps every assignment in the prefill
    (the decode's few tokens never overflow; a prefill past capacity drops
    by design). The vlm decode runs on the text alone, as the reference's
    does, so the prefill here has no prefix."""
    cfg = tconfigs.get_smoke(arch).replace(
        param_dtype="float32", compute_dtype="float32", **kw)
    params = init_params(model_decls(cfg), torch.Generator().manual_seed(0),
                         "cpu", torch.float32)
    toks = h.tokens(cfg, 2, 48, seed=3)
    dec = _port_decode(cfg, params, toks, 48)
    pre = h.port_prefill_logits(cfg, params, toks)
    assert h.share_of_max(dec, pre) <= 1e-4


def test_encdec_decode_mixers_match_own_prefill():
    """The encdec decode orders a layer self-attention, cross-attention,
    FFN and its forward self-attention, FFN, cross-attention (both as the
    reference), so the logits of the two differ; each token mixer's
    decode output is held to its prefill on the same inputs instead."""
    from unittest import mock
    cfg = tconfigs.get_smoke("seamless-m4t-large-v2").replace(
        param_dtype="float32", compute_dtype="float32")
    params = init_params(model_decls(cfg), torch.Generator().manual_seed(0),
                         "cpu", torch.float32)
    toks = torch.from_numpy(h.tokens(cfg, 2, 24, seed=4))
    enc = torch.from_numpy(_enc_out(cfg, 2, 24))
    seen = {"a": [], "x": []}
    real_a, real_x = lm.attn.attention_decode_step, lm._cross_attention

    def rec_a(p, x, *a, **k):
        y, c = real_a(p, x, *a, **k)
        seen["a"].append((x, y))
        return y, c

    def rec_x(p, x, e, c):
        y = real_x(p, x, e, c)
        seen["x"].append((x, y))
        return y

    with mock.patch.object(lm.attn, "attention_decode_step", rec_a), \
            mock.patch.object(lm, "_cross_attention", rec_x), \
            torch.inference_mode():
        cache = lm.init_cache(cfg, 2, 24, device="cpu")
        cache["enc_out"].copy_(enc)
        for pos in range(24):
            lm.decode_step(params, toks[:, pos:pos + 1], pos, cache, cfg)
        positions = torch.arange(24).expand(2, 24)
        for i in range(cfg.dec_layers):
            lp = lm._layer(params["dec_layers"], i)
            for kind, fn in (
                    ("a", lambda x: lm.attn.attention_train(
                        lp["attn"], x, positions, cfg)),
                    ("x", lambda x: real_x(lp["xattn"], x, enc, cfg))):
                xs, ys = zip(*seen[kind][i::cfg.dec_layers])
                pre = fn(torch.cat(xs, 1))
                assert h.share_of_max(torch.cat(ys, 1).numpy(),
                                      pre.numpy()) <= 1e-5


# ---------------------------------------------------------------------------
# int8 serving weights
# ---------------------------------------------------------------------------
def test_quantize_params_matches_reference_on_the_new_leaves(jref):
    """A deepseek config wide enough that MLA, router, expert (3-D, a
    scale per expert) and shared-expert leaves are eligible: the same
    leaves quantized, the same int8 values, the same scales."""
    kw = dict(d_model=128, kv_lora_rank=128, q_lora_rank=128, n_heads=2,
              head_dim=64, rope_head_dim=16, v_head_dim=64, n_experts=128,
              d_ff_expert=128, d_ff_dense=256, vocab_size=256)
    rcfg, cfg = _cfgs(jref, "deepseek-v2-236b", **kw)
    rp, tp = _carried(jref, rcfg, cfg)
    rq = jref.quant.quantize_params(rp)
    tq = quant.quantize_params(tp)
    rleaves = dict(jref.jax.tree_util.tree_flatten_with_path(
        rq, is_leaf=lambda x: isinstance(x, jref.quant.QuantizedArray))[0])
    rleaves = {jref.jax.tree_util.keystr(k): v for k, v in rleaves.items()}
    tleaves = dict(tree_leaves(tq))
    assert rleaves.keys() == tleaves.keys()
    qd = sorted(k for k, v in tleaves.items()
                if isinstance(v, quant.QuantizedArray))
    assert qd == sorted(k for k, v in rleaves.items()
                        if isinstance(v, jref.quant.QuantizedArray))
    assert "['moe_layers']['ffn']['wi']" in qd
    for k in qd:
        np.testing.assert_array_equal(tleaves[k].q.numpy(),
                                      np.asarray(rleaves[k].q))
        np.testing.assert_allclose(tleaves[k].s.numpy(),
                                   np.asarray(rleaves[k].s), rtol=1e-6)
    assert tleaves["['moe_layers']['ffn']['wi']"].s.shape == (1, 128, 1, 1)
    toks = h.tokens(cfg, 2, 4)
    exp = _ref_decode(jref, rcfg, rq, toks, 4)
    out = _port_decode(cfg, tq, toks, 4)
    np.testing.assert_allclose(out, exp, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the drivers on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape,S", [
    ("deepseek-v2-236b", "prefill_32k", 64),
    ("seamless-m4t-large-v2", "prefill_32k", 64),
    ("paligemma-3b", "long_500k", 256)])
def test_serve_prefill_smoke_on_cpu(capsys, arch, shape, S):
    kw = {"window": 128} if shape == "long_500k" else {}
    res = serve_prefill(arch, shape=shape, smoke=True, batch=2,
                        prompt_len=S, device="cpu", **kw)
    out = capsys.readouterr().out
    cfg = res.cfg
    assert res.logits.shape == (2, 1, cfg.padded_vocab)
    assert torch.isfinite(res.logits).all()
    assert res.kernel_launches == {}             # the plain versions ran
    assert res.positions == 2 * S
    n_text = S - cfg.prefix_tokens if cfg.family == "vlm" else S
    assert tuple(res.tokens.shape) == (2, n_text)
    mixer = {"moe": "MoE of 8 experts top-2", "encdec": "cross-attention",
             "vlm": "prefix of 8 embeddings of 32"}[cfg.family]
    assert mixer in out
    with torch.inference_mode():
        again = make_prefill_step(cfg, device="cpu")(res.params, res.batch)
    torch.testing.assert_close(again, res.logits, atol=0, rtol=0)


def test_serve_prefill_vlm_on_the_swa_route_on_cpu():
    """paligemma under long_500k: SWA with head_dim 16 at the smoke size
    runs the plain version on the CPU; the prefix counts as positions."""
    res = serve_prefill("paligemma-3b", smoke=True, batch=1, prompt_len=128,
                        window=32, device="cpu")
    assert (res.cfg.attention, res.cfg.window) == ("swa", 32)
    assert res.batch["prefix_embeds"].shape == (1, 8, 32)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b",
                                  "seamless-m4t-large-v2", "paligemma-3b"])
def test_cli_decode_smoke_on_cpu(capsys, arch):
    serve_cli.main(["--arch", arch, "--smoke", "--batch", "2",
                    "--prompt-len", "4", "--gen", "4", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serve] 2 seqs x 4 tokens in ")
    assert lines[1].startswith("[serve] sample: [")


def test_cli_decode_encdec_reads_an_encoder_output_of_ones():
    """The decode mode's encdec cache holds ones where the encoder output
    goes (the reference's ``serve.py:486``), so its tokens equal a decode
    against ``enc_out`` filled with ones by hand."""
    cfg = tconfigs.get_smoke("seamless-m4t-large-v2")
    params = init_params(model_decls(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    prompt = h.tokens(cfg, 2, 4)
    tokens, _ = serve_cli.decode(cfg, params, prompt, 3, device="cpu")
    ones = np.ones((2, 7, cfg.d_model), np.float32)
    logits = _port_decode(cfg, params, np.concatenate(
        [prompt, tokens[:, :2]], 1), 7, ones)
    np.testing.assert_array_equal(logits[:, 3:].argmax(-1), tokens)
