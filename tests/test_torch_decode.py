"""Port decode slice vs the JAX reference: decode attention against a KV
cache (and the SWA ring buffer across its wrap), the recurrent mamba
step, ``lm.decode_step`` of the dense and ssm families, int8 serving
weights, and the decode mode of ``launch/serve.py`` on the CPU.

Inputs are drawn with numpy from a seed; weights are the reference's
``init_params(PRNGKey(0))`` carried with ``lm_params_from_numpy``.
Tolerances: float32 2e-5 (``tests/test_kernels.py``'s fp32 SWA
tolerance: the same math, sums in another order); bfloat16 logits within
2e-2 of the largest (the port rounds after every op, XLA keeps float32
inside its fusions; see ``tests/test_torch_lm.py``); the port's decode
against its own prefill 1e-4 of the largest logit in float32 (the
float32 model comparison of ``chip_smoke.py``); int8 weights as
``tests/test_perf_features.py`` holds them.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401

import lm_decode_harness as h
from repro_torch import configs as tconfigs
from repro_torch.configs import SHAPES
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.steps import effective_config, make_serve_step
from repro_torch.models import attention as tattn
from repro_torch.models import (init_params, lm, lm_params_from_numpy,
                                model_decls)
from repro_torch.models import quant as tquant
from repro_torch.models import ssm as tssm
from repro_torch.models.common import tree_leaves

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32 = {"atol": 2e-5, "rtol": 2e-5}


@pytest.fixture(scope="module")
def jref():
    return h.load_jref()


def _cfgs(jref, arch, **kw):
    """(reference config, port config) of one smoke arch, float32."""
    kw = {"param_dtype": "float32", "compute_dtype": "float32", **kw}
    return (jref.configs.get_smoke(arch).replace(**kw),
            tconfigs.get_smoke(arch).replace(**kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# decode attention and the KV cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv", [4, 1], ids=["group1", "group4"])
@pytest.mark.parametrize("valid_dim", [1, 2])
def test_decode_attention_matches_reference(jref, kv, valid_dim):
    rng = np.random.default_rng(kv + valid_dim)
    B, L, H, D = 2, 24, 4, 16
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(B, L, kv, D)).astype(np.float32)
    v = rng.normal(size=(B, L, kv, D)).astype(np.float32)
    valid = rng.random((B, L)[2 - valid_dim:]) < 0.6
    valid[..., 0] = True
    exp = jref.attention.decode_attention(
        *(jref.jnp.asarray(a) for a in (q, k, v)), scale=D ** -0.5,
        valid=jref.jnp.asarray(valid))
    out = tattn.decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), scale=D ** -0.5,
        valid=torch.from_numpy(valid))
    np.testing.assert_allclose(_np(out), _np(exp), **F32)


def _attn_params(jref, rcfg, seed):
    """The reference's attention weights (numpy), q/k norms drawn."""
    jax = jref.jax
    p = jax.tree.map(np.asarray, jref.models.init_params(
        jref.attention.attn_decls(rcfg, jref.models.CPU_AXES),
        jax.random.PRNGKey(seed), jref.jnp.float32))
    rng = np.random.default_rng(seed)
    for k in ("q_norm", "k_norm"):
        p[k] = (1 + rng.normal(size=p[k].shape) * 0.2).astype(np.float32)
    return p


@pytest.mark.parametrize("window", [None, 8], ids=["full", "swa-ring"])
@pytest.mark.parametrize("kv", [4, 1], ids=["group1", "group4"])
def test_attention_decode_step_matches_reference(jref, window, kv):
    """20 steps from position 0: under SWA the ring of 8 slots wraps twice
    (past 2L); the caches are held too, slot by slot."""
    rcfg, cfg = _cfgs(jref, "qwen3-4b", n_heads=4, n_kv_heads=kv)
    p = _attn_params(jref, rcfg, kv)
    rp = {k: jref.jnp.asarray(a) for k, a in p.items()}
    tp = {k: torch.from_numpy(np.array(a)) for k, a in p.items()}
    B, seq_len = 2, 24
    rc = jref.attention.init_kv_cache(rcfg, B, seq_len, window=window)
    tc = tattn.init_kv_cache(cfg, B, seq_len, window=window, device="cpu")
    L = tc["k"].shape[1]
    assert L == (window or seq_len)
    rng = np.random.default_rng(7)
    for pos in range(20):
        x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        ey, rc = jref.attention.attention_decode_step(
            rp, jref.jnp.asarray(x), jref.jnp.int32(pos), rc, rcfg,
            window=window)
        y, tc2 = tattn.attention_decode_step(tp, torch.from_numpy(x), pos, tc,
                                             cfg, window=window)
        assert tc2 is tc                          # written in place
        np.testing.assert_allclose(_np(y), _np(ey), **F32)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tc[name]), _np(rc[name]), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 8, 64])
def test_init_kv_cache_matches_reference(jref, dtype, window):
    rcfg, cfg = _cfgs(jref, "qwen3-4b", compute_dtype=dtype)
    exp = jref.attention.init_kv_cache(rcfg, 3, 32, window=window)
    out = tattn.init_kv_cache(cfg, 3, 32, window=window, device="cpu")
    for k in ("k", "v"):
        assert tuple(out[k].shape) == exp[k].shape
        assert str(out[k].dtype).removeprefix("torch.") == str(exp[k].dtype)
        assert not out[k].any()


# ---------------------------------------------------------------------------
# the recurrent mamba step and its cache
# ---------------------------------------------------------------------------
def _mix_params(jref, rcfg, seed):
    jax = jref.jax
    mix = jax.tree.map(np.asarray, jref.models.init_params(
        jref.ssm.ssm_decls(rcfg, jref.models.CPU_AXES),
        jax.random.PRNGKey(seed), jref.jnp.float32))
    block = h.draw_ssm_scalars(np.random.default_rng(seed),
                               {"ln": np.ones(1, np.float32), "mix": mix})
    return block["mix"]


def test_mamba_decode_step_matches_reference(jref):
    rcfg, cfg = _cfgs(jref, "mamba2-780m")
    p = _mix_params(jref, rcfg, 5)
    rp = {k: jref.jnp.asarray(a) for k, a in p.items()}
    tp = {k: torch.from_numpy(np.array(a)) for k, a in p.items()}
    B = 2
    rc = jref.ssm.init_ssm_cache(rcfg, B)
    tc = tssm.init_ssm_cache(cfg, B, device="cpu")
    rng = np.random.default_rng(6)
    for _ in range(8):
        x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        ey, rc = jref.ssm.mamba_decode_step(rp, jref.jnp.asarray(x), rc, rcfg)
        y, tc2 = tssm.mamba_decode_step(tp, torch.from_numpy(x), tc, cfg)
        assert tc2 is tc                          # written in place
        np.testing.assert_allclose(_np(y), _np(ey), **F32)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(_np(tc[k]), _np(rc[k]), **F32)


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
def test_init_ssm_cache_matches_reference(jref, cdtype, state_dtype):
    rcfg, cfg = _cfgs(jref, "mamba2-780m", compute_dtype=cdtype)
    exp = jref.ssm.init_ssm_cache(
        rcfg, 3, None if state_dtype is None else jref.jnp.bfloat16)
    out = tssm.init_ssm_cache(
        cfg, 3, None if state_dtype is None else torch.bfloat16,
        device="cpu")
    for k in ("conv", "ssm"):
        assert tuple(out[k].shape) == exp[k].shape
        assert str(out[k].dtype).removeprefix("torch.") == str(exp[k].dtype)
        assert not out[k].any()


def test_ssd_state_feeds_decode(jref):
    """``tests/test_kernels.py:test_ssd_state_feeds_decode`` as parity: the
    port's ``ssd_chunked`` final state at chunk 128 against the
    reference's at chunk 64, and the recurrent step continued from each
    state over the next tokens."""
    rng = np.random.default_rng(9)
    b, L, H, P, N = 1, 256, 2, 64, 128
    f = lambda *s: rng.normal(size=s).astype(np.float32)    # noqa: E731
    x, dt = f(b, L, H, P), f(b, L, H) * 0.5
    B, C = f(b, L, N) * N ** -0.5, f(b, L, N) * N ** -0.5
    A_log, D = f(H) * 0.3, f(H) * 0.1
    _, s_ref = jref.ssm.ssd_chunked(*(jref.jnp.asarray(a) for a in
                                      (x, dt, B, C, A_log, D)), chunk=64)
    _, s_port = tssm.ssd_chunked(*(torch.from_numpy(a) for a in
                                   (x, dt, B, C, A_log, D)), chunk=128)
    np.testing.assert_allclose(_np(s_port), _np(s_ref), **F32)

    rcfg, cfg = _cfgs(jref, "mamba2-780m", d_model=64, ssm_state=N,
                      ssm_head_dim=P)
    assert cfg.ssm_heads == H
    p = _mix_params(jref, rcfg, 10)
    rc = dict(jref.ssm.init_ssm_cache(rcfg, b), ssm=s_ref)
    tc = dict(tssm.init_ssm_cache(cfg, b, device="cpu"), ssm=s_port.clone())
    for _ in range(4):
        xt = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        ey, rc = jref.ssm.mamba_decode_step(
            {k: jref.jnp.asarray(a) for k, a in p.items()},
            jref.jnp.asarray(xt), rc, rcfg)
        y, tc = tssm.mamba_decode_step(
            {k: torch.from_numpy(np.array(a)) for k, a in p.items()},
            torch.from_numpy(xt), tc, cfg)
        np.testing.assert_allclose(_np(y), _np(ey), **F32)
    np.testing.assert_allclose(_np(tc["ssm"]), _np(rc["ssm"]), **F32)


# ---------------------------------------------------------------------------
# lm.decode_step, dense and ssm
# ---------------------------------------------------------------------------
DECODE_CASES = {
    "gemma-2b": ("gemma-2b", {}),
    "qwen3-4b": ("qwen3-4b", {}),
    "qwen3-4b-swa": ("qwen3-4b", {"window": 4}),
    "mamba2-780m": ("mamba2-780m", {}),
}


def _decode_cfgs(jref, case, dtype):
    arch, kw = DECODE_CASES[case]
    kw = {"param_dtype": dtype, "compute_dtype": dtype, **kw}
    rcfg = jref.configs.get_smoke(arch)
    cfg = tconfigs.get_smoke(arch)
    if "window" in kw:          # long_500k's SWA, with a window of 4 slots
        rcfg = jref.steps.effective_config(rcfg, jref.configs.SHAPES[
            "long_500k"])
        cfg = effective_config(cfg, SHAPES["long_500k"])
        assert cfg.attention == rcfg.attention == "swa"
    return rcfg.replace(**kw), cfg.replace(**kw)


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_step_matches_reference(jref, case):
    """8 steps from position 0, teacher-forced; under SWA the ring of 4
    slots wraps at step 4. Float32 logits at 2e-5, greedy tokens equal."""
    rcfg, cfg = _decode_cfgs(jref, case, "float32")
    rp, tp = h.carried(jref, rcfg, cfg)
    toks = h.tokens(cfg, 2, 8)
    exp = h.ref_decode_logits(jref, rcfg, rp, toks, 16)
    out = h.port_decode_logits(cfg, tp, toks, 16)
    np.testing.assert_allclose(out, exp, **F32)
    np.testing.assert_array_equal(out.argmax(-1), exp.argmax(-1))


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_step_matches_reference_bf16(jref, case):
    rcfg, cfg = _decode_cfgs(jref, case, "bfloat16")
    rp, tp = h.carried(jref, rcfg, cfg)
    toks = h.tokens(cfg, 2, 8)
    exp = h.ref_decode_logits(jref, rcfg, rp, toks, 16)
    out = h.port_decode_logits(cfg, tp, toks, 16)
    assert np.isfinite(out).all()
    assert h.share_of_max(out, exp) <= 2e-2


@pytest.mark.parametrize("case,S", [("gemma-2b", 24), ("qwen3-4b-swa", 32),
                                    ("mamba2-780m", 64)],
                         ids=["dense", "dense-swa", "ssm"])
def test_decode_matches_own_prefill(case, S):
    """The port's teacher-forced decode against its own prefill of the
    same tokens, at every position (float32; under SWA a window of 8
    over 32 positions: the ring wraps three times)."""
    arch, kw = DECODE_CASES[case]
    cfg = tconfigs.get_smoke(arch).replace(param_dtype="float32",
                                           compute_dtype="float32")
    if "window" in kw:
        cfg = effective_config(cfg, SHAPES["long_500k"]).replace(window=8)
    params = init_params(model_decls(cfg), torch.Generator().manual_seed(0),
                         "cpu", torch.float32)
    toks = h.tokens(cfg, 2, S, seed=3)
    dec = h.port_decode_logits(cfg, params, toks, S)
    pre = h.port_prefill_logits(cfg, params, toks)
    assert h.share_of_max(dec, pre) <= 1e-4


def test_decode_step_writes_the_stacked_cache_in_place():
    cfg = tconfigs.get_smoke("qwen3-4b").replace(param_dtype="float32",
                                                 compute_dtype="float32")
    params = init_params(model_decls(cfg), torch.Generator().manual_seed(0),
                         "cpu", torch.float32)
    cache = lm.init_cache(cfg, 2, 8, device="cpu")
    k = cache["layers"]["k"]
    assert tuple(k.shape) == (cfg.n_layers, 2, 8, cfg.n_kv_heads,
                              cfg.head_dim)
    with torch.inference_mode():
        _, out = lm.decode_step(params, torch.zeros((2, 1), dtype=torch.int32),
                                0, cache, cfg)
    assert out["layers"]["k"] is k
    assert k[:, :, 0].abs().sum() > 0 and not k[:, :, 1:].any()


# ---------------------------------------------------------------------------
# int8 serving weights (tests/test_perf_features.py:19-69 as parity)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(256, 512), (4, 256, 512), (300,)])
def test_quantize_matches_reference(jref, shape):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    w.flat[:3] = 127.0, 2.5, -3.5     # scale 1: two ties, rounded to even
    exp = jref.quant.quantize(jref.jnp.asarray(w))
    out = tquant.quantize(torch.from_numpy(w))
    assert out.dtype == torch.int8 and tuple(out.shape) == shape
    np.testing.assert_array_equal(out.q.numpy(), np.asarray(exp.q))
    np.testing.assert_array_equal(out.s.numpy(), np.asarray(exp.s))
    np.testing.assert_array_equal(out.to(torch.float32).numpy(), np.asarray(
        exp.astype(jref.jnp.float32)))
    if len(shape) == 2:
        w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
        deq = tquant.quantize(torch.from_numpy(w)).to(torch.float32).numpy()
        rel = np.linalg.norm(deq - w) / np.linalg.norm(w)
        assert rel < 0.02                      # absmax int8: ~1% rms error


def test_quantized_array_slices_a_stacked_leaf():
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 256, 512)).astype(np.float32))
    q = tquant.quantize(w)
    for i in range(4):
        qi = q[i]
        assert isinstance(qi, tquant.QuantizedArray)
        assert tuple(qi.s.shape) == (1, 1)
        one = tquant.quantize(w[i])
        assert torch.equal(qi.q, one.q) and torch.equal(qi.s, one.s)
        assert torch.equal(qi.to(torch.bfloat16), one.to(torch.bfloat16))


@pytest.mark.parametrize("arch", ["mistral-large-123b", "gemma-2b",
                                  "mamba2-780m", "zamba2-7b"])
def test_quantize_params_picks_the_reference_leaves(jref, arch):
    """The same leaves quantized, to the same q, at the smoke size widened
    to 256 so that the projections qualify."""
    kw = {"d_model": 256, "d_ff": 512}
    if jref.configs.get_smoke(arch).n_heads:
        kw.update(n_heads=4, n_kv_heads=2, head_dim=64)
    rcfg, cfg = _cfgs(jref, arch, **kw)
    tree = h.ref_params(jref, rcfg)
    rq = dict(tree_leaves(jref.quant.quantize_params(
        jref.jax.tree.map(jref.jnp.asarray, tree))))
    tq = dict(tree_leaves(tquant.quantize_params(
        lm_params_from_numpy(tree, cfg, device="cpu"))))
    assert rq.keys() == tq.keys()
    want = sorted(p for p, leaf in rq.items()
                  if isinstance(leaf, jref.quant.QuantizedArray))
    got = sorted(p for p, leaf in tq.items()
                 if isinstance(leaf, tquant.QuantizedArray))
    assert got == want and len(got) >= 2
    for p in got:
        np.testing.assert_array_equal(tq[p].q.numpy(), np.asarray(rq[p].q))


def test_quantize_params_skips_small_and_vectors():
    params = {"norm": torch.ones((4, 4096)),        # stacked vectors: skip
              "small": torch.ones((64, 64)),        # too small: skip
              "embedding": torch.ones((512, 256)),  # excluded by name
              "wi": torch.ones((512, 512))}         # quantized
    q = tquant.quantize_params(params)
    assert isinstance(q["wi"], tquant.QuantizedArray)
    for k in ("norm", "small", "embedding"):
        assert not isinstance(q[k], tquant.QuantizedArray), k


def _mistral_wide(jref):
    return _cfgs(jref, "mistral-large-123b", d_model=256, d_ff=512,
                 n_heads=4, n_kv_heads=2, head_dim=64)


def test_quantized_decode_matches_reference(jref):
    """The quantized decode of the mistral smoke variant of
    ``test_quantized_decode_matches_fp``: the port against the reference's
    quantized decode (float32 2e-5), and the reference's own bound
    (relative 0.1) against the unquantized decode."""
    rcfg, cfg = _mistral_wide(jref)
    tree = h.ref_params(jref, rcfg)
    rp = jref.jax.tree.map(jref.jnp.asarray, tree)
    tp = lm_params_from_numpy(tree, cfg, device="cpu")
    rq, tq = jref.quant.quantize_params(rp), tquant.quantize_params(tp)
    toks = h.tokens(cfg, 2, 6, seed=1)
    exp = h.ref_decode_logits(jref, rcfg, rq, toks, 64)
    out = h.port_decode_logits(cfg, tq, toks, 64)
    np.testing.assert_allclose(out, exp, **F32)
    full = h.port_decode_logits(cfg, tp, toks, 64)
    assert np.linalg.norm(out - full) / np.linalg.norm(full) < 0.1


# ---------------------------------------------------------------------------
# make_serve_step and the decode mode of the launcher
# ---------------------------------------------------------------------------
def test_serve_step_is_decode_then_argmax():
    cfg = tconfigs.get_smoke("gemma-2b").replace(param_dtype="float32",
                                                 compute_dtype="float32")
    params = init_params(model_decls(cfg), torch.Generator().manual_seed(0),
                         "cpu", torch.float32)
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    with torch.inference_mode():
        logits, _ = lm.decode_step(params, tok, 0,
                                   lm.init_cache(cfg, 2, 4, device="cpu"), cfg)
        nxt, _ = make_serve_step(cfg, device="cpu")(
            params, tok, 0, lm.init_cache(cfg, 2, 4, device="cpu"))
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (2, 1)
    assert torch.equal(nxt[:, 0], logits[:, -1].argmax(-1).to(torch.int32))


def test_cli_decode_prints_the_reference_lines(capsys):
    res = serve_cli.run_decode(serve_cli.parse_args(
        ["--arch", "gemma-2b", "--smoke", "--batch", "2", "--prompt-len", "8",
         "--gen", "8", "--device", "cpu"]))
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    assert re.fullmatch(r"\[serve\] 2 seqs x 8 tokens in \d+\.\ds "
                        r"\(\d+\.\d tok/s\)", lines[0]), lines[0]
    assert lines[1] == f"[serve] sample: {res.tokens[0][:16].tolist()}"
    assert res.tokens.shape == (2, 8) and res.tokens.dtype == np.int32
    assert res.steps == 15 and res.tok_per_s > 0


def test_cli_decode_int8(capsys):
    serve_cli.main(["--arch", "gemma-2b", "--smoke", "--batch", "2",
                    "--prompt-len", "4", "--gen", "4", "--int8", "--device",
                    "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[serve] int8 serving weights enabled"
    assert lines[1].startswith("[serve] 2 seqs x 4 tokens in ")
    assert lines[2].startswith("[serve] sample: [")


def test_cli_decode_tokens_equal_the_reference_loop(jref):
    """With carried float32 weights, the factored decode loop gives the
    tokens of the reference's ``make_serve_step`` loop (``run_decode``'s,
    prompt from ``default_rng(0)``)."""
    rcfg, cfg = _cfgs(jref, "gemma-2b")
    rp, tp = h.carried(jref, rcfg, cfg)
    B, P, G = 2, 8, 8
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P),
                                               dtype=np.int32)
    jax, jnp = jref.jax, jref.jnp
    serve = jax.jit(jref.steps.make_serve_step(rcfg, jref.models.CPU_AXES,
                                               None))
    cache = jref.models.init_cache(rcfg, B, P + G)
    tok, outs = jnp.asarray(prompt[:, :1]), []
    for pos in range(P + G - 1):
        nxt, cache = serve(rp, tok, jnp.int32(pos), cache)
        if pos + 1 < P:
            tok = jnp.asarray(prompt[:, pos + 1:pos + 2])
        else:
            tok = nxt
            outs.append(np.asarray(nxt)[:, 0])
    tokens, _ = serve_cli.decode(cfg, tp, prompt, G, device="cpu")
    np.testing.assert_array_equal(tokens, np.stack(outs, 1))


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "seamless-m4t-large-v2",
                                  "paligemma-3b"])
def test_cli_decode_of_an_unported_family_names_a8(arch, capsys):
    """The families that ROADMAP.md A.8 listed as unported are served now:
    the CLI decodes each smoke config on the CPU at its defaults."""
    serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serve] 4 seqs x 32 tokens in ")
    assert lines[1].startswith("[serve] sample: [")


def test_cli_decode_needs_arch():
    with pytest.raises(SystemExit):
        serve_cli.main(["--batch", "2"])

