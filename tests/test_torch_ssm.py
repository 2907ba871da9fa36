"""Port SSM (mamba2) prefill slice vs the JAX reference: the SSD chunk scan
(plain version against the model zoo's ``ssd_chunked`` and the Pallas
kernel in interpret mode), the causal conv, the Mamba2 mixer, the whole
mamba2 prefill step, and the serving driver on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Parameters the reference initialises to 0 or 1 (A_log, D, dt_bias, conv_b,
norm, ln) are overwritten with numpy draws in both, so that a wrong sign of
a or a dropped D * x would show. Tolerances: the SSD scan 2e-5 in float32
(``tests/test_kernels.py``'s: the same math, sums in another order); in
bfloat16 one bf16 ulp of the model zoo's ``ssd_chunked`` (both compute in
float32 and round y once; the Pallas wrapper rounds twice and is held to
it only in float32); the mixer 1e-5 in float32; the prefill logits 1e-4
in float32 and, in bfloat16, bit for bit against the reference evaluated
op by op (see the test). The CUDA kernels are held against their plain
versions on the card (marked ``cuda``). The tensor-core route's arithmetic
(bf16 products, u, S_in and W split in two bf16 parts) is emulated on the
CPU and held to ``chip_smoke.py``'s gates.
"""
import types
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs
from repro_torch.kernels import (ssd, ssd_chunk_out, ssd_chunk_out_plain,
                                 ssd_chunk_state, ssd_chunk_state_plain,
                                 ssd_chunked, ssd_chunked_fma,
                                 ssd_chunked_plain, ssd_chunked_tc,
                                 ssd_state_scan, ssd_state_scan_plain)
from repro_torch.launch.serve_prefill import serve_prefill
from repro_torch.launch.steps import effective_config, make_prefill_step
from repro_torch.models import init_params, lm_params_from_numpy, model_decls
from repro_torch.models import ssm as tssm

BF16_ULP = {"atol": 1e-5, "rtol": 2 ** -7}


@pytest.fixture(scope="module")
def jref():
    """The JAX reference, imported here so that the ``cuda`` tests of this
    file also run on a machine that has a card and no JAX."""
    jax = pytest.importorskip("jax")
    import repro.configs as configs
    import repro.models as models
    from repro.kernels.ssd import ssd_chunked_pallas
    from repro.launch import steps
    from repro.models import ssm
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, configs=configs,
                                 models=models, steps=steps, ssm=ssm,
                                 pallas=ssd_chunked_pallas)


def _ssd_inputs(seed, b, L, H, P, N, slow=False):
    """The distributions of tests/test_kernels.py:_ssd_inputs, from numpy.
    With them a chunk of 128 decays the state by about e^-90, so ``slow``
    shifts dt by -4 and A_log by -3 (a chunk decays it by about e^-0.1):
    then the state carried across chunks counts."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)    # noqa: E731
    return [f(b, L, H, P), f(b, L, H) * 0.5 - 4 * slow, f(b, L, N) * N ** -0.5,
            f(b, L, N) * N ** -0.5, f(H) * 0.3 - 3 * slow, f(H) * 0.1]


def _t(arrays, dtype=torch.float32, device="cpu"):
    """To torch: x, B, C in ``dtype``; dt, A_log, D in float32."""
    x, dt, B, C, A_log, D = (torch.from_numpy(np.asarray(a)) for a in arrays)
    return [x.to(device, dtype), dt.to(device), B.to(device, dtype),
            C.to(device, dtype), A_log.to(device), D.to(device)]


def _j(jref, arrays, dtype=torch.float32):
    jnp = jref.jnp
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x, dt, B, C, A_log, D = (jnp.asarray(a) for a in arrays)
    return [x.astype(jd), dt, B.astype(jd), C.astype(jd), A_log, D]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the SSD scan: plain version vs the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("L,Q", [(256, 128), (512, 128), (512, 256),
                                 (128, 128), (96, 256)])
@pytest.mark.parametrize("P,N", [(64, 128), (128, 128), (64, 64)])
def test_plain_matches_reference_ssd(jref, L, Q, P, N):
    """(96, 256): L < chunk, so Q = L."""
    arrays = _ssd_inputs(L + P + N, 2, L, 2, P, N)
    out, state = ssd_chunked_plain(*_t(arrays), chunk=Q)
    for fn in (jref.ssm.ssd_chunked, jref.pallas):
        y, s = fn(*_j(jref, arrays), chunk=Q)
        np.testing.assert_allclose(_np(out), _np(y), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(_np(state), _np(s), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("slow", [False, True])
def test_plain_init_state_matches_reference(jref, slow):
    arrays = _ssd_inputs(11, 2, 256, 2, 64, 128, slow)
    s0 = np.random.default_rng(12).normal(size=(2, 2, 64, 128)).astype(
        np.float32)
    out, state = ssd_chunked_plain(*_t(arrays), chunk=128,
                                   init_state=torch.from_numpy(s0))
    y, s = jref.ssm.ssd_chunked(*_j(jref, arrays), chunk=128,
                                init_state=jref.jnp.asarray(s0))
    np.testing.assert_allclose(_np(out), _np(y), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(state), _np(s), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("L,Q", [(256, 128), (512, 256)])
def test_plain_bf16_within_one_ulp_of_reference(jref, L, Q):
    arrays = _ssd_inputs(L + Q, 2, L, 2, 64, 128)
    out, state = ssd_chunked_plain(*_t(arrays, torch.bfloat16), chunk=Q)
    y, s = jref.ssm.ssd_chunked(*_j(jref, arrays, torch.bfloat16), chunk=Q)
    assert out.dtype == torch.bfloat16 and state.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(y), **BF16_ULP)
    np.testing.assert_allclose(_np(state), _np(s), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("slow", [False, True])
def test_final_state_under_two_chunkings(jref, slow):
    """As tests/test_kernels.py:test_ssd_state_feeds_decode."""
    arrays = _ssd_inputs(9, 1, 256, 2, 64, 128, slow)
    _, s128 = ssd_chunked_plain(*_t(arrays), chunk=128)
    _, s64 = ssd_chunked_plain(*_t(arrays), chunk=64)
    _, ref64 = jref.ssm.ssd_chunked(*_j(jref, arrays), chunk=64)
    np.testing.assert_allclose(_np(s128), _np(s64), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(s128), _np(ref64), atol=2e-5, rtol=2e-5)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args = _t(_ssd_inputs(5, 1, 256, 2, 64, 64))
    before = ssd_chunked.launches
    y, s = ssd_chunked(*args, chunk=128)
    assert ssd_chunked.launches == before
    py, ps = ssd_chunked_plain(*args, chunk=128)
    torch.testing.assert_close(y, py, atol=0, rtol=0)
    torch.testing.assert_close(s, ps, atol=0, rtol=0)


@pytest.mark.parametrize("bad,err", [("chunk", ValueError),
                                     ("shape", ValueError),
                                     ("init", ValueError),
                                     ("dtype", TypeError)])
def test_wrapper_raises_on_what_the_reference_rejects(bad, err):
    x, dt, B, C, A_log, D = _t(_ssd_inputs(6, 1, 256, 2, 64, 64))
    kw = {"chunk": 128}
    if bad == "chunk":
        kw["chunk"] = 96                         # L % Q != 0
    elif bad == "shape":
        B = B[:, :128]
    elif bad == "init":
        kw["init_state"] = torch.zeros(1, 2, 64, 32)
    else:
        dt = dt.to(torch.int32)
    for fn in (ssd_chunked, ssd_chunked_plain):
        with pytest.raises(err):
            fn(x, dt, B, C, A_log, D, **kw)


# ---------------------------------------------------------------------------
# the tensor-core route: its three stages, its arithmetic, the routing
# ---------------------------------------------------------------------------
def _stages_plain(x, dt, B, C, A_log, D, *, chunk, init_state=None):
    dts, da = ssd._discretize(dt, A_log)
    la, ds = ssd_chunk_state_plain(x, dts, da, B, chunk=chunk)
    s_in, state = ssd_state_scan_plain(la, ds, chunk=chunk,
                                       init_state=init_state)
    return ssd_chunk_out_plain(x, dts, la, B, C, D, s_in,
                               chunk=chunk), state


@pytest.mark.parametrize("L,Q,P,N", [(256, 128, 64, 128), (512, 256, 64, 128),
                                     (512, 64, 128, 64), (96, 96, 32, 64)])
@pytest.mark.parametrize("slow", [False, True])
def test_plain_stages_compose_to_the_plain_version(L, Q, P, N, slow):
    """K1, K2 and K3's plain stages, composed, are ssd_chunked_plain."""
    args = _t(_ssd_inputs(L + Q + P, 2, L, 3, P, N, slow))
    s0 = torch.from_numpy(np.random.default_rng(L).normal(
        size=(2, 3, P, N)).astype(np.float32))
    for init in (None, s0):
        y, state = _stages_plain(*args, chunk=Q, init_state=init)
        py, pstate = ssd_chunked_plain(*args, chunk=Q, init_state=init)
        torch.testing.assert_close(y, py, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(state, pstate, atol=2e-5, rtol=2e-5)


def _split(v, parts):
    """v as the sum of ``parts`` bf16 values (hi, mid, lo), each the bf16
    rounding of what the parts before it leave."""
    out = []
    for _ in range(parts):
        out.append(v.bfloat16().float())
        v = v - out[-1]
    return out


TC_PARTS = {"u": 3, "S": 3, "W": 3}


def _emulate_tc(x, dt, B, C, A_log, D, *, chunk, init_state=None,
                parts=TC_PARTS):
    """csrc/ssd_chunk_tc.cu's arithmetic in torch, -> (y in float32 before
    its rounding, final state). K1: u = x * exp(la_end - la) * dt in
    float32, ds = u^T B on bf16 operands (exact products, float32 sums), u
    in ``parts["u"]`` bf16 parts. K2: S <- S * exp(la_end) + ds in float32.
    K3: G = C B^T on the raw bf16 operands; W = G * exp(la_s - la_t) * dt_t
    masked before the exp, in ``parts["W"]`` parts; y = W x + (C S_in^T)
    exp(la) + D x with S_in in ``parts["S"]`` parts, all in float32."""
    b, L, H, P = x.shape
    N, Q = B.shape[-1], chunk
    nc = L // Q
    dts, da = ssd._discretize(dt, A_log)
    la = ssd._chunk_cumsum(da, Q)                             # (b, nc, Q, H)
    xf = x.float().reshape(b, nc, Q, H, P)
    Bf, Cf = (t.float().reshape(b, nc, Q, N) for t in (B, C))
    dtq = dts.reshape(b, nc, Q, H)
    u = xf * (torch.exp(la[:, :, -1:] - la) * dtq)[..., None]
    ds = sum(torch.einsum("bctn,bcthp->bchpn", Bf, part)
             for part in _split(u, parts["u"]))
    S = (torch.zeros((b, H, P, N)) if init_state is None
         else init_state.float())
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    y = torch.empty(x.shape)
    for c in range(nc):
        lq = la[:, c]
        G = torch.einsum("bsn,btn->bst", Cf[:, c], Bf[:, c])
        seg = lq[:, :, None, :] - lq[:, None, :, :]
        W = G[..., None] * torch.exp(seg.masked_fill(
            ~causal[None, :, :, None], float("-inf"))) * dtq[:, c, None]
        yq = sum(torch.einsum("bsth,bthp->bshp", part, xf[:, c])
                 for part in _split(W, parts["W"]))
        yint = sum(torch.einsum("bsn,bhpn->bshp", Cf[:, c], part)
                   for part in _split(S, parts["S"]))
        y[:, c * Q:(c + 1) * Q] = yq + yint * torch.exp(lq)[..., None] \
            + D.float()[:, None] * xf[:, c]
        S = S * torch.exp(lq[:, -1])[..., None, None] + ds[:, c]
    return y, S


def _gate_failures(args, chunk, init_state=None, parts=TC_PARTS):
    """(y, state) entries of the emulation that miss chip_smoke.py's gates
    against ssd_chunked_plain: y one bf16 ulp, the state 2e-5."""
    y, state = _emulate_tc(*args, chunk=chunk, init_state=init_state,
                           parts=parts)
    py, pstate = ssd_chunked_plain(*args, chunk=chunk, init_state=init_state)
    y = y.to(py.dtype)
    return (int((~torch.isclose(y.float(), py.float(), **BF16_ULP)).sum()),
            int((~torch.isclose(state, pstate, atol=2e-5, rtol=2e-5)).sum()))


def _synthetic(slow, init):
    args = _t(_ssd_inputs(0, 1, 1024, 8, 64, 128, slow), torch.bfloat16)
    s0 = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 8, 64, 128)).astype(np.float32)) if init else None
    return args, s0


@pytest.mark.parametrize("slow", [False, True])
@pytest.mark.parametrize("init", [False, True])
def test_tc_numerics_meet_the_gates(slow, init):
    """The design's arithmetic holds the plain version to one bf16 ulp on y
    and 2e-5 on the state (b 1, L 1024, H 8, P 64, N 128, chunk 256)."""
    args, s0 = _synthetic(slow, init)
    assert _gate_failures(args, 256, s0) == (0, 0)


def test_s_in_rounded_once_to_bf16_fails_the_gate():
    """Why K3 splits S_in: one bf16 rounding of the state entering a chunk
    misses the y gate at slow decay (where the carried state counts)."""
    args, _ = _synthetic(True, False)
    y_fail, _ = _gate_failures(args, 256, parts={**TC_PARTS, "S": 1})
    assert y_fail > 0.01 * 1024 * 8 * 64


@pytest.fixture(scope="module")
def mamba2_activations():
    """The SSD inputs of the first layer of the full-width mamba2-780m
    (one layer, prefill_32k's config, weights from a seeded generator),
    on a prompt of 1024 tokens: x, B and C of the model's scale, where y
    is a small sum of large terms."""
    cfg = effective_config(tconfigs.get_config("mamba2-780m"),
                           tconfigs.SHAPES["prefill_32k"]).replace(n_layers=1)
    params = init_params(model_decls(cfg), torch.Generator().manual_seed(0),
                         "cpu", cfg.pdtype)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 1024),
                                               dtype=np.int32)
    seen = []

    def grab(*args, **kw):
        seen.append((args, kw["chunk"]))
        return ssd_chunked(*args, **kw)

    with mock.patch.object(tssm, "ssd_chunked", grab), torch.inference_mode():
        make_prefill_step(cfg, device="cpu")(params, {"tokens": tokens})
    (args, chunk), = seen
    return [t.clone() for t in args], chunk


def _ulps_before_rounding(args, chunk, parts):
    """The largest error of the emulation's float32 y against the plain
    version's float32 y (same bf16 values, float32 arithmetic), in units
    of the bf16 ulp of the plain y."""
    a32 = [t.float() for t in args]
    y, _ = _emulate_tc(*a32, chunk=chunk, parts=parts)
    py, _ = ssd_chunked_plain(*a32, chunk=chunk)
    ulp = torch.exp2(torch.floor(torch.log2(py.abs().clamp_min(1e-30))) - 7)
    return float(((y - py).abs() / (ulp + 1e-5)).max())


def test_tc_numerics_meet_the_gates_on_mamba2_activations(mamba2_activations):
    """On the model's own activations the three-part design meets the
    gates, with its float32 y within a tenth of an ulp before rounding."""
    args, chunk = mamba2_activations
    assert _gate_failures(args, chunk) == (0, 0)
    assert _ulps_before_rounding(args, chunk, TC_PARTS) < 0.1


@pytest.mark.parametrize("operand", ["u", "S", "W"])
def test_two_parts_of_an_operand_lose_the_margin(mamba2_activations,
                                                 operand):
    """Why three parts: with one operand in two, the error before y's
    rounding grows at least twofold (u 8x, S 2.4x, W 70x on this input),
    and two parts of W miss the y gate outright."""
    args, chunk = mamba2_activations
    two = {**TC_PARTS, operand: 2}
    assert _ulps_before_rounding(args, chunk, two) \
        > 2 * _ulps_before_rounding(args, chunk, TC_PARTS)
    if operand == "W":
        assert _gate_failures(args, chunk, parts=two)[0] > 0


@pytest.mark.parametrize("dtype,P,N,Q,route", [
    (torch.bfloat16, 64, 128, 256, "tc"), (torch.bfloat16, 128, 64, 64, "tc"),
    (torch.bfloat16, 64, 128, 128, "tc"), (torch.bfloat16, 64, 128, 96, "fma"),
    (torch.bfloat16, 32, 128, 128, "fma"), (torch.float32, 64, 128, 256, "fma"),
    (torch.float32, 64, 64, 96, "fma"), (torch.bfloat16, 64, 32, 256, None),
    (torch.bfloat16, 48, 128, 256, None), (torch.float32, 64, 128, 512, None),
    (torch.float16, 64, 128, 256, None)])
def test_route_names_the_kernel_or_raises(dtype, P, N, Q, route):
    if route is None:
        with pytest.raises(ValueError):
            ssd._route(dtype, P, N, Q)
    else:
        assert ssd._route(dtype, P, N, Q) == route


@pytest.mark.parametrize("fn", [ssd_chunked_tc, ssd_chunked_fma])
def test_route_entries_raise_on_a_cpu_tensor(fn):
    args = _t(_ssd_inputs(13, 1, 256, 2, 64, 128), torch.bfloat16)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(*args, chunk=128)
    assert fn.launches == before


def test_tc_entries_raise_on_what_they_do_not_take():
    """Q 96 and float32 are the FMA kernel's, not the tensor-core route's."""
    x, dt, B, C, A_log, D = _t(_ssd_inputs(14, 1, 192, 2, 64, 128),
                               torch.bfloat16)
    dts, da = ssd._discretize(dt, A_log)
    with pytest.raises(ValueError, match="tensor-core"):
        ssd_chunk_state(x, dts, da, B, chunk=96)
    with pytest.raises(ValueError, match="tensor-core"):
        ssd_chunk_state(x.float(), dts, da, B.float(), chunk=64)
    la = torch.zeros((1, 192, 2))
    with pytest.raises(ValueError, match="tensor-core"):
        ssd_state_scan(la, torch.zeros((1, 2, 2, 64, 128)), chunk=96)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_chunk_out(x, dts, la, B, C, D, torch.zeros((1, 3, 2, 64, 128)),
                      chunk=64)


# ---------------------------------------------------------------------------
# the mixer and its parts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_causal_conv_matches_reference(jref, dtype):
    """In bfloat16 both round after every product and add, bit for bit;
    in float32 XLA's exp and logistic differ from PyTorch's by an ulp."""
    jnp = jref.jnp
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    rng = np.random.default_rng(8)
    xBC = rng.normal(size=(2, 64, 48)).astype(np.float32)
    w = (rng.normal(size=(4, 48)) * 0.5).astype(np.float32)
    b = (rng.normal(size=(48,)) * 0.1).astype(np.float32)
    exp, exp_state = jref.ssm._causal_conv(
        *(jnp.asarray(a).astype(jd) for a in (xBC, w, b)))
    out, state = tssm._causal_conv(
        *(torch.from_numpy(a).to(dtype) for a in (xBC, w, b)))
    assert out.dtype == dtype
    tol = 0 if dtype == torch.bfloat16 else 1e-6
    np.testing.assert_allclose(_np(out), _np(exp.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_array_equal(_np(state),
                                  _np(exp_state.astype(jnp.float32)))


def _draw_ssm_scalars(rng, tree, lead=()):
    """Overwrite the leaves that the reference initialises to 0 or 1."""
    mix = tree["mix"] if "mix" in tree else tree
    draws = {"A_log": lambda s: rng.normal(size=s) * 0.5,
             "D": lambda s: 1 + rng.normal(size=s) * 0.5,
             "dt_bias": lambda s: rng.normal(size=s) * 0.5,
             "conv_b": lambda s: rng.normal(size=s) * 0.1,
             "norm": lambda s: 1 + rng.normal(size=s) * 0.2}
    for k, draw in draws.items():
        mix[k] = draw(np.shape(mix[k])).astype(np.asarray(mix[k]).dtype)
    if "ln" in tree:
        tree["ln"] = (1 + rng.normal(size=np.shape(tree["ln"])) * 0.1
                      ).astype(np.asarray(tree["ln"]).dtype)
    return tree


def _cfgs(jref, **kw):
    kw = {"param_dtype": "float32", "compute_dtype": "float32", **kw}
    return (jref.configs.get_smoke("mamba2-780m").replace(**kw),
            tconfigs.get_smoke("mamba2-780m").replace(**kw))


def test_mamba_block_matches_reference(jref):
    rcfg, cfg = _cfgs(jref)
    jax = jref.jax
    decls = jref.ssm.ssm_decls(rcfg, jref.models.CPU_AXES)
    p = jax.tree.map(np.asarray, jref.models.init_params(
        decls, jax.random.PRNGKey(3), jref.jnp.float32))
    p = _draw_ssm_scalars(np.random.default_rng(3), dict(p))
    x = np.random.default_rng(4).normal(size=(2, 128, cfg.d_model)).astype(
        np.float32)
    exp = jref.ssm.mamba_block({k: jref.jnp.asarray(v) for k, v in p.items()},
                               jref.jnp.asarray(x), rcfg)
    out = tssm.mamba_block({k: torch.from_numpy(np.array(v))
                            for k, v in p.items()}, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(out), _np(exp), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the slice as a whole: the mamba2 prefill step
# ---------------------------------------------------------------------------
def _prefill_pair(jref, rcfg, cfg, S=512, B=2):
    jax = jref.jax
    ref_params = jax.tree.map(np.asarray, jref.models.init_params(
        jref.models.model_decls(rcfg, jref.models.CPU_AXES),
        jax.random.PRNGKey(0), rcfg.pdtype))
    ref_params["layers"] = _draw_ssm_scalars(
        np.random.default_rng(1), {"ln": ref_params["layers"]["ln"],
                                   "mix": dict(ref_params["layers"]["mix"])})
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)
    exp = jref.steps.make_prefill_step(rcfg, jref.models.CPU_AXES, None)(
        jax.tree.map(jref.jnp.asarray, ref_params),
        {"tokens": jref.jnp.asarray(tokens)})
    params = lm_params_from_numpy(ref_params, cfg, device="cpu")
    with torch.inference_mode():
        out = make_prefill_step(cfg, device="cpu")(params,
                                                   {"tokens": tokens})
    assert out.shape == (B, 1, cfg.padded_vocab)
    assert out.dtype == torch.float32
    return _np(out), _np(exp)


def test_prefill_step_matches_reference(jref):
    rcfg, cfg = _cfgs(jref)
    out, exp = _prefill_pair(jref, rcfg, cfg)
    np.testing.assert_allclose(out, exp, atol=1e-4, rtol=1e-4)


def test_prefill_step_matches_reference_bf16(jref):
    """Held to the reference evaluated op by op (``jax.disable_jit``),
    where both round to bfloat16 after every op: bit for bit. (Compiled,
    XLA keeps float32 inside its fusions; on this case the compiled
    reference differs from its own op-by-op evaluation by 0.070 in logits
    up to 3.375, 2.1% of the largest, so the 2e-2 rule of
    ``test_torch_lm.py`` would fail the reference against itself.)"""
    rcfg, cfg = _cfgs(jref, param_dtype="bfloat16", compute_dtype="bfloat16")
    with jref.jax.disable_jit():
        out, exp = _prefill_pair(jref, rcfg, cfg)
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, exp)


def test_serve_prefill_mamba2_smoke_on_cpu():
    res = serve_prefill("mamba2-780m", shape="prefill_32k", smoke=True,
                        batch=2, prompt_len=256, device="cpu")
    assert res.cfg.family == "ssm"
    assert res.logits.shape == (2, 1, res.cfg.padded_vocab)
    assert torch.isfinite(res.logits).all()
    assert (res.launches, res.ssd_launches) == (0, 0)   # plain versions ran
    with torch.inference_mode():
        again = make_prefill_step(res.cfg, device="cpu")(
            res.params, {"tokens": res.tokens})
    torch.testing.assert_close(again, res.logits, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the CUDA kernel (runs only where there is a card)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,Q,P,N", [(256, 128, 64, 128), (512, 256, 64, 128),
                                     (512, 128, 128, 128), (128, 64, 64, 64),
                                     (96, 256, 64, 128)])
@pytest.mark.parametrize("slow", [False, True])
@pytest.mark.parametrize("route", ["routed", "fma"])
def test_cuda_kernel_matches_plain(cuda, dtype, L, Q, P, N, slow, route):
    """``routed``: ssd_chunked, which takes the tensor-core route for bf16
    with P % 64 == 0 and Q % 64 == 0 and the FMA kernel otherwise; ``fma``:
    the FMA kernel on every input, bf16 ones of the tensor-core route
    included."""
    args = _t(_ssd_inputs(L + Q + P + N, 2, L, 3, P, N, slow), dtype, cuda)
    s0 = torch.randn((2, 3, P, N), device=cuda)
    fn = ssd_chunked if route == "routed" else ssd_chunked_fma
    kernel = ssd._KERNELS[ssd._route(dtype, P, N, min(Q, L))] \
        if route == "routed" else ssd_chunked_fma
    before = fn.launches, kernel.launches
    y, s = fn(*args, chunk=Q, init_state=s0)
    torch.cuda.synchronize()
    assert (fn.launches, kernel.launches) == (before[0] + 1, before[1] + 1)
    py, ps = ssd_chunked_plain(*args, chunk=Q, init_state=s0)
    tol = BF16_ULP if dtype == torch.bfloat16 else {"atol": 2e-5,
                                                     "rtol": 2e-5}
    torch.testing.assert_close(y, py, **tol)
    torch.testing.assert_close(s, ps, atol=2e-5, rtol=2e-5)
    # x, B, C as strided views of one tensor, as mamba_block passes them
    x, dt, B, C, A_log, D = args
    H = x.shape[2]
    packed = torch.cat([x.reshape(2, L, H * P), B, C], dim=-1)
    views = (packed[..., :H * P].reshape(2, L, H, P),
             packed[..., H * P:H * P + N], packed[..., H * P + N:])
    vy, vs = fn(views[0], dt, views[1], views[2], A_log, D, chunk=Q,
                init_state=s0)
    torch.testing.assert_close(vy, y, atol=0, rtol=0)
    torch.testing.assert_close(vs, s, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("L,Q,P,N", [(512, 128, 64, 128), (512, 256, 64, 128),
                                     (256, 64, 128, 64)])
@pytest.mark.parametrize("slow", [False, True])
def test_cuda_tc_stages_match_their_plain_stages(cuda, L, Q, P, N, slow):
    """K1, K2 and K3 each against its plain stage on the plain stage's own
    inputs: la and ds at 2e-5, the states entering the chunks and the
    final state at 2e-5, y at one bf16 ulp."""
    x, dt, B, C, A_log, D = _t(_ssd_inputs(L + Q + N, 2, L, 3, P, N, slow),
                               torch.bfloat16, cuda)
    s0 = torch.randn((2, 3, P, N), device=cuda)
    dts, da = ssd._discretize(dt, A_log)
    before = [f.launches for f in (ssd_chunk_state, ssd_state_scan,
                                   ssd_chunk_out)]
    la, ds = ssd_chunk_state(x, dts, da, B, chunk=Q)
    pla, pds = ssd_chunk_state_plain(x, dts, da, B, chunk=Q)
    torch.cuda.synchronize()
    torch.testing.assert_close(la, pla, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(ds, pds, atol=2e-5, rtol=2e-5)
    st = pds.clone()
    state = ssd_state_scan(pla, st, chunk=Q, init_state=s0)
    s_in, pstate = ssd_state_scan_plain(pla, pds, chunk=Q, init_state=s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(st, s_in, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(state, pstate, atol=2e-5, rtol=2e-5)
    y = ssd_chunk_out(x, dts, pla, B, C, D, s_in, chunk=Q)
    py = ssd_chunk_out_plain(x, dts, pla, B, C, D, s_in, chunk=Q)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, py, **BF16_ULP)
    assert [f.launches for f in (ssd_chunk_state, ssd_state_scan,
                                 ssd_chunk_out)] == [n + 1 for n in before]
