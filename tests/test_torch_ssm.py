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
op by op (see the test). The CUDA kernel is held against its plain
version on the card (marked ``cuda``).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs
from repro_torch.kernels import ssd_chunked, ssd_chunked_plain
from repro_torch.launch.serve_prefill import serve_prefill
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import lm_params_from_numpy
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
def test_cuda_kernel_matches_plain(cuda, dtype, L, Q, P, N, slow):
    args = _t(_ssd_inputs(L + Q + P + N, 2, L, 3, P, N, slow), dtype, cuda)
    s0 = torch.randn((2, 3, P, N), device=cuda)
    before = ssd_chunked.launches
    y, s = ssd_chunked(*args, chunk=Q, init_state=s0)
    torch.cuda.synchronize()
    assert ssd_chunked.launches == before + 1
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
    vy, vs = ssd_chunked(views[0], dt, views[1], views[2], A_log, D,
                         chunk=Q, init_state=s0)
    torch.testing.assert_close(vy, y, atol=0, rtol=0)
    torch.testing.assert_close(vs, s, atol=0, rtol=0)
