"""Port sliding-window attention kernel module vs the reference Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) and the oracles.

Tolerances are those of tests/test_kernels.py: float32 2e-5, bfloat16 2e-2
(both sides compute in float32 and round the output once), and 3e-5 for
the model-layout wrapper against the model zoo's chunk + halo
``swa_attention``. The CUDA kernel is held against its plain version on
the card (marked ``cuda``) at the same tolerances: both sum float32
products, in different orders.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (ref, swa_attention, swa_attention_op,
                                 swa_attention_plain)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def jref():
    """The JAX reference, imported here so that the ``cuda`` tests of this
    file also run on a machine that has a card and no JAX."""
    jnp = pytest.importorskip("jax.numpy")
    import repro.kernels as kernels
    from repro.models.attention import swa_attention as model_swa
    return types.SimpleNamespace(
        jnp=jnp, pallas=kernels.swa_attention_pallas,
        op=kernels.swa_attention_op, oracle=kernels.ref.swa_attention_ref,
        model_swa=model_swa)


def _qkv(seed, B, H, KV, S, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))]


def _to_torch(arrays, dtype=torch.float32, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=dtype)
            for a in arrays]


def _to_jax(jref, arrays, dtype=torch.float32):
    jnp = jref.jnp
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return [jnp.asarray(a).astype(jd) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# plain version vs the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,window", [(256, 128), (512, 256), (384, 128)])
@pytest.mark.parametrize("D", [64, 128])
def test_plain_matches_pallas_shapes(jref, S, window, D):
    arrays = _qkv(S + D, 1, 2, 1, S, D)
    exp = jref.pallas(*_to_jax(jref, arrays), window=window,
                      scale=D ** -0.5, blk=128)
    out = swa_attention_plain(*_to_torch(arrays), window=window,
                              scale=D ** -0.5)
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_pallas_dtypes(jref, dtype):
    arrays = _qkv(0, 2, 4, 2, 256, 64)
    exp = jref.pallas(*_to_jax(jref, arrays, dtype), window=128, scale=0.125)
    out = swa_attention_plain(*_to_torch(arrays, dtype), window=128,
                              scale=0.125)
    assert out.dtype == dtype
    np.testing.assert_allclose(_np(out), _np(exp), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_plain_matches_pallas_gqa_groups(jref):
    """H=8 query heads share KV=2 heads by index arithmetic."""
    arrays = _qkv(1, 1, 8, 2, 256, 64)
    exp = jref.pallas(*_to_jax(jref, arrays), window=128, scale=0.125)
    out = swa_attention_plain(*_to_torch(arrays), window=128, scale=0.125)
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-5)


@pytest.mark.parametrize("window", [256, 512])
def test_plain_window_covering_the_sequence_is_causal(jref, window):
    """window // blk + 1 >= nq: every causal block is visited."""
    arrays = _qkv(3, 1, 1, 1, 256, 64)
    exp = jref.pallas(*_to_jax(jref, arrays), window=window, scale=0.125)
    out = swa_attention_plain(*_to_torch(arrays), window=window, scale=0.125)
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-5)
    causal = ref.swa_attention_ref(*_to_torch(arrays), window=256,
                                   scale=0.125)
    np.testing.assert_allclose(_np(out), _np(causal), atol=2e-5)


# ---------------------------------------------------------------------------
# oracles and the model-layout wrapper
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ref_matches_reference_oracle(jref, dtype):
    arrays = _qkv(4, 2, 4, 2, 256, 64)
    exp = jref.oracle(*_to_jax(jref, arrays, dtype), window=128, scale=0.125)
    out = ref.swa_attention_ref(*_to_torch(arrays, dtype), window=128,
                                scale=0.125)
    assert out.dtype == dtype
    np.testing.assert_allclose(_np(out), _np(exp), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_op_matches_model_zoo_swa(jref):
    """(B, S, H, D) layout; the model zoo's chunk + halo swa_attention and
    the reference's own op over the Pallas kernel."""
    rng = np.random.default_rng(2)
    B, S, H, KV, D, W = 1, 512, 4, 2, 64, 256
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]
    jq, jk, jv = _to_jax(jref, arrays)
    out = _np(swa_attention_op(*_to_torch(arrays), window=W, scale=0.125))
    for exp in (jref.model_swa(jq, jk, jv, window=W, scale=0.125),
                jref.op(jq, jk, jv, window=W, scale=0.125)):
        np.testing.assert_allclose(out, _np(exp), atol=3e-5, rtol=3e-5)


# ---------------------------------------------------------------------------
# the wrapper on CPU tensors
# ---------------------------------------------------------------------------
def test_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v = _to_torch(_qkv(5, 1, 4, 2, 384, 64))
    before = swa_attention.launches
    out = swa_attention(q, k, v, window=128, scale=0.125)
    assert swa_attention.launches == before
    torch.testing.assert_close(
        out, swa_attention_plain(q, k, v, window=128, scale=0.125),
        atol=0, rtol=0)
    np.testing.assert_allclose(
        out.numpy(), ref.swa_attention_ref(q, k, v, window=128,
                                           scale=0.125).numpy(), atol=2e-5)


def test_plain_small_pieces_match_one_piece():
    q, k, v = _to_torch(_qkv(6, 2, 4, 1, 512, 64))
    one = swa_attention_plain(q, k, v, window=256, scale=0.125)
    many = swa_attention_plain(q, k, v, window=256, scale=0.125,
                               chunk_bytes=1)
    np.testing.assert_allclose(many.numpy(), one.numpy(), atol=2e-6)


@pytest.mark.parametrize("bad,err", [
    ("S", ValueError), ("window", ValueError), ("heads", ValueError),
    ("dtype", TypeError)])
def test_wrapper_raises_like_the_reference_asserts(bad, err):
    S, W, H = 256, 128, 4
    if bad == "S":
        S = 320                                    # S % blk != 0
    elif bad == "window":
        W = 192                                    # window % blk != 0
    elif bad == "heads":
        H = 3                                      # H % KV != 0
    q, k, v = _to_torch(_qkv(7, 1, H, 2, S, 64))
    if bad == "dtype":
        q = q.double()
    for fn in (swa_attention, swa_attention_plain):
        with pytest.raises(err):
            fn(q, k, v, window=W, scale=0.125)


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
@pytest.mark.parametrize("S,window,D,G", [
    (256, 128, 64, 1), (384, 128, 128, 4), (512, 256, 128, 8),
    (256, 256, 64, 4), (1024, 256, 256, 2)])
def test_cuda_kernel_matches_plain(cuda, dtype, S, window, D, G):
    q, k, v = _to_torch(_qkv(S + D + G, 2, 2 * G, 2, S, D), dtype, cuda)
    before = swa_attention.launches
    out = swa_attention(q, k, v, window=window, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert swa_attention.launches == before + 1
    plain = swa_attention_plain(q, k, v, window=window, scale=D ** -0.5)
    torch.testing.assert_close(out, plain, atol=TOL[dtype], rtol=TOL[dtype])
    # the model layout: (B, S, H, D) views read in place
    t = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
    op = swa_attention_op(*t, window=window, scale=D ** -0.5)
    torch.testing.assert_close(op.transpose(1, 2), out, atol=0, rtol=0)
