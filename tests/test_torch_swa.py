"""Port sliding-window attention kernel module vs the reference Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) and the oracles.

Tolerances against the reference are those of tests/test_kernels.py:
float32 2e-5, bfloat16 2e-2 (both sides compute in float32 and round the
output once), and 3e-5 for the model-layout wrapper against the model
zoo's chunk + halo ``swa_attention``. The CUDA kernels are held against
their plain version on the card (marked ``cuda``) at ``chip_smoke.py``'s
gate, ``KERNEL_TOL``: float32 2e-5, bfloat16 one bf16 ulp (atol 1e-5, rtol
2**-7); each side rounds a float32 result once, and the two differ only
in sum order and, for the wgmma kernel, in its two-part bf16 P.
The wgmma kernel's arithmetic (bf16 products, P split in two bf16 parts,
its key tile at each head dim) is emulated on the CPU and held to the same
gate.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (ref, swa, swa_attention, swa_attention_fma,
                                 swa_attention_op, swa_attention_plain,
                                 swa_attention_wgmma)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
KERNEL_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-5, 2 ** -7)}
# keys a tile of the wgmma kernel at each head dim (csrc Smem<D>::BK)
WGMMA_BK = {64: 128, 128: 128, 256: 64}


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
@pytest.mark.parametrize("D", [64, 128, 256])
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


@pytest.mark.parametrize("S,window", [(256, 64), (384, 192), (320, 64)])
def test_plain_takes_a_window_that_divides_s(jref, S, window):
    """A window that is not a multiple of the kernels' 128-row tile runs on
    the CPU where it divides S, as the model zoo's swa_attention."""
    arrays = _qkv(S + window, 1, 4, 2, S, 64)
    out = swa_attention(*_to_torch(arrays), window=window, scale=0.125)
    t = [jref.jnp.asarray(a).transpose(0, 2, 1, 3) for a in arrays]
    exp = jref.model_swa(*t, window=window, scale=0.125).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("fn", [swa_attention_wgmma, swa_attention_fma])
def test_kernel_entries_raise_on_a_window_off_the_tile(fn):
    """On the card both kernels tile S by 128 rows: a window of 64 raises
    with that reason before any launch (checked here without a card: the
    tile check comes before the device check)."""
    q, k, v = _to_torch(_qkv(10, 1, 2, 1, 256, 64), torch.bfloat16)
    before = fn.launches
    with pytest.raises(ValueError, match="tile S by 128 rows"):
        fn(q, k, v, window=64, scale=0.125)
    assert fn.launches == before
    swa._check_tiles(256, 128)
    swa._check_tiles(384, 256)
    for S, window in ((256, 64), (320, 128), (384, 192)):
        with pytest.raises(ValueError, match="tile S by 128 rows"):
            swa._check_tiles(S, window)


# ---------------------------------------------------------------------------
# the wgmma kernel's numerics, emulated on the CPU
# ---------------------------------------------------------------------------
def _emulate_wgmma_kernel(q, k, v, *, window, scale, split=True, bq=128,
                          bk=128):
    """csrc/swa_attention_wgmma.cu's arithmetic in torch: per 128-row query
    tile, an online softmax over the ``bk``-key tiles that hold an in-band
    key (``WGMMA_BK``: 128 at D 64 and 128, 64 at D 256); q.k on the raw
    bf16 q and k (exact products, float32 sums), the
    scale folded with log2(e) into exp2 after the product; P split into
    hi = bf16(p) and lo = bf16(p - hi) (``split``; else rounded once) and
    p.v = hi V + lo V in float32; l summed from the float32 p; the output
    rounded once. As in the kernel's pipeline, o takes on tile j's factor
    after p.v of tile j - 1 has been added to it."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    c = scale * 1.4426950408889634
    qf, kf, vf = (t.float() for t in (q, k, v))
    out = torch.empty_like(q)
    for q0 in range(0, S, bq):
        rows = torch.arange(q0, q0 + bq)[:, None]
        m = torch.full((B, H, bq), -1e30)
        l = torch.zeros((B, H, bq))
        acc = torch.zeros((B, H, bq, D))
        pv = None                                  # p.v of the last tile
        for k0 in range(max(0, q0 - window + 1) // bk * bk, q0 + bq, bk):
            rel = rows - torch.arange(k0, k0 + bk)[None, :]
            valid = (rel >= 0) & (rel < window)
            kt, vt = (t[:, :, k0:k0 + bk].repeat_interleave(G, 1)
                      for t in (kf, vf))
            s = qf[:, :, q0:q0 + bq] @ kt.transpose(-1, -2)
            s = torch.where(valid, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2((m - m_new) * c)
            p = torch.where(valid, torch.exp2(s * c - (m_new * c)[..., None]),
                            0.0)
            l = l * alpha + p.sum(-1)
            if pv is not None:
                acc = (acc + pv) * alpha[..., None]
            hi = p.bfloat16().float()
            pv = hi @ vt
            if split:
                pv = pv + (p - hi).bfloat16().float() @ vt
            m = m_new
        out[:, :, q0:q0 + bq] = (
            (acc + pv) / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out


def _gate_failures(out, plain):
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    return int((~torch.isclose(out.float(), plain.float(), atol=atol,
                               rtol=rtol)).sum())


def _gate_case(S, window, D, G, seed, KV=2):
    """A case of the one-ulp gate: H = G * KV query heads; the id names KV
    only where it is not 2."""
    kv = "" if KV == 2 else f"-KV{KV}"
    return pytest.param(S, window, D, G, KV, seed,
                        id=f"{S}-{window}-{D}-{G}-{seed}{kv}")


@pytest.mark.parametrize("S,window,D,G,KV,seed", [
    _gate_case(512, 128, 64, 1, 0), _gate_case(512, 256, 128, 4, 1),
    _gate_case(1024, 256, 64, 4, 2), _gate_case(1024, 512, 128, 1, 3),
    _gate_case(2048, 512, 128, 4, 4), _gate_case(2048, 128, 64, 1, 5),
    # D 256 on 64-key tiles; G 8 with KV 1 is paligemma-3b's MQA
    _gate_case(256, 128, 256, 1, 6), _gate_case(512, 256, 256, 8, 7, KV=1),
    _gate_case(1024, 128, 256, 8, 8, KV=1), _gate_case(1024, 256, 256, 1, 9),
    _gate_case(768, 256, 256, 4, 10)])
def test_wgmma_numerics_meet_the_one_ulp_gate(S, window, D, G, KV, seed):
    """The design's arithmetic, on its key tile at this head dim, holds the
    plain version to one bf16 ulp."""
    q, k, v = _to_torch(_qkv(seed, 1, G * KV, KV, S, D), torch.bfloat16)
    emu = _emulate_wgmma_kernel(q, k, v, window=window, scale=D ** -0.5,
                                bk=WGMMA_BK[D])
    plain = swa_attention_plain(q, k, v, window=window, scale=D ** -0.5)
    assert emu.dtype == torch.bfloat16
    assert _gate_failures(emu, plain) == 0


def test_p_rounded_once_to_bf16_fails_the_gate():
    """Why the kernel splits P: one bf16 rounding of p misses the gate."""
    q, k, v = _to_torch(_qkv(0, 1, 8, 2, 2048, 128), torch.bfloat16)
    plain = swa_attention_plain(q, k, v, window=512, scale=128 ** -0.5)
    once = _emulate_wgmma_kernel(q, k, v, window=512, scale=128 ** -0.5,
                                 split=False)
    assert _gate_failures(once, plain) > 0.05 * plain.numel()


# ---------------------------------------------------------------------------
# routing between the two CUDA kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 256, "fma"),
    (torch.bfloat16, 32, None), (torch.float32, 96, None),
    (torch.float16, 128, None)])
def test_route_names_the_kernel_or_raises(dtype, D, route):
    if route is None:
        with pytest.raises(ValueError):
            swa._route(dtype, D)
    else:
        assert swa._route(dtype, D) == route


@pytest.mark.parametrize("fn,dtype,D", [
    (swa_attention_wgmma, torch.float32, 128),
    (swa_attention_wgmma, torch.bfloat16, 96),
    (swa_attention_fma, torch.bfloat16, 96)])
def test_kernel_entries_raise_on_what_their_kernel_does_not_take(fn, dtype,
                                                                 D):
    q, k, v = _to_torch(_qkv(8, 1, 2, 1, 256, D), dtype)
    with pytest.raises(ValueError, match="takes"):
        fn(q, k, v, window=128, scale=0.125)


@pytest.mark.parametrize("fn", [swa_attention_wgmma, swa_attention_fma])
def test_kernel_entries_raise_on_a_cpu_tensor(fn):
    q, k, v = _to_torch(_qkv(9, 1, 2, 1, 256, 64), torch.bfloat16)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(q, k, v, window=128, scale=0.125)
    assert fn.launches == before


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
@pytest.mark.parametrize("S,window,D,G,KV", [
    (256, 128, 64, 1, 2), (384, 128, 128, 4, 2), (512, 256, 128, 8, 2),
    (256, 256, 64, 4, 2), (1024, 256, 256, 2, 2), (128, 128, 128, 1, 2),
    (128, 128, 64, 8, 2), (512, 256, 64, 4, 2), (1024, 512, 128, 1, 2),
    # D 256 (wgmma on 64-key tiles in bf16); G 8 with KV 1 is paligemma's
    (128, 128, 256, 1, 2), (256, 128, 256, 8, 1), (512, 256, 256, 4, 2),
    (1024, 512, 256, 8, 1), (1024, 128, 256, 1, 1)])
def test_cuda_kernel_matches_plain(cuda, dtype, S, window, D, G, KV):
    """The routed kernel (wgmma for bf16, FMA for float32) at the one-ulp
    gate; a second call gives the same bits, and the model layout read in
    place gives the same output bit for bit."""
    q, k, v = _to_torch(_qkv(S + D + G, 2, G * KV, KV, S, D), dtype, cuda)
    kernel = swa._KERNELS[swa._route(dtype, D)]
    before = swa_attention.launches, kernel.launches
    out = swa_attention(q, k, v, window=window, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert (swa_attention.launches, kernel.launches) == (before[0] + 1,
                                                         before[1] + 1)
    plain = swa_attention_plain(q, k, v, window=window, scale=D ** -0.5)
    atol, rtol = KERNEL_TOL[dtype]
    torch.testing.assert_close(out, plain, atol=atol, rtol=rtol)
    assert torch.equal(out, swa_attention(q, k, v, window=window,
                                          scale=D ** -0.5))
    # the model layout: (B, S, H, D) views read in place
    t = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
    op = swa_attention_op(*t, window=window, scale=D ** -0.5)
    torch.testing.assert_close(op.transpose(1, 2), out, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("S,window,D,G", [
    (256, 128, 64, 1), (384, 128, 128, 4), (512, 256, 128, 8),
    (512, 256, 256, 4)])
def test_cuda_fma_kernel_matches_plain_in_bf16(cuda, S, window, D, G):
    """The FMA kernel on the bf16 inputs that the wgmma kernel takes on the
    paths (``chip_smoke.py`` times both on one input, at D 128 and 256)."""
    q, k, v = _to_torch(_qkv(S + G, 1, 2 * G, 2, S, D), torch.bfloat16, cuda)
    out = swa_attention_fma(q, k, v, window=window, scale=D ** -0.5)
    plain = swa_attention_plain(q, k, v, window=window, scale=D ** -0.5)
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    torch.testing.assert_close(out, plain, atol=atol, rtol=rtol)
    assert torch.equal(out, swa_attention_fma(q, k, v, window=window,
                                              scale=D ** -0.5))
