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

The backward: ``swa_attention_bwd_plain`` against autograd through
``swa_attention_plain`` (1e-5 of each gradient's largest element: the same
math in another order) and against ``jax.grad`` of the model zoo's
``swa_attention`` (2e-5 of the largest); the CUDA backward kernels (the
route ``_bwd_route`` names) against it on the card at ``chip_smoke.py``'s
gate, ``BWD_TOL``: float32 within 1e-4 of each gradient's largest element,
bfloat16 one ulp. The wgmma backward's arithmetic (bf16 products, P and dS
split in bf16 parts, its tiles and their order) is emulated on the CPU and
held to the same one-ulp gate.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401

from repro_torch.kernels import (ops, ref, swa, swa_attention,
                                 swa_attention_bwd, swa_attention_bwd_dkdv,
                                 swa_attention_bwd_dq,
                                 swa_attention_bwd_plain,
                                 swa_attention_bwd_stats,
                                 swa_attention_bwd_stats_plain,
                                 swa_attention_bwd_wgmma_dkdv,
                                 swa_attention_bwd_wgmma_dq,
                                 swa_attention_bwd_wgmma_stats,
                                 swa_attention_fma, swa_attention_op,
                                 swa_attention_plain, swa_attention_wgmma)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
KERNEL_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-5, 2 ** -7)}
BWD_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-5, 2 ** -7)}
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


# bf16 parts of each split A operand of the wgmma backward
# (csrc/swa_attention_bwd_wgmma.cu DKDV_PARTS, DQ_PARTS)
WGMMA_BWD_PARTS = {"p": 3, "dk": 3, "dq": 2}


def _emulate_wgmma_bwd(q, k, v, o, do, *, window, scale,
                       parts=WGMMA_BWD_PARTS):
    """csrc/swa_attention_bwd_wgmma.cu's arithmetic in torch: (dq, dk, dv)
    in q's dtype. stats: per 128-row query tile the forward's online max
    and sum over the 128-key tiles of the band (raw bf16 q.k, float32 sums,
    the scale folded with log2(e) into exp2 after the product), lse = m
    scale + log(max(l, 1e-30)), delta = sum do o in float32; dkdv: per
    128-key tile, the G query heads of its group in order and, for each,
    the 64-row query tiles whose band covers its keys in order: S^T and
    dP^T on the raw bf16 operands, p = exp2(s c - lse log2(e)) (0 off the
    band), ds = p (dp - delta), dv += P^T dO and dk += dS^T Q; dq: per
    128-row query tile the 64-key tiles of the band in order, dq += dS K.
    ``parts`` gives for each product (``"p"`` dv, ``"dk"``, ``"dq"``) the
    bf16 parts its A operand goes in as, each the rounding of what the ones
    before leave (hi = bf16(x), lo = bf16(x - hi), ...; one part is x
    rounded once); dk and dq take the scale at the end; each output is
    rounded once."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    c = scale * 1.4426950408889634
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))

    def product(x, y, name):
        out = 0.0
        for _ in range(parts[name]):
            part = x.bfloat16().float()
            out, x = out + part @ y, x - part
        return out

    def band(r0, nr, c0, nc):
        rel = (torch.arange(r0, r0 + nr)[:, None]
               - torch.arange(c0, c0 + nc)[None, :])
        return (rel >= 0) & (rel < window)

    lse = torch.empty(B, H, S)
    for q0 in range(0, S, 128):
        m = torch.full((B, H, 128), -1e30)
        l = torch.zeros((B, H, 128))
        for k0 in range(max(0, q0 - window + 1) // 128 * 128, q0 + 128, 128):
            valid = band(q0, 128, k0, 128)
            kt = kf[:, :, k0:k0 + 128].repeat_interleave(G, 1)
            s = torch.where(valid, qf[:, :, q0:q0 + 128] @ kt.transpose(-1, -2),
                            -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(valid, torch.exp2(s * c - (m_new * c)[..., None]),
                            0.0)
            l = l * torch.exp2((m - m_new) * c) + p.sum(-1)
            m = m_new
        lse[:, :, q0:q0 + 128] = m * scale + torch.log(l.clamp_min(1e-30))
    lse2 = lse * 1.4426950408889634
    delta = (dof * of).sum(-1)
    dk, dv = torch.empty(B, KV, S, D), torch.empty(B, KV, S, D)
    for k0 in range(0, S, 128):
        kt, vt = kf[:, :, k0:k0 + 128], vf[:, :, k0:k0 + 128]
        acc_k = torch.zeros(B, KV, 128, D)
        acc_v = torch.zeros(B, KV, 128, D)
        for g in range(G):
            heads = torch.arange(KV) * G + g
            for q0 in range(k0, min(S, k0 + 127 + window), 64):
                rows = slice(q0, q0 + 64)
                valid = band(q0, 64, k0, 128).T               # keys x rows
                qt, dot = qf[:, heads, rows], dof[:, heads, rows]
                p = torch.where(valid, torch.exp2(
                    kt @ qt.transpose(-1, -2) * c
                    - lse2[:, heads, None, rows]), 0.0)
                ds = p * (vt @ dot.transpose(-1, -2)
                          - delta[:, heads, None, rows])
                acc_v = acc_v + product(p, dot, "p")
                acc_k = acc_k + product(ds, qt, "dk")
        dk[:, :, k0:k0 + 128] = acc_k * scale
        dv[:, :, k0:k0 + 128] = acc_v
    dq = torch.empty(B, H, S, D)
    kr, vr = kf.repeat_interleave(G, 1), vf.repeat_interleave(G, 1)
    for q0 in range(0, S, 128):
        rows = slice(q0, q0 + 128)
        acc = torch.zeros(B, H, 128, D)
        for k0 in range(max(0, q0 - window + 1) // 64 * 64, q0 + 128, 64):
            kt, vt = kr[:, :, k0:k0 + 64], vr[:, :, k0:k0 + 64]
            p = torch.where(band(q0, 128, k0, 64), torch.exp2(
                qf[:, :, rows] @ kt.transpose(-1, -2) * c
                - lse2[:, :, rows, None]), 0.0)
            ds = p * (dof[:, :, rows] @ vt.transpose(-1, -2)
                      - delta[:, :, rows, None])
            acc = acc + product(ds, kt, "dq")
        dq[:, :, rows] = acc * scale
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


@pytest.mark.parametrize("S,window,D,G,KV,seed", [
    _gate_case(256, 128, 64, 1, 0), _gate_case(512, 128, 128, 4, 1),
    _gate_case(512, 256, 64, 4, 2), _gate_case(512, 256, 128, 1, 3),
    # a window that cuts the 64-row query tiles and the 64-key tiles
    _gate_case(384, 192, 128, 4, 4), _gate_case(384, 192, 64, 1, 5),
    _gate_case(256, 256, 128, 4, 6, KV=1), _gate_case(512, 128, 64, 4, 7,
                                                      KV=1)])
def test_wgmma_bwd_numerics_meet_the_one_ulp_gate(S, window, D, G, KV, seed):
    """The wgmma backward's arithmetic, on its tiles, holds each of dq, dk,
    dv of the plain backward to one bf16 ulp."""
    q, k, v, o, do = _bwd_inputs(seed, 1, G * KV, KV, S, D, window,
                                 torch.bfloat16)
    emu = _emulate_wgmma_bwd(q, k, v, o, do, window=window, scale=D ** -0.5)
    plain = swa_attention_bwd_plain(q, k, v, o, do, window=window,
                                    scale=D ** -0.5)
    for e, p in zip(emu, plain):
        assert e.dtype == torch.bfloat16
        assert _gate_failures(e, p) == 0


@pytest.mark.parametrize("once,grad", [("p", 2), ("dk", 1), ("dq", 0)])
def test_p_or_ds_rounded_once_to_bf16_fails_the_gate(once, grad):
    """Why the backward splits P (for dv) and dS (for dk and dq): one bf16
    rounding of either misses the gate on more than 5% of that gradient."""
    q, k, v, o, do = _bwd_inputs(8, 1, 8, 2, 512, 128, 256, torch.bfloat16)
    plain = swa_attention_bwd_plain(q, k, v, o, do, window=256,
                                    scale=128 ** -0.5)
    emu = _emulate_wgmma_bwd(q, k, v, o, do, window=256, scale=128 ** -0.5,
                             parts={**WGMMA_BWD_PARTS, once: 1})
    for i, (e, p) in enumerate(zip(emu, plain)):
        if i == grad:
            assert _gate_failures(e, p) > 0.05 * p.numel()
        else:
            assert _gate_failures(e, p) == 0


@pytest.mark.parametrize("name,grad,seed", [("p", 2, 52), ("dk", 1, 9)])
def test_two_parts_of_p_or_ds_for_dk_miss_the_gate_near_zero(name, grad,
                                                            seed):
    """Why P and dS go to dv and dk in three parts: two parts carry ~16
    bits, and a gradient of a key that the first rows see (p up to 1)
    summing to near 0 then misses the gate's 1e-5 floor. Found by drawing
    inputs; dq, a sum over a row's own keys, met the gate in two parts on
    every draw tried (60 seeds of five small shapes, and chip_smoke.py's
    24 bf16 edges under 16 seeds). The two draws miss it by 22% and 23%
    of the gate's bound; three parts keep them inside it."""
    S, window, D, G, KV = (512, 512, 128, 8, 1) if name == "p" else \
        (256, 128, 128, 8, 1)
    q, k, v, o, do = _bwd_inputs(seed, 1, G * KV, KV, S, D, window,
                                 torch.bfloat16)
    plain = swa_attention_bwd_plain(q, k, v, o, do, window=window,
                                    scale=D ** -0.5)
    two = _emulate_wgmma_bwd(q, k, v, o, do, window=window, scale=D ** -0.5,
                             parts={**WGMMA_BWD_PARTS, name: 2})
    assert _gate_failures(two[grad], plain[grad]) > 0
    three = _emulate_wgmma_bwd(q, k, v, o, do, window=window,
                               scale=D ** -0.5)
    assert _gate_failures(three[grad], plain[grad]) == 0


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


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 256, "fma"),
    (torch.bfloat16, 32, None), (torch.float32, 96, None),
    (torch.float16, 128, None)])
def test_bwd_route_names_the_kernel_or_raises(dtype, D, route):
    if route is None:
        with pytest.raises(ValueError, match="no SWA backward kernel"):
            swa._bwd_route(dtype, D)
    else:
        assert swa._bwd_route(dtype, D) == route
        assert len(swa._BWD_KERNELS[route]) == 3


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


# ---------------------------------------------------------------------------
# the backward: plain version, autograd Function, CUDA kernel
# ---------------------------------------------------------------------------
def _bwd_inputs(seed, B, H, KV, S, D, window, dtype=torch.float32,
                device="cpu"):
    """q, k, v, the plain forward's output o and a seeded gradient do."""
    q, k, v = _to_torch(_qkv(seed, B, H, KV, S, D), dtype, device)
    o = swa_attention_plain(q, k, v, window=window, scale=D ** -0.5)
    do = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=q.shape).astype(np.float32)).to(device=device, dtype=dtype)
    return q, k, v, o, do


def _close_to_largest(got, exp, share):
    for g, e in zip(got, exp):
        g, e = _np(g), _np(e)
        assert np.abs(g - e).max() <= share * np.abs(e).max()


@pytest.mark.parametrize("S,window,G,KV,D", [
    (256, 128, 4, 2, 64), (384, 128, 1, 2, 32), (512, 256, 8, 1, 64),
    (256, 256, 2, 1, 16), (200, 50, 2, 2, 16), (256, 300, 1, 1, 16)])
def test_bwd_plain_matches_autograd_through_plain(S, window, G, KV, D):
    """Band and halo tiles, GQA groups, a window that divides S off the
    128-row tile, a window covering S."""
    q, k, v, _, do = _bwd_inputs(S + window + G, 2, G * KV, KV, S, D,
                                 window)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = swa_attention_plain(*leaves, window=window, scale=D ** -0.5)
    o.backward(do)
    got = swa_attention_bwd_plain(q, k, v, o.detach(), do, window=window,
                                  scale=D ** -0.5)
    _close_to_largest(got, [t.grad for t in leaves], 1e-5)


def test_bwd_plain_matches_jax_grad_of_the_model_zoo_swa(jref):
    """The reference trains through ``jax.grad`` of the model zoo's chunk +
    halo ``swa_attention`` ((B, S, H, D) layout); the plain backward, fed
    the same inputs and cotangent, gives its gradients."""
    import jax
    B, S, H, KV, D, W = 1, 512, 4, 2, 64, 128
    q, k, v, o, do = _bwd_inputs(11, B, H, KV, S, D, W)
    t = lambda x: jref.jnp.asarray(_np(x).transpose(0, 2, 1, 3))  # noqa
    _, vjp = jax.vjp(lambda a, b, c: jref.model_swa(
        a, b, c, window=W, scale=D ** -0.5), t(q), t(k), t(v))
    exp = [np.asarray(g).transpose(0, 2, 1, 3) for g in vjp(t(do))]
    got = swa_attention_bwd_plain(q, k, v, o, do, window=W, scale=D ** -0.5)
    _close_to_largest(got, exp, 2e-5)


def test_bwd_plain_small_pieces_match_one_piece():
    """Pieces of 64 rows (G 2 x 64 x 191 float32 scores fit 100,000
    bytes): key blocks whose query rows overlap, and a pass of row
    statistics in 8 pieces, give the one-piece result."""
    q, k, v, o, do = _bwd_inputs(12, 2, 4, 2, 512, 32, 128)
    one = swa_attention_bwd_plain(q, k, v, o, do, window=128, scale=0.125)
    many = swa_attention_bwd_plain(q, k, v, o, do, window=128, scale=0.125,
                                   chunk_bytes=100_000)
    _close_to_largest(many, one, 1e-6)
    assert swa._piece(2, 128, 512, 100_000) == 64
    lse, delta = swa_attention_bwd_stats_plain(q, k, o, do, window=128,
                                               scale=0.125,
                                               chunk_bytes=100_000)
    s = (q.float() * 0.125) @ k.repeat_interleave(2, dim=1).transpose(2, 3)
    rel = torch.arange(512)[:, None] - torch.arange(512)[None, :]
    s = torch.where((rel >= 0) & (rel < 128), s, float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(delta.numpy(), (do * o).sum(-1).numpy(),
                               atol=1e-5)


def test_op_gradient_is_the_plain_backward_on_the_cpu():
    """``swa_attention_op`` (model layout) differentiates through its
    autograd Function; on the CPU the backward is the plain version, which
    counts no launch."""
    q, k, v, _, do = _bwd_inputs(13, 1, 4, 2, 256, 32, 128)
    leaves = [x.transpose(1, 2).contiguous().requires_grad_()
              for x in (q, k, v)]
    before = swa_attention_bwd_dq.launches
    o = swa_attention_op(*leaves, window=128, scale=32 ** -0.5)
    o.backward(do.transpose(1, 2))
    assert swa_attention_bwd_dq.launches == before
    exp = swa_attention_bwd_plain(q, k, v, o.detach().transpose(1, 2), do,
                                  window=128, scale=32 ** -0.5)
    for g, e in zip(leaves, exp):
        torch.testing.assert_close(g.grad.transpose(1, 2), e, atol=0, rtol=0)


@pytest.mark.parametrize("fn", [swa_attention_bwd_stats,
                                swa_attention_bwd_dkdv,
                                swa_attention_bwd_dq,
                                swa_attention_bwd_wgmma_stats,
                                swa_attention_bwd_wgmma_dkdv,
                                swa_attention_bwd_wgmma_dq])
def test_bwd_entries_raise_on_a_cpu_tensor(fn):
    dtype = (torch.bfloat16 if fn in swa._BWD_KERNELS["wgmma"]
             else torch.float32)
    q, k, v, o, do = _bwd_inputs(14, 1, 2, 1, 256, 64, 128, dtype)
    stats = () if fn in (swa_attention_bwd_stats,
                         swa_attention_bwd_wgmma_stats) else \
        swa_attention_bwd_stats_plain(q, k, o, do, window=128, scale=0.125)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(q, k, v, o, do, *stats, window=128, scale=0.125)
    with pytest.raises(ValueError, match="multiples of 128"):
        fn(q, k, v, o, do, *stats, window=64, scale=0.125)
    assert fn.launches == before


@pytest.mark.parametrize("fn", [swa_attention_bwd_wgmma_stats,
                                swa_attention_bwd_wgmma_dkdv,
                                swa_attention_bwd_wgmma_dq])
@pytest.mark.parametrize("dtype,D", [(torch.float32, 128),
                                     (torch.bfloat16, 256)])
def test_bwd_wgmma_entries_raise_on_what_they_do_not_take(fn, dtype, D):
    """The wgmma backward takes bf16 at D 64 and 128 only; it raises before
    any launch (the FMA backward is the route of the rest)."""
    q, k, v, o, do = _bwd_inputs(15, 1, 2, 1, 256, D, 128, dtype)
    stats = () if fn is swa_attention_bwd_wgmma_stats else \
        swa_attention_bwd_stats_plain(q, k, o, do, window=128, scale=0.125)
    with pytest.raises(ValueError, match="takes bf16 with D in"):
        fn(q, k, v, o, do, *stats, window=128, scale=0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,window,D,G,KV", [
    (256, 128, 64, 1, 2), (384, 128, 128, 4, 2), (512, 256, 128, 8, 1),
    (256, 256, 64, 4, 2), (1024, 896, 128, 1, 2), (512, 256, 256, 4, 2),
    (1024, 128, 256, 8, 1), (512, 384, 64, 8, 1)])
def test_cuda_bwd_kernel_matches_plain(cuda, dtype, S, window, D, G, KV):
    """The three launches of the routed backward (wgmma for bf16 at D 64
    and 128, FMA for float32 and bf16 at D 256) at ``BWD_TOL``, read in
    place from (B, S, H, D) views; two calls give the same bits; each entry
    of the route counts its launch, and the other route launches
    nothing."""
    q, k, v, o, do = (x.transpose(1, 2).contiguous().transpose(1, 2)
                      for x in _bwd_inputs(S + D + G, 2, G * KV, KV, S, D,
                                           window, dtype, cuda))
    route = swa._bwd_route(dtype, D)
    assert route == ("wgmma" if dtype == torch.bfloat16 and D < 256
                     else "fma")
    counters = swa._BWD_KERNELS[route]
    others = swa._BWD_KERNELS["fma" if route == "wgmma" else "wgmma"]
    before = [f.launches for f in counters + others]
    got = swa_attention_bwd(q, k, v, o, do, window=window, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert [f.launches for f in counters + others] == \
        [n + 1 for n in before[:3]] + before[3:]
    exp = swa_attention_bwd_plain(q, k, v, o, do, window=window,
                                  scale=D ** -0.5)
    atol, rtol = BWD_TOL[dtype]
    for g, e in zip(got, exp):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, e, rtol=rtol,
                                   atol=max(atol * float(e.float().abs().max()),
                                            1e-5 if rtol else 0.0))
    again = swa_attention_bwd(q, k, v, o, do, window=window, scale=D ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_gradient_flows_through_the_kernels(cuda, dtype):
    """Through ``swa_attention_op``'s Function the attention's weights get
    a gradient on the card (``wq.grad`` non-zero), from the backward kernel
    that ``_bwd_route`` names (wgmma in bf16, FMA in float32), equal to the plain route's (the plain forward and backward
    stood in for the kernels) within 1e-4 of its largest element in
    float32 and 2e-2 in bf16 (the two forwards round o differently)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import attention as tattn
    cfg = get_smoke("qwen3-4b").replace(
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        param_dtype=str(dtype)[6:], compute_dtype=str(dtype)[6:])
    rng = np.random.default_rng(21)
    shapes = {"wq": (256, 256), "wk": (256, 128), "wv": (256, 128),
              "wo": (256, 256), "q_norm": (64,), "k_norm": (64,)}
    p = {n: torch.from_numpy((rng.normal(size=s) / 16 + (len(s) == 1))
                             .astype(np.float32)).to(cuda, dtype)
         for n, s in shapes.items()}
    x = torch.from_numpy(rng.normal(size=(2, 512, 256)).astype(
        np.float32)).to(cuda, dtype)
    pos = torch.arange(512, device=cuda).expand(2, 512)
    dy = torch.from_numpy(rng.normal(size=(2, 512, 256)).astype(
        np.float32)).to(cuda, dtype)

    def grads():
        leaves = {n: t.clone().requires_grad_() for n, t in p.items()}
        tattn.attention_train(leaves, x, pos, cfg, window=128).backward(dy)
        return {n: t.grad for n, t in leaves.items()}

    route = "wgmma" if dtype == torch.bfloat16 else "fma"
    dq_fns = (swa_attention_bwd_wgmma_dq, swa_attention_bwd_dq)
    before = [f.launches for f in dq_fns]
    kern = grads()
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(dq_fns, before)] == \
        ([1, 0] if route == "wgmma" else [0, 1])
    assert float(kern["wq"].abs().max()) > 0
    from unittest import mock
    with mock.patch.object(ops, "swa_attention", swa_attention_plain), \
            mock.patch.object(ops, "swa_attention_bwd",
                              swa_attention_bwd_plain):
        plain = grads()
    share = 1e-4 if dtype == torch.float32 else 2e-2
    for n in p:
        e = plain[n].float()
        assert float((kern[n].float() - e).abs().max()) <= \
            share * float(e.abs().max()), n
