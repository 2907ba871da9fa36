"""The SSD chunk scan's backward in the port (``kernels/ssd.py``): the plain
backward, written as the kernel ``csrc/ssd_chunk_bwd.cu`` decomposes it
(bK1 the chunks' own state gradients, bK2 the reverse scan, bK3 the
per-chunk gradients), against ``torch.autograd`` of the plain forward and
against ``jax.grad`` of the model zoo's ``ssd_chunked``
(``src/repro/models/ssm.py:59``), the reference's training path; each
stage on its own; the autograd Function with the plain versions standing
in for the kernels; ``_bwd_route``; and, on a card (``cuda`` tests), the
kernel against the plain backward and a mamba2 mixer's gradient through
it.

Inputs are numpy draws from a seed, with the distributions of
tests/test_torch_ssm.py (``slow`` makes the state carried across chunks
count). Tolerances: float32 gradients within 1e-5 of each one's largest
element (the same math in another order); on the card float32 within
1e-4 of the largest plain element, and bf16 outputs within one bf16 ulp of
the plain float32 backward rounded once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401

from repro_torch.kernels import (ssd, ssd_chunk_bwd_dstate,
                                 ssd_chunk_bwd_dstate_plain,
                                 ssd_chunk_bwd_grads,
                                 ssd_chunk_bwd_grads_plain,
                                 ssd_chunk_bwd_scan, ssd_chunk_bwd_scan_plain,
                                 ssd_chunked_bwd, ssd_chunked_bwd_plain,
                                 ssd_chunked_fwd_plain, ssd_chunked_plain)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHARE = 1e-5
BF16_ULP = {"atol": 1e-5, "rtol": 2 ** -7}
NAMES = ("dx", "ddts", "dda", "dB", "dC", "dD", "dinit")


def _inputs(seed, b, L, H, P, N, *, slow=False, init=False, dstate=False,
            dtype=torch.float32, device="cpu"):
    """(x, dt, B, C, A_log, D, init_state, dy, dstate) from numpy; None for
    the initial state and the final state's gradient unless asked."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(                          # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(device)
    x, dt = f(b, L, H, P), f(b, L, H) * 0.5 - 4 * slow
    B, C = f(b, L, N) * N ** -0.5, f(b, L, N) * N ** -0.5
    A_log, D = f(H) * 0.3 - 3 * slow, f(H) * 0.1 + 1
    s0 = f(b, H, P, N) if init else None
    dy = f(b, L, H, P)
    dS = f(b, H, P, N) if dstate else None
    return (x.to(dtype), dt, B.to(dtype), C.to(dtype), A_log, D, s0,
            dy.to(dtype), dS)


def _close(got, exp, share=SHARE, label=""):
    got, exp = got.float(), exp.float()
    assert torch.isfinite(got).all(), label
    err = float((got - exp).abs().max())
    assert err <= share * float(exp.abs().max()) + 1e-30, \
        (label, err, float(exp.abs().max()))


def _autograd(x, dts, da, B, C, D, s0, dy, dS, Q):
    """Gradients of <y, dy> + <final state, dS> through the plain forward
    stages, w.r.t. x, dts, da, B, C, D and init_state."""
    leaves = [t.clone().requires_grad_() for t in (x, dts, da, B, C, D)]
    init = None if s0 is None else s0.clone().requires_grad_()
    y, s_out, _, _ = ssd_chunked_fwd_plain(*leaves, chunk=Q, init_state=init)
    loss = (y.float() * dy.float()).sum()
    if dS is not None:
        loss = loss + (s_out * dS).sum()
    wrt = leaves + ([init] if init is not None else [])
    return torch.autograd.grad(loss, wrt)


CASES = [  # b, L, H, P, N, Q, slow, init, dstate
    (2, 64, 1, 16, 8, 64, False, False, False),      # L = Q, H 1
    (2, 256, 3, 16, 16, 64, True, True, True),       # L = 4Q
    (1, 128, 3, 64, 8, 32, True, False, True),
    (2, 192, 2, 8, 16, 64, False, True, False),
    (1, 96, 2, 16, 8, 128, True, True, True),        # L < chunk: Q = L
]
CASE_IDS = ["L=Q", "L=4Q-slow-init-dstate", "dstate", "init", "L<chunk"]


@pytest.mark.parametrize("b,L,H,P,N,Q,slow,init,dstate", CASES, ids=CASE_IDS)
def test_bwd_plain_matches_autograd_through_plain(b, L, H, P, N, Q, slow,
                                                  init, dstate):
    """Every input's gradient, init_state's too, with a zero and a
    non-zero final-state gradient."""
    x, dt, B, C, A_log, D, s0, dy, dS = _inputs(
        L + H + N, b, L, H, P, N, slow=slow, init=init, dstate=dstate)
    dts, da = ssd._discretize(dt, A_log)
    exp = _autograd(x, dts, da, B, C, D, s0, dy, dS, min(Q, L))
    got = ssd_chunked_bwd_plain(x, dts, da, B, C, D, dy, dS, chunk=Q,
                                init_state=s0)
    for name, g, e in zip(NAMES, got, exp):
        _close(g, e, label=name)
    if s0 is None:
        assert got[6].shape == (b, H, P, N)


def test_bwd_plain_matches_jax_grad_of_the_model_zoo_ssd():
    """The reference trains through ``jax.grad`` of the model zoo's
    ``ssd_chunked``; the plain backward, carried from dts and da to dt and
    A_log by autograd (``_discretize``), gives its gradients of every
    input, with an initial state and a final-state gradient."""
    jax = pytest.importorskip("jax")
    from repro.models import ssm as rssm
    b, L, H, P, N, Q = 2, 256, 3, 16, 16, 64
    x, dt, B, C, A_log, D, s0, dy, dS = _inputs(
        5, b, L, H, P, N, slow=True, init=True, dstate=True)
    j = lambda t: jax.numpy.asarray(t.numpy())                # noqa: E731

    def loss(*a):
        y, s = rssm.ssd_chunked(*a[:6], chunk=Q, init_state=a[6])
        return (y * j(dy)).sum() + (s * j(dS)).sum()
    exp = jax.grad(loss, argnums=tuple(range(7)))(
        *(j(t) for t in (x, dt, B, C, A_log, D, s0)))
    dt_l, a_l = dt.clone().requires_grad_(), A_log.clone().requires_grad_()
    dts, da = ssd._discretize(dt_l, a_l)
    dx, ddts, dda, dB, dC, dD, dinit = ssd_chunked_bwd_plain(
        x, dts.detach(), da.detach(), B, C, D, dy, dS, chunk=Q,
        init_state=s0)
    torch.autograd.backward([dts, da], [ddts, dda])
    got = (dx, dt_l.grad, dB, dC, a_l.grad, dD, dinit)
    for name, g, e in zip(("dx", "ddt", "dB", "dC", "dA_log", "dD", "dinit"),
                          got, exp):
        _close(g, torch.from_numpy(np.array(e)), label=name)


@pytest.mark.parametrize("slow", [False, True])
def test_scan_stages_give_each_chunks_state_gradient(slow):
    """bK1 then bK2: g_c, the gradient of the state leaving chunk c, is the
    gradient of init_state of the scan restarted at chunk c + 1 from that
    state; the last chunk's is the final state's gradient, and the
    gradient of init_state the whole scan's."""
    b, L, H, P, N, Q = 2, 256, 2, 16, 8, 64
    x, dt, B, C, A_log, D, s0, dy, dS = _inputs(
        7 + slow, b, L, H, P, N, slow=slow, init=True, dstate=True)
    dts, da = ssd._discretize(dt, A_log)
    la, ds = ssd.ssd_chunk_state_plain(x, dts, da, B, chunk=Q)
    s_in, _ = ssd.ssd_state_scan_plain(la, ds, chunk=Q, init_state=s0)
    R = ssd_chunk_bwd_dstate_plain(dy, C, la, chunk=Q)
    g, dinit, dle = ssd_chunk_bwd_scan_plain(la, R, s_in, chunk=Q,
                                             dstate=dS)
    nc = L // Q
    torch.testing.assert_close(g[:, nc - 1], dS, rtol=0, atol=0)
    for c in range(-1, nc - 1):
        rows = slice((c + 1) * Q, None)
        start = (s0 if c < 0 else s_in[:, c + 1]).clone().requires_grad_()
        y, s = ssd_chunked_plain(x[:, rows], dt[:, rows], B[:, rows],
                                 C[:, rows], A_log, D, chunk=Q,
                                 init_state=start)
        (grad,) = torch.autograd.grad((y * dy[:, rows]).sum()
                                      + (s * dS).sum(), start)
        _close(dinit if c < 0 else g[:, c], grad, label=f"chunk {c}")
    la_end = la.reshape(b, nc, Q, H)[:, :, -1]
    torch.testing.assert_close(dle, torch.exp(la_end) * (
        g * s_in).sum((-2, -1)), rtol=1e-6, atol=1e-12)


def test_chunk_stage_gives_each_chunks_gradients():
    """bK3: chunk by chunk, its dx, d dts, d da, dB and dC rows (and dD over
    all chunks) are autograd's of that chunk alone (y and the state it
    leaves, from the state entering it), with cotangents dy and g_c."""
    b, L, H, P, N, Q = 2, 192, 3, 16, 8, 64
    x, dt, B, C, A_log, D, s0, dy, dS = _inputs(
        9, b, L, H, P, N, slow=True, init=True, dstate=True)
    dts, da = ssd._discretize(dt, A_log)
    la, ds = ssd.ssd_chunk_state_plain(x, dts, da, B, chunk=Q)
    s_in, _ = ssd.ssd_state_scan_plain(la, ds, chunk=Q, init_state=s0)
    g, _, dle = ssd_chunk_bwd_scan_plain(
        la, ssd_chunk_bwd_dstate_plain(dy, C, la, chunk=Q), s_in, chunk=Q,
        dstate=dS)
    got = ssd_chunk_bwd_grads_plain(x, dts, la, B, C, D, dy, s_in, g, dle,
                                    chunk=Q)
    dD = torch.zeros_like(D)
    for c in range(L // Q):
        rows = slice(c * Q, (c + 1) * Q)
        exp = _autograd(x[:, rows], dts[:, rows], da[:, rows], B[:, rows],
                        C[:, rows], D, s_in[:, c], dy[:, rows], g[:, c], Q)
        for name, gt, e in zip(NAMES[:5], got[:5], exp[:5]):
            _close(gt[:, rows], e, label=f"{name} chunk {c}")
        dD += exp[5]
    _close(got[5], dD, label="dD")


def test_function_with_the_plain_versions_standing_in(monkeypatch):
    """``_SsdChunked`` looks its forward and backward up when called: with
    the plain forward stood in for the kernels (the backward takes its
    plain stages on a CPU tensor), its gradients of x, dt, B, C, A_log, D
    and init_state are autograd's through ``ssd_chunked_plain``, and no
    kernel launch is counted."""
    monkeypatch.setattr(ssd, "ssd_chunked_fwd", ssd_chunked_fwd_plain)
    b, L, H, P, N, Q = 2, 256, 2, 16, 16, 64
    x, dt, B, C, A_log, D, s0, dy, dS = _inputs(
        11, b, L, H, P, N, slow=True, init=True, dstate=True)
    counters = (ssd_chunked_bwd,) + ssd._BWD_KERNELS["fma"]
    before = [f.launches for f in counters]

    def grads(run):
        leaves = [t.clone().requires_grad_() for t in
                  (x, dt, B, C, A_log, D, s0)]
        y, s = run(*leaves)
        ((y * dy).sum() + (s * dS).sum()).backward()
        return [t.grad for t in leaves]

    def through_function(x_, dt_, B_, C_, A_, D_, s0_):
        dts, da = ssd._discretize(dt_, A_)
        return ssd._SsdChunked.apply(Q, x_, dts, da, B_, C_, D_, s0_)
    got = grads(through_function)
    exp = grads(lambda *a: ssd_chunked_plain(*a[:6], chunk=Q,
                                             init_state=a[6]))
    for name, gt, e in zip(("dx", "ddt", "dB", "dC", "dA_log", "dD",
                            "dinit"), got, exp):
        _close(gt, e, label=name)
    assert [f.launches for f in counters] == before


def test_function_without_a_final_state_gradient(monkeypatch):
    """The final state unused (as ``mamba_block`` drops it): its gradient
    reaches the backward as zeros."""
    monkeypatch.setattr(ssd, "ssd_chunked_fwd", ssd_chunked_fwd_plain)
    x, dt, B, C, A_log, D, _, dy, _ = _inputs(12, 1, 128, 2, 16, 8)
    leaves = [t.clone().requires_grad_() for t in (x, dt, B, C)]
    dts, da = ssd._discretize(leaves[1], A_log)
    y, _ = ssd._SsdChunked.apply(64, leaves[0], dts, da, leaves[2],
                                 leaves[3], D, None)
    (y * dy).sum().backward()
    exp = [t.clone().requires_grad_() for t in (x, dt, B, C)]
    y2, _ = ssd_chunked_plain(*exp, A_log, D, chunk=64)
    (y2 * dy).sum().backward()
    for gt, e in zip(leaves, exp):
        _close(gt.grad, e.grad)


@pytest.mark.parametrize("dtype,P,N,Q,route", [
    (torch.bfloat16, 64, 128, 256, "tc"), (torch.float32, 64, 64, 64, "fma"),
    (torch.bfloat16, 64, 64, 128, "tc"), (torch.float32, 64, 128, 256, "fma"),
    (torch.bfloat16, 64, 64, 192, "tc"), (torch.bfloat16, 32, 128, 256, None),
    (torch.float32, 64, 96, 256, None), (torch.bfloat16, 64, 128, 96, None),
    (torch.bfloat16, 64, 128, 320, None), (torch.float16, 64, 128, 256, None)])
def test_bwd_route_names_the_kernel_or_raises(dtype, P, N, Q, route):
    """P 64, N 64 or 128, Q a multiple of 64 up to 256 (mamba2-780m's and
    zamba2-7b's mixers): bf16 on the tensor-core route, float32 on the FMA
    one; anything else raises with its reason."""
    if route is None:
        with pytest.raises(ValueError, match="no SSD backward kernel"):
            ssd._bwd_route(dtype, P, N, Q)
    else:
        assert ssd._bwd_route(dtype, P, N, Q) == route
        assert ssd._BWD_KERNELS[route][0] is ssd_chunk_bwd_dstate


def test_bwd_entries_raise_on_a_cpu_tensor():
    """Each launch of the backward kernel raises on a CPU tensor (the
    wrapper takes the plain stages there), counting no launch."""
    b, L, H, P, N, Q = 1, 128, 2, 64, 64, 64
    x, dt, B, C, A_log, D, _, dy, _ = _inputs(14, b, L, H, P, N)
    dts, da = ssd._discretize(dt, A_log)
    la, ds = ssd.ssd_chunk_state_plain(x, dts, da, B, chunk=Q)
    s_in, _ = ssd.ssd_state_scan_plain(la, ds, chunk=Q)
    R = ssd_chunk_bwd_dstate_plain(dy, C, la, chunk=Q)
    g, _, dle = ssd_chunk_bwd_scan_plain(la, R.clone(), s_in, chunk=Q)
    calls = [lambda: ssd_chunk_bwd_dstate(dy, C, la, chunk=Q),
             lambda: ssd_chunk_bwd_scan(la, R, s_in, chunk=Q),
             lambda: ssd_chunk_bwd_grads(x, dts, la, B, C, D, dy, s_in, g,
                                         dle, chunk=Q)]
    fns = ssd._BWD_KERNELS["fma"]
    for fn, call in zip(fns, calls):
        before = fn.launches
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
        assert fn.launches == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _hold(got, exp):
    """float32 within 1e-4 of the largest plain element; bf16 one ulp of
    the plain float32 backward rounded once."""
    for name, g, e in zip(NAMES, got, exp):
        assert torch.isfinite(g).all(), name
        if g.dtype == torch.bfloat16:
            torch.testing.assert_close(g, e.to(torch.bfloat16), **BF16_ULP)
        else:
            _close(g, e, 1e-4, name)


ROUTES = [(torch.float32, "fma"), (torch.bfloat16, "fma"),
          (torch.bfloat16, "tc")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", ROUTES,
                         ids=["fp32-fma", "bf16-fma", "bf16-tc"])
@pytest.mark.parametrize("b,L,H,N,Q,slow,init,dstate", [
    (2, 64, 1, 64, 64, False, False, False), (2, 256, 3, 128, 64, True,
                                              True, True),
    (1, 1024, 3, 128, 256, False, True, False), (2, 256, 1, 64, 256, True,
                                                 False, True)])
def test_cuda_bwd_kernel_matches_plain(cuda, dtype, route, b, L, H, N, Q,
                                       slow, init, dstate):
    """Each route's launches on strided x/B/C views as ``mamba_block``
    passes them, from the routed forward's own la and entering states,
    against the plain backward; two calls give the same bits; each launch
    counts once. The route that ``_bwd_route`` names is the one
    ``ssd_chunked_bwd`` takes (the FMA route also takes bf16: it is the
    comparison on the tensor-core route's input)."""
    x, dt, B, C, A_log, D, s0, dy, dS = _inputs(
        L + H + N, b, L, H, 64, N, slow=slow, init=init, dstate=dstate,
        device=cuda)
    packed = torch.cat([x.reshape(b, L, H * 64), B, C], -1).to(dtype)
    x = packed[..., :H * 64].reshape(b, L, H, 64)
    B, C = packed[..., H * 64:H * 64 + N], packed[..., H * 64 + N:]
    dy = dy.to(dtype)
    dts, da = ssd._discretize(dt, A_log)
    _, _, la, s_in = ssd.ssd_chunked_fwd(x, dts, da, B, C, D, chunk=Q,
                                         init_state=s0)
    fns = ssd._BWD_KERNELS[route]
    before = [f.launches for f in fns]
    if route == ssd._bwd_route(dtype, 64, N, Q):
        run = lambda: ssd_chunked_bwd(x, dts, la, B, C, D, s_in, dy,  # noqa
                                      dS, chunk=Q)
    else:
        run = lambda: ssd.bwd_run(route, x, dts, la, B, C, D, s_in, dy,  # noqa
                                  dS, chunk=Q)
    got = run()
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, before)] == [1] * len(fns)
    exp = ssd_chunked_bwd_plain(x, dts, da, B, C, D, dy, dS, chunk=Q,
                                init_state=s0)
    _hold(got, exp)
    again = run()
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mixer_gradient_flows_through_the_kernels(cuda, dtype):
    """A mamba2 mixer under grad on the card: ``ssd_chunked`` runs its
    routed forward and the routed backward (one call of each of its
    launches: the tensor-core route in bf16, FMA in float32); the
    gradients of the mixer's weights equal the plain
    route's within 1e-4 of each leaf's largest in float32 and 2e-2 in
    bf16 (the two forwards round y differently)."""
    from unittest import mock
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_params
    from repro_torch.models import ssm as tssm
    cfg = get_smoke("mamba2-780m").replace(
        d_model=256, ssm_heads=4, ssm_head_dim=64, ssm_state=64,
        ssm_chunk=64, param_dtype=str(dtype)[6:],
        compute_dtype=str(dtype)[6:])
    p = init_params(tssm.ssm_decls(cfg),
                    torch.Generator(device=cuda).manual_seed(0), cuda, dtype)
    x = torch.randn((2, 256, 256), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda, dtype=dtype)

    def grads():
        leaves = {n: t.clone().requires_grad_() for n, t in p.items()}
        tssm.mamba_block(leaves, x, cfg).float().pow(2).sum().backward()
        return {n: t.grad for n, t in leaves.items()}
    last = ssd._BWD_KERNELS[ssd._bwd_route(dtype, 64, 64, 64)][-1]
    before = last.launches
    kern = grads()
    torch.cuda.synchronize()
    assert last.launches == before + 1
    with mock.patch.object(ssd, "ssd_chunked_fwd", ssd_chunked_fwd_plain), \
            mock.patch.object(ssd, "ssd_chunked_bwd",
                              ssd.ssd_chunked_bwd_stages_plain):
        plain = grads()
    share = 1e-4 if dtype == torch.float32 else 2e-2
    for n in kern:
        _close(kern[n], plain[n], share, n)
    assert float(kern["A_log"].abs().max()) > 0
