"""The tensor-core route of the SSD chunk scan's backward
(``csrc/ssd_chunk_bwd_tc.cu``) in plain PyTorch, on the CPU: each of its
launches' plain versions (the scan with <g, S> in slices, dGs summed over
heads, dB and dC from dGs with the row sums qc and xg, the head stage) and
the five composed (after the shared bK1), against the FMA route's plain
stages (``ssd_chunk_bwd_grads_plain``), against ``torch.autograd`` of the
plain forward and against ``jax.grad`` of the model zoo's ``ssd_chunked``
(``src/repro/models/ssm.py:59``); the kernel's arithmetic (bf16 operands
as they are, float32 operands in three bf16 parts, sums over heads in
float32) emulated and held at one bf16 ulp; and each launch's wrapper
raising on a CPU tensor.

Inputs are numpy draws from a seed (``test_torch_ssd_bwd._inputs``).
Tolerances: float32 results within 1e-5 of each one's largest element (the
same math in another order); the emulation's bf16 dB and dC within one
bf16 ulp of the plain float32 backward rounded once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_ssd_bwd import (BF16_ULP, CASE_IDS, CASES, NAMES, SHARE,
                                _autograd, _close, _inputs)
from torch_threads import one_torch_thread  # noqa: F401

from repro_torch.kernels import (ssd, ssd_chunk_bwd_dstate_plain,
                                 ssd_chunk_bwd_grads_plain,
                                 ssd_chunk_bwd_scan_plain,
                                 ssd_chunk_bwd_tc_dbdc,
                                 ssd_chunk_bwd_tc_dbdc_plain,
                                 ssd_chunk_bwd_tc_dgs,
                                 ssd_chunk_bwd_tc_dgs_plain,
                                 ssd_chunk_bwd_tc_head,
                                 ssd_chunk_bwd_tc_head_plain,
                                 ssd_chunk_bwd_tc_scan,
                                 ssd_chunk_bwd_tc_scan_plain,
                                 ssd_chunked_bwd_plain)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _stages(seed, b, L, H, P, N, Q, *, slow=True, dtype=torch.float32):
    """Inputs, the plain forward's la and entering states, bK1's R and the
    FMA route's g and dle."""
    x, dt, B, C, A_log, D, s0, dy, dS = _inputs(
        seed, b, L, H, P, N, slow=slow, init=True, dstate=True, dtype=dtype)
    dts, da = ssd._discretize(dt, A_log)
    la, ds = ssd.ssd_chunk_state_plain(x, dts, da, B, chunk=Q)
    s_in, _ = ssd.ssd_state_scan_plain(la, ds, chunk=Q, init_state=s0)
    R = ssd_chunk_bwd_dstate_plain(dy, C, la, chunk=Q)
    g, dinit, dle = ssd_chunk_bwd_scan_plain(la, R, s_in, chunk=Q, dstate=dS)
    return dict(x=x, dts=dts, da=da, la=la, B=B, C=C, D=D, dy=dy, s0=s0,
                dS=dS, s_in=s_in, R=R, g=g, dinit=dinit, dle=dle)


@pytest.mark.parametrize("b,L,H,P,N,Q,slow,init,dstate", CASES, ids=CASE_IDS)
def test_tc_route_plain_matches_autograd_and_the_fma_route(b, L, H, P, N, Q,
                                                           slow, init,
                                                           dstate):
    """The tensor-core route's plain stages composed give every input's
    gradient, init_state's too: autograd's through the plain forward, and
    the FMA route's plain backward."""
    x, dt, B, C, A_log, D, s0, dy, dS = _inputs(
        L + H + N, b, L, H, P, N, slow=slow, init=init, dstate=dstate)
    dts, da = ssd._discretize(dt, A_log)
    exp = _autograd(x, dts, da, B, C, D, s0, dy, dS, min(Q, L))
    got = ssd_chunked_bwd_plain(x, dts, da, B, C, D, dy, dS, chunk=Q,
                                init_state=s0, route="tc")
    fma = ssd_chunked_bwd_plain(x, dts, da, B, C, D, dy, dS, chunk=Q,
                                init_state=s0)
    for name, g, e, f in zip(NAMES, got, exp, fma):
        _close(g, e, label=name)
        _close(g, f, label=f"{name} vs fma")


def test_tc_route_plain_matches_jax_grad_of_the_model_zoo_ssd():
    """``jax.grad`` of the model zoo's ``ssd_chunked`` (the reference's
    training path): the tensor-core route's plain backward, carried from
    dts and da to dt and A_log by autograd, gives its gradients of every
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
        init_state=s0, route="tc")
    torch.autograd.backward([dts, da], [ddts, dda])
    got = (dx, dt_l.grad, dB, dC, a_l.grad, dD, dinit)
    for name, g, e in zip(("dx", "ddt", "dB", "dC", "dA_log", "dD", "dinit"),
                          got, exp):
        _close(g, torch.from_numpy(np.array(e)), label=name)


@pytest.mark.parametrize("P,N", [(16, 16), (64, 128), (64, 64)])
def test_tc_scan_slices_sum_to_the_state_decay_share(P, N):
    """The scan's g and init_state's gradient are bK2's; its slices of
    <g, S> (BWD_SLICE entries each) add up, times exp(la_end), to bK2's
    dle; each slice is its own entries' sum."""
    b, L, H, Q = 1, 256, 2, 64
    st = _stages(21 + N, b, L, H, P, N, Q)
    g, dinit, dlep = ssd_chunk_bwd_tc_scan_plain(
        st["la"], st["R"], st["s_in"], chunk=Q, dstate=st["dS"])
    torch.testing.assert_close(g, st["g"], rtol=0, atol=0)
    torch.testing.assert_close(dinit, st["dinit"], rtol=0, atol=0)
    nslice = -(-P * N // ssd.BWD_SLICE)
    assert dlep.shape == (b, L // Q, H, nslice)
    la_end = st["la"].reshape(b, L // Q, Q, H)[:, :, -1]
    _close(torch.exp(la_end) * dlep.sum(-1), st["dle"], label="dle")
    flat = (g * st["s_in"]).reshape(b, L // Q, H, P * N)
    last = flat[..., (nslice - 1) * ssd.BWD_SLICE:].sum(-1)
    _close(dlep[..., -1], last, label="last slice")


def test_tc_dgs_is_the_head_sum_of_each_heads_gradient():
    """dGs is, per chunk, the sum over heads of dW M dts, zero above the
    diagonal: each head's own term taken alone and added in head order."""
    b, L, H, P, N, Q = 2, 128, 3, 16, 8, 64
    st = _stages(31, b, L, H, P, N, Q)
    dgs = ssd_chunk_bwd_tc_dgs_plain(st["x"], st["dts"], st["la"], st["dy"],
                                     chunk=Q)
    assert dgs.shape == (b, L // Q, Q, Q)
    upper = torch.ones((Q, Q), dtype=torch.bool).triu(1)
    assert float(dgs[..., upper].abs().max()) == 0.0
    exp = torch.zeros_like(dgs)
    for h in range(H):
        one = ssd_chunk_bwd_tc_dgs_plain(
            st["x"][:, :, h:h + 1], st["dts"][..., h:h + 1],
            st["la"][..., h:h + 1], st["dy"][:, :, h:h + 1], chunk=Q)
        exp += one
    _close(dgs, exp, label="dGs")


@pytest.mark.parametrize("N", [8, 128])
def test_tc_dbdc_and_head_give_the_fma_routes_gradients(N):
    """From the same g: dbdc's dB and dC, and the head stage's dx, d dts,
    d da and dD are ``ssd_chunk_bwd_grads_plain``'s; qc's boxes add up to
    dy.(C S^T) and xg's to x.(g B), each box its own BWD_BOX columns."""
    b, L, H, P, Q = 2, 192, 3, 16, 64
    st = _stages(41 + N, b, L, H, P, N, Q)
    args = (st["x"], st["dts"], st["la"], st["B"], st["C"], st["D"],
            st["dy"], st["s_in"], st["g"], st["dle"])
    exp = ssd_chunk_bwd_grads_plain(*args, chunk=Q)
    dgs = ssd_chunk_bwd_tc_dgs_plain(st["x"], st["dts"], st["la"], st["dy"],
                                     chunk=Q)
    dB, dC, qc, xg = ssd_chunk_bwd_tc_dbdc_plain(
        st["x"], st["dts"], st["la"], st["B"], st["C"], st["dy"],
        st["s_in"], st["g"], dgs, chunk=Q)
    _, _, dlep = ssd_chunk_bwd_tc_scan_plain(st["la"], st["R"], st["s_in"],
                                             chunk=Q, dstate=st["dS"])
    dx, ddts, dda, dDp = ssd_chunk_bwd_tc_head_plain(
        st["x"], st["dts"], st["la"], st["B"], st["C"], st["D"], st["dy"],
        st["g"], dlep, qc, xg, chunk=Q)
    for name, g, e in zip(("dx", "ddts", "dda", "dB", "dC", "dD"),
                          (dx, ddts, dda, dB, dC, dDp.sum((0, 1))), exp):
        _close(g, e, label=name)
    nbox = -(-N // ssd.BWD_BOX)
    assert qc.shape == xg.shape == (nbox, b, L, H)
    S = st["s_in"].repeat_interleave(Q, 1)                    # (b, L, H, P, N)
    G = st["g"].repeat_interleave(Q, 1)
    CS = torch.einsum("bln,blhpn->blhp", st["C"], S)
    gB = torch.einsum("bln,blhpn->blhp", st["B"], G)
    _close(qc.sum(0), (st["dy"] * CS).sum(-1), label="qc")
    _close(xg.sum(0), (st["x"] * gB).sum(-1), label="xg")
    cols = slice(0, min(N, ssd.BWD_BOX))
    box0 = torch.einsum("bln,blhpn->blhp", st["C"][..., cols], S[..., cols])
    _close(qc[0], (st["dy"] * box0).sum(-1), label="qc box 0")


def _parts(v, n=3):
    """v as n bf16 parts, each the rounding of what the ones before leave
    (the kernel's split), returned as float32."""
    out, r = [], v.float()
    for _ in range(n):
        h = r.to(torch.bfloat16).float()
        out.append(h)
        r = r - h
    return out


@pytest.mark.parametrize("slow", [False, True])
def test_tc_dbdc_arithmetic_meets_the_one_ulp_gate(slow):
    """dbdc's arithmetic emulated on bf16 inputs (at mamba2-780m's P 64,
    chunk 64, N 128): dGs, S_c and g_c in three bf16 parts against the
    bf16 inputs as they are, each part's product in float32, the per-head
    products scaled and summed over heads in float32, one rounding; dB
    and dC within one bf16 ulp of the plain float32 backward rounded
    once."""
    b, L, H, P, N, Q = 1, 128, 4, 64, 128, 64
    st = _stages(51 + slow, b, L, H, P, N, Q, slow=slow,
                 dtype=torch.bfloat16)
    x, dy, B, C = (st[k].float() for k in ("x", "dy", "B", "C"))
    dgs = ssd_chunk_bwd_tc_dgs_plain(st["x"], st["dts"], st["la"], st["dy"],
                                     chunk=Q)
    pB, pC, _, _ = ssd_chunk_bwd_tc_dbdc_plain(
        x, st["dts"], st["la"], B, C, dy, st["s_in"], st["g"], dgs, chunk=Q)
    la = st["la"].reshape(b, L // Q, Q, H)
    for c in range(L // Q):
        rows = slice(c * Q, (c + 1) * Q)
        lq, dtq = la[:, c], st["dts"][:, rows]
        w = torch.exp(lq[:, -1:] - lq) * dtq
        dC = sum(p @ B[:, rows] for p in _parts(dgs[:, c]))
        dB = sum(p.transpose(1, 2) @ C[:, rows] for p in _parts(dgs[:, c]))
        for h in range(H):
            dyS = sum(dy[:, rows, h] @ p for p in _parts(st["s_in"][:, c, h]))
            xg = sum(x[:, rows, h] @ p for p in _parts(st["g"][:, c, h]))
            dC = dC + torch.exp(lq[..., h:h + 1]) * dyS
            dB = dB + w[..., h:h + 1] * xg
        torch.testing.assert_close(dC.to(torch.bfloat16),
                                   pC[:, rows].to(torch.bfloat16),
                                   **BF16_ULP)
        torch.testing.assert_close(dB.to(torch.bfloat16),
                                   pB[:, rows].to(torch.bfloat16),
                                   **BF16_ULP)


def test_tc_entries_raise_on_a_cpu_tensor():
    """Each launch of the tensor-core backward raises on a CPU tensor (the
    wrapper takes the plain stages there), counting no launch."""
    b, L, H, P, N, Q = 1, 128, 2, 64, 64, 64
    st = _stages(61, b, L, H, P, N, Q, dtype=torch.bfloat16)
    dgs = ssd_chunk_bwd_tc_dgs_plain(st["x"], st["dts"], st["la"], st["dy"],
                                     chunk=Q)
    _, _, dlep = ssd_chunk_bwd_tc_scan_plain(st["la"], st["R"], st["s_in"],
                                             chunk=Q)
    _, _, qc, xg = ssd_chunk_bwd_tc_dbdc_plain(
        st["x"], st["dts"], st["la"], st["B"], st["C"], st["dy"],
        st["s_in"], st["g"], dgs, chunk=Q)
    calls = [
        lambda: ssd_chunk_bwd_tc_scan(st["la"], st["R"].clone(), st["s_in"],
                                      chunk=Q),
        lambda: ssd_chunk_bwd_tc_dgs(st["x"], st["dts"], st["la"], st["dy"],
                                     chunk=Q),
        lambda: ssd_chunk_bwd_tc_dbdc(st["x"], st["dts"], st["la"], st["B"],
                                      st["C"], st["dy"], st["s_in"], st["g"],
                                      dgs, chunk=Q),
        lambda: ssd_chunk_bwd_tc_head(st["x"], st["dts"], st["la"], st["B"],
                                      st["C"], st["D"], st["dy"], st["g"],
                                      dlep, qc, xg, chunk=Q)]
    fns = ssd._BWD_KERNELS["tc"][1:]
    for fn, call in zip(fns, calls):
        before = fn.launches
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
        assert fn.launches == before


def test_tc_route_is_bk1_then_its_four_launches():
    """The tensor-core route shares the FMA route's bK1 (its launch and its
    plain version), then runs its scan, dgs, dbdc and head, in that
    order."""
    tc, fma = ssd._BWD_KERNELS["tc"], ssd._BWD_KERNELS["fma"]
    assert tc[0] is fma[0] and ssd._BWD_PLAIN["tc"][0] is \
        ssd._BWD_PLAIN["fma"][0]
    assert tuple(f.__name__ for f in tc[1:]) == ssd.BWD_TC_ENTRIES
    assert tuple(f.__name__ for f in ssd._BWD_PLAIN["tc"][1:]) == tuple(
        n + "_plain" for n in ssd.BWD_TC_ENTRIES)
